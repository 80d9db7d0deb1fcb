"""Exact neighbor ranges and the plain PyTorch neighbor sweep.

A query's 27-cell neighborhood is 9 contiguous runs of a hash-sorted
source array, one per (dy, dz) row (``grid.row_segments``). With a
boundary set the sweeps read ONE source matrix, the fluid rows followed by
the boundary rows, and 18 ranges per query: rows 0-8 index the fluid
region, rows 9-17 the boundary region (offset by the fluid length). The
ranges are exact, so no neighbor can be missed and there is no window to
overflow.

:func:`neighbor_sweep_plain` expands the ranges into an explicit pair list
and sums a pair formula into the queries with ``index_add_``. It is the
CPU path and the twin of the CUDA sweep kernels (``ops/cuda_sweep.py``),
which walk the same ranges one thread per query. Self-pairs are included
on purpose: the density self term comes from them, and every other pair
term is exactly 0 there.

A sweep whose pairs never change (an elastic body's, in its reference
positions) walks a static pair list instead (:func:`cutoff_list`, built
once from the ranges; :func:`list_sweep_plain` is its plain sweep).
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import grid as gridlib

N_ROWS = 9


def query_ranges(grid: gridlib.Grid, coords, fluid_hash,
                 boundary_hash=None):
    """``(seg_start, seg_end)``, each (9 or 18, N) int32: the fluid rows,
    then (when ``boundary_hash`` is given) the boundary rows offset by the
    fluid source length."""
    start, end = gridlib.row_segments(grid, fluid_hash, coords)
    if boundary_hash is None or boundary_hash.numel() == 0:
        return start, end
    off = fluid_hash.shape[0]
    b_start, b_end = gridlib.row_segments(grid, boundary_hash, coords)
    return (torch.cat([start, b_start + off]),
            torch.cat([end, b_end + off]))


def row_pairs(seg_start_row, seg_end_row):
    """Explicit (query, source) index pairs of one row of ranges."""
    counts = (seg_end_row - seg_start_row).clamp(min=0).long()
    n = counts.shape[0]
    qi = torch.repeat_interleave(
        torch.arange(n, device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(qi.shape[0], device=counts.device) - first[qi]
    return qi, seg_start_row.long()[qi] + k


def neighbor_sweep_plain(pair_fn: Callable, q, src, seg_start, seg_end,
                         out_width: int, pair_fn_b: Callable | None = None):
    """Σ over every (query, source) pair in the ranges of ``pair_fn(q_i,
    s_j)`` → (N, out_width). ``q`` is (N, Fq), ``src`` (M, Fs); the pair
    function gets the gathered (P, Fq) and (P, Fs) rows and returns
    (P, out_width). Rows 9-17, when present, use ``pair_fn_b``. One row at
    a time, so the pair list never holds more than one row's pairs."""
    n_rows = seg_start.shape[0]
    if n_rows not in (N_ROWS, 2 * N_ROWS):
        raise ValueError(f"expected 9 or 18 range rows, got {n_rows}")
    if n_rows == 2 * N_ROWS and pair_fn_b is None:
        raise ValueError("18 range rows need a boundary pair function")
    out = torch.zeros((q.shape[0], out_width), dtype=q.dtype,
                      device=q.device)
    for r in range(n_rows):
        fn = pair_fn if r < N_ROWS else pair_fn_b
        qi, sj = row_pairs(seg_start[r], seg_end[r])
        out.index_add_(0, qi, fn(q.index_select(0, qi),
                                 src.index_select(0, sj)))
    return out


def cutoff_list(x, seg_start, seg_end, h2):
    """The static pair list of the ranges: ``(nbr_start, nbr)``, (N + 1,)
    and (P,) int32, query i's sources ``nbr[nbr_start[i]:nbr_start[i +
    1]]``, the candidates j of its ranges whose positions ``x`` (N, 3) lie
    within |x_i − x_j|² < ``h2`` (the self pair included), computed as the
    pair formulas compute r², in range order. The ranges index ``x``
    itself (9 rows: a body over its own reference positions)."""
    n = x.shape[0]
    qs, js = [], []
    for r in range(seg_start.shape[0]):
        qi, sj = row_pairs(seg_start[r], seg_end[r])
        xi, xj = x.index_select(0, qi), x.index_select(0, sj)
        dx = xi[:, 0] - xj[:, 0]
        dy = xi[:, 1] - xj[:, 1]
        dz = xi[:, 2] - xj[:, 2]
        keep = dx * dx + dy * dy + dz * dz < h2
        qs.append(qi[keep])
        js.append(sj[keep])
    qi, sj = torch.cat(qs), torch.cat(js)
    order = torch.sort(qi, stable=True).indices
    nbr = sj.index_select(0, order).to(torch.int32)
    nbr_start = torch.zeros((n + 1,), dtype=torch.int32, device=x.device)
    nbr_start[1:] = torch.cumsum(torch.bincount(qi, minlength=n), 0)
    return nbr_start, nbr


# pairs gathered at a time by list_sweep_plain: bounds its memory, as one
# range row at a time bounds neighbor_sweep_plain's
LIST_CHUNK = 1 << 22


def list_sweep_plain(pair_fn: Callable, q, src, nbr_start, nbr,
                     out_width: int):
    """Σ over every (query, source) pair of a static pair list
    (:func:`cutoff_list`) of ``pair_fn(q_i, s_j)`` → (N, out_width), in
    list order, ``LIST_CHUNK`` pairs at a time."""
    n = q.shape[0]
    counts = (nbr_start[1:] - nbr_start[:-1]).long()
    qi_all = torch.repeat_interleave(
        torch.arange(n, device=counts.device), counts)
    out = torch.zeros((n, out_width), dtype=q.dtype, device=q.device)
    for k in range(0, nbr.shape[0], LIST_CHUNK):
        qi = qi_all[k:k + LIST_CHUNK]
        sj = nbr[k:k + LIST_CHUNK].long()
        out.index_add_(0, qi, pair_fn(q.index_select(0, qi),
                                      src.index_select(0, sj)))
    return out
