"""The in-kernel cell check and the wide-grid A/B (PyTorch port of
``tools/wideprobe.py``'s ``cellcheck``, ``--pad-below`` and ``steps_ab``).

The sweeps walk int32 ranges built from ``grid.cell_coords`` of the
hash-sorted positions, so nothing in a step recomputes a query's cell. A
grid refit (new origin and extent) and a grid past 2²⁴ cells are where a
cell could disagree: :func:`cellcheck` recomputes every query's cell in a
kernel (``csrc/cell_check.cu``) from the step's packed queries and
parameter vector, holds it against ``grid.cell_coords_cols``, and checks
that each query's own sorted index lies in its centre-row range, the range
walk's own cell. :func:`stretch_grid` and :func:`pad_below` build the
wide grids (``bench.py``'s ``wcsph_wide12M`` stretch, and ``wideprobe
--pad-below``, which puts the fluid's hashes above 2²⁴), and
:func:`steps_ab` runs K WCSPH steps on two grids and compares positions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import grid as gridlib
from ..ops.neighbors import N_ROWS
from ..ops.sph_pairs import dispatch

HASH24 = 2 ** 24
CENTRE_ROW = N_ROWS // 2     # (dy, dz) = (0, 0)


def cell_coords_plain(q, pvec, grid: gridlib.Grid):
    """The cell check's plain version: ``grid.cell_coords_cols`` of the
    queries' positions as (N, 4) int32, column 3 zero. It reads the origin
    and 1/cell from ``grid``; ``pvec``, the kernel's copy of them, is
    unused."""
    c = gridlib.cell_coords_cols(grid, q[:, 0], q[:, 1], q[:, 2])
    return torch.stack([*c, torch.zeros_like(c[0])], dim=1)


def cell_coords_in_kernel(q, pvec, grid: gridlib.Grid):
    """Each query's cell (N, 4) int32 from q (N, 4 or 8) and the parameter
    vector ``pvec`` (origin, 1/cell): the kernel on CUDA tensors, the plain
    version on CPU ones."""
    return dispatch((q, pvec), cell_coords_plain, "cell_check", q, pvec,
                    grid)


def cellcheck(state, params, grid: gridlib.Grid, cfg, boundary=None,
              quiet=False) -> int:
    """The number of active queries whose in-kernel cell differs from
    ``grid.cell_coords_cols`` or whose own sorted index lies outside its
    centre-row range ``[seg_start[4], seg_end[4])``; prints the per-axis
    counts (and the first few mismatches) unless ``quiet``."""
    from ..solvers.sweep_common import build_sweep_ctx
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    kern = cell_coords_in_kernel(ctx.queries(width=4), ctx.pvec, grid)[:, :3]
    host = torch.stack(gridlib.cell_coords_cols(grid, ctx.px, ctx.py,
                                                ctx.pz), dim=1)
    diff = (kern != host) & ctx.active[:, None]
    idx = torch.arange(ctx.c, device=host.device)
    own = ((ctx.seg_start[CENTRE_ROW] <= idx)
           & (idx < ctx.seg_end[CENTRE_ROW]))
    outside = ctx.active & ~own
    bad = diff.any(dim=1) | outside
    n_bad = int(bad.sum())
    if not quiet:
        print(f"[cellcheck] mismatched queries: {n_bad} / "
              f"{int(ctx.active.sum())} (per-axis "
              f"{diff.sum(dim=0).tolist()}, outside their centre row "
              f"{int(outside.sum())})")
        for i in torch.nonzero(bad)[:10, 0].tolist():
            print(f"  idx {i}: kernel {kern[i].tolist()} host "
                  f"{host[i].tolist()}")
    return n_bad


def stretch_grid(grid: gridlib.Grid) -> gridlib.Grid:
    """``bench.py``'s ``wcsph_wide12M`` grid: gx, gy and the origin kept,
    gz raised to ⌈2²⁴·1.05/(gx·gy)⌉ so the grid has more than 2²⁴ cells;
    every hash of a particle inside the old grid is unchanged."""
    gx, gy, gz = grid.size
    gz_wide = max(math.ceil(HASH24 * 1.05 / (gx * gy)), gz)
    return gridlib.Grid(origin=grid.origin, size=(gx, gy, gz_wide),
                        cell=grid.cell)


def pad_below(grid: gridlib.Grid, k: int) -> gridlib.Grid:
    """``wideprobe --pad-below k``: the origin lowered by k cells in z and
    k cell planes added, so every hash grows by k·gx·gy (past 2²⁴ for
    k ≥ 2²⁴/(gx·gy)). The origin moves by k·cell in float64, then rounds to
    the grid's dtype, so (v − o) rounds differently than on ``grid``."""
    origin = grid.origin.detach().cpu().numpy().astype(np.float64)
    origin[2] -= k * float(grid.cell[0])
    gx, gy, gz = grid.size
    return gridlib.Grid(
        origin=torch.as_tensor(origin).to(dtype=grid.origin.dtype,
                                          device=grid.origin.device),
        size=(gx, gy, gz + k), cell=grid.cell)


def step_order(state, grid):
    """The permutation a step on ``grid`` applies to ``state`` (its new
    row i is ``state``'s row ``step_order[i]``): the stable sort of the
    masked hashes, as ``build_sweep_ctx`` sorts them."""
    h = gridlib.hash_positions(grid, state.pos, state.active_mask())
    return torch.sort(h, stable=True)[1]


def steps_ab(state, params, grid_a, grid_b, cfg, steps: int, boundary_a=None,
             boundary_b=None):
    """``steps`` WCSPH steps from ``state`` on ``grid_a`` and on ``grid_b``
    (each with its boundary, sorted for it); returns ``(max|Δpos|,
    bit-identical)`` over the live particles. Particles are matched by
    identity: each one's slot in ``state``, carried through every step's
    hash sort. (``wideprobe`` matches the final positions by
    ``np.lexsort``; on a lattice two particles of one plane can tie in
    x to rounding, and a lexsort can then pair different particles.)"""
    from ..solvers.wcsph import wcsph_step

    def drive(grid, boundary, tag):
        s = state
        ids = torch.arange(state.capacity, device=state.pos.device)
        for _ in range(steps):
            ids = ids.index_select(0, step_order(s, grid))
            s, d = wcsph_step(s, params, grid, cfg, boundary)
        pos = torch.empty_like(s.pos).index_copy_(0, ids, s.pos)
        print(f"[steps {tag}] grid {grid.size} cells {math.prod(grid.size)} "
              f"nan {int(torch.isnan(s.pos).sum())} max_density "
              f"{float(d.max_density):.6g}")
        return pos[state.active_mask()]

    pa = drive(grid_a, boundary_a, "a")
    pb = drive(grid_b, boundary_b, "b")
    d = (pa - pb).abs()
    max_d, identical = float(d.max()), bool(torch.equal(pa, pb))
    print(f"[steps b vs a] max|dpos|={max_d:.3e} mean|dpos|="
          f"{float(d.mean()):.3e} bit-identical {identical}")
    return max_d, identical
