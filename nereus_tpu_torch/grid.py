"""Uniform-grid spatial hashing and the sorted 9-row neighbor structure
(PyTorch port of ``nereus_tpu.grid``).

The hash is row-major with x fastest, ``(z·gy + y)·gx + x``, as in the
reference (``calcGridHash``, ``sph_kernel_impl.cuh:118-125``), and cell
coordinates are clamped to the grid. The 27-cell neighborhood of a cell is
then 9 contiguous runs of the hash-sorted arrays, one per (dy, dz) row
(:func:`row_segments`). Cell coordinates are formed exactly as the JAX
package forms them, so hashes and sort order agree bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import resolve_device

INT32_MAX = 2 ** 31 - 1

# The 9 (dy, dz) row offsets of the 3×3×3 neighborhood, dz outer.
ROW_OFFSETS = tuple((dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1))


@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform grid: ``origin`` (3,) and ``cell`` (3,) tensors, ``size``
    the cell counts per axis (a Python tuple)."""

    origin: torch.Tensor
    size: tuple = (1, 1, 1)
    cell: torch.Tensor = None


def make_grid(origin, size, cell_size, dtype=torch.float32,
              device=None) -> Grid:
    """A grid on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    origin = torch.as_tensor(np.asarray(origin, np.float64)).to(
        dtype=dtype, device=device)
    size = tuple(int(s) for s in np.asarray(size).reshape(-1))
    cell = torch.as_tensor(np.asarray(cell_size, np.float64)).to(
        dtype=dtype, device=device).expand(3).clone()
    return Grid(origin=origin, size=size, cell=cell)


def fit_grid(lo, hi, cell_size, margin: float = 0.1, dtype=torch.float32,
             device=None) -> Grid:
    """Fit a grid around an AABB on the host (``SPH::updateGrid``,
    ``sph/sph.cpp:313-337``): origin = lo − margin, extent padded by
    ``margin`` on both faces, exact size (no power-of-two rounding; the
    hash clamps instead of wrapping)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    origin = lo - margin
    size = np.ceil((hi - lo + 2.0 * margin) / cell_size).astype(np.int32)
    size = np.maximum(size, 1)
    return make_grid(origin, size, cell_size, dtype=dtype, device=device)


def refit_grid(state, cell_size, boundary=None, margin: float = 0.1,
               dtype=torch.float32) -> Grid:
    """A grid fit to the AABB of the live particles (and of ``boundary``'s
    samples), on the state's device (``SPH::updateGrid``,
    ``sph/sph.cpp:290-337``). The AABB is a masked min/max on the device,
    so parked slots (1e9) never inflate it; only its 6 floats reach the
    host. Stepping on the new grid needs the boundary re-sorted
    (``boundary.rehash_boundary``)."""
    pos = state.pos
    big = torch.finfo(pos.dtype).max
    act = state.active_mask()[:, None]
    lo = torch.where(act, pos, big).amin(dim=0)
    hi = torch.where(act, pos, -big).amax(dim=0)
    if boundary is not None and boundary.num_boundaries > 0:
        lo = torch.minimum(lo, boundary.pos.amin(dim=0))
        hi = torch.maximum(hi, boundary.pos.amax(dim=0))
    lo, hi = torch.cat([lo, hi]).cpu().numpy().reshape(2, 3)
    return fit_grid(lo, hi, cell_size, margin=margin, dtype=dtype,
                    device=pos.device)


def _coord(v, origin, inv_cell, g):
    # floor((v − o)·(1/cell)); the clamp happens on the float so positions
    # far outside the grid (parked slots at 1e9) saturate instead of
    # overflowing the int32 cast
    c = torch.floor((v - origin) * inv_cell)
    return torch.clamp(c, 0, g - 1).to(torch.int32)


def cell_coords(grid: Grid, pos):
    """Integer cell coordinates (N, 3), clamped to the grid
    (``calcGridPos`` without the power-of-two wrap). Multiply by the
    float32 reciprocal ``1/cell``, not divide: the JAX package and its
    kernels round this way."""
    inv = 1.0 / grid.cell
    return torch.stack([_coord(pos[..., k], grid.origin[k], inv[k],
                               grid.size[k]) for k in range(3)], dim=-1)


def cell_coords_cols(grid: Grid, x, y, z):
    """Column form of :func:`cell_coords`: three (N,) int32 columns."""
    inv = 1.0 / grid.cell
    return tuple(_coord(v, grid.origin[k], inv[k], grid.size[k])
                 for k, v in enumerate((x, y, z)))


def cell_hash(grid: Grid, coords):
    """Row-major linear cell id, x fastest."""
    gx, gy = grid.size[0], grid.size[1]
    return (coords[..., 2] * gy + coords[..., 1]) * gx + coords[..., 0]


def hash_positions(grid: Grid, pos, active_mask=None):
    """Per-particle int32 cell hash; inactive slots hash to ``INT32_MAX``
    so the sort pushes them to the tail and no row range reaches them."""
    h = cell_hash(grid, cell_coords(grid, pos))
    if active_mask is not None:
        h = torch.where(active_mask, h,
                        torch.full_like(h, INT32_MAX))
    return h


def sort_by_hash(hashes, *arrays, return_perm=False):
    """Stable sort by cell hash; returns ``(sorted_hash, perm, arrays)``
    with every array gathered into sorted order (``perm`` is None unless
    asked for). On a GPU a stable key sort plus gathers is the cheap form;
    the JAX package's variadic sort exists only for the TPU's slow
    gathers."""
    sorted_hash, perm = torch.sort(hashes, stable=True)
    res = tuple(a.index_select(0, perm) for a in arrays)
    return sorted_hash, perm if return_perm else None, res


def row_segments(grid: Grid, sorted_hash, coords):
    """Bounds of the 9 contiguous neighbor runs per query.

    For each query cell (x, y, z) and each (dy, dz) of the 3×3 row stencil
    the run covers the hash range [(z+dz, y+dy, max(x−1, 0)),
    (z+dz, y+dy, min(x+1, gx−1))]; rows outside the grid in y or z are
    empty. ``coords`` is (N, 3) int32; returns ``(seg_start, seg_end)``,
    each (9, N) int32 indices into ``sorted_hash``.
    """
    gx, gy, gz = grid.size
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    off = torch.tensor(ROW_OFFSETS, dtype=coords.dtype,
                       device=coords.device)
    # all 9 rows at once, (9, N): a handful of launches, not ~20 per row
    yy = y[None] + off[:, 0:1]
    zz = z[None] + off[:, 1:2]
    valid = (yy >= 0) & (yy < gy) & (zz >= 0) & (zz < gz)
    row = (zz.clamp(0, gz - 1) * gy + yy.clamp(0, gy - 1)) * gx
    sh = sorted_hash.contiguous()
    s = torch.searchsorted(sh, row + torch.clamp(x - 1, min=0),
                           out_int32=True)
    e = torch.searchsorted(sh, row + torch.clamp(x + 1, max=gx - 1),
                           out_int32=True, right=True)
    return torch.where(valid, s, 0), torch.where(valid, e, 0)
