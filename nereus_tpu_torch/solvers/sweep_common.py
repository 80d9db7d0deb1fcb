"""Per-step sweep context (the counterpart of
``nereus_tpu.solvers.pallas_common``): hash → stable sort → query cell
coordinates → exact fluid and boundary ranges → packed parameters.

There is no window plan, no packing into lane-aligned regions and no float
hash payload: those exist for the TPU's Mosaic compiler. Per-step state
stays as sorted (C,) columns; the (N, Fq) query and (M, 8) source matrices
the kernels read are built from them per sweep.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..ops.neighbors import query_ranges
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState


@dataclasses.dataclass
class SweepCtx:
    """Sorted state of one step and the ranges every sweep of it walks."""

    px: torch.Tensor          # (C,) hash-sorted columns
    py: torch.Tensor
    pz: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    active: torch.Tensor      # (C,) bool
    seg_start: torch.Tensor   # (9 or 18, C) int32, fluid rows then
    seg_end: torch.Tensor     # boundary rows (offset by C)
    pvec: torch.Tensor        # (PV_LEN,)
    b_src: Optional[torch.Tensor] = None   # (Mb, 8) boundary source rows

    @property
    def c(self) -> int:
        return self.px.shape[0]

    def queries(self, *cols, width: int | None = None):
        """(C, width) query matrix: positions, then ``cols``, then zero
        columns up to ``width``."""
        cols = [self.px, self.py, self.pz, *cols]
        if width is not None:
            if width < len(cols):
                raise ValueError(f"width {width} < {len(cols)} columns")
            z = torch.zeros_like(self.px)
            cols += [z] * (width - len(cols))
        return torch.stack(cols, dim=1)

    def pack(self, vel, slot6):
        """(C [+ Mb], 8) source matrix: fluid rows ``x y z vx vy vz slot6
        0``, then the boundary rows (velocity 0, ψ_b in slot 6)."""
        z = torch.zeros_like(self.px)
        fluid = torch.stack([self.px, self.py, self.pz, *vel,
                             slot6.expand(self.c), z], dim=1)
        if self.b_src is None:
            return fluid
        return torch.cat([fluid, self.b_src])


def _boundary_src(boundary: BoundaryData):
    z = torch.zeros_like(boundary.psi)
    p = boundary.pos
    return torch.stack([p[:, 0], p[:, 1], p[:, 2], z, z, z,
                        boundary.psi, z], dim=1)


def build_sweep_ctx(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData]) -> SweepCtx:
    h = gridlib.hash_positions(grid, state.pos, state.active_mask())
    sorted_hash, _, (pos, vel) = gridlib.sort_by_hash(h, state.pos,
                                                       state.vel)
    px, py, pz = pos.unbind(1)
    coords = gridlib.cell_coords(grid, pos)
    with_b = boundary is not None and boundary.num_boundaries > 0
    seg_start, seg_end = query_ranges(
        grid, coords, sorted_hash,
        boundary.sorted_hash if with_b else None)
    return SweepCtx(
        px=px, py=py, pz=pz, vx=vel[:, 0], vy=vel[:, 1], vz=vel[:, 2],
        active=torch.arange(state.capacity, device=pos.device)
        < state.num_active,
        seg_start=seg_start, seg_end=seg_end,
        pvec=SP.build_pvec(params, cfg, grid),
        b_src=_boundary_src(boundary) if with_b else None)
