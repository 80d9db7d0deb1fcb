"""Per-step sweep context (the counterpart of
``nereus_tpu.solvers.pallas_common``): hash → stable sort → query cell
coordinates → exact fluid and boundary ranges → packed parameters.

There is no window plan, no packing into lane-aligned regions and no float
hash payload: those exist for the TPU's Mosaic compiler. Per-step state
stays as sorted (C,) columns; the (N, Fq) query and (M, 8) source matrices
the kernels read are built from them per sweep. The density and force
sweeps read one matrix each (:meth:`SweepCtx.density_operands`,
:meth:`SweepCtx.force_operands`): the queries are its fluid rows, the
boundary rows follow them; DFSPH's density and α sweep walks the
density's, and the multiphase density and α sweeps one built the same
way. The multiphase force sweep reads one
(C [+ Mb], 12) wide matrix (:meth:`SweepCtx.pack_wide`), its queries the
fluid rows, the multiphase DFSPH κ sweep a (M, 4) one
(:meth:`SweepCtx.pack_psi`), and the XSPH and ω
sweeps over the fluid rows only one (C, 8) matrix that is their queries
and their source (:meth:`SweepCtx.pack_fluid`). The wide and the (C, 8)
matrices are built through contiguous planes and one transposing copy.
A multiphase state's ``mass`` and ``rho0`` ride the sort with the
positions. A moving boundary (``BoundaryData.vel`` set) packs its wall
velocities into slots 3-5 of every 8-wide and wide boundary row, as the
JAX package's ``_bcols`` does, so every sweep that reads a source
velocity there (IISPH's ρ_adv, DFSPH's Dρ/Dt, multiphase DFSPH's dδ̂/dt,
the viscous Laplacian, the wall friction) reads the moving wall.

Every sweep of a step walks the ranges built here from the start-of-step
positions, PCISPH's predicted density at x* included
(``solvers/pcisph_cuda.py``). The sweeps of the row-tiled CUDA engine
(the pressure force, the viscous Laplacian) also read the step's tile
plan (:attr:`SweepCtx.tile_plan`), built once from the sorted hashes and
reused by every launch of the step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..ops.neighbors import N_ROWS, query_ranges
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
    perm: torch.Tensor        # (C,) int64, sorted row → state row
    pressure: torch.Tensor    # (C,) the state's pressure, unsorted
    b_src: Optional[torch.Tensor] = None   # (Mb, 8) boundary source rows
    coords: Optional[torch.Tensor] = None  # (C, 3) int32 query cells
    # (C,) int32 ascending: the fluid's hashes, which a sweep with other
    # queries (the elastic coupling's body samples) searches
    sorted_hash: Optional[torch.Tensor] = None
    mass: Optional[torch.Tensor] = None    # (C,) hash-sorted phase columns
    rho0: Optional[torch.Tensor] = None    # of a multiphase state

    # the boundary rows carry wall velocities (``BoundaryData.vel`` set)
    moving_boundary: bool = False
    grid_size: tuple = (1, 1, 1)           # the grid's cell counts

    @property
    def c(self) -> int:
        return self.px.shape[0]

    @functools.cached_property
    def pres_prev(self):
        """(C,) previous pressure (DFSPH: accumulated κ), hash-sorted:
        gathered on first use, so only the implicit solvers' warm starts
        pay for it."""
        return self.pressure.index_select(0, self.perm)

    @functools.cached_property
    def tile_plan(self):
        """The tile plan of this step's queries for the row-tiled sweeps
        (``ops/cuda_sweep.py::tile_plan``): built on first use, on the
        device, and shared by every launch of the step."""
        from ..ops.cuda_sweep import tile_plan
        return tile_plan(self.sorted_hash, self.grid_size)

    @property
    def seg_start_f(self):
        """(9, C) fluid rows only (a view): the ranges of a sweep that
        never reaches the boundary region (IISPH Σd_ij·p_j)."""
        return self.seg_start[:N_ROWS]

    @property
    def seg_end_f(self):
        return self.seg_end[:N_ROWS]

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

    def pack(self, vel, slot6, boundary=True):
        """(C [+ Mb], 8) source matrix: fluid rows ``x y z vx vy vz slot6
        0``, then (unless ``boundary`` is False: a sweep over the fluid
        rows only) the boundary rows (the wall velocity, 0 for a static
        wall, and ψ_b in slot 6)."""
        z = torch.zeros_like(self.px)
        fluid = torch.stack([self.px, self.py, self.pz, *vel,
                             slot6.expand(self.c), z], dim=1)
        if self.b_src is None or not boundary:
            return fluid
        return torch.cat([fluid, self.b_src])

    def pack_psi(self, q4):
        """(C [+ Mb], 4) source of a sweep that reads positions and one
        scalar: fluid rows ``q4`` (4-wide queries, ``x y z s``: κV̂²_j of
        multiphase DFSPH), then the boundary rows ``x y z ψ_b``."""
        if self.b_src is None:
            return q4
        return torch.cat([q4, self._b_src_psi])

    def density_operands(self, psi):
        """The density sweep's operands ``(q, src, seg_start, seg_end,
        pvec)`` on one (C [+ Mb], 4) matrix: fluid rows ``x y z ψ`` (ψ =
        ``psi``, 0-d or (C,): the particle mass; the multiphase density's
        unread 0 and the multiphase α's 1/m), then the boundary rows
        ``x y z ψ_b``; the query is its first C rows (the kernel does not
        read its slot 3)."""
        return self._one_matrix([psi.expand(self.c)], self._b_src_psi)

    def force_operands(self, vel, dens, pd2):
        """The force sweep's operands ``(q, src, seg_start, seg_end,
        pvec)`` on one (C [+ Mb], 8) matrix: fluid rows ``x y z v ρ pd2``
        (``vel`` three (C,) columns; ``pd2`` = p/ρ², or 0 for the
        pressure-off sweep, which does not read it), then the boundary rows
        as they are; the query is its first C rows, and without a boundary
        the matrix is the query itself."""
        return self._one_matrix([*vel, dens, pd2], self.b_src)

    def _one_matrix(self, cols, walls):
        """``(q, src, seg_start, seg_end, pvec)`` on one (C [+ Mb], 3 +
        len(cols)) matrix: the fluid rows ``x y z cols`` stacked in place,
        then ``walls``; ``q`` its first C rows, ``src`` itself without a
        boundary."""
        rng = (self.seg_start, self.seg_end, self.pvec)
        if self.b_src is None:
            q = self.queries(*cols)
            return (q, q, *rng)
        out = self.px.new_empty((self.c + walls.shape[0], 3 + len(cols)))
        torch.stack([self.px, self.py, self.pz, *cols], dim=1,
                    out=out[:self.c])
        out[self.c:] = walls
        return (out[:self.c], out, *rng)

    def pack_wide(self, cols):
        """(C [+ Mb], 12) wide matrix: fluid rows ``x y z``, then ``cols``
        ((C,) or 0-d) and zero pads (the multiphase force: vx vy vz V pV²
        ρ0 1/m m 1/ρ̃, whose first C rows are its queries); boundary rows
        ``x y z v_b ψ_b 0 0 0 0 0`` (v_b = 0 for a static wall). Built
        through planes (:meth:`_through_planes`)."""
        return self._through_planes(cols, SP.WIDE_WIDTH, self._b_src_wide)

    def pack_fluid(self, vel, slot6):
        """(C, 8) matrix ``x y z vx vy vz slot6 0`` of a sweep over the
        fluid rows only, its queries and its source (XSPH, ω): the values of
        ``pack(vel, slot6, boundary=False)``, built through planes
        (:meth:`_through_planes`)."""
        return self._through_planes([*vel, slot6], SP.SRC_WIDTH)

    def _through_planes(self, cols, width, walls=None):
        """(C [+ Mb], ``width``): fluid rows ``x y z``, then ``cols`` ((C,)
        or 0-d) and zero pads, then the rows ``walls`` (Mb, ``width``) when
        given. The columns are stacked as contiguous (``width``, C)
        planes, then one transposing copy writes the fluid rows. A stack
        straight into 32- or 48-byte rows copies column by column, each
        4-byte store touching every row's sector (IISPH's 1,092,727 +
        100,120 rows, 12 wide: 0.32 ms against 0.09, PERF.md section 6)."""
        if len(cols) > width - 3:
            raise ValueError(f"a {width}-wide matrix takes at most "
                             f"{width - 3} columns, got {len(cols)}")
        z = torch.zeros_like(self.px)
        pads = [z] * (width - 3 - len(cols))
        planes = torch.stack([self.px, self.py, self.pz,
                              *(col.expand(self.c) for col in cols), *pads])
        nb = 0 if walls is None else walls.shape[0]
        out = planes.new_empty((self.c + nb, width))
        out[:self.c] = planes.t()
        if nb:
            out[self.c:] = walls
        return out

    @functools.cached_property
    def _b_src_psi(self):
        """(Mb, 4) boundary rows ``x y z ψ_b``."""
        return None if self.b_src is None else psi_rows(self.b_src)

    @functools.cached_property
    def _b_src_wide(self):
        """(Mb, 12) boundary rows ``x y z v_b ψ_b 0 0 0 0 0``."""
        if self.b_src is None:
            return None
        pad = self.b_src.new_zeros((self.b_src.shape[0],
                                    SP.WIDE_WIDTH - SP.SRC_WIDTH))
        return torch.cat([self.b_src, pad], dim=1)


def psi_rows(src):
    """(M, 4) ``x y z ψ`` of (M, 8) source rows with ψ in slot 6. One cat
    of two slices: indexing the columns with a list would copy the list to
    the device, which waits for the stream."""
    return torch.cat([src[:, :3], src[:, 6:7]], dim=1)


def pd2_operands(ctx: SweepCtx):
    """The pressure-force sweep's operands, loop-invariant: returns
    ``at(pd2) -> (q, src, seg_start, seg_end, pvec)``, which writes the
    (C,) ``pd2`` (p/ρ², or DFSPH's κ/ρ) in place into query column 3 and
    the fluid source rows' slot 6 (the boundary rows keep ψ_b)."""
    z = torch.zeros_like(ctx.px)
    q = ctx.queries(z)
    src = ctx.pack((z, z, z), z)

    def at(pd2):
        q[:, 3] = pd2
        src[:ctx.c, 6] = pd2
        return q, src, ctx.seg_start, ctx.seg_end, ctx.pvec
    return at


def boundary_src(boundary: BoundaryData):
    """(Mb, 8) source rows of a boundary set, ``x y z v_b ψ_b 0``: the wall
    velocity when ``boundary.vel`` is set, else 0 (a static wall)."""
    z = torch.zeros_like(boundary.psi)
    p = boundary.pos
    v = (z, z, z) if boundary.vel is None else boundary.vel.unbind(1)
    return torch.stack([p[:, 0], p[:, 1], p[:, 2], *v, boundary.psi, z],
                       dim=1)


def build_sweep_ctx(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData]) -> SweepCtx:
    h = gridlib.hash_positions(grid, state.pos, state.active_mask())
    phase = (state.mass, state.rho0) if state.multiphase else ()
    sorted_hash, perm, (pos, vel, *phase) = gridlib.sort_by_hash(
        h, state.pos, state.vel, *phase, return_perm=True)
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
        perm=perm, pressure=state.pressure,
        b_src=boundary_src(boundary) if with_b else None, coords=coords,
        sorted_hash=sorted_hash, grid_size=grid.size,
        moving_boundary=with_b and boundary.vel is not None,
        mass=phase[0] if phase else None, rho0=phase[1] if phase else None)
