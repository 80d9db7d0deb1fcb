"""The tile plan of the port's row-tiled CUDA sweep engine
(``nereus_tpu_torch/csrc/tiled_sweep.cuh``, built by
``ops/cuda_sweep.py::tile_plan``) on the CPU, and a plain emulation of the
tiled kernel's walk: every source row gathered through its tile's span
(``lo`` + offset), which must reproduce the plain sweeps bit for bit at
every tile size.

Scenes, built by the port: the shear scene of ``tests/test_viscosity.py::
test_implicit_viscosity_engines_match`` (DFSPH parameters at ν = 0.5, a 9³
cube at 0.5·h with a sinusoidal shear velocity in a walled box; mirrored
against JAX in ``test_torch_viscosity.py``) and a small PCISPH settled
block (~1,000 and ~4,000 particles at 0.8·h with its walls, impact
velocity −1 m/s; its steps are held against JAX in
``test_torch_pcisph.py``). The tiled kernels themselves run on the card
only (``tests/test_torch_package.py``).

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import nereus_tpu_torch as pt
from nereus_tpu_torch import boundary as B
from nereus_tpu_torch import scene
from nereus_tpu_torch.grid import INT32_MAX
from nereus_tpu_torch.ops import cuda_sweep
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.ops.neighbors import N_ROWS, row_pairs
from nereus_tpu_torch.solvers import viscosity
from nereus_tpu_torch.solvers.sweep_common import (build_sweep_ctx,
                                                   pd2_operands)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _shear(extra_slots=0):
    """The shear scene; ``extra_slots`` parked slots past the fluid."""
    cfg = pt.SimConfig(viscosity_model="implicit")
    params = pt.calibrate_mass(pt.dfsph_params(
        viscosity=0.5, dt=5e-4, particle_radius=0.0537 / 4, device=CPU), cfg)
    h = float(params.interaction_radius)
    sp = 2 * float(params.particle_radius)
    side = 9 * sp
    pos = scene.particle_cube((0.25, 0.3, 0.25), (side,) * 3, sp)
    lo, hi = np.zeros(3), np.array((0.5, 0.8, 0.5))
    grid = pt.fit_grid(lo - h, hi + h, h, device=CPU)
    walls = B.box_boundary(grid, lo, hi, float(params.particle_radius),
                           params, device=CPU)
    vel = np.zeros_like(pos)
    vel[:, 0] = np.sin(2.0 * np.pi * (pos[:, 1] - 0.3) / side)
    state = pt.make_fluid_state(pos, vel, capacity=len(pos) + extra_slots,
                                device=CPU)
    return cfg, params, state, grid, walls


def _block(n_target=4000):
    """The settled PCISPH block of ``bench.py``'s pcisph_256k_settled at
    ``n_target`` particles."""
    cfg = pt.SimConfig()
    base = pt.pcisph_params(device=CPU)
    spacing = 0.8 * float(base.interaction_radius)
    params = pt.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, walls = scene.resting_block(
        params, cfg, n_target=n_target, spacing=spacing,
        impact_velocity=-1.0, device=CPU)
    return cfg, params, state, grid, walls


def _ctx(case):
    cfg, params, state, grid, walls = case
    return build_sweep_ctx(state, params, grid, cfg, walls)


SCENES = {"shear": _shear, "block": _block}


def _tiles(plan, ctx=None):
    """``(n_tiles, (n_tiles, 2) first query and count, spans)``: the spans
    (``cuda_sweep.tile_spans``) over ``ctx``'s ranges, None without."""
    nt = int(plan.n_tiles[0])
    b = plan.bounds[:nt + 1].long()
    spans = None if ctx is None else cuda_sweep.tile_spans(
        plan, ctx.seg_start, ctx.seg_end)
    return nt, torch.stack([b[:-1], b[1:] - b[:-1]], dim=1), spans


def _tile_of(plan):
    _, tiles, _ = _tiles(plan)
    return torch.repeat_interleave(torch.arange(len(tiles)), tiles[:, 1])


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [32, 64, 128])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_tiles_stay_in_one_cell_row(name, tile):
    """The tiles cover the queries in order, hold 1 to ``tile`` queries
    each, never cross a (y, z) cell row, and cut a row of k queries into
    ceil(k / tile) tiles; their count fits the launch's upper bound."""
    ctx = _ctx(SCENES[name]())
    plan = cuda_sweep.tile_plan(ctx.sorted_hash, ctx.grid_size, tile=tile)
    n = ctx.c
    gx, gy, gz = ctx.grid_size
    nt, tiles, _ = _tiles(plan)
    assert plan.n_ctas == min(n, -(-n // tile) + gy * gz) >= nt
    first, count = tiles[:, 0], tiles[:, 1]
    assert int(first[0]) == 0 and int(count.sum()) == n
    assert torch.equal(first[1:], (first + count)[:-1])
    assert bool((count >= 1).all()) and bool((count <= tile).all())
    key = (ctx.sorted_hash // gx).long()
    t_of = _tile_of(plan)
    assert torch.equal(key[first][t_of], key)
    rows, per_row = torch.unique_consecutive(key, return_counts=True)
    assert nt == int(((per_row + tile - 1) // tile).sum())
    assert nt < n // 4   # the scenes' rows hold several queries per tile


@pytest.mark.parametrize("name", sorted(SCENES))
def test_spans_hold_every_query_ranges(name):
    """A tile's span of a row runs from its first query's range start to
    its last query's range end; every query's non-empty range of every row
    lies inside it (the starts and ends are non-decreasing along a tile),
    and an empty span means every range of the tile is empty."""
    ctx = _ctx(SCENES[name]())
    assert ctx.seg_start.shape[0] == 2 * N_ROWS
    plan = ctx.tile_plan
    nt, tiles, spans = _tiles(plan, ctx)
    t_of = _tile_of(plan)
    s, e = ctx.seg_start.long(), ctx.seg_end.long()
    first, last = tiles[:, 0], tiles[:, 0] + tiles[:, 1] - 1
    full = spans[..., 1] > 0
    assert torch.equal(spans[..., 0].t()[full.t()], s[:, first][full.t()])
    assert torch.equal((spans[..., 0] + spans[..., 1]).t()[full.t()],
                       e[:, last][full.t()])
    lo = spans[t_of, :, 0].t()
    hi = lo + spans[t_of, :, 1].t()
    busy = e > s
    assert bool((~busy | ((s >= lo) & (e <= hi))).all())
    assert not bool((busy & (hi == lo)).any())
    assert bool(full.any())


def test_parked_slots_reach_no_source():
    """Parked slots (``INT32_MAX`` hashes) sort last and form tiles of
    their own whose spans are all empty, so the kernel walks nothing for
    them and writes 0, as the plain sweep gives them."""
    ctx = _ctx(_shear(extra_slots=301))
    parked = ctx.sorted_hash == INT32_MAX
    n_live = int((~parked).sum())
    assert n_live == 1000 and int(parked.sum()) == 301
    # the plain sweep finds no candidate of a parked slot inside h
    s, e = ctx.seg_start[:, n_live:], ctx.seg_end[:, n_live:]
    q = ctx.queries(width=4)[n_live:]
    for r in range(s.shape[0]):
        qi, sj = row_pairs(s[r], e[r])
        src = torch.cat([torch.stack([ctx.px, ctx.py, ctx.pz], 1),
                         ctx.b_src[:, :3]])
        d2 = ((q[qi, :3] - src[sj]) ** 2).sum(1)
        assert bool((d2 > float(ctx.pvec[SP.PV_H2])).all())
    plan = ctx.tile_plan
    nt, tiles, spans = _tiles(plan, ctx)
    t_of = _tile_of(plan)
    parked_tiles = parked[tiles[:, 0]]
    assert torch.equal(parked[tiles[:, 0] + tiles[:, 1] - 1], parked_tiles)
    assert int(parked_tiles.sum()) == -(-301 // cuda_sweep.TILE)
    assert int(spans[parked_tiles, :, 1].abs().sum()) == 0
    assert torch.equal(parked_tiles[t_of], parked)
    assert plan.n_ctas >= nt


def test_plan_flags_what_the_kernel_reads():
    """A query count that is no multiple of the tile leaves short tiles;
    a tile whose queries see no wall has empty wall spans (its wall phase
    is skipped), a tile at the walls does not; a span is a (lo, length)
    pair, lo 0 where it is empty."""
    block = _ctx(_block())
    nt, _, spans = _tiles(cuda_sweep.tile_plan(
        block.sorted_hash, block.grid_size, tile=32), block)
    # the block's rows reach its side walls at both ends: the middle tiles
    # of a row cut in 32-query tiles see no wall, the others (and the
    # bottom tiles the floor's too) do
    wall = spans[:, N_ROWS:, 1].sum(dim=1)
    assert 0 < int((wall == 0).sum()) < nt
    ctx = _ctx(_shear())
    assert ctx.c % cuda_sweep.TILE != 0
    plan = ctx.tile_plan
    nt, tiles, spans = _tiles(plan, ctx)
    assert int(tiles[:, 1].min()) < cuda_sweep.TILE
    # the shear cube stands off its walls: no wall span, no wall range
    assert int(spans[:, N_ROWS:, 1].sum()) == 0
    assert bool((ctx.seg_end[N_ROWS:] == ctx.seg_start[N_ROWS:]).all())
    assert spans.shape == (nt, 2 * N_ROWS, 2)
    assert int(spans[spans[..., 1] == 0][:, 0].abs().sum()) == 0


def test_plan_bounds_and_empty_input():
    """An empty query set gives an empty plan; a tile size outside the
    kernel's launch range raises."""
    ctx = _ctx(_shear())
    plan = cuda_sweep.tile_plan(ctx.sorted_hash[:0], ctx.grid_size)
    assert int(plan.n_tiles[0]) == 0 and plan.bounds.tolist() == [0, 0]
    for tile in (16, 96 + 1, 512):
        with pytest.raises(ValueError, match="tile"):
            cuda_sweep.tile_plan(ctx.sorted_hash, ctx.grid_size, tile=tile)


# ---------------------------------------------------------------------------
# The kernel's walk, emulated
# ---------------------------------------------------------------------------

def _emulate(pair_fn, pair_fn_b, q, src, seg_start, seg_end, plan, width):
    """The tiled kernel's sums in torch: every candidate of a query read
    from its tile's span, at ``lo`` + (j − lo) with the offset checked to
    lie inside the span; rows in the kernel's order."""
    spans = cuda_sweep.tile_spans(plan, seg_start, seg_end)
    t_of = _tile_of(plan)
    n_rows, n = seg_start.shape
    out = torch.zeros((n, width), dtype=q.dtype)
    for r in range(n_rows):
        qi, sj = row_pairs(seg_start[r], seg_end[r])
        t = t_of[qi]
        lo, ln = spans[t, r, 0], spans[t, r, 1]
        rel = sj - lo
        assert bool(((rel >= 0) & (rel < ln)).all())
        fn = pair_fn if r < N_ROWS else pair_fn_b
        out.index_add_(0, qi, fn(q[qi], src[lo + rel]))
    return out


@pytest.mark.parametrize("tile", [32, 64, 256])
def test_emulated_walk_reproduces_visc_laplacian_plain(tile):
    """The viscous Laplacian of the shear scene's velocities (the CG's
    first matvec) through the tile plans of 32, 64 and 256 queries: equal
    to ``visc_laplacian_sweep_plain``."""
    cfg, params, state, grid, walls = _shear()
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    args = viscosity.laplacian_operands(ctx, params, dens)(vel)
    plan = cuda_sweep.tile_plan(ctx.sorted_hash, ctx.grid_size, tile=tile)
    ref = SP.visc_laplacian_sweep_plain(cfg, *args)
    assert float(ref.abs().max()) > 0.0
    q, src, s, e, pvec = args
    got = _emulate(SP._bind(SP.visc_laplacian_pair, cfg, pvec,
                            boundary=False),
                   SP._bind(SP.visc_laplacian_pair, cfg, pvec,
                            boundary=True), q, src, s, e, plan, 3)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("tile", [32, 64, 256])
def test_emulated_walk_reproduces_pressure_force_plain(tile):
    """The pressure force of the PCISPH block at a seeded pressure (p/ρ²
    in the pd2 slot, as PCISPH's corrective loop writes it) through the
    tile plans of 32, 64 and 256 queries: equal to
    ``pressure_force_sweep_plain``."""
    cfg, params, state, grid, walls = _block()
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    p = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 2e3, ctx.c).astype(np.float32))
    args = pd2_operands(ctx)(p / (dens * dens))
    plan = cuda_sweep.tile_plan(ctx.sorted_hash, ctx.grid_size, tile=tile)
    ref = SP.pressure_force_sweep_plain(cfg, *args)
    assert float(ref.abs().max()) > 0.0
    q, src, s, e, pvec = args
    got = _emulate(SP._bind(SP.grad_pressure_force_pair, cfg, pvec,
                            boundary=False),
                   SP._bind(SP.grad_pressure_force_pair, cfg, pvec,
                            boundary=True, boundary_sign=-1.0),
                   q, src, s, e, plan, 3)
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# Routing and the per-step plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["visc_laplacian", "pressure_force"])
def test_tiled_dispatchers_give_the_plan_to_the_kernel_only(key):
    """On CPU tensors the two tiled sweeps run their plain versions with or
    without a plan and launch nothing; the CUDA wrappers refuse CPU
    tensors, and refuse to launch without a plan."""
    cfg, params, state, grid, walls = _shear()
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    fq = 8 if key == "visc_laplacian" else 4
    q = ctx.queries(ctx.vx, width=fq)
    src = ctx.pack((ctx.vx, ctx.vy, ctx.vz), ctx.px)
    args = (q, src, ctx.seg_start, ctx.seg_end, ctx.pvec)
    dispatch = getattr(SP, f"{key}_sweep")
    plain = getattr(SP, f"{key}_sweep_plain")
    wrapper = getattr(cuda_sweep, f"{key}_sweep")
    cuda_sweep.reset_launches()
    ref = plain(cfg, *args)
    assert torch.equal(dispatch(cfg, *args), ref)
    assert torch.equal(dispatch(cfg, *args, plan=ctx.tile_plan), ref)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(cfg, *args, plan=ctx.tile_plan)
    with pytest.raises(ValueError, match="TilePlan"):
        cuda_sweep._check_plan(None, ctx.c, CPU)
    assert all(k.launches == 0 for k in cuda_sweep.KERNELS)
    assert {cuda_sweep.VISC_LAPLACIAN.name, cuda_sweep.PRESSURE_FORCE.name} \
        == {"tiled_pair_sweep_kernel<ViscLaplacian>",
            "tiled_pair_sweep_kernel<PressureForce>"}


@pytest.mark.parametrize("solver", ["wcsph_implicit", "pcisph", "iisph",
                                    "dfsph_implicit"])
def test_a_step_builds_one_plan(monkeypatch, solver):
    """A step builds its tile plan once, however many times its loops
    launch the tiled sweeps (the CG's matvecs, PCISPH's corrective
    iterations, DFSPH's κ corrections)."""
    built = []
    make = cuda_sweep.tile_plan

    def counted(*a, **k):
        built.append(1)
        return make(*a, **k)
    monkeypatch.setattr(cuda_sweep, "tile_plan", counted)
    calls = []
    for name in ("visc_laplacian_sweep", "pressure_force_sweep"):
        sweep = getattr(SP, name)

        def wrapped(*a, _sweep=sweep, **k):
            calls.append(k.get("plan"))
            return _sweep(*a, **k)
        monkeypatch.setattr(SP, name, wrapped)
    if solver in ("wcsph_implicit", "dfsph_implicit"):
        cfg, params, state, grid, walls = _shear()
        step = pt.wcsph_step if solver == "wcsph_implicit" else pt.dfsph_step
        step(state, params, grid, cfg, walls)
    elif solver == "pcisph":
        cfg, params, state, grid, walls = _block(1000)
        pt.pcisph_step(state, params, grid, cfg, walls,
                       delta=pt.pcisph_delta(params, cfg), tol_frac=0.001)
    else:
        cfg, base, state, grid, walls = _block(1000)
        params = pt.calibrate_mass(pt.iisph_params(device=CPU), cfg,
                                   spacing=0.8 * float(
                                       base.interaction_radius))
        pt.iisph_step(state, params, grid, cfg, walls)
    assert len(built) == 1
    assert len(calls) >= 2 or solver == "iisph"
    assert len(calls) >= 1 and all(
        isinstance(c, cuda_sweep.TilePlan) and c is calls[0] for c in calls)
