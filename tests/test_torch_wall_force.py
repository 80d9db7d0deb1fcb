"""The port's wall-only force sweep (``ops/sph_pairs.py::
boundary_force_sweep``, the plain twin of the ``WallForce`` kernel) vs the
JAX package's ``pallas_sph.boundary_force_sweep`` in interpret mode, and
the identity fused force − fluid-only force = wall-only force (CPU).

The JAX sweep has no caller in its package; it is run here as the coupled
step runs its body sweeps: a window plan of the wall samples alone
(``plan_windows`` over the walls' sorted hashes, 9 rows, the default
block and window) and the walls packed by ``pack_source``. Both sides get
the same hash-sorted queries (``x y z v ρ pd2``, ρ and pd2 from the port's
density). Tolerance max|Δ| ≤ 1e-5·max|ref| per column: float32 sums in
another order (windows against per-row ``index_add_``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import grid as jgrid
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.ops.pallas_neighbors import (anchors_pack16, hash_payload,
                                             pack_source, plan_windows)
from nereus_tpu.solvers.pallas_common import build_pallas_ctx, padded_len

import nereus_tpu_torch as pt
from nereus_tpu_torch import grid as pgrid
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, exact_reciprocal, jax_scene,
                          to_port)

torch.set_num_threads(1)

KERNEL_SETS = [jt.KernelSet.MULLER, jt.KernelSet.MONAGHAN]


@functools.cache
def _jax_plan():
    """The half of JAX's operands that no kernel set changes, built once:
    the fluid's sweep context (hash-sorted, padded queries) and the window
    plan of the wall samples alone: ``(pos, jctx, anchors)``."""
    cfg, params, state, grid, walls = jax_scene(True, KERNEL_SETS[0],
                                                floor=-0.095)
    cfg = jt.SimConfig(kernel_set=KERNEL_SETS[0], sweep_fused_rows=False)
    jctx = build_pallas_ctx(state, params, grid, cfg, None)
    assert jctx.rows_local == 9
    win = cfg.resolve_win(False)
    mb = walls.num_boundaries
    coords = jgrid.cell_coords_cols(grid, jctx.px, jctx.py, jctx.pz)
    anchors, miss = plan_windows(
        walls.sorted_hash, coords, grid.size, cfg.resolve_block(False),
        padded_len(mb, win), active_mask=jctx.active, win=win,
        pack16=anchors_pack16(padded_len(mb, win), win), rows_local=9)
    assert int(miss) == 0
    return np.asarray(state.pos), jctx, anchors


@functools.cache
def _operands(kernel_set):
    """JAX's and the port's force queries and wall sources on the small
    dam-break with its floor 0.02 under the bottom layer (27 queries with
    wall terms), seeded velocities: ``(cfg, jax_args, port_args, c)``."""
    cfg, params, state, grid, walls = jax_scene(True, kernel_set,
                                                floor=-0.095)
    cfg = jt.SimConfig(kernel_set=kernel_set, sweep_fused_rows=False)
    pcfg, pparams, pstate, pg, pwalls = to_port(cfg, params, state, grid,
                                                walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pwalls)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dens = SP.density_sweep_plain(pcfg, *ctx.density_operands(
        pparams.particle_mass))
    ds = dens.clamp(min=1e-12)
    pd2 = pt.tait_pressure(dens, pparams) / (ds * ds)
    q8 = ctx.queries(*vel, dens, pd2)
    w_start, w_end = pgrid.row_segments(pg, pwalls.sorted_hash, ctx.coords)
    port = (pcfg, q8, ctx.b_src, w_start, w_end, ctx.pvec)

    pos, jctx, anchors = _jax_plan()
    np.testing.assert_array_equal(np.asarray(state.pos), pos)
    c, cb = jctx.c, jctx.cb
    pad = jnp.zeros((cb - c,), jnp.float32)
    jq = jctx.queries(jctx.vx, jctx.vy, jctx.vz,
                      jnp.concatenate([jnp.asarray(dens.numpy()), pad]),
                      jnp.concatenate([jnp.asarray(pd2.numpy()), pad]))
    np.testing.assert_array_equal(np.asarray(jq)[:c], q8.numpy())
    jsrc = pack_source(tuple(walls.pos[:, k] for k in range(3)),
                       hash_payload(walls.sorted_hash, jnp.float32,
                                    grid.size),
                       dens_or_psi=walls.psi, win=cfg.resolve_win(False))
    pvec = PS.build_pvec(params, cfg, grid)
    return cfg, (jq, jsrc, anchors, pvec, grid.size), port, c


@pytest.mark.parametrize("include_pressure", [True, False],
                         ids=["pressure", "no-pressure"])
@pytest.mark.parametrize("kernel_set", KERNEL_SETS,
                         ids=[k.name.lower() for k in KERNEL_SETS])
def test_wall_force_matches_jax(exact_reciprocal, kernel_set,
                                include_pressure):
    cfg, (jq, jsrc, anchors, pvec, gsize), port, c = _operands(kernel_set)
    want = PS.boundary_force_sweep(cfg, jq, jsrc, anchors, pvec, gsize,
                                   include_pressure=include_pressure,
                                   interpret=True)
    got = SP.boundary_force_sweep(*port, include_pressure=include_pressure)
    assert got.shape == (c, 3)
    assert int((got.abs().sum(dim=1) > 0).sum()) > 20
    assert_columns_close(got.numpy(), np.asarray(want)[:c], 1e-5,
                         f"wall force {kernel_set.name} {include_pressure}")


@pytest.mark.parametrize("kernel_set", KERNEL_SETS,
                         ids=[k.name.lower() for k in KERNEL_SETS])
def test_fused_minus_fluid_is_wall_force(kernel_set):
    """The fused force sweep (fluid rows 0-8, wall rows 9-17) minus the
    same sweep with the wall ranges emptied equals the wall-only sweep, for
    both pressure switches; the pressure switch changes the wall force."""
    pcfg, q8, b_src, w_start, w_end, pvec = _operands(kernel_set)[2]
    cfg, params, state, grid, walls = jax_scene(True, kernel_set,
                                                floor=-0.095)
    _, pparams, pstate, pg, pwalls = to_port(cfg, params, state, grid,
                                             walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pwalls)
    np.testing.assert_array_equal((ctx.seg_start[9:] - ctx.c).numpy(),
                                  w_start.numpy())
    src = torch.cat([q8, b_src])
    fluid_end = ctx.seg_end.clone()
    fluid_end[9:] = ctx.seg_start[9:]
    walls_only = {}
    for p in (True, False):
        full = SP.fluid_force_sweep(pcfg, q8, src, ctx.seg_start,
                                    ctx.seg_end, pvec, include_pressure=p)
        fluid = SP.fluid_force_sweep(pcfg, q8, src, ctx.seg_start,
                                     fluid_end, pvec, include_pressure=p)
        walls_only[p] = SP.boundary_force_sweep(pcfg, q8, b_src, w_start,
                                                w_end, pvec,
                                                include_pressure=p)
        assert_columns_close((full - fluid).numpy(), walls_only[p].numpy(),
                             1e-5, f"identity {kernel_set.name} {p}")
    assert not torch.equal(walls_only[True], walls_only[False])
