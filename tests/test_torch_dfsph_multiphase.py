"""The port's multiphase DFSPH step and its three sweeps vs the JAX package
(CPU, plain sweeps), on ``tests/test_torch_multiphase.py``'s contact scene
(the two-layer tank of ``tests/test_multiphase.py``, 128 particles in two
phases at a ρ₀ ratio 1 : 0.4, settled until the floor lies inside h).

* The plain twin of the multiphase density and α̂ in one walk (nine
  columns) against interpret-mode ``generic_sweep`` with
  ``multiphase_density_pair``/``_bpair`` and ``multiphase_alpha_pair``/
  ``_bpair``, with walls and without, both kernel sets: max|Δ| ≤
  1e-5·max|ref| per live column.
* The multiphase α, dδ̂/dt and κV̂² plain sweeps against interpret-mode
  ``generic_sweep`` with ``multiphase_alpha_pair``/``_bpair``,
  ``multiphase_drho_pair``/``_bpair`` and ``multiphase_kappa_pair``/
  ``_bpair`` on the same sorted operands, walls in contact, both kernel
  sets: max|Δ| ≤ 1e-5·max|ref| per output column (float32 sums in another
  order). dδ̂/dt on its one matrix (``MultiphaseKappaSweeps.
  drho_operands``, the queries a view of its first rows) against JAX's
  ``d[:, 0] + sm * d[:, 1]``, also with the light phase's mass scaled so
  that s_i/m_i differs by phase.
* ``dfsph_step`` on a multiphase state against JAX's Pallas step
  (interpret) over two steps, in one canonical order: positions rtol 2e-4
  / atol 2e-6, velocities rtol 2e-3 / atol 2e-4, mass and ρ₀ equal,
  ``solver_iters`` equal. κ̂ is not compared: near rest it cancels as the
  single-phase κ does.
* A mirror of ``test_multiphase.py::test_dfsph_multiphase_reduces_to_
  single_phase`` (uniform phase columns reproduce the port's single-phase
  DFSPH step), parked slots, the loops' host reads, and the JAX multiphase
  step's refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.boundary import box_boundary
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass
from nereus_tpu.scene import particle_cube
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import dfsph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_multiphase import two_layer
from test_torch_multiphase import canon, contact
from torch_bridge import assert_columns_close, to_port

torch.set_num_threads(1)

ST = jt.SurfaceTensionModel


def _kv2(px):
    """A positive stand-in for κV̂² on the sorted x column (either
    package's), the same float32 values on both sides."""
    return abs(px) * 1e-3 + 1e-4


def _jax_sweeps(cfg, params, state, grid, boundary):
    """``dfsph_multiphase_pallas``'s α, dδ̂/dt (on the state's velocities)
    and κV̂² (on :func:`_kv2`, qc = 0.7·κV̂²) sweeps."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    kw = dict(n_rows=ctx.n_rows, interpret=True)
    c = ctx.c
    al = PS.generic_sweep(cfg, PS.multiphase_alpha_pair,
                          ctx.queries(width=4),
                          ctx.pack(slot6=1.0 / ctx.mass), *geo, out_width=8,
                          pair_fn_b=PS.multiphase_alpha_bpair, **kw)
    v = (ctx.vx, ctx.vy, ctx.vz)
    d = PS.generic_sweep(cfg, PS.multiphase_drho_pair,
                         ctx.queries(*v, width=8), ctx.pack(vel=v), *geo,
                         out_width=4, pair_fn_b=PS.multiphase_drho_bpair,
                         **kw)
    kv2 = _kv2(ctx.px)
    f = PS.generic_sweep(cfg, PS.multiphase_kappa_pair,
                         ctx.queries(kv2, 0.7 * kv2), ctx.pack(slot6=kv2),
                         *geo, out_width=4,
                         pair_fn_b=PS.multiphase_kappa_bpair, **kw)
    return (al[:c, :7], d[:c, :2], f[:c, :3], ctx.rho0[:c], ctx.mass[:c])


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_shared_density_alpha_matrix(contact, kernel_set):
    """The multiphase DFSPH step's one matrix
    (``dfsph_cuda.multiphase_alpha_operands``: fluid rows ``x y z 1/m``,
    then the walls ``x y z ψ_b``, the queries a view of its first rows)
    gives the multiphase density sweep the same δ and Σψ_bW, and the
    multiphase density and α̂ sweep the same nine sums, bit for bit, as the
    two matrices the step built before (each a column stack ``x y z 0`` /
    ``x y z 1/m`` with the walls copied behind it); the wall column is
    live."""
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas", kernel_set=kernel_set,
                       surface_tension_model=ST.NONE)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    args = dfsph_cuda.multiphase_alpha_operands(ctx)
    q, src = args[:2]
    assert q.data_ptr() == src.data_ptr() and q.shape == (ctx.c, 4)
    assert torch.equal(q[:, 3], 1.0 / ctx.mass)
    rng = args[2:]
    qd = ctx.queries(width=4)
    qa = ctx.queries(1.0 / ctx.mass)
    dout = SP.multiphase_density_sweep(pcfg, *args)
    assert torch.equal(dout, SP.multiphase_density_sweep(
        pcfg, qd, ctx.pack_psi(qd), *rng))
    assert float(dout[:, 1].abs().max()) > 0.0
    fused = SP.multiphase_density_alpha_sweep(pcfg, *args)
    assert torch.equal(fused[:, :2], dout)
    assert torch.equal(fused[:, 2:], SP.multiphase_alpha_sweep_plain(
        pcfg, qa, ctx.pack_psi(qa), *rng))


# the wall sums of the multiphase density and α̂ sweep's nine columns
WALL_COLS = (1, 6, 7, 8)


@pytest.mark.parametrize("with_walls", [True, False],
                         ids=["walls", "no-walls"])
@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_multiphase_density_alpha_twin_matches_jax(contact, kernel_set,
                                                   with_walls):
    """The plain twin of the fused multiphase density and α̂ kernel (nine
    planes δ, Σψ_bW, G, S, B) on the step's one matrix
    (``dfsph_cuda.multiphase_alpha_operands``) against interpret-mode
    ``generic_sweep`` with ``multiphase_density_pair``/``_bpair`` and
    ``multiphase_alpha_pair``/``_bpair`` on the same sorted state, with
    the walls in contact and without walls: max|Δ| ≤ 1e-5·max|ref| per
    column (float32 sums in another order); without walls the four wall
    columns exactly 0 on both sides."""
    state, params, grid, walls = contact
    walls = walls if with_walls else None
    cfg = jt.SimConfig(engine="pallas", kernel_set=kernel_set,
                       surface_tension_model=ST.NONE)

    def jax_sums(s):
        ctx = build_pallas_ctx(s, params, grid, cfg, walls)
        geo = (ctx.anchors, ctx.pvec, ctx.gsize)
        kw = dict(n_rows=ctx.n_rows, interpret=True)
        q, src = ctx.queries(width=4), ctx.pack(slot6=1.0 / ctx.mass)
        dout = PS.generic_sweep(cfg, PS.multiphase_density_pair, q, src,
                                *geo, out_width=4,
                                pair_fn_b=PS.multiphase_density_bpair, **kw)
        al = PS.generic_sweep(cfg, PS.multiphase_alpha_pair, q, src, *geo,
                              out_width=8,
                              pair_fn_b=PS.multiphase_alpha_bpair, **kw)
        return jnp.concatenate([dout[:ctx.c, :2], al[:ctx.c, :7]], axis=1)
    want = np.asarray(jax.jit(jax_sums)(state))
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == (18 if with_walls else 9)
    got = SP.multiphase_density_alpha_sweep(
        pcfg, *dfsph_cuda.multiphase_alpha_operands(ctx)).numpy()
    assert got.shape == want.shape == (ctx.c, 9)
    live = [c for c in range(9) if with_walls or c not in WALL_COLS]
    assert_columns_close(got[:, live], want[:, live], 1e-5,
                         f"density and alpha, walls {with_walls}")
    if not with_walls:
        assert not got[:, WALL_COLS].any() and not want[:, WALL_COLS].any()


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_multiphase_dfsph_sweeps_match_jax(contact, kernel_set):
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas", kernel_set=kernel_set,
                       surface_tension_model=ST.NONE)
    al, d, f, rho0, mass = jax.jit(lambda s: _jax_sweeps(
        cfg, params, s, grid, walls))(state)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    got = SP.multiphase_density_alpha_sweep(
        pcfg, *dfsph_cuda.multiphase_alpha_operands(ctx))[:, 2:]
    assert_columns_close(got.numpy(), np.asarray(al), 1e-5, "alpha")
    # dδ̂/dt at s_i/m_i = 1/m (m ∝ ρ0), then with the light phase's mass
    # scaled by 1.5: s_i/m_i then differs by phase, so a wrong slot 6
    # shows; JAX's d does not read the mass, its sm does
    vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], 1)
    got_by_mass = []
    for scale in (1.0, 1.5):
        light = jnp.where(rho0 < jnp.max(rho0), scale, 1.0)
        sm = (rho0 / params.rest_density) / (mass * light)
        want = np.asarray(d[:, 0] + sm * d[:, 1])
        pmass = pstate.mass * torch.where(
            pstate.rho0 < pstate.rho0.max(), scale, 1.0)
        mctx = build_sweep_ctx(dataclasses.replace(pstate, mass=pmass),
                               pparams, pg, pcfg, pb)
        sweeps = dfsph_cuda.MultiphaseKappaSweeps(mctx, pparams, pcfg,
                                                  torch.ones_like(ctx.px))
        first = SP.multiphase_drho_sweep(pcfg, *sweeps.drho_operands(-vel))
        q, src, s, e, pv = sweeps.drho_operands(vel)
        # one write: the queries are a view of the matrix's first C rows,
        # the walls as the step packs them
        assert q.data_ptr() == src.data_ptr() and q.shape == (ctx.c, 8)
        assert torch.equal(src[:ctx.c, 3:6], vel)
        assert torch.equal(src[ctx.c:], mctx.b_src)
        got = SP.multiphase_drho_sweep(pcfg, q, src, s, e, pv)
        assert not torch.equal(first, got)
        assert_columns_close(got.numpy()[:, None], want[:, None], 1e-5,
                             f"drho, light phase's mass ×{scale}")
        assert torch.equal(got, sweeps.drho(vel))
        got_by_mass.append(got)
    assert len(np.unique(np.asarray(sm)[:int(state.num_active)])) == 2
    assert not torch.equal(*got_by_mass)
    kv2 = _kv2(ctx.px)
    q = ctx.queries(kv2, 0.7 * kv2, width=8)
    src = ctx.pack_psi(ctx.queries(kv2))
    got = SP.multiphase_kappa_sweep(pcfg, q, src, ctx.seg_start, ctx.seg_end,
                                    ctx.pvec)
    assert_columns_close(got.numpy(), np.asarray(f), 1e-5, "kappa")
    # the wall rows are live
    fluid_only = SP.multiphase_kappa_sweep(pcfg, q, src, ctx.seg_start[:9],
                                           ctx.seg_end[:9], ctx.pvec)
    assert not torch.equal(fluid_only, got)


@pytest.mark.parametrize("st,st_cross", [(ST.NONE, 0.0), (ST.BECKER, 0.25)],
                         ids=["none", "becker"])
def test_multiphase_dfsph_step_matches_jax(contact, st, st_cross):
    """Two steps from the wall-contacting state: the second from JAX's
    Pallas state after the first, warm-started from its κ̂."""
    state, params, grid, walls = contact
    n = int(state.num_active)
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=st,
                       st_cross=st_cross)
    jstep = jax.jit(lambda s: jt.dfsph_step(s, params, grid, cfg, walls))
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                walls)
        s_port, d_port = pt.dfsph_step(pstate, pparams, pg, pcfg, pb)
        s_ref, d_ref = jstep(state)
        msg = f"step {step}"
        assert int(d_ref.seg_overflow) == 0, msg
        assert int(d_port.solver_iters) == int(d_ref.solver_iters), msg
        po, vo, mo, ro = canon(s_port, n)
        pr, vr, mr, rr = canon(s_ref, n)
        np.testing.assert_allclose(po, pr, rtol=2e-4, atol=2e-6, err_msg=msg)
        np.testing.assert_allclose(vo, vr, rtol=2e-3, atol=2e-4, err_msg=msg)
        np.testing.assert_array_equal(mo, mr, err_msg=msg)
        np.testing.assert_array_equal(ro, rr, err_msg=msg)
        np.testing.assert_allclose(float(d_port.max_density),
                                   float(d_ref.max_density), rtol=1e-5,
                                   err_msg=msg)
        state = s_ref
    assert float(jnp.max(state.pressure)) > 0.0
    assert float(s_port.pressure.min()) >= 0.0


def test_dfsph_multiphase_reduces_to_single_phase():
    """``test_multiphase.py::test_dfsph_multiphase_reduces_to_single_phase``
    on the port: uniform phase columns (m_i = m, ρ0_i = ρ₀) reproduce the
    single-phase DFSPH step over 10 free-fall and contact steps, with the
    same iteration counts."""
    base = jt.dfsph_params()
    sp = 0.8 * float(base.interaction_radius)
    cfg = jt.SimConfig(engine="segments", surface_tension_model=ST.NONE)
    params = calibrate_mass(base, cfg, spacing=sp)
    pm = float(params.particle_mass)
    rd = float(params.rest_density)
    h = float(params.interaction_radius)
    side = 5 * sp
    pos = particle_cube((side / 2 + 2 * sp,) * 3, (side,) * 3, sp)
    n = len(pos)
    lo = np.zeros(3)
    hi = np.array([side + 4 * sp, 2.5 * side, side + 4 * sp])
    grid = jt.fit_grid(lo - h, hi + h, h)
    walls = box_boundary(grid, lo, hi, float(params.particle_radius),
                         params)
    pcfg, pparams, s1, pg, pb = to_port(cfg, params,
                                        jt.make_fluid_state(pos), grid,
                                        walls)
    s2 = to_port(cfg, params, jt.make_fluid_state(
        pos, masses=pm, rest_densities=rd), grid, walls)[2]
    assert s2.multiphase and not s1.multiphase
    for i in range(10):
        s1, d1 = pt.dfsph_step(s1, pparams, pg, pcfg, pb)
        s2, d2 = pt.dfsph_step(s2, pparams, pg, pcfg, pb)
        assert int(d1.solver_iters) == int(d2.solver_iters), i
    np.testing.assert_allclose(s2.pos.numpy()[:n], s1.pos.numpy()[:n],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(s2.vel.numpy()[:n], s1.vel.numpy()[:n],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(d2.mean_density_error),
                               float(d1.mean_density_error), atol=1e-6)


def test_multiphase_dfsph_parked_slots_stay_parked():
    """Slots past the live count (parked at 1e9, the first particle's
    phase, no neighbors: δ̂ = 0, so V̂² = 1/max(δ̂², 1e-24)) stay parked,
    and every output stays finite."""
    state, params, grid, walls, _ = two_layer(side_cells=3,
                                              base_params=jt.dfsph_params())
    n = int(state.num_active)
    padded = jt.make_fluid_state(np.asarray(state.pos)[:n],
                                 np.asarray(state.vel)[:n], capacity=n + 32,
                                 masses=np.asarray(state.mass)[:n],
                                 rest_densities=np.asarray(state.rho0)[:n])
    pcfg, pparams, s, pg, pb = to_port(jt.SimConfig(), params, padded, grid,
                                       walls)
    for _ in range(3):
        s, diag = pt.dfsph_step(s, pparams, pg, pcfg, pb)
    assert np.all(s.pos.numpy()[n:] == np.float32(1e9))
    for t in (s.pos, s.vel, s.pressure, diag.mean_density_error):
        assert np.isfinite(t.numpy()).all()


@pytest.mark.parametrize("sync_every", [1, 3])
def test_multiphase_loops_sync_once_per_k_iterations(contact, monkeypatch,
                                                     sync_every):
    """Both multiphase loops read their condition once per SYNC_EVERY
    launched iterations and freeze the carry past their end: the result
    does not depend on SYNC_EVERY."""
    state, params, grid, walls = contact
    pcfg, pparams, pstate, pg, pb = to_port(jt.SimConfig(), params, state,
                                            grid, walls)
    kw = dict(tol=0.05, tol_v=0.05)
    for name in ("SYNC_EVERY", "SYNC_EVERY_V"):
        monkeypatch.setattr(dfsph_cuda, name, 1)
    s_1, d_1 = pt.dfsph_step(pstate, pparams, pg, pcfg, pb, **kw)
    for name in ("SYNC_EVERY", "SYNC_EVERY_V"):
        monkeypatch.setattr(dfsph_cuda, name, sync_every)
    dfsph_cuda.LOOP.reset()
    dfsph_cuda.LOOP_V.reset()
    s_k, d_k = pt.dfsph_step(pstate, pparams, pg, pcfg, pb, **kw)
    it = int(d_k.solver_iters)
    assert it == int(d_1.solver_iters)
    assert it > pcfg.dfsph_min_iters + pcfg.dfsph_min_iters_v
    assert torch.equal(s_k.vel, s_1.vel)
    assert torch.equal(s_k.pressure, s_1.pressure)
    for loop in (dfsph_cuda.LOOP, dfsph_cuda.LOOP_V):
        last = loop.last
        assert bool(last.err <= last.tol) or int(last.it) == last.max_iters
        assert int(last.it) <= loop.launched < int(last.it) + sync_every


def test_multiphase_dfsph_refusals():
    """The JAX multiphase DFSPH step's refusals, with its reasons (AKINCI
    surface tension, implicit viscosity); moving walls, once refused, are
    ported: a wall set at velocity 0 reproduces the static step."""
    state, params, grid, walls, _ = two_layer(side_cells=3)
    pcfg, pparams, s, pg, pb = to_port(jt.SimConfig(), params, state, grid,
                                       walls)
    cases = [
        (dataclasses.replace(pcfg, viscosity_model="implicit"), pb,
         "implicit viscosity is single-phase-only"),
        (dataclasses.replace(
            pcfg, surface_tension_model=pt.SurfaceTensionModel.AKINCI), pb,
         "AKINCI surface tension is single-phase-only"),
    ]
    for c, b, reason in cases:
        with pytest.raises(NotImplementedError, match=reason):
            pt.dfsph_step(s, pparams, pg, c, b)
    s0, _ = pt.dfsph_step(s, pparams, pg, pcfg, pb)
    s1, _ = pt.dfsph_step(s, pparams, pg, pcfg, dataclasses.replace(
        pb, vel=torch.zeros_like(pb.pos)))
    assert torch.equal(s0.pos, s1.pos) and torch.equal(s0.vel, s1.vel)
    # the JAX step refuses the same two configurations
    for c, _, reason in cases[:2]:
        jcfg = dataclasses.replace(
            jt.SimConfig(), viscosity_model=c.viscosity_model,
            surface_tension_model=ST[c.surface_tension_model.name])
        with pytest.raises(NotImplementedError, match=reason):
            jt.dfsph_step(state, params, grid, jcfg, walls)
