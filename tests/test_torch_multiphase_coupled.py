"""The port's multiphase coupled WCSPH step vs the JAX package (CPU, plain
sweeps), mirroring ``tests/test_multiphase_coupled.py``.

* The ``MultiphaseBody`` plain twin against JAX's ``multiphase_body_pair``
  summed over every (query, sample) pair within h, on the step's own
  operands: max|Δ| ≤ 1e-5·max|ref| per column.
* ``wcsph_coupled_step`` on ``test_torch_multiphase.py``'s settled
  two-phase tank in wall contact, with a moving, spinning body parked in
  the fluid, against JAX's Pallas step (interpret mode) over two steps:
  fluid positions atol 1e-6 and velocities atol 1e-4 in sorted order,
  mass and ρ₀ equal, body com and R atol 1e-6, velocity atol 1e-5,
  ω atol 1e-4 (``test_mp_coupled_engines_match``'s tolerances).
* At uniform phase columns the multiphase coupled step gives the
  single-phase one's reaction (body velocity rtol 1e-4, ω rtol 1e-3, max
  density rtol 1e-5, as ``test_mp_body_contact_reduces_to_single_phase``);
  the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import coupled_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_multiphase import two_layer
from test_torch_multiphase import canon, contact
from torch_bridge import (assert_columns_close, body_to_port, dense_pairs,
                          exact_reciprocal, to_port)

torch.set_num_threads(1)

ST = jt.SurfaceTensionModel


def _parked_body(state, params, density=400.0):
    """``test_mp_coupled_engines_match``'s 0.06 box parked mid-column (at
    the 0.6 height quantile), here moving and spinning."""
    n = int(state.num_active)
    p = np.asarray(state.pos)[:n]
    center = (float(p[:, 0].mean()), float(np.quantile(p[:, 1], 0.6)),
              float(p[:, 2].mean()))
    body = jt.make_rigid_box(center, (0.06,) * 3,
                             float(params.particle_radius), density, params)
    return dataclasses.replace(
        body, vel=jnp.asarray([0.05, -0.1, 0.02], jnp.float32),
        omega=jnp.asarray([0.2, -0.1, 0.3], jnp.float32))


def test_multiphase_body_twin_matches_jax(contact):
    """The multiphase body contact's plain twin on the step's operands,
    and on them with bp = 0 (its friction alone, ~1e-10 of the pressure
    term here), against ``multiphase_body_pair`` over every pair within h;
    the friction reads the sample velocities."""
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    body = _parked_body(state, params)
    shells = coupled_cuda.body_shells(ctx, pg, (body_to_port(body),))
    _, q8b, _, pres = coupled_cuda.coupled_multiphase_operands(
        ctx, pparams, pcfg, shells)
    sh = shells[0]
    assert float(pres.max()) > 0.0
    pv = PS.build_pvec(params, cfg, grid)
    src = jnp.asarray(sh.src.numpy().T)
    # as the step runs it, then the friction alone (bp = 0)
    fric = q8b.clone()
    fric[:, 6] = 0.0
    for name, q in (("multiphase body", q8b), ("friction", fric)):
        got = SP.multiphase_body_sweep(pcfg, q, sh.src, sh.seg_start,
                                       sh.seg_end, ctx.pvec)
        jq = jnp.asarray(q.numpy())
        want = PS.multiphase_body_pair(
            jq, src, jnp.ones((jq.shape[0], src.shape[1]), bool), pv,
            kernel_set=cfg.kernel_set)
        assert_columns_close(got.numpy(), np.asarray(want)[:, :3], 1e-5,
                             name)
    # the friction reads the sample velocities
    still = SP.multiphase_body_sweep(
        pcfg, fric, sh.src.clone().index_fill_(1, torch.tensor([3, 4, 5]),
                                               0.0),
        sh.seg_start, sh.seg_end, ctx.pvec)
    assert float((still - got).abs().max()) > 1e-3 * float(got.abs().max())


def test_mp_coupled_matches_jax(exact_reciprocal, contact):
    """Two multiphase coupled steps against JAX's Pallas step."""
    state, params, grid, walls = contact
    n = int(state.num_active)
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE)
    body = _parked_body(state, params)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    step = jax.jit(lambda s, b: jt.wcsph_coupled_step(s, params, grid, cfg,
                                                      b, walls))
    js, jb, ps, pb = state, body, pstate, body_to_port(body)
    for it in range(2):
        js, jb, jd = step(js, jb)
        ps, pb, pd = pt.wcsph_coupled_step(ps, pparams, pg, pcfg, pb, pw)
        po, vo, mo, ro = canon(js, n)
        pp, vp, mp, rp = canon(ps, n)
        np.testing.assert_allclose(pp, po, rtol=0, atol=1e-6, err_msg=it)
        np.testing.assert_allclose(vp, vo, rtol=0, atol=1e-4, err_msg=it)
        np.testing.assert_array_equal(mp, mo)
        np.testing.assert_array_equal(rp, ro)
        for f, atol in (("com", 1e-6), ("R", 1e-6), ("vel", 1e-5),
                        ("omega", 1e-4)):
            np.testing.assert_allclose(getattr(pb, f).numpy(),
                                       np.asarray(getattr(jb, f)), rtol=0,
                                       atol=atol, err_msg=f"{it} {f}")
        assert int(jd.seg_overflow) == 0 and int(pd.seg_overflow) == 0
    assert float(torch.linalg.norm(pb.omega - torch.tensor(
        [0.2, -0.1, 0.3]))) > 1.0


def test_mp_body_contact_reduces_to_single_phase():
    """At uniform phase (mass m, ρ₀ everywhere) the multiphase coupled step
    gives the single-phase step's reaction on a body parked in the fluid
    (the port alone, the tank settled by the port's multiphase step)."""
    state, params, grid, walls, _ = two_layer(ratio_top=1.0, vel_y=-1.0,
                                              side_cells=4)
    cfg = jt.SimConfig(surface_tension_model=ST.NONE)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    for _ in range(40):
        pstate, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pw)
    n = int(pstate.num_active)
    body = body_to_port(_parked_body(
        dataclasses.replace(state, pos=jnp.asarray(pstate.pos.numpy())),
        params))
    s_mp, b_mp, d_mp = pt.wcsph_coupled_step(pstate, pparams, pg, pcfg, body,
                                             pw)
    single = pt.FluidState(pos=pstate.pos, vel=pstate.vel,
                           pressure=pstate.pressure,
                           num_active=pstate.num_active)
    s_sp, b_sp, d_sp = pt.wcsph_coupled_step(single, pparams, pg, pcfg,
                                             body, pw)
    assert float(torch.linalg.norm(b_mp.vel - body.vel)) > 1e-3
    np.testing.assert_allclose(b_mp.vel.numpy(), b_sp.vel.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(b_mp.omega.numpy(), b_sp.omega.numpy(),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(d_mp.max_density),
                               float(d_sp.max_density), rtol=1e-5)
    assert np.isfinite(s_mp.pos.numpy()[:n]).all()


def test_mp_coupled_gates():
    """AKINCI surface tension and implicit viscosity refuse multiphase
    coupling, with the JAX step's reasons."""
    state, params, grid, walls, _ = two_layer(side_cells=3)
    body = jt.make_rigid_box((0.2, 0.5, 0.2), (0.06,) * 3,
                             float(params.particle_radius), 400.0, params)
    pcfg, pparams, pstate, pg, pw = to_port(jt.SimConfig(), params, state,
                                            grid, walls)
    pbody = body_to_port(body)
    for c in (dataclasses.replace(
            pcfg, surface_tension_model=pt.SurfaceTensionModel.AKINCI),
            dataclasses.replace(pcfg, viscosity_model="implicit")):
        with pytest.raises(NotImplementedError, match="single-phase-only"):
            pt.wcsph_coupled_step(pstate, pparams, pg, c, pbody, pw)
        jcfg = dataclasses.replace(
            jt.SimConfig(engine="segments"),
            viscosity_model=c.viscosity_model,
            surface_tension_model=ST[c.surface_tension_model.name])
        with pytest.raises(NotImplementedError, match="single-phase-only"):
            jt.wcsph_coupled_step(state, params, grid, jcfg, body, walls)


# ---------------------------------------------------------------------------
# Multiphase DFSPH with rigid bodies (the adapted-domain Gauss–Seidel
# interface, ``dfsph_coupled_step``)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_dfsph_mp_body_twins_match_jax(contact, kernel_set):
    """The multiphase DFSPH step's body sweeps on its first divergence
    iteration (the body parked in the settled two-phase tank, moving and
    spinning) against JAX's pair functions over every pair within h: the
    body forms ``multiphase_alpha_bpair`` (columns 4-6; 0-3 exactly 0),
    ``multiphase_drho_bpair`` (column 1; column 0 exactly 0) and
    ``multiphase_kappa_bpair`` over the shell alone, the friction
    (``multiphase_body_pair`` at bp = 0), and the fluid and wall κV̂²
    correction (``multiphase_kappa_sweep``: ``multiphase_kappa_pair`` over
    the fluid rows plus ``multiphase_kappa_bpair`` over the walls),
    max|Δ| ≤ 1e-5·max|ref|."""
    from nereus_tpu_torch.solvers import dfsph_coupled_cuda as DC
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE,
                       kernel_set=kernel_set)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    body = body_to_port(_parked_body(state, params))
    (t,) = DC.body_terms(ctx, pg, (body,))
    bv = (body.vel, body.omega)
    dens, _, alpha = DC.coupled_density_alpha_multiphase(
        ctx, pparams, pcfg, [t])
    sweeps = DC.MultiphaseCoupledSweeps(ctx, pparams, pcfg, dens, [t])
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dhat = torch.clamp(sweeps.drho(v, [bv]), min=0.0)
    kargs = sweeps.kappa_operands(dhat * alpha / float(params.dt))
    assert float(kargs[0][:, 4].abs().max()) > 0.0
    rows = t.ranges(ctx.pvec)
    src_v = t.src_at(bv).clone()
    inv_rho = 1.0 / torch.clamp(dens, min=1e-12)
    zero = torch.zeros_like(dens)
    q8b = ctx.queries(ctx.vx, ctx.vy, ctx.vz, zero,
                      ctx.mass * inv_rho * inv_rho)
    q4 = ctx.queries(width=4)
    pv = PS.build_pvec(params, cfg, grid)
    ks = kernel_set
    # the correction's (C + Mb, 4) source with its scalar in JAX's slot 6
    src8 = torch.zeros((kargs[1].shape[0], 8))
    src8[:, :3] = kargs[1][:, :3]
    src8[:, 6] = kargs[1][:, 3]
    al = SP.multiphase_alpha_body_sweep(pcfg, q4, t.src4, *rows)
    dr = SP.multiphase_drho_body_sweep(pcfg, sweeps.q_v, src_v, *rows)
    fric = SP.multiphase_body_sweep(pcfg, q8b, src_v, *rows)
    cases = (
        ("alpha", al[:, 4:7],
         dense_pairs(PS.multiphase_alpha_bpair, q4, t.shell.src, pv,
                     kernel_set=ks)[:, 4:7]),
        ("drho", dr[:, 1],
         dense_pairs(PS.multiphase_drho_bpair, sweeps.q_v, src_v, pv,
                     kernel_set=ks)[:, 1]),
        ("kappa", SP.multiphase_kappa_body_sweep(pcfg, kargs[0], t.src4,
                                                 *rows),
         dense_pairs(PS.multiphase_kappa_bpair, kargs[0], t.shell.src, pv,
                     kernel_set=ks)[:, :3]),
        ("friction", fric,
         dense_pairs(PS.multiphase_body_pair, q8b, src_v, pv,
                     kernel_set=ks)[:, :3]),
        ("kappa fluid and walls", SP.multiphase_kappa_sweep(pcfg, *kargs),
         dense_pairs(PS.multiphase_kappa_pair, kargs[0], src8[:ctx.c], pv,
                     kernel_set=ks)[:, :3]
         + dense_pairs(PS.multiphase_kappa_bpair, kargs[0], src8[ctx.c:],
                       pv, kernel_set=ks)[:, :3]))
    for name, got, want in cases:
        assert_columns_close(got.numpy(), want, 1e-5, name)
    assert float(al[:, :4].abs().max()) == 0.0
    assert float(dr[:, 0].abs().max()) == 0.0
    still = src_v.clone()
    still[:, 3:6] = 0.0
    other = SP.multiphase_body_sweep(pcfg, q8b, still, *rows)
    assert float((other - fric).abs().max()) > 1e-3 * float(
        fric.abs().max())


def _dfsph_two_layer(side_cells=4):
    """``test_multiphase_coupled.py``'s ``_dfsph_two_layer(vel_y=-0.5)``
    (DFSPH parameters at dt 5e-4, ρ₀ ratio 1 : 0.4) at ``side_cells`` a
    side, settled by the port's multiphase DFSPH step for 20 steps (its
    ``test_dfsph_mp_coupled_engines_match`` settles with JAX's), and its
    0.06 box of 400 kg/m³ parked at the 0.6 height quantile, here moving
    and spinning. Returns JAX ``(params, grid, walls, body)``, the settled
    port state, and the port ``(cfg, params, grid, walls)``."""
    state, params, grid, walls, _ = two_layer(
        base_params=jt.dfsph_params(dt=5e-4), vel_y=-0.5,
        side_cells=side_cells)
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE)
    pcfg, pparams, ps, pg, pw = to_port(cfg, params, state, grid, walls)
    for _ in range(20):
        ps, d = pt.dfsph_step(ps, pparams, pg, pcfg, pw)
        assert int(d.seg_overflow) == 0
    n = int(ps.num_active)
    settled = dataclasses.replace(state, pos=jnp.asarray(ps.pos.numpy()[:n]))
    return ((cfg, params, grid, walls, _parked_body(settled, params)), ps,
            (pcfg, pparams, pg, pw))


def test_dfsph_mp_coupled_matches_jax(exact_reciprocal):
    """Two multiphase coupled DFSPH steps against JAX's Pallas step from
    the same settled state: equal ``solver_iters``; fluid positions atol
    1e-6, mass and ρ₀ equal; velocities, body velocity and ω within
    1e-5·max|ref| (the parked box overlaps the fluid lattice and is thrown
    out at m/s, ω ~1e3 rad/s, as in JAX's test); com atol 1e-6."""
    (cfg, params, grid, walls, body), ps, (pcfg, pparams, pg, pw) = \
        _dfsph_two_layer()
    n = int(ps.num_active)
    js = jt.make_fluid_state(ps.pos.numpy(), ps.vel.numpy(),
                             masses=ps.mass.numpy(),
                             rest_densities=ps.rho0.numpy())
    js = dataclasses.replace(js, pressure=jnp.asarray(ps.pressure.numpy()))
    step = jax.jit(lambda s, b: jt.dfsph_coupled_step(s, params, grid, cfg,
                                                      b, walls))
    jb, pb = body, body_to_port(body)
    for it in range(2):
        js, jb, jd = step(js, jb)
        ps, pb, pd = pt.dfsph_coupled_step(ps, pparams, pg, pcfg, pb, pw)
        assert int(pd.solver_iters) == int(jd.solver_iters), it
        po, vo, mo, ro = canon(js, n)
        pp, vp, mp, rp = canon(ps, n)
        np.testing.assert_allclose(pp, po, rtol=0, atol=1e-6, err_msg=it)
        np.testing.assert_allclose(vp, vo, rtol=0,
                                   atol=1e-5 * np.abs(vo).max(), err_msg=it)
        np.testing.assert_array_equal(mp, mo)
        np.testing.assert_array_equal(rp, ro)
        np.testing.assert_allclose(pb.com.numpy(), np.asarray(jb.com),
                                   rtol=0, atol=1e-6, err_msg=it)
        for f in ("vel", "omega"):
            want = np.asarray(getattr(jb, f))
            np.testing.assert_allclose(getattr(pb, f).numpy(), want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=f"{it} {f}")
        assert int(jd.seg_overflow) == 0 and int(pd.seg_overflow) == 0
    assert int(pd.solver_iters) > pcfg.dfsph_min_iters + pcfg.dfsph_min_iters_v


def test_dfsph_mp_coupled_reduces_to_single_phase():
    """At uniform phase (mass m, ρ₀ everywhere) the multiphase coupled DFSPH
    step reproduces the single-phase one (``test_dfsph_mp_coupled_reduces_
    to_single_phase``, the port alone): a block of 6³ with seeded
    velocities and a submerged moving, spinning box, one step; equal
    ``solver_iters`` beyond the minimum, positions atol 1e-6, velocities
    atol 2e-4, body velocity atol 1e-3 and ω atol 5e-3."""
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch import scene as pscene
    cfg = pt.SimConfig(surface_tension_model=pt.SurfaceTensionModel.NONE)
    base = pt.dfsph_params(dt=5e-4, device="cpu")
    sp = 0.8 * float(base.interaction_radius)
    params = pt.calibrate_mass(base, cfg, spacing=sp)
    pm = float(params.particle_mass)
    rd = float(params.rest_density)
    h = float(params.interaction_radius)
    side = 6 * sp
    pos = pscene.particle_cube((side / 2 + 2 * sp,) * 3, (side,) * 3, sp)
    n = len(pos)
    lo = np.zeros(3)
    hi = np.array([side + 4 * sp, 2.5 * side, side + 4 * sp])
    grid = pt.fit_grid(lo - h, hi + h, h, device="cpu")
    walls = B.box_boundary(grid, lo, hi, float(params.particle_radius),
                           params, device="cpu")
    center = (side / 2 + 2 * sp,) * 3
    body = dataclasses.replace(
        pt.make_rigid_box(center, (0.06,) * 3, float(params.particle_radius),
                          400.0, params, device="cpu"),
        vel=torch.tensor([0.05, -0.1, 0.02]),
        omega=torch.tensor([0.2, -0.1, 0.3]))
    vels = np.random.default_rng(11).normal(scale=0.05, size=pos.shape)
    s1 = pt.make_fluid_state(pos, velocities=vels, device="cpu")
    s2 = pt.make_fluid_state(pos, velocities=vels, masses=pm,
                             rest_densities=rd, device="cpu")
    s1, b1, d1 = pt.dfsph_coupled_step(s1, params, grid, cfg, body, walls)
    s2, b2, d2 = pt.dfsph_coupled_step(s2, params, grid, cfg, body, walls)
    assert int(d1.solver_iters) == int(d2.solver_iters)
    assert int(d1.solver_iters) > cfg.dfsph_min_iters
    np.testing.assert_allclose(s2.pos.numpy()[:n], s1.pos.numpy()[:n],
                               atol=1e-6)
    np.testing.assert_allclose(s2.vel.numpy()[:n], s1.vel.numpy()[:n],
                               atol=2e-4)
    np.testing.assert_allclose(b2.vel.numpy(), b1.vel.numpy(), atol=1e-3)
    np.testing.assert_allclose(b2.omega.numpy(), b1.omega.numpy(),
                               atol=5e-3)
    assert float(torch.linalg.norm(b1.vel - body.vel)) > 1e-2
