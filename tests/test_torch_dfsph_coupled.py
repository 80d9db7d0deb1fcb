"""The port's single-phase coupled DFSPH + rigid-body step vs the JAX
package (CPU, plain sweeps), mirroring ``tests/test_dfsph_coupled.py``.

* The plain twins of the step's body sweeps against JAX's pair functions
  summed over every (query, sample) pair within h, on the step's own
  operands of a moving, spinning box inside a fluid block (its first
  divergence iteration), both kernel sets, max|Δ| ≤ 1e-5·max|ref| per
  column: the body form of the κ impulse
  (``grad_pressure_force_pair(boundary=True, boundary_sign=-1)``), the
  shell's ψ-density with the body form of α in one sweep (``density_pair``
  and ``alpha_pair(include_sq=False)``), Dρ/Dt over the shell with its
  sample velocities, and the friction
  alone (``boundary_force_pair(include_pressure=False, moving=True,
  include_adhesion=False)``), which reads the sample velocities.
* ``dfsph_coupled_step`` against JAX's Pallas step (interpret mode) over
  two steps, equal ``solver_iters``, one body under strong coupling and
  two bodies without it:

  - on ``test_dfsph_coupled_engine_equivalence``'s own scene, at its
    absolute tolerances: positions 2e-5, velocities 2e-4, body com 1e-6,
    body velocity 2e-4, ω 2e-3;
  - on its tank (walls 0.4 × 0.6 × 0.4, dt 2e-4, calibrated DFSPH
    parameters, 0.08 boxes) with the fluid block around the bodies, so the
    contact is live from the first iteration. The contact makes the κ
    solve stiff, and JAX's own two engines (``segments`` and ``pallas``)
    differ there by more than those tolerances. Positions and com keep
    them; fluid velocity, body velocity and ω are held to them or to
    twice the two engines' own max|Δ| on the same steps, whichever is
    larger, both read in the test.
* ``bench.py``'s ``dfsph_coupled_256k`` geometry at its smallest scale
  (``n_target=343``, 512 fluid particles; the 0.15 box's shell 0.025
  over the water, inside h), single phase and split as
  ``dfsph_mp_coupled_256k``: one step against JAX's Pallas step at the
  engine tolerances above. Both throw the box up at more than 10 m/s.
* Mirrors: total momentum is conserved while a blob hits a body through
  the pressure solve; the refusals.
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
from nereus_tpu.scene import particle_cube, resting_block

import nereus_tpu_torch as pt
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import dfsph_coupled_cuda as DC
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, body_to_port, dense_pairs,
                          exact_reciprocal, to_port)

torch.set_num_threads(1)

# the second body rests on the block's top face, its shell 0.06 (> h)
# above the first one's: the body-body contact stays out of the comparison
CENTERS = ((0.2, 0.2, 0.2), (0.2, 0.34, 0.2))


def _tank(n_bodies=1, strong=True, kernel_set=jt.KernelSet.MULLER):
    """``test_dfsph_coupled_engine_equivalence``'s tank and parameters with
    a 0.2 fluid block at spacing 2·r around one or two 0.08 boxes
    (300 kg/m³, then 800), the fluid carved out of their shells to a
    quarter spacing, seeded velocities in ±0.05 m/s, the boxes moving at
    (0.02, −0.04, 0.01) m/s and spinning. JAX objects: ``(cfg, params,
    state, grid, walls, bodies)``."""
    cfg = jt.SimConfig(engine="pallas", dfsph_strong_coupling=strong,
                       kernel_set=kernel_set)
    params = calibrate_mass(jt.dfsph_params(dt=2e-4),
                            jt.SimConfig(engine="segments"))
    h = float(params.interaction_radius)
    r = float(params.particle_radius)
    spacing = 2 * r
    fluid = particle_cube((0.2, 0.2, 0.2), (0.2, 0.2, 0.2), spacing)
    centers = CENTERS[:n_bodies]
    keep = np.ones(len(fluid), bool)
    for c in centers:
        keep &= np.abs(fluid - np.asarray(c)).max(axis=1) > (
            0.04 + 0.25 * spacing)
    fluid = fluid[keep]
    vel = np.random.default_rng(5).uniform(-0.05, 0.05, fluid.shape)
    lo, hi = np.zeros(3), np.array((0.4, 0.6, 0.4))
    grid = jt.fit_grid(lo - h, hi + h, h)
    walls = box_boundary(grid, lo, hi, r, params)
    bodies = tuple(dataclasses.replace(
        jt.make_rigid_box(c, (0.08,) * 3, r, 300.0 + 500.0 * k, params),
        vel=jnp.asarray((0.02, -0.04, 0.01), jnp.float32),
        omega=jnp.asarray((0.1 * (k + 1), -0.05, 0.15), jnp.float32))
        for k, c in enumerate(centers))
    state = jt.make_fluid_state(fluid, vel.astype(np.float32))
    return cfg, params, state, grid, walls, bodies


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_body_twins_match_jax(kernel_set):
    """The body sweeps' twins on the step's first divergence iteration."""
    cfg, params, state, grid, walls, bodies = _tank(kernel_set=kernel_set)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    (t,) = DC.body_terms(ctx, pg, (body_to_port(bodies[0]),))
    bv = (t.com.new_tensor([0.02, -0.04, 0.01]),
          t.com.new_tensor([0.1, -0.05, 0.15]))
    dens, alpha = DC.coupled_density_alpha(ctx, pparams, pcfg, [t])
    sweeps = DC.CoupledSweeps(ctx, pparams, pcfg, dens, [t])
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    drho = torch.clamp(sweeps.drho(v, [bv]), min=0.0)
    kargs = sweeps.kappa_operands(drho * alpha / float(params.dt))
    rows = t.ranges(ctx.pvec)
    src_v = t.src_at(bv).clone()
    q8 = ctx.queries(ctx.vx, ctx.vy, ctx.vz, dens, torch.zeros_like(dens))
    live = int((rows[1] - rows[0]).sum(dim=0).gt(0).sum())
    assert live > ctx.c // 4, live
    assert float(kargs[0][:, 3].abs().max()) > 0.0
    pv = PS.build_pvec(params, cfg, grid)
    ks = kernel_set
    cases = (
        ("kappa", SP.pressure_force_body_sweep(pcfg, kargs[0], t.shell.src,
                                               *rows),
         dense_pairs(PS.grad_pressure_force_pair, kargs[0], t.shell.src, pv,
                     kernel_set=ks, boundary=True, boundary_sign=-1.0)[:, :3]),
        ("density and alpha",
         SP.body_density_alpha_sweep(pcfg, ctx.queries(width=4), t.src4,
                                     *rows),
         np.concatenate([
             dense_pairs(PS.density_pair, ctx.queries(width=4), t.shell.src,
                         pv, kernel_set=ks),
             dense_pairs(PS.alpha_pair, ctx.queries(width=4), t.shell.src,
                         pv, kernel_set=ks, include_sq=False)[:, :3]],
             axis=1)),
        ("drho", SP.drho_shell_sweep(pcfg, sweeps.q_v, src_v, *rows),
         dense_pairs(PS.drho_pair, sweeps.q_v, src_v, pv,
                     kernel_set=ks)[:, 0]),
        ("friction", SP.body_force_sweep(pcfg, q8, src_v, *rows,
                                         include_pressure=False),
         dense_pairs(PS.boundary_force_pair, q8, src_v, pv, kernel_set=ks,
                     include_pressure=False, moving=True,
                     include_adhesion=False)[:, :3]))
    for name, got, want in cases:
        assert_columns_close(got.numpy(), want, 1e-5, name)
    assert cases[1][1].shape == (ctx.c, 4)
    # the friction reads the sample velocities
    still = src_v.clone()
    still[:, 3:6] = 0.0
    fric = cases[-1][1]
    other = SP.body_force_sweep(pcfg, q8, still, *rows,
                                include_pressure=False)
    assert float((other - fric).abs().max()) > 1e-3 * float(
        fric.abs().max())


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_shell_alpha_forms_read_src4(kernel_set):
    """The source-width pin of the shell's ψ-density and α sweep, both
    forms: ``body_density_alpha_sweep`` (``include_sq`` False / True) reads
    the shell's (Mb, 4) rows ``x y z ψ_b`` (``BodyTerms.src4``), and on
    them gives JAX's ``density_pair`` and ``alpha_pair`` (``include_sq``
    False / True) over the shell's (Mb, 8) rows ``x y z v_b ψ_b 0`` (ψ_b
    in slot 6, the layout of JAX's sweeps) within 1e-5·max|ref| per
    column; the 8-wide rows cut to their first four columns (the sample
    velocity's x where ψ_b belongs) give another result."""
    cfg, params, state, grid, walls, bodies = _tank(kernel_set=kernel_set)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    (t,) = DC.body_terms(ctx, pg, (body_to_port(bodies[0]),))
    rows = t.ranges(ctx.pvec)
    q4 = ctx.queries(width=4)
    assert t.src4.shape == (t.shell.src.shape[0], 4)
    assert torch.equal(t.src4[:, 3], t.shell.src[:, 6])
    pv = PS.build_pvec(params, cfg, grid)
    cut = t.shell.src[:, :4].contiguous()
    dens = dense_pairs(PS.density_pair, q4, t.shell.src, pv,
                       kernel_set=kernel_set)
    for name, sq in (("body", False), ("shell", True)):
        got = SP.body_density_alpha_sweep(pcfg, q4, t.src4, *rows,
                                          include_sq=sq)
        want = np.concatenate([dens, dense_pairs(
            PS.alpha_pair, q4, t.shell.src, pv, kernel_set=kernel_set,
            include_sq=sq)[:, :4 if sq else 3]], axis=1)
        assert got.shape == want.shape
        assert_columns_close(got.numpy(), want, 1e-5,
                             f"density and alpha {name}")
        assert float(got[:, 1:4].abs().max()) > 0.0
        assert not torch.allclose(SP.body_density_alpha_sweep(
            pcfg, q4, cut, *rows, include_sq=sq), got)


_JAX_STEP = jax.jit(jt.dfsph_coupled_step, static_argnums=(3,))

# test_dfsph_coupled_engine_equivalence's tolerances
ATOL = {"pos": 2e-5, "vel": 2e-4, "com": 1e-6, "body_vel": 2e-4,
        "omega": 2e-3}


def _lockstep(cfg, params, state, grid, walls, bodies, steps=2,
              engines=("pallas",)):
    """``steps`` coupled steps of JAX's step, one run per engine of
    ``engines``, and of the port, from the same inputs. Yields, per step,
    ``(jax, port)``: ``jax`` maps each engine to its ``(state, bodies,
    diag)``, ``port`` is the port's."""
    pcfg, pparams, ps, pg, pw = to_port(cfg, params, state, grid, walls)
    pb = tuple(body_to_port(b) for b in bodies)
    runs = {e: (state, bodies) for e in engines}
    for _ in range(steps):
        jax_out = {}
        for e, (js, jb) in runs.items():
            jax_out[e] = _JAX_STEP(js, params, grid,
                                   dataclasses.replace(cfg, engine=e), jb,
                                   walls)
            runs[e] = jax_out[e][:2]
        ps, pb, pd = pt.dfsph_coupled_step(ps, pparams, pg, pcfg, pb, pw)
        yield jax_out, (ps, pb, pd)


def _fields(s, bodies):
    """The compared arrays of a state and its bodies."""
    out = {"pos": np.asarray(s.pos), "vel": np.asarray(s.vel)}
    for f, key in (("com", "com"), ("vel", "body_vel"), ("omega", "omega")):
        out[key] = np.stack([np.asarray(getattr(b, f)) for b in bodies])
    return out


def _engine_scene(n_bodies, strong):
    """``test_dfsph_coupled_engine_equivalence``'s scene: a 0.15 fluid cube
    centred at (0.2, 0.3, 0.2) at spacing 2·r over a 300 kg/m³ 0.08 box at
    (0.2, 0.12, 0.2); a second body (800 kg/m³) at (0.08, 0.12, 0.08)."""
    cfg = jt.SimConfig(engine="pallas", dfsph_strong_coupling=strong)
    params = calibrate_mass(jt.dfsph_params(dt=2e-4),
                            jt.SimConfig(engine="segments"))
    h = float(params.interaction_radius)
    r = float(params.particle_radius)
    fluid = particle_cube((0.2, 0.3, 0.2), (0.15, 0.15, 0.15), 2 * r)
    lo, hi = np.zeros(3), np.array((0.4, 0.6, 0.4))
    grid = jt.fit_grid(lo - h, hi + h, h)
    walls = box_boundary(grid, lo, hi, r, params)
    centers = ((0.2, 0.12, 0.2), (0.08, 0.12, 0.08))[:n_bodies]
    bodies = tuple(jt.make_rigid_box(c, (0.08,) * 3, r, 300.0 + 500.0 * k,
                                     params)
                   for k, c in enumerate(centers))
    return cfg, params, jt.make_fluid_state(fluid), grid, walls, bodies


@pytest.mark.parametrize("n_bodies,strong", [(1, True), (2, False)],
                         ids=["one-body-strong", "two-bodies-weak"])
def test_engine_scene_matches_jax(exact_reciprocal, n_bodies, strong):
    """JAX's engine-equivalence scene at its absolute tolerances."""
    cfg, params, state, grid, walls, bodies = _engine_scene(n_bodies,
                                                            strong)
    for it, (jax_out, (ps, pb, pd)) in enumerate(
            _lockstep(cfg, params, state, grid, walls, bodies)):
        js, jb, jd = jax_out["pallas"]
        name = f"{n_bodies} bodies strong {strong} step {it}"
        assert int(jd.seg_overflow) == 0 == int(pd.seg_overflow)
        assert int(pd.solver_iters) == int(jd.solver_iters), name
        want, got = _fields(js, jb), _fields(ps, pb)
        for key, atol in ATOL.items():
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=atol, err_msg=f"{name} {key}")


@pytest.mark.parametrize("n_bodies,strong", [(1, True), (2, False)],
                         ids=["one-body-strong", "two-bodies-weak"])
def test_coupled_step_matches_jax(exact_reciprocal, n_bodies, strong):
    """The live-contact tank: positions and com at the engine tolerances,
    the velocities and ω at them or at twice JAX's own engines' gap."""
    cfg, params, state, grid, walls, bodies = _tank(n_bodies, strong)
    for it, (jax_out, (ps, pb, pd)) in enumerate(_lockstep(
            cfg, params, state, grid, walls, bodies,
            engines=("pallas", "segments"))):
        name = f"{n_bodies} bodies strong {strong} step {it}"
        (js, jb, jd), (so, bo, do) = jax_out["pallas"], jax_out["segments"]
        assert int(jd.seg_overflow) == 0 == int(pd.seg_overflow)
        assert int(pd.solver_iters) == int(jd.solver_iters), name
        assert int(do.solver_iters) == int(jd.solver_iters), name
        want, got, other = _fields(js, jb), _fields(ps, pb), _fields(so, bo)
        for key, atol in ATOL.items():
            if key in ("vel", "body_vel", "omega"):
                atol = max(atol, 2.0 * float(np.abs(other[key]
                                                    - want[key]).max()))
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=atol, err_msg=f"{name} {key}")
    assert int(pd.solver_iters) > cfg.dfsph_min_iters + cfg.dfsph_min_iters_v
    # the fluid pushed the bodies: ω left its start by far more than the
    # tolerance
    for k in range(n_bodies):
        w0 = np.asarray(bodies[k].omega)
        assert np.abs(pb[k].omega.numpy() - w0).max() > 0.1


def _bench_scene(multiphase):
    """``bench.py:239-268``'s dfsph_coupled_256k at ``n_target=343``, its
    smallest scale: the resting block of ``dfsph_params(dt=5e-4)``
    calibrated to the 0.8·h lattice, impact velocity −1 m/s, and the 0.15
    box of 400 kg/m³ centred over it 0.1 above the water top; multiphase:
    the top half by y at 0.4·ρ₀ (``dfsph_mp_coupled_256k``)."""
    cfg = jt.SimConfig(engine="pallas")
    base = jt.dfsph_params(dt=5e-4)
    spacing = 0.8 * float(base.interaction_radius)
    params = calibrate_mass(base, cfg, spacing=spacing)
    state, grid, walls = resting_block(params, cfg, n_target=343,
                                       spacing=spacing, impact_velocity=-1.0)
    n = int(state.num_active)
    pos = np.asarray(state.pos)[:n]
    if multiphase:
        rd, pm = float(params.rest_density), float(params.particle_mass)
        rho0 = np.full(state.capacity, rd, np.float32)
        rho0[:n] = np.where(pos[:, 1] >= np.quantile(pos[:, 1], 0.5),
                            0.4 * rd, rd)
        state = dataclasses.replace(state, mass=jnp.asarray(rho0 * (pm / rd)),
                                    rho0=jnp.asarray(rho0))
    body = jt.make_rigid_box(
        (float(pos[:, 0].mean()), float(pos[:, 1].max()) + 0.1,
         float(pos[:, 2].mean())), (0.15,) * 3,
        float(params.particle_radius), 400.0, params)
    return cfg, params, state, grid, walls, (body,)


@pytest.mark.parametrize("multiphase", [False, True],
                         ids=["single-phase", "two-phase"])
def test_bench_box_matches_jax(exact_reciprocal, multiphase):
    """The bench box's first step: its shell lies inside h of the water,
    and JAX's Pallas step and the port both throw it up (> 10 m/s) and
    agree at the engine tolerances."""
    cfg, params, state, grid, walls, bodies = _bench_scene(multiphase)
    h = float(params.interaction_radius)
    n = int(state.num_active)
    gap = (float(np.asarray(bodies[0].com)[1]) - 0.075
           - float(np.asarray(state.pos)[:n, 1].max()))
    assert 0.0 < gap < h, gap
    ((jax_out, (ps, pb, pd)),) = _lockstep(cfg, params, state, grid, walls,
                                           bodies, steps=1)
    js, jb, jd = jax_out["pallas"]
    assert int(jd.seg_overflow) == 0 == int(pd.seg_overflow)
    assert int(pd.solver_iters) == int(jd.solver_iters)
    want, got = _fields(js, jb), _fields(ps, pb)
    for key, atol in ATOL.items():
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=atol,
                                   err_msg=key)
    assert float(want["body_vel"][0, 1]) > 10.0
    assert float(got["body_vel"][0, 1]) > 10.0


def test_coupled_momentum_conservation():
    """Zero gravity, no walls, no viscosity, no surface tension: the
    fluid↔fluid κ corrections are antisymmetric and every fluid↔body κ
    impulse is mirrored onto the body, so total momentum is conserved
    while a blob flies into the body (rtol 2e-3, atol 2e-4, as
    ``test_dfsph_coupled_momentum_conservation``)."""
    cfg = pt.SimConfig(surface_tension_model=pt.SurfaceTensionModel.NONE)
    params = pt.dfsph_params(viscosity=0.0, gravity=(0.0, 0.0, 0.0),
                             dt=2e-4, device="cpu")
    h = float(params.interaction_radius)
    spacing = 0.8 * h
    params = pt.calibrate_mass(params, cfg, spacing=spacing)
    pm = float(params.particle_mass)
    fluid = pscene.particle_cube((0.22, 0.25, 0.25), (0.12,) * 3, spacing)
    state = pt.make_fluid_state(fluid, velocities=(1.0, 0.0, 0.0),
                                device="cpu")
    body = pt.make_rigid_box((0.33, 0.25, 0.25), (0.08,) * 3,
                             float(params.particle_radius), 400.0, params,
                             device="cpu")
    grid = pt.fit_grid(np.zeros(3) - 0.2, np.ones(3) * 0.7, h, device="cpu")

    def total_p(s, b):
        n = int(s.num_active)
        return (pm * s.vel[:n].double().sum(dim=0).numpy()
                + float(b.mass) * b.vel.double().numpy())

    p0 = total_p(state, body)
    for i in range(20):
        state, body, d = pt.dfsph_coupled_step(state, params, grid, cfg,
                                               body)
        assert int(d.seg_overflow) == 0, i
    p1 = total_p(state, body)
    assert bool(torch.isfinite(state.pos).all())
    assert float(body.mass) * float(torch.linalg.norm(body.vel)) > \
        1e-3 * abs(p0[0])
    np.testing.assert_allclose(p1, p0, rtol=2e-3, atol=2e-4)


def test_coupled_refusals():
    """A multiphase state refuses what JAX refuses (AKINCI, implicit
    viscosity); a single-phase state refuses implicit viscosity (the JAX
    step runs the explicit term whatever the model says); no body."""
    cfg, params, state, grid, walls, (body,) = _tank()
    pcfg, pparams, ps, pg, pw = to_port(cfg, params, state, grid, walls)
    pbody = body_to_port(body)
    implicit = dataclasses.replace(pcfg, viscosity_model="implicit")
    with pytest.raises(NotImplementedError, match="implicit viscosity"):
        pt.dfsph_coupled_step(ps, pparams, pg, implicit, pbody, pw)
    with pytest.raises(ValueError, match="at least one body"):
        pt.dfsph_coupled_step(ps, pparams, pg, pcfg, (), pw)
    mp = dataclasses.replace(ps, mass=torch.full((ps.capacity,), 1e-3),
                             rho0=torch.full((ps.capacity,), 1000.0))
    akinci = dataclasses.replace(
        pcfg, surface_tension_model=pt.SurfaceTensionModel.AKINCI)
    for c in (akinci, implicit):
        with pytest.raises(NotImplementedError, match="single-phase-only"):
            pt.dfsph_coupled_step(mp, pparams, pg, c, pbody, pw)
