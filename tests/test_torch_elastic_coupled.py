"""The port's fluid–elastic coupled WCSPH step vs the JAX package (CPU,
plain sweeps), mirroring ``tests/test_elastic_coupled.py``.

* ``elastic_psi`` equals JAX's (rtol 1e-6).
* The ``FluidReaction`` plain twin (``fluid_reaction_pair``) against JAX's
  pair function summed over every (sample, fluid) pair within h, on the
  step's own operands of a moving, spinning cube immersed in a fluid block
  with seeded velocities, and on its friction alone (the fluid density
  clamped to ρ₀, so the Tait pressure is 0; ~1e-9 of the pressure term
  here): max|Δ| ≤ 1e-5·max|ref| per column, both kernel sets; the
  friction reads the sample velocities.
* The ``BodyForce`` plain twin, both forms (with the Akinci pressure, and
  the friction alone of the DFSPH couplings), over the same cube's shell
  against JAX's ``boundary_force_pair`` body form summed over every pair
  within h: max|Δ| ≤ 1e-5·max|ref| per column, both kernel sets.
* ``wcsph_elastic_step`` against JAX's Pallas step (interpret mode) on
  ``_free_space_scene`` and on the same scene with the body moved into
  contact with the blob, 2 steps at ``substeps=2``: fluid positions atol
  2e-6 in sorted order, body positions atol 2e-6, velocities atol 1e-3
  (``test_oracle_pallas_lockstep``).
* Mirrors: total momentum is conserved across contact
  (``test_total_momentum_conserved_across_contact``); the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import SimConfig, make_params
from nereus_tpu.scene import particle_cube
from nereus_tpu.solvers import elastic as JEL

import nereus_tpu_torch as pt
from nereus_tpu_torch import convert
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import elastic_coupled
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, exact_reciprocal,
                          params_to_port, to_port)

torch.set_num_threads(1)

ORACLE = SimConfig(engine="segments", seg_window=64)
PALLAS = SimConfig(engine="pallas", seg_window=64)
# one compiled JAX step for every scene of the same shapes
_JAX_STEP = jax.jit(jt.wcsph_elastic_step, static_argnums=(3, 9))
EP_FIELDS = ("mu", "lam", "hourglass", "damping", "floor_y", "box_lo",
             "box_hi", "yield_strain", "creep", "max_plastic")


def _free_space_scene(cfg):
    """``test_elastic_coupled.py``'s scene: a fluid blob flying +x at
    1.5 m/s into a soft cube, no gravity, no walls. JAX objects:
    ``(params, grid, state, estate, statics, ep, psi)``."""
    params = make_params(gravity=(0.0, 0.0, 0.0))
    h = float(np.asarray(params.interaction_radius))
    r = float(params.particle_radius)
    blob = particle_cube((0.15, 0.2, 0.2), (0.1, 0.1, 0.1), 2 * r)
    sp = 0.5 * h
    cube = JEL.sample_box_solid((0.27, 0.15, 0.15),
                                (0.27 + 3 * sp, 0.15 + 3 * sp,
                                 0.15 + 3 * sp), sp)
    lo, hi = np.zeros(3), np.array((0.6, 0.4, 0.4))
    grid = jt.fit_grid(lo - h, hi + h, h)
    state = jt.make_fluid_state(blob)
    state = dataclasses.replace(
        state, vel=jnp.broadcast_to(jnp.array([1.5, 0.0, 0.0]),
                                    state.vel.shape).astype(state.vel.dtype))
    ep = jt.elastic_params(1e4, 0.3)
    estate, statics, _ = jt.make_elastic_solid(np.asarray(cube), params,
                                               cfg, sp, grid=grid)
    psi = jt.elastic_psi(statics, params, cfg)
    return params, grid, state, estate, statics, ep, psi


def _to_port(cfg, params, grid, state, estate, statics, ep):
    pcfg, pparams, pstate, pgrid, _ = to_port(cfg, params, state, grid, None)
    pstat = convert.elastic_statics_from_numpy(
        statics.x0, statics.corr, statics.fixed, statics.vol, statics.mass,
        pgrid, pparams.interaction_radius, device="cpu")
    pest = convert.elastic_state_from_numpy(estate.pos, estate.vel,
                                            device="cpu")
    pep = convert.elastic_params_from_numpy(
        {f: np.asarray(getattr(ep, f)) for f in EP_FIELDS}, device="cpu")
    return pcfg, pparams, pstate, pgrid, pest, pstat, pep


def test_elastic_psi_matches_jax():
    params, grid, state, estate, statics, ep, psi = _free_space_scene(ORACLE)
    pcfg, pparams, _, _, _, pstat, _ = _to_port(ORACLE, params, grid, state,
                                                estate, statics, ep)
    got = pt.elastic_psi(pstat, pparams, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(psi), rtol=1e-6)
    assert float(got.min()) > 0.0


def _immersed(kernel_set):
    """A 4³ cube (spacing h/2) moving at (0.3, −0.5, 0.2) m/s and spinning
    at (1, −2, 0.5) rad/s inside a 0.24 m fluid block with seeded
    velocities in ±0.2 m/s, the fluid carved out of the cube to a quarter
    spacing; the block's lattice (0.037 m) is compressed enough that the
    pressure is positive inside and negative at its surface. Port objects:
    ``(cfg, params, grid, ctx, estate, psi)``."""
    cfg = dataclasses.replace(ORACLE, kernel_set=kernel_set)
    params = make_params(dt=2e-4)
    h = float(np.asarray(params.interaction_radius))
    spacing = 0.037
    sp = 0.5 * h
    c = np.array([0.2, 0.2, 0.2])
    cube = JEL.sample_box_solid(c - 1.5 * sp, c + 1.5 * sp, sp)
    fluid = particle_cube(c, (0.24,) * 3, spacing)
    fluid = fluid[np.abs(fluid - c).max(axis=1) > 1.5 * sp + 0.25 * spacing]
    vel = np.random.default_rng(3).uniform(-0.2, 0.2, fluid.shape)
    grid = jt.fit_grid(np.zeros(3) - h, np.ones(3) * 0.4 + h, h)
    state = jt.make_fluid_state(fluid, vel.astype(np.float32))
    estate, statics, _ = jt.make_elastic_solid(cube, params, cfg, sp,
                                               grid=grid)
    ep = jt.elastic_params(1e4, 0.3)
    pcfg, pparams, pstate, pgrid, pest, pstat, _ = _to_port(
        cfg, params, grid, state, estate, statics, ep)
    x = pstat.x0 - pstat.x0.mean(dim=0)
    v = torch.tensor([0.3, -0.5, 0.2]) + torch.linalg.cross(
        torch.tensor([1.0, -2.0, 0.5]).expand_as(x), x)
    pest = dataclasses.replace(pest, vel=v)
    ctx = build_sweep_ctx(pstate, pparams, pgrid, pcfg, None)
    psi = pt.elastic_psi(pstat, pparams, pcfg)
    return (cfg, params, grid), (pcfg, pparams, pgrid, ctx, pest, psi)


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_fluid_reaction_twin_matches_jax(kernel_set):
    """As the step runs it, then on the friction alone: the fluid density
    clamped to ρ₀ (the Tait pressure 0); the friction reads the sample
    velocities."""
    (cfg, params, grid), (pcfg, pparams, pgrid, ctx, pest, psi) = \
        _immersed(kernel_set)
    ops = elastic_coupled.elastic_operands(ctx, pparams, pcfg, pgrid, pest,
                                           psi)
    q, src, s, e, pv = ops.rargs
    assert int((e - s).sum(dim=0).gt(0).sum()) > q.shape[0] // 2
    assert float(ops.pres.max()) > 0.0 > float(ops.pres.min())
    fric = src.clone()
    fric[:, 6] = torch.clamp(fric[:, 6], max=float(params.rest_density))
    jpv = PS.build_pvec(params, cfg, grid)
    for name, sv in (("reaction", src), ("friction", fric)):
        got = SP.fluid_reaction_sweep(pcfg, q, sv, s, e, pv)
        jq, js = jnp.asarray(q.numpy()), jnp.asarray(sv.numpy().T)
        want = PS.fluid_reaction_pair(
            jq, js, jnp.ones((jq.shape[0], js.shape[1]), bool), jpv,
            kernel_set=kernel_set)
        assert_columns_close(got.numpy(), np.asarray(want)[:, :3], 1e-5,
                             name)
    assert float(got.abs().max()) < 1e-3 * float(
        SP.fluid_reaction_sweep(pcfg, q, src, s, e, pv).abs().max())
    still = q.clone()
    still[:, 3:6] = 0.0
    moved = SP.fluid_reaction_sweep(pcfg, still, fric, s, e, pv)
    assert float((moved - got).abs().max()) > 1e-2 * float(got.abs().max())


@pytest.mark.parametrize("include_pressure", [True, False],
                         ids=["body-force", "friction"])
@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_body_force_twin_matches_jax(kernel_set, include_pressure):
    """The body contact's plain twin over a dense shell in mid-fluid (the
    immersed 4³ cube at h/2, moving and spinning: most of its samples have
    fluid within h), both forms, on the step's own operands (the force
    sweep's query, the shell's rows ``x y z v_b ψ_b 0``), against JAX's
    ``boundary_force_pair(moving=True, include_adhesion=False,
    pressure_sign=-1, consistent_pressure=True)`` summed over every pair
    within h: max|Δ| ≤ 1e-5·max|ref| per column. The friction-only form
    (``include_pressure=False``, the DFSPH couplings') reads the sample
    velocities."""
    (cfg, params, grid), (pcfg, pparams, pgrid, ctx, pest, psi) = \
        _immersed(kernel_set)
    ops = elastic_coupled.elastic_operands(ctx, pparams, pcfg, pgrid, pest,
                                           psi)
    sh = ops.shell
    q = ops.fargs[0]
    busy = int((sh.seg_end - sh.seg_start).sum(dim=0).gt(0).sum())
    assert busy > q.shape[0] // 4, busy
    got = SP.body_force_sweep(pcfg, q, sh.src, sh.seg_start, sh.seg_end,
                              ctx.pvec, include_pressure=include_pressure)
    jq, js = jnp.asarray(q.numpy()), jnp.asarray(sh.src.numpy().T)
    want = PS.boundary_force_pair(
        jq, js, jnp.ones((jq.shape[0], js.shape[1]), bool),
        PS.build_pvec(params, cfg, grid), kernel_set=kernel_set,
        include_pressure=include_pressure, moving=True,
        include_adhesion=False, pressure_sign=-1.0,
        consistent_pressure=True)
    assert_columns_close(got.numpy(), np.asarray(want)[:, :3], 1e-5,
                         f"pressure={include_pressure}")
    if not include_pressure:
        still = SP.body_force_sweep(
            pcfg, q, sh.src.clone().index_fill_(1, torch.tensor([3, 4, 5]),
                                                0.0),
            sh.seg_start, sh.seg_end, ctx.pvec, include_pressure=False)
        assert float((still - got).abs().max()) > 1e-2 * float(
            got.abs().max())


@pytest.fixture(scope="module")
def pallas_scene():
    return _free_space_scene(PALLAS)


@pytest.mark.parametrize("shift", [0.0, 0.055], ids=["apart", "contact"])
def test_step_matches_jax_pallas(exact_reciprocal, pallas_scene, shift):
    """Two coupled steps at ``substeps=2`` against JAX's Pallas step: the
    scene of ``test_oracle_pallas_lockstep``, and the same body moved
    ``shift`` towards the blob, to 0.015 from it (the contact sweeps and
    the reaction live; the reference configuration stays)."""
    params, grid, state, estate, statics, ep, psi = pallas_scene
    estate = dataclasses.replace(
        estate, pos=estate.pos - jnp.array([shift, 0.0, 0.0], jnp.float32))
    pcfg, pparams, ps, pgrid, pes, pstat, pep = _to_port(
        PALLAS, params, grid, state, estate, statics, ep)
    ppsi = pt.elastic_psi(pstat, pparams, pcfg)
    np.testing.assert_allclose(ppsi.numpy(), np.asarray(psi), rtol=1e-6)
    js, jes = state, estate
    for it in range(2):
        js, jes, jd = _JAX_STEP(js, params, grid, PALLAS, jes, statics, ep,
                                psi, None, 2)
        ps, pes, pd = pt.wcsph_elastic_step(ps, pparams, pgrid, pcfg, pes,
                                            pstat, pep, ppsi, None,
                                            substeps=2)
        np.testing.assert_allclose(ps.pos.numpy(), np.asarray(js.pos),
                                   rtol=0, atol=2e-6, err_msg=f"fluid {it}")
        np.testing.assert_allclose(pes.pos.numpy(), np.asarray(jes.pos),
                                   rtol=0, atol=2e-6, err_msg=f"body {it}")
        np.testing.assert_allclose(pes.vel.numpy(), np.asarray(jes.vel),
                                   rtol=0, atol=1e-3, err_msg=f"vel {it}")
        assert int(pd.seg_overflow) == int(jd.seg_overflow) == 0
    if shift:
        # the fluid pushed the body
        assert float(pes.vel[:, 0].max()) > 1e-2


def test_total_momentum_conserved_across_contact():
    params, grid, state, estate, statics, ep, psi = _free_space_scene(ORACLE)
    pcfg, pparams, s, pgrid, es, pstat, pep = _to_port(
        ORACLE, params, grid, state, estate, statics, ep)
    ppsi = pt.elastic_psi(pstat, pparams, pcfg)
    pm, bm = float(params.particle_mass), float(pstat.mass)
    n = int(s.num_active)

    def momentum(s, es):
        return (pm * s.vel[:n].double().sum(dim=0)
                + bm * es.vel.double().sum(dim=0)).numpy()
    p0 = momentum(s, es)
    hit = False
    for _ in range(40):
        s, es, _ = pt.wcsph_elastic_step(s, pparams, pgrid, pcfg, es, pstat,
                                         pep, ppsi, None, substeps=2)
        assert bool(torch.isfinite(s.pos).all())
        assert bool(torch.isfinite(es.pos).all())
        hit = hit or float(es.vel.abs().max()) > 1e-4
    assert hit, "the blob never touched the body"
    p1 = momentum(s, es)
    assert np.abs(p1 - p0).max() < 2e-3 * np.abs(p0).max(), (p0, p1)
    assert float(es.vel[:, 0].mean()) > 0.0


def test_refusals():
    """A multiphase state, as JAX refuses it; implicit viscosity (the JAX
    step runs the explicit term whatever the model says); no substep."""
    params, grid, state, estate, statics, ep, psi = _free_space_scene(ORACLE)
    pcfg, pparams, s, pgrid, es, pstat, pep = _to_port(
        ORACLE, params, grid, state, estate, statics, ep)
    ppsi = pt.elastic_psi(pstat, pparams, pcfg)
    mp = dataclasses.replace(s, mass=torch.full((s.capacity,), 1e-3),
                             rho0=torch.full((s.capacity,), 1000.0))
    args = (pparams, pgrid)
    with pytest.raises(NotImplementedError, match="multiphase"):
        pt.wcsph_elastic_step(mp, *args, pcfg, es, pstat, pep, ppsi)
    with pytest.raises(NotImplementedError, match="implicit viscosity"):
        pt.wcsph_elastic_step(
            s, *args, dataclasses.replace(pcfg, viscosity_model="implicit"),
            es, pstat, pep, ppsi)
    with pytest.raises(ValueError, match="substeps"):
        pt.wcsph_elastic_step(s, *args, pcfg, es, pstat, pep, ppsi,
                              substeps=0)
    with pytest.raises(NotImplementedError, match="multiphase"):
        jt.wcsph_elastic_step(
            dataclasses.replace(state, mass=jnp.full((state.capacity,), 1e-3),
                                rho0=jnp.full((state.capacity,), 1000.0)),
            params, grid, ORACLE, estate, statics, ep, psi)
