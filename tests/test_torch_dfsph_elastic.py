"""The port's coupled DFSPH + elastic-body step vs the JAX package (CPU,
plain sweeps), mirroring ``tests/test_dfsph_elastic.py``.

* The plain twins of the step's body sweeps against JAX's pair functions
  summed over every pair within h, on the step's own operands of a 4³
  cube moving at (0.3, −0.5, 0.2) m/s and spinning at (1, −2, 0.5) rad/s
  inside a fluid block (``test_torch_elastic_coupled._immersed``), its
  first divergence iteration, both kernel sets, max|Δ| ≤ 1e-5·max|ref|
  per column: the κ impulse forward (the fluid rows over the shell) and
  reverse (the samples ``x y z ψ_b`` as queries against the fluid rows
  with κ/ρ in slot 6), both ``grad_pressure_force_pair(boundary=True,
  boundary_sign=-1)`` through their own wrappers' CPU routes, the
  shell's ψ-density with α's sums in their fluid form over the shell in
  one sweep (Σψ_bW, Σψ_b∇W, Σψ_b²|∇W|²: ``density_pair`` and
  ``alpha_pair(include_sq=True)``), and the per-sample friction
  (``fluid_reaction_pair(include_pressure=False)``), which reads the
  sample velocities.
* On the same operands the forward impulse summed over the fluid equals
  minus the reverse summed over the samples (1e-5·max|row|).
* ``dfsph_elastic_step`` against JAX's Pallas step (interpret mode) on
  ``_free_space_scene``, as it is and with the body moved to 0.015 from
  the blob (the contact live), 2 steps at ``substeps=2``: equal
  ``solver_iters``, fluid and body positions atol 2e-6, body velocities
  atol 1e-3 (``test_oracle_pallas_lockstep``).
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
from nereus_tpu.params import SimConfig

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import dfsph_elastic as DE
from nereus_tpu_torch.solvers.elastic_coupled import elastic_shell

from test_torch_elastic_coupled import _free_space_scene, _immersed, _to_port
from torch_bridge import assert_columns_close, dense_pairs, exact_reciprocal

torch.set_num_threads(1)

ORACLE = SimConfig(engine="segments", seg_window=64)
PALLAS = SimConfig(engine="pallas", seg_window=64)
_JAX_STEP = jax.jit(jt.dfsph_elastic_step, static_argnums=(3, 9))


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_body_twins_match_jax(kernel_set):
    """The elastic body's sweeps on the step's first divergence
    iteration."""
    (cfg, params, grid), (pcfg, pparams, pgrid, ctx, pest, psi) = \
        _immersed(kernel_set)
    es = elastic_shell(ctx, pgrid, pest, psi)
    mbm = torch.tensor(1.0)
    dens, alpha = DE.elastic_density_alpha(ctx, pparams, pcfg, es, mbm)
    sweeps = DE.ElasticSweeps(ctx, pparams, pcfg, dens, es, mbm)
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    vb = es.shell.src[:, 3:6]
    drho = torch.clamp(sweeps.drho(v, (vb,)), min=0.0)
    q, src, *_ = sweeps.kappa_operands(drho * alpha / float(params.dt))
    assert float(q[:, 3].abs().max()) > 0.0
    rev = (es.r_start, es.r_end, ctx.pvec)
    live = int((es.r_end - es.r_start).sum(dim=0).gt(0).sum())
    assert live > es.shell.src.shape[0] // 2, live
    cols = v.unbind(1)
    src_f = ctx.pack(cols, dens)[:ctx.c]
    src_b = sweeps.src_at(vb).clone()
    pv = PS.build_pvec(params, cfg, grid)
    ks = kernel_set
    q4 = ctx.queries(width=4)
    brng = (es.shell.seg_start, es.shell.seg_end, ctx.pvec)
    cases = (
        ("forward kappa",
         SP.pressure_force_body_sweep(pcfg, q, es.shell.src, *brng),
         dense_pairs(PS.grad_pressure_force_pair, q, es.shell.src, pv,
                     kernel_set=ks, boundary=True, boundary_sign=-1.0)[:, :3]),
        ("reverse kappa",
         SP.pressure_force_body_rev_sweep(pcfg, sweeps.q_b, src, *rev),
         dense_pairs(PS.grad_pressure_force_pair, sweeps.q_b, src, pv,
                     kernel_set=ks, boundary=True, boundary_sign=-1.0)[:, :3]),
        ("density and alpha shell",
         SP.body_density_alpha_sweep(pcfg, q4, es.shell.src4, *brng,
                                     include_sq=True),
         np.concatenate([
             dense_pairs(PS.density_pair, q4, es.shell.src, pv,
                         kernel_set=ks),
             dense_pairs(PS.alpha_pair, q4, es.shell.src, pv, kernel_set=ks,
                         include_sq=True)], axis=1)),
        ("friction", SP.fluid_reaction_sweep(pcfg, src_b, src_f, *rev,
                                             include_pressure=False),
         dense_pairs(PS.fluid_reaction_pair, src_b, src_f, pv, kernel_set=ks,
                     include_pressure=False)[:, :3]))
    for name, got, want in cases:
        assert_columns_close(got.numpy(), want, 1e-5, name)
    # the friction reads the sample velocities
    fric = cases[-1][1]
    still = src_b.clone()
    still[:, 3:6] = 0.0
    other = SP.fluid_reaction_sweep(pcfg, still, src_f, *rev,
                                    include_pressure=False)
    assert float((other - fric).abs().max()) > 1e-2 * float(
        fric.abs().max())


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_kappa_impulse_forward_reverse_antisymmetric(kernel_set):
    """On the immersed body's first divergence iteration, the forward κ
    impulse (the fluid rows over the shell, ``pressure_force_body_sweep``)
    summed over the fluid equals minus the reverse (the samples over the
    fluid rows, ``pressure_force_body_rev_sweep``) summed over the samples:
    each pair's two forces are one formula with the roles swapped. The
    totals (in float64) agree to 1e-5·max|row| of either sweep."""
    _, (pcfg, pparams, pgrid, ctx, pest, psi) = _immersed(kernel_set)
    es = elastic_shell(ctx, pgrid, pest, psi)
    mbm = torch.tensor(1.0)
    dens, alpha = DE.elastic_density_alpha(ctx, pparams, pcfg, es, mbm)
    sweeps = DE.ElasticSweeps(ctx, pparams, pcfg, dens, es, mbm)
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    drho = torch.clamp(sweeps.drho(v, (es.shell.src[:, 3:6],)), min=0.0)
    q, src, *_ = sweeps.kappa_operands(drho * alpha / float(pparams.dt))
    fwd = SP.pressure_force_body_sweep(pcfg, q, es.shell.src,
                                       es.shell.seg_start, es.shell.seg_end,
                                       ctx.pvec)
    rev = SP.pressure_force_body_rev_sweep(pcfg, sweeps.q_b, src,
                                           es.r_start, es.r_end, ctx.pvec)
    scale = max(float(fwd.abs().max()), float(rev.abs().max()))
    assert scale > 0.0
    total = fwd.double().sum(dim=0) + rev.double().sum(dim=0)
    assert float(total.abs().max()) <= 1e-5 * scale, (total, scale)
    assert float(fwd.double().sum(dim=0).abs().max()) > 1e-3 * scale


@pytest.fixture(scope="module")
def pallas_scene():
    return _free_space_scene(PALLAS)


@pytest.mark.parametrize("shift", [0.0, 0.055], ids=["apart", "contact"])
def test_step_matches_jax_pallas(exact_reciprocal, pallas_scene, shift):
    params, grid, state, estate, statics, ep, psi = pallas_scene
    estate = dataclasses.replace(
        estate, pos=estate.pos - jnp.array([shift, 0.0, 0.0], jnp.float32))
    pcfg, pparams, ps, pgrid, pes, pstat, pep = _to_port(
        PALLAS, params, grid, state, estate, statics, ep)
    ppsi = pt.elastic_psi(pstat, pparams, pcfg)
    js, jes = state, estate
    for it in range(2):
        js, jes, jd = _JAX_STEP(js, params, grid, PALLAS, jes, statics, ep,
                                psi, None, 2)
        ps, pes, pd = pt.dfsph_elastic_step(ps, pparams, pgrid, pcfg, pes,
                                            pstat, pep, ppsi, None,
                                            substeps=2)
        assert int(pd.solver_iters) == int(jd.solver_iters), it
        np.testing.assert_allclose(ps.pos.numpy(), np.asarray(js.pos),
                                   rtol=0, atol=2e-6, err_msg=f"fluid {it}")
        np.testing.assert_allclose(pes.pos.numpy(), np.asarray(jes.pos),
                                   rtol=0, atol=2e-6, err_msg=f"body {it}")
        np.testing.assert_allclose(pes.vel.numpy(), np.asarray(jes.vel),
                                   rtol=0, atol=1e-3, err_msg=f"vel {it}")
        assert int(pd.seg_overflow) == int(jd.seg_overflow) == 0
    if shift:
        # the fluid pushed the body, through the pressure solve
        assert float(pes.vel[:, 0].max()) > 1e-2


def test_total_momentum_conserved_across_contact():
    """Zero gravity, no walls: the forward and reverse κ sweeps are exactly
    antisymmetric per pair, so total momentum is conserved through the
    stiffness solve (2e-3·max|p|)."""
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
        s, es, _ = pt.dfsph_elastic_step(s, pparams, pgrid, pcfg, es, pstat,
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
        pt.dfsph_elastic_step(mp, *args, pcfg, es, pstat, pep, ppsi)
    with pytest.raises(NotImplementedError, match="implicit viscosity"):
        pt.dfsph_elastic_step(
            s, *args, dataclasses.replace(pcfg, viscosity_model="implicit"),
            es, pstat, pep, ppsi)
    with pytest.raises(ValueError, match="substeps"):
        pt.dfsph_elastic_step(s, *args, pcfg, es, pstat, pep, ppsi,
                              substeps=0)
    with pytest.raises(NotImplementedError, match="multiphase"):
        jt.dfsph_elastic_step(
            dataclasses.replace(state, mass=jnp.full((state.capacity,), 1e-3),
                                rho0=jnp.full((state.capacity,), 1000.0)),
            params, grid, ORACLE, estate, statics, ep, psi)
