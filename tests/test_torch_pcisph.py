"""The port's PCISPH step and its predicted-density sweep vs the JAX
package (CPU, plain sweeps).

* ``pcisph_delta`` against JAX's at rtol 1e-6, and a mirror of
  ``tests/test_pcisph.py::test_delta_positive_and_scale``.
* The predicted-density sweep (the density sweep at x* over the
  start-of-step ranges) against interpret-mode ``density_sweep(
  geom_offset=3)`` on the same sorted operands: max|Δ| ≤ 1e-5·max|ref|
  (float32 sums in another order), on a dam-break whose x* moves up to
  0.6·h and on the cell-crossing scene of
  ``tests/test_pallas_implicit.py``.
* ``pcisph_step`` against ``pcisph_step_pallas`` (interpret) and the jnp
  segment step over two steps, with and without boundary, with the
  tolerances of ``tests/test_pallas_implicit.py`` (positions atol 1e-5,
  velocities atol 2e-4) and equal iteration counts; the cell-crossing
  scene against the segment step, whose neighborhoods are frozen too.
* The refusals and the loop's host reads once per SYNC_EVERY iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import scene as jscene
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass as j_calibrate_mass
from nereus_tpu.solvers import common
from nereus_tpu.solvers import pcisph as j_pcisph
from nereus_tpu.solvers.pallas_common import build_pallas_ctx
from nereus_tpu.solvers.pcisph_pallas import pcisph_step_pallas

import nereus_tpu_torch as pt
from nereus_tpu_torch import convert
from nereus_tpu_torch import grid as pgrid
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import pcisph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, exact_reciprocal,
                          params_to_port, to_port)

torch.set_num_threads(1)


def _dam_scene(with_boundary, vel_frac=None, squeeze=1.005):
    """The ``tests/test_pallas_implicit.py`` PCISPH dam-break (216
    particles at spacing h − 0.005, dt 5e-4) with the mass calibrated to
    ``squeeze``× that spacing, so the block starts 1.5 % over-dense and
    the corrective loop builds pressure. With boundary, the floor stands
    0.05 under the bottom layer, inside the support. ``vel_frac``: seeded
    velocities in ±vel_frac·h/dt, so that x = x + dt·v moves up to
    vel_frac·h per axis."""
    cfg = jt.SimConfig(seg_window=48)
    params = jt.pcisph_params(dt=5e-4)
    spacing = float(params.interaction_radius) - 0.005
    params = j_calibrate_mass(params, cfg, spacing=spacing * squeeze)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.25, 0.25, 0.25),
        cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.125 if with_boundary else -0.3, 0.0),
        box_max=(0.2, 0.7, 1.0), with_boundary=with_boundary,
        boundary_radius=0.04)
    if vel_frac is not None:
        pos = np.asarray(state.pos)
        vmax = vel_frac * float(params.interaction_radius) / float(params.dt)
        vel = np.random.default_rng(1).uniform(-vmax, vmax, pos.shape)
        state = jt.make_fluid_state(pos, vel.astype(np.float32))
    return cfg, params, state, grid, boundary


def _crossing_scene():
    """``test_pallas_implicit.py::test_pcisph_pallas_predicted_cell_
    crossing_matches_oracle``: a jittered 6³ lattice moving 0.6 cells per
    dt, so most predictions land in the next cell."""
    cfg = jt.SimConfig(seg_window=64)
    params = j_calibrate_mass(jt.pcisph_params(dt=5e-4), cfg)
    h = float(params.interaction_radius)
    spacing = 2.0 * float(params.particle_radius)
    ax = np.arange(6) * spacing
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1).astype(
        np.float32)
    pts += np.random.default_rng(0).uniform(
        -0.1 * spacing, 0.1 * spacing, pts.shape).astype(np.float32)
    vel = np.full_like(pts, 0.6 * h / float(params.dt))
    state = jt.make_fluid_state(pts, vel)
    grid = jt.fit_grid(pts.min(0) - 2 * h, pts.max(0) + 0.6 * h + 2 * h, h)
    return cfg, params, state, grid, None


# ---------------------------------------------------------------------------
# The stiffness δ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel_set,spacing", [
    (jt.KernelSet.MULLER, None), (jt.KernelSet.MONAGHAN, None),
    (jt.KernelSet.MULLER, 0.8 * 0.0537)])
def test_pcisph_delta_matches_jax(kernel_set, spacing):
    cfg = jt.SimConfig(kernel_set=kernel_set)
    for params in (jt.pcisph_params(), j_calibrate_mass(
            jt.pcisph_params(dt=5e-4), cfg)):
        want = jt.pcisph_delta(params, cfg, spacing)
        got = pt.pcisph_delta(params_to_port(params),
                              convert.config_from_jax_fields(cfg), spacing)
        assert got > 0.0
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_delta_positive_and_scale():
    """``tests/test_pcisph.py::test_delta_positive_and_scale``: δ > 0 and
    δ ∝ 1/dt²."""
    cfg = pt.SimConfig()
    params = pt.pcisph_params(device="cpu")
    delta = pt.pcisph_delta(params, cfg)
    assert delta > 0.0
    params2 = pt.pcisph_params(dt=float(params.dt) / 2.0, device="cpu")
    np.testing.assert_allclose(pt.pcisph_delta(params2, cfg) / delta, 4.0,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# The predicted-density sweep against density_sweep(geom_offset=3)
# ---------------------------------------------------------------------------

def _jax_predicted_density(cfg, params, state, grid, boundary):
    """ρ* at x* = x + dt·v over the start-of-step window plan, as
    ``pcisph_step_pallas`` sweeps it; returns (ρ*, x*) at capacity."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    pred = tuple(p + params.dt * v for p, v in
                 zip((ctx.px, ctx.py, ctx.pz), (ctx.vx, ctx.vy, ctx.vz)))
    psi = jnp.full((ctx.c,), 1.0, ctx.dtype) * params.particle_mass
    rho = PS.density_sweep(cfg, ctx.queries(*pred, width=8),
                           ctx.pack(slot6=psi, pos_override=pred),
                           ctx.anchors, ctx.pvec, ctx.gsize,
                           n_rows=ctx.n_rows, geom_offset=3, interpret=True)
    return rho, jnp.stack(pred, axis=1)


def _jax_predicted_density_segments(cfg, params, state, grid, boundary):
    """The jnp oracle's ρ* at x* = x + dt·v over the fully frozen segment
    neighborhoods (``solvers/pcisph.py::_predicted_density``)."""
    ctx = common.build_ctx(state, grid, cfg, boundary)
    pred = ctx.state.pos + params.dt * ctx.state.vel
    return (j_pcisph._predicted_density(ctx, params, cfg, boundary, pred),
            pred, ctx.overflow)


@pytest.mark.parametrize("scene,reference", [
    ("dam-boundary", "pallas"), ("cell-crossing", "pallas"),
    ("dam-boundary-far", "segments")])
def test_predicted_density_sweep_matches_jax(scene, reference):
    """x* moves up to 0.3·h per axis (16 % of the particles change cell),
    0.6·h along the diagonal (the cell-crossing lattice), or up to 0.6·h
    per axis in mixed directions. At the last, JAX's Pallas sweep admits
    sources that its fused 3-row windows take in beyond the 27 start-of-
    step cells (the r² < h² cutoff removes them at x, not at x*), so that
    scene is held against the segment oracle, whose neighborhoods are
    exactly the port's."""
    scn = {"dam-boundary": lambda: _dam_scene(True, vel_frac=0.3),
           "cell-crossing": _crossing_scene,
           "dam-boundary-far": lambda: _dam_scene(True, vel_frac=0.6)}[
        scene]()
    cfg, params, state, grid, boundary = scn
    if reference == "pallas":
        rho, pred = jax.jit(lambda s: _jax_predicted_density(
            cfg, params, s, grid, boundary))(state)
    else:
        rho, pred, overflow = jax.jit(
            lambda s: _jax_predicted_density_segments(
                cfg, params, s, grid, boundary))(state)
        assert int(overflow) == 0
    n = state.capacity
    rho, pred = np.asarray(rho)[:n], np.asarray(pred)[:n]
    pcfg, pparams, pstate, pg, pb = to_port(*scn)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    got = SP.predicted_density_sweep(
        pcfg, *pcisph_cuda.predicted_density_operands(
            ctx, pparams.particle_mass)(torch.from_numpy(pred.copy())))
    assert ctx.seg_start.shape[0] == (18 if pb is not None else 9)
    # the predictions leave their start-of-step cells: the frozen ranges
    # are what holds the two sides together
    moved = (pgrid.cell_coords(pg, torch.from_numpy(pred.copy()))
             != pgrid.cell_coords(pg, torch.stack([ctx.px, ctx.py, ctx.pz],
                                                  1))).any(dim=1)
    assert float(moved.float().mean()) > 0.15
    assert_columns_close(got.numpy(), rho, 1e-5, scene)


# ---------------------------------------------------------------------------
# The step against pcisph_step_pallas and the segment step
# ---------------------------------------------------------------------------

def _compare(s_port, d_port, s_ref, d_ref, n, name):
    """Both steps return hash-sorted state in the same stable order."""
    assert int(d_port.solver_iters) == int(d_ref.solver_iters), name
    np.testing.assert_allclose(s_port.pos.numpy()[:n],
                               np.asarray(s_ref.pos)[:n], rtol=0, atol=1e-5,
                               err_msg=name)
    np.testing.assert_allclose(s_port.vel.numpy()[:n],
                               np.asarray(s_ref.vel)[:n], rtol=0, atol=2e-4,
                               err_msg=name)


@pytest.mark.parametrize("with_boundary", [False, True])
def test_pcisph_step_matches_jax(exact_reciprocal, with_boundary):
    """Two steps from rest at tol 0.3 % of ρ₀: the first from zero
    pressure (the warm sweep runs on p⁰ = 0) and past min-iters, the
    second from JAX's first-step state, warm-started from its non-zero
    pressure."""
    cfg, params, state, grid, boundary = _dam_scene(with_boundary)
    n = int(state.num_active)
    delta = jt.pcisph_delta(params, cfg)
    tol = 0.003
    steps = {
        "pallas": jax.jit(lambda s: pcisph_step_pallas(
            s, params, grid, cfg, boundary, delta=delta, tol_frac=tol)),
        "segments": jax.jit(lambda s: jt.pcisph_step(
            s, params, grid, cfg, boundary, delta=delta, tol_frac=tol)),
    }
    iters = []
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                boundary)
        s_port, d_port = pt.pcisph_step(pstate, pparams, pg, pcfg, pb,
                                        delta=delta, tol_frac=tol)
        refs = {name: fn(state) for name, fn in steps.items()}
        for name, (s_ref, d_ref) in refs.items():
            assert int(d_ref.seg_overflow) == 0, name
            _compare(s_port, d_port, s_ref, d_ref, n, f"{name} step {step}")
        iters.append(int(d_port.solver_iters))
        state = refs["pallas"][0]
        assert float(jnp.max(state.pressure)) > 0.0
    assert iters[0] > pcfg.pcisph_min_iters, iters


def test_pcisph_cell_crossing_step_matches_jax():
    """The cell-crossing scene: every iteration's x* leaves its cell, and
    the segment step keeps the start-of-step neighborhoods too."""
    cfg, params, state, grid, _ = _crossing_scene()
    delta = jt.pcisph_delta(params, cfg)
    s_ref, d_ref = jax.jit(lambda s: jt.pcisph_step(
        s, params, grid, cfg, None, delta=delta))(state)
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    s_port, d_port = pt.pcisph_step(pstate, pparams, pg, pcfg, delta=delta)
    _compare(s_port, d_port, s_ref, d_ref, int(state.num_active),
             "cell crossing")


# ---------------------------------------------------------------------------
# Refusals and the predicated loop
# ---------------------------------------------------------------------------

def test_unported_options_raise():
    pcfg, pparams, pstate, pg, pb = to_port(*_dam_scene(True))
    multi = pt.make_fluid_state(pstate.pos.numpy(), masses=1.0,
                                rest_densities=1000.0, device="cpu")
    with pytest.raises(NotImplementedError, match="WCSPH-only"):
        pt.pcisph_step(multi, pparams, pg, pcfg, pb)
    # moving boundaries are ported (test_torch_moving_boundary.py): a wall
    # set at velocity 0, once refused, reproduces the static step
    moving = dataclasses.replace(pb, vel=torch.zeros_like(pb.pos))
    s0, _ = pt.pcisph_step(pstate, pparams, pg, pcfg, pb)
    s1, _ = pt.pcisph_step(pstate, pparams, pg, pcfg, moving)
    assert torch.equal(s0.pos, s1.pos) and torch.equal(s0.vel, s1.vel)


def _port_block():
    """The over-dense 216-particle block without boundary, built by the
    port alone; the loop takes 10 iterations at tol 0.4 % of ρ₀."""
    cfg = pt.SimConfig()
    params = pt.pcisph_params(dt=5e-4, device="cpu")
    spacing = float(params.interaction_radius) - 0.005
    params = pt.calibrate_mass(params, cfg, spacing=spacing * 1.005)
    state, grid, _ = pscene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=False, device="cpu")
    return cfg, params, state, grid


@pytest.mark.parametrize("sync_every", [1, 2, 3, 4])
def test_corrective_loop_syncs_once_per_k_iterations(monkeypatch,
                                                     sync_every):
    """The loop reads its condition on the host after every SYNC_EVERY-th
    launched iteration from min-iters on, launches at most SYNC_EVERY − 1
    iterations past the converged count, and freezes the carry in those:
    the result does not depend on SYNC_EVERY."""
    cfg, params, state, grid = _port_block()
    delta = pt.pcisph_delta(params, cfg)
    monkeypatch.setattr(pcisph_cuda, "SYNC_EVERY", 1)
    s_1, d_1 = pt.pcisph_step(state, params, grid, cfg, delta=delta,
                              tol_frac=0.004)
    monkeypatch.setattr(pcisph_cuda, "SYNC_EVERY", sync_every)
    pcisph_cuda.LOOP.reset()
    s_k, d_k = pt.pcisph_step(state, params, grid, cfg, delta=delta,
                              tol_frac=0.004)
    it = int(d_k.solver_iters)
    launched = pcisph_cuda.LOOP.launched
    assert it == int(d_1.solver_iters) > cfg.pcisph_min_iters + 3
    assert int(pcisph_cuda.LOOP.last.it) == it
    assert torch.equal(s_k.pressure, s_1.pressure)
    assert torch.equal(s_k.vel, s_1.vel)
    assert it <= launched < it + sync_every
    checks = [m for m in range(1, launched + 1)
              if m >= cfg.pcisph_min_iters and m % sync_every == 0]
    assert pcisph_cuda.LOOP.syncs == len(checks)
    assert checks[-1] == launched


def test_delta_helpers_are_exported():
    """``nereus_tpu`` exports ``pcisph_grad_denom`` and
    ``pcisph_delta_from_denom``; so does the port, and both agree with the
    JAX functions on the default PCISPH parameters."""
    for name in ("pcisph_grad_denom", "pcisph_delta_from_denom"):
        assert name in jt.__all__ and name in pt.__all__, name
    params = jt.pcisph_params()
    pparams = params_to_port(params)
    denom = pt.pcisph_grad_denom(pparams, pt.SimConfig())
    j_denom = jt.pcisph_grad_denom(params, jt.SimConfig())
    assert denom == pytest.approx(j_denom, rel=1e-6)
    np.testing.assert_allclose(
        float(pt.pcisph_delta_from_denom(pparams, denom)),
        float(jt.pcisph_delta_from_denom(params, j_denom)), rtol=1e-6)
