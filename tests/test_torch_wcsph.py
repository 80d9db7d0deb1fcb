"""The port's WCSPH step vs the JAX package's steps, the O(N²) numpy
oracle, and a short stability run (CPU, plain sweeps).

One step from identical inputs (carried across by
``nereus_tpu_torch.convert``) is held against ``wcsph_step_pallas`` in
interpret mode and against the jnp segment step, with the tolerances of
``tests/test_pallas.py``: positions atol 1e-6, velocities atol 1e-5,
mean density error rtol 1e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.solvers.wcsph_pallas import wcsph_step_pallas

import nereus_tpu_torch as pt
from nereus_tpu_torch import boundary as pbnd
from nereus_tpu_torch import grid as pgrid
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from reference_np import Oracle
from torch_bridge import MODEL_IDS, MODELS, jax_scene, to_port

torch.set_num_threads(1)


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set,st", MODELS, ids=MODEL_IDS)
def test_step_matches_jax(kernel_set, st, with_boundary):
    cfg, params, state, grid, boundary = jax_scene(with_boundary,
                                                   kernel_set, st)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    n = int(state.num_active)
    s_port, d_port = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
    assert int(d_port.seg_overflow) == 0
    refs = {
        "pallas": jax.jit(lambda s: wcsph_step_pallas(
            s, params, grid, cfg, boundary))(state),
        "segments": jax.jit(lambda s: jt.wcsph_step(
            s, params, grid, cfg, boundary))(state),
    }
    for name, (s_ref, d_ref) in refs.items():
        assert int(d_ref.seg_overflow) == 0, name
        # both steps return hash-sorted state in the same stable order
        np.testing.assert_allclose(s_port.pos.numpy()[:n],
                                   np.asarray(s_ref.pos)[:n],
                                   rtol=0, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(s_port.vel.numpy()[:n],
                                   np.asarray(s_ref.vel)[:n],
                                   rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(float(d_port.mean_density_error),
                                   float(d_ref.mean_density_error),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(float(d_port.max_density),
                                   float(d_ref.max_density), rtol=1e-4,
                                   err_msg=name)


def test_multi_step_stability():
    """20 steps with the floor inside the kernel support of the bottom
    layer: finite, no overflow, nothing through the floor."""
    floor = -0.115
    scene = jax_scene(True, floor=floor)
    pcfg, pparams, state, pg, pb = to_port(*scene)
    for _ in range(20):
        state, diag = pt.wcsph_step(state, pparams, pg, pcfg, pb)
    pos = state.pos.numpy()[:int(state.num_active)]
    assert np.isfinite(pos).all()
    assert np.isfinite(state.vel.numpy()).all()
    assert int(diag.seg_overflow) == 0
    assert pos[:, 1].min() > floor
    assert 0.0 <= float(diag.mean_compression) < 0.1


def _oracle_setup(seed, n=600):
    """``tests/test_density_forces.py``'s random block with a box shell."""
    params = pt.make_params(device="cpu")
    h = float(params.interaction_radius)
    rng = np.random.RandomState(seed)
    side = h * (n / 2.0) ** (1 / 3)
    pos = rng.uniform(0.0, side, (n, 3))
    vel = rng.uniform(-1.0, 1.0, (n, 3))
    grid = pgrid.fit_grid(pos.min(0), pos.max(0), h, device="cpu")
    state = pt.make_fluid_state(pos, vel, device="cpu")
    boundary = pbnd.box_boundary(grid, (-0.05,) * 3, (side + 0.05,) * 3,
                                 0.02, params, device="cpu")
    oracle = Oracle(h, float(params.particle_mass),
                    float(params.rest_density), float(params.gas_stiffness),
                    float(params.viscosity), float(params.surface_tension),
                    float(params.particle_radius), float(params.beta),
                    float(params.sound_speed))
    return params, grid, state, boundary, oracle


@pytest.mark.parametrize("with_boundary", [False, True])
def test_density_and_forces_match_oracle(with_boundary):
    params, grid, state, boundary, oracle = _oracle_setup(
        seed=2 if with_boundary else 1)
    if not with_boundary:
        boundary = None
    cfg = pt.SimConfig()
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dens = SP.density_sweep(cfg, *ctx.density_operands(
        params.particle_mass))
    pres = pt.tait_pressure(dens, params)
    pd2 = pres / dens.clamp(min=1e-12) ** 2
    force = SP.fluid_force_sweep(cfg, *ctx.force_operands(vel, dens, pd2))
    force = force + params.particle_mass * params.gravity

    spos = torch.stack([ctx.px, ctx.py, ctx.pz], 1).double().numpy()
    svel = torch.stack(vel, 1).double().numpy()
    bpos = psi = None
    if boundary is not None:
        bpos = boundary.pos.double().numpy()
        psi = boundary.psi.double().numpy()
    d64 = oracle.density(spos, bpos, psi)
    np.testing.assert_allclose(dens.numpy(), d64, rtol=2e-5)
    want = oracle.forces(spos, svel, d64, oracle.tait(d64), bpos, psi)
    scale = np.maximum(np.linalg.norm(want, axis=-1, keepdims=True), 1e-3)
    np.testing.assert_allclose(force.numpy() / scale, want / scale,
                               atol=2e-3)


def test_parked_slots_stay_parked():
    params, grid, state, _, _ = _oracle_setup(seed=4)
    n = state.capacity
    s = pt.make_fluid_state(state.pos.numpy(), state.vel.numpy(),
                            capacity=n + 64, device="cpu")
    for _ in range(2):
        s, _ = pt.wcsph_step(s, params, grid, pt.SimConfig())
    pos = s.pos.numpy()
    assert np.all(pos[n:] == np.float32(1e9))
    assert np.isfinite(pos[:n]).all()


def test_cfl_dt_matches_jax():
    cfg, params, state, grid, boundary = jax_scene(False)
    _, pparams, pstate, _, _ = to_port(cfg, params, state, grid, boundary)
    np.testing.assert_allclose(float(pt.cfl_dt(pstate, pparams)),
                               float(jt.cfl_dt(state, params)), rtol=1e-6)


def test_unported_options_raise():
    """Nothing the JAX step takes is refused any more: moving boundaries
    are ported (``test_torch_moving_boundary.py``), implicit viscosity too
    (``test_torch_viscosity.py``). A wall set at velocity 0, once refused,
    runs and reproduces the static step."""
    scene = jax_scene(True)
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    s0, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
    s1, _ = pt.wcsph_step(pstate, pparams, pg, pcfg,
                          dataclasses.replace(pb, vel=torch.zeros_like(pb.pos)))
    assert torch.equal(s0.pos, s1.pos) and torch.equal(s0.vel, s1.vel)
