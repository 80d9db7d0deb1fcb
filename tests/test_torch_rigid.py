"""The port's rigid bodies and single-phase coupled WCSPH step vs the JAX
package (CPU, plain sweeps), mirroring ``tests/test_rigid.py``.

* ``make_rigid_box`` equals JAX's (offsets, ψ, mass, inertia exactly);
  ``integrate_rigid`` follows JAX's over 50 steps under a torque
  (rtol 1e-5); ``wall_contact_force`` and ``body_body_contact`` equal
  JAX's within 1e-5·max|ref| (float32 sums in another order).
* The ``BodyForce`` plain twin (the body form of ``boundary_force_pair``:
  moving, no adhesion, repulsive consistent pressure) against JAX's pair
  function summed over every (query, sample) pair within h, on the
  coupled step's own operands and on them with pd2 = 0 (the friction
  alone): max|Δ| ≤ 1e-5·max|ref| per column.
* ``wcsph_coupled_step`` against JAX's Pallas step (interpret mode) over
  three steps with one body and two steps with two bodies, the bodies
  moving and spinning inside a fluid block with seeded velocities: fluid
  positions atol 2e-5 and velocities atol 1e-4 in sorted order, body com
  atol 1e-6, velocity atol 1e-5, ω atol 1e-4, R atol 1e-6 (the
  tolerances of ``test_coupled_engine_equivalence``, tighter where the
  port holds them).
* Mirrors of ``test_rigid.py``: total momentum is conserved while a blob
  hits a body at zero gravity, and the refusals.
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
from nereus_tpu.scene import particle_cube

import nereus_tpu_torch as pt
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import coupled_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, body_to_port,
                          exact_reciprocal, params_to_port, to_port)

torch.set_num_threads(1)

BODY_FIELDS = ("offsets", "psi", "mass", "inertia_body", "com", "R", "vel",
               "omega")


def _box(params, center, size=0.08, density=300.0):
    return jt.make_rigid_box(center, (size,) * 3,
                             float(params.particle_radius), density, params)


def _spin(body, vel, omega):
    return dataclasses.replace(body, vel=jnp.asarray(vel, jnp.float32),
                               omega=jnp.asarray(omega, jnp.float32))


def _tank(n_bodies=1):
    """``test_coupled_engine_equivalence``'s tank (walls 0.4 × 0.6 × 0.4,
    dt 2e-4) with a 0.2 fluid block at spacing 2·r, seeded velocities in
    ±0.2 m/s, and one or two 0.08 boxes inside it, moving and spinning,
    the fluid carved out of their shells to a quarter spacing (the nearest
    fluid 0.02 from a face, inside the support); two bodies' shells stand
    0.02 apart (the body-body contact live). Returns ``(cfg, params, state,
    grid, walls, bodies)`` (JAX objects)."""
    cfg = jt.SimConfig(engine="pallas")
    params = jt.make_params(dt=2e-4)
    h = float(params.interaction_radius)
    spacing = 2 * float(params.particle_radius)
    fluid = particle_cube((0.2, 0.2, 0.2), (0.2, 0.2, 0.2), spacing)
    centers = [(0.2, 0.2, 0.2), (0.2, 0.3, 0.2)][:n_bodies]
    keep = np.ones(len(fluid), bool)
    for c in centers:
        keep &= np.abs(fluid - np.asarray(c)).max(axis=1) > 0.04 + 0.25 * (
            spacing)
    fluid = fluid[keep]
    vel = np.random.default_rng(5).uniform(-0.2, 0.2, fluid.shape)
    lo, hi = np.zeros(3), np.array((0.4, 0.6, 0.4))
    grid = jt.fit_grid(lo - h, hi + h, h)
    walls = box_boundary(grid, lo, hi, float(params.particle_radius), params)
    bodies = tuple(_spin(_box(params, c, density=300.0 + 500.0 * k),
                         (0.05, -0.1, 0.02), (0.2 * (k + 1), -0.1, 0.3))
                   for k, c in enumerate(centers))
    state = jt.make_fluid_state(fluid, vel.astype(np.float32))
    return cfg, params, state, grid, walls, bodies


def _assert_body_close(got, want, name=""):
    tol = {"com": 1e-6, "vel": 1e-5, "omega": 1e-4, "R": 1e-6}
    for f, atol in tol.items():
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f"{name} {f}")


# ---------------------------------------------------------------------------
# The body, its integration and its dense contacts
# ---------------------------------------------------------------------------

def test_make_rigid_box_basics():
    """The box's basics (``test_make_rigid_box_basics``) and the box equal
    to JAX's, field by field."""
    params = jt.make_params()
    pparams = params_to_port(params)
    args = ((0.2, 0.2, 0.2), (0.1, 0.08, 0.12), 0.02, 500.0)
    body = pt.make_rigid_box(*args, pparams, device="cpu")
    want = jt.make_rigid_box(*args, params)
    assert body.num_samples == want.num_samples > 20
    assert float(body.mass) == np.float32(500.0 * 0.1 * 0.08 * 0.12)
    inertia = body.inertia_body.numpy()
    assert (np.diag(inertia) > 0).all() and np.allclose(inertia, inertia.T)
    assert (body.psi.numpy() > 0).all()
    for f in BODY_FIELDS:
        np.testing.assert_array_equal(getattr(body, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    grid = pt.fit_grid(np.zeros(3), np.ones(3), 0.0457, device="cpu")
    p = pt.body_boundary(body, grid).pos.numpy()
    assert p.min() > 0.2 - 0.07 and p.max() < 0.2 + 0.07


def test_integrate_rigid_freefall_and_spin():
    """Free fall (``test_integrate_rigid_freefall_and_spin``), then 50
    steps under a torque about a tilted axis against JAX's
    ``integrate_rigid`` (rtol 1e-5, atol 1e-7); R stays orthonormal."""
    params = jt.make_params()
    body = jt.make_rigid_box((0.0, 0.0, 0.0), (0.1, 0.07, 0.13), 0.02,
                             1000.0, params)
    pbody = body_to_port(body)
    dt = 1e-2
    b = pt.integrate_rigid(pbody, torch.zeros(3), torch.zeros(3), dt,
                           (0.0, -9.81, 0.0))
    np.testing.assert_allclose(float(b.vel[1]), -9.81 * dt, rtol=1e-5)
    np.testing.assert_allclose(b.com.numpy(), [0.0, -9.81 * dt * dt, 0.0],
                               atol=1e-7)
    force = np.array([0.3, -0.2, 0.1], np.float32)
    torque = np.array([2e-4, -1e-4, 1e-3], np.float32)
    step = jax.jit(lambda bb: jt.integrate_rigid(
        bb, jnp.asarray(force), jnp.asarray(torque), dt, (0.0, -9.81, 0.0)))
    jb, pb = body, pbody
    for _ in range(50):
        jb = step(jb)
        pb = pt.integrate_rigid(pb, torch.from_numpy(force),
                                torch.from_numpy(torque), dt,
                                (0.0, -9.81, 0.0))
    assert float(pb.omega[2]) > 0
    for f in ("com", "vel", "omega", "R"):
        np.testing.assert_allclose(getattr(pb, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    R = pb.R.numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_wall_and_body_contacts_match_jax():
    """The dense body ↔ wall and body ↔ body penalty contacts, the bodies
    pressed into a wall corner and into each other with moving samples,
    against JAX's: max|Δ| ≤ 1e-5·max|ref| per component, Newton's third
    law exact."""
    params = jt.make_params()
    h = float(params.interaction_radius)
    grid = jt.fit_grid(np.zeros(3) - h, np.ones(3) * 0.4 + h, h)
    walls = box_boundary(grid, np.zeros(3), np.ones(3) * 0.4,
                         float(params.particle_radius), params)
    a = _spin(_box(params, (0.05, 0.05, 0.2)), (0.1, -0.3, 0.0),
              (0.0, 0.0, 2.0))
    b = _spin(_box(params, (0.05, 0.13, 0.21)), (0.0, -0.5, 0.1),
              (1.0, 0.0, 0.0))
    pparams = params_to_port(params)
    _, _, _, _, pwalls = to_port(jt.SimConfig(), params,
                                 jt.make_fluid_state(np.zeros((1, 3))),
                                 grid, walls)
    pa, pb = body_to_port(a), body_to_port(b)
    got = pt.wall_contact_force(pa, pwalls, pparams)
    want = jt.wall_contact_force(a, walls, params)
    got += pt.body_body_contact(pa, pb, pparams)
    want += jt.body_body_contact(a, b, params)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.0, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    assert torch.equal(got[4], -got[2])


# ---------------------------------------------------------------------------
# The body contact sweep and the coupled step
# ---------------------------------------------------------------------------

def test_body_force_twin_matches_jax():
    """The body contact's plain twin on the step's own operands (the fused
    density with the shell's ψ-density, Tait pd2, the shell at its pose)
    against JAX's ``boundary_force_pair(moving=True,
    include_adhesion=False, pressure_sign=-1, consistent_pressure=True)``
    summed over every pair within h, and its friction alone (pd2 = 0;
    ~1e-10 of the pressure term here); the friction reads the sample
    velocities."""
    cfg, params, state, grid, walls, (body,) = _tank()
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    shells = coupled_cuda.body_shells(ctx, pg, (body_to_port(body),))
    _, fargs, _, pres = coupled_cuda.coupled_operands(ctx, pparams, pcfg,
                                                      shells)
    sh = shells[0]
    assert float(pres.max()) > 0.0 and float(pres.min()) < 0.0
    pv = PS.build_pvec(params, cfg, grid)
    src = jnp.asarray(sh.src.numpy().T)
    # as the step runs it, then the friction alone (pd2 = 0)
    fric = fargs[0].clone()
    fric[:, 7] = 0.0
    for name, q in (("body force", fargs[0]), ("friction", fric)):
        got = SP.body_force_sweep(pcfg, q, sh.src, sh.seg_start, sh.seg_end,
                                  ctx.pvec)
        jq = jnp.asarray(q.numpy())
        want = PS.boundary_force_pair(
            jq, src, jnp.ones((jq.shape[0], src.shape[1]), bool), pv,
            kernel_set=cfg.kernel_set, include_pressure=True, moving=True,
            include_adhesion=False, pressure_sign=-1.0,
            consistent_pressure=True)
        assert_columns_close(got.numpy(), np.asarray(want)[:, :3], 1e-5,
                             name)
    # the friction reads the sample velocities
    still = SP.body_force_sweep(pcfg, fric, sh.src.clone().index_fill_(
        1, torch.tensor([3, 4, 5]), 0.0), sh.seg_start, sh.seg_end, ctx.pvec)
    assert float((still - got).abs().max()) > 1e-3 * float(got.abs().max())


def _coupled_vs_jax(n_bodies, steps):
    cfg, params, state, grid, walls, bodies = _tank(n_bodies)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    pbodies = tuple(body_to_port(b) for b in bodies)
    n = int(state.num_active)
    step = jax.jit(lambda s, b: jt.wcsph_coupled_step(s, params, grid, cfg,
                                                      b, walls))
    js, jb, ps, pb = state, bodies, pstate, pbodies
    for it in range(steps):
        js, jb, jd = step(js, jb)
        ps, pb, pd = pt.wcsph_coupled_step(ps, pparams, pg, pcfg, pb, pw)
        name = f"{n_bodies} bodies step {it}"
        assert int(jd.seg_overflow) == 0
        np.testing.assert_allclose(ps.pos.numpy()[:n],
                                   np.asarray(js.pos)[:n], rtol=0,
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(ps.vel.numpy()[:n],
                                   np.asarray(js.vel)[:n], rtol=0,
                                   atol=1e-4, err_msg=name)
        for k in range(n_bodies):
            _assert_body_close(pb[k], jb[k], f"{name} body {k}")
    # the fluid pushed the bodies: their velocities left the free fall by
    # ten times the velocity tolerance
    for k in range(n_bodies):
        free = np.asarray(bodies[k].vel) + steps * float(params.dt) * (
            np.asarray(params.gravity))
        assert np.abs(pb[k].vel.numpy() - free).max() > 1e-4
    return pb


def test_coupled_step_matches_jax(exact_reciprocal):
    """One body, three steps; a single body in, a single body out."""
    pb = _coupled_vs_jax(1, 3)
    cfg, params, state, grid, walls, (body,) = _tank()
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    _, one, _ = pt.wcsph_coupled_step(pstate, pparams, pg, pcfg,
                                      body_to_port(body), pw)
    assert isinstance(one, pt.RigidBody) and len(pb) == 1


def test_coupled_step_two_bodies_matches_jax(exact_reciprocal):
    """Two bodies in one tank, two steps; a tuple in, a tuple out."""
    pb = _coupled_vs_jax(2, 2)
    assert isinstance(pb, tuple) and len(pb) == 2


def test_coupled_momentum_conservation():
    """Zero gravity, no walls, no viscosity, no surface tension: every pair
    force is central and balanced (the body's reaction is the fluid-side
    sum), so total momentum is conserved while a blob hits the body
    (rtol 2e-3, atol 2e-4, as ``test_coupled_momentum_conservation``)."""
    cfg = pt.SimConfig(surface_tension_model=pt.SurfaceTensionModel.NONE)
    params = pt.make_params(viscosity=0.0, gravity=(0.0, 0.0, 0.0),
                            dt=2e-4, device="cpu")
    h = float(params.interaction_radius)
    spacing = 0.8 * h
    params = pt.calibrate_mass(params, cfg, spacing=spacing)
    pm = float(params.particle_mass)
    fluid = pscene.particle_cube((0.22, 0.25, 0.25), (0.12,) * 3,
                                 spacing)
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
    for _ in range(25):
        state, body, d = pt.wcsph_coupled_step(state, params, grid, cfg,
                                               body)
    p1 = total_p(state, body)
    assert float(body.mass) * float(torch.linalg.norm(body.vel)) > \
        1e-3 * abs(p0[0])
    np.testing.assert_allclose(p1, p0, rtol=2e-3, atol=2e-4)


def test_coupled_refusals():
    """The single-phase coupled step refuses implicit viscosity (the JAX
    step runs the explicit viscosity whatever the model says) and an
    empty body sequence."""
    cfg, params, state, grid, walls, (body,) = _tank()
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    pbody = body_to_port(body)
    with pytest.raises(NotImplementedError, match="implicit viscosity"):
        pt.wcsph_coupled_step(
            pstate, pparams, pg,
            dataclasses.replace(pcfg, viscosity_model="implicit"), pbody,
            pw)
    with pytest.raises(ValueError, match="at least one body"):
        pt.wcsph_coupled_step(pstate, pparams, pg, pcfg, (), pw)
