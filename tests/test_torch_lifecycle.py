"""The port's particle lifecycle and grid refit (``add_particles``,
``add_particles_traced``, ``remove_particles``, ``refit_grid``) against
the JAX package's on the same numpy inputs (CPU).

Mirrors ``tests/test_app.py::test_remove_particles_semantics``,
``::test_add_particles_traced_semantics`` and
``::test_fountain_emit_and_drain``, and ``tests/test_grid.py::
test_refit_grid_covers_live_particles`` and
``::test_refit_and_rehash_preserve_physics``, plus a multiphase case (the
phase columns follow the sort) and the capacity refusal. The lifecycle
operations move values without arithmetic, so they are held exactly; the
steps at the tolerances of ``tests/test_pallas.py`` (positions atol 1e-6,
velocities atol 1e-5), the refit's physics at ``tests/test_grid.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import scene as jscene
from nereus_tpu.boundary import rehash_boundary as j_rehash
from nereus_tpu.scene import particle_cube

import nereus_tpu_torch as pt
from nereus_tpu_torch.boundary import rehash_boundary

from torch_bridge import params_to_port, to_port

torch.set_num_threads(1)


def _port_state(state):
    """A JAX FluidState as a port FluidState on the CPU."""
    from nereus_tpu_torch import convert
    return convert.state_from_numpy(state.pos, state.vel, state.pressure,
                                    state.num_active, state.mass, state.rho0,
                                    device="cpu")


def _assert_same(port, ref):
    """Every column of two states equal, the live count too."""
    assert int(port.num_active) == int(ref.num_active)
    for f in ("pos", "vel", "pressure", "mass", "rho0"):
        got, want = getattr(port, f), getattr(ref, f)
        assert (got is None) == (want is None), f
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f)


def _random_state(multiphase=False):
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 1, (50, 3))
    vel = rng.normal(size=(50, 3))
    kw = {}
    if multiphase:
        kw = dict(masses=rng.uniform(0.5, 2.0, 50),
                  rest_densities=np.where(pos[:, 1] > 0.5, 300.0, 1000.0))
    state = jt.make_fluid_state(pos, velocities=vel, capacity=64, **kw)
    return state, pos, vel


@pytest.mark.parametrize("multiphase", [False, True],
                         ids=["single", "multiphase"])
def test_remove_particles_matches_jax(multiphase):
    """Keepers in order at the front, dropped slots parked at 1e9 with zero
    velocity and pressure, the live count dropped; the phase columns
    follow the sort (the dropped particles' mass and ρ₀ stay in the parked
    slots); slots already inactive stay inactive; freed slots refill."""
    state, pos, vel = _random_state(multiphase)
    state = jt.FluidState(pos=state.pos, vel=state.vel,
                          pressure=jnp.arange(64, dtype=jnp.float32),
                          num_active=state.num_active, mass=state.mass,
                          rho0=state.rho0)
    pstate = _port_state(state)
    drop = jax.jit(lambda s: jt.remove_particles(s, s.pos[:, 0] >= 0.5))
    out = drop(state)
    pout = pt.remove_particles(pstate, pstate.pos[:, 0] >= 0.5)
    _assert_same(pout, out)
    k = int((pos[:, 0] >= 0.5).sum())
    assert int(pout.num_active) == k
    np.testing.assert_array_equal(pout.pos.numpy()[:k],
                                  pos[pos[:, 0] >= 0.5].astype(np.float32))
    assert (pout.pos.numpy()[k:] == 1e9).all()
    assert (pout.vel.numpy()[k:] == 0).all()
    assert (pout.pressure.numpy()[k:] == 0).all()
    if multiphase:
        assert np.isfinite(pout.mass.numpy()).all()
        assert sorted(pout.mass.numpy()[:50]) == sorted(
            pstate.mass.numpy()[:50])
    # already-inactive slots stay inactive even where keep says True
    again = pt.remove_particles(pout, torch.ones(64, dtype=torch.bool))
    _assert_same(again, jt.remove_particles(out, jnp.ones(64, bool)))
    assert int(again.num_active) == k
    # freed slots are reusable
    fill = np.full((64 - k, 3), 0.3)
    _assert_same(pt.add_particles(pout, fill), jt.add_particles(out, fill))


def test_add_particles_matches_jax():
    """Appended rows at the live count, velocities broadcast; a multiphase
    state's new rows take the given mass and ρ₀, or the first particle's."""
    state, _, _ = _random_state()
    pts = np.full((5, 3), 0.4)
    _assert_same(pt.add_particles(_port_state(state), pts, velocities=1.0),
                 jt.add_particles(state, pts, velocities=1.0))
    mstate, _, _ = _random_state(multiphase=True)
    pm = _port_state(mstate)
    _assert_same(pt.add_particles(pm, pts, masses=0.7,
                                  rest_densities=500.0),
                 jt.add_particles(mstate, pts, masses=0.7,
                                  rest_densities=500.0))
    _assert_same(pt.add_particles(pm, pts), jt.add_particles(mstate, pts))
    with pytest.raises(ValueError, match="single-phase"):
        pt.add_particles(_port_state(state), pts, masses=1.0)


def test_add_particles_past_capacity_raises():
    state, _, _ = _random_state()
    too_many = np.zeros((15, 3))
    with pytest.raises(ValueError, match="exceeds capacity"):
        jt.add_particles(state, too_many)
    with pytest.raises(ValueError, match="exceeds capacity"):
        pt.add_particles(_port_state(state), too_many)
    # the traced form refuses nothing at the host: it reports the overflow
    s, ovf = pt.add_particles_traced(_port_state(state), too_many)
    assert int(ovf) == 15 and int(s.num_active) == 50


@pytest.mark.parametrize("multiphase", [False, True],
                         ids=["single", "multiphase"])
def test_add_particles_traced_matches_jax(multiphase):
    """Emission at the live count with no host read; a batch that would
    not fit writes nothing and reports its size; a multiphase state emits
    the first particle's phase."""
    kw = {}
    if multiphase:
        kw = dict(masses=[0.5, 0.6, 0.7, 0.8],
                  rest_densities=[300.0, 300.0, 1000.0, 1000.0])
    state = jt.make_fluid_state(np.zeros((4, 3)) + 0.2, capacity=10, **kw)
    pstate = _port_state(state)
    pts = np.full((3, 3), 0.4, np.float32)
    emit = jax.jit(lambda s: jt.add_particles_traced(
        s, pts, velocities=jnp.ones(3)))
    for want_ovf, want_n in ((0, 7), (0, 10), (3, 10)):
        state, ovf = emit(state)
        pstate, povf = pt.add_particles_traced(pstate, pts,
                                               velocities=np.ones(3))
        assert povf.dtype == torch.int32 and povf.dim() == 0
        assert int(povf) == int(ovf) == want_ovf
        assert int(pstate.num_active) == want_n
        _assert_same(pstate, state)


def test_emit_and_drain_matches_jax():
    """``test_fountain_emit_and_drain`` at small n: a nozzle emits a jet
    every 4 steps into a 256-slot state, a WCSPH step, then a drain plane
    removes what falls below it. Each step starts both packages from JAX's
    state: the emission and the drain are held exactly, the step at the
    one-step tolerances (float32 rounding grows along a free trajectory of
    colliding jets)."""
    cfg = jt.SimConfig(engine="segments")
    params = jt.make_params()
    spacing = float(params.interaction_radius) - 0.005
    nozzle = particle_cube((0.25, 0.55, 0.25), (0.08, 0.04, 0.08), spacing)
    state = jt.make_fluid_state(np.zeros((0, 3)), capacity=256)
    grid = jt.fit_grid(np.array([-0.2, -0.2, -0.2]),
                       np.array([0.7, 0.8, 0.7]),
                       float(params.interaction_radius))
    pcfg, pparams, _, pgrid, _ = to_port(cfg, params, state, grid, None)
    jet = np.asarray([0.0, -3.0, 0.0])
    drain_y = 0.5

    @jax.jit
    def j_emit(s):
        return jt.add_particles_traced(s, nozzle, velocities=jnp.asarray(jet))

    j_step = jax.jit(lambda s: jt.wcsph_step(s, params, grid, cfg, None))
    counts, drained = [], 0
    for i in range(24):
        if i % 4 == 0:
            pstate, povf = pt.add_particles_traced(_port_state(state),
                                                   nozzle, velocities=jet)
            state, ovf = j_emit(state)
            assert int(ovf) == int(povf) == 0
            _assert_same(pstate, state)
        pstate, _ = pt.wcsph_step(_port_state(state), pparams, pgrid, pcfg,
                                  None)
        state, d = j_step(state)
        n = int(state.num_active)
        assert int(pstate.num_active) == n and int(d.seg_overflow) == 0
        np.testing.assert_allclose(pstate.pos.numpy()[:n],
                                   np.asarray(state.pos)[:n], rtol=0,
                                   atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(pstate.vel.numpy()[:n],
                                   np.asarray(state.vel)[:n], rtol=0,
                                   atol=1e-5, err_msg=str(i))
        pstate = pt.remove_particles(_port_state(state),
                                     torch.from_numpy(np.array(
                                         state.pos[:, 1] >= drain_y)))
        state = jt.remove_particles(state, state.pos[:, 1] >= drain_y)
        _assert_same(pstate, state)
        drained += n - int(state.num_active)
        counts.append(int(state.num_active))
    assert drained > 0 and max(counts) <= 256 and counts[-1] > 0


def test_refit_grid_matches_jax():
    """The refit grid covers the live particles, ignores the parked slots
    and equals JAX's (origin and size), with and without a boundary."""
    rng = np.random.default_rng(0)
    state = jt.make_fluid_state(rng.uniform(-2.0, 3.0, (200, 3)),
                                capacity=256)
    pstate = _port_state(state)
    g = pt.refit_grid(pstate, 0.1)
    want = jt.refit_grid(state, 0.1)
    assert g.size == tuple(want.size)
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(want.origin))
    lo = g.origin.numpy()
    hi = lo + np.asarray(g.size) * g.cell.numpy()
    pos = pstate.pos.numpy()[:200]
    assert (pos > lo).all() and (pos < hi).all()
    assert max(g.size) < 100
    # with a boundary set, its samples widen the box
    cfg = jt.SimConfig()
    params = jt.make_params()
    _, jgrid, walls = jscene.dam_break(
        params, cfg, cube_size=(0.2, 0.2, 0.2), cube_center=(-0.3, 0.05, 0.5),
        box_min=(-2.5, -0.3, 0.0), box_max=(0.2, 0.7, 3.5),
        with_boundary=True, boundary_radius=0.04)
    pwalls = to_port(cfg, params, state, jgrid, walls)[4]
    g = pt.refit_grid(pstate, 0.1, boundary=pwalls)
    want = jt.refit_grid(state, 0.1, boundary=walls)
    assert g.size == tuple(want.size)
    np.testing.assert_array_equal(g.origin.numpy(), np.asarray(want.origin))


def test_refit_and_rehash_preserve_physics():
    """One step on an oversized grid and one on the grid refit to the live
    fluid + boundary AABB (with the boundary re-sorted for each) agree, as
    ``tests/test_grid.py`` holds JAX's; the port's refit grid equals JAX's
    and its step on it follows JAX's segment step."""
    cfg = jt.SimConfig(seg_window=48, engine="segments")
    params = jt.make_params(dt=5e-4)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.2, 0.2, 0.2), cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=True, boundary_radius=0.04)
    n = int(state.num_active)
    pcfg, pparams, pstate, _, pb = to_port(cfg, params, state, grid,
                                           boundary)
    ir = float(params.interaction_radius)
    lo, hi = np.asarray((-0.8, -0.3, 0.0)), np.asarray((0.2, 0.7, 1.0))
    g1 = pt.fit_grid(lo - 0.7, hi + 0.7, ir, device="cpu")
    g2 = pt.refit_grid(pstate, ir, boundary=pb)
    jg2 = jt.refit_grid(state, ir, boundary=boundary)
    assert g2.size == tuple(jg2.size) and g2.size != g1.size
    np.testing.assert_array_equal(g2.origin.numpy(), np.asarray(jg2.origin))
    s1, d1 = pt.wcsph_step(pstate, pparams, g1, pcfg,
                           rehash_boundary(pb, g1))
    s2, d2 = pt.wcsph_step(pstate, pparams, g2, pcfg,
                           rehash_boundary(pb, g2))

    def key(a):
        return np.lexsort((a[:, 2], a[:, 1], a[:, 0]))

    p1, p2 = s1.pos.numpy()[:n], s2.pos.numpy()[:n]
    k1, k2 = key(p1), key(p2)
    np.testing.assert_allclose(p2[k2], p1[k1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(s2.vel.numpy()[:n][k2],
                               s1.vel.numpy()[:n][k1], rtol=0, atol=1e-5)
    js2, _ = jax.jit(lambda s: jt.wcsph_step(
        s, params, jg2, cfg, j_rehash(boundary, jg2)))(state)
    np.testing.assert_allclose(p2, np.asarray(js2.pos)[:n], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(s2.vel.numpy()[:n], np.asarray(js2.vel)[:n],
                               rtol=0, atol=1e-5)


def test_refit_needs_no_host_copy_of_state():
    """The AABB ignores parked slots however far they sit, and an empty
    state's refit is the boundary's box."""
    state = pt.make_fluid_state(np.zeros((0, 3)), capacity=8, device="cpu")
    b = pt.BoundaryData(pos=torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]),
                        psi=torch.ones(2),
                        sorted_hash=torch.zeros(2, dtype=torch.int32))
    g = pt.refit_grid(state, 0.5, boundary=b, margin=0.0)
    np.testing.assert_array_equal(g.origin.numpy(), [0.0, 0.0, 0.0])
    assert g.size == (2, 4, 6)
