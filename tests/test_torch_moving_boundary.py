"""The port's moving boundaries vs the JAX package (CPU, plain sweeps),
mirroring ``tests/test_moving_boundary.py``.

* ``move_boundary`` equals a rebuild from host-moved positions and equals
  JAX's ``move_boundary``: the same hashes, positions within 1e-6 (1e-5
  rotated) after a lexicographic sort; ψ rtol 1e-6.
* Every solver with a moving wall (wall velocity (0.8, 0, −0.4) m/s)
  against JAX's Pallas step (interpret mode) over two steps, on the
  ``tests/test_moving_boundary.py`` dam-break with its floor 0.04 under the
  bottom layer (the wall terms live) and seeded velocities: positions
  atol 2e-5, velocities atol 2e-3, the tolerances of
  ``test_moving_boundary_engine_equivalence``; WCSPH, IISPH, DFSPH, PCISPH,
  multiphase WCSPH and DFSPH, and WCSPH with the implicit viscosity solve
  (ν = 5; its matvec carries the wall velocity, an affine operator, as
  JAX's). The same wall at rest gives another IISPH, DFSPH and implicit
  viscosity result (ρ_adv, Dρ/Dt and the Laplacian read the wall velocity).
* The force and multiphase force plain sweeps with ``moving_boundary``
  against JAX's ``fluid_force_sweep(moving_boundary=True)`` and
  ``generic_sweep`` with ``multiphase_boundary_pair(moving=True)`` on the
  same sorted operands, and their wall friction alone (the pair functions
  with ``moving=True`` over the wall ranges, everything but the friction
  dropped): max|Δ| ≤ 1e-5·max|ref| per column (float32 sums in another
  order; the JAX force pairs' approximate reciprocal replaced by the exact
  one); the friction at rest differs by more than 10 %.
* Zero wall velocity reproduces the static step exactly; a piston pushes
  fluid; a rotating drum against JAX's DFSPH step at the same tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import boundary as JB
from nereus_tpu import scene as jscene
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch import boundary as PB
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import wcsph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_torch_multiphase import contact
from torch_bridge import assert_columns_close, exact_reciprocal, to_port

torch.set_num_threads(1)

WALL_VEL = (0.8, 0.0, -0.4)      # tests/test_moving_boundary.py:96
SOLVERS = ["wcsph", "iisph", "dfsph", "pcisph", "wcsph_mp", "dfsph_mp",
           "wcsph_visc"]
# the solvers whose step reads the wall velocity beyond the wall friction
# (IISPH's ρ_adv, DFSPH's Dρ/Dt and dδ̂/dt, the implicit viscosity
# Laplacian's wall rows); the friction is ~1e-10 of the wall force at these
# parameters, so WCSPH's and PCISPH's steps move by rounding alone and the
# friction is held apart (the sweep tests)
VELOCITY_READERS = ("iisph", "dfsph", "dfsph_mp", "wcsph_visc")
PCISPH_KW = dict(tol_frac=0.003)


def _lexsort(pos):
    p = np.asarray(pos)
    return np.lexsort((p[:, 2], p[:, 1], p[:, 0]))


@functools.lru_cache(maxsize=None)
def _scene(solver):
    """``(cfg, params, state, grid, walls)`` (JAX objects, walls static):
    ``test_moving_boundary._dam`` with the floor at −0.115 (0.04 under the
    bottom layer) and seeded velocities in ±0.5 m/s; the implicit
    solvers' mass calibrated to the lattice; ``*_mp`` the state split in
    two phases (the top half by y at 0.4·ρ₀, mass ρ0_i/ρ₀·m). PCISPH's
    scene is ``test_torch_pcisph.py``'s: dt 5e-4, mass calibrated to
    1.005× the lattice spacing, at rest, tolerance 0.3 % of ρ₀."""
    base = solver.removesuffix("_mp").removesuffix("_visc")
    cfg = jt.SimConfig(engine="pallas")
    if solver.endswith("_visc"):
        cfg = dataclasses.replace(cfg, viscosity_model="implicit")
    params = {"wcsph": lambda: jt.make_params(
                  viscosity=5.0 if solver.endswith("_visc") else 0.005),
              "iisph": jt.iisph_params,
              "dfsph": jt.dfsph_params,
              "pcisph": lambda: jt.pcisph_params(dt=5e-4)}[base]()
    if base != "wcsph":
        spacing = float(params.interaction_radius) - 0.005
        params = calibrate_mass(params, cfg, spacing=spacing * (
            1.005 if base == "pcisph" else 1.0))
    state, grid, walls = jscene.dam_break(
        params, cfg, cube_size=(0.25, 0.25, 0.25),
        cube_center=(-0.3, 0.05, 0.5), box_min=(-0.8, -0.115, 0.0),
        box_max=(0.2, 0.7, 1.0), boundary_radius=0.04)
    pos = np.asarray(state.pos)
    # PCISPH's corrective loop diverges from seeded velocities this
    # large; its scene starts at rest (test_torch_pcisph.py's)
    vmax = 0.0 if base == "pcisph" else 0.5
    vel = np.random.default_rng(3).uniform(-vmax, vmax, pos.shape)
    kw = {}
    if solver.endswith("_mp"):
        rd = float(params.rest_density)
        rho0 = np.where(pos[:, 1] >= np.median(pos[:, 1]), 0.4 * rd, rd)
        kw = dict(masses=rho0 * float(params.particle_mass) / rd,
                  rest_densities=rho0)
    state = jt.make_fluid_state(pos, vel.astype(np.float32), **kw)
    return cfg, params, state, grid, walls


@functools.lru_cache(maxsize=None)
def _jax_step(solver):
    """JAX's Pallas step of ``solver`` on its scene, jitted once with the
    boundary as an argument (a moved or rotated set reuses the trace)."""
    cfg, params, _, grid, _ = _scene(solver)
    base = solver.removesuffix("_mp").removesuffix("_visc")
    if base == "pcisph":
        delta = jt.pcisph_delta(params, cfg)
        return jax.jit(lambda s, b: jt.pcisph_step(
            s, params, grid, cfg, b, delta=delta, **PCISPH_KW))
    step = {"wcsph": jt.wcsph_step, "iisph": jt.iisph_step,
            "dfsph": jt.dfsph_step}[base]
    return jax.jit(lambda s, b: step(s, params, grid, cfg, b))


def _port_step(solver):
    if solver == "pcisph":
        return functools.partial(pt.pcisph_step, **PCISPH_KW)
    return {"wcsph": pt.wcsph_step, "iisph": pt.iisph_step,
            "dfsph": pt.dfsph_step}[
        solver.removesuffix("_mp").removesuffix("_visc")]


# ---------------------------------------------------------------------------
# move_boundary, rehash_boundary, rotation
# ---------------------------------------------------------------------------

def _port_walls(solver="wcsph"):
    cfg, params, state, grid, walls = _scene(solver)
    return (walls, params, grid) + to_port(cfg, params, state, grid,
                                           walls)[1:]


def test_move_boundary_matches_rebuild():
    """A translated set equals the set rebuilt from host-shifted positions
    and JAX's moved set: identical ascending hashes, the same (pos, ψ)
    multiset; no velocity argument leaves ``vel`` None."""
    walls, params, grid, pparams, _, pg, pb = _port_walls()
    off = np.array([0.03, -0.02, 0.05], np.float32)
    moved = PB.move_boundary(pb, pg, offset=torch.from_numpy(off))
    rebuilt = PB.build_boundary(
        pg, pb.pos.numpy() + off, pb.psi.numpy() / float(
            params.rest_density), float(params.rest_density), device="cpu")
    j_moved = JB.move_boundary(walls, grid, jnp.asarray(off))
    assert moved.vel is None
    for want in (rebuilt.sorted_hash.numpy(), np.asarray(j_moved.sorted_hash)):
        np.testing.assert_array_equal(moved.sorted_hash.numpy(), want)
    km = _lexsort(moved.pos.numpy())
    for ref_pos, ref_psi in ((rebuilt.pos.numpy(), rebuilt.psi.numpy()),
                             (np.asarray(j_moved.pos),
                              np.asarray(j_moved.psi))):
        kr = _lexsort(ref_pos)
        np.testing.assert_allclose(moved.pos.numpy()[km], ref_pos[kr],
                                   atol=1e-6)
        np.testing.assert_allclose(moved.psi.numpy()[km], ref_psi[kr],
                                   rtol=1e-6)


def test_rehash_boundary_matches_jax():
    """Re-sorting against a widened grid (the wavemaker's) gives JAX's
    hashes and order."""
    walls, params, grid, _, _, pg, pb = _port_walls()
    cell = float(np.asarray(grid.cell)[0])
    lo = np.asarray(grid.origin, np.float64)
    hi = lo + np.asarray(grid.size) * cell
    pad = np.array([0.05 + cell, 0.0, 0.0])
    j_grid = jt.fit_grid(lo - pad, hi + pad, cell)
    p_grid = pt.fit_grid(lo - pad, hi + pad, cell, device="cpu")
    got = PB.rehash_boundary(pb, p_grid)
    want = JB.rehash_boundary(walls, j_grid)
    np.testing.assert_array_equal(got.sorted_hash.numpy(),
                                  np.asarray(want.sorted_hash))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    assert got.vel is None and p_grid.size == j_grid.size


def test_rotation_matrix_basics():
    R = PB.rotation_matrix((0.0, 0.0, 1.0), np.pi / 2, device="cpu").numpy()
    np.testing.assert_allclose(R @ np.array([1.0, 0, 0]),
                               np.array([0.0, 1.0, 0.0]), atol=1e-6)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    R2 = PB.rotation_matrix((0.3, 1.0, -0.2), torch.tensor(0.7)).numpy()
    want = np.asarray(JB.rotation_matrix((0.3, 1.0, -0.2),
                                         jnp.float32(0.7)))
    np.testing.assert_allclose(R2, want, atol=1e-6)


def test_move_boundary_rotation_matches_rebuild():
    """Rotating about the set's centre equals rebuilding from host-rotated
    positions and JAX's rotated set (same hashes; positions 1e-5)."""
    walls, params, grid, _, _, pg, pb = _port_walls()
    center = pb.pos.numpy().mean(axis=0)
    R = PB.rotation_matrix((0.0, 1.0, 0.0), 0.35, device="cpu")
    moved = PB.move_boundary(pb, pg, rotation=R, center=center)
    host = (pb.pos.numpy() - center) @ R.numpy().T + center
    rebuilt = PB.build_boundary(pg, host, pb.psi.numpy() / float(
        params.rest_density), float(params.rest_density), device="cpu")
    j_moved = JB.move_boundary(walls, grid, rotation=jnp.asarray(R.numpy()),
                               center=center)
    for ref in (rebuilt, j_moved):
        np.testing.assert_array_equal(moved.sorted_hash.numpy(),
                                      np.asarray(ref.sorted_hash))
        np.testing.assert_allclose(moved.pos.numpy()[_lexsort(moved.pos)],
                                   np.asarray(ref.pos)[_lexsort(ref.pos)],
                                   atol=1e-5)


def test_omega_spin_velocities():
    """``omega`` gives v_b = ω × (p − c) per sample, in sorted order."""
    _, _, _, _, _, pg, pb = _port_walls()
    c = np.array([0.1, 0.2, 0.5], np.float32)
    w = np.array([0.0, 0.0, 3.0], np.float32)
    moved = PB.move_boundary(pb, pg, omega=w, center=c)
    p, v = moved.pos.numpy(), moved.vel.numpy()
    np.testing.assert_allclose(v, np.cross(np.broadcast_to(w, p.shape),
                                           p - c), atol=1e-5)


def test_concat_boundaries_matches_jax():
    """Walls plus a moving gate: one hash-sorted set equal to JAX's, the
    walls' rows at velocity 0."""
    from nereus_tpu.rigid import concat_boundaries as j_concat
    walls, params, grid, _, _, pg, pb = _port_walls()
    shift = np.array([0.0, 0.3, 0.0], np.float32)
    gate = PB.move_boundary(pb, pg, offset=shift,
                            velocity=np.array([0.2, 0.0, 0.0]))
    j_gate = JB.move_boundary(walls, grid, offset=jnp.asarray(shift),
                              velocity=jnp.asarray([0.2, 0.0, 0.0]))
    got = pt.concat_boundaries(pg, pb, gate)
    want = j_concat(grid, walls, j_gate)
    assert got.num_boundaries == 2 * pb.num_boundaries
    np.testing.assert_array_equal(got.sorted_hash.numpy(),
                                  np.asarray(want.sorted_hash))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.vel.numpy(), np.asarray(want.vel))


# ---------------------------------------------------------------------------
# The plain force sweeps with a moving wall vs JAX's
# ---------------------------------------------------------------------------

def _moving(walls, grid):
    return JB.move_boundary(walls, grid, velocity=jnp.asarray(
        WALL_VEL, jnp.float32))


def _zero_pair(q_ref, src_ref, valid, pv, *, kernel_set):
    return jnp.zeros((q_ref.shape[0], 4), q_ref.dtype)


def _friction_only(cfg, ctx, pctx, jq, jsrc, pq, psrc, j_pair, p_pair,
                   **kw):
    """The wall rows of a force sweep alone, with ``kw`` dropping all but
    the friction: JAX's ``j_pair(moving=True)`` in ``generic_sweep`` (a
    zero fluid pair) against the port's ``p_pair(moving=True)`` over the
    same wall ranges, max|Δ| ≤ 1e-5·max|ref| per column. Returns
    max|moving − static| / max|moving| of the port's."""
    from nereus_tpu_torch.ops.neighbors import neighbor_sweep_plain
    want = PS.generic_sweep(cfg, _zero_pair, jq, jsrc, ctx.anchors,
                            ctx.pvec, ctx.gsize, out_width=4,
                            pair_fn_b=j_pair,
                            pair_b_kw=dict(moving=True, **kw),
                            n_rows=ctx.n_rows, interpret=True)
    walls_only = (pctx.seg_start.clone(), pctx.seg_end.clone())
    walls_only[1][:9] = walls_only[0][:9]

    def run(moving):
        def pair_b(qq, ss):
            return p_pair(qq, ss, pctx.pvec,
                          kernel_set=pt.KernelSet[cfg.kernel_set.name],
                          moving=moving, **kw)
        return neighbor_sweep_plain(
            lambda qq, ss: qq.new_zeros((qq.shape[0], 3)), pq, psrc,
            *walls_only, 3, pair_fn_b=pair_b)
    got = run(True)
    assert_columns_close(got.numpy(), np.asarray(want)[:pctx.c, :3], 1e-5,
                         "wall friction")
    return float((run(False) - got).abs().max() / got.abs().max())


def test_force_sweep_moving_matches_jax(exact_reciprocal):
    """The fused force sweep with ``moving_boundary=True`` on the same
    sorted operands as JAX's; the static sweep differs from it."""
    cfg, params, state, grid, walls = _scene("wcsph")
    bd = _moving(walls, grid)
    ctx = build_pallas_ctx(state, params, grid, cfg, bd)
    c = ctx.c
    vel = (ctx.vx, ctx.vy, ctx.vz)
    src_d = ctx.pack(vel=vel, slot6=jnp.full((c,), 1.0, ctx.dtype)
                     * params.particle_mass)
    dens = PS.density_sweep(cfg, ctx.queries(width=4), src_d, ctx.anchors,
                            ctx.pvec, ctx.gsize, n_rows=ctx.n_rows,
                            interpret=True)
    dens = jnp.where(jnp.arange(ctx.cb) < c, dens, 0.0)
    ds = jnp.maximum(dens, 1e-12)
    pd2 = jt.tait_pressure(dens, params) / (ds * ds)
    want = PS.fluid_force_sweep(
        cfg, ctx.queries(*vel, dens, pd2), ctx.update_rows(src_d, 6, [dens]),
        ctx.anchors, ctx.pvec, ctx.gsize, n_rows=ctx.n_rows,
        moving_boundary=True, interpret=True)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, bd)
    pctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert pctx.moving_boundary and pctx.seg_start.shape[0] == 18
    d = torch.from_numpy(np.asarray(dens)[:c].copy())
    dsp = d.clamp(min=1e-12)
    pvel = (pctx.vx, pctx.vy, pctx.vz)
    args = pctx.force_operands(pvel, d,
                               pt.tait_pressure(d, pparams) / (dsp * dsp))
    got = SP.fluid_force_sweep(pcfg, *args, moving_boundary=True)
    assert_columns_close(got.numpy(), np.asarray(want)[:c], 1e-5, "force")
    # the friction alone (~1e-10 of the wall force at these parameters)
    fric = _friction_only(cfg, ctx, pctx, ctx.queries(*vel, dens, pd2),
                          ctx.update_rows(src_d, 6, [dens]), args[0],
                          args[1], PS.boundary_force_pair,
                          SP.boundary_force_pair, include_adhesion=False,
                          include_pressure=False)
    assert fric > 0.1


def test_multiphase_force_sweep_moving_matches_jax(exact_reciprocal,
                                                   contact):
    """The multiphase force sweep with ``moving_boundary=True`` against
    ``generic_sweep`` with ``multiphase_boundary_pair(moving=True)`` on
    JAX's own operand columns, on ``test_torch_multiphase.py``'s settled
    two-phase tank in wall contact; its friction alone too."""
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas",
                       surface_tension_model=jt.SurfaceTensionModel.NONE)
    bd = _moving(walls, grid)
    ctx = build_pallas_ctx(state, params, grid, cfg, bd)
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dout = PS.generic_sweep(cfg, PS.multiphase_density_pair,
                            ctx.queries(width=4), ctx.pack(vel=vel), *geo,
                            out_width=4,
                            pair_fn_b=PS.multiphase_density_bpair,
                            n_rows=ctx.n_rows, interpret=True)
    mass, rho0 = ctx.mass, ctx.rho0
    delta = dout[:, 0]
    dens = mass * delta + (rho0 / params.rest_density) * dout[:, 1]
    pres = jt.tait_pressure(dens, params, rho0)
    vol = 1.0 / jnp.maximum(delta, 1e-12)
    qcols = [*vel, pres * vol * vol, 1.0 / mass, mass,
             1.0 / jnp.maximum(dens, 1e-12)]
    wcols = [*vel, vol, pres * vol * vol]
    want = PS.generic_sweep(cfg, PS.multiphase_force_pair,
                            ctx.queries(*qcols),
                            ctx.pack_wide(wcols, rows=16), *geo, out_width=4,
                            pair_fn_b=PS.multiphase_boundary_pair,
                            pair_b_kw={"moving": True}, st_becker=False,
                            n_rows=ctx.n_rows, interpret=True)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, bd)
    pctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    qc = torch.from_numpy(np.asarray(jnp.stack(qcols, 1))[:n].copy())
    wc = torch.from_numpy(np.asarray(jnp.stack(wcols, 1))[:n].copy())
    assert torch.equal(qc[:, 0], pctx.vx) and torch.equal(qc[:, 5],
                                                          pctx.mass)
    # laid out as the port's one matrix, its first n rows the queries
    src = pctx.pack_wide([*qc[:, :3].unbind(1), wc[:, 3], wc[:, 4],
                          pctx.rho0, *qc[:, 4:7].unbind(1)])
    args = (src[:n], src, pctx.seg_start, pctx.seg_end, pctx.pvec)
    got = SP.multiphase_force_sweep(pcfg, *args, moving_boundary=True)
    assert_columns_close(got.numpy(), np.asarray(want)[:n, :3], 1e-5,
                         "multiphase force")
    # the friction alone: 1/m_i (JAX's query column 7, the port's slot
    # MP_INV_M) at 0 drops the penalty
    jq = ctx.queries(*qcols).at[:, 7].set(0.0)
    pq = args[0].clone()
    pq[:, SP.MP_INV_M] = 0.0
    fric = _friction_only(cfg, ctx, pctx, jq, ctx.pack_wide(wcols, rows=16),
                          pq, args[1], PS.multiphase_boundary_pair,
                          SP.multiphase_boundary_pair)
    assert fric > 0.1


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", SOLVERS)
def test_moving_boundary_matches_jax(exact_reciprocal, solver):
    """Two steps with the moving wall against JAX's Pallas step: positions
    atol 2e-5, velocities atol 2e-3, the same iteration counts; for the
    solvers that read the wall velocity beyond the friction, the wall at
    rest gives another result."""
    cfg, params, state, grid, walls = _scene(solver)
    bd = _moving(walls, grid)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, bd)
    assert pb.vel is not None
    n = int(state.num_active)
    step = _jax_step(solver)
    pstep = _port_step(solver)
    js, ps = state, pstate
    for it in range(2):
        js, jd = step(js, bd)
        ps, pd = pstep(ps, pparams, pg, pcfg, pb)
        assert int(jd.seg_overflow) == 0
        assert int(pd.solver_iters) == int(jd.solver_iters), (solver, it)
        np.testing.assert_allclose(ps.pos.numpy()[:n],
                                   np.asarray(js.pos)[:n], rtol=0,
                                   atol=2e-5, err_msg=f"{solver} {it}")
        np.testing.assert_allclose(ps.vel.numpy()[:n],
                                   np.asarray(js.vel)[:n], rtol=0,
                                   atol=2e-3, err_msg=f"{solver} {it}")
    if solver in VELOCITY_READERS:
        static, _ = pstep(pstate, pparams, pg, pcfg,
                          dataclasses.replace(pb, vel=None))
        first, _ = pstep(pstate, pparams, pg, pcfg, pb)
        assert float((static.vel - first.vel).abs().max()) > 1e-4


def test_zero_velocity_matches_static():
    """A wall set at velocity 0 runs the moving path and reproduces the
    static step exactly."""
    cfg, params, state, grid, walls = _scene("wcsph")
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    still = PB.move_boundary(pb, pg, velocity=torch.zeros(3))
    assert still.vel is not None and pb.vel is None
    s1, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
    s2, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, still)
    assert torch.equal(s1.pos, s2.pos) and torch.equal(s1.vel, s2.vel)


def test_rotating_boundary_matches_jax(exact_reciprocal):
    """A rotated, spinning wall set (per-sample velocities ω × r) against
    JAX's DFSPH step: positions atol 2e-5, velocities atol 2e-3."""
    cfg, params, state, grid, walls = _scene("dfsph")
    center = np.asarray(walls.pos).mean(axis=0)
    R = JB.rotation_matrix((0.0, 1.0, 0.0), jnp.float32(0.12))
    bd = JB.move_boundary(walls, grid, rotation=R, center=center,
                          omega=jnp.asarray([0.0, 2.0, 0.0]))
    pcfg, pparams, pstate, pg, pb0 = to_port(cfg, params, state, grid,
                                             walls)
    pb = PB.move_boundary(pb0, pg, rotation=torch.from_numpy(np.asarray(R)),
                          center=center, omega=(0.0, 2.0, 0.0))
    np.testing.assert_array_equal(pb.sorted_hash.numpy(),
                                  np.asarray(bd.sorted_hash))
    js, jd = _jax_step("dfsph")(state, bd)
    ps, pd = pt.dfsph_step(pstate, pparams, pg, pcfg, pb)
    n = int(state.num_active)
    assert int(jd.seg_overflow) == 0
    np.testing.assert_allclose(ps.pos.numpy()[:n], np.asarray(js.pos)[:n],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(ps.vel.numpy()[:n], np.asarray(js.vel)[:n],
                               rtol=0, atol=2e-3)


def test_piston_pushes_fluid():
    """A wall advancing at 3 m/s into a fluid block at zero gravity moves
    it along +x (the port alone, ``move_boundary`` every step from the
    t = 0 set)."""
    cfg = pt.SimConfig()
    params = pt.dfsph_params(dt=5e-4, gravity=(0.0, 0.0, 0.0), device="cpu")
    h = float(params.interaction_radius)
    spacing = 0.8 * h
    params = pt.calibrate_mass(params, cfg, spacing=spacing)
    pos = pscene.particle_cube((0.2, 0.3, 0.25), (0.2, 0.3, 0.3), spacing)
    lo, hi = np.zeros(3), np.array((0.5, 0.6, 0.5))
    grid = pt.fit_grid(lo - h - 0.25, hi + h + 0.25, h, device="cpu")
    bd0 = PB.box_boundary(grid, lo, hi, float(params.particle_radius),
                          params, device="cpu")
    state = pt.make_fluid_state(pos, device="cpu")
    vpush = 3.0
    t = 0.0
    for _ in range(60):
        bd = PB.move_boundary(bd0, grid, offset=(vpush * t, 0.0, 0.0),
                              velocity=(vpush, 0.0, 0.0))
        state, diag = pt.dfsph_step(state, params, grid, cfg, bd)
        t += float(params.dt)
    v = state.vel.numpy()
    assert np.isfinite(state.pos.numpy()).all() and np.isfinite(v).all()
    assert float(v[:, 0].mean()) > 0.05, float(v[:, 0].mean())


def test_moving_force_operands_carry_wall_velocity():
    """The step's own operands put the wall velocity in slots 3-5 of every
    8-wide and wide boundary row (JAX's ``_bcols``); the 4-wide pack stays
    position and ψ."""
    cfg, params, state, grid, walls = _scene("wcsph_mp")
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            _moving(walls, grid))
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    c = ctx.c
    want = torch.tensor(WALL_VEL).expand(pb.num_boundaries, 3)
    one = torch.ones(())
    assert torch.equal(ctx.pack((ctx.vx, ctx.vy, ctx.vz), one)[c:, 3:6],
                       want)
    dargs = wcsph_cuda.multiphase_density_operands(ctx)
    dout = SP.multiphase_density_sweep(pcfg, *dargs)
    fargs, _, _ = wcsph_cuda.multiphase_force_operands(ctx, pparams, dout)
    assert torch.equal(fargs[1][c:, 3:6], want)
    assert dargs[1].shape[1] == 4
    assert torch.equal(dargs[1][c:, 3], pb.psi)
