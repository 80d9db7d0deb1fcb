"""The port's implicit viscosity (Weiler 2018) and the force sweep without
viscosity vs the JAX package (CPU, plain sweeps).

* The force sweep with ``include_viscosity=False`` (no Müller viscosity,
  no wall friction), pressure on and off, and the viscous-Laplacian sweep,
  against interpret-mode ``fluid_force_sweep`` / ``generic_sweep`` with
  ``visc_laplacian_pair`` on the same sorted operands, both kernel sets,
  walls in support: max|Δ| ≤ 1e-5·max|ref| per output column (float32
  sums in another order; the JAX side's approximate reciprocal replaced
  by the exact one, ``exact_reciprocal``).
* ``wcsph_step`` and ``dfsph_step`` with ``viscosity_model="implicit"``
  against the JAX Pallas steps (interpret) on the shear scene of
  ``tests/test_viscosity.py::test_implicit_viscosity_engines_match``, two
  steps: positions rtol 2e-4 / atol 2e-6, velocities rtol 2e-3 / atol
  2e-4, ``solver_iters`` equal.
* A mirror of ``test_viscosity.py::test_cg_solves_the_viscous_system``,
  also held against the JAX segment oracle's solve; the CG loop's host
  reads and launches; IISPH's refusal, which the JAX IISPH step does not
  have (it runs the explicit term).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.boundary import box_boundary
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass as j_calibrate_mass
from nereus_tpu.scene import particle_cube
from nereus_tpu.solvers import common as jcommon
from nereus_tpu.solvers.pallas_common import build_pallas_ctx
from nereus_tpu.solvers.viscosity import implicit_viscosity_oracle

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import viscosity
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import (assert_columns_close, exact_reciprocal, jax_scene,
                          to_port)

torch.set_num_threads(1)

KERNEL_SETS = [jt.KernelSet.MULLER, jt.KernelSet.MONAGHAN]


# ---------------------------------------------------------------------------
# The two sweeps against the JAX sweeps
# ---------------------------------------------------------------------------

def _jax_sweeps(cfg, params, state, grid, boundary):
    """``(dens, force, lap)``: the density, the force sweep without
    viscosity with pressure on and off (``{include_pressure: (N, 3)}``)
    and the Laplacian of the state's own velocities, as
    ``wcsph_step_pallas`` / ``implicit_viscosity_pallas`` run them."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    c = ctx.c
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm = params.particle_mass
    src_d = ctx.pack(vel=vel, slot6=jnp.full((c,), 1.0, ctx.dtype) * pm)
    dens = PS.density_sweep(cfg, ctx.queries(width=4), src_d, *geo,
                            n_rows=ctx.n_rows, interpret=True)
    ds = jnp.maximum(dens, 1e-12)
    pd2 = jt.tait_pressure(dens, params) / (ds * ds)
    force = {p: PS.fluid_force_sweep(
        cfg, ctx.queries(*vel, dens, pd2), ctx.update_rows(src_d, 6, [dens]),
        *geo, n_rows=ctx.n_rows, include_pressure=p,
        include_viscosity=False, interpret=True)[:c] for p in (True, False)}
    lap = PS.generic_sweep(
        cfg, PS.visc_laplacian_pair, ctx.queries(*vel, dens, width=8),
        ctx.pack(vel=vel, slot6=(pm / ds)[:c]), *geo, out_width=4,
        n_rows=ctx.n_rows, interpret=True, boundary=False,
        pair_fn_b=PS.visc_laplacian_pair, pair_b_kw=dict(boundary=True))
    return dens[:c], force, lap[:c, :3]


@functools.lru_cache(maxsize=None)
def _sweep_case(kernel_set):
    """The scene (floor 0.04 under the bottom layer: the boundary rows are
    live) and its JAX sweeps, once per kernel set; call under
    ``exact_reciprocal``."""
    scene = jax_scene(True, kernel_set, jt.SurfaceTensionModel.BECKER,
                      floor=-0.115)
    cfg, params, state, grid, boundary = scene
    out = jax.jit(lambda s: _jax_sweeps(cfg, params, s, grid, boundary))(
        state)
    return scene, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("include_pressure", [True, False])
@pytest.mark.parametrize("kernel_set", KERNEL_SETS)
def test_sweeps_match_jax(exact_reciprocal, kernel_set, include_pressure):
    scene, (dens, forces, lap) = _sweep_case(kernel_set)
    force = forces[include_pressure]
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    vel = (ctx.vx, ctx.vy, ctx.vz)
    d = torch.from_numpy(np.asarray(dens).copy())
    ds = d.clamp(min=1e-12)
    pd2 = pt.tait_pressure(d, pparams) / (ds * ds)
    fargs = ctx.force_operands(vel, d, pd2)
    got = SP.fluid_force_sweep(pcfg, *fargs, include_pressure=include_pressure,
                               include_viscosity=False)
    assert_columns_close(got.numpy(), np.asarray(force), 1e-5, "force")
    with_visc = SP.fluid_force_sweep(pcfg, *fargs,
                                     include_pressure=include_pressure)
    assert not torch.equal(with_visc, got)

    largs = viscosity.laplacian_operands(ctx, pparams, d)(
        torch.stack(vel, dim=1))
    got = SP.visc_laplacian_sweep(pcfg, *largs)
    assert_columns_close(got.numpy(), np.asarray(lap), 1e-5, "laplacian")
    # the wall rows are live
    fluid_only = SP.visc_laplacian_sweep(pcfg, *largs[:2],
                                         ctx.seg_start[:9], ctx.seg_end[:9],
                                         ctx.pvec)
    assert not torch.equal(fluid_only, got)


# ---------------------------------------------------------------------------
# The steps against the JAX Pallas steps
# ---------------------------------------------------------------------------

def _shear_scene():
    """``test_viscosity.py::test_implicit_viscosity_engines_match``'s scene:
    DFSPH parameters at ν = 0.5, particle radius h/4 (a 0.5·h lattice, ~26
    in-radius neighbors), a 9³ cube in a walled box with a sinusoidal
    shear velocity field."""
    cfg = jt.SimConfig(engine="pallas", viscosity_model="implicit")
    params = j_calibrate_mass(jt.dfsph_params(viscosity=0.5, dt=5e-4,
                                              particle_radius=0.0537 / 4),
                              cfg)
    h = float(params.interaction_radius)
    sp = 2 * float(params.particle_radius)
    side = 9 * sp
    pos = particle_cube((0.25, 0.3, 0.25), (side,) * 3, sp)
    lo, hi = np.zeros(3), np.array((0.5, 0.8, 0.5))
    grid = jt.fit_grid(lo - h, hi + h, h)
    boundary = box_boundary(grid, lo, hi, float(params.particle_radius),
                            params)
    vel = np.zeros_like(pos)
    vel[:, 0] = np.sin(2.0 * np.pi * (pos[:, 1] - 0.3) / side)
    return cfg, params, jt.make_fluid_state(pos, vel), grid, boundary


@pytest.mark.parametrize("solver", ["wcsph", "dfsph"])
def test_implicit_viscosity_steps_match_jax(exact_reciprocal, solver):
    """Two steps: the second from JAX's state after the first."""
    cfg, params, state, grid, boundary = _shear_scene()
    n = int(state.num_active)
    jstep = jax.jit(lambda s: getattr(jt, f"{solver}_step")(
        s, params, grid, cfg, boundary))
    pstep = getattr(pt, f"{solver}_step")
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                boundary)
        s_port, d_port = pstep(pstate, pparams, pg, pcfg, pb)
        s_ref, d_ref = jstep(state)
        msg = f"{solver} step {step}"
        assert int(d_ref.seg_overflow) == 0, msg
        assert int(d_port.solver_iters) == int(d_ref.solver_iters), msg
        np.testing.assert_allclose(s_port.pos.numpy()[:n],
                                   np.asarray(s_ref.pos)[:n], rtol=2e-4,
                                   atol=2e-6, err_msg=msg)
        np.testing.assert_allclose(s_port.vel.numpy()[:n],
                                   np.asarray(s_ref.vel)[:n], rtol=2e-3,
                                   atol=2e-4, err_msg=msg)
        state = s_ref
    # the solve acts: the explicit step from the same state differs
    s_exp, _ = pstep(pstate, pparams, pg,
                     dataclasses.replace(pcfg, viscosity_model="explicit"),
                     pb)
    assert float((s_exp.vel - s_port.vel).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# The CG solve
# ---------------------------------------------------------------------------

def _blob(n=500, seed=2, viscosity=0.05):
    """``test_viscosity.py``'s random blob, no gravity, no boundary."""
    params = jt.dfsph_params(viscosity=viscosity, gravity=(0.0, 0.0, 0.0))
    h = float(params.interaction_radius)
    rng = np.random.RandomState(seed)
    side = h * (n / 2.0) ** (1 / 3)
    pos = rng.uniform(0.0, side, (n, 3))
    vel = rng.uniform(-1.0, 1.0, (n, 3))
    grid = jt.fit_grid(pos.min(0) - h, pos.max(0) + h, h)
    return params, grid, jt.make_fluid_state(pos, vel)


def _port_solve(params, grid, state, cfg, v=None):
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, None)
    dens = SP.density_sweep(pcfg, *ctx.density_operands(
        pparams.particle_mass))
    v_star = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1) if v is None else v
    return ctx, pparams, pcfg, dens, viscosity.implicit_viscosity(
        ctx, pparams, pcfg, dens, v_star)


def test_cg_solves_the_viscous_system():
    """``test_viscosity.py::test_cg_solves_the_viscous_system`` on the
    port: the solve reaches the configured relative residual, solving again
    from its result barely moves it, and it agrees with the JAX segment
    oracle's solve (the same iteration count)."""
    cfg = jt.SimConfig(engine="segments", viscosity_model="implicit")
    params, grid, state = _blob()
    ctx, pparams, pcfg, dens, (v_sol, iters, res) = _port_solve(
        params, grid, state, cfg)
    assert int(iters) > 0
    assert float(res) < pcfg.visc_cg_tol
    v_star = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    v2, _, _ = viscosity.implicit_viscosity(ctx, pparams, pcfg, dens, v_sol)
    assert float((v2 - v_sol).abs().max()) < \
        2.0 * float((v_sol - v_star).abs().max())

    jctx = jcommon.build_ctx(state, grid, cfg, None)
    jdens = jcommon.compute_density(jctx, params, cfg, None)
    jv, jiters, jres = implicit_viscosity_oracle(jctx, params, cfg, None,
                                                 jdens, jctx.state.vel)
    assert int(iters) == int(jiters)
    np.testing.assert_allclose(v_sol.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(res), float(jres), rtol=0.05)


def test_cg_converged_at_its_warm_start_commits_nothing(monkeypatch):
    """A uniform velocity field has a zero Laplacian, so the warm start
    v* solves the system: the loop ends with 0 iterations and x = v* bit
    for bit, though its first launched iteration ran. The Laplacian runs
    once for r0 and once per launched iteration."""
    cfg = jt.SimConfig(engine="segments", viscosity_model="implicit")
    params, grid, state = _blob(n=200)
    calls = []
    sweep = SP.visc_laplacian_sweep

    def counted(*a, **k):
        calls.append(1)
        return sweep(*a, **k)
    monkeypatch.setattr(SP, "visc_laplacian_sweep", counted)
    viscosity.LOOP.reset()
    v = torch.tensor([[0.3, -1.0, 0.5]]).expand(state.capacity, 3)
    _, _, _, _, (x, iters, res) = _port_solve(params, grid, state, cfg,
                                              v.contiguous())
    assert int(iters) == 0 and float(res) == 0.0
    assert torch.equal(x, v)
    assert viscosity.LOOP.launched == viscosity.SYNC_EVERY
    assert len(calls) == 1 + viscosity.LOOP.launched


@pytest.mark.parametrize("sync_every", [1, 2, 3])
def test_cg_loop_syncs_once_per_k_iterations(monkeypatch, sync_every):
    """The CG loop reads its condition after every SYNC_EVERY-th launched
    iteration, launches at most SYNC_EVERY − 1 past its converged count,
    and freezes the carry in those: the result does not depend on
    SYNC_EVERY."""
    cfg = jt.SimConfig(engine="segments", viscosity_model="implicit")
    params, grid, state = _blob(n=300)
    monkeypatch.setattr(viscosity, "SYNC_EVERY", 1)
    *_, (x1, it1, res1) = _port_solve(params, grid, state, cfg)
    monkeypatch.setattr(viscosity, "SYNC_EVERY", sync_every)
    viscosity.LOOP.reset()
    *_, (xk, itk, resk) = _port_solve(params, grid, state, cfg)
    assert int(itk) == int(it1) > 1
    assert torch.equal(xk, x1) and torch.equal(resk, res1)
    loop = viscosity.LOOP
    assert int(itk) <= loop.launched < int(itk) + sync_every
    assert loop.syncs == loop.launched // sync_every
    assert loop.launched % sync_every == 0
    assert bool(loop.last.err <= loop.last.tol)


# ---------------------------------------------------------------------------
# IISPH: the JAX step runs the explicit term; the port refuses
# ---------------------------------------------------------------------------

def test_iisph_refuses_implicit_viscosity():
    """JAX's IISPH step has no implicit viscosity stage: with
    ``viscosity_model="implicit"`` its Pallas step (``iisph_pallas.py``,
    the port's counterpart) traces to the same program as the explicit
    one, so it runs the explicit Müller term. The port refuses and says
    why."""
    cfg, params, state, grid, boundary = jax_scene(True, floor=-0.115)
    params = jt.iisph_params(dt=5e-4)
    explicit = dataclasses.replace(cfg, engine="pallas")
    implicit = dataclasses.replace(explicit, viscosity_model="implicit")
    exp, imp = (str(jax.make_jaxpr(lambda s, c=c: jt.iisph_step(
        s, params, grid, c, boundary))(state)) for c in (explicit, implicit))
    assert imp == exp
    pcfg, pparams, pstate, pg, pb = to_port(implicit, params, state, grid,
                                            boundary)
    with pytest.raises(NotImplementedError,
                       match="IISPH has no implicit viscosity stage"):
        pt.iisph_step(pstate, pparams, pg, pcfg, pb)


def test_config_carries_the_viscosity_fields():
    """``convert.config_from_jax_fields`` carries the implicit viscosity
    solve's three fields."""
    from nereus_tpu_torch import convert
    cfg = convert.config_from_jax_fields(jt.SimConfig(
        viscosity_model="implicit", visc_cg_tol=3e-5, visc_cg_max_iters=37))
    assert (cfg.viscosity_model, cfg.visc_cg_tol, cfg.visc_cg_max_iters) \
        == ("implicit", 3e-5, 37)
