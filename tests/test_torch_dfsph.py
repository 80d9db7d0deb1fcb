"""The port's single-phase DFSPH step and its two sweeps vs the JAX
package (CPU, plain sweeps).

* The α and Dρ/Dt plain sweeps against interpret-mode ``generic_sweep``
  with ``alpha_pair`` / ``drho_pair`` on the same sorted operands:
  max|Δ| ≤ 1e-5·max|ref| per output column (float32 sums in another
  order), the boundary rows live. The density and α in one sweep of the
  density's matrix (``density_alpha_sweep``, and its sums form) against
  ``density_sweep``, ``generic_sweep(alpha_pair)`` and
  ``dfsph_step_pallas``'s α, with and without walls, to the same
  tolerance.
* ``dfsph_step`` against ``dfsph_step_pallas`` (interpret) and the jnp
  segment step over two steps, with and without boundary, with the
  tolerances of ``tests/test_dfsph.py::test_dfsph_pallas_matches_oracle``
  (positions rtol 2e-4 / atol 2e-6, velocities rtol 2e-3 / atol 2e-4) and
  equal iteration counts. κ is not compared bit for bit: near rest it
  cancels as the IISPH pressure does.
* A mirror of ``tests/test_dfsph.py::test_apply_kappa_conserves_momentum``,
  the refusals, and both loops' host reads once per SYNC_EVERY iterations.
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
from nereus_tpu.solvers.dfsph_pallas import dfsph_step_pallas
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import dfsph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import assert_columns_close, exact_reciprocal, to_port

torch.set_num_threads(1)


def _dam_scene(with_boundary, kernel_set=jt.KernelSet.MULLER, squeeze=1.02):
    """The 216-particle dam-break of ``tests/test_pallas_implicit.py``
    (spacing h − 0.005, dt 5e-4) with DFSPH parameters, the mass
    calibrated to ``squeeze``× the spacing (the block starts ~6 %
    over-dense, so the density loop runs past its minimum) and seeded
    velocities in ±0.5 m/s. With boundary, the floor stands 0.05 under
    the bottom layer, inside the support."""
    cfg = jt.SimConfig(seg_window=48, kernel_set=kernel_set)
    params = jt.dfsph_params(dt=5e-4)
    spacing = float(params.interaction_radius) - 0.005
    params = j_calibrate_mass(params, cfg, spacing=spacing * squeeze)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.25, 0.25, 0.25),
        cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.125 if with_boundary else -0.3, 0.0),
        box_max=(0.2, 0.7, 1.0), with_boundary=with_boundary,
        boundary_radius=0.04)
    pos = np.asarray(state.pos)
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    return cfg, params, jt.make_fluid_state(pos, vel.astype(np.float32)), \
        grid, boundary


# ---------------------------------------------------------------------------
# The α and Dρ/Dt sweeps against generic_sweep
# ---------------------------------------------------------------------------

def _jax_sweeps(cfg, params, state, grid, boundary):
    """``dfsph_step_pallas``'s α and Dρ/Dt sweeps on the state's own
    velocities."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    kw = dict(n_rows=ctx.n_rows, interpret=True)
    psi = jnp.full((ctx.c,), 1.0, ctx.dtype) * params.particle_mass
    al = PS.generic_sweep(cfg, PS.alpha_pair, ctx.queries(width=4),
                          ctx.pack(slot6=psi), *geo, out_width=4,
                          include_sq=True, pair_fn_b=PS.alpha_pair,
                          pair_b_kw=dict(include_sq=False), **kw)
    v = (ctx.vx, ctx.vy, ctx.vz)
    drho = PS.generic_sweep(cfg, PS.drho_pair, ctx.queries(*v, width=8),
                            ctx.pack(vel=v, slot6=psi), *geo, out_width=1,
                            pair_fn_b=PS.drho_pair, **kw)
    return al, drho[:, 0]


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_alpha_drho_sweeps_match_jax(kernel_set):
    scene = _dam_scene(True, kernel_set)
    cfg, params, state, grid, boundary = scene
    al, drho = jax.jit(lambda s: _jax_sweeps(cfg, params, s, grid,
                                             boundary))(state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    src = ctx.pack(vel, pparams.particle_mass)
    # α's sums read the density's one matrix x y z ψ (the step's operands)
    q4, src4, *_ = ctx.density_operands(pparams.particle_mass)
    got_al = SP.density_alpha_sums_sweep(pcfg, q4, src4, *rng)[:, 1:]
    got_drho = SP.drho_sweep(pcfg, ctx.queries(*vel, width=8), src, *rng)
    assert_columns_close(got_al.numpy(), np.asarray(al)[:n], 1e-5, "alpha")
    assert_columns_close(got_drho.numpy(), np.asarray(drho)[:n], 1e-5,
                         "drho")
    # the boundary rows add to the gradient sum, not to the square sum
    fluid_only = SP.density_alpha_sums_sweep(
        pcfg, q4, src4, ctx.seg_start[:9], ctx.seg_end[:9], ctx.pvec)[:, 1:]
    assert torch.equal(fluid_only[:, 3], got_al[:, 3])
    assert not torch.equal(fluid_only[:, 1], got_al[:, 1])


def _jax_density_alpha(cfg, params, state, grid, boundary):
    """``dfsph_step_pallas``'s density, α sums and α (lines 202-214)."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    kw = dict(n_rows=ctx.n_rows, interpret=True)
    q4 = ctx.queries(width=4)
    src = ctx.pack(slot6=jnp.full((ctx.c,), 1.0, ctx.dtype)
                   * params.particle_mass)
    dens = PS.density_sweep(cfg, q4, src, ctx.anchors, ctx.pvec, ctx.gsize,
                            **kw)
    al = PS.generic_sweep(cfg, PS.alpha_pair, q4, src, ctx.anchors,
                          ctx.pvec, ctx.gsize, out_width=4, include_sq=True,
                          pair_fn_b=PS.alpha_pair,
                          pair_b_kw=dict(include_sq=False), **kw)
    denom = al[:, 0] ** 2 + al[:, 1] ** 2 + al[:, 2] ** 2 + al[:, 3]
    return dens, al, dens / jnp.maximum(denom, 1e-6)


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_density_alpha_sweep_matches_jax(kernel_set, with_boundary):
    """The density and α in one sweep of the density's one matrix
    ``x y z ψ`` (the step's operands, the queries its first rows): (ρ, α)
    and the couplings' form (ρ, α's four sums), each column a contiguous
    plane, against JAX's density sweep, α sums and α; ρ equals the plain
    density sweep's bit for bit and α its ``alpha_of`` of the sums."""
    scene = _dam_scene(with_boundary, kernel_set)
    cfg, params, state, grid, boundary = scene
    dens, al, alpha = jax.jit(lambda s: _jax_density_alpha(
        cfg, params, s, grid, boundary))(state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == (18 if with_boundary else 9)
    args = ctx.density_operands(pparams.particle_mass)
    assert args[0].data_ptr() == args[1].data_ptr()
    got = SP.density_alpha_sweep(pcfg, *args)
    sums = SP.density_alpha_sums_sweep(pcfg, *args)
    assert got.shape == (n, 2) and sums.shape == (n, 5)
    assert got.t().is_contiguous() and sums.t().is_contiguous()
    want = np.stack([np.asarray(dens)[:n], np.asarray(alpha)[:n]], 1)
    assert_columns_close(got.numpy(), want, 1e-5, "rho, alpha")
    assert_columns_close(sums.numpy()[:, 1:], np.asarray(al)[:n], 1e-5,
                         "alpha sums")
    assert torch.equal(got[:, 0], SP.density_sweep(pcfg, *args))
    assert torch.equal(sums[:, 0], got[:, 0])
    assert torch.equal(got, SP.alpha_of(sums))
    assert float(got[:, 1].min()) > 0.0


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_one_matrix_drho_operands_match_jax(kernel_set):
    """``KappaSweeps.drho_operands``: one (C + Mb, 8) matrix, its first C
    rows the queries (a view: the velocities are written once per call),
    the wall rows as the step packs them; through the plain twin it gives
    JAX's ``generic_sweep`` with ``drho_pair`` and walls at the tolerance
    of ``test_alpha_drho_sweeps_match_jax``, after a call at other
    velocities has written the matrix first."""
    scene = _dam_scene(True, kernel_set)
    cfg, params, state, grid, boundary = scene
    _, drho = jax.jit(lambda s: _jax_sweeps(cfg, params, s, grid,
                                            boundary))(state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dens = SP.density_sweep(pcfg, *ctx.density_operands(
        pparams.particle_mass))
    sweeps = dfsph_cuda.KappaSweeps(ctx, pparams, pcfg, dens)
    first = SP.drho_sweep(pcfg, *sweeps.drho_operands(-vel))
    q, src, s, e, pv = sweeps.drho_operands(vel)
    assert src.shape == (ctx.c + pb.num_boundaries, 8)
    assert q.data_ptr() == src.data_ptr() and q.shape == (ctx.c, 8)
    assert q.is_contiguous() and torch.equal(q, src[:ctx.c])
    assert torch.equal(src[ctx.c:], ctx.b_src)
    assert torch.equal(src[:ctx.c, 3:6], vel)
    got = SP.drho_sweep(pcfg, q, src, s, e, pv)
    assert s.shape[0] == 18 and not torch.equal(first, got)
    assert_columns_close(got.numpy()[:, None], np.asarray(drho)[:n, None],
                         1e-5, "drho")
    assert torch.equal(got, sweeps.drho(vel))


# ---------------------------------------------------------------------------
# The step against dfsph_step_pallas and the segment step
# ---------------------------------------------------------------------------

def _compare(s_port, d_port, s_ref, d_ref, n, name):
    """Both steps return hash-sorted state in the same stable order."""
    assert int(d_port.solver_iters) == int(d_ref.solver_iters), name
    np.testing.assert_allclose(s_port.pos.numpy()[:n],
                               np.asarray(s_ref.pos)[:n], rtol=2e-4,
                               atol=2e-6, err_msg=name)
    np.testing.assert_allclose(s_port.vel.numpy()[:n],
                               np.asarray(s_ref.vel)[:n], rtol=2e-3,
                               atol=2e-4, err_msg=name)


@pytest.mark.parametrize("with_boundary", [False, True])
def test_dfsph_step_matches_jax(exact_reciprocal, with_boundary):
    """Two steps: the first from zero κ (the warm start applies 0), the
    second from JAX's first-step state, warm-started from its κ."""
    cfg, params, state, grid, boundary = _dam_scene(with_boundary)
    n = int(state.num_active)
    steps = {
        "pallas": jax.jit(lambda s: dfsph_step_pallas(
            s, params, grid, cfg, boundary)),
        "segments": jax.jit(lambda s: jt.dfsph_step(
            s, params, grid, cfg, boundary)),
    }
    iters = []
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                boundary)
        s_port, d_port = pt.dfsph_step(pstate, pparams, pg, pcfg, pb)
        refs = {name: fn(state) for name, fn in steps.items()}
        for name, (s_ref, d_ref) in refs.items():
            assert int(d_ref.seg_overflow) == 0, name
            _compare(s_port, d_port, s_ref, d_ref, n, f"{name} step {step}")
        iters.append(int(d_port.solver_iters))
        state = refs["pallas"][0]
        assert float(jnp.max(state.pressure)) > 0.0
    assert iters[0] > pcfg.dfsph_min_iters + pcfg.dfsph_min_iters_v, iters


# ---------------------------------------------------------------------------
# Mirror of the JAX package's κ-correction test, refusals, the loops
# ---------------------------------------------------------------------------

def test_apply_kappa_conserves_momentum():
    """``test_dfsph.py::test_apply_kappa_conserves_momentum``: the fluid
    κ-gradient correction is pairwise antisymmetric, so one application
    leaves the total fluid momentum unchanged (no boundary)."""
    params = pt.dfsph_params(device="cpu")
    cfg = pt.SimConfig()
    h = float(params.interaction_radius)
    rng = np.random.RandomState(3)
    n = 300
    side = h * (n / 2.0) ** (1 / 3)
    pos = rng.uniform(0.0, side, (n, 3))
    state = pt.make_fluid_state(pos, rng.uniform(-0.5, 0.5, (n, 3)),
                                device="cpu")
    grid = pt.fit_grid(pos.min(0), pos.max(0), h, device="cpu")
    ctx = build_sweep_ctx(state, params, grid, cfg, None)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dens = SP.density_sweep(cfg, *ctx.density_operands(
        params.particle_mass))
    sweeps = dfsph_cuda.KappaSweeps(ctx, params, cfg, dens)
    kappa = torch.abs(ctx.px) + 0.5
    v0 = torch.stack(vel, 1)
    v1 = sweeps.apply_kappa(kappa, v0)
    p0 = v0.double().sum(0).numpy()
    p1 = v1.double().sum(0).numpy()
    assert float((v1 - v0).abs().max()) > 1e-3
    np.testing.assert_allclose(p1, p0, rtol=0, atol=5e-3 * max(
        1.0, float(np.abs(p0).max())))


def test_unported_options_raise():
    """Nothing the JAX step takes is refused any more: moving boundaries
    are ported (``test_torch_moving_boundary.py``), multiphase DFSPH and
    implicit viscosity too (``test_torch_dfsph_multiphase.py``,
    ``test_torch_viscosity.py``). A wall set at velocity 0, once refused,
    runs and reproduces the static step."""
    pcfg, pparams, pstate, pg, pb = to_port(*_dam_scene(True))
    s0, _ = pt.dfsph_step(pstate, pparams, pg, pcfg, pb)
    s1, _ = pt.dfsph_step(pstate, pparams, pg, pcfg,
                          dataclasses.replace(pb, vel=torch.zeros_like(pb.pos)))
    assert torch.equal(s0.pos, s1.pos) and torch.equal(s0.vel, s1.vel)


def _port_block():
    """An over-dense 216-particle block converging on its centre, built by
    the port alone: both loops run past their minimum at tol 0.2."""
    cfg = pt.SimConfig()
    params = pt.dfsph_params(dt=5e-4, device="cpu")
    spacing = float(params.interaction_radius) - 0.005
    params = pt.calibrate_mass(params, cfg, spacing=spacing * 1.02)
    state, grid, _ = pscene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=False, device="cpu")
    pos = state.pos.numpy()
    vel = -4.0 * (pos - pos.mean(axis=0))
    return cfg, params, pt.make_fluid_state(pos, vel, device="cpu"), grid


@pytest.mark.parametrize("sync_every", [1, 2, 3, 4])
def test_loops_sync_once_per_k_iterations(monkeypatch, sync_every):
    """Each loop reads its condition on the host after every
    SYNC_EVERY-th launched iteration from its minimum on, launches at most
    SYNC_EVERY − 1 iterations past its converged count, and freezes the
    carry in those: the result does not depend on SYNC_EVERY."""
    cfg, params, state, grid = _port_block()
    kw = dict(tol=0.2, tol_v=0.2)
    for name in ("SYNC_EVERY", "SYNC_EVERY_V"):
        monkeypatch.setattr(dfsph_cuda, name, 1)
    s_1, d_1 = pt.dfsph_step(state, params, grid, cfg, **kw)
    for name in ("SYNC_EVERY", "SYNC_EVERY_V"):
        monkeypatch.setattr(dfsph_cuda, name, sync_every)
    dfsph_cuda.LOOP.reset()
    dfsph_cuda.LOOP_V.reset()
    s_k, d_k = pt.dfsph_step(state, params, grid, cfg, **kw)
    assert int(d_k.solver_iters) == int(d_1.solver_iters)
    assert torch.equal(s_k.pressure, s_1.pressure)
    assert torch.equal(s_k.vel, s_1.vel)
    launched = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
    it = int(d_k.solver_iters)
    assert it <= launched < it + 2 * (sync_every - 1) + 1
    # each loop's last run: its own count, ended within its own tolerance
    assert int(dfsph_cuda.LOOP.last.it + dfsph_cuda.LOOP_V.last.it) == it
    assert torch.equal(dfsph_cuda.LOOP.last.err / params.rest_density,
                       d_k.mean_density_error)
    for loop, lo in ((dfsph_cuda.LOOP, cfg.dfsph_min_iters),
                     (dfsph_cuda.LOOP_V, cfg.dfsph_min_iters_v)):
        last = loop.last
        assert bool(last.err <= last.tol) or int(last.it) == last.max_iters
        assert int(last.it) <= loop.launched < int(last.it) + sync_every
        assert loop.launched > lo, (loop.launched, lo)
        checks = [m for m in range(1, loop.launched + 1)
                  if m >= lo and m % sync_every == 0]
        assert loop.syncs == len(checks)
        assert checks[-1] == loop.launched
