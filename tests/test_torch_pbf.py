"""The port's PBF step and its three sweeps vs the JAX package (CPU, plain
sweeps), on ``tests/test_pbf.py``'s settle scene.

* The λ, Δp, ω and N plain sweeps against interpret-mode
  ``generic_sweep`` with ``pbf_lambda_pair`` (``include_sq`` on the fluid
  rows, not on the wall rows; N on the fluid rows alone),
  ``pbf_dp_pair`` (``boundary`` False / True) and ``pbf_omega_pair``, on
  the same sorted operands: the cube resting on the floor and against two
  walls, the iterate displaced from x* by up to 0.1·h, seeded λ ≤ 0 and
  velocities, both kernel sets; max|Δ| ≤ 1e-5·max|ref| per output column
  (float32 sums in another order), no column all zero. The λ sweep
  returns (ρ, λ), held against JAX's sums put through
  ``pbf_pallas.py:71-75``'s formula here (λ within 1e-5·max|λ| plus its
  float32 resolution ``LAM_FLOOR``); Δp reads λ from the matrix. With
  ``pbf_scorr_k = 0`` the Δp sweep matches JAX's too, and differs from
  the one with scorr. λ is exactly 0 on a block under ρ₀ and negative on
  an over-dense one, as JAX's. The step's one operand matrix carries the
  iterate in its fluid rows and keeps its wall rows. ω's one matrix,
  built through planes, equals bit for bit the column stack it replaced.
* ``pbf_step`` against ``pbf_step_pallas`` (interpret) and the jnp segment
  step over three steps of ``_settle_scene(nside=7)``, without and with
  ``xsph_eps = 0.02, vorticity_eps = 0.01``, the port's own trajectory
  held at every step against both JAX trajectories in the same hash-sorted
  order: positions rtol 2e-4 / atol 2e-6, velocities rtol 2e-3 / atol
  2e-4, ``max_density`` rtol 1e-4 (``tests/test_pbf.py:56-62``) and λ
  (``pressure``) within 1e-4·max|λ|. The JAX trajectories run once, in a
  module fixture.
* A mirror of ``test_pbf.py::test_pbf_dam_settle``, ``solver_iters``, the
  multiphase refusal, a boundary velocity that changes nothing, the
  density at rest of the PBF lattices, and ``convert`` carrying
  ``pbf_params()`` across.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass as j_calibrate_mass
from nereus_tpu.params import pbf_params as j_pbf_params
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import pbf_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_pbf import _settle_scene
from torch_bridge import assert_columns_close, params_to_port, to_port

torch.set_num_threads(1)

EXTRAS = [{}, dict(xsph_eps=0.02, vorticity_eps=0.01)]


def _contact_scene(kernel_set=jt.KernelSet.MULLER, scorr_k=None):
    """``_settle_scene()`` (729 particles) with the cube moved onto the
    floor and against the x = 0 and z = 0 walls, 0.6 particle spacings
    off each: every wall row of the sweeps is live."""
    cfg, params, grid, boundary, state = _settle_scene()
    over = {"kernel_set": kernel_set}
    if scorr_k is not None:
        over["pbf_scorr_k"] = scorr_k
    cfg = dataclasses.replace(cfg, **over)
    params = j_calibrate_mass(j_pbf_params(dt=1e-3), cfg)
    pos = np.asarray(state.pos)
    gap = 0.6 * 2.0 * float(params.particle_radius)
    pos = pos - pos.min(axis=0) + np.array([gap, gap, gap], np.float32)
    state = jt.make_fluid_state(pos.astype(np.float32))
    return cfg, params, grid, boundary, state


def _sweep_inputs(c, h, seed=0):
    """Seeded, in hash-sorted order: the iterate's displacement from x*
    (up to 0.1·h per axis), λ ≤ 0 and velocities (±0.5 m/s)."""
    rng = np.random.default_rng(seed)
    disp = rng.uniform(-0.1 * h, 0.1 * h, (c, 3)).astype(np.float32)
    lam = -rng.uniform(0.0, 2e-4, c).astype(np.float32)
    vel = rng.uniform(-0.5, 0.5, (c, 3)).astype(np.float32)
    return disp, lam, vel


def _jax_sweeps(cfg, params, state, grid, boundary, disp, lam, vel):
    """``pbf_step_pallas``'s λ and Δp sweeps at the displaced iterate,
    its ω sweep and its N sweep (λ pair on the fluid plan) at x*, on the
    seeded operands (m/ρ from the λ sweep's ρ, ψ_N = m/ρ·|ω|)."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    c, cb = ctx.c, ctx.cb
    geo = (ctx.pvec, ctx.gsize)
    kw = dict(interpret=True)

    def pad(a):
        return jnp.zeros((cb,), ctx.dtype).at[:c].set(a)
    x = tuple(p + pad(disp[:, k]) for k, p in
              enumerate((ctx.px, ctx.py, ctx.pz)))
    zeros = jnp.zeros((cb,), ctx.dtype)
    xc = tuple(a[:c] for a in x)
    pm = jnp.full((c,), 1.0, ctx.dtype) * params.particle_mass
    al = PS.generic_sweep(cfg, PS.pbf_lambda_pair, ctx.queries(zeros, *x,
                                                               width=8),
                          ctx.pack(slot6=pm, pos_override=xc), ctx.anchors,
                          *geo, out_width=8, n_rows=ctx.n_rows,
                          include_sq=True, pair_fn_b=PS.pbf_lambda_pair,
                          pair_b_kw=dict(include_sq=False), **kw)
    lam_b = pad(lam)
    dp = PS.generic_sweep(cfg, PS.pbf_dp_pair, ctx.queries(lam_b, *x,
                                                           width=8),
                          ctx.pack(slot6=lam_b[:c], pos_override=xc),
                          ctx.anchors, *geo, out_width=4, n_rows=ctx.n_rows,
                          boundary=False, pair_fn_b=PS.pbf_dp_pair,
                          pair_b_kw=dict(boundary=True), **kw)
    v = tuple(pad(vel[:, k]) for k in range(3))
    mrho = params.particle_mass / jnp.maximum(al[:, 0], 1e-12)
    om = PS.generic_sweep(cfg, PS.pbf_omega_pair, ctx.queries(*v, width=8),
                          ctx.pack(vel=v, slot6=mrho[:c]), ctx.anchors_f,
                          *geo, out_width=4, n_rows=ctx.rows_local, **kw)
    psi_n = mrho * jnp.sqrt(om[:, 0] ** 2 + om[:, 1] ** 2 + om[:, 2] ** 2)
    x0 = (ctx.px, ctx.py, ctx.pz)
    al_n = PS.generic_sweep(cfg, PS.pbf_lambda_pair,
                            ctx.queries(zeros, *x0, width=8),
                            ctx.pack(slot6=psi_n[:c],
                                     pos_override=tuple(a[:c] for a in x0)),
                            ctx.anchors_f, *geo, out_width=8,
                            n_rows=ctx.rows_local, include_sq=False, **kw)
    return (al[:c, :5], dp[:c, :3], mrho[:c], om[:c, :3], psi_n[:c],
            al_n[:c, :4])


def _jax_lambda(al, params, cfg):
    """(ρ, λ) from JAX's λ sums (N, 5) by ``pbf_pallas.py:71-75``'s
    formula, in float32."""
    rd = params.rest_density
    dens = al[:, 0]
    comp = jnp.maximum(dens / rd - 1.0, 0.0)
    denom = (al[:, 1] ** 2 + al[:, 2] ** 2 + al[:, 3] ** 2
             + al[:, 4]) / (rd * rd)
    return np.stack([np.asarray(dens), np.asarray(-comp
                                                  / (denom + cfg.pbf_eps))],
                    axis=1)


def _assert_lambda_close(got, want, name):
    """(ρ, λ) against JAX's: ρ within 1e-5·max|ρ|, λ within
    1e-5·max|λ| plus its float32 resolution ``LAM_FLOOR``."""
    assert_columns_close(got[:, :1], want[:, :1], 1e-5, f"{name} rho")
    err = float(np.abs(got[:, 1] - want[:, 1]).max())
    assert err <= 1e-5 * float(np.abs(want[:, 1]).max()) + LAM_FLOOR, (
        name, err)


def _port_sweeps(scene, disp, lam, vel, mrho, psi_n):
    """The same four sweeps on the port's plain dispatchers, operands from
    the step's own operand functions."""
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    x = torch.stack([ctx.px, ctx.py, ctx.pz], 1) + torch.from_numpy(disp)
    lam_at, dp_at = pbf_cuda.pbf_operands(ctx, pparams.particle_mass)
    rl = SP.pbf_lambda_sweep(pcfg, *lam_at(x))
    dp = SP.pbf_dp_sweep(pcfg, *dp_at(torch.from_numpy(lam)))
    v = tuple(torch.from_numpy(vel[:, k].copy()) for k in range(3))
    om = SP.pbf_omega_sweep(pcfg, *pbf_cuda.omega_operands(
        ctx, v, torch.from_numpy(mrho.copy())))
    al_n = SP.pbf_grad_sweep(pcfg, *pbf_cuda.grad_operands(
        ctx, torch.from_numpy(psi_n.copy())))
    return rl, dp, om, al_n, ctx


def _scene_sweeps(kernel_set, scorr_k=None):
    """(JAX outputs, port outputs, port ctx) of the four sweeps."""
    scene = _contact_scene(kernel_set, scorr_k)
    cfg, params, grid, boundary, state = scene
    c = state.capacity
    disp, lam, vel = _sweep_inputs(c, float(params.interaction_radius))
    ref = jax.jit(lambda s: _jax_sweeps(cfg, params, s, grid, boundary,
                                        disp, lam, vel))(state)
    ref = [np.asarray(r) for r in ref]
    al, dp, om, al_n, ctx = _port_sweeps(
        (cfg, params, state, grid, boundary), disp, lam, vel, ref[2],
        ref[4])
    return ref, (al, dp, om, al_n), ctx


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_pbf_sweeps_match_jax(kernel_set):
    ref, (rl, dp, om, al_n), ctx = _scene_sweeps(kernel_set)
    j_al, j_dp, _, j_om, _, j_al_n = ref
    cfg = pt.SimConfig(kernel_set=pt.KernelSet[kernel_set.name])
    _assert_lambda_close(rl.numpy(), _jax_lambda(j_al, _contact_scene(
        kernel_set)[1], cfg), "lambda")
    if kernel_set == jt.KernelSet.MULLER:
        # under Monaghan kernels the cube sits under ρ₀ (its mass is
        # calibrated over the 2h support) and λ is 0:
        # test_lambda_epilogue_matches_jax squeezes it
        assert float(rl[:, 1].min()) < -1e3 * LAM_FLOOR
    assert_columns_close(dp.numpy(), j_dp, 1e-5, "dp")
    assert_columns_close(om.numpy(), j_om, 1e-5, "omega")
    assert_columns_close(al_n[:, :4].numpy(), j_al_n, 1e-5, "N")
    # λ is the formula of the sums; the walls add to ρ and Σψ∇W, not to
    # the square sum
    lam_at, _ = pbf_cuda.pbf_operands(ctx, ctx.pvec[SP.PV_PM])
    q, src, _, _, pv = lam_at(torch.stack([ctx.px, ctx.py, ctx.pz], 1))
    both = SP.pbf_grad_sweep(cfg, q, src, ctx.seg_start, ctx.seg_end, pv)
    fluid = SP.pbf_grad_sweep(cfg, q, src, ctx.seg_start[:9],
                              ctx.seg_end[:9], pv)
    assert torch.equal(SP.pbf_lambda_sweep(cfg, q, src, ctx.seg_start,
                                           ctx.seg_end, pv),
                       SP.pbf_lambda_of(both, pv))
    assert torch.equal(both[:, 4], fluid[:, 4])
    assert not torch.equal(both[:, 0], fluid[:, 0])
    assert not torch.equal(both[:, 2], fluid[:, 2])


def test_dp_sweep_without_scorr_matches_jax():
    """``pbf_scorr_k = 0`` folds to s_corr = 0 in both packages' parameter
    vectors, so scorr is exactly 0; the Δp sweep matches JAX's and
    differs from the one with the default k on the same operands."""
    ref, (_, dp, _, _), ctx = _scene_sweeps(jt.KernelSet.MULLER, 0.0)
    assert float(ctx.pvec[SP.PV_SCORR_S]) == 0.0
    assert_columns_close(dp.numpy(), ref[1], 1e-5, "dp without scorr")
    cfg, params, grid, boundary, state = _contact_scene()
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    ctx_k = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert float(ctx_k.pvec[SP.PV_SCORR_S]) > 0.0
    disp, lam, _ = _sweep_inputs(state.capacity,
                                 float(params.interaction_radius))
    lam_at, dp_at = pbf_cuda.pbf_operands(ctx_k, pparams.particle_mass)
    lam_at(torch.stack([ctx_k.px, ctx_k.py, ctx_k.pz], 1)
           + torch.from_numpy(disp))
    dp_k = SP.pbf_dp_sweep(pcfg, *dp_at(torch.from_numpy(lam)))
    assert float((dp_k - dp).abs().max()) > 1e-3 * float(dp.abs().max())


@pytest.mark.parametrize("kernel_set,squeeze", [
    (jt.KernelSet.MULLER, 1.25), (jt.KernelSet.MULLER, 0.9),
    (jt.KernelSet.MONAGHAN, 0.75)],
    ids=["under-rest", "over-dense", "monaghan-over-dense"])
def test_lambda_epilogue_matches_jax(kernel_set, squeeze):
    """The 5³ settle cube stretched ×1.25 about its centre, clear of
    the walls (under ρ₀ everywhere), or the contact scene's cube squeezed
    about its wall corner (over-dense inside: ×0.9, and ×0.75 under
    Monaghan kernels, where the unsqueezed cube sits at 0.58·ρ₀), at x*:
    the λ sweep's λ is exactly 0 on the whole stretched block, as JAX's
    formula gives it, and negative inside a squeezed one where JAX's is;
    (ρ, λ) against JAX's sums through ``pbf_pallas.py:71-75``'s formula as
    in :func:`test_pbf_sweeps_match_jax`."""
    cfg, params, grid, boundary, state = _contact_scene(kernel_set)
    pos = np.asarray(state.pos)
    if squeeze > 1.0:
        pos = np.asarray(_settle_scene(nside=5)[4].pos)
        mid = pos.mean(axis=0)
    else:
        mid = 0.6 * 2.0 * float(params.particle_radius)
    pos = mid + (pos - mid) * squeeze
    state = jt.make_fluid_state(pos.astype(np.float32))

    def sums(s):
        ctx = build_pallas_ctx(s, params, grid, cfg, boundary)
        zeros = jnp.zeros((ctx.cb,), ctx.dtype)
        pm = jnp.full((ctx.c,), 1.0, ctx.dtype) * params.particle_mass
        return PS.generic_sweep(
            cfg, PS.pbf_lambda_pair, ctx.queries(zeros, ctx.px, ctx.py,
                                                 ctx.pz, width=8),
            ctx.pack(slot6=pm), ctx.anchors, ctx.pvec, ctx.gsize,
            out_width=8, n_rows=ctx.n_rows, include_sq=True,
            pair_fn_b=PS.pbf_lambda_pair, pair_b_kw=dict(include_sq=False),
            interpret=True)[:ctx.c, :5]
    want = _jax_lambda(np.asarray(jax.jit(sums)(state)), params, cfg)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    lam_at, _ = pbf_cuda.pbf_operands(ctx, pparams.particle_mass)
    rl = SP.pbf_lambda_sweep(pcfg, *lam_at(torch.stack(
        [ctx.px, ctx.py, ctx.pz], 1))).numpy()
    if squeeze > 1.0:
        assert float(want[:, 0].max()) < float(params.rest_density)
        assert (want[:, 1] == 0.0).all() and (rl[:, 1] == 0.0).all()
    else:
        assert float(rl[:, 1].min()) < -1e3 * LAM_FLOOR
        np.testing.assert_array_equal(rl[:, 1] < 0.0, want[:, 1] < 0.0)
    _assert_lambda_close(rl, want, f"squeeze {squeeze}")


def test_operand_matrix_keeps_wall_rows():
    """:func:`pbf_cuda.pbf_operands` builds one matrix per step: in each
    iteration ``lam_at(x)`` writes the iterate into its fluid rows' x y z
    and ``dp_at(λ)`` λ into their slot 3, in place, and both leave the
    wall rows ``x y z ψ_b`` as they are; q is its fluid rows, and every
    iteration gets the same tensors. The λ sweep does not read the fluid
    rows' slot 3 (ψ = m from pvec), the Δp sweep reads λ there."""
    cfg, params, grid, boundary, state = _contact_scene()
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    c = ctx.c
    lam_at, dp_at = pbf_cuda.pbf_operands(ctx, pparams.particle_mass)
    x0 = torch.stack([ctx.px, ctx.py, ctx.pz], 1)
    q, src, s, e, pv = lam_at(x0)
    walls = src[c:].clone()
    assert walls.shape[0] == boundary.num_boundaries
    assert torch.equal(walls, ctx.density_operands(
        pparams.particle_mass)[1][c:])
    assert q.data_ptr() == src.data_ptr() and q.shape == (c, 4)
    rl0 = SP.pbf_lambda_sweep(pcfg, q, src, s, e, pv)
    for seed in (1, 2):
        rng = np.random.default_rng(seed)
        x = x0 + torch.from_numpy(rng.uniform(-1e-3, 1e-3, (c, 3)).astype(
            np.float32))
        lam = torch.from_numpy(-rng.uniform(0.0, 1e-4, c).astype(np.float32))
        args = lam_at(x)
        assert all(a is b for a, b in zip(args, (q, src, s, e, pv)))
        assert torch.equal(src[:c, :3], x)
        assert torch.equal(src[c:], walls)
        assert all(a is b for a, b in zip(dp_at(lam), args))
        assert torch.equal(src[:c, :3], x) and torch.equal(src[:c, 3], lam)
        assert torch.equal(src[c:], walls)
    lam_at(x0)
    assert torch.equal(SP.pbf_lambda_sweep(pcfg, q, src, s, e, pv), rl0)


# ---------------------------------------------------------------------------
# The step against pbf_step_pallas and the segment step
# ---------------------------------------------------------------------------

N_STEPS = 3
# (squeezed, stirred, step options) of the step comparisons: the scene as
# test_pbf.py runs it (in free fall its lattice sits at ρ₀, so λ is the
# float32 rounding of ρ/ρ₀ − 1 and nothing more, and its uniform velocity
# has no vorticity and nothing for XSPH to smooth); the same cube with the
# mass calibrated to 1.02× its spacing (~6 % over-dense), whose λ is real
# from the first iteration; and the cube with seeded velocities (±0.5 m/s)
# under XSPH (the CLI's PBF range tops at 0.05) and a confinement strong
# enough to move them by ~1e-2 m/s
CASES = {"plain": (False, False, {}),
         "xsph-vorticity": (False, False, EXTRAS[1]),
         "squeezed": (True, False, {}),
         "stirred": (False, True, dict(xsph_eps=0.05, vorticity_eps=0.5))}
# the float32 resolution of λ = −max(ρ/ρ₀ − 1, 0)/(denom + ε): a few ulps
# of ρ/ρ₀ over ε (pbf_eps, 100 by default)
LAM_FLOOR = 4.0 * float(np.finfo(np.float32).eps) / jt.SimConfig().pbf_eps


def _step_scene(squeezed, stirred):
    cfg, params, grid, boundary, state = _settle_scene(nside=7)
    if squeezed:
        params = j_calibrate_mass(
            j_pbf_params(dt=1e-3), cfg,
            spacing=1.02 * 2.0 * float(params.particle_radius))
    if stirred:
        pos = np.asarray(state.pos)
        vel = np.random.default_rng(3).uniform(-0.5, 0.5, pos.shape)
        state = jt.make_fluid_state(pos, vel.astype(np.float32))
    return cfg, params, state, grid, boundary


@pytest.fixture(scope="module")
def jax_trajectories():
    """Three steps of each case on JAX's Pallas (interpret) and segment
    engines: ``{(case, engine): [(state, diag), ...]}`` as numpy.
    Interpret mode evaluates the XSPH pair's ``pl.reciprocal(approx=
    True)`` with a ~4e-3 relative error; the port divides exactly, so the
    trajectories are taken with the exact form (as
    ``torch_bridge.exact_reciprocal`` does)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PS, "_fast_recip", lambda x: 1.0 / x)
        for case, (squeezed, stirred, extras) in CASES.items():
            cfg_o, params, state0, grid, boundary = _step_scene(squeezed,
                                                                stirred)
            cfg_p = dataclasses.replace(cfg_o, engine="pallas")
            for engine, cfg in (("pallas", cfg_p), ("segments", cfg_o)):
                step = jax.jit(lambda s, cfg=cfg, extras=extras, p=params:
                               jt.pbf_step(s, p, grid, cfg, boundary,
                                           **extras))
                s, traj = state0, []
                for _ in range(N_STEPS):
                    s, d = step(s)
                    traj.append((jax.tree_util.tree_map(np.asarray, s),
                                 jax.tree_util.tree_map(np.asarray, d)))
                out[(case, engine)] = traj
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_pbf_step_matches_jax(jax_trajectories, case):
    """λ within 1e-4·max|λ| plus its float32 resolution ``LAM_FLOOR``;
    the squeezed case's first λ lies far above that floor (the first
    step's projection leaves the cube below ρ₀, so its later λ are 0)."""
    squeezed, stirred, extras = CASES[case]
    pcfg, pparams, pstate, pg, pb = to_port(*_step_scene(squeezed, stirred))
    n = int(pstate.num_active)
    s = pstate
    for it in range(N_STEPS):
        s, d = pt.pbf_step(s, pparams, pg, pcfg, pb, **extras)
        assert int(d.solver_iters) == pcfg.pbf_iters
        lam = s.pressure.numpy()[:n]
        for engine in ("pallas", "segments"):
            s_ref, d_ref = jax_trajectories[(case, engine)][it]
            name = f"{engine} step {it}"
            assert int(d_ref.seg_overflow) == 0, name
            np.testing.assert_allclose(s.pos.numpy()[:n], s_ref.pos[:n],
                                       rtol=2e-4, atol=2e-6, err_msg=name)
            np.testing.assert_allclose(s.vel.numpy()[:n], s_ref.vel[:n],
                                       rtol=2e-3, atol=2e-4, err_msg=name)
            np.testing.assert_allclose(float(d.max_density),
                                       float(d_ref.max_density), rtol=1e-4,
                                       err_msg=name)
            lam_ref = s_ref.pressure[:n]
            scale = float(np.abs(lam_ref).max())
            if squeezed and it == 0:
                assert scale > 1e3 * LAM_FLOOR, (name, scale)
            err = float(np.abs(lam - lam_ref).max())
            assert err <= 1e-4 * scale + LAM_FLOOR, (name, err, scale)
        assert float(s.pressure.max()) <= 0.0
    if stirred:
        # confinement and XSPH each move the velocities by more than 3× the
        # velocity tolerance at 0.5 m/s (2e-4 + 2e-3·0.5), so the
        # comparison above holds their formulas
        s0, _ = pt.pbf_step(pstate, pparams, pg, pcfg, pb)
        for kw in (dict(vorticity_eps=extras["vorticity_eps"]),
                   dict(xsph_eps=extras["xsph_eps"])):
            s1, _ = pt.pbf_step(pstate, pparams, pg, pcfg, pb, **kw)
            assert float((s1.vel - s0.vel).abs().max()) > 3.6e-3, kw


# ---------------------------------------------------------------------------
# Mirror of the JAX dam-settle test, options and refusals
# ---------------------------------------------------------------------------

def test_pbf_dam_settle():
    """``test_pbf.py::test_pbf_dam_settle`` on the port: free fall obeys
    ½gt² (scorr inflates the cube's edges a little, hence the bounds),
    the fluid lands and stays above the floor with mean compression
    < 0.05, and the velocities damp out (max |v| < 1.5 m/s after 200
    steps)."""
    cfg, params, grid, boundary, state = _settle_scene()
    pcfg, pparams, state, pg, pb = to_port(cfg, params, state, grid,
                                           boundary)
    dt = float(pparams.dt)
    n = int(state.num_active)
    y0 = float(state.pos[:n, 1].min())
    maxcomp = 0.0
    for i in range(200):
        state, diag = pt.pbf_step(state, pparams, pg, pcfg, pb)
        maxcomp = max(maxcomp, float(diag.mean_compression))
        if i == 29:
            drop = y0 - float(state.pos[:n, 1].min())
            want = 0.5 * 9.81 * (30 * dt) ** 2
            assert want * 0.7 < drop < want * 1.75, (drop, want)
    p = state.pos.numpy()[:n]
    assert np.isfinite(p).all()
    assert p[:, 1].min() > 0.0, "floor penetration"
    assert maxcomp < 0.05, maxcomp
    assert int(diag.seg_overflow) == 0
    assert float(state.vel[:n].abs().max()) < 1.5


def _small_port_scene():
    cfg, params, grid, boundary, state = _settle_scene(nside=5)
    return to_port(cfg, params, state, grid, boundary)


@pytest.mark.parametrize("iters", [1, 2, 6])
def test_solver_iters_is_pbf_iters(iters):
    pcfg, pparams, pstate, pg, pb = _small_port_scene()
    cfg = dataclasses.replace(pcfg, pbf_iters=iters)
    _, diag = pt.pbf_step(pstate, pparams, pg, cfg, pb)
    assert diag.solver_iters.dtype == torch.int32
    assert int(diag.solver_iters) == iters


def test_multiphase_refused():
    pcfg, pparams, pstate, pg, pb = _small_port_scene()
    multi = pt.make_fluid_state(pstate.pos.numpy(), masses=1.0,
                                rest_densities=1000.0, device="cpu")
    with pytest.raises(NotImplementedError, match="WCSPH-only"):
        pt.pbf_step(multi, pparams, pg, pcfg, pb)


def test_boundary_velocity_changes_nothing():
    """Neither PBF wall pair reads a wall velocity (``pallas_sph.py``
    ``pbf_lambda_pair`` and ``pbf_dp_pair`` read the wall rows' positions
    and ψ only; ``pallas_common.py:115-123`` packs the velocity into rows
    3-5 that they never read), so the JAX step accepts a moving boundary
    and its result does not depend on the velocity. The port accepts it
    too, bit for bit the static result, with XSPH and vorticity on."""
    scene = _contact_scene()
    cfg, params, grid, boundary, state = scene
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    vel = np.random.default_rng(2).uniform(-1.0, 1.0, pb.pos.shape)
    moving = dataclasses.replace(pb, vel=torch.from_numpy(
        vel.astype(np.float32)))
    kw = EXTRAS[1]
    s0, d0 = pt.pbf_step(pstate, pparams, pg, pcfg, pb, **kw)
    s1, d1 = pt.pbf_step(pstate, pparams, pg, pcfg, moving, **kw)
    for a, b in ((s0.pos, s1.pos), (s0.vel, s1.vel),
                 (s0.pressure, s1.pressure),
                 (d0.max_density, d1.max_density)):
        assert torch.equal(a, b)
    # the JAX segment step with and without the wall velocity agree too
    j_moving = dataclasses.replace(boundary, vel=jnp.asarray(vel, jnp.float32))
    r0 = jax.jit(lambda s: jt.pbf_step(s, params, grid, cfg, boundary,
                                       **kw))(state)[0]
    r1 = jax.jit(lambda s: jt.pbf_step(s, params, grid, cfg, j_moving,
                                       **kw))(state)[0]
    np.testing.assert_array_equal(np.asarray(r0.vel), np.asarray(r1.vel))


@pytest.mark.parametrize("kernel_set,lattice,calibrated,want", [
    ("MULLER", "dam", "2r", 0.6759),
    ("MULLER", 0.8, 0.8, 1.0),
    ("MONAGHAN", 0.8, 0.8, 0.5784),
    ("MONAGHAN", 0.7, 0.8, 1.1792),
], ids=["pbf_1M", "settled", "monaghan-settled", "monaghan-0.7h"])
def test_lattice_density_at_rest(kernel_set, lattice, calibrated, want):
    """ρ/ρ₀ of an interior particle of a PBF lattice at rest, summed as the
    sweeps sum it (W cut at h), with the mass ``calibrate_mass`` sets:
    ``pbf_1M``'s dam-break (seeded at h − 0.005, mass calibrated to 2·r)
    sits at 0.68·ρ₀, so λ is 0 until it compresses; the settled 0.8·h
    block at ρ₀; under Monaghan kernels ``calibrate_mass`` sums the
    lattice out to the 2h support, so the same block sits at 0.58·ρ₀ and
    the kernel checks seed theirs at 0.7·h (1.18·ρ₀)."""
    from nereus_tpu_torch import kernels as K
    from nereus_tpu_torch.params import prototype_lattice
    cfg = pt.SimConfig(kernel_set=pt.KernelSet[kernel_set])
    params = pt.pbf_params(device="cpu")
    h = float(params.interaction_radius)
    cal = (2.0 * float(params.particle_radius) if calibrated == "2r"
           else calibrated * h)
    params = pt.calibrate_mass(params, cfg, spacing=cal)
    spacing = h - 0.005 if lattice == "dam" else lattice * h
    pts = prototype_lattice(params, cfg, spacing)
    pts = pts[np.sum(pts * pts, axis=-1) < h * h]
    w = K.w_value(cfg.kernel_set, torch.as_tensor(pts, dtype=torch.float32),
                  params)
    ratio = float(params.particle_mass) * float(w.sum()) / float(
        params.rest_density)
    assert ratio == pytest.approx(want, rel=1e-3)


def test_convert_carries_pbf_params():
    """``convert.params_from_numpy`` carries a JAX ``pbf_params()`` set
    across unchanged, raw and calibrated, and it equals the port's own."""
    cfg = jt.SimConfig()
    pcfg = pt.SimConfig()
    for jparams, own in (
            (j_pbf_params(), pt.pbf_params(device="cpu")),
            (j_calibrate_mass(j_pbf_params(), cfg),
             pt.calibrate_mass(pt.pbf_params(device="cpu"), pcfg))):
        carried = params_to_port(jparams)
        for f in dataclasses.fields(carried):
            want = np.asarray(getattr(jparams, f.name))
            got = getattr(carried, f.name).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f.name)
            np.testing.assert_array_equal(getattr(own, f.name).numpy(), want,
                                          err_msg=f.name)
    assert "pbf_params" in pt.__all__ and "pbf_step" in pt.__all__


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_omega_operands_equal_pack(kernel_set):
    """ω's one (C, 8) matrix, built through planes, is the query and the
    source at once and equals bit for bit ``pack(v, m/ρ, boundary=False)``
    (the column stack it replaced), ``x y z v m/ρ 0``, with the velocities
    as the step hands them over: strided views of one (C, 3) tensor."""
    cfg, params, grid, boundary, state = _contact_scene(kernel_set)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    ctx = build_sweep_ctx(pbf_cuda.advected(pstate, pparams), pparams, pg,
                          pcfg, pb)
    _, _, vel = _sweep_inputs(ctx.c, float(pparams.interaction_radius))
    v = torch.from_numpy(vel).unbind(1)
    mrho = pparams.particle_mass / torch.from_numpy(
        np.random.default_rng(2).uniform(900.0, 1100.0, ctx.c).astype(
            np.float32))
    q, src, s, e, pv = pbf_cuda.omega_operands(ctx, v, mrho)
    assert q is src and q.is_contiguous() and q.shape == (ctx.c, 8)
    assert torch.equal(q, ctx.pack(v, mrho, boundary=False))
    assert s.shape[0] == e.shape[0] == 9 and pv is ctx.pvec
