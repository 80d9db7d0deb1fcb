"""The port's XSPH option of the single-phase WCSPH step vs the JAX package
(CPU, plain sweeps), on ``tests/test_xsph.py``'s dam-break with seeded
velocities in ±0.5 m/s (so that the smoothing sum is not zero).

* The XSPH plain sweep against interpret-mode ``generic_sweep`` with
  ``xsph_pair`` over the fluid-only ranges, on the same sorted operands:
  max|Δ| ≤ 1e-5·max|ref| per output column (float32 sums in another
  order).
* ``wcsph_step`` with ε = 0.3 against JAX's Pallas (interpret) and segment
  steps over two steps: positions atol 1e-6, velocities atol 1e-5, the
  tolerances of ``test_torch_wcsph.py::test_step_matches_jax``; the JAX
  force pair's approximate reciprocal replaced by the exact one.
* ε = 0 reproduces the step without XSPH bit for bit.
* The step's one XSPH operand matrix, built through planes, equals bit for
  bit the two column-stacked builds it replaced, and is the query and the
  source at once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.solvers.pallas_common import build_pallas_ctx
from nereus_tpu.solvers.wcsph_pallas import wcsph_step_pallas

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import wcsph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_xsph import _dam
from torch_bridge import assert_columns_close, exact_reciprocal, to_port

torch.set_num_threads(1)

EPS = 0.3    # tests/test_xsph.py's ε


def _scene(kernel_set=jt.KernelSet.MULLER):
    cfg = jt.SimConfig(engine="pallas", kernel_set=kernel_set)
    params = jt.make_params()
    state, grid, boundary = _dam(params, cfg)
    pos = np.asarray(state.pos)
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    return (cfg, params, jt.make_fluid_state(pos, vel.astype(np.float32)),
            grid, boundary)


def _jax_xsph(cfg, params, state, grid, boundary):
    """The XSPH sweep of ``wcsph_step_pallas`` (nv = the state's velocities,
    ρ from its density sweep) in interpret mode: ``(dens, sum)``."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    psi = jnp.full((ctx.c,), 1.0, ctx.dtype) * params.particle_mass
    src = ctx.pack(vel=vel, slot6=psi)
    dens = PS.density_sweep(cfg, ctx.queries(width=4), src, ctx.anchors,
                            ctx.pvec, ctx.gsize, n_rows=ctx.n_rows,
                            interpret=True)
    src_x = ctx.update_rows(src, 6, [dens])
    sm = PS.generic_sweep(cfg, PS.xsph_pair, ctx.queries(*vel, dens, width=8),
                          src_x, ctx.anchors_f, ctx.pvec, ctx.gsize,
                          out_width=4, n_rows=ctx.rows_local, interpret=True)
    return dens, sm


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_xsph_sweep_matches_jax(kernel_set):
    scene = _scene(kernel_set)
    cfg, params, state, grid, boundary = scene
    dens, sm = jax.jit(lambda s: _jax_xsph(cfg, params, s, grid,
                                           boundary))(state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(*scene)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    d = torch.from_numpy(np.asarray(dens)[:n].copy())
    args = wcsph_cuda.xsph_operands(ctx, (ctx.vx, ctx.vy, ctx.vz), d)
    assert args[2].shape[0] == 9 and args[1].shape[0] == n
    got = SP.xsph_sweep(pcfg, *args)
    assert_columns_close(got.numpy(), np.asarray(sm)[:n, :3], 1e-5, "xsph")


def test_xsph_step_matches_jax(exact_reciprocal):
    """Two steps with ε = 0.3: the second from JAX's Pallas state after the
    first; XSPH moves the positions (against ε = 0) by far more than the
    tolerance."""
    cfg, params, state, grid, boundary = _scene()
    n = int(state.num_active)
    seg_cfg = jt.SimConfig(engine="segments")
    steps = {
        "pallas": jax.jit(lambda s: wcsph_step_pallas(
            s, params, grid, cfg, boundary, xsph_eps=jnp.float32(EPS))),
        "segments": jax.jit(lambda s: jt.wcsph_step(
            s, params, grid, seg_cfg, boundary, xsph_eps=jnp.float32(EPS))),
    }
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                boundary)
        s_port, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb,
                                  xsph_eps=EPS)
        s_off, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
        moved = float((s_port.pos - s_off.pos)[:n].abs().max())
        assert moved > 1e-5, moved
        refs = {name: fn(state) for name, fn in steps.items()}
        for name, (s_ref, d_ref) in refs.items():
            assert int(d_ref.seg_overflow) == 0, name
            msg = f"{name} step {step}"
            np.testing.assert_allclose(s_port.pos.numpy()[:n],
                                       np.asarray(s_ref.pos)[:n], rtol=0,
                                       atol=1e-6, err_msg=msg)
            np.testing.assert_allclose(s_port.vel.numpy()[:n],
                                       np.asarray(s_ref.vel)[:n], rtol=0,
                                       atol=1e-5, err_msg=msg)
        state = refs["pallas"][0]


def test_xsph_eps_zero_matches_off():
    """ε = 0 reproduces the step without XSPH exactly: the sum is scaled
    outside the sweep, and the stored velocity is never smoothed."""
    pcfg, pparams, pstate, pg, pb = to_port(*_scene())
    s0, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
    s1, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb, xsph_eps=0.0)
    assert torch.equal(s0.pos, s1.pos)
    assert torch.equal(s0.vel, s1.vel)
    s2, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pb, xsph_eps=EPS)
    assert torch.equal(s0.vel, s2.vel)
    assert not torch.equal(s0.pos, s2.pos)


def _port_ctx():
    """The sweep context of the port's copy of ``_scene()``, with seeded
    new velocities (±0.5 m/s) and a seeded density around ρ₀."""
    pcfg, pparams, pstate, pg, pb = to_port(*_scene())
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    rng = np.random.default_rng(1)
    nv = torch.from_numpy(rng.uniform(-0.5, 0.5, (ctx.c, 3)).astype(
        np.float32))
    dens = torch.from_numpy(rng.uniform(900.0, 1100.0, ctx.c).astype(
        np.float32))
    return ctx, nv, dens


@pytest.mark.parametrize("strided", [False, True])
def test_xsph_operands_equal_the_column_builds(strided):
    """XSPH's one (C, 8) matrix, built through planes, is the query and the
    source at once and holds bit for bit what the two column stacks it
    replaced held: the query ``queries(*nv, ρ, width=8)`` and the source
    ``pack(nv, ρ, boundary=False)``, ``x y z nv ρ 0``; the new velocities
    as three contiguous columns (the WCSPH step's) or as strided views of
    one (C, 3) tensor (the PBF step's)."""
    ctx, nv, dens = _port_ctx()
    cols = (nv.unbind(1) if strided
            else tuple(nv[:, k].contiguous() for k in range(3)))
    q, src, s, e, pv = wcsph_cuda.xsph_operands(ctx, cols, dens)
    assert q is src and q.is_contiguous() and q.shape == (ctx.c, 8)
    assert torch.equal(q, ctx.queries(*cols, dens, width=8))
    assert torch.equal(src, ctx.pack(cols, dens, boundary=False))
    assert s.shape[0] == e.shape[0] == 9 and pv is ctx.pvec
    assert torch.equal(q[:, 7], torch.zeros(ctx.c))


def test_plane_builds_refuse_too_many_columns():
    """A matrix built through planes takes at most its width less the three
    position columns; the wide matrix keeps its boundary rows behind the
    fluid rows, ``x y z v_b ψ_b`` and zero pads."""
    ctx, nv, dens = _port_ctx()
    with pytest.raises(ValueError, match="at most 5 columns"):
        ctx.pack_fluid([*nv.unbind(1), dens, dens], dens)
    wide = ctx.pack_wide([*nv.unbind(1), dens])
    assert wide.shape == (ctx.c + ctx.b_src.shape[0], SP.WIDE_WIDTH)
    assert torch.equal(wide[ctx.c:, :8], ctx.b_src)
    assert not wide[ctx.c:, 8:].any()
    assert torch.equal(wide[:ctx.c, :7],
                       ctx.queries(*nv.unbind(1), dens))
