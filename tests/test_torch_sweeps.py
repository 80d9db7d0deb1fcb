"""The port's plain density and force sweeps vs the JAX Pallas sweeps
(interpret mode), on identical sorted inputs.

The JAX side is run as ``wcsph_step_pallas`` runs it: ``build_pallas_ctx``
then ``PS.density_sweep`` / ``PS.fluid_force_sweep``. The force sweep is
fed the same density on both sides, so each sweep is held on its own.
Tolerances: density rtol 1e-5, force max|Δf| ≤ 1e-5·max|f| (float32
summation order differs: windows on one side, per-row ``index_add_`` on
the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import MODEL_IDS, MODELS, jax_scene, to_port

torch.set_num_threads(1)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """Interpret mode evaluates the force pair's ``pl.reciprocal(approx=
    True)`` with a ~4e-3 relative error. The port divides exactly, as the
    JAX pair formulas do outside a Mosaic kernel (``_fast_recip``); hold
    both to the exact form so the tolerance measures the sweep."""
    monkeypatch.setattr(PS, "_fast_recip", lambda x: 1.0 / x)


def _jax_sweeps(cfg, params, state, grid, boundary):
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    c, cb = ctx.c, ctx.cb
    vel = (ctx.vx, ctx.vy, ctx.vz)
    src_d = ctx.pack(vel=vel, slot6=jnp.full((c,), 1.0, ctx.dtype)
                     * params.particle_mass)
    dens = PS.density_sweep(cfg, ctx.queries(width=4), src_d, ctx.anchors,
                            ctx.pvec, ctx.gsize, n_rows=ctx.n_rows,
                            interpret=True)
    dens = jnp.where(jnp.arange(cb) < c, dens, 0.0)
    pres = jt.tait_pressure(dens, params)
    ds = jnp.maximum(dens, 1e-12)
    force = PS.fluid_force_sweep(
        cfg, ctx.queries(*vel, dens, pres / (ds * ds)),
        ctx.update_rows(src_d, 6, [dens]), ctx.anchors, ctx.pvec,
        ctx.gsize, n_rows=ctx.n_rows, interpret=True)
    return np.asarray(dens)[:c], np.asarray(force)[:c]


def _port_sweeps(pcfg, pparams, pstate, pgrid, pboundary, dens):
    ctx = build_sweep_ctx(pstate, pparams, pgrid, pcfg, pboundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    p_dens = SP.density_sweep(pcfg, ctx.queries(width=4),
                              ctx.pack(vel, pparams.particle_mass),
                              ctx.seg_start, ctx.seg_end, ctx.pvec)
    d = torch.from_numpy(dens.copy())
    ds = d.clamp(min=1e-12)
    pd2 = pt.tait_pressure(d, pparams) / (ds * ds)
    p_force = SP.fluid_force_sweep(pcfg, ctx.queries(*vel, d, pd2),
                                   ctx.pack(vel, d), ctx.seg_start,
                                   ctx.seg_end, ctx.pvec)
    return p_dens.numpy(), p_force.numpy(), ctx.seg_start.shape[0]


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set,st", MODELS, ids=MODEL_IDS)
def test_sweeps_match_jax(exact_reciprocal, kernel_set, st, with_boundary):
    # floor 0.04 under the bottom layer: the boundary terms are live
    scene = jax_scene(with_boundary, kernel_set, st, floor=-0.115)
    dens, force = _jax_sweeps(*scene)
    p_dens, p_force, p_rows = _port_sweeps(*to_port(*scene), dens)
    assert p_rows == (18 if with_boundary else 9)
    assert np.isfinite(p_force).all()
    np.testing.assert_allclose(p_dens, dens, rtol=1e-5)
    scale = np.abs(force).max()
    assert scale > 0.0
    assert np.abs(p_force - force).max() <= 1e-5 * scale
