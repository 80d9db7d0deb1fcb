"""The port's multiphase coupled WCSPH step vs the JAX package (CPU, plain
sweeps), mirroring ``tests/test_multiphase_coupled.py``.

* The ``MultiphaseBody`` plain twin against JAX's ``multiphase_body_pair``
  summed over every (query, sample) pair within h, on the step's own
  operands: max|Δ| ≤ 1e-5·max|ref| per column.
* ``wcsph_coupled_step`` on ``test_torch_multiphase.py``'s settled
  two-phase tank in wall contact, with a moving, spinning body parked in
  the fluid, against JAX's Pallas step (interpret mode) over two steps:
  fluid positions atol 1e-6 and velocities atol 1e-4 in sorted order,
  mass and ρ₀ equal, body com and R atol 1e-6, velocity atol 1e-5,
  ω atol 1e-4 (``test_mp_coupled_engines_match``'s tolerances).
* At uniform phase columns the multiphase coupled step gives the
  single-phase one's reaction (body velocity rtol 1e-4, ω rtol 1e-3, max
  density rtol 1e-5, as ``test_mp_body_contact_reduces_to_single_phase``);
  the refusals.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import coupled_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_multiphase import two_layer
from test_torch_multiphase import canon, contact
from torch_bridge import (assert_columns_close, body_to_port,
                          exact_reciprocal, to_port)

torch.set_num_threads(1)

ST = jt.SurfaceTensionModel


def _parked_body(state, params, density=400.0):
    """``test_mp_coupled_engines_match``'s 0.06 box parked mid-column (at
    the 0.6 height quantile), here moving and spinning."""
    n = int(state.num_active)
    p = np.asarray(state.pos)[:n]
    center = (float(p[:, 0].mean()), float(np.quantile(p[:, 1], 0.6)),
              float(p[:, 2].mean()))
    body = jt.make_rigid_box(center, (0.06,) * 3,
                             float(params.particle_radius), density, params)
    return dataclasses.replace(
        body, vel=jnp.asarray([0.05, -0.1, 0.02], jnp.float32),
        omega=jnp.asarray([0.2, -0.1, 0.3], jnp.float32))


def test_multiphase_body_twin_matches_jax(contact):
    """The multiphase body contact's plain twin on the step's operands,
    and on them with bp = 0 (its friction alone, ~1e-10 of the pressure
    term here), against ``multiphase_body_pair`` over every pair within h;
    the friction reads the sample velocities."""
    state, params, grid, walls = contact
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pw)
    body = _parked_body(state, params)
    shells = coupled_cuda.body_shells(ctx, pg, (body_to_port(body),))
    _, q8b, _, pres = coupled_cuda.coupled_multiphase_operands(
        ctx, pparams, pcfg, shells)
    sh = shells[0]
    assert float(pres.max()) > 0.0
    pv = PS.build_pvec(params, cfg, grid)
    src = jnp.asarray(sh.src.numpy().T)
    # as the step runs it, then the friction alone (bp = 0)
    fric = q8b.clone()
    fric[:, 6] = 0.0
    for name, q in (("multiphase body", q8b), ("friction", fric)):
        got = SP.multiphase_body_sweep(pcfg, q, sh.src, sh.seg_start,
                                       sh.seg_end, ctx.pvec)
        jq = jnp.asarray(q.numpy())
        want = PS.multiphase_body_pair(
            jq, src, jnp.ones((jq.shape[0], src.shape[1]), bool), pv,
            kernel_set=cfg.kernel_set)
        assert_columns_close(got.numpy(), np.asarray(want)[:, :3], 1e-5,
                             name)
    # the friction reads the sample velocities
    still = SP.multiphase_body_sweep(
        pcfg, fric, sh.src.clone().index_fill_(1, torch.tensor([3, 4, 5]),
                                               0.0),
        sh.seg_start, sh.seg_end, ctx.pvec)
    assert float((still - got).abs().max()) > 1e-3 * float(got.abs().max())


def test_mp_coupled_matches_jax(exact_reciprocal, contact):
    """Two multiphase coupled steps against JAX's Pallas step."""
    state, params, grid, walls = contact
    n = int(state.num_active)
    cfg = jt.SimConfig(engine="pallas", surface_tension_model=ST.NONE)
    body = _parked_body(state, params)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    step = jax.jit(lambda s, b: jt.wcsph_coupled_step(s, params, grid, cfg,
                                                      b, walls))
    js, jb, ps, pb = state, body, pstate, body_to_port(body)
    for it in range(2):
        js, jb, jd = step(js, jb)
        ps, pb, pd = pt.wcsph_coupled_step(ps, pparams, pg, pcfg, pb, pw)
        po, vo, mo, ro = canon(js, n)
        pp, vp, mp, rp = canon(ps, n)
        np.testing.assert_allclose(pp, po, rtol=0, atol=1e-6, err_msg=it)
        np.testing.assert_allclose(vp, vo, rtol=0, atol=1e-4, err_msg=it)
        np.testing.assert_array_equal(mp, mo)
        np.testing.assert_array_equal(rp, ro)
        for f, atol in (("com", 1e-6), ("R", 1e-6), ("vel", 1e-5),
                        ("omega", 1e-4)):
            np.testing.assert_allclose(getattr(pb, f).numpy(),
                                       np.asarray(getattr(jb, f)), rtol=0,
                                       atol=atol, err_msg=f"{it} {f}")
        assert int(jd.seg_overflow) == 0 and int(pd.seg_overflow) == 0
    assert float(torch.linalg.norm(pb.omega - torch.tensor(
        [0.2, -0.1, 0.3]))) > 1.0


def test_mp_body_contact_reduces_to_single_phase():
    """At uniform phase (mass m, ρ₀ everywhere) the multiphase coupled step
    gives the single-phase step's reaction on a body parked in the fluid
    (the port alone, the tank settled by the port's multiphase step)."""
    state, params, grid, walls, _ = two_layer(ratio_top=1.0, vel_y=-1.0,
                                              side_cells=4)
    cfg = jt.SimConfig(surface_tension_model=ST.NONE)
    pcfg, pparams, pstate, pg, pw = to_port(cfg, params, state, grid, walls)
    for _ in range(40):
        pstate, _ = pt.wcsph_step(pstate, pparams, pg, pcfg, pw)
    n = int(pstate.num_active)
    body = body_to_port(_parked_body(
        dataclasses.replace(state, pos=jnp.asarray(pstate.pos.numpy())),
        params))
    s_mp, b_mp, d_mp = pt.wcsph_coupled_step(pstate, pparams, pg, pcfg, body,
                                             pw)
    single = pt.FluidState(pos=pstate.pos, vel=pstate.vel,
                           pressure=pstate.pressure,
                           num_active=pstate.num_active)
    s_sp, b_sp, d_sp = pt.wcsph_coupled_step(single, pparams, pg, pcfg,
                                             body, pw)
    assert float(torch.linalg.norm(b_mp.vel - body.vel)) > 1e-3
    np.testing.assert_allclose(b_mp.vel.numpy(), b_sp.vel.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(b_mp.omega.numpy(), b_sp.omega.numpy(),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(d_mp.max_density),
                               float(d_sp.max_density), rtol=1e-5)
    assert np.isfinite(s_mp.pos.numpy()[:n]).all()


def test_mp_coupled_gates():
    """AKINCI surface tension and implicit viscosity refuse multiphase
    coupling, with the JAX step's reasons."""
    state, params, grid, walls, _ = two_layer(side_cells=3)
    body = jt.make_rigid_box((0.2, 0.5, 0.2), (0.06,) * 3,
                             float(params.particle_radius), 400.0, params)
    pcfg, pparams, pstate, pg, pw = to_port(jt.SimConfig(), params, state,
                                            grid, walls)
    pbody = body_to_port(body)
    for c in (dataclasses.replace(
            pcfg, surface_tension_model=pt.SurfaceTensionModel.AKINCI),
            dataclasses.replace(pcfg, viscosity_model="implicit")):
        with pytest.raises(NotImplementedError, match="single-phase-only"):
            pt.wcsph_coupled_step(pstate, pparams, pg, c, pbody, pw)
        jcfg = dataclasses.replace(
            jt.SimConfig(engine="segments"),
            viscosity_model=c.viscosity_model,
            surface_tension_model=ST[c.surface_tension_model.name])
        with pytest.raises(NotImplementedError, match="single-phase-only"):
            jt.wcsph_coupled_step(state, params, grid, jcfg, body, walls)
