"""The port's elastic and elastoplastic solids vs the JAX package (CPU, plain
sweeps), mirroring ``tests/test_elastic.py`` and
``tests/test_elastic_plastic.py``.

* ``make_elastic_solid`` equals JAX's on the 8×4×4 bar: ``x0`` in the same
  order exactly, ``fixed`` exactly, the corrections within atol 1e-5;
  ``elastic_params`` equals JAX's field by field.
* The plain twins of ``elastic_f_pair`` and of ``elastic_force_pair`` and
  ``elastic_hourglass_pair`` (the fused force + hourglass sweep), both
  over the body's static pair list, against JAX's pair functions summed
  over every pair within h, on the bar stretched 2 % along x, sheared,
  rotated and perturbed by a seeded non-affine noise of 0.05·spacing (the
  hourglass term is 0 on affine motion), both kernel sets: max|Δ| ≤
  1e-5·max|ref| per column, JAX's approximate reciprocal replaced by the
  exact one. Over the list, both sweeps equal the same pair functions
  walked over the body's (9, N) ranges within 1e-6·max|ref| (summation
  order), and so does an elastic step whose F sweep walks the ranges.
* ``elastic_step`` against JAX's segment oracle (``seg_window=64``) and
  JAX's Pallas step in interpret mode, over 3 steps from the 2 %-stretched
  bar: pos atol 1e-6, vel atol 1e-4, energy rtol 1e-3
  (``test_oracle_pallas_lockstep``); the elastoplastic step over 3 steps
  of active flow (``test_plastic_oracle_pallas_lockstep``: pos and plastic
  strain atol 1e-6).
* Mirrors: the rest state is an equilibrium; a rigid rotation gives zero
  force; a uniform stretch gives the analytic StVK energy and pulls back.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import SimConfig, make_params
from nereus_tpu.solvers import elastic as JEL

import nereus_tpu_torch as pt
from nereus_tpu_torch import convert
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import elastic_cuda

from test_torch_package import _deformed
from torch_bridge import (assert_columns_close, exact_reciprocal,
                          params_to_port)

torch.set_num_threads(1)

ORACLE = SimConfig(engine="segments", seg_window=64)
PALLAS = SimConfig(engine="pallas", seg_window=64)
EP_FIELDS = ("mu", "lam", "hourglass", "damping", "floor_y", "box_lo",
             "box_hi", "yield_strain", "creep", "max_plastic")


def _bar(cfg=ORACLE, nx=8, ny=4, nz=4, fixed_x0=False, dt=1e-4):
    """``test_elastic.py``'s rubber bar (spacing h/2), JAX side: ``(pos,
    params, sp, fixed, (state, statics, grid))``."""
    params = make_params(dt=dt, gravity=(0.0, 0.0, 0.0))
    sp = 0.5 * float(np.asarray(params.interaction_radius))
    pos = JEL.sample_box_solid(
        (0.0, 0.0, 0.0), ((nx - 1) * sp, (ny - 1) * sp, (nz - 1) * sp), sp)
    fixed = pos[:, 0] < 0.5 * sp if fixed_x0 else None
    body = jt.make_elastic_solid(pos, params, cfg, sp, fixed=fixed)
    return pos, params, sp, fixed, body


def _port_cfg(cfg):
    return convert.config_from_jax_fields(cfg)


def _ep_to_port(ep):
    return convert.elastic_params_from_numpy(
        {f: np.asarray(getattr(ep, f)) for f in EP_FIELDS}, device="cpu")


def _statics_to_port(statics, grid, params):
    pgrid = convert.grid_from_numpy(grid.origin, grid.size, grid.cell,
                                    device="cpu")
    return convert.elastic_statics_from_numpy(
        statics.x0, statics.corr, statics.fixed, statics.vol, statics.mass,
        pgrid, float(params.interaction_radius), device="cpu"), pgrid


# ---------------------------------------------------------------------------
# The body, its parameters and the pair twins
# ---------------------------------------------------------------------------

def test_make_elastic_solid_matches_jax():
    """x0 and fixed equal JAX's exactly (statics order is the contract
    between the packages), corr within atol 1e-5, the same grid; the
    static ranges are exact (miss 0) and rebuilt equal from x0 by
    ``convert``."""
    pos, params, sp, fixed, (state, statics, grid) = _bar(fixed_x0=True)
    pparams = params_to_port(params)
    pstate, pstat, pgrid = pt.make_elastic_solid(
        pos, pparams, _port_cfg(ORACLE), sp, fixed=fixed, device="cpu")
    np.testing.assert_array_equal(pstat.x0.numpy(), np.asarray(statics.x0))
    np.testing.assert_array_equal(pstat.fixed.numpy(),
                                  np.asarray(statics.fixed))
    assert 0 < int(pstat.fixed.sum()) < pstat.n
    np.testing.assert_allclose(pstat.corr.numpy(), np.asarray(statics.corr),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pstat.sorted_hash.numpy(),
                                  np.asarray(statics.sorted_hash))
    assert pgrid.size == tuple(int(s) for s in grid.size)
    np.testing.assert_array_equal(pgrid.origin.numpy(),
                                  np.asarray(grid.origin))
    for f in ("vol", "mass"):
        assert float(getattr(pstat, f)) == float(getattr(statics, f)), f
    assert pstat.seg_start.shape == (9, pstat.n)
    assert int(pstat.miss) == 0 and pstate.plastic is None
    np.testing.assert_array_equal(pstate.pos.numpy(), pstat.x0.numpy())
    conv, _ = _statics_to_port(statics, grid, params)
    for f in ("sorted_hash", "seg_start", "seg_end", "fixed"):
        assert torch.equal(getattr(conv, f), getattr(pstat, f)), f


def test_elastic_params_match_jax():
    kw = dict(hourglass=12.0, damping=3.0, floor_y=-0.1,
              box_lo=(-1.0, -2.0, -3.0), box_hi=(1.0, 2.0, 3.0),
              yield_strain=0.02, creep=50.0, max_plastic=0.3)
    for args, k in (((1e5,), {}), ((2e5, 0.35), kw)):
        got = pt.elastic_params(*args, **k, device="cpu")
        want = jt.elastic_params(*args, **k)
        for f in EP_FIELDS:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)


def test_entry_points_default_to_the_card():
    for fn in (pt.elastic_params, pt.make_elastic_solid,
               convert.elastic_params_from_numpy,
               convert.elastic_state_from_numpy,
               convert.elastic_statics_from_numpy):
        assert inspect.signature(fn).parameters["device"].default is None, \
            fn.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pt.elastic_params(1e5)


def _operands(kernel_set, seed=0):
    """The deformed bar's operands, port and JAX layouts: ``(pcfg, ppv,
    pstat, fargs, hargs, jax pieces)``."""
    cfg = dataclasses.replace(ORACLE, kernel_set=kernel_set)
    pos, params, sp, _, (state, statics, grid) = _bar(cfg)
    pstat, pgrid = _statics_to_port(statics, grid, params)
    pcfg, pparams = _port_cfg(cfg), params_to_port(params)
    ppv = SP.build_pvec(pparams, pcfg, pgrid)
    x = _deformed(torch.from_numpy(np.asarray(statics.x0)), sp, seed)
    fargs = elastic_cuda.f_gradient_operands(pstat, x, ppv)
    raw = SP.elastic_f_sweep_plain(pcfg, *fargs)
    n = pstat.n
    f = torch.bmm(pstat.vol * raw.reshape(n, 3, 3), pstat.corr)
    ep = pt.elastic_params(1e5, 0.3, device="cpu")
    pc, _, _ = pt.solvers.elastic.stress_pc(f, pstat.corr, ep)
    hargs = elastic_cuda.force_operands(pstat, x, pc, f, ppv)
    return pcfg, fargs, hargs, raw, (cfg, params, grid), pstat


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_pair_twins_match_jax(exact_reciprocal, kernel_set):
    """The F accumulator, the elastic force and the hourglass force (the
    fused sweep's two halves) against JAX's pair functions over every pair
    within h; the hourglass is live (not all 0) on these operands."""
    pcfg, fargs, hargs, raw, (cfg, params, grid), _ = _operands(kernel_set)
    pv = PS.build_pvec(params, cfg, grid)
    q8 = fargs[0].numpy()
    q24 = hargs[0].numpy()
    n = q8.shape[0]
    valid = jnp.ones((n, n), bool)

    def dense(pair, q):
        return np.asarray(pair(jnp.asarray(q), jnp.asarray(q.T), valid, pv,
                               kernel_set=kernel_set))
    want_f = dense(PS.elastic_f_pair, q8)
    want_el = dense(PS.elastic_force_pair,
                    np.concatenate([q24[:, :3], q24[:, 6:15]], axis=1))
    want_hg = dense(PS.elastic_hourglass_pair,
                    np.concatenate([q24[:, :6], q24[:, 15:24]], axis=1))
    assert_columns_close(raw.numpy(), want_f, 1e-5, "F")
    got = SP.elastic_force_hourglass_sweep_plain(pcfg, *hargs).numpy()
    assert_columns_close(got[:, :3], want_el[:, :3], 1e-5, "elastic force")
    assert_columns_close(got[:, 3:], want_hg[:, :3], 1e-5, "hourglass")
    # the fused sweep is the two pair functions side by side, over the
    # body's pair list
    pv_t = hargs[4]
    for k, pair in ((slice(0, 3), SP.elastic_force_pair),
                    (slice(3, 6), SP.elastic_hourglass_pair)):
        alone = pt.ops.neighbors.list_sweep_plain(
            lambda a, b: pair(a, b, pv_t, kernel_set=pcfg.kernel_set),
            hargs[0], hargs[1], hargs[2], hargs[3], 3)
        assert torch.equal(alone, torch.from_numpy(got[:, k]))


def _list_pairs(nbr_start, nbr):
    """The set of (i, j) pairs of a static pair list."""
    counts = (nbr_start[1:] - nbr_start[:-1]).long()
    qi = torch.repeat_interleave(torch.arange(len(counts)), counts)
    return set(zip(qi.tolist(), nbr.tolist()))


def test_pair_list_holds_the_pairs_within_h():
    """The body's static pair list holds exactly the pairs with |X_ij|² <
    h² in float32 (self pairs included), found here by an all-pairs
    search, each once and grouped by query; ``convert`` rebuilds the same
    list from JAX's body, given the params' h."""
    pos, params, sp, _, (state, statics, grid) = _bar()
    pparams = params_to_port(params)
    _, pstat, _ = pt.make_elastic_solid(pos, pparams, _port_cfg(ORACLE), sp,
                                        device="cpu")
    x = pstat.x0.numpy()
    d = x[:, None, :] - x[None, :, :]
    h = np.float32(np.asarray(params.interaction_radius))
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    want = set(zip(*map(np.ndarray.tolist, np.nonzero(r2 < h * h))))
    ns, nb = pstat.nbr_start, pstat.nbr
    assert ns.dtype == nb.dtype == torch.int32
    assert int(ns[0]) == 0 and int(ns[-1]) == nb.shape[0] == len(want)
    assert bool((ns[1:] >= ns[:-1]).all())
    assert _list_pairs(ns, nb) == want
    assert all((i, i) in want for i in range(pstat.n))
    conv = convert.elastic_statics_from_numpy(
        statics.x0, statics.corr, statics.fixed, statics.vol, statics.mass,
        convert.grid_from_numpy(grid.origin, grid.size, grid.cell,
                                device="cpu"),
        pparams.interaction_radius, device="cpu")
    assert torch.equal(conv.nbr_start, ns) and torch.equal(conv.nbr, nb)


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_pair_list_sweep_matches_the_range_walk(kernel_set):
    """The fused force + hourglass sweep over the pair list equals the
    same pair function walked over the body's (9, N) ranges (every pair
    outside h adds exactly 0 there) on the deformed bar, both kernel
    sets."""
    pcfg, _, hargs, _, _, pstat = _operands(kernel_set)
    q, src, ns, nb, pv = hargs
    got = SP.elastic_force_hourglass_sweep(pcfg, *hargs)
    walk = pt.ops.neighbors.neighbor_sweep_plain(
        lambda a, b: SP.elastic_force_hourglass_pair(
            a, b, pv, kernel_set=pcfg.kernel_set), q, src, pstat.seg_start,
        pstat.seg_end, 6)
    assert int(nb.shape[0]) < int((pstat.seg_end - pstat.seg_start).sum())
    assert float(got[:, 3:].abs().max()) > 0.0
    torch.testing.assert_close(got, walk, rtol=1e-6,
                               atol=1e-6 * float(walk.abs().max()))


def _f_range_walk(cfg, q, src, seg_start, seg_end, pvec):
    """The deformation-gradient sweep walked over the body's (9, N) ranges,
    every candidate outside h adding exactly 0."""
    return pt.ops.neighbors.neighbor_sweep_plain(
        lambda a, b: SP.elastic_f_pair(a, b, pvec,
                                       kernel_set=cfg.kernel_set),
        q, src, seg_start, seg_end, 9)


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_f_list_sweep_matches_the_range_walk(kernel_set):
    """The deformation-gradient sweep over the pair list (the dispatcher's
    CPU route) equals ``elastic_f_pair`` walked over the body's ranges on
    the deformed bar: max|Δ| ≤ 1e-6·max|ref| per column (the two sum in
    another order)."""
    pcfg, fargs, _, raw, _, pstat = _operands(kernel_set)
    q, src, ns, nb, pv = fargs
    assert torch.equal(ns, pstat.nbr_start) and torch.equal(nb, pstat.nbr)
    got = SP.elastic_f_sweep(pcfg, *fargs)
    assert torch.equal(got, raw)
    walk = _f_range_walk(pcfg, q, src, pstat.seg_start, pstat.seg_end, pv)
    assert_columns_close(got.numpy(), walk.numpy(), 1e-6, "F")


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_step_matches_the_range_walk_step(kernel_set, monkeypatch):
    """One elastic step (``elastic_step_cuda`` on CPU tensors) from the
    deformed bar, its F sweep over the pair list, against the same step
    with the F sweep walked over the body's ranges: positions, velocities
    and the diagnostics within 1e-6·max|ref| per column."""
    cfg = dataclasses.replace(ORACLE, kernel_set=kernel_set)
    pos, params, sp, _, (_, statics, grid) = _bar(cfg)
    pstat, pgrid = _statics_to_port(statics, grid, params)
    pcfg, pparams = _port_cfg(cfg), params_to_port(params)
    ep = pt.elastic_params(1e5, 0.3, device="cpu")
    x = _deformed(torch.from_numpy(np.asarray(statics.x0)), sp, 0)
    state = convert.elastic_state_from_numpy(x.numpy(), np.zeros_like(
        x.numpy()), device="cpu")
    want_f = elastic_cuda.f_gradient_operands

    def steps():
        return elastic_cuda.elastic_step_cuda(state, pstat, pparams, ep,
                                              pgrid, pcfg)
    got, gd = steps()
    monkeypatch.setattr(
        elastic_cuda, "f_gradient_operands",
        lambda st, cur, pv: (*want_f(st, cur, pv)[:2], st.seg_start,
                             st.seg_end, pv))
    monkeypatch.setattr(SP, "elastic_f_sweep", _f_range_walk)
    ref, rd = steps()
    assert float(ref.vel.abs().max()) > 0.0
    for name in ("pos", "vel"):
        assert_columns_close(getattr(got, name).numpy(),
                             getattr(ref, name).numpy(), 1e-6, name)
    for name in ("elastic_energy", "max_stretch", "max_speed"):
        assert_columns_close(getattr(gd, name).reshape(1).numpy(),
                             getattr(rd, name).reshape(1).numpy(), 1e-6,
                             name)


# ---------------------------------------------------------------------------
# The step against JAX
# ---------------------------------------------------------------------------

def _stretched(state, statics, eps=0.02):
    return np.asarray(statics.x0) * np.array([1.0 + eps, 1.0, 1.0],
                                             np.float32)


def _lockstep(jcfg, jbody, pbody, params, ep, x, steps=3, plastic=False):
    """``steps`` JAX and port steps from positions ``x``; asserts the
    tolerances of the JAX lockstep tests each step."""
    jstate, jstat, jgrid = jbody
    pstate, pstat, pgrid = pbody
    pcfg, pparams, pep = _port_cfg(jcfg), params_to_port(params), \
        _ep_to_port(ep)
    js = dataclasses.replace(jstate, pos=jnp.asarray(x))
    ps = dataclasses.replace(pstate, pos=torch.from_numpy(x))
    for it in range(steps):
        js, jd = jt.elastic_step(js, jstat, params, ep, jgrid, jcfg)
        ps, pd = pt.elastic_step(ps, pstat, pparams, pep, pgrid, pcfg)
        np.testing.assert_allclose(ps.pos.numpy(), np.asarray(js.pos),
                                   rtol=0, atol=1e-6, err_msg=f"pos {it}")
        np.testing.assert_allclose(ps.vel.numpy(), np.asarray(js.vel),
                                   rtol=0, atol=1e-4, err_msg=f"vel {it}")
        np.testing.assert_allclose(float(pd.elastic_energy),
                                   float(jd.elastic_energy), rtol=1e-3)
        if plastic:
            np.testing.assert_allclose(ps.plastic.numpy(),
                                       np.asarray(js.plastic), rtol=0,
                                       atol=1e-6, err_msg=f"plastic {it}")
        assert int(pd.seg_overflow) == 0
    return ps, pd, js


def test_step_matches_jax_segment_oracle():
    pos, params, sp, _, jbody = _bar()
    pbody = pt.make_elastic_solid(pos, params_to_port(params),
                                  _port_cfg(ORACLE), sp, device="cpu")
    ep = jt.elastic_params(1e5, 0.3, damping=0.0)
    ps, pd, _ = _lockstep(ORACLE, jbody, pbody, params, ep,
                          _stretched(*jbody[:2]))
    # the bar moved: the velocities are far above the tolerance
    assert float(pd.max_speed) > 1e-2


def test_step_matches_jax_pallas(exact_reciprocal):
    """Against JAX's Pallas step (interpret mode), the port's statics
    carried across by ``convert``."""
    _, params, sp, _, (_, ostat, grid) = _bar()
    jbody = jt.make_elastic_solid(np.asarray(ostat.x0), params, PALLAS, sp,
                                  grid=grid)
    assert int(jbody[1].miss) == 0
    pstat, pgrid = _statics_to_port(jbody[1], grid, params)
    pstate = convert.elastic_state_from_numpy(
        jbody[0].pos, jbody[0].vel, device="cpu")
    ep = jt.elastic_params(1e5, 0.3, damping=0.0)
    _lockstep(PALLAS, jbody, (pstate, pstat, pgrid), params, ep,
              _stretched(*jbody[:2]))


def test_plastic_step_matches_jax():
    """The 5³ cube stretched 6 %, beyond its 2 % yield: three steps of
    active flow against the JAX oracle; E_p stays traceless."""
    params = make_params(dt=2e-4, gravity=(0.0, 0.0, 0.0))
    sp = 0.5 * float(np.asarray(params.interaction_radius))
    side = 4 * sp
    pos = JEL.sample_box_solid((0.0, 0.0, 0.0), (side, side, side), sp)
    jbody = jt.make_elastic_solid(pos, params, ORACLE, sp, plastic=True)
    pbody = pt.make_elastic_solid(pos, params_to_port(params),
                                  _port_cfg(ORACLE), sp, plastic=True,
                                  device="cpu")
    ep = jt.elastic_params(1e5, yield_strain=0.02)
    ps, _, js = _lockstep(ORACLE, jbody, pbody, params, ep,
                          _stretched(*jbody[:2], eps=0.06), plastic=True)
    assert float(jnp.abs(js.plastic).max()) > 1e-3
    tr = torch.einsum("naa->n", ps.plastic)
    assert float(tr.abs().max()) < 1e-5 * float(ps.plastic.abs().max())


# ---------------------------------------------------------------------------
# Mirrors of test_elastic.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_bar():
    pos, params, sp, _, _ = _bar()
    pparams = params_to_port(params)
    state, statics, grid = pt.make_elastic_solid(
        pos, pparams, _port_cfg(ORACLE), sp, device="cpu")
    ep = pt.elastic_params(1e5, 0.3, damping=0.0, device="cpu")
    return _port_cfg(ORACLE), pparams, state, statics, grid, ep, sp


def test_rest_state_is_equilibrium(port_bar):
    cfg, params, state, statics, grid, ep, sp = port_bar
    s = state
    for _ in range(20):
        s, diag = pt.elastic_step(s, statics, params, ep, grid, cfg)
    drift = float((s.pos - statics.x0).abs().max())
    assert drift < 2e-3 * 2.0 * sp, drift
    assert float(diag.elastic_energy) < 1e-8


def test_rigid_rotation_gives_zero_force(port_bar):
    """F = R on an affine map, so E = 0 and the elastic force vanishes, and
    the hourglass term is blind to it: the velocities after one step are
    under 1e-3 of those of a 1 % stretch."""
    cfg, params, state, statics, grid, ep, sp = port_bar
    r = pt.rotation_matrix((0.0, 0.0, 1.0), np.deg2rad(30.0), device="cpu")
    com = statics.x0.mean(dim=0)
    rot = (statics.x0 - com) @ r.T + com
    s2, diag = pt.elastic_step(dataclasses.replace(state, pos=rot), statics,
                               params, ep, grid, cfg)
    s3, _ = pt.elastic_step(
        dataclasses.replace(state, pos=statics.x0 * torch.tensor(
            [1.01, 1.0, 1.0])), statics, params, ep, grid, cfg)
    vrot, vstretch = float(s2.vel.abs().max()), float(s3.vel.abs().max())
    assert vrot < 1e-3 * vstretch, (vrot, vstretch)
    assert float(diag.elastic_energy) < 1e-8


def test_uniform_stretch_matches_analytic_stvk(port_bar):
    cfg, params, state, statics, grid, ep, sp = port_bar
    eps = 0.03
    s = dataclasses.replace(state, pos=statics.x0 * torch.tensor(
        [1.0 + eps, 1.0, 1.0]))
    raw = elastic_cuda.f_gradient_sweep(statics, s.pos, params, grid, cfg)
    f = torch.bmm(statics.vol * raw.reshape(statics.n, 3, 3), statics.corr)
    f_ref = np.diag([1.0 + eps, 1.0, 1.0])
    assert np.abs(f.numpy() - f_ref).max() < 1e-3
    e_ref = 0.5 * (f_ref.T @ f_ref - np.eye(3))
    mu, lam = float(ep.mu), float(ep.lam)
    psi = mu * (e_ref * e_ref).sum() + 0.5 * lam * np.trace(e_ref) ** 2
    s2, diag = pt.elastic_step(s, statics, params, ep, grid, cfg)
    u_ref = psi * float(statics.vol) * statics.n
    assert abs(float(diag.elastic_energy) - u_ref) < 1e-2 * u_ref
    x0c = statics.x0[:, 0]
    face = x0c > x0c.max() - 0.4 * sp
    assert bool(face.any())
    assert float(s2.vel[face, 0].mean()) < 0.0
