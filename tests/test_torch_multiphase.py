"""The port's multiphase WCSPH step and its two sweeps vs the JAX package
(CPU, plain sweeps), on ``tests/test_multiphase.py``'s two-layer tank.

* The multiphase density and force plain sweeps against interpret-mode
  ``generic_sweep`` with ``multiphase_density_pair``/``_bpair`` and
  ``multiphase_force_pair``/``multiphase_boundary_pair`` on the same
  sorted operands, walls in contact, both kernel sets × {NONE, BECKER with
  st_cross = 0.25}: max|Δ| ≤ 1e-5·max|ref| per output column (float32 sums
  in another order; the JAX force pair's approximate reciprocal replaced
  by the exact one, ``exact_reciprocal``).
* ``wcsph_step`` on a multiphase state against JAX's Pallas (interpret)
  and segment steps over two steps, in sorted order (``canon``):
  positions atol 1e-6, velocities atol 1e-4, mass and ρ₀ equal, the
  tolerances of ``test_multiphase.py::test_multiphase_engines_match``.
* Mirrors of ``test_multiphase.py``: uniform phase columns with BECKER
  reproduce the port's single-phase step (10 steps, positions atol 1e-6,
  velocities atol 1e-4), and the light-on-heavy tank stays stratified
  over 400 steps; plus parked slots and the JAX step's refusals.
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
from nereus_tpu.params import calibrate_mass
from nereus_tpu.scene import particle_cube
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import wcsph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from test_multiphase import two_layer
from torch_bridge import assert_columns_close, exact_reciprocal, to_port

torch.set_num_threads(1)

ST = jt.SurfaceTensionModel
# (kernel set, surface-tension model, st_cross) of the sweep comparisons
SWEEP_CASES = [(ks, st, x) for ks in (jt.KernelSet.MULLER,
                                      jt.KernelSet.MONAGHAN)
               for st, x in ((ST.NONE, 0.0), (ST.BECKER, 0.25))]
SWEEP_IDS = [f"{ks.name.lower()}-{st.name.lower()}"
             for ks, st, _ in SWEEP_CASES]


@pytest.fixture(scope="module")
def contact():
    """``two_layer(vel_y=-1, side_cells=4)`` (128 particles in two phases,
    ρ₀ ratio 1 : 0.4) settled with the JAX segment step until the floor
    lies inside h of the lowest particle, as
    ``test_multiphase_engines_match`` settles it: the boundary density
    column, the wall penalty and the friction are all live."""
    state, params, grid, walls, _ = two_layer(vel_y=-1.0, side_cells=4)
    n = int(state.num_active)
    h = float(params.interaction_radius)
    cfg = jt.SimConfig(engine="segments", surface_tension_model=ST.NONE)
    step = jax.jit(lambda s: jt.wcsph_step(s, params, grid, cfg, walls))
    for _ in range(40):
        state, _ = step(state)
        if float(np.asarray(state.pos)[:n, 1].min()) < 0.85 * h:
            break
    assert float(np.asarray(state.pos)[:n, 1].min()) < h, \
        "scene never reached wall contact"
    return state, params, grid, walls


def _cfg(kernel_set, st, st_cross, engine="pallas"):
    return jt.SimConfig(engine=engine, kernel_set=kernel_set,
                        surface_tension_model=st, st_cross=st_cross)


def _jax_sweeps(cfg, params, state, grid, boundary):
    """``_wcsph_pallas_multiphase``'s two sweeps in interpret mode:
    ``(dout, acc, qcols, wcols)`` with the force sweep's query and wide
    source columns (JAX's padded length)."""
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    kw = dict(n_rows=ctx.n_rows, interpret=True)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dout = PS.generic_sweep(cfg, PS.multiphase_density_pair,
                            ctx.queries(width=4), ctx.pack(vel=vel), *geo,
                            out_width=4,
                            pair_fn_b=PS.multiphase_density_bpair, **kw)
    mass, rho0 = ctx.mass, ctx.rho0
    delta = dout[:, 0]
    dens = mass * delta + (rho0 / params.rest_density) * dout[:, 1]
    pres = jt.tait_pressure(dens, params, rho0)
    vol = 1.0 / jnp.maximum(delta, 1e-12)
    pv2 = pres * vol * vol
    qcols = [*vel, pv2, 1.0 / mass, mass, 1.0 / jnp.maximum(dens, 1e-12)]
    wcols = [*vel, vol, pv2]
    st_becker = cfg.surface_tension_model == ST.BECKER
    if st_becker:
        qcols.append(rho0)
        wcols.append(rho0)
    acc = PS.generic_sweep(cfg, PS.multiphase_force_pair,
                           ctx.queries(*qcols), ctx.pack_wide(wcols, rows=16),
                           *geo, out_width=4,
                           pair_fn_b=PS.multiphase_boundary_pair,
                           pair_b_kw={"moving": False}, st_becker=st_becker,
                           **kw)
    return dout, acc, jnp.stack(qcols, 1), jnp.stack(wcols, 1)


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_one_matrix_density_operands_match_jax(contact, kernel_set):
    """``wcsph_cuda.multiphase_density_operands``: one (C + Mb, 4) matrix,
    its first C rows the queries (a view), fluid rows ``x y z 0``, then the
    walls ``x y z ψ_b``; its x y z are JAX's ``q4`` (``wcsph_pallas.py:156``)
    in the same sorted order, its wall rows the samples JAX's ``src_d``
    carries (their positions and ψ_b), and the sweep on it gives JAX's
    ``generic_sweep`` on ``q4`` / ``src_d`` within 1e-5·max|ref| per
    column, the wall column live."""
    state, params, grid, walls = contact
    cfg = _cfg(kernel_set, ST.NONE, 0.0)

    def jax_operands(s):
        ctx = build_pallas_ctx(s, params, grid, cfg, walls)
        return ctx.queries(width=4)

    q4 = np.asarray(jax.jit(jax_operands)(state))
    dout = jax.jit(lambda s: _jax_sweeps(cfg, params, s, grid, walls)[0])(
        state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    q, src, s, e, pv = wcsph_cuda.multiphase_density_operands(ctx)
    mb = walls.num_boundaries
    assert src.shape == (n + mb, 4) and q.shape == (n, 4)
    assert q.data_ptr() == src.data_ptr()
    np.testing.assert_array_equal(q[:, :3].numpy(), q4[:n, :3])
    assert float(q[:, 3].abs().max()) == 0.0
    wall_rows = np.concatenate([np.asarray(walls.pos),
                                np.asarray(walls.psi)[:, None]], axis=1)
    np.testing.assert_array_equal(src[n:].numpy(), wall_rows)
    got = SP.multiphase_density_sweep(pcfg, q, src, s, e, pv)
    assert_columns_close(got.numpy(), np.asarray(dout)[:n, :2], 1e-5,
                         "density")
    assert float(got[:, 1].abs().max()) > 0.0


@pytest.mark.parametrize("kernel_set,st,st_cross", SWEEP_CASES,
                         ids=SWEEP_IDS)
def test_multiphase_sweeps_match_jax(exact_reciprocal, contact, kernel_set,
                                     st, st_cross):
    state, params, grid, walls = contact
    cfg = _cfg(kernel_set, st, st_cross)
    dout, acc, qcols, wcols = jax.jit(lambda s: _jax_sweeps(
        cfg, params, s, grid, walls))(state)
    n = state.capacity
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert ctx.seg_start.shape[0] == 18
    got = SP.multiphase_density_sweep(
        pcfg, *wcsph_cuda.multiphase_density_operands(ctx))
    assert_columns_close(got.numpy(), np.asarray(dout)[:n, :2], 1e-5,
                         "density")
    # the force sweep on JAX's own operand columns, laid out as the port's
    # one matrix (its first n rows the queries)
    qc = torch.from_numpy(np.asarray(qcols)[:n].copy())
    wc = torch.from_numpy(np.asarray(wcols)[:n].copy())
    # both packages sort stably by the same hash, phase columns with it
    assert torch.equal(qc[:, 0], ctx.vx) and torch.equal(qc[:, 5], ctx.mass)
    rho0 = qc[:, 7] if st == ST.BECKER else ctx.rho0
    src = ctx.pack_wide([*qc[:, :3].unbind(1), wc[:, 3], wc[:, 4], rho0,
                         *qc[:, 4:7].unbind(1)])
    q = src[:n]
    got = SP.multiphase_force_sweep(pcfg, q, src, ctx.seg_start,
                                    ctx.seg_end, ctx.pvec)
    assert_columns_close(got.numpy(), np.asarray(acc)[:n, :3], 1e-5,
                         "force")
    # the boundary rows are live in both sweeps
    fluid_only = SP.multiphase_force_sweep(pcfg, q, src, ctx.seg_start[:9],
                                           ctx.seg_end[:9], ctx.pvec)
    assert not torch.equal(fluid_only, got)


@pytest.mark.parametrize("solver", ["wcsph", "dfsph"])
def test_multiphase_step_without_walls(contact, solver):
    """A multiphase step with no walls, as ``boundary=None`` and as a
    boundary set of no rows: the force sweep's one matrix is its query
    itself, and both steps give the same finite state."""
    state, params, grid, _ = contact
    cfg = _cfg(jt.KernelSet.MULLER, ST.BECKER, 0.25)
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    empty = pt.BoundaryData(pos=torch.zeros((0, 3)), psi=torch.zeros(0),
                            sorted_hash=torch.zeros(0, dtype=torch.int32))
    step = pt.wcsph_step if solver == "wcsph" else pt.dfsph_step
    outs = []
    for walls in (None, empty):
        ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, walls)
        assert ctx.b_src is None and ctx.seg_start.shape[0] == 9
        dout = SP.multiphase_density_sweep(
            pcfg, *wcsph_cuda.multiphase_density_operands(ctx))
        args = wcsph_cuda.multiphase_force_operands(ctx, pparams, dout)[0]
        assert args[0] is args[1]
        assert args[0].shape == (ctx.c, SP.WIDE_WIDTH)
        s, _ = step(pstate, pparams, pg, pcfg, walls)
        assert np.isfinite(s.pos.numpy()).all()
        assert np.isfinite(s.vel.numpy()).all()
        outs.append(s)
    assert torch.equal(outs[0].pos, outs[1].pos)
    assert torch.equal(outs[0].vel, outs[1].vel)


def canon(state, n):
    """Positions, velocities, mass and ρ₀ of the first ``n`` slots in one
    canonical (lexicographic position) order, from either package."""
    p, v, m, r = (np.asarray(getattr(state, f))[:n]
                  for f in ("pos", "vel", "mass", "rho0"))
    order = np.lexsort((p[:, 2], p[:, 1], p[:, 0]))
    return p[order], v[order], m[order], r[order]


@pytest.mark.parametrize("kernel_set,st,st_cross", [
    (jt.KernelSet.MULLER, ST.BECKER, 0.25),
    (jt.KernelSet.MONAGHAN, ST.NONE, 0.0)], ids=["muller-becker",
                                                 "monaghan-none"])
def test_multiphase_step_matches_jax(exact_reciprocal, contact, kernel_set,
                                     st, st_cross):
    """Two steps from the wall-contacting state: the second from JAX's
    Pallas state after the first."""
    state, params, grid, walls = contact
    n = int(state.num_active)
    steps = {engine: jax.jit(lambda s, c=_cfg(kernel_set, st, st_cross,
                                                engine): jt.wcsph_step(
        s, params, grid, c, walls)) for engine in ("pallas", "segments")}
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(
            _cfg(kernel_set, st, st_cross), params, state, grid, walls)
        s_port, d_port = pt.wcsph_step(pstate, pparams, pg, pcfg, pb)
        po, vo, mo, ro = canon(s_port, n)
        refs = {name: fn(state) for name, fn in steps.items()}
        for name, (s_ref, d_ref) in refs.items():
            pr, vr, mr, rr = canon(s_ref, n)
            msg = f"{name} step {step}"
            np.testing.assert_allclose(po, pr, rtol=0, atol=1e-6,
                                       err_msg=msg)
            np.testing.assert_allclose(vo, vr, rtol=0, atol=1e-4,
                                       err_msg=msg)
            np.testing.assert_array_equal(mo, mr, err_msg=msg)
            np.testing.assert_array_equal(ro, rr, err_msg=msg)
            np.testing.assert_allclose(float(d_port.mean_density_error),
                                       float(d_ref.mean_density_error),
                                       rtol=1e-5, err_msg=msg)
            np.testing.assert_allclose(float(d_port.max_density),
                                       float(d_ref.max_density), rtol=1e-5,
                                       err_msg=msg)
        state = refs["pallas"][0]


def test_multiphase_becker_reduces_to_single_phase():
    """``test_multiphase.py::test_multiphase_becker_reduces_to_single_phase``
    on the port: uniform phase columns with BECKER (κ_eff = κ for every
    pair at any st_cross) reproduce the single-phase BECKER step over 10
    free-fall and contact steps."""
    base = jt.make_params()
    sp = 0.8 * float(base.interaction_radius)
    cfg = jt.SimConfig(engine="segments", st_cross=0.3,
                       surface_tension_model=ST.BECKER)
    params = calibrate_mass(base, cfg, spacing=sp)
    pm = float(params.particle_mass)
    rd = float(params.rest_density)
    h = float(params.interaction_radius)
    side = 5 * sp
    pos = particle_cube((side / 2 + 2 * sp,) * 3, (side,) * 3, sp)
    n = len(pos)
    lo = np.zeros(3)
    hi = np.array([side + 4 * sp, 2.5 * side, side + 4 * sp])
    grid = jt.fit_grid(lo - h, hi + h, h)
    walls = box_boundary(grid, lo, hi, float(params.particle_radius),
                         params)
    pcfg, pparams, s1, pg, pb = to_port(cfg, params,
                                        jt.make_fluid_state(pos), grid,
                                        walls)
    s2 = to_port(cfg, params, jt.make_fluid_state(
        pos, masses=pm, rest_densities=rd), grid, walls)[2]
    assert s2.multiphase and not s1.multiphase
    for _ in range(10):
        s1, _ = pt.wcsph_step(s1, pparams, pg, pcfg, pb)
        s2, _ = pt.wcsph_step(s2, pparams, pg, pcfg, pb)
    np.testing.assert_allclose(s2.pos.numpy()[:n], s1.pos.numpy()[:n],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(s2.vel.numpy()[:n], s1.vel.numpy()[:n],
                               rtol=0, atol=1e-4)


def test_multiphase_stratified_stays_stratified():
    """``test_multiphase.py::test_multiphase_stratified_stays_stratified``
    on the port: 400 steps of the light-on-heavy tank keep the phases
    ordered, in the tank, and the compression-side error (against each
    particle's own ρ₀) below 0.2."""
    state, params, grid, walls, pm = two_layer()
    cfg = jt.SimConfig(engine="segments", surface_tension_model=ST.NONE)
    pcfg, pparams, s, pg, pb = to_port(cfg, params, state, grid, walls)
    n = int(state.num_active)
    for _ in range(400):
        s, diag = pt.wcsph_step(s, pparams, pg, pcfg, pb)
        assert int(diag.seg_overflow) == 0
    p = s.pos.numpy()[:n]
    heavy = s.mass.numpy()[:n] > 0.5 * pm
    assert np.isfinite(p).all()
    assert p[:, 1].min() > 0.0, "fluid fell through the floor"
    assert p[heavy, 1].mean() < p[~heavy, 1].mean(), \
        "stable stratification overturned"
    assert float(diag.mean_compression) < 0.2


def test_multiphase_parked_slots_stay_parked():
    """Slots past the live count (parked at 1e9, the first particle's
    phase) stay parked and finite, and the live particles finite."""
    state, params, grid, walls, _ = two_layer(side_cells=3)
    n = int(state.num_active)
    padded = jt.make_fluid_state(np.asarray(state.pos)[:n],
                                 np.asarray(state.vel)[:n], capacity=n + 32,
                                 masses=np.asarray(state.mass)[:n],
                                 rest_densities=np.asarray(state.rho0)[:n])
    pcfg, pparams, s, pg, pb = to_port(jt.SimConfig(), params, padded, grid,
                                       walls)
    for _ in range(3):
        s, _ = pt.wcsph_step(s, pparams, pg, pcfg, pb)
    assert np.all(s.pos.numpy()[n:] == np.float32(1e9))
    assert np.isfinite(s.pos.numpy()).all()
    assert np.isfinite(s.vel.numpy()).all()


def test_multiphase_refusals():
    """The JAX multiphase step's refusals, with its reasons: XSPH, implicit
    viscosity, AKINCI surface tension."""
    state, params, grid, walls, _ = two_layer(side_cells=3)
    pcfg, pparams, s, pg, pb = to_port(jt.SimConfig(), params, state, grid,
                                       walls)
    cases = [
        (pcfg, 0.1, "XSPH is single-phase-only"),
        (dataclasses.replace(pcfg, viscosity_model="implicit"), None,
         "implicit viscosity is single-phase-only"),
        (dataclasses.replace(
            pcfg, surface_tension_model=pt.SurfaceTensionModel.AKINCI),
         None, "AKINCI surface tension is single-phase-only"),
    ]
    for c, eps, reason in cases:
        with pytest.raises(NotImplementedError, match=reason):
            pt.wcsph_step(s, pparams, pg, c, pb, xsph_eps=eps)
    # the sweep itself refuses AKINCI before any launch
    ctx = build_sweep_ctx(s, pparams, pg, pcfg, pb)
    dout = SP.multiphase_density_sweep(
        pcfg, *wcsph_cuda.multiphase_density_operands(ctx))
    args, _, _ = wcsph_cuda.multiphase_force_operands(ctx, pparams, dout)
    with pytest.raises(ValueError, match="AKINCI"):
        SP.multiphase_force_sweep(cases[2][0], *args)
