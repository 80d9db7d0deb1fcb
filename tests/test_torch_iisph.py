"""The port's IISPH step and its sweeps vs the JAX package (CPU, plain
sweeps).

* Each plain IISPH sweep, and the pressure-off force sweep, against
  ``generic_sweep`` / ``fluid_force_sweep`` in interpret mode, fed the
  same sorted operands of one IISPH step: max|Δ| ≤ 1e-5·max|ref| per
  output column (float32 sums in another order: windows on one side,
  per-row ``index_add_`` on the other), each on the step's own operand
  builders (``iisph_cuda.dii_aii_operands``, ``sum_dij_operands``,
  ``jacobi_operands``); the fused d_ii, ρ_adv and a_ii sweep also in the
  CUDA kernel's formulation (its three sums over one walk, then its
  epilogue), with static and with moving walls.
* The Jacobi twin on its e-source against the reference's per-pair order
  (1e-6·max|ref|), and the step's Σd_ij·p_j matrix as the pressure
  force's query.
* ``iisph_step`` against ``iisph_step_pallas`` (interpret) and the jnp
  segment step, with the tolerances of ``tests/test_pallas_implicit.py``
  (positions atol 1e-6, velocities atol 2e-5, mean density error rtol
  2e-3 / atol 2e-5) and an equal iteration count.
* Port mirrors of the JAX package's convergence-predicate, resting-block
  and 10-step stability tests, each with JAX's iteration count.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import grid as jgrid
from nereus_tpu import scene as jscene
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass as j_calibrate_mass
from nereus_tpu.solvers.iisph_pallas import iisph_step_pallas
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch import boundary as pboundary
from nereus_tpu_torch import convert
from nereus_tpu_torch import grid as pgrid
from nereus_tpu_torch import scene as pscene
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import iisph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import MODEL_IDS, MODELS, to_port

torch.set_num_threads(1)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """Interpret mode evaluates the force pair's ``pl.reciprocal(approx=
    True)`` with a ~4e-3 relative error; hold both sides to the exact
    division the port uses (``tests/test_torch_sweeps.py``)."""
    monkeypatch.setattr(PS, "_fast_recip", lambda x: 1.0 / x)


def _implicit_scene(with_boundary, kernel_set=jt.KernelSet.MULLER,
                    st=jt.SurfaceTensionModel.BECKER, floor=-0.3,
                    seed=None, calibrated=False):
    """The ``tests/test_pallas_implicit.py`` IISPH dam-break (cube 0.25,
    boundary radius 0.04, dt 5e-4). With ``seed``: seeded velocities in
    [−0.5, 0.5) m/s and a seeded previous pressure in [0, 2000) Pa, so
    every sweep of the step, the warm start included, sees non-zero
    operands. ``calibrated`` sets the mass so the seeding lattice sums to
    ρ₀: the raw mass leaves the cube under-dense, and the solve then ends
    at zero pressure."""
    cfg = jt.SimConfig(seg_window=48, kernel_set=kernel_set,
                       surface_tension_model=st)
    params = jt.iisph_params(dt=5e-4)
    if calibrated:
        params = j_calibrate_mass(
            params, cfg, spacing=float(params.interaction_radius) - 0.005)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.25, 0.25, 0.25),
        cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, floor, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=with_boundary, boundary_radius=0.04)
    if seed is not None:
        rng = np.random.default_rng(seed)
        pos = np.asarray(state.pos)
        vel = rng.uniform(-0.5, 0.5, pos.shape).astype(np.float32)
        state = dataclasses.replace(
            jt.make_fluid_state(pos, vel),
            pressure=jnp.asarray(rng.uniform(0.0, 2000.0, pos.shape[0]),
                                 jnp.float32))
    return cfg, params, state, grid, boundary


# ---------------------------------------------------------------------------
# Each IISPH sweep against JAX's interpret-mode sweep
# ---------------------------------------------------------------------------

def _jax_sweeps(cfg, params, state, grid, boundary, pre_loop=False):
    """The sweeps of ``iisph_step_pallas`` on one state (jitted), with
    p = ½·p_prev for the pressure-dependent ones; returns every sweep's
    output and the intermediate operands, sliced to the capacity. With
    ``pre_loop``, only the density, d_ii + ρ_adv and a_ii, on v_adv = v
    (no advection force)."""
    out = jax.jit(lambda s: _jax_sweep_chain(cfg, params, s, grid,
                                             boundary, pre_loop))(state)
    return {k: np.asarray(v)[:state.capacity] for k, v in out.items()}


def _jax_sweep_chain(cfg, params, state, grid, boundary, pre_loop=False):
    ctx = build_pallas_ctx(state, params, grid, cfg, boundary)
    c = ctx.c
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm = params.particle_mass
    dt = params.dt
    geo = (ctx.anchors, ctx.pvec, ctx.gsize)
    kw = dict(n_rows=ctx.n_rows, interpret=True)
    q4 = ctx.queries(width=4)
    psi = jnp.full((c,), 1.0, ctx.dtype) * pm
    dens = PS.density_sweep(cfg, q4, ctx.pack(slot6=psi), *geo, **kw)
    ds = jnp.maximum(dens, 1e-12)
    inv_d2 = 1.0 / (ds * ds)
    if pre_loop:
        vel_adv = vel
    else:
        f_adv = PS.fluid_force_sweep(
            cfg, ctx.queries(*vel, dens, jnp.zeros((ctx.cb,), ctx.dtype)),
            ctx.pack(vel=vel, slot6=dens), *geo, include_pressure=False,
            **kw)
        vel_adv = tuple(v + (dt / pm) * (f_adv[:, k]
                                         + pm * params.gravity[k])
                        for k, v in enumerate(vel))
    src_p = ctx.pack(vel=vel_adv, slot6=psi)
    pr = PS.generic_sweep(cfg, PS.dii_rhoadv_pair,
                          ctx.queries(*vel_adv, *vel, inv_d2, width=12),
                          src_p, *geo, out_width=4, vel_q_offset=3,
                          pair_fn_b=PS.dii_rhoadv_pair,
                          pair_b_kw=dict(vel_q_offset=6), **kw)
    dii = tuple(pr[:, k] for k in range(3))
    dpi = pm * inv_d2
    aii = PS.generic_sweep(cfg, PS.aii_pair,
                           ctx.queries(*dii, dpi, width=8), src_p, *geo,
                           out_width=1, **kw)
    if pre_loop:
        return dict(dens=dens, vel_adv=jnp.stack(vel_adv, 1), pr=pr,
                    aii=aii[:, 0])
    p = 0.5 * ctx.pres_prev
    pd2 = p * inv_d2
    sum_dij = PS.generic_sweep(cfg, PS.sum_dij_pair, q4,
                               ctx.pack(slot6=pd2), ctx.anchors_f,
                               ctx.pvec, ctx.gsize, out_width=4,
                               n_rows=ctx.rows_local, interpret=True)[:, :3]
    sd = tuple(sum_dij[:, k] for k in range(3))
    fb = PS.generic_sweep(cfg, PS.jacobi_fluid_pair,
                          ctx.queries(*sd, dpi * p, width=8),
                          ctx.pack_wide([*dii, p, *sd], rows=16), *geo,
                          out_width=1, pair_fn_b=PS.jacobi_boundary_pair,
                          **kw)
    f_p = PS.generic_sweep(cfg, PS.grad_pressure_force_pair,
                           ctx.queries(pd2), ctx.pack(slot6=pd2), *geo,
                           out_width=4, boundary=False,
                           pair_fn_b=PS.grad_pressure_force_pair,
                           pair_b_kw=dict(boundary=True, boundary_sign=-1.0),
                           **kw)
    return dict(dens=dens, f_adv=f_adv[:, :3], vel_adv=jnp.stack(vel_adv, 1),
                pr=pr, aii=aii[:, 0], p=p, sum_dij=sum_dij, fb=fb[:, 0],
                f_p=f_p[:, :3])


def _fused_pair(q, s, pv, *, kernel_set, vel_q_offset):
    """The pair of the fused d_ii, ρ_adv and a_ii kernel
    (``csrc/iisph_sweep.cu::DiiAii``) on its one 12-wide matrix: ψ·s·r⃗,
    ψ·s²·r² and ψ·s·(v_q − v_j)·r⃗ (``vel_q_offset`` 3: v_adv, fluid rows;
    7: the pre-advection v, wall rows), masked by the cutoff where the
    kernel skips the pair. Returns (P, 5)."""
    dx, dy, dz, r2, sg, okf = SP._default_grad(q, s, pv, kernel_set)
    c = s[:, 6] * sg * okf
    o = vel_q_offset
    dv = ((q[:, o] - s[:, 3]) * dx + (q[:, o + 1] - s[:, 4]) * dy
          + (q[:, o + 2] - s[:, 5]) * dz)
    return torch.stack([c * dx, c * dy, c * dz, c * sg * r2, c * dv], dim=1)


def _fused_dii_aii(cfg, q, src, seg_start, seg_end, pv):
    """The fused kernel's formulation in torch: its five sums S = Σψ·s·r⃗,
    T = Σψ·s²·r², R = Σψ·s·(v_q − v_j)·r⃗ over one walk, then its
    epilogue d_ii = −(1/ρ²)·S, Δρ_adv = dt·R, a_ii = d_ii·S − (m/ρ²)·T.
    Returns (N, 5) d_ii xyz, Δρ_adv, a_ii."""
    from nereus_tpu_torch.ops.neighbors import neighbor_sweep_plain
    sums = neighbor_sweep_plain(
        SP._bind(_fused_pair, cfg, pv, vel_q_offset=3), q, src, seg_start,
        seg_end, 5, pair_fn_b=SP._bind(_fused_pair, cfg, pv,
                                       vel_q_offset=7))
    inv = q[:, 10]
    dii = -inv[:, None] * sums[:, :3]
    aii = (dii * sums[:, :3]).sum(dim=1) - (pv[SP.PV_PM] * inv) * sums[:, 3]
    return torch.cat([dii, (pv[SP.PV_DT] * sums[:, 4])[:, None],
                      aii[:, None]], dim=1)


def _port_sweeps(pcfg, pparams, pstate, pgrid_, pbnd, ref):
    """The port's dispatchers on the same sorted operands, each fed the
    JAX side's upstream results so that every sweep is held on its own;
    only the pre-loop sweeps where ``ref`` has no pressure."""
    ctx = build_sweep_ctx(pstate, pparams, pgrid_, pcfg, pbnd)
    t = {k: torch.from_numpy(v.copy()) for k, v in ref.items()}
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm = pparams.particle_mass
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    dargs = ctx.density_operands(pm)
    dens = t["dens"]
    ds = dens.clamp(min=1e-12)
    inv_d2 = 1.0 / (ds * ds)
    zero = torch.zeros_like(dens)
    got = {"dens": SP.density_sweep(pcfg, *dargs)}
    if "f_adv" in t:
        got["f_adv"] = SP.fluid_force_sweep(
            pcfg, *ctx.force_operands(vel, dens, zero),
            include_pressure=False)
    vel_adv = t["vel_adv"].unbind(1)
    dargs = iisph_cuda.dii_aii_operands(ctx, vel_adv, pm, inv_d2)
    da = SP.dii_aii_sweep(pcfg, *dargs)
    got["pr"], got["aii"] = da[:, :4], da[:, 4]
    got["dii_aii_fused"] = _fused_dii_aii(pcfg, *dargs)
    if "p" not in t:
        return {k: v.numpy() for k, v in got.items()}, ctx.seg_start.shape[0]
    dpi = pm * inv_d2
    p = t["p"]
    torch.testing.assert_close(0.5 * ctx.pres_prev, p, rtol=0, atol=0)
    # the step's own operand builders (solvers/iisph_cuda.py)
    sum_dij_at = iisph_cuda.sum_dij_operands(ctx, inv_d2)
    got["sum_dij"] = SP.sum_dij_sweep(pcfg, *sum_dij_at(p))
    jacobi_at, jsrc = iisph_cuda.jacobi_operands(ctx, t["pr"][:, :3], dpi)
    got["fb"] = SP.jacobi_sweep(pcfg, *jacobi_at(p, t["sum_dij"]))
    pq = sum_dij_at(p)[0]
    got["f_p"] = SP.pressure_force_sweep(
        pcfg, pq, iisph_cuda.pressure_source(jsrc, pq), *rng)
    return {k: v.numpy() for k, v in got.items()}, ctx.seg_start.shape[0]


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set,st", MODELS[:2], ids=MODEL_IDS[:2])
def test_iisph_sweeps_match_jax(exact_reciprocal, kernel_set, st,
                                with_boundary):
    # floor 0.04 under the bottom layer: the boundary rows are live
    scene = _implicit_scene(with_boundary, kernel_set, st, floor=-0.115,
                            seed=1)
    ref = _jax_sweeps(*scene)
    got, rows = _port_sweeps(*to_port(*scene), ref)
    assert rows == (18 if with_boundary else 9)
    _assert_columns_match(got, ref)


def _assert_columns_match(got, ref):
    """Each output column of the port's sweeps within 1e-5·max|ref| of
    JAX's, finite, and not all zero; the fused formulation against JAX's
    d_ii + ρ_adv and a_ii sweeps."""
    ref = {**ref, "dii_aii_fused": np.concatenate(
        [ref["pr"], ref["aii"][:, None]], axis=1)}
    for name, g in got.items():
        want = ref[name].reshape(len(ref[name]), -1)
        g = g.reshape(len(g), -1)
        assert np.isfinite(g).all(), name
        for col in range(want.shape[1]):
            scale = np.abs(want[:, col]).max()
            assert scale > 0.0, (name, col)
            err = np.abs(g[:, col] - want[:, col]).max()
            assert err <= 1e-5 * scale, (name, col, err, scale)


@pytest.mark.parametrize("kernel_set,st", MODELS[:1], ids=MODEL_IDS[:1])
def test_iisph_sweeps_match_jax_moving_walls(exact_reciprocal, kernel_set,
                                             st):
    """``test_iisph_sweeps_match_jax``'s density and pre-loop sweeps (on
    v_adv = v, which the wall pairs do not read) with the walls moving at
    (0.8, 0, −0.4) m/s (``tests/test_moving_boundary.py``'s wall
    velocity): the wall rows' v_b enters ρ_adv's sum in both packages and
    in the fused formulation, whose wall pairs read the pre-advection v."""
    cfg, params, state, grid, boundary = _implicit_scene(
        True, kernel_set, st, floor=-0.115, seed=1)
    boundary = dataclasses.replace(boundary, vel=jnp.broadcast_to(
        jnp.asarray([0.8, 0.0, -0.4], jnp.float32), boundary.pos.shape))
    ref = _jax_sweeps(cfg, params, state, grid, boundary, pre_loop=True)
    got, rows = _port_sweeps(*to_port(cfg, params, state, grid, boundary),
                             ref)
    assert rows == 18 and sorted(got) == ["aii", "dens", "dii_aii_fused",
                                          "pr"]
    _assert_columns_match(got, ref)
    # the same on the walls at rest: only ρ_adv's sum moves with them
    still, _ = _port_sweeps(*to_port(cfg, params, state, grid, dataclasses
                                     .replace(boundary, vel=None)), ref)
    for name in ("pr", "dii_aii_fused"):
        np.testing.assert_array_equal(still[name][:, :3], got[name][:, :3])
        assert not np.array_equal(still[name][:, 3], got[name][:, 3])


def _reference_order_pair(q, s, pv, *, kernel_set):
    """The Jacobi fluid pair in the reference's order on its 12-wide rows
    (``pallas_sph.py::jacobi_fluid_pair``: d_jj in slots 3-5, p_j in 6,
    Σd_jk·p_k in 7-9): (Σd_ij·p_j − d_jj·p_j) − Σd_jk·p_k per pair."""
    dx, dy, dz, r2, sg, okf = SP._default_grad(q, s, pv, kernel_set)
    p_j = s[:, 6]
    ix = q[:, 3] - s[:, 3] * p_j - s[:, 7]
    iy = q[:, 4] - s[:, 4] * p_j - s[:, 8]
    iz = q[:, 5] - s[:, 5] * p_j - s[:, 9]
    inner = sg * (ix * dx + iy * dy + iz * dz) + q[:, 6] * sg * sg * r2
    return (pv[SP.PV_PM] * inner * okf)[:, None]


@pytest.mark.parametrize("kernel_set,st", MODELS[:2], ids=MODEL_IDS[:2])
def test_jacobi_e_source_matches_reference_order(kernel_set, st):
    """The Jacobi twin on the step's 8-wide source (e_j = d_jj·p_j +
    Σd_jk·p_k written once per iteration, sd_i − e_j per pair) against
    the reference's per-pair order on the 12-wide rows, on one step's
    operands with live walls and a real warm-start pressure: max|Δ| ≤
    1e-6·max|ref| (the same terms rounded in another order, measured
    0.8-1.7e-7 on this scene; the wall rows are the same formula on the
    same ψ_b)."""
    from nereus_tpu_torch.ops.neighbors import neighbor_sweep_plain
    pcfg, pparams, pstate, pg, pb = to_port(*_implicit_scene(
        True, kernel_set, st, floor=-0.115, seed=1, calibrated=True))
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    pm = pparams.particle_mass
    dens = SP.density_sweep(pcfg, *ctx.density_operands(pm))
    inv_d2 = 1.0 / dens.clamp(min=1e-12) ** 2
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dii = SP.dii_aii_sweep(pcfg, *iisph_cuda.dii_aii_operands(
        ctx, vel, pm, inv_d2))[:, :3]
    p = 0.5 * ctx.pres_prev
    sd = SP.sum_dij_sweep(pcfg, *iisph_cuda.sum_dij_operands(ctx, inv_d2)(p))
    q, src, s, e, pv = iisph_cuda.jacobi_operands(ctx, dii, pm * inv_d2)[0](
        p, sd)
    assert src.shape == (ctx.c + pb.num_boundaries, 8)
    got = SP.jacobi_sweep(pcfg, q, src, s, e, pv)
    wide = ctx.pack_wide([*dii.unbind(1), p, *sd.unbind(1)])
    want = neighbor_sweep_plain(
        SP._bind(_reference_order_pair, pcfg, pv), q, wide, s, e, 1,
        pair_fn_b=SP._bind(SP.jacobi_boundary_pair, pcfg, pv))[:, 0]
    walls = neighbor_sweep_plain(
        SP._bind(SP.jacobi_boundary_pair, pcfg, pv), q, src, s[9:], e[9:], 1)
    assert float(walls.abs().max()) > 0.0 and float(p.max()) > 0.0
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-6 * scale, (err, scale)


def test_sum_dij_matrix_is_the_pressure_query(monkeypatch):
    """In the step, Σd_ij·p_j reads one (C, 4) matrix ``x y z p/ρ²`` as its
    queries and source, the same storage in every iteration, and after the
    loop that matrix is the pressure force's query, its slot 3 the p/ρ²
    of the source's fluid rows; the Jacobi sum reads an 8-wide source
    whose wall rows are the step's ``x y z v_b ψ_b 0``, the same storage
    in every iteration, and after the loop that source is the pressure
    force's."""
    seen = {"sum_dij": [], "jacobi": [], "pressure": []}

    def record(name, sweep):
        def wrapped(cfg, q, src, *rest, **kw):
            seen[name].append((q, src, q.clone(), src.clone()))
            return sweep(cfg, q, src, *rest, **kw)
        return wrapped
    for name, attr in (("sum_dij", "sum_dij_sweep"),
                       ("jacobi", "jacobi_sweep"),
                       ("pressure", "pressure_force_sweep")):
        monkeypatch.setattr(SP, attr, record(name, getattr(SP, attr)))
    pcfg, pparams, pstate, pg, pb = to_port(*_implicit_scene(
        True, calibrated=True))
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    pt.iisph_step(pstate, pparams, pg, pcfg, pb)
    c = ctx.c
    pos = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    assert len(seen["sum_dij"]) == len(seen["jacobi"]) > 1
    (m, _, _, _), = seen["sum_dij"][:1]
    for q, src, qv, _ in seen["sum_dij"]:
        assert q is src and q.data_ptr() == m.data_ptr()
        assert q.shape == (c, 4) and torch.equal(qv[:, :3], pos)
    (pq, psrc, pqv, psrcv), = seen["pressure"]
    assert pq.data_ptr() == m.data_ptr() and pq.shape == (c, 4)
    assert torch.equal(pqv[:, 3], psrcv[:c, 6]) and float(pqv[:, 3].max()) > 0
    for q, src, _, srcv in seen["jacobi"]:
        assert q.shape == (c, 8) and src.shape == (c + pb.num_boundaries, 8)
        assert torch.equal(srcv[c:], ctx.b_src)
        assert src.data_ptr() == psrc.data_ptr()


@pytest.mark.parametrize("walls", ["none", "static", "moving"])
def test_step_reads_one_dii_aii_matrix(monkeypatch, walls):
    """The step runs d_ii, ρ_adv and a_ii as one sweep on one (C + Mb, 12)
    matrix, its queries the first C rows ``x y z v_adv m v 1/ρ² 0`` and
    its wall rows the step's ``x y z v_b ψ_b 0…``; the Jacobi operands
    take d_ii from that sweep's first three columns; its plain version
    gives the bits of the two sweeps it replaces, each on its own
    operands."""
    seen = {"dii_aii": [], "jacobi": []}
    sweep = SP.dii_aii_sweep

    def dii_aii(cfg, q, src, *rest):
        out = sweep(cfg, q, src, *rest)
        seen["dii_aii"].append((q, src, src.clone(), out))
        return out
    jacobi_operands = iisph_cuda.jacobi_operands

    def jacobi(ctx, dii, dpi):
        seen["jacobi"].append(dii)
        return jacobi_operands(ctx, dii, dpi)
    monkeypatch.setattr(SP, "dii_aii_sweep", dii_aii)
    monkeypatch.setattr(iisph_cuda, "jacobi_operands", jacobi)
    pcfg, pparams, pstate, pg, pb = to_port(*_implicit_scene(
        walls != "none", floor=-0.115, seed=1, calibrated=True))
    if walls == "moving":
        pb = dataclasses.replace(pb, vel=torch.tensor(
            [0.8, 0.0, -0.4]).expand_as(pb.pos).contiguous())
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    pt.iisph_step(pstate, pparams, pg, pcfg, pb)
    c, pm = ctx.c, pparams.particle_mass
    (q, m, src, out), = seen["dii_aii"]
    (dii,) = seen["jacobi"]
    mb = 0 if pb is None else pb.num_boundaries
    assert q.data_ptr() == m.data_ptr()
    assert q.shape == (c, 12) and src.shape == (c + mb, 12)
    assert torch.equal(q, src[:c])
    torch.testing.assert_close(
        src[:c, [0, 1, 2, 6, 7, 8, 9, 11]],
        torch.stack([ctx.px, ctx.py, ctx.pz, pm.expand(c), ctx.vx, ctx.vy,
                     ctx.vz, torch.zeros_like(ctx.px)], dim=1),
        rtol=0, atol=0)
    dens = SP.density_sweep(pcfg, *ctx.density_operands(pm))
    torch.testing.assert_close(src[:c, 10], 1.0 / dens.clamp(min=1e-12) ** 2,
                               rtol=0, atol=0)
    if mb:
        assert torch.equal(src[c:, :8], ctx.b_src)
        assert not src[c:, 8:].any()
        assert bool(src[c:, 3:6].any()) == (walls == "moving")
    assert out.shape == (c, 5) and torch.equal(dii, out[:, :3])
    assert float(out[:, 4].abs().max()) > 0.0
    # the parent's two sweeps on their own operands give the same bits
    vel_adv = src[:c, 3:6].unbind(1)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    src_p = ctx.pack(vel_adv, pm)
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    pr = SP.dii_rhoadv_sweep_plain(
        pcfg, ctx.queries(*vel_adv, *vel, src[:c, 10], width=12), src_p,
        *rng)
    aii = SP.aii_sweep_plain(pcfg, ctx.queries(
        *pr[:, :3].unbind(1), pm * src[:c, 10], width=8), src_p, *rng)
    assert torch.equal(out[:, :4], pr) and torch.equal(out[:, 4], aii)


# ---------------------------------------------------------------------------
# The step against iisph_step_pallas and the segment step
# ---------------------------------------------------------------------------

def _compare(s_port, d_port, s_ref, d_ref, n, name):
    """Both steps return hash-sorted state in the same stable order."""
    assert int(d_port.solver_iters) == int(d_ref.solver_iters), name
    np.testing.assert_allclose(s_port.pos.numpy()[:n],
                               np.asarray(s_ref.pos)[:n], rtol=0, atol=1e-6,
                               err_msg=name)
    np.testing.assert_allclose(s_port.vel.numpy()[:n],
                               np.asarray(s_ref.vel)[:n], rtol=0, atol=2e-5,
                               err_msg=name)
    np.testing.assert_allclose(float(d_port.mean_density_error),
                               float(d_ref.mean_density_error), rtol=2e-3,
                               atol=2e-5, err_msg=name)


def _jax_steps(cfg, params, grid, boundary):
    return {
        "pallas": jax.jit(lambda s: iisph_step_pallas(
            s, params, grid, cfg, boundary)),
        "segments": jax.jit(lambda s: jt.iisph_step(
            s, params, grid, cfg, boundary)),
    }


@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["raw-mass", "calibrated"])
def test_iisph_step_matches_jax(calibrated, with_boundary):
    """The ``test_pallas_implicit.py`` scene, as it is (raw mass: the cube
    is under-dense and the solve ends at zero pressure) and with its mass
    calibrated to the seeding lattice (the solve ends at a non-zero
    pressure): one step from rest, then a second step from JAX's own
    first-step state, whose ½·p_prev warm start runs on the pressure JAX
    carried (and, calibrated, differs from the same step started cold)."""
    cfg, params, state, grid, boundary = _implicit_scene(
        with_boundary, calibrated=calibrated)
    n = int(state.num_active)
    steps = _jax_steps(cfg, params, grid, boundary)
    for step in range(2):
        pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                                boundary)
        s_port, d_port = pt.iisph_step(pstate, pparams, pg, pcfg, pb)
        assert int(d_port.seg_overflow) == 0
        refs = {name: fn(state) for name, fn in steps.items()}
        for name, (s_ref, d_ref) in refs.items():
            assert int(d_ref.seg_overflow) == 0, name
            _compare(s_port, d_port, s_ref, d_ref, n, f"{name} step {step}")
        # no pressure comparison: ρ₀ − ρ_adv cancels to ~1e-5 of ρ₀ at
        # rest, so p is ill-conditioned in float32 (JAX's own two steps
        # disagree on p here) while the velocities agree
        carried = refs["pallas"][0]
        if step == 1 and calibrated:
            cold = dataclasses.replace(
                pstate, pressure=torch.zeros_like(pstate.pressure))
            assert not torch.equal(pt.iisph_step(cold, pparams, pg, pcfg,
                                                 pb)[0].vel, s_port.vel)
        state = carried
        assert (float(jnp.max(state.pressure)) > 0.0) == calibrated


# ---------------------------------------------------------------------------
# Mirrors of the JAX package's IISPH tests
# ---------------------------------------------------------------------------

def _lattice_block(scale, n_side=8):
    """``tests/test_iisph.py``'s cubic lattice at ``scale``× the rest
    spacing, for both packages."""
    params = jt.iisph_params(gravity=(0.0, 0.0, 0.0))
    h = float(params.interaction_radius)
    spacing = (float(params.particle_mass)
               / float(params.rest_density)) ** (1 / 3)
    ax = np.arange(n_side) * spacing * scale
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    pos = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], -1)
    grid = jgrid.fit_grid(pos.min(0) - h, pos.max(0) + h, h)
    state = jt.make_fluid_state(pos)
    return jt.SimConfig(), params, state, grid


def test_iisph_convergence_predicate_not_vacuous():
    """Over-dense block: past min-iters, ending within tol (0.1% of ρ₀) or
    at the cap. Under-dense: exactly min-iters with zero error. Both with
    JAX's iteration count."""
    tol = 1.0
    for scale, over in ((0.92, True), (1.3, False)):
        cfg, params, state, grid = _lattice_block(scale)
        _, d_ref = jt.iisph_step(state, params, grid, cfg, tol=tol)
        pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid,
                                               None)
        _, diag = pt.iisph_step(pstate, pparams, pg, pcfg, tol=tol)
        it = int(diag.solver_iters)
        err = float(diag.mean_density_error)
        assert it == int(d_ref.solver_iters), (scale, it)
        assert err >= 0.0
        if over:
            assert it > pcfg.iisph_min_iters, (it, err)
            assert err <= tol / float(pparams.rest_density) or \
                it == pcfg.iisph_max_iters, (it, err)
        else:
            assert it == pcfg.iisph_min_iters
            assert err <= tol / float(pparams.rest_density)


def test_resting_block_exercises_real_solve():
    """The settled scene of the 1M path at n_target 1500, built by the
    port's own ``resting_block``: past min-iters from step 1, stable, and
    JAX's iteration count."""
    jcfg, pcfg = jt.SimConfig(), pt.SimConfig()
    spacing = 0.8 * float(jt.iisph_params().interaction_radius)
    jparams = j_calibrate_mass(jt.iisph_params(), jcfg, spacing=spacing)
    pparams = pt.calibrate_mass(pt.iisph_params(device="cpu"), pcfg,
                                spacing=spacing)
    js, jg, jb = jscene.resting_block(jparams, jcfg, n_target=1500,
                                      spacing=spacing)
    ps, pg, pb = pscene.resting_block(pparams, pcfg, n_target=1500,
                                      spacing=spacing, device="cpu")
    _, d_ref = jt.iisph_step(js, jparams, jg, jcfg, boundary=jb)
    state, diag = pt.iisph_step(ps, pparams, pg, pcfg, boundary=pb)
    assert int(diag.solver_iters) == int(d_ref.solver_iters)
    assert int(diag.solver_iters) > pcfg.iisph_min_iters
    assert np.isfinite(float(diag.mean_density_error))
    v = state.vel.numpy()[:int(state.num_active)]
    assert np.abs(v).max() < 5.0, np.abs(v).max()


def test_iisph_multi_step():
    """``test_pallas_implicit.py::test_iisph_pallas_multi_step``: 10 steps
    of the cube-0.2 dam-break with its boundary; finite, no overflow, and
    each step's iteration count equal to JAX's from the same state."""
    cfg = jt.SimConfig(seg_window=48)
    params = jt.iisph_params(dt=5e-4)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.2, 0.2, 0.2), cube_center=(-0.3, 0.0, 0.5),
        box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=True, boundary_radius=0.04)
    step = jax.jit(lambda s: jt.iisph_step(s, params, grid, cfg, boundary))
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    n = int(state.num_active)
    for _ in range(10):
        pstate, diag = pt.iisph_step(pstate, pparams, pg, pcfg, pb)
        state, d_ref = step(state)
        assert int(diag.solver_iters) == int(d_ref.solver_iters)
        assert int(diag.seg_overflow) == 0
    assert not np.isnan(float(diag.mean_density_error))
    assert np.isfinite(pstate.pos.numpy()[:n]).all()
    np.testing.assert_allclose(pstate.pos.numpy()[:n],
                               np.asarray(state.pos)[:n], rtol=0, atol=1e-5)


def test_unported_options_raise():
    cfg, params, state, grid, boundary = _implicit_scene(True)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid,
                                            boundary)
    multi = pt.make_fluid_state(pstate.pos.numpy(), masses=1.0,
                                rest_densities=1000.0, device="cpu")
    with pytest.raises(NotImplementedError, match="WCSPH-only"):
        pt.iisph_step(multi, pparams, pg, pcfg, pb)
    # the JAX IISPH step has no implicit viscosity stage
    # (test_torch_viscosity.py::test_iisph_refuses_implicit_viscosity)
    with pytest.raises(NotImplementedError,
                       match="IISPH has no implicit viscosity stage"):
        pt.iisph_step(pstate, pparams, pg,
                      dataclasses.replace(pcfg, viscosity_model="implicit"),
                      pb)
    # moving boundaries are ported (test_torch_moving_boundary.py): a wall
    # set at velocity 0, once refused, reproduces the static step
    s0, _ = pt.iisph_step(pstate, pparams, pg, pcfg, pb)
    s1, _ = pt.iisph_step(pstate, pparams, pg, pcfg,
                          dataclasses.replace(pb, vel=torch.zeros_like(pb.pos)))
    assert torch.equal(s0.pos, s1.pos) and torch.equal(s0.vel, s1.vel)


@pytest.mark.parametrize("sync_every", [1, 2, 3, 4])
def test_jacobi_loop_syncs_once_per_k_iterations(monkeypatch, sync_every):
    """The loop reads its condition on the host after every SYNC_EVERY-th
    launched iteration from min-iters on, launches at most SYNC_EVERY − 1
    iterations past the converged count, and freezes the carry in those:
    the result does not depend on SYNC_EVERY."""
    cfg, params, state, grid = _lattice_block(0.92)
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    s_1, d_1 = pt.iisph_step(pstate, pparams, pg, pcfg)
    monkeypatch.setattr(iisph_cuda, "SYNC_EVERY", sync_every)
    iisph_cuda.LOOP.reset()
    s_k, d_k = pt.iisph_step(pstate, pparams, pg, pcfg)
    it = int(d_k.solver_iters)
    launched = iisph_cuda.LOOP.launched
    assert it == int(d_1.solver_iters) > pcfg.iisph_min_iters
    assert torch.equal(s_k.pressure, s_1.pressure)
    assert torch.equal(s_k.vel, s_1.vel)
    assert it <= launched < it + sync_every
    checks = [m for m in range(1, launched + 1)
              if m >= pcfg.iisph_min_iters and m % sync_every == 0]
    assert iisph_cuda.LOOP.syncs == len(checks)
    assert checks[-1] == launched or launched == pcfg.iisph_max_iters


# ---------------------------------------------------------------------------
# Entry points build on the card unless asked otherwise
# ---------------------------------------------------------------------------

ENTRY_POINTS = [
    pt.make_params, pgrid.make_grid, pgrid.fit_grid, pt.make_fluid_state,
    pscene.resting_block, pscene.dam_break, pboundary.build_boundary,
    pboundary.box_boundary, convert.params_from_numpy,
    convert.state_from_numpy, convert.boundary_from_numpy,
    convert.grid_from_numpy,
]


def test_entry_points_default_to_the_card():
    for fn in ENTRY_POINTS:
        assert inspect.signature(fn).parameters["device"].default is None, \
            fn.__qualname__
    assert pt.params.resolve_device(None) == torch.device("cuda")
    assert pt.params.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert pt.make_params().dt.device.type == "cuda"
    else:
        # no probe and no fallback: torch's own error, not a CPU tensor
        with pytest.raises((AssertionError, RuntimeError)):
            pt.make_params()
