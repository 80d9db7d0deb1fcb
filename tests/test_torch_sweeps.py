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
    p_dens = SP.density_sweep(pcfg, *ctx.density_operands(
        pparams.particle_mass))
    d = torch.from_numpy(dens.copy())
    ds = d.clamp(min=1e-12)
    pd2 = pt.tait_pressure(d, pparams) / (ds * ds)
    p_force = SP.fluid_force_sweep(pcfg, *ctx.force_operands(vel, d, pd2))
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


# (include_pressure, include_viscosity, moving walls) of the force switches
SWITCHES = [(True, True, False), (True, False, False), (False, True, False),
            (False, False, False), (False, True, True)]


@pytest.mark.parametrize("include_pressure,include_viscosity,moving",
                         SWITCHES)
def test_force_switches_match_jax(exact_reciprocal, include_pressure,
                                  include_viscosity, moving):
    """The force sweep's pressure and viscosity switches, on static and
    moving walls, on the port's one matrix (the queries ``x y z v ρ pd2``
    are its fluid rows) against JAX's ``fluid_force_sweep`` in interpret
    mode fed the same density: max|Δf| ≤ 1e-5·max|f| per column."""
    from nereus_tpu_torch import boundary as PB
    from nereus_tpu_torch.solvers.wcsph import tait_pd2
    from torch_bridge import assert_columns_close
    cfg, params, state, grid, walls = jax_scene(True, floor=-0.115)
    if moving:
        walls = jt.move_boundary(walls, grid,
                                 velocity=jnp.asarray([0.8, 0.0, -0.4]))
    ctx = build_pallas_ctx(state, params, grid, cfg, walls)
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
    kw = dict(include_pressure=include_pressure,
              include_viscosity=include_viscosity, moving_boundary=moving)
    want = PS.fluid_force_sweep(
        cfg, ctx.queries(*vel, dens, pd2), ctx.update_rows(src_d, 6, [dens]),
        ctx.anchors, ctx.pvec, ctx.gsize, n_rows=ctx.n_rows, interpret=True,
        **kw)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    pctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    assert pctx.moving_boundary == moving and pctx.seg_start.shape[0] == 18
    d = torch.from_numpy(np.asarray(dens)[:c].copy())
    args = pctx.force_operands((pctx.vx, pctx.vy, pctx.vz), d,
                               tait_pd2(d, pparams))
    assert args[0].data_ptr() == args[1].data_ptr()
    got = SP.fluid_force_sweep(pcfg, *args, **kw)
    assert_columns_close(got.numpy(), np.asarray(want)[:c], 1e-5, str(kw))


def _recomputed_pd2_pair(q, s, pv, **kw):
    """The force pair of the earlier contract: pd2_j recomputed from ρ_j in
    slot 6 by the Tait EOS, whatever slot 7 holds."""
    s = s.clone()
    dens_j = torch.clamp(s[:, 6], min=1e-12)
    ratio = dens_j * (1.0 / pv[SP.PV_RD])
    ratio2 = ratio * ratio
    p_j = pv[SP.PV_K] * (ratio2 * ratio2 * ratio2 * ratio - 1.0)
    inv = 1.0 / dens_j
    s[:, 7] = p_j * inv * inv
    return SP.fluid_force_pair(q, s, pv, **kw)


@pytest.mark.parametrize("kernel_set,st", MODELS, ids=MODEL_IDS)
def test_force_pd2_slot_equals_recomputed(kernel_set, st):
    """The force twin reading pd2_j from slot 7 (``wcsph.tait_pd2``, the
    step's column) against the twin that recomputes it from ρ_j per pair:
    equal bit for bit (the column is the recomputation's operation
    order), on the scene's wall and fluid rows."""
    from nereus_tpu_torch.ops.neighbors import neighbor_sweep_plain
    from nereus_tpu_torch.solvers.wcsph import tait_pd2
    pcfg, pparams, pstate, pg, pb = to_port(
        *jax_scene(True, kernel_set, st, floor=-0.115))
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    dens = SP.density_sweep(pcfg, *ctx.density_operands(
        pparams.particle_mass))
    args = ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens,
                              tait_pd2(dens, pparams))
    got = SP.fluid_force_sweep(pcfg, *args)
    q, src, s, e, pv = args

    def pair(qq, ss):
        return _recomputed_pd2_pair(
            qq, ss, pv, kernel_set=pcfg.kernel_set,
            st_model=pcfg.surface_tension_model)

    def pair_b(qq, ss):
        return SP.boundary_force_pair(qq, ss, pv, kernel_set=pcfg.kernel_set)
    want = neighbor_sweep_plain(pair, q, src, s, e, 3, pair_fn_b=pair_b)
    assert float(want.abs().max()) > 0.0
    assert torch.equal(got, want)
    # the step's pressure column (Tait p / ρ² by division) differs from it
    # by rounding only
    ds = dens.clamp(min=1e-12)
    torch.testing.assert_close(tait_pd2(dens, pparams),
                               pt.tait_pressure(dens, pparams) / (ds * ds),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kernel_set", [jt.KernelSet.MULLER,
                                        jt.KernelSet.MONAGHAN])
def test_body_density_matches_jax(kernel_set):
    """A body shell's ψ-density, the density sweep over its ``x y z ψ_b``
    rows (9 range rows), against JAX's ``density_pair`` summed over every
    (query, sample) pair of the shell's 8-wide rows (ψ_b in slot 6): rtol
    1e-5."""
    from nereus_tpu_torch.solvers import coupled_cuda
    from torch_bridge import dense_pairs
    cfg, params, state, grid, walls = jax_scene(True, kernel_set,
                                                floor=-0.115)
    pcfg, pparams, pstate, pg, pb = to_port(cfg, params, state, grid, walls)
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    box = pt.make_rigid_box(pstate.pos.mean(dim=0), (0.08,) * 3,
                            float(pparams.particle_radius), 500.0, pparams,
                            device="cpu")
    (sh,) = coupled_cuda.body_shells(ctx, pg, (box,))
    q4 = ctx.density_operands(pparams.particle_mass)[0]
    got = SP.body_density_sweep(pcfg, q4, sh.src4, sh.seg_start, sh.seg_end,
                                ctx.pvec)
    want = dense_pairs(PS.density_pair, q4, sh.src,
                       PS.build_pvec(params, cfg, grid),
                       kernel_set=kernel_set)[:, 0]
    assert (want > 0).sum() > 10
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_boundary", [False, True])
def test_sweep_operands_are_one_matrix(with_boundary):
    """Each sweep's operands on one matrix: the density's ``x y z m`` fluid
    rows then the walls' ``x y z ψ_b``, its queries the first C rows; the
    force's query rows ``x y z v ρ pd2`` then the walls as they are, the
    matrix itself without walls; PCISPH's x* written once, into both."""
    from nereus_tpu_torch.solvers import pcisph_cuda
    pcfg, pparams, pstate, pg, pb = to_port(*jax_scene(with_boundary))
    ctx = build_sweep_ctx(pstate, pparams, pg, pcfg, pb)
    c, pm = ctx.c, pparams.particle_mass
    q, src = ctx.density_operands(pm)[:2]
    assert q.data_ptr() == src.data_ptr() and q.shape == (c, 4)
    pos = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    assert torch.equal(src[:c, :3], pos) and bool((src[:c, 3] == pm).all())
    nb = 0 if pb is None else pb.num_boundaries
    assert src.shape == (c + nb, 4)
    if nb:
        assert torch.equal(src[c:], ctx.b_src[:, [0, 1, 2, 6]])
    dens = torch.rand(c) + 900.0
    pd2 = torch.rand(c)
    fq, fsrc = ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens, pd2)[:2]
    assert (fq is fsrc) == (nb == 0) and fq.data_ptr() == fsrc.data_ptr()
    assert torch.equal(fq, torch.stack([ctx.px, ctx.py, ctx.pz, ctx.vx,
                                        ctx.vy, ctx.vz, dens, pd2], dim=1))
    if nb:
        assert torch.equal(fsrc[c:], ctx.b_src)
    x = pos + 0.01
    pq, psrc = pcisph_cuda.predicted_density_operands(ctx, pm)(x)[:2]
    assert pq.data_ptr() == psrc.data_ptr() and torch.equal(pq[:, :3], x)
