"""PyTorch port vs the JAX package: parameters, packed parameter vector,
smoothing kernels (float32, to the ulp or rtol 1e-6), and the hash / sort
/ row-range neighbor structure (bit-exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import grid as jgrid
from nereus_tpu import kernels as JK
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu.params import calibrate_mass as j_calibrate_mass

import nereus_tpu_torch as pt
from nereus_tpu_torch import grid as pgrid
from nereus_tpu_torch import kernels as PK
from nereus_tpu_torch.ops import sph_pairs as SP

from torch_bridge import MODEL_IDS, MODELS, jax_scene, to_port

torch.set_num_threads(1)

# the JAX package's parameter sets, as make_params overrides
PARAM_SETS = {
    "make_params": {},
    "iisph_params": dict(viscosity=0.01, surface_tension=0.01,
                         interaction_radius=0.0537, beta=1050.0,
                         mass_factor=0.5),
    "pcisph_params": dict(viscosity=0.005, surface_tension=0.0001,
                          interaction_radius=0.0537, beta=650.0,
                          mass_factor=1.0),
}


def _fields(p):
    return {f.name: np.asarray(getattr(p, f.name))
            for f in dataclasses.fields(p)}


def _port_fields(p):
    return {f.name: getattr(p, f.name).numpy()
            for f in dataclasses.fields(p)}


@pytest.mark.parametrize("name", sorted(PARAM_SETS))
def test_params_match_jax(name):
    want = _fields(getattr(jt, name)())
    got = _port_fields(pt.make_params(**PARAM_SETS[name], device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=1)


@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_calibrate_mass_matches_jax(kernel_set):
    jcfg = jt.SimConfig(kernel_set=jt.KernelSet[kernel_set])
    pcfg = pt.SimConfig(kernel_set=pt.KernelSet[kernel_set])
    want = j_calibrate_mass(jt.pcisph_params(), jcfg).particle_mass
    got = pt.calibrate_mass(pt.make_params(**PARAM_SETS["pcisph_params"],
                                           device="cpu"),
                            pcfg).particle_mass
    np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want),
                                    maxulp=1)


@pytest.mark.parametrize("kernel_set,st", MODELS, ids=MODEL_IDS)
def test_build_pvec_matches_jax(kernel_set, st):
    cfg, params, state, grid, boundary = jax_scene(True, kernel_set, st)
    pcfg, pparams, _, pg, _ = to_port(cfg, params, state, grid, boundary)
    want = np.asarray(PS.build_pvec(params, cfg, grid))
    got = SP.build_pvec(pparams, pcfg, pg).numpy()
    # the port's vector is JAX's with PBF's ε appended (read by the λ
    # kernel's epilogue)
    assert got.shape == (SP.PV_LEN,) == (len(want) + 1,)
    np.testing.assert_array_max_ulp(got[:SP.PV_PBF_EPS], want, maxulp=1)
    assert got[SP.PV_PBF_EPS] == np.float32(cfg.pbf_eps)


KERNEL_FNS = {
    "w_poly6": lambda K, r, p: K.w_poly6(r, p.interaction_radius, p.kpoly),
    "w_poly6_grad": lambda K, r, p: K.w_poly6_grad(
        r, p.interaction_radius, p.kpoly_grad),
    "w_spiky_grad": lambda K, r, p: K.w_spiky_grad(
        r, p.interaction_radius, p.kpress_grad),
    "w_viscosity_grad": lambda K, r, p: K.w_viscosity_grad(
        r, p.interaction_radius, p.kvisc_grad, p.kvisc_denum),
    "w_monaghan": lambda K, r, p: K.w_monaghan(r, p.interaction_radius),
    "w_monaghan_grad": lambda K, r, p: K.w_monaghan_grad(
        r, p.interaction_radius),
    "c_akinci": lambda K, r, p: K.c_akinci(
        r, p.interaction_radius, p.ksurf1, p.ksurf2),
    "a_boundary": lambda K, r, p: K.a_boundary(
        r, p.interaction_radius, p.bpol),
}


@pytest.mark.parametrize("name", sorted(KERNEL_FNS))
def test_kernels_match_jax(name):
    h = 0.0457
    rng = np.random.default_rng(1)
    r = rng.uniform(-1.3 * h, 1.3 * h, (2000, 3)).astype(np.float32)
    r[0] = 0.0                     # the self pair
    fn = KERNEL_FNS[name]
    want = np.asarray(fn(JK, jnp.asarray(r), jt.make_params()))
    got = fn(PK, torch.from_numpy(r), pt.make_params(device="cpu")).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if name == "a_boundary":
        # A = bpol·arg^(1/4), arg = −4|r|²/h + 6|r| − 2h: terms of size
        # ~6h cancel near the roots, and XLA contracts them into FMAs, so
        # arg itself agrees to a few float32 ulp of 6h, not relatively
        bpol = float(jt.make_params().bpol)
        np.testing.assert_allclose((got / bpol) ** 4, (want / bpol) ** 4,
                                   rtol=1e-6,
                                   atol=4 * np.finfo(np.float32).eps * 6 * h)
        return
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("with_boundary", [False, True])
def test_scene_matches_jax(with_boundary):
    """The port's own dam_break builds the same arrays as the JAX one."""
    from nereus_tpu_torch import scene as pscene
    cfg, params, state, grid, boundary = jax_scene(with_boundary)
    pcfg, pparams, _, _, _ = to_port(cfg, params, state, grid, boundary)
    ps, pg, pb = pscene.dam_break(
        pparams, pcfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=with_boundary, boundary_radius=0.04, device="cpu")
    np.testing.assert_array_equal(ps.pos.numpy(), np.asarray(state.pos))
    assert int(ps.num_active) == int(state.num_active)
    assert pg.size == grid.size
    np.testing.assert_array_equal(pg.origin.numpy(), np.asarray(grid.origin))
    np.testing.assert_array_equal(pg.cell.numpy(), np.asarray(grid.cell))
    if with_boundary:
        for f in ("pos", "psi", "sorted_hash"):
            np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                          np.asarray(getattr(boundary, f)))
    else:
        assert pb is None and boundary is None


def test_resting_block_matches_jax():
    from nereus_tpu import scene as jscene
    from nereus_tpu_torch import scene as pscene
    jcfg, pcfg = jt.SimConfig(), pt.SimConfig()
    js, jg, jb = jscene.resting_block(jt.make_params(), jcfg, n_target=500,
                                      impact_velocity=-0.5)
    ps, pg, pb = pscene.resting_block(pt.make_params(device="cpu"), pcfg,
                                      n_target=500, impact_velocity=-0.5,
                                      device="cpu")
    np.testing.assert_array_equal(ps.pos.numpy(), np.asarray(js.pos))
    np.testing.assert_array_equal(ps.vel.numpy(), np.asarray(js.vel))
    assert pg.size == jg.size
    for f in ("pos", "psi", "sorted_hash"):
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)))


def test_hash_sort_row_segments_exact():
    """Hashes, stable sort order and the 9 row ranges are bit-identical,
    including parked slots (hash INT32_MAX, sorted to the tail)."""
    _, _, state, grid, _ = jax_scene(False)
    n = int(state.num_active)
    pos = np.asarray(state.pos)
    jstate = jt.make_fluid_state(pos, capacity=n + 37)
    pstate = pt.make_fluid_state(pos, capacity=n + 37, device="cpu")
    pg = pgrid.make_grid(np.asarray(grid.origin), grid.size,
                         np.asarray(grid.cell), device="cpu")

    jh = jgrid.hash_positions(grid, jstate.pos, jstate.active_mask())
    ph = pgrid.hash_positions(pg, pstate.pos, pstate.active_mask())
    assert ph.dtype == torch.int32
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    assert (ph.numpy()[n:] == pgrid.INT32_MAX).all()

    jsh, jperm, (jpos,) = jgrid.sort_by_hash(jh, jstate.pos,
                                             return_perm=True)
    psh, pperm, (ppos,) = pgrid.sort_by_hash(ph, pstate.pos,
                                             return_perm=True)
    np.testing.assert_array_equal(psh.numpy(), np.asarray(jsh))
    np.testing.assert_array_equal(pperm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(ppos.numpy(), np.asarray(jpos))

    jc = jgrid.cell_coords(grid, jpos)
    pc = pgrid.cell_coords(pg, ppos)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        torch.stack(pgrid.cell_coords_cols(pg, *ppos.unbind(1)), 1).numpy(),
        np.asarray(jc))
    js, je = jgrid.row_segments(grid, jsh, jc)
    ps, pe = pgrid.row_segments(pg, psh, pc)
    assert ps.dtype == torch.int32 and ps.shape == (9, n + 37)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    # every active query's ranges hold itself
    own = torch.arange(n + 37, dtype=torch.int32)[None]
    assert ((ps <= own) & (own < pe)).any(0)[:n].all()
