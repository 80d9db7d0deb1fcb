"""The port's triangle-mesh geometry vs the JAX package, mirroring
``tests/test_mesh.py`` (its CLI test waits for the CLI's port): OBJ
parsing, exact polyhedral mass properties and surface sampling equal to
JAX's on the same inputs (the same NumPy arithmetic), a mesh boundary equal
to JAX's and holding a settling fluid block (the port's WCSPH step, plain
sweeps), and a mesh rigid body with the analytic box's mass properties
driving the coupled steps."""

import numpy as np
import pytest
import torch

import nereus_tpu as jt

import nereus_tpu_torch as pt
from nereus_tpu_torch import scene as pscene

from test_mesh import box_mesh
from torch_bridge import params_to_port

torch.set_num_threads(1)

OBJ = """# comment
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vt 0 0
vn 0 0 1
f 1 2 3 4
f 1/1 2/1 3/1
f -4//1 -3//1 -2//1
"""


def test_load_obj(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(OBJ)
    v, f = pt.load_obj(str(p))
    assert v.shape == (4, 3) and f.shape == (4, 3)
    np.testing.assert_array_equal(f, [[0, 1, 2], [0, 2, 3], [0, 1, 2],
                                      [0, 1, 2]])
    jv, jf = jt.load_obj(str(p))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    p.write_text("v 0 0 0\nf 1 2 3\n")
    with pytest.raises(ValueError, match="out of range"):
        pt.load_obj(str(p))


def test_mesh_mass_properties_box():
    """The analytic box for both windings, at an offset from the origin,
    and JAX's result exactly."""
    lo, hi = np.array([1.0, -2.0, 3.0]), np.array([1.5, -0.8, 3.7])
    size = hi - lo
    v, f = box_mesh(lo, hi)
    rho = 250.0
    m, com, inertia = pt.mesh_mass_properties(v, f, rho)
    m_ref = rho * size.prod()
    i_ref = (m_ref / 12.0) * np.diag([size[1]**2 + size[2]**2,
                                      size[0]**2 + size[2]**2,
                                      size[0]**2 + size[1]**2])
    assert m == pytest.approx(m_ref, rel=1e-12)
    np.testing.assert_allclose(com, (lo + hi) / 2, rtol=0, atol=1e-12)
    np.testing.assert_allclose(inertia, i_ref, rtol=1e-10,
                               atol=1e-12 * np.abs(i_ref).max())
    m2, _, i2 = pt.mesh_mass_properties(v, f[:, ::-1], rho)
    assert m2 == pytest.approx(m, rel=1e-12)
    np.testing.assert_allclose(i2, inertia, rtol=1e-12,
                               atol=1e-12 * np.abs(inertia).max())
    jm, jcom, ji = jt.mesh_mass_properties(v, f, rho)
    assert m == jm
    np.testing.assert_array_equal(com, jcom)
    np.testing.assert_array_equal(inertia, ji)
    flat = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    with pytest.raises(ValueError, match="no volume"):
        pt.mesh_mass_properties(flat, np.array([[0, 1, 2]]), rho)


def test_mesh_mass_properties_compound():
    """Two disjoint boxes in one mesh: masses add, the com is mass
    weighted."""
    v1, f1 = box_mesh((0, 0, 0), (1, 1, 1))
    v2, f2 = box_mesh((3, 0, 0), (4, 2, 1))
    v = np.concatenate([v1, v2])
    f = np.concatenate([f1, f2 + len(v1)])
    m, com, _ = pt.mesh_mass_properties(v, f, 1.0)
    assert m == pytest.approx(3.0, rel=1e-12)
    np.testing.assert_allclose(
        com, (np.array([0.5, 0.5, 0.5]) + 2.0 * np.array([3.5, 1.0, 0.5]))
        / 3.0, atol=1e-12)


def test_sample_surface_box():
    """Every sample on the surface, no two closer than 0.3 spacing, the
    count of the order of area/s², no face empty, no gap over 1.2·s; and
    the same points as JAX's sampler."""
    radius = 0.02
    s = 2 * radius
    lo, hi = np.zeros(3), np.array([0.4, 0.3, 0.5])
    v, f = box_mesh(lo, hi)
    pts = pt.sample_surface(v, f, radius)
    np.testing.assert_array_equal(pts, jt.sample_surface(v, f, radius))
    d_face = np.minimum(np.abs(pts - lo), np.abs(pts - hi)).min(axis=1)
    assert d_face.max() < 1e-9
    assert ((pts > lo - 1e-9) & (pts < hi + 1e-9)).all()
    dd = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    np.fill_diagonal(dd, 1e9)
    assert dd.min() > 0.3 * s
    area = 2 * ((hi - lo)[[0, 1]].prod() + (hi - lo)[[1, 2]].prod()
                + (hi - lo)[[0, 2]].prod())
    assert 0.5 * area / s**2 < len(pts) < 2.5 * area / s**2
    for axis in range(3):
        for val in (lo[axis], hi[axis]):
            assert (np.abs(pts[:, axis] - val) < 1e-9).sum() > 10
    probe = pt.sample_surface(v, f, radius / 3)
    dmin = np.array([np.linalg.norm(pts - q, axis=1).min() for q in probe])
    assert dmin.max() < 1.2 * s


def test_mesh_boundary_matches_jax_and_holds_fluid():
    """A tank sampled from a triangle mesh equals JAX's (positions, ψ and
    sorted hashes) and holds a settling fluid block moving down at 1 m/s:
    150 WCSPH steps, nothing through the floor or out of the tank."""
    cfg = pt.SimConfig()
    params = pt.calibrate_mass(pt.make_params(device="cpu"), cfg)
    h = float(params.interaction_radius)
    r = float(params.particle_radius)
    lo, hi = np.zeros(3), np.array([0.5, 0.8, 0.5])
    v, f = box_mesh(lo, hi)
    grid = pt.fit_grid(lo - h, hi + h, h, device="cpu")
    walls = pt.mesh_boundary(grid, v, f, r, params, device="cpu")
    assert walls.num_boundaries > 1000
    jparams = jt.make_params()
    jwalls = jt.mesh_boundary(jt.fit_grid(lo - h, hi + h, h), v, f, r,
                              jparams)
    np.testing.assert_array_equal(walls.sorted_hash.numpy(),
                                  np.asarray(jwalls.sorted_hash))
    np.testing.assert_allclose(walls.pos.numpy(), np.asarray(jwalls.pos),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(walls.psi.numpy(), np.asarray(jwalls.psi),
                               rtol=1e-6)
    pos = pscene.particle_cube((0.25, 0.12, 0.25), (0.16,) * 3, 2 * r)
    state = pt.make_fluid_state(
        pos, velocities=np.tile([0.0, -1.0, 0.0], (len(pos), 1)),
        device="cpu")
    for i in range(150):
        state, diag = pt.wcsph_step(state, params, grid, cfg, walls)
        assert int(diag.seg_overflow) == 0, i
    p = state.pos.numpy()
    assert np.isfinite(p).all()
    assert p[:, 1].min() > 0.0, "fluid fell through the mesh floor"
    assert (p > lo - 2 * r).all() and (p < hi + 2 * r).all()


def test_make_rigid_mesh_matches_box():
    """A body built from a box mesh has the analytic box's mass, com and
    inertia, a shell of comparable size, JAX's fields (rtol 1e-6), and
    drives the coupled WCSPH and DFSPH steps to finite states."""
    cfg = pt.SimConfig()
    jparams = jt.make_params()
    params = pt.calibrate_mass(params_to_port(jparams), cfg)
    r = float(params.particle_radius)
    center, size, rho = np.array([0.25, 0.4, 0.25]), 0.08, 200.0
    v, f = box_mesh(center - size / 2, center + size / 2)
    mb = pt.make_rigid_mesh(v, f, r, rho, params, device="cpu")
    bb = pt.make_rigid_box(center, (size,) * 3, r, rho, params,
                           device="cpu")
    assert float(mb.mass) == pytest.approx(float(bb.mass), rel=1e-5)
    np.testing.assert_allclose(mb.com.numpy(), center, atol=1e-6)
    ib = bb.inertia_body.numpy()
    np.testing.assert_allclose(mb.inertia_body.numpy(), ib, rtol=1e-4,
                               atol=1e-6 * np.abs(ib).max())
    assert 0.5 * bb.num_samples < mb.num_samples < 2.0 * bb.num_samples
    jb = jt.make_rigid_mesh(v, f, r, rho, jparams, scale=1.0)
    for name in ("offsets", "psi", "mass", "inertia_body", "com", "R", "vel",
                 "omega"):
        np.testing.assert_allclose(getattr(mb, name).numpy(),
                                   np.asarray(getattr(jb, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    moved = pt.make_rigid_mesh(v, f, r, rho, params, scale=2.0,
                               offset=(0.1, 0.0, 0.0), device="cpu")
    np.testing.assert_allclose(moved.com.numpy(),
                               2.0 * center + [0.1, 0.0, 0.0], atol=1e-6)
    h = float(params.interaction_radius)
    lo, hi = np.zeros(3), np.array([0.5, 0.8, 0.5])
    grid = pt.fit_grid(lo - h, hi + h, h, device="cpu")
    walls = pt.mesh_boundary(grid, *box_mesh(lo, hi), r, params,
                             device="cpu")
    fluid = pscene.particle_cube((0.25, 0.15, 0.25), (0.2,) * 3, 2 * r)
    for step in (pt.wcsph_coupled_step, pt.dfsph_coupled_step):
        state = pt.make_fluid_state(fluid, device="cpu")
        body = mb
        for _ in range(5):
            state, body, diag = step(state, params, grid, cfg, body, walls)
            assert int(diag.seg_overflow) == 0
        assert bool(torch.isfinite(state.pos).all())
        assert bool(torch.isfinite(body.com).all())
        assert bool(torch.isfinite(body.vel).all())
