"""Triangle-mesh geometry: OBJ boundaries and rigid bodies (PyTorch port
of ``nereus_tpu.mesh``).

Load a triangle mesh, sample its surface with Akinci boundary spheres, and
either bake it into a static :class:`~nereus_tpu_torch.state.BoundaryData`
(tanks, terrain, obstacles) or build a dynamic
:class:`~nereus_tpu_torch.rigid.RigidBody` with the exact polyhedral mass
properties (volume, center of mass and inertia tensor from
signed-tetrahedron integrals, the divergence-theorem method).

The mesh work is a one-time host precompute in NumPy, as the box samplers'
is; the sampled particles then ride the device machinery
(``build_boundary``, ``RigidBody``), built on the CUDA device unless the
caller names another.
"""

from __future__ import annotations

import numpy as np
import torch

from .params import KernelSet, SimParams, resolve_device

__all__ = ["load_obj", "sample_surface", "mesh_mass_properties",
           "mesh_boundary", "make_rigid_mesh"]


def load_obj(path: str):
    """Minimal Wavefront OBJ reader: ``v`` and ``f`` records only
    (``vt``/``vn``/materials ignored; ``f`` entries may be ``i``,
    ``i/j``, ``i//k`` or ``i/j/k``; polygons are fan-triangulated;
    negative indices are relative per the spec).

    Returns ``(verts (V, 3) float64, faces (F, 3) int64)``.
    """
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = []
                for w in t[1:]:
                    i = int(w.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"OBJ face index out of range ({path})")
    return v, f


def sample_surface(verts, faces, radius):
    """Sample a triangle mesh's surface with boundary spheres at lattice
    spacing ``2·radius`` (the spacing ``boundary.sample_box`` uses on box
    faces).

    Per triangle: vertices + edge subdivisions + an in-plane 2-D lattice
    over the interior, then a global voxel dedup at half spacing so
    shared edges/overlapping lattices don't double-sample. Sampling
    UNIFORMITY is not required — Akinci ψ = ρ₀/ΣW (``compute_vbi``)
    calibrates each sample's volume to its actual local sample density,
    which is the entire point of that construction
    (use sites ``sph_kernel_impl.cuh:349,573``).

    Returns (M, 3) float64 points lying exactly on the surface.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    s = 2.0 * float(radius)
    pts = [verts[np.unique(faces.reshape(-1))]]

    # unique edges, subdivided at spacing s
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                        faces[:, [2, 0]]], axis=0)
    e = np.unique(np.sort(e, axis=1), axis=0)
    a, b = verts[e[:, 0]], verts[e[:, 1]]
    L = np.linalg.norm(b - a, axis=1)
    for i in np.nonzero(L > s)[0]:
        n = int(np.floor(L[i] / s))
        t = (np.arange(1, n + 1) / (n + 1))[:, None]
        pts.append(a[i] * (1.0 - t) + b[i] * t)

    # triangle interiors: an axis-aligned lattice in each triangle's
    # own plane (orthonormal basis from the longest edge), barycentric
    # inside-test with a small inset so edge samples stay the edges' job
    for f in faces:
        v0, v1, v2 = verts[f[0]], verts[f[1]], verts[f[2]]
        e1, e2 = v1 - v0, v2 - v0
        nrm = np.cross(e1, e2)
        a2 = np.linalg.norm(nrm)
        if a2 < 1e-30:
            continue                      # degenerate triangle
        t1 = e1 / np.linalg.norm(e1)
        t2 = np.cross(nrm / a2, t1)
        p = np.stack([(e1 @ t1, e1 @ t2), (e2 @ t1, e2 @ t2)])  # 2-D verts
        lo = np.minimum(0.0, p.min(axis=0))
        hi = np.maximum(0.0, p.max(axis=0))
        us = np.arange(lo[0] + s, hi[0], s)
        vs = np.arange(lo[1] + s, hi[1], s)
        if us.size == 0 or vs.size == 0:
            continue
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        q = np.stack([uu.reshape(-1), vv.reshape(-1)], axis=1)
        # barycentric in the 2-D chart
        det = p[0, 0] * p[1, 1] - p[0, 1] * p[1, 0]
        w1 = (q[:, 0] * p[1, 1] - q[:, 1] * p[1, 0]) / det
        w2 = (q[:, 1] * p[0, 0] - q[:, 0] * p[0, 1]) / det
        # inset ~s/4 of physical distance from each edge (barycentric wᵢ
        # maps to distance wᵢ·2A/|opposite edge|; a2 = |e1×e2| = 2A) —
        # edge/vertex samples own the rim, so any positive inset is safe
        # (the voxel dedup catches stragglers either way)
        q4 = 0.25 * s / a2
        keep = ((w1 > q4 * np.linalg.norm(e2))
                & (w2 > q4 * np.linalg.norm(e1))
                & (w1 + w2 < 1.0 - q4 * np.linalg.norm(e2 - e1)))
        if keep.any():
            w1, w2 = w1[keep], w2[keep]
            pts.append(v0 + w1[:, None] * e1 + w2[:, None] * e2)

    pts = np.concatenate(pts, axis=0)
    # voxel dedup at s/2: one representative point per half-spacing cell
    vox = np.round(pts / (0.5 * s)).astype(np.int64)
    _, idx = np.unique(vox, axis=0, return_index=True)
    return pts[np.sort(idx)]


def mesh_mass_properties(verts, faces, density: float = 1.0):
    """Exact mass properties of a closed triangle mesh by signed-
    tetrahedron integrals (each face forms a tet with the origin;
    divergence-theorem accounting makes concavities and holes-in-solids
    exact as long as the surface is closed and consistently oriented).

    For the tet (0, a, b, c) with d = det[a b c]:
    ``V = d/6``, ``∫x dV = d·(a+b+c)/24``, and with M = [a b c],
    ``∫ x xᵀ dV = (d/120)·(M Mᵀ + s sᵀ)`` where ``s = a+b+c`` (from the
    canonical-tet moments ∫uᵢuⱼ = (1+δᵢⱼ)/120). A globally inward-wound
    mesh yields V < 0 and is corrected by an overall sign flip.

    Returns ``(mass, com (3,), inertia_com (3, 3))``.
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    d = np.einsum("ij,ij->i", a, np.cross(b, c))          # per-face det
    vol = d.sum() / 6.0
    if abs(vol) < 1e-30:
        raise ValueError("mesh encloses no volume (open or degenerate)")
    sgn = 1.0 if vol > 0 else -1.0
    vol *= sgn
    d *= sgn
    s = a + b + c
    com = (d[:, None] * s).sum(axis=0) / (24.0 * vol)
    # C = ∫ x xᵀ dV about the ORIGIN
    C = (np.einsum("i,ij,ik->jk", d, a, a)
         + np.einsum("i,ij,ik->jk", d, b, b)
         + np.einsum("i,ij,ik->jk", d, c, c)
         + np.einsum("i,ij,ik->jk", d, s, s)) / 120.0
    # shift to the com, then I = ρ·(tr(C)·1 − C)
    C -= vol * np.outer(com, com)
    inertia = float(density) * (np.trace(C) * np.eye(3) - C)
    mass = float(density) * vol
    return mass, com, inertia


def mesh_boundary(grid, verts, faces, radius, params: SimParams,
                  kernel_set: KernelSet = KernelSet.MULLER,
                  dtype=torch.float32, device=None):
    """Sample a mesh surface and bake a static
    :class:`~nereus_tpu_torch.state.BoundaryData` (tank, terrain,
    obstacle) on ``device`` (default: the CUDA device): the mesh analogue
    of :func:`~nereus_tpu_torch.boundary.box_boundary`. The caller's grid
    must cover the mesh (``fit_grid`` with margin)."""
    from .boundary import build_boundary, compute_vbi

    pts = sample_surface(verts, faces, radius)
    vbi = compute_vbi(pts, float(params.interaction_radius), kernel_set)
    return build_boundary(grid, pts, vbi, float(params.rest_density),
                          dtype=dtype, device=device)


def make_rigid_mesh(verts, faces, radius, body_density, params: SimParams,
                    kernel_set: KernelSet = KernelSet.MULLER,
                    scale: float = 1.0, offset=(0.0, 0.0, 0.0),
                    dtype=torch.float32, device=None):
    """A dynamic :class:`~nereus_tpu_torch.rigid.RigidBody` from a closed
    triangle mesh, at rest, on ``device`` (default: the CUDA device): the
    Akinci shell from :func:`sample_surface`, mass, com and inertia from
    :func:`mesh_mass_properties` (the mesh analogue of
    ``make_rigid_box``'s analytic box).

    ``scale`` and ``offset`` place the mesh in the scene (applied to the
    vertices before everything else); ψ uses the fluid's rest density, as
    every Akinci shell does. The coupled steps take it as any body."""
    from .boundary import compute_vbi
    from .rigid import RigidBody

    device = resolve_device(device)
    verts = np.asarray(verts, np.float64) * float(scale) \
        + np.asarray(offset, np.float64)
    mass, com, inertia = mesh_mass_properties(verts, faces,
                                              float(body_density))
    pts = sample_surface(verts, faces, radius)
    vbi = compute_vbi(pts, float(params.interaction_radius), kernel_set)
    psi = float(params.rest_density) * vbi

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=dtype, device=device)

    return RigidBody(
        offsets=t(pts - com), psi=t(psi), mass=t(mass),
        inertia_body=t(inertia), com=t(com), R=t(np.eye(3)),
        vel=t(np.zeros(3)), omega=t(np.zeros(3)))
