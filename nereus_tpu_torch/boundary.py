"""Akinci-2012 boundary particles (PyTorch port of ``nereus_tpu.boundary``).

* :func:`sample_box` — a lattice of spacing 2·radius over the six faces of
  an AABB, edges and corners deduplicated.
* :func:`compute_vbi` — per-sample volume V_bi = 1 / Σ_k W(b_i − b_k) over
  boundary neighbors within h; the solvers use ψ = ρ₀·V_bi.

Both are one-time host computations in float64 (the C++ pass of
``native/`` when a compiler is present, numpy otherwise); the result
moves to the device once, hash-sorted, in :func:`build_boundary`.

Prescribed rigid motion (a wavemaker, a rotating drum) runs on the
device: :func:`move_boundary` transforms the t = 0 set, gives it wall
velocities and re-sorts it by hash each step; :func:`rehash_boundary`
re-sorts a set against a refit grid.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from . import grid as gridlib
from .params import KernelSet, SimParams, resolve_device
from .state import BoundaryData


def _face_lattice(lo, hi, spacing):
    axes = []
    for a, b in zip(lo, hi):
        n = max(int(np.floor((b - a) / spacing + 1e-9)) + 1, 2)
        axes.append(np.linspace(a, b, n))
    return axes


def sample_box(box_min, box_max, radius):
    """Sample the surface of an AABB with boundary spheres: (M, 3) float64
    positions on a lattice of spacing 2·radius over all six faces."""
    box_min = np.asarray(box_min, dtype=np.float64)
    box_max = np.asarray(box_max, dtype=np.float64)
    spacing = 2.0 * float(radius)
    ax = _face_lattice(box_min, box_max, spacing)
    pts = []
    for axis in range(3):
        u, v = [i for i in range(3) if i != axis]
        uu, vv = np.meshgrid(ax[u], ax[v], indexing="ij")
        for side_val in (box_min[axis], box_max[axis]):
            face = np.empty(uu.shape + (3,))
            face[..., axis] = side_val
            face[..., u] = uu
            face[..., v] = vv
            pts.append(face.reshape(-1, 3))
    pts = np.concatenate(pts, axis=0)
    # deduplicate edge/corner points shared between faces
    q = spacing * 1e-6
    return np.unique(np.round(pts / q).astype(np.int64), axis=0) * q


def compute_vbi(positions, interaction_radius,
                kernel_set: KernelSet = KernelSet.MULLER):
    """Akinci boundary volumes V_bi = 1 / Σ_k W(b_i − b_k), |b_i − b_k| < h
    (float64, host): the native cell-binned pass when available, else the
    equivalent numpy pass."""
    pos = np.asarray(positions, dtype=np.float64)
    h = float(interaction_radius)
    m = pos.shape[0]
    if m == 0:
        return np.zeros((0,), dtype=np.float64)

    from . import native
    nat = native.compute_vbi(pos, h, kernel_set.value)
    if nat is not None:
        return nat

    if kernel_set == KernelSet.MULLER:
        kpoly = 315.0 / (64.0 * np.pi * h**9)

        def w(r2):
            d = np.maximum(h * h - r2, 0.0)
            return kpoly * d**3
    else:
        sigma = 1.0 / (4.0 * np.pi * h**3)

        def w(r2):
            q = np.sqrt(r2) / h
            a = np.maximum(2.0 - q, 0.0)
            b = np.maximum(1.0 - q, 0.0)
            return sigma * (a**3 - 4.0 * b**3)

    # cell-bin at spacing h, then sum over the 27-cell neighborhood
    coords = np.floor((pos - pos.min(axis=0)) / h).astype(np.int64)
    cells = defaultdict(list)
    for i, c in enumerate(map(tuple, coords)):
        cells[c].append(i)
    wsum = np.zeros(m)
    for c, idx in cells.items():
        idx = np.asarray(idx)
        neigh = []
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    neigh.extend(cells.get((c[0] + dx, c[1] + dy, c[2] + dz),
                                           ()))
        neigh = np.asarray(neigh)
        d = pos[idx][:, None, :] - pos[neigh][None, :, :]
        r2 = np.sum(d * d, axis=-1)
        wsum[idx] = np.where(r2 < h * h, w(r2), 0.0).sum(axis=1)
    return 1.0 / np.maximum(wsum, 1e-12)


def build_boundary(grid, positions, vbi, rest_density,
                   dtype=torch.float32, device=None) -> BoundaryData:
    """Hash-sort the static boundary set once (``updateGpuBoundaries``,
    ``sph/sph.cpp:391-432``) and bake ψ = ρ₀·V_bi, on ``device``
    (default: the CUDA device)."""
    device = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions, np.float64)).to(
        dtype=dtype, device=device)
    psi = torch.as_tensor(float(rest_density) * np.asarray(vbi)).to(
        dtype=dtype, device=device)
    h = gridlib.hash_positions(grid, pos)
    sorted_hash, _, (pos_s, psi_s) = gridlib.sort_by_hash(h, pos, psi)
    return BoundaryData(pos=pos_s, psi=psi_s, sorted_hash=sorted_hash)


def box_boundary(grid, box_min, box_max, radius, params: SimParams,
                 kernel_set: KernelSet = KernelSet.MULLER,
                 dtype=torch.float32, device=None) -> BoundaryData:
    """Sample an AABB shell and build its BoundaryData (the demo scene,
    ``main.cpp:541-553``)."""
    pts = sample_box(box_min, box_max, radius)
    vbi = compute_vbi(pts, float(params.interaction_radius), kernel_set)
    return build_boundary(grid, pts, vbi, float(params.rest_density),
                          dtype=dtype, device=device)


def rotation_matrix(axis, angle, dtype=torch.float32, device=None):
    """Rodrigues rotation matrix (3, 3) about ``axis`` by ``angle``
    (radians; a float or a 0-d tensor, whose device it takes), on
    ``device`` (default: the CUDA device)."""
    if isinstance(angle, torch.Tensor):
        device = angle.device if device is None else device
        angle = angle.to(dtype)
    device = resolve_device(device)
    a = torch.as_tensor(axis, dtype=dtype, device=device)
    a = a / torch.sqrt(torch.sum(a * a))
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    c, s = torch.cos(angle), torch.sin(angle)
    z = torch.zeros_like(a[0])
    k = torch.stack([torch.stack([z, -a[2], a[1]]),
                     torch.stack([a[2], z, -a[0]]),
                     torch.stack([-a[1], a[0], z])])
    return torch.eye(3, dtype=dtype, device=device) + s * k + (1.0 - c) * (
        k @ k)


def move_boundary(boundary: BoundaryData, grid, offset=None,
                  velocity=None, rotation=None, omega=None,
                  center=None) -> BoundaryData:
    """Prescribed rigid motion of a boundary set, on its device: new
    positions ``center + R·(p₀ − center) + offset``, wall velocities
    ``velocity + ω × (p' − center)``, hashes recomputed and every column
    re-sorted by one stable sort (``grid.sort_by_hash``).

    ``offset`` (3,) translation; ``velocity`` (3,) or (M, 3); ``rotation``
    (3, 3) (:func:`rotation_matrix`) about ``center`` (default: the
    origin); ``omega`` (3,) angular velocity. With no velocity-like
    argument the result has ``vel=None`` (the static path); with neither
    ``offset`` nor ``rotation`` the set keeps its order. Pass the t = 0
    set with absolute motion parameters every step: increments would
    accumulate error. The grid must cover the swept region; ψ is
    geometry and moves unchanged."""
    pos = boundary.pos

    def t(x):
        return torch.as_tensor(x, dtype=pos.dtype, device=pos.device)

    c = 0.0 if center is None else t(center)
    if rotation is not None:
        pos = (pos - c) @ t(rotation).T + c
    vel = None
    if velocity is not None:
        vel = torch.broadcast_to(t(velocity), pos.shape)
    if omega is not None:
        spin = torch.linalg.cross(torch.broadcast_to(t(omega), pos.shape),
                                  pos - c)
        vel = spin if vel is None else vel + spin
    if offset is None and rotation is None:
        return BoundaryData(pos=pos, psi=boundary.psi,
                            sorted_hash=boundary.sorted_hash,
                            vel=None if vel is None else vel.contiguous())
    if offset is not None:
        pos = pos + t(offset)[None, :]
    h = gridlib.hash_positions(grid, pos)
    cols = (pos, boundary.psi) + ((vel,) if vel is not None else ())
    sorted_hash, _, out = gridlib.sort_by_hash(h, *cols)
    return BoundaryData(pos=out[0], psi=out[1], sorted_hash=sorted_hash,
                        vel=out[2] if vel is not None else None)


def rehash_boundary(boundary: BoundaryData, grid) -> BoundaryData:
    """Re-sort a boundary set against a refit grid (``updateGpuBoundaries``
    after ``updateGrid``, ``sph/sph.cpp:408``): ψ is geometry, only the
    hashes and their order move."""
    h = gridlib.hash_positions(grid, boundary.pos)
    sorted_hash, _, (pos_s, psi_s) = gridlib.sort_by_hash(
        h, boundary.pos, boundary.psi)
    return BoundaryData(pos=pos_s, psi=psi_s, sorted_hash=sorted_hash)
