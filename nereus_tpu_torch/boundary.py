"""Akinci-2012 boundary particles (PyTorch port of ``nereus_tpu.boundary``).

* :func:`sample_box` — a lattice of spacing 2·radius over the six faces of
  an AABB, edges and corners deduplicated.
* :func:`compute_vbi` — per-sample volume V_bi = 1 / Σ_k W(b_i − b_k) over
  boundary neighbors within h; the solvers use ψ = ρ₀·V_bi.

Both are one-time host computations in float64 (the C++ pass of
``native/`` when a compiler is present, numpy otherwise); the result
moves to the device once, hash-sorted, in :func:`build_boundary`.
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
