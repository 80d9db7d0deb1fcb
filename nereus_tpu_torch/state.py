"""Particle state (PyTorch port of ``nereus_tpu.state``).

A fixed-capacity set of ``(capacity, ...)`` tensors plus a live count
``num_active`` (a 0-d int32 tensor kept on the device, so a step never
syncs with the host to learn it). Slots past the live count are parked at
1e9 and hash to ``INT32_MAX``, so no neighbor range ever reaches them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import resolve_device


@dataclasses.dataclass(frozen=True)
class FluidState:
    """Dynamic fluid-particle state: pos/vel (C, 3), pressure (C,).

    ``mass``/``rho0`` (optional) carry per-particle masses and rest
    densities of a multiphase scene; the WCSPH step runs them through its
    multiphase step, the implicit solvers refuse them."""

    pos: torch.Tensor
    vel: torch.Tensor
    pressure: torch.Tensor
    num_active: torch.Tensor          # 0-d int32, on the state's device
    mass: torch.Tensor | None = None
    rho0: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def multiphase(self) -> bool:
        return self.mass is not None

    def active_mask(self):
        return torch.arange(self.capacity,
                            device=self.pos.device) < self.num_active


@dataclasses.dataclass(frozen=True)
class BoundaryData:
    """Static boundary samples sorted by cell hash: positions, Akinci
    ψ = ρ₀·V_bi, and the sorted int32 hashes the fluid queries search."""

    pos: torch.Tensor          # (M, 3)
    psi: torch.Tensor          # (M,)
    sorted_hash: torch.Tensor  # (M,) int32, ascending
    vel: torch.Tensor | None = None

    @property
    def num_boundaries(self) -> int:
        return self.pos.shape[0]


def make_fluid_state(positions, velocities=None, capacity=None,
                     dtype=torch.float32, masses=None, rest_densities=None,
                     device=None) -> FluidState:
    """Build a FluidState from host arrays on ``device`` (default: the
    CUDA device), padding to ``capacity`` with slots parked at 1e9."""
    device = resolve_device(device)
    positions = np.asarray(positions, dtype=np.float64)
    n = positions.shape[0]
    if velocities is None:
        velocities = np.zeros_like(positions)
    velocities = np.broadcast_to(np.asarray(velocities, dtype=np.float64),
                                 positions.shape)
    if capacity is None:
        capacity = n
    if capacity < n:
        raise ValueError(f"capacity {capacity} smaller than particle "
                         f"count {n}")
    if (masses is None) != (rest_densities is None):
        raise ValueError("masses and rest_densities must be set together")
    pos = np.full((capacity, 3), 1e9, dtype=np.float64)
    vel = np.zeros((capacity, 3), dtype=np.float64)
    pos[:n] = positions
    vel[:n] = velocities

    def t(a):
        return torch.as_tensor(a).to(dtype=dtype, device=device)

    mass = rho0 = None
    if masses is not None:
        m = np.broadcast_to(np.asarray(masses, np.float64), (n,))
        r0 = np.broadcast_to(np.asarray(rest_densities, np.float64), (n,))
        # pad slots take the first particle's phase: finite values keep
        # the pair math NaN-free
        mass = np.full((capacity,), m[0] if n else 1.0)
        rho0 = np.full((capacity,), r0[0] if n else 1.0)
        mass[:n] = m
        rho0[:n] = r0
        mass, rho0 = t(mass), t(rho0)
    return FluidState(
        pos=t(pos), vel=t(vel),
        pressure=torch.zeros((capacity,), dtype=dtype, device=device),
        num_active=torch.tensor(n, dtype=torch.int32, device=device),
        mass=mass, rho0=rho0,
    )
