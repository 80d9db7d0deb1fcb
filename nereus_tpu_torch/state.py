"""Particle state (PyTorch port of ``nereus_tpu.state``).

A fixed-capacity set of ``(capacity, ...)`` tensors plus a live count
``num_active`` (a 0-d int32 tensor kept on the device, so a step never
syncs with the host to learn it). Slots past the live count are parked at
1e9 and hash to ``INT32_MAX``, so no neighbor range ever reaches them.

Particle lifecycle: :func:`add_particles` (the reference's particle
dropping, with a host read of the live count and a ``ValueError`` past
capacity), :func:`add_particles_traced` (emission with no host read: the
overflow is a device tensor) and :func:`remove_particles` (outflow: one
stable sort moves the keepers to the front). None of them launches a
sweep kernel.
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


def _rows(state: FluidState, a, k: int):
    """``a`` broadcast to (k, 3) on the state's device and dtype (None:
    zeros)."""
    if a is None:
        return state.vel.new_zeros((k, 3))
    a = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a)
    return torch.broadcast_to(a.to(dtype=state.pos.dtype,
                                   device=state.pos.device), (k, 3))


def _append_phase_cols(state: FluidState, idx, masses, rho0s):
    """New ``(mass, rho0)`` columns with the rows ``idx`` (k,) written;
    they default to the first particle's values (same-phase emission).
    ``(None, None)`` for a single-phase state, which refuses per-particle
    values."""
    if state.mass is None:
        if masses is not None or rho0s is not None:
            raise ValueError(
                "per-particle masses on a single-phase state — build the "
                "state with make_fluid_state(..., masses=, rest_densities=)")
        return None, None
    k = idx.shape[0]

    def col(c, v):
        v = c[0].expand(k) if v is None else torch.broadcast_to(
            torch.as_tensor(v, dtype=c.dtype).to(c.device), (k,))
        return c.index_copy(0, idx, v)
    return col(state.mass, masses), col(state.rho0, rho0s)


def add_particles(state: FluidState, positions, velocities=None,
                  masses=None, rest_densities=None) -> FluidState:
    """Append ``positions`` (k, 3) as live particles in the first free
    slots (the reference's particle dropping, ``main.cpp:499-521`` /
    ``sph/sph.cpp:341-368``, which can run past its buffer; here past
    capacity raises ``ValueError``). Reads the live count on the host."""
    pos = _rows(state, positions, np.shape(positions)[0])
    k = pos.shape[0]
    n = int(state.num_active)
    if n + k > state.capacity:
        raise ValueError(f"adding {k} particles exceeds capacity "
                         f"{state.capacity} (live: {n})")
    idx = torch.arange(n, n + k, device=pos.device)
    m2, r2 = _append_phase_cols(state, idx, masses, rest_densities)
    return FluidState(
        pos=state.pos.index_copy(0, idx, pos),
        vel=state.vel.index_copy(0, idx, _rows(state, velocities, k)),
        pressure=state.pressure, num_active=state.num_active + k,
        mass=m2, rho0=r2)


def add_particles_traced(state: FluidState, positions, velocities=None):
    """:func:`add_particles` with no host read: the k particles go to slots
    ``[n, n+k)`` of the device live count n; when they do not fit, nothing
    is written. Returns ``(state, overflow)``, ``overflow`` a 0-d int32
    device tensor: the number of particles not emitted (0 or k). The write
    start is clamped to ``capacity − k`` so the rows stay in bounds when
    the emission is refused, as the JAX package clamps it."""
    pos = _rows(state, positions, np.shape(positions)[0])
    k = pos.shape[0]
    if k > state.capacity:
        raise ValueError(f"emitting {k} particles into capacity "
                         f"{state.capacity}")
    n = state.num_active
    ok = n + k <= state.capacity
    idx = torch.clamp(n, max=state.capacity - k).long() + torch.arange(
        k, device=pos.device)
    # a refused emission writes the rows' own values back
    pos = torch.where(ok, pos, state.pos.index_select(0, idx))
    vel = torch.where(ok, _rows(state, velocities, k),
                      state.vel.index_select(0, idx))
    m2 = r2 = None
    if state.mass is not None:
        m2, r2 = _append_phase_cols(
            state, idx, torch.where(ok, state.mass[0], state.mass[idx]),
            torch.where(ok, state.rho0[0], state.rho0[idx]))
    zero = torch.zeros_like(n)
    new = FluidState(pos=state.pos.index_copy(0, idx, pos),
                     vel=state.vel.index_copy(0, idx, vel),
                     pressure=state.pressure,
                     num_active=torch.where(ok, n + k, n).to(n.dtype),
                     mass=m2, rho0=r2)
    return new, torch.where(ok, zero, zero + k).to(torch.int32)


def remove_particles(state: FluidState, keep) -> FluidState:
    """Deactivate the particles where ``keep`` (capacity,) is False
    (open-boundary outflow, drains; the reference only ever adds). Slots
    already inactive stay inactive. One stable sort on ``~keep`` moves the
    keepers to the front in their order; the dropped slots are parked at
    1e9 with zero velocity and pressure, their ``mass``/``rho0`` following
    the sort (finite, as the pair math needs); the live count stays a
    device tensor."""
    keep = torch.as_tensor(keep, device=state.pos.device).to(torch.bool)
    keep = keep & state.active_mask()
    _, perm = torch.sort((~keep).to(torch.int32), stable=True)
    new_n = keep.sum().to(state.num_active.dtype)
    live = torch.arange(state.capacity, device=keep.device) < new_n
    pos = torch.where(live[:, None], state.pos.index_select(0, perm),
                      torch.full_like(state.pos, 1e9))
    vel = torch.where(live[:, None], state.vel.index_select(0, perm),
                      torch.zeros_like(state.vel))
    pres = torch.where(live, state.pressure.index_select(0, perm),
                       torch.zeros_like(state.pressure))
    phase = {}
    if state.mass is not None:
        phase = dict(mass=state.mass.index_select(0, perm),
                     rho0=state.rho0.index_select(0, perm))
    return FluidState(pos=pos, vel=vel, pressure=pres, num_active=new_n,
                      **phase)
