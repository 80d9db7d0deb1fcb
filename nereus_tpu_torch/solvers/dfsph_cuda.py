"""The single-phase DFSPH step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.dfsph_pallas.dfsph_step_pallas``).

Density → α from the Σψ∇W / Σ|ψ∇W|² sweep → divergence loop (per
iteration: Dρ/Dt, then the κᵛ correction) → advection forces (pressure
off) + gravity → warm start, ½·κ_prev applied once → density loop (per
iteration: ρ* = ρ + dt·Dρ/Dt, then the κ correction) → positions. The κ
correction is the implicit solvers' pressure-force sweep with κ/ρ in the
pd2 slot. On CUDA tensors the sweeps are the hand-written kernels of
``csrc/``; on CPU tensors their plain PyTorch versions.

Both loops are :class:`~.predicated_loop.PredicatedLoop`\\ s that commit
the velocities (and κ) and read their conditions on the host once per
:data:`SYNC_EVERY_V` / :data:`SYNC_EVERY` launched iterations from their
minimum on. The divergence loop's error is dt·mean(max(Dρ/Dt, 0)), the
density loop's the mean clamped compression, both over active rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .predicated_loop import LoopCounts, PredicatedLoop
from .sweep_common import SweepCtx, build_sweep_ctx, pd2_operands
from .wcsph import StepDiagnostics

_EPS_DENOM = 1e-6

# Iterations launched between two host reads of the divergence and the
# density loop's condition. The settled block's loops end at their minima,
# 1 and 2, on most steps (PERF.md): these values read there once and
# launch no frozen iteration, and at most one on a longer solve.
SYNC_EVERY_V = 1
SYNC_EVERY = 2

# iterations launched and host reads of their condition, per loop
LOOP_V = LoopCounts()
LOOP = LoopCounts()


class KappaSweeps:
    """The two sweeps of a DFSPH iteration on loop-invariant operands:
    each call writes its columns in place (the velocities into the Dρ/Dt
    query and the fluid source rows, κ/ρ into the correction's query and
    fluid slot 6) and launches one sweep."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens):
        z = torch.zeros_like(dens)
        self.ctx, self.cfg = ctx, cfg
        self.dens_safe = torch.clamp(dens, min=1e-12)
        self.dt_m = params.dt / params.particle_mass
        self.q_v = ctx.queries(z, z, z, width=8)
        self.src_v = ctx.pack((z, z, z), params.particle_mass)
        self._pd2_at = pd2_operands(ctx)

    def drho_operands(self, vel):
        """The Dρ/Dt sweep's operands at the (C, 3) velocities ``vel``."""
        self.q_v[:, 3:6] = vel
        self.src_v[:self.ctx.c, 3:6] = vel
        return (self.q_v, self.src_v, self.ctx.seg_start, self.ctx.seg_end,
                self.ctx.pvec)

    def kappa_operands(self, kappa):
        """The κ correction's (pressure-force sweep's) operands, κ/ρ in
        the pd2 slot."""
        return self._pd2_at(kappa / self.dens_safe)

    def drho(self, vel):
        """Dρ/Dt (C,) of the (C, 3) velocities ``vel``."""
        return SP.drho_sweep(self.cfg, *self.drho_operands(vel))

    def apply_kappa(self, kappa, vel):
        """(C, 3) v + (dt/m)·F with F = −m²Σ(κ_i/ρ_i + κ_j/ρ_j)∇W over the
        fluid and −mψ_b(κ_i/ρ_i)∇W over the boundary rows."""
        f = SP.pressure_force_sweep(self.cfg, *self.kappa_operands(kappa))
        return vel + self.dt_m * f


def dfsph_step_cuda(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData] = None,
                    tol: float = 1.0, tol_v: float = 1.0):
    """One single-phase DFSPH step; returns ``(new_state,
    StepDiagnostics)`` with the new state in hash-sorted order."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    active = ctx.active
    nact = torch.clamp(state.num_active.to(cfg.dtype), min=1.0)
    dt = params.dt
    pm = params.particle_mass
    rest = params.rest_density
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)

    # -- density + the DFSPH factor α --------------------------------------
    q4 = ctx.queries(width=4)
    src_psi = ctx.pack(vel, pm)
    dens = SP.density_sweep(cfg, q4, src_psi, *rng)
    zero = torch.zeros_like(dens)
    al = SP.alpha_sweep(cfg, q4, src_psi, *rng)
    denom = (al[:, 0] * al[:, 0] + al[:, 1] * al[:, 1] + al[:, 2] * al[:, 2]
             + al[:, 3])
    alpha = dens / torch.clamp(denom, min=_EPS_DENOM)
    sweeps = KappaSweeps(ctx, params, cfg, dens)

    def mean_active(x):
        return torch.sum(torch.where(active, x, zero)) / nact

    # -- divergence-free solve on the incoming velocities -------------------
    # (C, 3) rows: one launch per elementwise operation, not three
    vel3 = torch.stack(vel, dim=1)
    v = vel3
    loop_v = PredicatedLoop(LOOP_V, like=dens, tol=tol_v,
                            min_iters=cfg.dfsph_min_iters_v,
                            max_iters=cfg.dfsph_max_iters_v,
                            sync_every=SYNC_EVERY_V, err0=2.0 * tol_v)
    for _ in loop_v:
        drho = torch.clamp(sweeps.drho(v), min=0.0)
        v = loop_v.commit(sweeps.apply_kappa(drho * alpha / dt, v), v)
        loop_v.advance(dt * mean_active(drho))

    # -- non-pressure forces on the divergence-free velocities --------------
    cols = v.unbind(1)
    f_adv = SP.fluid_force_sweep(cfg, ctx.queries(*cols, dens, zero),
                                 ctx.pack(cols, dens), *rng,
                                 include_pressure=False)
    v = v + (dt / pm) * (f_adv + pm * params.gravity)

    # -- constant-density solve on v*, warm-started with ½·κ_prev ---------
    kap = zero
    if cfg.dfsph_warm_start:
        kap = 0.5 * torch.clamp(torch.where(active, ctx.pres_prev, zero),
                                min=0.0)
        v = sweeps.apply_kappa(kap, v)
    loop = PredicatedLoop(LOOP, like=dens, tol=tol,
                          min_iters=cfg.dfsph_min_iters,
                          max_iters=cfg.dfsph_max_iters,
                          sync_every=SYNC_EVERY, err0=2.0 * tol)
    for _ in loop:
        rho_star = dens + dt * sweeps.drho(v)
        comp = torch.clamp(rho_star - rest, min=0.0)
        kappa = comp * alpha / (dt * dt)
        v = loop.commit(sweeps.apply_kappa(kappa, v), v)
        kap = loop.commit(kap + kappa, kap)
        loop.advance(mean_active(comp))

    # -- integration ---------------------------------------------------------
    pos3 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    act = active[:, None]
    new_state = FluidState(
        pos=torch.where(act, pos3 + dt * v, pos3),
        vel=torch.where(act, v, vel3),
        pressure=torch.where(active, kap, zero),
        num_active=state.num_active)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(active, dens, zero)),
        mean_density_error=loop.err / rest,
        mean_compression=loop.err / rest,
        seg_overflow=torch.zeros((), dtype=torch.int32, device=dens.device),
        solver_iters=loop.it + loop_v.it,
    )
    return new_state, diag
