"""The DFSPH steps on the sweep kernels (the counterparts of
``nereus_tpu.solvers.dfsph_pallas.dfsph_step_pallas`` and
``dfsph_multiphase_pallas``).

Single phase (:func:`dfsph_step_cuda`): density → α from the Σψ∇W /
Σ|ψ∇W|² sweep → divergence loop (per iteration: Dρ/Dt, then the κᵛ
correction) → advection forces (pressure off) + gravity → with
``viscosity_model="implicit"`` the implicit viscosity solve on v*, the
force sweep then without viscosity and wall friction → warm start,
½·κ_prev applied once → density loop (per iteration: ρ* = ρ + dt·Dρ/Dt,
then the κ correction) → positions. The κ correction is the implicit
solvers' pressure-force sweep with κ/ρ in the pd2 slot.

Multiphase (:func:`dfsph_step_multiphase_cuda`): the same two loops on the
adapted number-density domain of ``nereus_tpu.solvers.dfsph``: δ̂ = ρ̃/m_i
from the multiphase density sweep, α̂ = m_iδ̂²/max(|Ĝ|² + m_iS, ε) from
the multiphase α sweep, per iteration one dδ̂/dt sweep and one κV̂²
correction sweep (V̂ = 1/δ̂), and the multiphase force sweep with zero
pressure as the non-pressure forces. Errors are in kg/m³ of each
particle's own ρ₀ (``to_kg`` = m_i·ρ₀/ρ0_i).

On CUDA tensors the sweeps are the hand-written kernels of ``csrc/``; on
CPU tensors their plain PyTorch versions.

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
from .viscosity import implicit_viscosity
from .wcsph import StepDiagnostics
from .wcsph_cuda import multiphase_density_operands, multiphase_force_args

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


class MultiphaseKappaSweeps:
    """The two sweeps of a multiphase DFSPH iteration on loop-invariant
    operands, and the adapted-domain columns of the step: each call writes
    its columns in place (the velocities into the dδ̂/dt query and fluid
    source rows, κV̂² and (s_i/m_i)·κV̂² into the correction's query and
    κV̂²_j into its 4-wide fluid source rows) and launches one sweep."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens):
        z = torch.zeros_like(dens)
        mass = ctx.mass
        self.ctx, self.cfg = ctx, cfg
        self.delta_hat = dens / mass
        self.vhat2 = 1.0 / torch.clamp(self.delta_hat * self.delta_hat,
                                       min=1e-24)
        self.sm = (ctx.rho0 / params.rest_density) / mass
        self.dt_im = (params.dt * (1.0 / mass))[:, None]
        self.q_v = ctx.queries(z, z, z, width=8)
        self.src_v = ctx.pack((z, z, z), z)
        self.q_k = ctx.queries(z, z, width=8)
        self.src_k = ctx.pack_psi(ctx.queries(z))

    def drho_operands(self, vel):
        """The dδ̂/dt sweep's operands at the (C, 3) velocities ``vel``."""
        self.q_v[:, 3:6] = vel
        self.src_v[:self.ctx.c, 3:6] = vel
        return (self.q_v, self.src_v, self.ctx.seg_start, self.ctx.seg_end,
                self.ctx.pvec)

    def kappa_operands(self, kappa):
        """The κV̂² correction's operands at the (C,) stiffness ``kappa``."""
        kv2 = kappa * self.vhat2
        self.q_k[:, 3] = kv2
        self.q_k[:, 4] = self.sm * kv2
        self.src_k[:self.ctx.c, 3] = kv2
        return (self.q_k, self.src_k, self.ctx.seg_start, self.ctx.seg_end,
                self.ctx.pvec)

    def drho(self, vel):
        """dδ̂/dt (C,) of the (C, 3) velocities ``vel``: the fluid sum plus
        the wall sum scaled by s_i/m_i."""
        d = SP.multiphase_drho_sweep(self.cfg, *self.drho_operands(vel))
        return d[:, 0] + self.sm * d[:, 1]

    def apply_kappa(self, kappa, vel):
        """(C, 3) v − (dt/m_i)·Σ(κV̂²_i + κV̂²_j)∇W − (dt/m_i)·qc_i·Σψ_b∇W."""
        f = SP.multiphase_kappa_sweep(self.cfg, *self.kappa_operands(kappa))
        return vel - self.dt_im * f


def multiphase_alpha_operands(ctx: SweepCtx):
    """The multiphase α sweep's operands ``(q, src, seg_start, seg_end,
    pvec)``: q ``x y z 1/m_i`` (the kernel reads x y z), the 4-wide source
    (fluid rows the queries, ``x y z 1/m_j``; boundary rows
    ``x y z ψ_b``)."""
    q = ctx.queries(1.0 / ctx.mass)
    return q, ctx.pack_psi(q), ctx.seg_start, ctx.seg_end, ctx.pvec


def _result(state: FluidState, ctx: SweepCtx, params: SimParams, v, kap,
            dens, loop, loop_v):
    """The new state (positions advanced by dt·v under the ``active``
    mask, a multiphase state's phase columns sorted) and the diagnostics,
    the density loop's error (kg/m³) reported as a fraction of ρ₀."""
    rest = params.rest_density
    pos3 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    vel3 = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    act = ctx.active[:, None]
    zero = torch.zeros_like(dens)
    new_state = FluidState(
        pos=torch.where(act, pos3 + params.dt * v, pos3),
        vel=torch.where(act, v, vel3),
        pressure=torch.where(ctx.active, kap, zero),
        num_active=state.num_active, mass=ctx.mass, rho0=ctx.rho0)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(ctx.active, dens, zero)),
        mean_density_error=loop.err / rest,
        mean_compression=loop.err / rest,
        seg_overflow=torch.zeros((), dtype=torch.int32, device=dens.device),
        solver_iters=loop.it + loop_v.it,
    )
    return new_state, diag


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
    # (the implicit viscosity solve owns the viscosity and wall friction)
    implicit_visc = cfg.viscosity_model == "implicit"
    cols = v.unbind(1)
    f_adv = SP.fluid_force_sweep(cfg, ctx.queries(*cols, dens, zero),
                                 ctx.pack(cols, dens), *rng,
                                 include_pressure=False,
                                 include_viscosity=not implicit_visc,
                                 moving_boundary=ctx.moving_boundary)
    v = v + (dt / pm) * (f_adv + pm * params.gravity)
    if implicit_visc:
        v_sol, _, _ = implicit_viscosity(ctx, params, cfg, dens, v)
        v = torch.where(active[:, None], v_sol, v)

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

    return _result(state, ctx, params, v, kap, dens, loop, loop_v)


def dfsph_step_multiphase_cuda(state: FluidState, params: SimParams,
                               grid: gridlib.Grid, cfg: SimConfig,
                               boundary: Optional[BoundaryData] = None,
                               tol: float = 1.0, tol_v: float = 1.0):
    """One multiphase DFSPH step (surface tension NONE or BECKER); returns
    ``(new_state, StepDiagnostics)`` with the new state, its ``mass`` and
    ``rho0`` in hash-sorted order, ``pressure`` the accumulated κ̂."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    active = ctx.active
    nact = torch.clamp(state.num_active.to(cfg.dtype), min=1.0)
    dt = params.dt
    rest = params.rest_density
    mass, rho0 = ctx.mass, ctx.rho0

    # -- adapted density + the factor α̂ -------------------------------------
    dout = SP.multiphase_density_sweep(cfg, *multiphase_density_operands(ctx))
    delta = dout[:, 0]
    dens = mass * delta + (rho0 / rest) * dout[:, 1]
    zero = torch.zeros_like(dens)
    sweeps = MultiphaseKappaSweeps(ctx, params, cfg, dens)
    delta_hat, sm = sweeps.delta_hat, sweeps.sm
    delta0 = rho0 / mass
    to_kg = mass * (rest / rho0)
    al = SP.multiphase_alpha_sweep(cfg, *multiphase_alpha_operands(ctx))
    ghx = al[:, 0] + sm * al[:, 4]
    ghy = al[:, 1] + sm * al[:, 5]
    ghz = al[:, 2] + sm * al[:, 6]
    denom = ghx * ghx + ghy * ghy + ghz * ghz + mass * al[:, 3]
    alpha = mass * delta_hat * delta_hat / torch.clamp(denom, min=_EPS_DENOM)

    def mean_active(x):
        return torch.sum(torch.where(active, x, zero)) / nact

    # -- divergence-free solve on the incoming velocities -------------------
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    loop_v = PredicatedLoop(LOOP_V, like=dens, tol=tol_v,
                            min_iters=cfg.dfsph_min_iters_v,
                            max_iters=cfg.dfsph_max_iters_v,
                            sync_every=SYNC_EVERY_V, err0=2.0 * tol_v)
    for _ in loop_v:
        dhat = torch.clamp(sweeps.drho(v), min=0.0)
        v = loop_v.commit(sweeps.apply_kappa(dhat * alpha / dt, v), v)
        loop_v.advance(dt * mean_active(dhat * to_kg))

    # -- non-pressure forces: the multiphase force sweep with zero pressure
    # (volume-form viscosity, β walls, friction) ---------------------------
    vol = 1.0 / torch.clamp(delta, min=1e-12)
    inv_rho = 1.0 / torch.clamp(dens, min=1e-12)
    acc = SP.multiphase_force_sweep(
        cfg, *multiphase_force_args(ctx, cfg, v.unbind(1), vol, inv_rho,
                                    zero),
        moving_boundary=ctx.moving_boundary)
    v = v + dt * (acc + params.gravity)

    # -- constant-density solve on v*, warm-started with ½·κ̂_prev ---------
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
        dstar = delta_hat + dt * sweeps.drho(v)
        comp = torch.clamp(dstar - delta0, min=0.0)
        kappa = comp * alpha / (dt * dt)
        v = loop.commit(sweeps.apply_kappa(kappa, v), v)
        kap = loop.commit(kap + kappa, kap)
        loop.advance(mean_active(comp * to_kg))

    return _result(state, ctx, params, v, kap, dens, loop, loop_v)
