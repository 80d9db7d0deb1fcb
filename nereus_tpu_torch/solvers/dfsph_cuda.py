"""The DFSPH steps on the sweep kernels (the counterparts of
``nereus_tpu.solvers.dfsph_pallas.dfsph_step_pallas`` and
``dfsph_multiphase_pallas``).

Single phase (:func:`dfsph_step_cuda`): density and α = ρ/max(|Σψ∇W|² +
Σ|ψ∇W|², ε) from one sweep of the density's matrix → divergence loop
(per iteration: Dρ/Dt, then the κᵛ correction) → advection forces
(pressure off) + gravity → with ``viscosity_model="implicit"`` the
implicit viscosity solve on v*, the force sweep then without viscosity and
wall friction → warm start, ½·κ_prev applied once → density loop (per
iteration: ρ* = ρ + dt·Dρ/Dt, then the κ correction) → positions. The κ
correction is the implicit solvers' pressure-force sweep with κ/ρ in the
pd2 slot.

Multiphase (:func:`dfsph_step_multiphase_cuda`): the same two loops on the
adapted number-density domain of ``nereus_tpu.solvers.dfsph``: δ̂ = ρ̃/m_i
and α̂ = m_iδ̂²/max(|Ĝ|² + m_iS, ε) from the sums of one sweep of one
(C [+ Mb], 4) matrix ``x y z 1/m`` (:func:`multiphase_alpha_operands`;
the multiphase density's and α̂'s sums in one walk), per iteration one
dδ̂/dt sweep and one κV̂² correction sweep (V̂ = 1/δ̂), and the multiphase
force sweep with zero pressure as the non-pressure forces. Errors are in
kg/m³ of each particle's own ρ₀ (``to_kg`` = m_i·ρ₀/ρ0_i).

On CUDA tensors the sweeps are the hand-written kernels of ``csrc/``; on
CPU tensors their plain PyTorch versions.

Both steps, and the coupled steps of :mod:`.dfsph_coupled_cuda` and
:mod:`.dfsph_elastic`, run their two loops through :func:`dfsph_solve`,
which takes the step's sweeps object. The loops are
:class:`~.predicated_loop.PredicatedLoop`\\ s that commit the velocities,
κ and whatever else the sweeps carry, and read their conditions on the
host once per :data:`SYNC_EVERY_V` / :data:`SYNC_EVERY` launched
iterations from their minimum on. The divergence loop's error is
dt·mean(max(Dρ/Dt, 0)), the density loop's the mean clamped compression,
both over active rows.
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
from .wcsph_cuda import multiphase_force_args

_EPS_DENOM = SP.ALPHA_EPS

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
    """The sweeps of a single-phase DFSPH step on loop-invariant operands,
    in the interface :func:`dfsph_solve` drives: :meth:`drho`,
    :meth:`correct` and :meth:`nonpressure` each take the fluid velocities
    and the tuple of other values the solve carries (here none; a coupled
    step's bodies), and the density loop's ``base`` (ρ), ``target`` (ρ₀)
    and ``to_kg`` (None: the errors are already in kg/m³). Each call
    writes its columns in place (the velocities into the fluid rows of the
    Dρ/Dt sweep's one matrix, whose first C rows are its queries; κ/ρ into
    the correction's query and fluid slot 6) and launches one sweep."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens):
        z = torch.zeros_like(dens)
        self.ctx, self.params, self.cfg = ctx, params, cfg
        self.dens, self.zero = dens, z
        self.base, self.target, self.to_kg = dens, params.rest_density, None
        self.dens_safe = torch.clamp(dens, min=1e-12)
        self.dt = params.dt
        self.dt_m = params.dt / params.particle_mass
        # one (C [+ Mb], 8) matrix x y z v ψ 0 (fluid ψ = m), the walls as
        # they are; its first C rows are the queries (a contiguous view)
        self.src_v = ctx.pack((z, z, z), params.particle_mass)
        self.q_v = self.src_v[:ctx.c]
        self._pd2_at = pd2_operands(ctx)

    def drho_operands(self, vel):
        """The Dρ/Dt sweep's operands at the (C, 3) velocities ``vel``,
        written once into the fluid rows of its one matrix: ``(q, src,
        seg_start, seg_end, pvec)``, q the matrix's first C rows."""
        self.q_v[:, 3:6] = vel
        return (self.q_v, self.src_v, self.ctx.seg_start, self.ctx.seg_end,
                self.ctx.pvec)

    def kappa_operands(self, kappa):
        """The κ correction's (pressure-force sweep's) operands, κ/ρ in
        the pd2 slot."""
        return self._pd2_at(kappa / self.dens_safe)

    def drho(self, vel, carry=()):
        """Dρ/Dt (C,) of the (C, 3) velocities ``vel``."""
        return SP.drho_sweep(self.cfg, *self.drho_operands(vel))

    def apply_kappa(self, kappa, vel):
        """(C, 3) v + (dt/m)·F with F = −m²Σ(κ_i/ρ_i + κ_j/ρ_j)∇W over the
        fluid and −mψ_b(κ_i/ρ_i)∇W over the boundary rows."""
        f = SP.pressure_force_sweep(self.cfg, *self.kappa_operands(kappa),
                                    plan=self.ctx.tile_plan)
        return vel + self.dt_m * f

    def correct(self, kappa, vel, carry=()):
        """One κ correction: ``(v, carry)``."""
        return self.apply_kappa(kappa, vel), carry

    def forces(self, vel, include_viscosity=True):
        """``(q8, src, f)``: the non-pressure force sweep's query and
        source at the (C, 3) velocities ``vel``, and its (C, 3) force."""
        q8, src, *rng = self.ctx.force_operands(vel.unbind(1), self.dens,
                                                self.zero)
        f = SP.fluid_force_sweep(self.cfg, q8, src, *rng,
                                 include_pressure=False,
                                 include_viscosity=include_viscosity,
                                 moving_boundary=self.ctx.moving_boundary)
        return q8, src, f

    def kick(self, vel, f):
        """v + (dt/m)·(f + m·g)."""
        pm = self.params.particle_mass
        return vel + (self.dt / pm) * (f + pm * self.params.gravity)

    def nonpressure(self, vel, carry=()):
        """The advection forces (pressure off) and gravity on the
        divergence-free velocities; with ``viscosity_model="implicit"``
        the implicit viscosity solve on v* owns the viscosity and wall
        friction. Returns ``(v*, carry)``."""
        implicit_visc = self.cfg.viscosity_model == "implicit"
        v = self.kick(vel, self.forces(vel, not implicit_visc)[2])
        if implicit_visc:
            v_sol, _, _ = implicit_viscosity(self.ctx, self.params, self.cfg,
                                             self.dens, v)
            v = torch.where(self.ctx.active[:, None], v_sol, v)
        return v, carry


class MultiphaseKappaSweeps:
    """The sweeps of a multiphase DFSPH step on loop-invariant operands,
    in :class:`KappaSweeps`' interface on the adapted domain (``base``
    δ̂ = ρ̃/m_i, ``target`` ρ0_i/m_i, ``to_kg`` m_i·ρ₀/ρ0_i). Each call
    writes its columns in place (the velocities into the fluid rows of the
    dδ̂/dt sweep's one matrix, whose first C rows are its queries and whose
    slot 6 holds s_i/m_i; κV̂² and (s_i/m_i)·κV̂² into the correction's
    query and κV̂²_j into its 4-wide fluid source rows) and launches one
    sweep.
    ``delta``: the number density δ of the non-pressure stage's volumes."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens, delta=None):
        z = torch.zeros_like(dens)
        mass = ctx.mass
        self.ctx, self.params, self.cfg = ctx, params, cfg
        self.dens, self.delta, self.zero = dens, delta, z
        self.delta_hat = dens / mass
        self.base, self.target = self.delta_hat, ctx.rho0 / mass
        self.to_kg = mass * (params.rest_density / ctx.rho0)
        self.vhat2 = 1.0 / torch.clamp(self.delta_hat * self.delta_hat,
                                       min=1e-24)
        self.sm = (ctx.rho0 / params.rest_density) / mass
        self.dt = params.dt
        self.dt_im = (params.dt * (1.0 / mass))[:, None]
        # one (C [+ Mb], 8) matrix x y z v s/m 0, the walls as they are;
        # its first C rows are the queries (a contiguous view)
        self.src_v = ctx.pack((z, z, z), self.sm)
        self.q_v = self.src_v[:ctx.c]
        self.q_k = ctx.queries(z, z, width=8)
        self.src_k = ctx.pack_psi(ctx.queries(z))

    def drho_operands(self, vel):
        """The dδ̂/dt sweep's operands at the (C, 3) velocities ``vel``,
        written once into the fluid rows of its one matrix: ``(q, src,
        seg_start, seg_end, pvec)``, q the matrix's first C rows."""
        self.q_v[:, 3:6] = vel
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

    def drho(self, vel, carry=()):
        """dδ̂/dt (C,) of the (C, 3) velocities ``vel``: the fluid sum plus
        the wall sum scaled by s_i/m_i, formed in the sweep."""
        return SP.multiphase_drho_sweep(self.cfg, *self.drho_operands(vel))

    def apply_kappa(self, kappa, vel):
        """(C, 3) v − (dt/m_i)·Σ(κV̂²_i + κV̂²_j)∇W − (dt/m_i)·qc_i·Σψ_b∇W."""
        f = SP.multiphase_kappa_sweep(self.cfg, *self.kappa_operands(kappa))
        return vel - self.dt_im * f

    def correct(self, kappa, vel, carry=()):
        """One κ̂ correction: ``(v, carry)``."""
        return self.apply_kappa(kappa, vel), carry

    def forces(self, vel):
        """``(cols, inv_rho, acc)``: the velocity columns, 1/ρ̃ and the
        multiphase force sweep's (C, 3) acceleration at zero pressure
        (volume-form viscosity, β walls, friction)."""
        cols = vel.unbind(1)
        vol = 1.0 / torch.clamp(self.delta, min=1e-12)
        inv_rho = 1.0 / torch.clamp(self.dens, min=1e-12)
        acc = SP.multiphase_force_sweep(
            self.cfg, *multiphase_force_args(self.ctx, cols, vol, inv_rho,
                                             self.zero),
            moving_boundary=self.ctx.moving_boundary)
        return cols, inv_rho, acc

    def nonpressure(self, vel, carry=()):
        """v + dt·(a + g) with the non-pressure acceleration a: ``(v*,
        carry)``."""
        acc = self.forces(vel)[2]
        return vel + self.dt * (acc + self.params.gravity), carry


def _commit(loop: PredicatedLoop, new, old):
    """:meth:`~.predicated_loop.PredicatedLoop.commit` over a tensor or a
    tuple of them, nested."""
    if torch.is_tensor(old):
        return loop.commit(new, old)
    return tuple(_commit(loop, n, o) for n, o in zip(new, old))


def dfsph_solve(state: FluidState, sweeps, alpha, carry=(),
                tol: float = 1.0, tol_v: float = 1.0):
    """The two solves of a DFSPH step around its non-pressure stage, on
    ``sweeps`` (:class:`KappaSweeps`, :class:`MultiphaseKappaSweeps` or a
    coupled step's subclass): the divergence loop (per iteration the
    clamped rate, then the correction with κ = rate·α/dt), the
    non-pressure stage, the warm start (½·κ_prev, one correction of its
    own), then the density loop (per iteration base* = base + dt·rate,
    the clamped compression over ``target``, then the correction with
    κ = comp·α/dt²). ``carry``: a tuple of tensors (or of such tuples)
    that the corrections and the non-pressure stage advance with the
    velocities; both loops commit it, the velocities and κ, so an
    iteration launched after a loop's end changes nothing. Returns
    ``(new_state, carry, StepDiagnostics)``."""
    ctx, cfg = sweeps.ctx, sweeps.cfg
    active = ctx.active
    zero = sweeps.zero
    nact = torch.clamp(state.num_active.to(cfg.dtype), min=1.0)
    dt = sweeps.dt

    def mean_active(x):
        if sweeps.to_kg is not None:
            x = x * sweeps.to_kg
        return torch.sum(torch.where(active, x, zero)) / nact

    # -- divergence-free solve on the incoming velocities -------------------
    # (C, 3) rows: one launch per elementwise operation, not three
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    loop_v = PredicatedLoop(LOOP_V, like=zero, tol=tol_v,
                            min_iters=cfg.dfsph_min_iters_v,
                            max_iters=cfg.dfsph_max_iters_v,
                            sync_every=SYNC_EVERY_V, err0=2.0 * tol_v)
    for _ in loop_v:
        drho = torch.clamp(sweeps.drho(v, carry), min=0.0)
        v, carry = _commit(loop_v, sweeps.correct(drho * alpha / dt, v,
                                                  carry), (v, carry))
        loop_v.advance(dt * mean_active(drho))

    v, carry = sweeps.nonpressure(v, carry)

    # -- constant-density solve on v*, warm-started with ½·κ_prev ---------
    kap = zero
    if cfg.dfsph_warm_start:
        kap = 0.5 * torch.clamp(torch.where(active, ctx.pres_prev, zero),
                                min=0.0)
        v, carry = sweeps.correct(kap, v, carry)
    loop = PredicatedLoop(LOOP, like=zero, tol=tol,
                          min_iters=cfg.dfsph_min_iters,
                          max_iters=cfg.dfsph_max_iters,
                          sync_every=SYNC_EVERY, err0=2.0 * tol)
    for _ in loop:
        base_star = sweeps.base + dt * sweeps.drho(v, carry)
        comp = torch.clamp(base_star - sweeps.target, min=0.0)
        kappa = comp * alpha / (dt * dt)
        v, carry = _commit(loop, sweeps.correct(kappa, v, carry), (v, carry))
        kap = loop.commit(kap + kappa, kap)
        loop.advance(mean_active(comp))

    new_state, diag = _result(state, ctx, sweeps.params, v, kap, sweeps.dens,
                              loop, loop_v)
    return new_state, carry, diag


def multiphase_alpha_operands(ctx: SweepCtx):
    """The operands ``(q, src, seg_start, seg_end, pvec)`` of the
    multiphase density and α̂ sweep on one (C [+ Mb], 4) matrix, built as
    the density's (:meth:`SweepCtx.density_operands`): fluid rows
    ``x y z 1/m_j``, then the boundary rows ``x y z ψ_b``; q its first C
    rows (the kernel reads their x y z). The multiphase density sweep
    alone walks it too (it reads no fluid row's slot 3)."""
    return ctx.density_operands(1.0 / ctx.mass)


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
    # -- density + the DFSPH factor α: one sweep of the density's matrix ---
    dens, alpha = SP.density_alpha_sweep(
        cfg, *ctx.density_operands(params.particle_mass)).unbind(1)
    new_state, _, diag = dfsph_solve(state, KappaSweeps(ctx, params, cfg,
                                                        dens),
                                     alpha, tol=tol, tol_v=tol_v)
    return new_state, diag


def dfsph_step_multiphase_cuda(state: FluidState, params: SimParams,
                               grid: gridlib.Grid, cfg: SimConfig,
                               boundary: Optional[BoundaryData] = None,
                               tol: float = 1.0, tol_v: float = 1.0):
    """One multiphase DFSPH step (surface tension NONE or BECKER); returns
    ``(new_state, StepDiagnostics)`` with the new state, its ``mass`` and
    ``rho0`` in hash-sorted order, ``pressure`` the accumulated κ̂."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    mass = ctx.mass

    # -- adapted density + the factor α̂: one sweep of one matrix ----------
    out = SP.multiphase_density_alpha_sweep(cfg,
                                            *multiphase_alpha_operands(ctx))
    delta = out[:, 0]
    dens = mass * delta + (ctx.rho0 / params.rest_density) * out[:, 1]
    sweeps = MultiphaseKappaSweeps(ctx, params, cfg, dens, delta)
    sm = sweeps.sm
    al = out[:, 2:]
    ghx = al[:, 0] + sm * al[:, 4]
    ghy = al[:, 1] + sm * al[:, 5]
    ghz = al[:, 2] + sm * al[:, 6]
    denom = ghx * ghx + ghy * ghy + ghz * ghz + mass * al[:, 3]
    alpha = mass * sweeps.delta_hat * sweeps.delta_hat / torch.clamp(
        denom, min=_EPS_DENOM)
    new_state, _, diag = dfsph_solve(state, sweeps, alpha, tol=tol,
                                     tol_v=tol_v)
    return new_state, diag
