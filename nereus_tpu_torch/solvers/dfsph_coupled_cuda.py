"""The DFSPH + rigid-body coupled steps on the sweep kernels (the
counterparts of ``_coupled_pallas`` and ``_coupled_mp_pallas`` in
``nereus_tpu.solvers.dfsph_coupled``).

Each body's shell (:func:`~.coupled_cuda.body_shells`) enters the DFSPH
solve as a boundary of its own, swept alone over 9 range rows:

* the density and the factor α: the fluid's ρ and α's sums come from one
  sweep (``density_alpha_sums_sweep``), the shell's ψ-density and its
  Σψ_b∇W (the boundary form of α's sums) from one sweep of the shell's
  ``x y z ψ_b`` rows (``body_density_alpha_sweep``); Σψ_b∇W joins the
  gradient sum, and with ``SimConfig.dfsph_strong_coupling`` the body's
  mobility pm·(|g|²/M + t·I⁻¹t), t = (x_i − c)×g, joins the denominator;
* every Dρ/Dt of both loops: the shell with the body's CURRENT sample
  velocities v + ω×r in slots 3-5 (``drho_shell_sweep``);
* every κ correction of both loops and the warm start: the boundary form
  of the pressure force over the shell (``pressure_force_body_sweep``; κ
  reads no velocity, so the shell keeps its start-of-step rows); its
  central pair forces give the body's reaction from the fluid side
  (:func:`~.coupled_cuda.reaction`), which kicks the body's (v, ω) at once:
  the next iteration's Dρ/Dt sees the body yield (a Gauss–Seidel
  interface, as the JAX step);
* the non-pressure stage: the body's friction alone
  (``body_force_sweep(include_pressure=False)``), kicked the same way.

Multiphase (:func:`dfsph_coupled_step_multiphase_cuda`): the same on the
adapted number-density domain of :mod:`.dfsph_cuda`, with the body forms of
the multiphase α, dδ̂/dt and κ sweeps (each body term scaled by the
query's s_i/m_i; the reactions are −Σ fb and Σ m_i·a_b), and the
multiphase body contact with bp = 0 as the friction.

The two loops are :func:`~.dfsph_cuda.dfsph_solve`'s, on the sweeps of
this module (subclasses of :mod:`.dfsph_cuda`'s) with every body's (v, ω)
as the carried state: the loops commit it with the velocities and κ, so an
iteration launched after a loop's end moves no body. The 3×3 inverses are
``inv_ex``: nothing reads the host but the loops' condition reads.
Gravity, wall and body-body contacts and the rigid integration come once
at the end (``rigid_extras``, ``integrate_rigid``). On CUDA tensors the
sweeps are the hand-written kernels of ``csrc/``; on CPU tensors their
plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..rigid import integrate_rigid
from ..state import BoundaryData, FluidState
from .coupled import rigid_extras
from .coupled_cuda import Shell, body_shells, reaction
from .dfsph_cuda import (_EPS_DENOM, KappaSweeps, MultiphaseKappaSweeps,
                         dfsph_solve, multiphase_alpha_operands)
from .sweep_common import SweepCtx, build_sweep_ctx


class BodyTerms:
    """One body's shell and the per-step constants of its coupling: the
    world inertia's inverse, the samples' offsets from the com (sorted
    order) and a source buffer for the spliced sample velocities."""

    def __init__(self, body, shell: Shell):
        self.shell = shell
        self.com = body.com
        self.mass = body.mass
        iw = body.R @ body.inertia_body @ body.R.T
        self.iw_inv = torch.linalg.inv_ex(iw)[0]
        self.rel = shell.src[:, :3] - body.com[None, :]
        self._src_v = shell.src.clone()

    @functools.cached_property
    def src4(self):
        """(Mb, 4) ``x y z ψ_b``: the shell of the density and α sweep,
        the multiphase density, α and κ sweeps."""
        return self.shell.src4

    def ranges(self, pvec):
        return self.shell.seg_start, self.shell.seg_end, pvec

    def src_at(self, bv):
        """The shell's rows with the sample velocities v + ω×r of the
        body's ``bv = (v, ω)`` in slots 3-5 (one buffer, rewritten by each
        call)."""
        v, w = bv
        self._src_v[:, 3:6] = v[None, :] + torch.linalg.cross(
            w.expand_as(self.rel), self.rel)
        return self._src_v

    def kick(self, bv, F, T, dt):
        """``bv`` after the reaction (F, T) over dt."""
        v, w = bv
        return v + (dt / self.mass) * F, w + dt * (self.iw_inv @ T)

    def mobility(self, rel_base, g):
        """|g|²/M + t·I⁻¹t with t = (x_i − c)×g: the body's yield per unit
        κ_i, the strong-coupling term of α's denominator (unscaled)."""
        t = torch.linalg.cross(rel_base - self.com[None, :], g)
        return (torch.sum(g * g, dim=1) / self.mass
                + torch.sum((t @ self.iw_inv) * t, dim=1))


def body_terms(ctx: SweepCtx, grid: gridlib.Grid, bodies):
    """Each body's :class:`BodyTerms` at its current pose."""
    return [BodyTerms(b, sh)
            for b, sh in zip(bodies, body_shells(ctx, grid, bodies))]


def _integrate(bodies, bv, boundary, params: SimParams, cfg: SimConfig):
    """The bodies with their kicked (v, ω) integrated under gravity and
    the wall and body-body contacts."""
    Fx, Tx = rigid_extras(bodies, boundary, params, cfg)
    return tuple(
        integrate_rigid(
            dataclasses.replace(b, vel=bv[k][0], omega=bv[k][1]), Fx[k],
            Tx[k], params.dt, params.gravity)
        for k, b in enumerate(bodies))


class CoupledSweeps(KappaSweeps):
    """The sweeps of a single-phase coupled DFSPH step, fluid and bodies;
    the carried state is each body's ``(v, ω)``."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens, terms):
        super().__init__(ctx, params, cfg, dens)
        self.terms = terms

    def drho(self, v, bv=()):
        """Dρ/Dt (C,) at the fluid velocities ``v`` and the bodies'
        ``bv``: the fluid and wall sweep, then each shell at its sample
        velocities."""
        d = super().drho(v)
        for t, b in zip(self.terms, bv):
            d = d + SP.drho_shell_sweep(self.cfg, self.q_v, t.src_at(b),
                                        *t.ranges(self.ctx.pvec))
        return d

    def correct(self, kappa, v, bv=()):
        """One κ correction: fluid and walls, then each body's impulse on
        the fluid and its reaction kick. Returns ``(v, bv)``."""
        args = self.kappa_operands(kappa)
        v = v + self.dt_m * SP.pressure_force_sweep(
            self.cfg, *args, plan=self.ctx.tile_plan)
        out = []
        for t, b in zip(self.terms, bv):
            fb = SP.pressure_force_body_sweep(self.cfg, args[0], t.shell.src,
                                              *t.ranges(self.ctx.pvec))
            v = v + self.dt_m * fb
            F, T = reaction(self.ctx, fb, t.com)
            out.append(t.kick(b, F, T, self.dt))
        return v, tuple(out)

    def nonpressure(self, v, bv=()):
        """The non-pressure forces plus each body's friction, each body
        kicked by its reaction."""
        q8, _, f = self.forces(v)
        out = []
        for t, b in zip(self.terms, bv):
            fb = SP.body_force_sweep(self.cfg, q8, t.src_at(b),
                                     *t.ranges(self.ctx.pvec),
                                     include_pressure=False)
            f = f + fb
            F, T = reaction(self.ctx, fb, t.com)
            out.append(t.kick(b, F, T, self.dt))
        return self.kick(v, f), tuple(out)


def coupled_density_alpha(ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                          terms):
    """``(dens, alpha)`` of a single-phase coupled step: the density with
    every shell's ψ-density, and α with every shell's Σψ_b∇W in the
    gradient sum and, under strong coupling, its mobility pm·(|g|²/M +
    t·I⁻¹t) in the denominator. The fluid's ρ and α's sums come from one
    sweep of the density's matrix, each shell's ψ-density and Σψ_b∇W from
    one sweep of its rows."""
    pm = params.particle_mass
    q4, *dargs = ctx.density_operands(pm)
    sums = SP.density_alpha_sums_sweep(cfg, q4, *dargs)
    dens, g = sums[:, 0], sums[:, 1:4]
    mob = torch.zeros_like(dens)
    pos = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    for t in terms:
        shell = SP.body_density_alpha_sweep(cfg, q4, t.src4,
                                            *t.ranges(ctx.pvec))
        dens = dens + shell[:, 0]
        g = g + shell[:, 1:]
        if cfg.dfsph_strong_coupling:
            mob = mob + pm * t.mobility(pos, shell[:, 1:])
    denom = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
             + sums[:, 4] + mob)
    return dens, dens / torch.clamp(denom, min=_EPS_DENOM)


def dfsph_coupled_step_cuda(state: FluidState, params: SimParams,
                            grid: gridlib.Grid, cfg: SimConfig, bodies,
                            boundary: Optional[BoundaryData] = None,
                            tol: float = 1.0, tol_v: float = 1.0):
    """One single-phase coupled DFSPH step; returns ``(new_state,
    new_bodies, StepDiagnostics)``, the new state in hash-sorted order and
    the bodies a tuple."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    terms = body_terms(ctx, grid, bodies)
    dens, alpha = coupled_density_alpha(ctx, params, cfg, terms)
    new_state, bv, diag = dfsph_solve(
        state, CoupledSweeps(ctx, params, cfg, dens, terms), alpha,
        tuple((b.vel, b.omega) for b in bodies), tol=tol, tol_v=tol_v)
    return new_state, _integrate(bodies, bv, boundary, params, cfg), diag


class MultiphaseCoupledSweeps(MultiphaseKappaSweeps):
    """The sweeps of a multiphase coupled DFSPH step in the adapted domain;
    the carried state is each body's ``(v, ω)``."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens, terms, delta=None):
        super().__init__(ctx, params, cfg, dens, delta)
        self.terms = terms

    def drho(self, v, bv=()):
        """dδ̂/dt (C,): the fluid and wall sums, then each shell's wall
        column at its sample velocities, scaled by s_i/m_i."""
        d = super().drho(v)
        for t, b in zip(self.terms, bv):
            db = SP.multiphase_drho_body_sweep(self.cfg, self.q_v,
                                               t.src_at(b),
                                               *t.ranges(self.ctx.pvec))
            d = d + self.sm * db[:, 1]
        return d

    def correct(self, kappa, v, bv=()):
        """One κ̂ correction: fluid and walls, then each body's term on the
        fluid (v −= dt/m_i·fb) and its reaction kick (the fluid's momentum
        rate from the body is −fb)."""
        args = self.kappa_operands(kappa)
        v = v - self.dt_im * SP.multiphase_kappa_sweep(self.cfg, *args)
        out = []
        for t, b in zip(self.terms, bv):
            fb = SP.multiphase_kappa_body_sweep(self.cfg, args[0], t.src4,
                                                *t.ranges(self.ctx.pvec))
            v = v - self.dt_im * fb
            F, T = reaction(self.ctx, -fb, t.com)
            out.append(t.kick(b, F, T, self.dt))
        return v, tuple(out)

    def nonpressure(self, v, bv=()):
        """The multiphase force at zero pressure plus each body's friction
        (the multiphase body contact at bp = 0), each body kicked by its
        reaction Σ m_i·a_b."""
        cols, inv_rho, acc = self.forces(v)
        mass = self.ctx.mass
        q8b = self.ctx.queries(*cols, self.zero, mass * inv_rho * inv_rho)
        out = []
        for t, b in zip(self.terms, bv):
            ab = SP.multiphase_body_sweep(self.cfg, q8b, t.src_at(b),
                                          *t.ranges(self.ctx.pvec))
            acc = acc + ab
            F, T = reaction(self.ctx, mass[:, None] * ab, t.com)
            out.append(t.kick(b, F, T, self.dt))
        return v + self.dt * (acc + self.params.gravity), tuple(out)


def coupled_density_alpha_multiphase(ctx: SweepCtx, params: SimParams,
                                     cfg: SimConfig, terms):
    """``(dens, delta, alpha)`` of a multiphase coupled step: the adapted
    density ρ̃ with every shell's ψ-density scaled by s_i = ρ0_i/ρ₀, the
    number density δ, and α̂ with every shell's Σψ_b∇W in the wall sum
    (scaled by s_i/m_i) and, under strong coupling, its mobility in
    adapted units, (s_i²/m_i)·(|g|²/M + t·I⁻¹t). The density and α̂'s
    sums come from one sweep of one matrix
    (:func:`~.dfsph_cuda.multiphase_alpha_operands`)."""
    mass = ctx.mass
    s_phase = ctx.rho0 / params.rest_density
    sm = s_phase / mass
    aargs = multiphase_alpha_operands(ctx)
    out = SP.multiphase_density_alpha_sweep(cfg, *aargs)
    delta, bsum = out[:, 0], out[:, 1]
    al = out[:, 2:]
    bgx, bgy, bgz = al[:, 4], al[:, 5], al[:, 6]
    mob = torch.zeros_like(delta)
    pos = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    for t in terms:
        bsum = bsum + SP.body_density_sweep(cfg, aargs[0], t.src4,
                                            *t.ranges(ctx.pvec))
        gk = SP.multiphase_alpha_body_sweep(cfg, aargs[0], t.src4,
                                            *t.ranges(ctx.pvec))[:, 4:7]
        bgx = bgx + gk[:, 0]
        bgy = bgy + gk[:, 1]
        bgz = bgz + gk[:, 2]
        if cfg.dfsph_strong_coupling:
            mob = mob + (s_phase * s_phase * (1.0 / mass)) * t.mobility(pos,
                                                                       gk)
    dens = mass * delta + s_phase * bsum
    delta_hat = dens / mass
    ghx = al[:, 0] + sm * bgx
    ghy = al[:, 1] + sm * bgy
    ghz = al[:, 2] + sm * bgz
    denom = ghx * ghx + ghy * ghy + ghz * ghz + mass * al[:, 3] + mob
    return dens, delta, (mass * delta_hat * delta_hat
                         / torch.clamp(denom, min=_EPS_DENOM))


def dfsph_coupled_step_multiphase_cuda(state: FluidState, params: SimParams,
                                       grid: gridlib.Grid, cfg: SimConfig,
                                       bodies,
                                       boundary: Optional[BoundaryData] = None,
                                       tol: float = 1.0, tol_v: float = 1.0):
    """One multiphase coupled DFSPH step (surface tension NONE or BECKER);
    returns ``(new_state, new_bodies, StepDiagnostics)``, the new state
    with its ``mass`` and ``rho0`` in hash-sorted order, ``pressure`` the
    accumulated κ̂."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    terms = body_terms(ctx, grid, bodies)
    dens, delta, alpha = coupled_density_alpha_multiphase(ctx, params, cfg,
                                                          terms)
    new_state, bv, diag = dfsph_solve(
        state, MultiphaseCoupledSweeps(ctx, params, cfg, dens, terms, delta),
        alpha, tuple((b.vel, b.omega) for b in bodies), tol=tol,
        tol_v=tol_v)
    return new_state, _integrate(bodies, bv, boundary, params, cfg), diag
