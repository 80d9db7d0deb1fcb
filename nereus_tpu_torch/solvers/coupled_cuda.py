"""The coupled WCSPH + rigid-body steps on the sweep kernels (the
counterpart of ``_coupled_step_pallas`` and ``_coupled_mp_pallas`` in
``nereus_tpu.solvers.coupled``).

Single phase (:func:`coupled_step_cuda`): the WCSPH step's density sweep
over fluid and walls plus one density sweep per body shell → Tait EOS →
the fused force sweep (``moving_boundary`` when the walls move) plus one
body-contact sweep per body, whose output is the fluid's contact force and,
summed with the opposite sign, the body's reaction → symplectic Euler and
:func:`~nereus_tpu_torch.rigid.integrate_rigid`.

Multiphase (:func:`coupled_step_multiphase_cuda`): the multiphase number
density plus each shell's Σψ_b·W, rescaled per query phase like the walls'
→ Tait EOS with per-particle ρ₀ → the volume-form force sweep plus one
multiphase body-contact sweep per body (an acceleration; ×m_i the
reaction) → symplectic Euler.

A body shell is a boundary set of its own: its source rows ``x y z v_b ψ_b
0`` (:func:`~.sweep_common.boundary_src`) and 9 range rows from the
step's sorted query cells and the shell's sorted hashes, rebuilt every
step as the body moves. On CUDA tensors the sweeps are the hand-written
kernels of ``csrc/``; on CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..ops.neighbors import query_ranges
from ..params import SimConfig, SimParams
from ..rigid import body_boundary, integrate_rigid
from ..state import BoundaryData, FluidState
from .coupled import rigid_extras
from .sweep_common import SweepCtx, boundary_src, build_sweep_ctx, psi_rows
from .wcsph import tait_pd2, tait_pressure
from .wcsph_cuda import _diagnostics, _integrate, multiphase_force_args


class Shell(NamedTuple):
    """A body shell's source rows and the queries' ranges over them."""

    src: torch.Tensor         # (Mb, 8) x y z v_b ψ_b 0
    seg_start: torch.Tensor   # (9, C) int32
    seg_end: torch.Tensor

    @property
    def src4(self):
        """(Mb, 4) ``x y z ψ_b``: the shell as the density sweep's (and the
        multiphase α and κ sweeps') source."""
        return psi_rows(self.src)


def body_shells(ctx: SweepCtx, grid: gridlib.Grid, bodies):
    """Each body's :class:`Shell` at its current pose."""
    shells = []
    for body in bodies:
        bd = body_boundary(body, grid)
        s, e = query_ranges(grid, ctx.coords, bd.sorted_hash)
        shells.append(Shell(boundary_src(bd), s, e))
    return shells


def reaction(ctx: SweepCtx, f, com):
    """The body's reaction to the per-query contact forces ``f`` (C, 3):
    ``(−Σ f_i, −Σ (x_i − com)×f_i)`` over the active rows."""
    act = ctx.active[:, None]
    zero = torch.zeros_like(f)
    pos = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    F = -torch.sum(torch.where(act, f, zero), dim=0)
    tau = -torch.sum(torch.where(
        act, torch.linalg.cross(pos - com[None, :], f), zero), dim=0)
    return F, tau


def coupled_operands(ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                     shells):
    """The density, force and body sweeps' operands of one single-phase
    coupled step: ``(dargs, fargs, dens, pres)`` with the fused density's
    ``(q, src, seg_start, seg_end, pvec)``, the force sweep's (its query
    also the body sweeps'), the density with every shell's ψ-density and
    its pressure. The shells' density sweeps run here."""
    dargs = ctx.density_operands(params.particle_mass)
    dens = SP.density_sweep(cfg, *dargs)
    for sh in shells:
        dens = dens + SP.body_density_sweep(cfg, dargs[0], sh.src4,
                                            sh.seg_start, sh.seg_end,
                                            ctx.pvec)
    pres = tait_pressure(dens, params)
    fargs = ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens,
                               tait_pd2(dens, params))
    return dargs, fargs, dens, pres


def coupled_step_cuda(state: FluidState, params: SimParams,
                      grid: gridlib.Grid, cfg: SimConfig, bodies,
                      boundary: Optional[BoundaryData] = None):
    """One single-phase coupled step; returns ``(new_state, new_bodies,
    StepDiagnostics)``, the new state in hash-sorted order and the bodies
    a tuple."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    shells = body_shells(ctx, grid, bodies)
    _, fargs, dens, pres = coupled_operands(ctx, params, cfg, shells)
    force = SP.fluid_force_sweep(cfg, *fargs,
                                 moving_boundary=ctx.moving_boundary)
    Fs, Ts = rigid_extras(bodies, boundary, params, cfg)
    for k, sh in enumerate(shells):
        f_body = SP.body_force_sweep(cfg, fargs[0], sh.src, sh.seg_start,
                                     sh.seg_end, ctx.pvec)
        force = force + f_body
        Fk, Tk = reaction(ctx, f_body, bodies[k].com)
        Fs[k], Ts[k] = Fs[k] + Fk, Ts[k] + Tk

    dt, pm, g = params.dt, params.particle_mass, params.gravity
    nv = [v + (dt / pm) * (force[:, k] + pm * g[k])
          for k, v in enumerate((ctx.vx, ctx.vy, ctx.vz))]
    pos, vel = _integrate(ctx, dt, nv, nv)
    new_bodies = tuple(integrate_rigid(b, Fs[k], Ts[k], dt, g)
                       for k, b in enumerate(bodies))
    active = ctx.active
    new_state = FluidState(
        pos=pos, vel=vel,
        pressure=torch.where(active, pres, torch.zeros_like(pres)),
        num_active=state.num_active)
    return (new_state, new_bodies,
            _diagnostics(state, dens, active, params.rest_density))


def coupled_multiphase_operands(ctx: SweepCtx, params: SimParams,
                                cfg: SimConfig, shells):
    """The force and body sweeps' operands of one multiphase coupled step:
    ``(fargs, q8b, dens, pres)`` with the multiphase force sweep's
    ``(q, src, seg_start, seg_end, pvec)``, the body sweeps' query
    ``x y z v bp fr``, the adapted density with every shell's ψ-density
    (rescaled by ρ0_i/ρ₀) and its pressure. The density sweeps run here."""
    from .wcsph_cuda import multiphase_density_operands
    mass, rho0 = ctx.mass, ctx.rho0
    dargs = multiphase_density_operands(ctx)
    dout = SP.multiphase_density_sweep(cfg, *dargs)
    delta, bsum = dout[:, 0], dout[:, 1]
    for sh in shells:
        bsum = bsum + SP.body_density_sweep(cfg, dargs[0], sh.src4,
                                            sh.seg_start, sh.seg_end,
                                            ctx.pvec)
    dens = mass * delta + (rho0 / params.rest_density) * bsum
    pres = tait_pressure(dens, params, rho0)
    inv_rho = 1.0 / torch.clamp(dens, min=1e-12)
    vol = 1.0 / torch.clamp(delta, min=1e-12)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    fargs = multiphase_force_args(ctx, vel, vol, inv_rho, pres * vol * vol)
    inv_r2 = inv_rho * inv_rho
    bp = (rho0 / params.rest_density) * torch.clamp(pres, min=0.0) * inv_r2
    q8b = ctx.queries(*vel, bp, mass * inv_r2)
    return fargs, q8b, dens, pres


def coupled_step_multiphase_cuda(state: FluidState, params: SimParams,
                                 grid: gridlib.Grid, cfg: SimConfig, bodies,
                                 boundary: Optional[BoundaryData] = None):
    """One multiphase coupled step (surface tension NONE or BECKER);
    returns ``(new_state, new_bodies, StepDiagnostics)``, the new state
    with its ``mass`` and ``rho0`` in hash-sorted order, the density errors
    against each particle's own ρ₀."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    shells = body_shells(ctx, grid, bodies)
    fargs, q8b, dens, pres = coupled_multiphase_operands(ctx, params, cfg,
                                                         shells)
    acc = SP.multiphase_force_sweep(cfg, *fargs,
                                    moving_boundary=ctx.moving_boundary)
    Fs, Ts = rigid_extras(bodies, boundary, params, cfg)
    for k, sh in enumerate(shells):
        a_body = SP.multiphase_body_sweep(cfg, q8b, sh.src, sh.seg_start,
                                          sh.seg_end, ctx.pvec)
        acc = acc + a_body
        Fk, Tk = reaction(ctx, ctx.mass[:, None] * a_body, bodies[k].com)
        Fs[k], Ts[k] = Fs[k] + Fk, Ts[k] + Tk

    dt, g = params.dt, params.gravity
    nv = [v + dt * (acc[:, k] + g[k])
          for k, v in enumerate((ctx.vx, ctx.vy, ctx.vz))]
    pos, vel = _integrate(ctx, dt, nv, nv)
    new_bodies = tuple(integrate_rigid(b, Fs[k], Ts[k], dt, g)
                       for k, b in enumerate(bodies))
    active = ctx.active
    new_state = FluidState(
        pos=pos, vel=vel,
        pressure=torch.where(active, pres, torch.zeros_like(pres)),
        num_active=state.num_active, mass=ctx.mass, rho0=ctx.rho0)
    return (new_state, new_bodies,
            _diagnostics(state, dens, active, ctx.rho0))
