"""The WCSPH steps on the sweep kernels (the counterpart of
``nereus_tpu.solvers.wcsph_pallas``).

Single phase (:func:`wcsph_step_cuda`): density sweep (fluid ψ = m and
boundary ψ_b, self term included) → Tait EOS → pd2 = p/max(ρ, 1e-12)²
(:func:`~.wcsph.tait_pd2`) → one fused fluid + boundary force sweep →
symplectic Euler under the ``active`` mask; with
``viscosity_model="implicit"`` the force sweep drops the viscosity and the
wall friction and the implicit viscosity solve (:mod:`.viscosity`)
replaces the new velocities of the active rows; with ``xsph_eps`` one more
sweep over the fluid rows smooths the advection velocity (Monaghan XSPH).

Multiphase (:func:`wcsph_step_multiphase_cuda`): number-density sweep
(fluid ΣW and boundary Σψ_bW in two columns) → ρ̃ = m·δ + (ρ0_i/ρ0_ref)·
Σψ_bW → Tait EOS with per-particle ρ₀ → one fused volume-form
acceleration sweep (walls: penalty and friction) → symplectic Euler.

On CUDA tensors the sweeps are the hand-written kernels of ``csrc/``; on
CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .sweep_common import SweepCtx, build_sweep_ctx
from .viscosity import implicit_viscosity
from .wcsph import (StepDiagnostics, density_errors, tait_pd2,
                    tait_pressure)


class Sweeps(NamedTuple):
    density: Callable
    force: Callable


# the device dispatchers (the step's default), and the plain versions on
# any device (to time the plain single-phase step on a GPU against the
# kernels)
DISPATCH = Sweeps(SP.density_sweep, SP.fluid_force_sweep)
PLAIN = Sweeps(SP.density_sweep_plain, SP.fluid_force_sweep_plain)


def xsph_operands(ctx: SweepCtx, nv, dens):
    """The XSPH sweep's operands from the new velocities ``nv`` (three (C,)
    columns) and the density: ``(q, src, seg_start_f, seg_end_f, pvec)``
    on one (C, 8) matrix ``x y z nv ρ 0`` built through planes
    (:meth:`SweepCtx.pack_fluid`), the query and the source, and the fluid
    ranges."""
    m = ctx.pack_fluid(nv, dens)
    return m, m, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec


def _integrate(ctx: SweepCtx, dt, nv, v_adv):
    """Positions advanced by ``v_adv``, velocities ``nv``, both under the
    ``active`` mask: ``(pos, vel)`` (C, 3)."""
    active = ctx.active
    vel = (ctx.vx, ctx.vy, ctx.vz)
    npos = [torch.where(active, p + dt * v, p)
            for p, v in zip((ctx.px, ctx.py, ctx.pz), v_adv)]
    nvel = [torch.where(active, v1, v0) for v1, v0 in zip(nv, vel)]
    return torch.stack(npos, dim=1), torch.stack(nvel, dim=1)


def _diagnostics(state: FluidState, dens, active, rest):
    nact = torch.clamp(state.num_active.to(dens.dtype), min=1.0)
    mae, mc = density_errors(dens, active, nact, rest)
    zero_i = torch.zeros((), dtype=torch.int32, device=dens.device)
    return StepDiagnostics(
        max_density=torch.max(torch.where(active, dens,
                                          torch.zeros_like(dens))),
        mean_density_error=mae,
        mean_compression=mc,
        seg_overflow=zero_i,
        solver_iters=zero_i.clone(),
    )


def wcsph_step_cuda(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData] = None, *,
                    xsph_eps=None, sweeps: Sweeps = DISPATCH):
    """One single-phase WCSPH step; returns ``(new_state,
    StepDiagnostics)`` with the new state in hash-sorted order.
    ``xsph_eps`` (float or 0-d tensor) smooths the advection velocity:
    positions advance with nv + ε·Σ, the stored velocity stays nv."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    active = ctx.active
    pm = params.particle_mass

    # -- density: fluid ψ = m, boundary ψ_b; self-pairs included -----------
    dens = sweeps.density(cfg, *ctx.density_operands(pm))
    pres = tait_pressure(dens, params)

    # -- forces: viscosity + surface tension + pressure + boundary terms ---
    # (the implicit viscosity solve owns the viscosity and wall friction)
    implicit_visc = cfg.viscosity_model == "implicit"
    force = sweeps.force(cfg, *ctx.force_operands(vel, dens,
                                                  tait_pd2(dens, params)),
                         include_viscosity=not implicit_visc,
                         moving_boundary=ctx.moving_boundary)

    # -- symplectic Euler (``integrate_functor``) --------------------------
    dt = params.dt
    g = params.gravity
    nv = [v + (dt / pm) * (force[:, k] + pm * g[k])
          for k, v in enumerate(vel)]
    if implicit_visc:
        nv3 = torch.stack(nv, dim=1)
        v_sol, _, _ = implicit_viscosity(ctx, params, cfg, dens, nv3)
        nv = torch.where(active[:, None], v_sol, nv3).unbind(1)
    v_adv = nv
    if xsph_eps is not None:
        # XSPH over the fluid rows; ε scales outside the sweep
        sm = SP.xsph_sweep(cfg, *xsph_operands(ctx, nv, dens))
        v_adv = [v + xsph_eps * sm[:, k] for k, v in enumerate(nv)]
    pos, vel_new = _integrate(ctx, dt, nv, v_adv)

    new_state = FluidState(
        pos=pos, vel=vel_new,
        pressure=torch.where(active, pres, torch.zeros_like(pres)),
        num_active=state.num_active)
    return new_state, _diagnostics(state, dens, active, params.rest_density)


def multiphase_density_operands(ctx: SweepCtx):
    """The multiphase density sweep's operands ``(q, src, seg_start,
    seg_end, pvec)`` on one (C [+ Mb], 4) matrix, built as the density's
    (:meth:`SweepCtx.density_operands`): fluid rows ``x y z 0`` (slot 3 is
    not read), then the boundary rows ``x y z ψ_b``; q its first C
    rows."""
    return ctx.density_operands(ctx.px.new_zeros(()))


def multiphase_force_args(ctx: SweepCtx, vel, vol, inv_rho, pv2):
    """The multiphase force sweep's operands ``(q, src, seg_start,
    seg_end, pvec)`` from the velocities ``vel`` (three (C,) columns), the
    volume V = 1/δ, 1/ρ̃ and pV² (0 in DFSPH's non-pressure forces), on
    one (C [+ Mb], 12) matrix: fluid rows ``x y z v V pV² ρ0 1/m m 1/ρ̃``
    (ρ0 for Becker cohesion, the query's and the source's one column),
    then the walls' wide rows; q is its first C rows, so the positions and
    velocities are written once, and without walls the matrix itself."""
    mass = ctx.mass
    src = ctx.pack_wide([*vel, vol, pv2, ctx.rho0, 1.0 / mass, mass,
                         inv_rho])
    q = src if ctx.b_src is None else src[:ctx.c]
    return q, src, ctx.seg_start, ctx.seg_end, ctx.pvec


def multiphase_force_operands(ctx: SweepCtx, params: SimParams, dout):
    """The multiphase force sweep's operands from the density sweep's
    (C, 2) output: ``(args, dens, pres)`` with ``args`` those of
    :func:`multiphase_force_args` on the state's velocities, and the
    adapted density ρ̃ and its pressure, in ``_wcsph_pallas_multiphase``'s
    order."""
    mass, rho0 = ctx.mass, ctx.rho0
    delta = dout[:, 0]
    dens = mass * delta + (rho0 / params.rest_density) * dout[:, 1]
    pres = tait_pressure(dens, params, rho0)
    inv_rho = 1.0 / torch.clamp(dens, min=1e-12)
    vol = 1.0 / torch.clamp(delta, min=1e-12)
    pv2 = pres * vol * vol
    args = multiphase_force_args(ctx, (ctx.vx, ctx.vy, ctx.vz), vol,
                                 inv_rho, pv2)
    return args, dens, pres


def wcsph_step_multiphase_cuda(state: FluidState, params: SimParams,
                               grid: gridlib.Grid, cfg: SimConfig,
                               boundary: Optional[BoundaryData] = None):
    """One multiphase WCSPH step (surface tension NONE or BECKER); returns
    ``(new_state, StepDiagnostics)`` with the new state, its ``mass`` and
    ``rho0`` in hash-sorted order and the density errors taken against
    each particle's own ρ₀."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    active = ctx.active

    dout = SP.multiphase_density_sweep(cfg,
                                       *multiphase_density_operands(ctx))
    args, dens, pres = multiphase_force_operands(ctx, params, dout)
    acc = SP.multiphase_force_sweep(cfg, *args,
                                    moving_boundary=ctx.moving_boundary)

    dt = params.dt
    g = params.gravity
    nv = [v + dt * (acc[:, k] + g[k])
          for k, v in enumerate((ctx.vx, ctx.vy, ctx.vz))]
    pos, vel_new = _integrate(ctx, dt, nv, nv)

    new_state = FluidState(
        pos=pos, vel=vel_new,
        pressure=torch.where(active, pres, torch.zeros_like(pres)),
        num_active=state.num_active, mass=ctx.mass, rho0=ctx.rho0)
    return new_state, _diagnostics(state, dens, active, ctx.rho0)
