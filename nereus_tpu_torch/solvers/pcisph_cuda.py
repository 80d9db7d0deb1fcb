"""The PCISPH step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.pcisph_pallas.pcisph_step_pallas``).

Density → advection forces (pressure off) + gravity → warm start
p⁰ = ``pcisph_warm_frac``·max(p_prev, 0) and its pressure force →
corrective loop (per iteration: predict x* from the current pressure
force, the density ρ* at x* over the start-of-step ranges, ρ_err =
max(ρ* − ρ₀, 0) on active rows, p += δ·ρ_err, the pressure force of p)
until max ρ_err ≤ ``tol_frac``·ρ₀ after at least ``pcisph_min_iters`` →
symplectic Euler. On CUDA tensors the sweeps are the hand-written kernels
of ``csrc/``; on CPU tensors their plain PyTorch versions.

The predicted density is the density kernel fed x* in its one matrix,
whose fluid rows are also its queries (:func:`predicted_density_operands`),
over the ranges built from the start-of-step positions: a particle whose
x* crosses a cell edge keeps its frozen neighbors, as the TPU kernel's
``geom_offset=3`` keeps them.

The loop is a :class:`~.predicated_loop.PredicatedLoop` that commits p and
the pressure force and reads its condition on the host once per
:data:`SYNC_EVERY` launched iterations from ``pcisph_min_iters`` on.

JAX skips the warm sweep with ``lax.cond(max(p⁰) > 0)``. Here it is
launched on every step with the warm start on: at p⁰ = 0 every pair term
of the pressure force is exactly ±0, so the force is 0 and the step's
result is the skipped sweep's, without a host read of max(p⁰).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .predicated_loop import LoopCounts, PredicatedLoop
from .sweep_common import SweepCtx, build_sweep_ctx, pd2_operands
from .wcsph import StepDiagnostics

# Corrective iterations launched between two host reads of the loop
# condition. The settled block's loop runs 30-100 iterations on most steps
# (PERF.md): a read after every iteration launches no frozen iteration,
# and the host-bound step measured faster with it than with 3 or 6.
SYNC_EVERY = 1

# corrective iterations launched and host reads of their condition
LOOP = LoopCounts()


def predicted_density_operands(ctx: SweepCtx, particle_mass):
    """The predicted-density sweep's operands, loop-invariant: returns
    ``at(x_pred) -> (q, src, seg_start, seg_end, pvec)``, which writes the
    (C, 3) predicted positions in place into columns 0-2 of the fluid rows
    of the one (C [+ Mb], 4) matrix ``x y z ψ`` (:meth:`SweepCtx.
    density_operands`), whose first C rows are the queries. The boundary
    rows keep their positions and the ranges stay the start-of-step
    ones."""
    args = ctx.density_operands(particle_mass)
    src = args[1]

    def at(x_pred):
        src[:ctx.c, :3] = x_pred
        return args
    return at


def pcisph_step_cuda(state: FluidState, params: SimParams,
                     grid: gridlib.Grid, cfg: SimConfig,
                     boundary: Optional[BoundaryData] = None, *,
                     delta: float, tol_frac: float = 0.01):
    """One PCISPH step with stiffness ``delta``; returns ``(new_state,
    StepDiagnostics)`` with the new state in hash-sorted order."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    # (C, 3) rows: one launch per elementwise operation, not three
    pos3 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    vel3 = torch.stack(vel, dim=1)
    active = ctx.active
    dt = params.dt
    pm = params.particle_mass
    dt_m = dt / pm
    rest = params.rest_density
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    delta = torch.as_tensor(delta, dtype=cfg.dtype, device=ctx.px.device)

    # -- density + advection forces ----------------------------------------
    dens = SP.density_sweep(cfg, *ctx.density_operands(pm))
    dens_safe = torch.clamp(dens, min=1e-12)
    inv_d2 = 1.0 / (dens_safe * dens_safe)
    zero = torch.zeros_like(dens)
    f_adv = SP.fluid_force_sweep(cfg, *ctx.force_operands(vel, dens, zero),
                                 include_pressure=False,
                                 moving_boundary=ctx.moving_boundary)
    f_adv = f_adv + pm * params.gravity
    tol = tol_frac * rest

    # loop-invariant operands, each sweep writing its columns in place
    pred_at = predicted_density_operands(ctx, pm)
    pd2_at = pd2_operands(ctx)

    def pressure_force(p):
        return SP.pressure_force_sweep(cfg, *pd2_at(p * inv_d2),
                                       plan=ctx.tile_plan)

    # -- warm start: a fraction of the previous step's pressure ------------
    p = zero
    f_p = torch.zeros_like(f_adv)
    if cfg.pcisph_warm_start:
        p = cfg.pcisph_warm_frac * torch.clamp(
            torch.where(active, ctx.pres_prev, zero), min=0.0)
        f_p = pressure_force(p)

    # -- predictive-corrective loop, predicated on the device --------------
    loop = PredicatedLoop(LOOP, like=dens, tol=tol,
                          min_iters=cfg.pcisph_min_iters,
                          max_iters=cfg.pcisph_max_iters,
                          sync_every=SYNC_EVERY, err0=math.inf)
    for _ in loop:
        x_pred = pos3 + dt * (vel3 + dt_m * (f_adv + f_p))
        rho_pred = SP.predicted_density_sweep(cfg, *pred_at(x_pred))
        rho_err = torch.where(active, torch.clamp(rho_pred - rest, min=0.0),
                              zero)
        p_new = p + delta * rho_err
        f_new = pressure_force(p_new)
        p = loop.commit(p_new, p)
        f_p = loop.commit(f_new, f_p)
        loop.advance(torch.max(rho_err))

    # -- integration ---------------------------------------------------------
    v = vel3 + dt_m * (f_adv + f_p)
    act = active[:, None]
    new_state = FluidState(
        pos=torch.where(act, pos3 + dt * v, pos3),
        vel=torch.where(act, v, vel3),
        pressure=torch.where(active, p, zero),
        num_active=state.num_active)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(active, dens, zero)),
        # the max positive predicted-density error: compression-side
        mean_density_error=loop.err / rest,
        mean_compression=loop.err / rest,
        seg_overflow=torch.zeros((), dtype=torch.int32, device=dens.device),
        solver_iters=loop.it,
    )
    return new_state, diag
