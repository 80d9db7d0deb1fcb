"""The IISPH step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.iisph_pallas.iisph_step_pallas``).

Density → advection forces (pressure off) → fused d_ii + ρ_adv → a_ii →
relaxed-Jacobi loop (per iteration: Σd_ij·p_j over the fluid rows, then
the fused fluid + boundary Jacobi sum) → pressure force → symplectic
Euler. On CUDA tensors the sweeps are the hand-written kernels of
``csrc/sph_sweep.cu`` and ``csrc/iisph_sweep.cu``; on CPU tensors their
plain PyTorch versions.

The JAX step runs the solve as one on-device ``lax.while_loop``; here it
is a :class:`~.predicated_loop.PredicatedLoop` that commits ``p`` and
``ρ_err`` and reads its condition on the host once per
:data:`SYNC_EVERY` launched iterations from ``iisph_min_iters`` on, the
only synchronisation in the step. Launches therefore count iterations
launched, which may exceed ``solver_iters`` by up to ``SYNC_EVERY − 1``.

The loop-invariant source and query matrices are built once per step;
each iteration writes its pressure-dependent columns into them in place.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .predicated_loop import LoopCounts, PredicatedLoop
from .sweep_common import build_sweep_ctx
from .wcsph import StepDiagnostics

# Jacobi iterations launched between two host reads of the loop condition.
# A read waits for the device to drain its queue; an iteration launched
# past convergence costs two sweeps. The settled 1M block converges in 2-3
# iterations per step once its first steps are past (PERF.md), so a read
# every 2 iterations wastes at most one.
SYNC_EVERY = 2


# Jacobi iterations launched and host reads of their condition
LOOP = LoopCounts()


def iisph_step_cuda(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData] = None,
                    tol: float = 1.0, omega: float = 0.5):
    """One IISPH step; returns ``(new_state, StepDiagnostics)`` with the
    new state in hash-sorted order."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    c = ctx.c
    active = ctx.active
    nact = torch.clamp(state.num_active.to(cfg.dtype), min=1.0)
    dt = params.dt
    pm = params.particle_mass
    rest = params.rest_density
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)

    # -- density: fluid ψ = m, boundary ψ_b; self-pairs included -----------
    # (its query, x y z m, is also Σd_ij·p_j's, which reads x y z)
    dargs = ctx.density_operands(pm)
    q4 = dargs[0]
    dens = SP.density_sweep(cfg, *dargs)
    dens_safe = torch.clamp(dens, min=1e-12)
    inv_d2 = 1.0 / (dens_safe * dens_safe)

    # -- non-pressure (advection) forces -----------------------------------
    zero = torch.zeros_like(dens)
    f_adv = SP.fluid_force_sweep(cfg, *ctx.force_operands(vel, dens, zero),
                                 include_pressure=False,
                                 moving_boundary=ctx.moving_boundary)
    g = params.gravity
    vel_adv = tuple(v + (dt / pm) * (f_adv[:, k] + pm * g[k])
                    for k, v in enumerate(vel))

    # -- d_ii + ρ_adv (fused fluid + boundary), then a_ii -------------------
    src_p = ctx.pack(vel_adv, pm)
    pr = SP.dii_rhoadv_sweep(cfg, ctx.queries(*vel_adv, *vel, inv_d2,
                                              width=12), src_p, *rng)
    dii = (pr[:, 0], pr[:, 1], pr[:, 2])
    rho_adv = dens + pr[:, 3]
    dpi = pm * inv_d2
    aii = SP.aii_sweep(cfg, ctx.queries(*dii, dpi, width=8), src_p, *rng)

    p = 0.5 * ctx.pres_prev   # p⁰ = ½·p_prev (sph_kernel_impl.cuh:1197)

    # -- relaxed-Jacobi solve, predicated on the device ---------------------
    dt2 = dt * dt
    denom = aii * dt2
    live = torch.abs(denom) > 1e-12
    w_denom = omega / denom
    b = rest - rho_adv
    # loop-invariant operands; each iteration writes its columns in place:
    # src_pd slot 6 = p/ρ² (fluid rows; the boundary rows keep ψ_b for the
    # pressure force), src_j slots 6-9 = p, Σd_jk·p_k, qj cols 3-6 =
    # Σd_ij·p_j, (m/ρ²)·p
    src_pd = ctx.pack((zero, zero, zero), p * inv_d2)
    src_j = ctx.pack_wide([*dii, p, zero, zero, zero])
    qj = ctx.queries(zero, zero, zero, zero, width=8)

    loop = PredicatedLoop(LOOP, like=dens, tol=tol,
                          min_iters=cfg.iisph_min_iters,
                          max_iters=cfg.iisph_max_iters,
                          sync_every=SYNC_EVERY, err0=2.0 * tol)
    for _ in loop:
        torch.mul(p, inv_d2, out=src_pd[:c, 6])
        sum_dij = SP.sum_dij_sweep(cfg, q4, src_pd, ctx.seg_start_f,
                                   ctx.seg_end_f, ctx.pvec)
        src_j[:c, 6] = p
        src_j[:c, 7:10] = sum_dij
        qj[:, 3:6] = sum_dij
        torch.mul(dpi, p, out=qj[:, 6])
        fb = SP.jacobi_sweep(cfg, qj, src_j, *rng)

        p_new = torch.where(live, (1.0 - omega) * p
                            + w_denom * (b - dt2 * fb), zero)
        p_new = torch.clamp(p_new, min=0.0)
        rho_corr = rho_adv + dt2 * (fb + aii * p)
        err = torch.clamp(rho_corr - rest, min=0.0)
        err_new = torch.sum(torch.where(active, err, zero)) / nact
        p = loop.commit(p_new, p)
        loop.advance(err_new)

    # -- pressure force + integration --------------------------------------
    pd2 = p * inv_d2
    src_pd[:c, 6] = pd2
    f_p = SP.pressure_force_sweep(cfg, ctx.queries(pd2), src_pd, *rng,
                                  plan=ctx.tile_plan)

    pos = (ctx.px, ctx.py, ctx.pz)
    nv, npos = [], []
    for k in range(3):
        v = vel_adv[k] + (dt / pm) * f_p[:, k]
        nv.append(torch.where(active, v, vel[k]))
        npos.append(torch.where(active, pos[k] + dt * v, pos[k]))

    new_state = FluidState(
        pos=torch.stack(npos, dim=1),
        vel=torch.stack(nv, dim=1),
        pressure=torch.where(active, p, zero),
        num_active=state.num_active)
    zero_i = torch.zeros((), dtype=torch.int32, device=dens.device)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(active, dens, zero)),
        # the solver residual is already clamped-positive (compression)
        mean_density_error=loop.err / rest,
        mean_compression=loop.err / rest,
        seg_overflow=zero_i,
        solver_iters=loop.it,
    )
    return new_state, diag
