"""The IISPH step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.iisph_pallas.iisph_step_pallas``).

Density → advection forces (pressure off) → d_ii, ρ_adv and a_ii in one
fused fluid + boundary sweep → relaxed-Jacobi loop (per iteration:
Σd_ij·p_j over the fluid rows, then the fused fluid + boundary Jacobi
sum) → pressure force → symplectic Euler. On CUDA tensors the sweeps are
the hand-written kernels of ``csrc/sph_sweep.cu`` and
``csrc/iisph_sweep.cu``; on CPU tensors their plain PyTorch versions.

The JAX step runs the solve as one on-device ``lax.while_loop``; here it
is a :class:`~.predicated_loop.PredicatedLoop` that commits ``p`` and
``ρ_err`` and reads its condition on the host once per
:data:`SYNC_EVERY` launched iterations from ``iisph_min_iters`` on, the
only synchronisation in the step. Launches therefore count iterations
launched, which may exceed ``solver_iters`` by up to ``SYNC_EVERY − 1``.

The pre-loop sweep reads one (C + Mb, 12) matrix
(:func:`dii_aii_operands`) whose first C rows are its queries; the JAX
step runs it as two sweeps, d_ii + ρ_adv and then a_ii on that d_ii, and
the kernel forms a_ii from the same neighbour sums in its epilogue.
The loop-invariant source and query matrices are built once per step by
:func:`sum_dij_operands` and :func:`jacobi_operands`; each iteration
writes its pressure-dependent columns into them in place, each once.
Σd_ij·p_j reads one (C, 4) matrix ``x y z p/ρ²`` as queries and source,
which after the loop, holding the final p/ρ², is the pressure force's
query. The Jacobi source carries e_j = d_jj·p_j + Σd_jk·p_k in its fluid
rows' slots 3-5; after the loop, with p/ρ² in their slot 6
(:func:`pressure_source`), it is the pressure force's source.
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


def dii_aii_operands(ctx, vel_adv, pm, inv_d2):
    """The d_ii, ρ_adv and a_ii sweep's operands ``(q, src, seg_start,
    seg_end, pvec)`` on one (C + Mb, 12) matrix: fluid rows ``x y z v_adv
    m v 1/ρ² 0`` (``vel_adv`` and the state's v three (C,) columns each,
    ``pm`` the particle mass, ``inv_d2`` = 1/ρ²), then the wall rows
    ``x y z v_b ψ_b 0…``; ``q`` its first C rows."""
    m = ctx.pack_wide([*vel_adv, pm, ctx.vx, ctx.vy, ctx.vz, inv_d2])
    return m[:ctx.c], m, ctx.seg_start, ctx.seg_end, ctx.pvec


def sum_dij_operands(ctx, inv_d2):
    """The Σd_ij·p_j sweep's operands on one (C, 4) matrix ``x y z p/ρ²``:
    returns ``at(p) -> (q, src, seg_start, seg_end, pvec)``, which writes
    p·(1/ρ²) (``inv_d2``) in place into slot 3; ``q`` and ``src`` are the
    matrix, the ranges its 9 fluid rows."""
    m = ctx.queries(torch.zeros_like(ctx.px))

    def at(p):
        torch.mul(p, inv_d2, out=m[:, 3])
        return m, m, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec
    return at


def jacobi_operands(ctx, dii, dpi):
    """The Jacobi sweep's operands: the (C, 8) query ``x y z Σd_ij·p_j
    (m/ρ²)·p 0`` and the 8-wide source, fluid rows ``x y z e 0 0``, then
    the wall rows as they are (``x y z v_b ψ_b 0``). Returns ``(at, src)``:
    ``at(p, sum_dij) -> (q, src, seg_start, seg_end, pvec)`` writes
    e = d_jj·p + Σd_jk·p_k (``dii`` (C, 3), one elementwise pass over the
    three columns), Σd_ij·p_j and (m/ρ²)·p (``dpi`` = m/ρ²) in place;
    ``src`` is the source, which :func:`pressure_source` turns into the
    pressure force's after the loop."""
    zero = torch.zeros_like(ctx.px)
    q = ctx.queries(zero, zero, zero, zero, width=8)
    src = ctx.pack((zero, zero, zero), zero)
    c = ctx.c

    def at(p, sum_dij):
        torch.addcmul(sum_dij, dii, p[:, None], out=src[:c, 3:6])
        q[:, 3:6] = sum_dij
        torch.mul(dpi, p, out=q[:, 6])
        return q, src, ctx.seg_start, ctx.seg_end, ctx.pvec
    return at, src


def pressure_source(src, pq):
    """The pressure force's (C + Mb, 8) source after the loop: the Jacobi
    source ``src`` with the final p/ρ² (slot 3 of the Σd_ij·p_j matrix
    ``pq``) written into its fluid rows' slot 6, in place. The wall rows
    carry ψ_b there already, and the force reads x y z and slot 6 alone."""
    src[:pq.shape[0], 6] = pq[:, 3]
    return src


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
    dens = SP.density_sweep(cfg, *ctx.density_operands(pm))
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

    # -- d_ii, ρ_adv and a_ii: one fluid + boundary sweep -------------------
    # (N, 5) columns, each a contiguous plane: dii below is a strided view
    # that the loop's one addcmul reads as it is
    da = SP.dii_aii_sweep(cfg, *dii_aii_operands(ctx, vel_adv, pm, inv_d2))
    dii = da[:, :3]
    rho_adv = dens + da[:, 3]
    aii = da[:, 4]
    dpi = pm * inv_d2

    p = 0.5 * ctx.pres_prev   # p⁰ = ½·p_prev (sph_kernel_impl.cuh:1197)

    # -- relaxed-Jacobi solve, predicated on the device ---------------------
    dt2 = dt * dt
    denom = aii * dt2
    live = torch.abs(denom) > 1e-12
    w_denom = omega / denom
    b = rest - rho_adv
    # loop-invariant operands, each column written once per iteration
    sum_dij_at = sum_dij_operands(ctx, inv_d2)
    jacobi_at, jacobi_src = jacobi_operands(ctx, dii, dpi)

    loop = PredicatedLoop(LOOP, like=dens, tol=tol,
                          min_iters=cfg.iisph_min_iters,
                          max_iters=cfg.iisph_max_iters,
                          sync_every=SYNC_EVERY, err0=2.0 * tol)
    for _ in loop:
        sum_dij = SP.sum_dij_sweep(cfg, *sum_dij_at(p))
        fb = SP.jacobi_sweep(cfg, *jacobi_at(p, sum_dij))

        p_new = torch.where(live, (1.0 - omega) * p
                            + w_denom * (b - dt2 * fb), zero)
        p_new = torch.clamp(p_new, min=0.0)
        rho_corr = rho_adv + dt2 * (fb + aii * p)
        err = torch.clamp(rho_corr - rest, min=0.0)
        err_new = torch.sum(torch.where(active, err, zero)) / nact
        p = loop.commit(p_new, p)
        loop.advance(err_new)

    # -- pressure force + integration --------------------------------------
    # the Σd_ij·p_j matrix at the final p is the query x y z p/ρ²; the
    # Jacobi source, its fluid rows' slot 6 the same p/ρ², the source
    pq = sum_dij_at(p)[0]
    f_p = SP.pressure_force_sweep(cfg, pq, pressure_source(jacobi_src, pq),
                                  *rng, plan=ctx.tile_plan)

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
