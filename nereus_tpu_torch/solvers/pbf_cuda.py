"""The PBF step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.pbf_pallas.pbf_step_pallas``).

Advection v* = v + dt·g, x* = x + dt·v* on active rows → one sweep
context on x*, whose ranges every sweep of the step walks (the
frozen-neighborhood contract of PCISPH's predicted density) →
``cfg.pbf_iters`` iterations, each a λ sweep at the iterate x (ρ and
λ = −max(ρ/ρ₀ − 1, 0)/((|Σψ∇W|² + Σ|ψ∇W|²)/ρ₀² + ε), formed in the
kernel) and a Δp sweep at the same x on that λ (x += Δp/ρ₀ on active
rows) → v = v* + (x − x*)/dt → optional vorticity confinement (ω sweep,
then N = Σ(m/ρ_j·|ω_j|)∇W, the λ sums over the fluid rows, both at x*) →
optional XSPH (the XSPH kernel at x*). The ρ the step reports, and that
vorticity and XSPH read, is the last λ sweep's: the density at the
iterate before the last correction, as in JAX. On CUDA tensors the sweeps
are the hand-written kernels of ``csrc/``; on CPU tensors their plain
PyTorch versions.

The iterations are a plain loop with no host read: per iteration the
iterate and then λ are written into the step's one operand matrix
(:func:`pbf_operands`), around the λ kernel, then the Δp kernel and the
x update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .sweep_common import SweepCtx, build_sweep_ctx
from .wcsph import StepDiagnostics, density_errors
from .wcsph_cuda import xsph_operands


def pbf_operands(ctx: SweepCtx, particle_mass):
    """The λ and Δp sweeps' operands on one (C [+ Mb], 4) matrix built
    once per step, fluid rows ``x y z m``, then the boundary rows
    ``x y z ψ_b`` (:meth:`SweepCtx.density_operands`); returns ``(lam_at,
    dp_at)``. ``lam_at(x)`` writes the (C, 3) iterate into the fluid
    rows' x y z, in place, and returns ``(q, src, seg_start, seg_end,
    pvec)``: q the fluid rows, src the whole matrix, the ranges the
    context's, built at x*; the λ sweep's operands (it takes ψ = m from
    pvec). ``dp_at(lam)`` writes λ into the fluid rows' slot 3 and
    returns the same tuple, now the Δp sweep's operands ``x y z λ``."""
    args = ctx.density_operands(particle_mass)
    q = args[0]

    def lam_at(x):
        q[:, :3] = x
        return args

    def dp_at(lam):
        q[:, 3] = lam
        return args
    return lam_at, dp_at


def omega_operands(ctx: SweepCtx, v, mrho):
    """The vorticity sweep's operands at x* from the (C,) velocity columns
    ``v`` and m/ρ: one (C, 8) matrix ``x y z v m/ρ 0`` built through
    planes (:meth:`SweepCtx.pack_fluid`) as query and source, the fluid
    ranges."""
    w8 = ctx.pack_fluid(v, mrho)
    return w8, w8, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec


def grad_operands(ctx: SweepCtx, psi):
    """The operands of N = Σψ_j∇W at x* (the λ sums on the fluid
    ranges): one (C, 4) matrix ``x y z ψ`` as query and source."""
    n4 = ctx.queries(psi)
    return n4, n4, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec


def confinement(ctx: SweepCtx, cfg: SimConfig, params: SimParams, v, dens,
                eps):
    """Vorticity confinement v + dt·ε(N̂ × ω) on the (C,) velocity columns
    ``v``, with N̂ = N·rsqrt(max(|N|², 1e-20)) as the Pallas route takes
    it; returns the new columns."""
    mrho = params.particle_mass / torch.clamp(dens, min=1e-12)
    om = SP.pbf_omega_sweep(cfg, *omega_operands(ctx, v, mrho))
    ox, oy, oz = om.unbind(1)
    omn = torch.sqrt(ox * ox + oy * oy + oz * oz)
    al = SP.pbf_grad_sweep(cfg, *grad_operands(ctx, mrho * omn))
    nx, ny, nz = al[:, 1], al[:, 2], al[:, 3]
    ninv = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    f = ((ny * oz - nz * oy) * ninv, (nz * ox - nx * oz) * ninv,
         (nx * oy - ny * ox) * ninv)
    k = params.dt * eps
    return [vk + k * fk for vk, fk in zip(v, f)]


def advected(state: FluidState, params: SimParams) -> FluidState:
    """The state after the external-force advection, v* = v + dt·g and
    x* = x + dt·v* on active rows: the state whose sweep context every
    sweep of the step walks."""
    dt = params.dt
    mask = state.active_mask()[:, None]
    vel_star = torch.where(mask, state.vel + dt * params.gravity, state.vel)
    pos_star = torch.where(mask, state.pos + dt * vel_star, state.pos)
    return dataclasses.replace(state, pos=pos_star, vel=vel_star)


def pbf_step_cuda(state: FluidState, params: SimParams, grid: gridlib.Grid,
                  cfg: SimConfig, boundary: Optional[BoundaryData] = None,
                  xsph_eps=None, vorticity_eps=None):
    """One PBF step; returns ``(new_state, StepDiagnostics)`` with the new
    state in hash-sorted order."""
    dt = params.dt
    rest = params.rest_density
    ctx = build_sweep_ctx(advected(state, params), params, grid, cfg,
                          boundary)
    active = ctx.active
    act = active[:, None]
    x0 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    v_star = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)

    # -- the fixed Jacobi iterations over the ranges built at x* ------------
    lam_at, dp_at = pbf_operands(ctx, params.particle_mass)
    x = x0
    dens = lam = torch.zeros_like(ctx.px)
    for _ in range(cfg.pbf_iters):
        dens, lam = SP.pbf_lambda_sweep(cfg, *lam_at(x)).unbind(1)
        dp = SP.pbf_dp_sweep(cfg, *dp_at(lam))
        x = torch.where(act, x + dp / rest, x)

    # -- velocities, vorticity confinement, XSPH (geometry at x*) -----------
    v = list((v_star + (x - x0) / dt).unbind(1))
    if vorticity_eps is not None:
        v = confinement(ctx, cfg, params, v, dens, vorticity_eps)
    if xsph_eps is not None:
        sm = SP.xsph_sweep(cfg, *xsph_operands(ctx, v, dens))
        v = [vk + xsph_eps * sm[:, k] for k, vk in enumerate(v)]

    zero = torch.zeros_like(dens)
    new_state = FluidState(
        pos=x, vel=torch.where(act, torch.stack(v, dim=1), v_star),
        pressure=torch.where(active, lam, zero),
        num_active=state.num_active)
    nact = torch.clamp(state.num_active.to(dens.dtype), min=1.0)
    mae, mc = density_errors(dens, active, nact, rest)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(active, dens, zero)),
        mean_density_error=mae, mean_compression=mc,
        seg_overflow=torch.zeros((), dtype=torch.int32, device=dens.device),
        # a fill on the device: a tensor from a host scalar would copy and
        # wait for the stream on every step
        solver_iters=torch.full((), cfg.pbf_iters, dtype=torch.int32,
                                device=dens.device))
    return new_state, diag
