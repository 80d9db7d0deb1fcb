"""The PBF step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.pbf_pallas.pbf_step_pallas``).

Advection v* = v + dt·g, x* = x + dt·v* on active rows → one sweep
context on x*, whose ranges every sweep of the step walks (the
frozen-neighborhood contract of PCISPH's predicted density) →
``cfg.pbf_iters`` iterations, each a λ sweep at the iterate x (ρ, Σψ∇W,
Σ|ψ∇W|²; λ = −max(ρ/ρ₀ − 1, 0)/((|Σψ∇W|² + Σ|ψ∇W|²)/ρ₀² + ε)) and a Δp
sweep at the same x (x += Δp/ρ₀ on active rows) → v = v* + (x − x*)/dt
→ optional vorticity confinement (ω sweep, then N = Σ(m/ρ_j·|ω_j|)∇W
through the λ kernel on the fluid rows, both at x*) → optional XSPH (the
XSPH kernel at x*). The ρ the step reports, and that vorticity and XSPH
read, is the last λ sweep's: the density at the iterate before the last
correction, as in JAX. On CUDA tensors the sweeps are the hand-written
kernels of ``csrc/``; on CPU tensors their plain PyTorch versions.

The iterations are a plain loop with no host read. Their operands are
built once per step and written in place (:func:`pbf_operands`).
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
    """The λ and Δp sweeps' operands, loop-invariant: returns
    ``(lam_at, dp_at)``. ``lam_at(x)`` writes the (C, 3) iterate in place
    into the 4-wide queries and the fluid rows of the λ source ``x y z m``
    and returns ``(q, src, seg_start, seg_end, pvec)``; ``dp_at(lam)``
    writes λ into query column 3 and returns the Δp sweep's operands, whose
    source's fluid rows are the queries ``x y z λ`` themselves. Boundary
    rows ``x y z ψ_b``; the ranges stay the context's, built at x*."""
    c = ctx.c
    src_lam = ctx.pack_psi(ctx.queries(particle_mass.expand(c)))
    src_dp = ctx.pack_psi(ctx.queries(width=4))
    q = src_dp[:c]
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)

    def lam_at(x):
        q[:, :3] = x
        src_lam[:c, :3] = x
        return (q, src_lam, *rng)

    def dp_at(lam):
        q[:, 3] = lam
        return (q, src_dp, *rng)
    return lam_at, dp_at


def lambda_of(al, rest_density, cfg: SimConfig):
    """(ρ, λ) from the λ sweep's (N, 5) output, in the JAX step's order."""
    dens = al[:, 0]
    comp = torch.clamp(dens / rest_density - 1.0, min=0.0)
    denom = (al[:, 1] ** 2 + al[:, 2] ** 2 + al[:, 3] ** 2
             + al[:, 4]) / (rest_density * rest_density)
    return dens, -comp / (denom + cfg.pbf_eps)


def omega_operands(ctx: SweepCtx, v, mrho):
    """The vorticity sweep's operands at x* from the (C,) velocity columns
    ``v`` and m/ρ: one (C, 8) matrix ``x y z v m/ρ 0`` as query and
    source, the fluid ranges."""
    w8 = ctx.pack(v, mrho, boundary=False)
    return w8, w8, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec


def grad_operands(ctx: SweepCtx, psi):
    """The operands of N = Σψ_j∇W at x* (the λ kernel on the fluid
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
    al = SP.pbf_lambda_sweep(cfg, *grad_operands(ctx, mrho * omn))
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
        dens, lam = lambda_of(SP.pbf_lambda_sweep(cfg, *lam_at(x)), rest,
                              cfg)
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
