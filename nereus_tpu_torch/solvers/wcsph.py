"""Weakly-compressible SPH (Tait EOS) solver (PyTorch port of
``nereus_tpu.solvers.wcsph``).

One step = hash → sort → density sweep → Tait EOS → fused force sweep →
symplectic Euler (``SPH::update``, ``sph/sph.cpp:215-285``), with no host
synchronisation; optionally the implicit viscosity solve (Weiler 2018) in
place of the explicit viscosity, and XSPH on the advection velocity. A
multiphase state (per-particle mass and ρ₀) runs the adapted-density,
volume-form step. :func:`wcsph_step` checks the configuration and runs the sweep steps
of :mod:`.wcsph_cuda`; the sweeps run the CUDA kernels on a GPU and their
plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import grid as gridlib
from ..params import SimConfig, SimParams, SurfaceTensionModel
from ..state import BoundaryData, FluidState


@dataclasses.dataclass(frozen=True)
class StepDiagnostics:
    """Per-step diagnostics, 0-d tensors on the state's device."""

    max_density: torch.Tensor
    mean_density_error: torch.Tensor   # mean |ρ−ρ₀|/ρ₀ over active
    # mean max(ρ−ρ₀, 0)/ρ₀ over active: the compression-side error the
    # incompressibility criterion reads (the |.| one is dominated by
    # free-surface rarefaction)
    mean_compression: torch.Tensor
    # neighbor-window overflow on the JAX side; the port's ranges are
    # exact, so it is 0 by construction
    seg_overflow: torch.Tensor
    solver_iters: torch.Tensor


def density_errors(dens, active, nact, rest):
    """(mean |ρ−ρ₀|/ρ₀, mean max(ρ−ρ₀,0)/ρ₀) over active particles."""
    dev = (dens - rest) / rest
    zero = torch.zeros_like(dev)
    mae = torch.sum(torch.where(active, torch.abs(dev), zero)) / nact
    mc = torch.sum(torch.where(active, torch.clamp(dev, min=0.0), zero)) / nact
    return mae, mc


def tait_pressure(dens, params: SimParams, rho0=None):
    """Tait EOS p = k((ρ/ρ₀)⁷ − 1) (``sph_kernel_impl.cuh:426``); negative
    pressures are not clamped, as in the reference."""
    ratio = dens / (params.rest_density if rho0 is None else rho0)
    r2 = ratio * ratio
    return params.gas_stiffness * (r2 * r2 * r2 * ratio - 1.0)


def tait_pd2(dens, params: SimParams):
    """p/ρ² of the Tait EOS in the operation order of the JAX force pair's
    pd2_j (``pallas_sph.fluid_force_pair``): ρ clamped to 1e-12, ratio =
    ρ·(1/ρ₀), p = k(ratio⁷ − 1), then p·(1/ρ)·(1/ρ). The force sweep's
    query and fluid source rows (one matrix) carry it in slot 7, as pd2_i
    and pd2_j."""
    ds = torch.clamp(dens, min=1e-12)
    ratio = ds * (1.0 / params.rest_density)
    r2 = ratio * ratio
    inv = 1.0 / ds
    return params.gas_stiffness * (r2 * r2 * r2 * ratio - 1.0) * inv * inv


def check_multiphase_cfg(cfg: SimConfig):
    """The JAX multiphase steps' (WCSPH and DFSPH) refusals, with their
    reasons."""
    if cfg.viscosity_model == "implicit":
        raise NotImplementedError("implicit viscosity is single-phase-only")
    if cfg.surface_tension_model == SurfaceTensionModel.AKINCI:
        raise NotImplementedError(
            "AKINCI surface tension is single-phase-only (its curvature "
            "correction has no per-phase meaning); multiphase supports "
            "NONE or BECKER (phase-pair cohesion, SimConfig.st_cross)")


def wcsph_step(state: FluidState, params: SimParams, grid: gridlib.Grid,
               cfg: SimConfig, boundary: Optional[BoundaryData] = None,
               xsph_eps=None):
    """One WCSPH step; returns ``(new_state, StepDiagnostics)`` with the new
    state in hash-sorted order, as the JAX step returns it. A multiphase
    state (``mass``/``rho0`` set) runs the multiphase step; ``xsph_eps``
    and ``viscosity_model="implicit"`` (single phase only) smooth the
    advection velocity and solve the viscosity implicitly. A moving
    ``boundary`` (``vel`` set, ``boundary.move_boundary``) gives the wall
    friction the relative velocity.

    Raises NotImplementedError for what the JAX package refuses and for
    what is not ported yet, rather than ignoring it."""
    if state.multiphase:
        if xsph_eps is not None:
            raise NotImplementedError("XSPH is single-phase-only")
        check_multiphase_cfg(cfg)
    from .wcsph_cuda import wcsph_step_cuda, wcsph_step_multiphase_cuda
    if state.multiphase:
        return wcsph_step_multiphase_cuda(state, params, grid, cfg, boundary)
    return wcsph_step_cuda(state, params, grid, cfg, boundary,
                           xsph_eps=xsph_eps)


def cfl_dt(state: FluidState, params: SimParams, lam: float = 0.4):
    """CFL timestep Δt = λ·h/|v|_max (the reference's disabled block,
    ``sph/sph.cpp:217-231``)."""
    speed = torch.linalg.norm(state.vel, dim=-1)
    vmax = torch.max(torch.where(state.active_mask(), speed,
                                 torch.zeros_like(speed)))
    return torch.where(vmax > 0.0,
                       lam * params.interaction_radius
                       / torch.clamp(vmax, min=1e-12),
                       params.dt)
