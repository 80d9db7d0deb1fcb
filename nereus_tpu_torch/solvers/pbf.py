"""PBF: Position Based Fluids (PyTorch port of ``nereus_tpu.solvers.pbf``;
Macklin & Müller 2013, a solver beyond the reference, which stops at
IISPH).

A fixed number (``SimConfig.pbf_iters``) of Jacobi iterations projects the
particle positions onto the density constraint C_i = ρ_i/ρ₀ − 1 ≤ 0:
λ_i = −max(C_i, 0) / ((|Σψ∇W|² + Σ|ψ∇W|²)/ρ₀² + ε), then
Δp_i = (1/ρ₀)(Σ_j m(λ_i + λ_j + scorr)∇W + Σ_b ψ_b λ_i ∇W) with the
anti-clustering scorr = −(W/W(Δq·h))⁴·k, and v = v* + (x_new − x*)/dt;
optionally vorticity confinement (paper §5) and XSPH smoothing of the
carried velocity. :func:`pbf_step` checks the configuration and runs the
sweep step of :mod:`.pbf_cuda`.
"""

from __future__ import annotations

from typing import Optional

from .. import grid as gridlib
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState


def pbf_step(state: FluidState, params: SimParams, grid: gridlib.Grid,
             cfg: SimConfig, boundary: Optional[BoundaryData] = None,
             xsph_eps=None, vorticity_eps=None):
    """One PBF step; returns ``(new_state, StepDiagnostics)`` with the new
    state in hash-sorted order. ``xsph_eps`` (None = off) smooths the
    carried velocity (Monaghan XSPH, the paper's viscosity, typical
    0.01-0.05); ``vorticity_eps`` (None = off) adds vorticity confinement
    v += dt·ε(N̂ × ω). ``solver_iters`` reports ``cfg.pbf_iters`` and
    ``pressure`` the last λ. A boundary's velocity is accepted and read
    by nothing: neither PBF wall pair reads a wall velocity, as in the JAX
    step. A multiphase state raises, as the JAX step does."""
    if state.multiphase:
        raise NotImplementedError(
            "multiphase (per-particle mass/rho0) is WCSPH-only; "
            "pbf refuses rather than silently dropping the columns")
    from .pbf_cuda import pbf_step_cuda
    return pbf_step_cuda(state, params, grid, cfg, boundary,
                         xsph_eps=xsph_eps, vorticity_eps=vorticity_eps)
