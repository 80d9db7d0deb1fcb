"""DFSPH: Divergence-Free SPH (PyTorch port of ``nereus_tpu.solvers.dfsph``;
Bender & Koschier 2015/2017, a solver beyond the reference, which stops at
IISPH).

Two stiffness solves per step share one factor α_i = ρ_i /
max(|Σψ∇W|² + Σ|m∇W|², ε): a divergence solve on the incoming velocities
(Dρ/Dt clamped ≥ 0, κᵛ = Dρ/Dt·α/dt), then, after the non-pressure
forces, a constant-density solve on v* (κ = max(ρ + dt·Dρ/Dt − ρ₀, 0)·
α/dt²); each iteration applies v ← v − dt·Σψ(κ_i/ρ_i + κ_j/ρ_j)∇W.
A multiphase state (per-particle mass and ρ₀) runs the same two solves on
the adapted number-density domain (δ̂ = ρ̃/m_i, V̂ = 1/δ̂; the derivation
block of ``nereus_tpu/solvers/dfsph.py``), which reduces exactly to the
single-phase step at uniform phase columns. ``viscosity_model="implicit"``
(single phase) adds the Weiler-2018 implicit viscosity solve on v*
(:mod:`.viscosity`). :func:`dfsph_step` checks the configuration and runs
the sweep steps of :mod:`.dfsph_cuda`.
"""

from __future__ import annotations

from typing import Optional

from .. import grid as gridlib
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .wcsph import check_multiphase_cfg


def dfsph_step(state: FluidState, params: SimParams, grid: gridlib.Grid,
               cfg: SimConfig, boundary: Optional[BoundaryData] = None,
               tol: float = 1.0, tol_v: float = 1.0):
    """One DFSPH step; returns ``(new_state, StepDiagnostics)`` with the
    new state (a multiphase state's mass and ρ₀ too) in hash-sorted order.
    A moving ``boundary`` (``vel`` set) enters Dρ/Dt (dδ̂/dt), the wall
    friction and the viscous Laplacian.

    ``tol`` bounds the mean clamped predicted density error of the
    constant-density solve, ``tol_v`` the per-step density drift
    dt·mean(max(Dρ/Dt, 0)) of the divergence solve, both in kg/m³
    (1 ≙ 0.1% of ρ₀). ``solver_iters`` is the total of both loops'
    iterations; ``pressure`` carries the accumulated κ, the next step's
    warm start. A multiphase state refuses what the JAX multiphase step
    refuses (AKINCI surface tension, implicit viscosity). Raises
    NotImplementedError for what is not ported, rather than ignoring it."""
    if state.multiphase:
        check_multiphase_cfg(cfg)
    from .dfsph_cuda import dfsph_step_cuda, dfsph_step_multiphase_cuda
    step = dfsph_step_multiphase_cuda if state.multiphase else dfsph_step_cuda
    return step(state, params, grid, cfg, boundary, tol=tol, tol_v=tol_v)
