"""PCISPH: Predictive-Corrective Incompressible SPH (PyTorch port of
``nereus_tpu.solvers.pcisph``; Solenthaler & Pajarola 2009, the algorithm
the reference's ``Nereus::PCISPH`` allocates for but leaves a stub,
``sph/sph_cuda.cu:944-952``).

One step = density and the non-pressure forces, then the
predictive-corrective loop (predict x* from the current pressure force →
density at x* over the step's start-of-step neighborhoods → p += δ·ρ_err
→ pressure force) until the max positive density error is within
``tol_frac``·ρ₀, then symplectic Euler. The stiffness δ comes from a
prototype filled neighborhood (:func:`pcisph_delta`), computed on the host
once per parameter set. :func:`pcisph_step` checks the configuration and
runs the sweep step of :mod:`.pcisph_cuda`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import grid as gridlib
from .. import kernels as K
from ..params import SimConfig, SimParams, prototype_lattice
from ..state import BoundaryData, FluidState


def pcisph_grad_denom(params: SimParams, cfg: SimConfig,
                      spacing: float | None = None) -> float:
    """The dt-independent lattice term of the PCISPH stiffness,
    S = −(Σ_j ∇W_ij)·(Σ_j ∇W_ij) − Σ_j ∇W_ij·∇W_ij over a template
    particle with a filled neighborhood (a lattice of ``spacing``, default
    one particle diameter, clipped to the support radius). The gradients
    are evaluated in ``cfg.dtype`` and summed in float64, as the JAX
    package does."""
    if spacing is None:
        # one particle diameter: the mass-derived spacing (m/ρ₀)^⅓ is
        # exactly h for the reference's PCISPH mass m = h³ρ₀, a lattice
        # with every neighbor on the support boundary where ∇W = 0
        spacing = 2.0 * float(params.particle_radius)
    pts = prototype_lattice(params, cfg, spacing)
    pts = pts[np.sum(pts * pts, axis=-1) > 1e-12]

    cpu = SimParams(**{f.name: getattr(params, f.name).cpu()
                       for f in dataclasses.fields(params)})
    grads = K.w_default_grad(cfg.kernel_set,
                             torch.as_tensor(pts).to(cfg.dtype), cpu)
    grads = grads.numpy().astype(np.float64)
    sum_g = grads.sum(axis=0)
    sum_gg = float(np.sum(grads * grads))
    denom = -float(sum_g @ sum_g) - sum_gg
    if denom == 0.0:
        raise ValueError(
            "degenerate PCISPH prototype neighborhood (all ∇W = 0); "
            "pass an explicit `spacing` < support radius")
    return denom


def pcisph_delta_from_denom(params: SimParams, denom: float, dt=None):
    """δ(dt) = −1 / (2 (dt m / ρ₀)² · S), in the params' dtype."""
    dt = params.dt if dt is None else dt
    r = dt * params.particle_mass / params.rest_density
    beta = 2.0 * (r * r)
    return -1.0 / (beta * denom)


def pcisph_delta(params: SimParams, cfg: SimConfig,
                 spacing: float | None = None) -> float:
    """The PCISPH stiffness δ = −1 / (β·S), β = 2 (dt m / ρ₀)², from the
    prototype neighborhood of :func:`pcisph_grad_denom`; host-side, once
    per parameter set."""
    return float(pcisph_delta_from_denom(
        params, pcisph_grad_denom(params, cfg, spacing),
        dt=float(params.dt)))


def pcisph_step(state: FluidState, params: SimParams, grid: gridlib.Grid,
                cfg: SimConfig, boundary: Optional[BoundaryData] = None,
                delta: float | None = None, tol_frac: float = 0.01):
    """One PCISPH step; returns ``(new_state, StepDiagnostics)`` with the
    new state in hash-sorted order and the corrective iteration count in
    ``solver_iters``. A moving ``boundary`` (``vel`` set) enters the wall
    friction.

    ``delta``: the stiffness of :func:`pcisph_delta` (computed here when
    None). ``tol_frac``: the bound on the max positive predicted density
    error, as a fraction of ρ₀. Raises NotImplementedError for what is not
    ported, rather than ignoring it."""
    if state.multiphase:
        raise NotImplementedError(
            "multiphase (per-particle mass/rho0) is WCSPH-only; "
            "pcisph refuses rather than silently dropping the columns")
    if delta is None:
        delta = pcisph_delta(params, cfg)
    from .pcisph_cuda import pcisph_step_cuda
    return pcisph_step_cuda(state, params, grid, cfg, boundary, delta=delta,
                            tol_frac=tol_frac)
