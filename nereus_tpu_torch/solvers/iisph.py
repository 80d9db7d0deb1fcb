"""IISPH: Implicit Incompressible SPH with a relaxed-Jacobi pressure solve
(PyTorch port of ``nereus_tpu.solvers.iisph``; the reference's
``Nereus::IISPH``, ``sph/iisph/iisph.cpp:170-217``).

One step = predicted advection (density, the non-pressure forces, d_ii
and ρ_adv, a_ii), the relaxed-Jacobi pressure iteration, then the
pressure force and symplectic Euler. The JAX package's intended-semantics
fixes of the reference are kept: boundary loops over the boundary ranges,
d_ji·p_i with p_i, the dt² factor in the predicted density, and the
clamped-positive mean density error as the convergence test.
:func:`iisph_step` checks the configuration and runs the sweep step of
:mod:`.iisph_cuda`.
"""

from __future__ import annotations

from typing import Optional

from .. import grid as gridlib
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState


def iisph_step(state: FluidState, params: SimParams, grid: gridlib.Grid,
               cfg: SimConfig, boundary: Optional[BoundaryData] = None,
               tol: float = 1.0, omega: float = 0.5):
    """One IISPH step; returns ``(new_state, StepDiagnostics)`` with the
    new state in hash-sorted order and the solver's iteration count. A
    moving ``boundary`` (``vel`` set) enters ρ_adv and the wall friction.

    ``tol`` bounds the mean clamped-positive predicted density error in
    kg/m³ (the reference's ``max_rho_err = 1``, 0.1% of ρ₀); ``omega`` is
    the Jacobi relaxation. Raises NotImplementedError for what is not
    ported, rather than ignoring it."""
    if state.multiphase:
        raise NotImplementedError(
            "multiphase (per-particle mass/rho0) is WCSPH-only; "
            "iisph refuses rather than silently dropping the columns")
    if cfg.viscosity_model != "explicit":
        # nereus_tpu has no implicit-viscosity stage for IISPH: its step
        # runs the explicit Müller term whatever viscosity_model says
        # (iisph_pallas.py:52-57); the port refuses rather than doing so
        raise NotImplementedError(
            f"viscosity_model={cfg.viscosity_model!r}: IISPH has no "
            "implicit viscosity stage (the JAX IISPH step silently runs "
            "the explicit Müller viscosity instead); the implicit solve "
            "runs with wcsph_step and dfsph_step")
    from .iisph_cuda import iisph_step_cuda
    return iisph_step_cuda(state, params, grid, cfg, boundary, tol=tol,
                           omega=omega)
