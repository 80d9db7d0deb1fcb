"""DFSPH with two-way rigid-body coupling (PyTorch port of
``nereus_tpu.solvers.dfsph_coupled``).

The bodies' Akinci shells enter the DFSPH pressure solve itself: the
density and the factor α, every Dρ/Dt with the bodies' current sample
velocities, and every κ correction of both loops, whose central pair
impulses give each body its exact reaction from the fluid side. The
interface is Gauss–Seidel: each iteration's reaction kicks the body's
(v, ω) at once and the next iteration's Dρ/Dt sees the body yield (a
frozen body diverges for light bodies, the added-mass instability). With
``SimConfig.dfsph_strong_coupling`` each body's mobility joins α's
denominator. The non-pressure stage exchanges the Akinci friction alone.
The body pose and the torque arm stay frozen across the step; gravity,
wall and body-body contacts and the rigid integration come once at the
end.

``body`` may be one :class:`~nereus_tpu_torch.rigid.RigidBody` or a
sequence of them, and the step returns the same kind. A multiphase state
runs the adapted-domain step. :func:`dfsph_coupled_step` checks the
configuration and runs the sweep steps of :mod:`.dfsph_coupled_cuda`.
"""

from __future__ import annotations

from typing import Optional

from .. import grid as gridlib
from ..params import SimConfig, SimParams
from ..rigid import RigidBody
from ..state import BoundaryData, FluidState
from .wcsph import check_multiphase_cfg


def dfsph_coupled_step(state: FluidState, params: SimParams,
                       grid: gridlib.Grid, cfg: SimConfig, body,
                       boundary: Optional[BoundaryData] = None,
                       tol: float = 1.0, tol_v: float = 1.0):
    """One coupled DFSPH + rigid-body step; returns ``(new_state,
    new_body_or_bodies, StepDiagnostics)`` with the new state in
    hash-sorted order, as the JAX step returns it; tolerances as
    :func:`~.dfsph.dfsph_step`. ``boundary`` (the walls) may move.

    A multiphase state refuses what the JAX step refuses (AKINCI surface
    tension, implicit viscosity). A single-phase state refuses
    ``viscosity_model="implicit"``: the JAX coupled step runs the explicit
    viscosity whatever the model says, and the port does not ignore the
    setting."""
    single = isinstance(body, RigidBody)
    bodies = (body,) if single else tuple(body)
    if not bodies:
        raise ValueError("dfsph_coupled_step needs at least one body")
    if state.multiphase:
        check_multiphase_cfg(cfg)
    elif cfg.viscosity_model != "explicit":
        raise NotImplementedError(
            f"viscosity_model={cfg.viscosity_model!r}: the coupled DFSPH "
            "step has no implicit viscosity stage (the JAX coupled step "
            "runs the explicit viscosity instead)")
    from .dfsph_coupled_cuda import (dfsph_coupled_step_cuda,
                                     dfsph_coupled_step_multiphase_cuda)
    step = (dfsph_coupled_step_multiphase_cuda if state.multiphase
            else dfsph_coupled_step_cuda)
    new_state, new_bodies, diag = step(state, params, grid, cfg, bodies,
                                       boundary, tol=tol, tol_v=tol_v)
    return new_state, (new_bodies[0] if single else new_bodies), diag
