"""WCSPH step with two-way rigid-body coupling (PyTorch port of
``nereus_tpu.solvers.coupled``).

One step advances the fluid and the rigid bodies together:

1. each body's shell adds its ψ to the fluid density (approaching fluid
   compresses, and its pressure resists penetration), its samples moving
   with ``v + ω×r``;
2. the fluid ↔ body contact is the Akinci pressure and friction (not the
   stiff β penalty of the static walls), at the consistent scale
   −m·ψ·max(pd2_i, 0)·∇W;
3. the reaction on the body follows Newton's third law from the fluid
   side: the contact pair forces are central, so ``F = −Σ_i f_i`` and
   ``τ = −Σ_i (x_i − c)×f_i`` are exact; one contact sweep per body
   serves both sides;
4. body ↔ wall and body ↔ body penalty contacts (dense, over the shells'
   samples);
5. the rigid state integrates on the device.

``body`` may be one :class:`~nereus_tpu_torch.rigid.RigidBody` or a
sequence of them, and the step returns the same kind. A multiphase state
(per-particle mass and ρ₀) runs the adapted-density step with the
volume-form contact. :func:`wcsph_coupled_step` checks the configuration
and runs the sweep steps of :mod:`.coupled_cuda`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import grid as gridlib
from ..params import SimConfig, SimParams
from ..rigid import RigidBody, body_body_contact, wall_contact_force
from ..state import BoundaryData, FluidState
from .wcsph import check_multiphase_cfg


def rigid_extras(bodies, boundary: Optional[BoundaryData],
                 params: SimParams, cfg: SimConfig):
    """Wall- and body-body-contact forces and torques per body: two lists
    of (3,) tensors."""
    dev = bodies[0].com.device
    zero = torch.zeros(3, dtype=cfg.dtype, device=dev)
    F = [zero for _ in bodies]
    T = [zero for _ in bodies]
    if boundary is not None and boundary.num_boundaries > 0:
        for k, b in enumerate(bodies):
            fw, tw = wall_contact_force(b, boundary, params,
                                        kernel_set=cfg.kernel_set)
            F[k] = F[k] + fw
            T[k] = T[k] + tw
    for i in range(len(bodies)):
        for j in range(i + 1, len(bodies)):
            fa, ta, fb, tb = body_body_contact(bodies[i], bodies[j], params,
                                               kernel_set=cfg.kernel_set)
            F[i], T[i] = F[i] + fa, T[i] + ta
            F[j], T[j] = F[j] + fb, T[j] + tb
    return F, T


def wcsph_coupled_step(state: FluidState, params: SimParams,
                       grid: gridlib.Grid, cfg: SimConfig, body,
                       boundary: Optional[BoundaryData] = None):
    """One coupled WCSPH + rigid-body step; returns ``(new_state,
    new_body_or_bodies, StepDiagnostics)`` with the new state in
    hash-sorted order, as the JAX step returns it. ``boundary`` (the
    walls) may move (``vel`` set).

    A multiphase state refuses what the JAX multiphase coupling refuses
    (AKINCI surface tension, implicit viscosity). A single-phase state
    refuses ``viscosity_model="implicit"``: the JAX coupled step runs the
    explicit viscosity whatever the model says, and the port does not
    ignore the setting."""
    single = isinstance(body, RigidBody)
    bodies = (body,) if single else tuple(body)
    if not bodies:
        raise ValueError("wcsph_coupled_step needs at least one body")
    if state.multiphase:
        check_multiphase_cfg(cfg)
    elif cfg.viscosity_model != "explicit":
        raise NotImplementedError(
            f"viscosity_model={cfg.viscosity_model!r}: the coupled WCSPH "
            "step has no implicit viscosity stage (the JAX coupled step "
            "runs the explicit viscosity instead)")
    from .coupled_cuda import coupled_step_cuda, coupled_step_multiphase_cuda
    step = (coupled_step_multiphase_cuda if state.multiphase
            else coupled_step_cuda)
    new_state, new_bodies, diag = step(state, params, grid, cfg, bodies,
                                       boundary)
    return new_state, (new_bodies[0] if single else new_bodies), diag
