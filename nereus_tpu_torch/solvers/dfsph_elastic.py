"""DFSPH with two-way fluid–elastic coupling (PyTorch port of
``nereus_tpu.solvers.dfsph_elastic``).

The body's Akinci samples enter the DFSPH pressure solve as the rigid
shells of :mod:`.dfsph_coupled` do — the density and α's gradient sum,
every Dρ/Dt with the LIVE sample velocities, every κ correction of both
loops — with the reaction distributed PER SAMPLE: each κ correction runs
one reverse sweep, the samples ``x y z ψ_b`` as queries against the fluid
rows with κ/ρ in slot 6. ``grad_pressure_force_pair(boundary=True,
boundary_sign=-1)`` is its own reverse form, so the forward and the
reverse sweep are one formula (``pressure_force_body_sweep`` and
``pressure_force_body_rev_sweep``, one plain sweep, two kernels) and the
per-pair forces are exactly antisymmetric: momentum is conserved to the
pair.

The interface is Gauss–Seidel: each reaction kicks the sample velocities
(v_b += dt·f_b/m_b) and the next Dρ/Dt sees the body yield. With
``SimConfig.dfsph_strong_coupling`` the per-sample mobility
(pm/m_b)·Σψ_b²|∇W|² joins α's denominator: α's sums in their fluid form
over the shell's ``x y z ψ_b`` rows; without it the shell adds to the
gradient sum alone. The shell's ψ-density and those sums come from one
sweep (``body_density_alpha_sweep``, with ``include_sq`` under strong
coupling). The
non-pressure stage exchanges the Akinci friction alone, forward
(``body_force_sweep``) and per sample (``fluid_reaction_sweep``), both
with ``include_pressure=False``. After the solve the kicked velocities go back to the body in
statics order and the body takes ``substeps`` elastic steps of
dt/substeps (the reaction came as an impulse at the step's start). On
CUDA tensors the sweeps are the hand-written kernels of ``csrc/``; on CPU
tensors their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .dfsph_cuda import _EPS_DENOM, KappaSweeps, dfsph_solve
from .elastic import ElasticParams, ElasticState, ElasticStatics
from .elastic_coupled import ElasticShell, elastic_shell
from .elastic_cuda import elastic_step_cuda
from .sweep_common import SweepCtx, build_sweep_ctx, psi_rows


class ElasticSweeps(KappaSweeps):
    """The sweeps of a coupled step, fluid and body, and the buffers of
    the body's live rows; the carried state is ``(vb,)``, the (Mb, 3)
    sample velocities."""

    def __init__(self, ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                 dens, es: ElasticShell, mbm):
        super().__init__(ctx, params, cfg, dens)
        self.es = es
        self.dt_mb = params.dt / mbm
        src = es.shell.src
        self.rng = (es.shell.seg_start, es.shell.seg_end, ctx.pvec)
        self.rev = (es.r_start, es.r_end, ctx.pvec)
        self._src_v = src.clone()
        # x y z ψ_b: the samples as the reverse κ sweep's queries
        self.q_b = psi_rows(src)

    def src_at(self, vb):
        """The shell's rows with the sample velocities ``vb`` (Mb, 3) in
        slots 3-5 (one buffer, rewritten by each call)."""
        self._src_v[:, 3:6] = vb
        return self._src_v

    def drho(self, v, carry=()):
        """Dρ/Dt (C,) at the fluid velocities ``v`` and the samples'
        ``carry = (vb,)``."""
        d = super().drho(v)
        return d + SP.drho_shell_sweep(self.cfg, self.q_v,
                                       self.src_at(carry[0]), *self.rng)

    def correct(self, kappa, v, carry=()):
        """One κ correction: fluid and walls plus the body's impulse on the
        fluid, then the per-sample reaction kick. Returns ``(v, (vb,))``."""
        q, src, *rng = self.kappa_operands(kappa)
        f = SP.pressure_force_sweep(self.cfg, q, src, *rng,
                                    plan=self.ctx.tile_plan)
        fb = SP.pressure_force_body_sweep(self.cfg, q, self.es.shell.src,
                                          *self.rng)
        v = v + self.dt_m * (f + fb)
        fbs = SP.pressure_force_body_rev_sweep(self.cfg, self.q_b, src,
                                               *self.rev)
        return v, (carry[0] + self.dt_mb * fbs,)

    def nonpressure(self, v, carry=()):
        """The non-pressure forces and the friction exchange: the body's
        friction on the fluid and, per sample, the fluid's on the body."""
        q8, src_f, f = self.forces(v)
        src_b = self.src_at(carry[0])
        f = f + SP.body_force_sweep(self.cfg, q8, src_b, *self.rng,
                                    include_pressure=False)
        f_fric = SP.fluid_reaction_sweep(self.cfg, src_b, src_f[:self.ctx.c],
                                         *self.rev, include_pressure=False)
        return self.kick(v, f), (carry[0] + self.dt_mb * f_fric,)


def elastic_density_alpha(ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                          es: ElasticShell, mbm):
    """``(dens, alpha)`` of a coupled step: the density with the body's
    ψ-density, and α with the body's Σψ_b∇W in the gradient sum and, under
    strong coupling, its per-sample mobility (pm/m_b)·Σψ_b²|∇W|² in the
    denominator (α's sums in their fluid form over the shell; without
    strong coupling their boundary form). The fluid's ρ and α's sums come
    from one sweep of the density's matrix, the shell's from one sweep of
    its ``x y z ψ_b`` rows."""
    pm = params.particle_mass
    strong = cfg.dfsph_strong_coupling
    q4, *dargs = ctx.density_operands(pm)
    sums = SP.density_alpha_sums_sweep(cfg, q4, *dargs)
    shell = SP.body_density_alpha_sweep(
        cfg, q4, es.shell.src4, es.shell.seg_start, es.shell.seg_end,
        ctx.pvec, include_sq=strong)
    dens = sums[:, 0] + shell[:, 0]
    g = sums[:, 1:4] + shell[:, 1:4]
    denom = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
             + sums[:, 4])
    if strong:
        denom = denom + (pm / mbm) * shell[:, 4]
    return dens, dens / torch.clamp(denom, min=_EPS_DENOM)


def dfsph_elastic_step(state: FluidState, params: SimParams,
                       grid: gridlib.Grid, cfg: SimConfig,
                       estate: ElasticState, statics: ElasticStatics,
                       ep: ElasticParams, psi,
                       boundary: Optional[BoundaryData] = None,
                       substeps: int = 4, tol: float = 1.0,
                       tol_v: float = 1.0):
    """One coupled DFSPH + elastic-body step; returns ``(new_state,
    new_estate, StepDiagnostics)``, the new fluid state in hash-sorted
    order as the JAX step returns it; tolerances as
    :func:`~.dfsph.dfsph_step`. ``psi``: the body's ψ from
    :func:`~.elastic_coupled.elastic_psi`. The body must meet its own CFL
    at dt/substeps.

    Refuses a multiphase state, as the JAX step does, and
    ``viscosity_model="implicit"``: the JAX step runs the explicit
    viscosity whatever the model says, and the port does not ignore the
    setting."""
    if state.multiphase:
        raise NotImplementedError(
            "multiphase fluid + elastic coupling is not implemented")
    if cfg.viscosity_model != "explicit":
        raise NotImplementedError(
            f"viscosity_model={cfg.viscosity_model!r}: the coupled DFSPH "
            "step has no implicit viscosity stage (the JAX coupled step "
            "runs the explicit viscosity instead)")
    if substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    es = elastic_shell(ctx, grid, estate, psi)
    mbm = statics.mass
    dens, alpha = elastic_density_alpha(ctx, params, cfg, es, mbm)
    new_state, (vb,), diag = dfsph_solve(
        state, ElasticSweeps(ctx, params, cfg, dens, es, mbm), alpha,
        (es.shell.src[:, 3:6],), tol=tol, tol_v=tol_v)

    # -- the kicked velocities back in statics order, then the substeps -----
    vb_statics = torch.zeros_like(vb).index_copy_(0, es.perm, vb)
    p_sub = dataclasses.replace(params, dt=params.dt / substeps)
    pvec = SP.build_pvec(p_sub, cfg, grid)
    body = dataclasses.replace(estate, vel=vb_statics)
    for _ in range(substeps):
        body, ediag = elastic_step_cuda(body, statics, p_sub, ep, grid, cfg,
                                        pvec=pvec)
    diag = dataclasses.replace(
        diag, seg_overflow=torch.maximum(diag.seg_overflow,
                                         ediag.seg_overflow))
    return new_state, body, diag
