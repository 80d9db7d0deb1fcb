"""WCSPH with two-way fluid–elastic coupling (PyTorch port of
``nereus_tpu.solvers.elastic_coupled``).

One step advances the fluid and a deformable elastic body together:

1. the body's samples are a MOVING Akinci boundary for the fluid (ψ per
   sample from the reference configuration, live velocities): a ψ-density
   and the repulsive pressure + friction contact of the rigid coupling
   (``BodyForce``; :mod:`.coupled_cuda`), no Becker penalty;
2. the reaction lands PER SAMPLE through a reverse sweep: the body samples
   are the queries and the step's fluid rows ``x y z v ρ 0`` the source
   (``FluidReaction``), over the samples' ranges in the fluid's sorted
   hashes; a rigid body needs only the fluid-side sums, a deformable one
   where each force lands;
3. the body takes ``substeps`` elastic steps of dt/substeps under the
   frozen reaction (:func:`~.elastic_cuda.elastic_step_cuda`, the packed
   parameters built once for all of them).

Weak (staggered) coupling: the body is frozen during the fluid step and
the reaction during the substeps. Walls compose through the unchanged
fluid machinery. On CUDA tensors the sweeps are the hand-written kernels
of ``csrc/``; on CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..ops.neighbors import query_ranges
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .coupled_cuda import Shell, coupled_operands
from .elastic import ElasticParams, ElasticState, ElasticStatics
from .elastic_cuda import elastic_step_cuda
from .sweep_common import SweepCtx, boundary_src, build_sweep_ctx
from .wcsph_cuda import _diagnostics, _integrate


def elastic_psi(statics: ElasticStatics, params: SimParams,
                cfg: SimConfig) -> torch.Tensor:
    """Per-sample Akinci ψ = ρ₀·V_bi over the body's REFERENCE positions
    (host, once per body), in statics order: interior samples see more
    neighbors and get less ψ, so the body's boundary volume stays honest
    without a surface extraction."""
    from ..boundary import compute_vbi
    vbi = compute_vbi(statics.x0.cpu().numpy(),
                      float(params.interaction_radius), cfg.kernel_set)
    return (torch.as_tensor(vbi).to(dtype=cfg.dtype, device=statics.x0.device)
            * params.rest_density)


def _body_boundary(estate: ElasticState, psi, grid: gridlib.Grid):
    """The body as a hash-sorted moving ``BoundaryData`` at its current
    positions and velocities, and the sort permutation (sorted row →
    statics row) that routes the reaction back."""
    h = gridlib.hash_positions(grid, estate.pos)
    sh, perm, (pos, vel, psi_s) = gridlib.sort_by_hash(
        h, estate.pos, estate.vel, psi, return_perm=True)
    return BoundaryData(pos=pos, psi=psi_s, sorted_hash=sh, vel=vel), perm


class ElasticShell(NamedTuple):
    """The body as a boundary of one coupled step."""

    shell: Shell          # the body as a source for the fluid queries
    r_start: torch.Tensor  # (9, Mb) the samples' ranges over the fluid's
    r_end: torch.Tensor    # sorted hashes (the reverse sweeps)
    perm: torch.Tensor    # (Mb,) sorted sample → statics row


def elastic_shell(ctx: SweepCtx, grid: gridlib.Grid, estate: ElasticState,
                  psi) -> ElasticShell:
    """The body at ``estate`` as a hash-sorted moving shell ``x y z v_b ψ
    0`` with the fluid queries' ranges over it, and its samples' ranges
    over the fluid's sorted hashes."""
    bd, perm = _body_boundary(estate, psi, grid)
    shell = Shell(boundary_src(bd),
                  *query_ranges(grid, ctx.coords, bd.sorted_hash))
    r_start, r_end = query_ranges(grid, gridlib.cell_coords(grid, bd.pos),
                                  ctx.sorted_hash)
    return ElasticShell(shell, r_start, r_end, perm)


class ElasticOperands(NamedTuple):
    """The sweeps' operands of one coupled step."""

    dargs: tuple          # fused density (q, src, seg_start, seg_end, pvec)
    fargs: tuple          # fused force; its query is also BodyForce's
    shell: Shell          # the body as a source for the fluid queries
    rargs: tuple          # FluidReaction: sample queries, fluid rows
    perm: torch.Tensor    # (Mb,) sorted sample → statics row
    dens: torch.Tensor    # (C,) with the body's ψ-density
    pres: torch.Tensor


def elastic_operands(ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                     grid: gridlib.Grid, estate: ElasticState,
                     psi) -> ElasticOperands:
    """Every sweep's operands of one coupled step from the fluid's ``ctx``
    and the body at ``estate``; the density sweeps run here. The reverse
    sweep's query is the shell's own rows ``x y z v_b ψ 0`` and its source
    the force sweep's fluid rows ``x y z v ρ 0``, over the samples' ranges
    (9 rows) in the fluid's sorted hashes."""
    es = elastic_shell(ctx, grid, estate, psi)
    dargs, fargs, dens, pres = coupled_operands(ctx, params, cfg, [es.shell])
    rargs = (es.shell.src, fargs[1][:ctx.c], es.r_start, es.r_end, ctx.pvec)
    return ElasticOperands(dargs, fargs, es.shell, rargs, es.perm, dens,
                           pres)


def wcsph_elastic_step(state: FluidState, params: SimParams,
                       grid: gridlib.Grid, cfg: SimConfig,
                       estate: ElasticState, statics: ElasticStatics,
                       ep: ElasticParams, psi,
                       boundary: Optional[BoundaryData] = None,
                       substeps: int = 4):
    """One coupled WCSPH + elastic-body step; returns ``(new_state,
    new_estate, StepDiagnostics)``, the new fluid state in hash-sorted
    order as the JAX step returns it. ``psi``: the body's ψ from
    :func:`elastic_psi`. The body must meet its own CFL at dt/substeps.

    Refuses a multiphase state, as the JAX step does, and
    ``viscosity_model="implicit"``: the JAX step runs the explicit
    viscosity whatever the model says, and the port does not ignore the
    setting."""
    if state.multiphase:
        raise NotImplementedError(
            "multiphase fluid + elastic coupling is not implemented")
    if cfg.viscosity_model != "explicit":
        raise NotImplementedError(
            f"viscosity_model={cfg.viscosity_model!r}: the coupled WCSPH "
            "step has no implicit viscosity stage (the JAX coupled step "
            "runs the explicit viscosity instead)")
    if substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    ops = elastic_operands(ctx, params, cfg, grid, estate, psi)
    sh = ops.shell
    force = SP.fluid_force_sweep(cfg, *ops.fargs,
                                 moving_boundary=ctx.moving_boundary)
    force = force + SP.body_force_sweep(cfg, ops.fargs[0], sh.src,
                                        sh.seg_start, sh.seg_end, ctx.pvec)
    f_rev = SP.fluid_reaction_sweep(cfg, *ops.rargs)
    f_react = torch.zeros_like(f_rev).index_copy_(0, ops.perm, f_rev)

    dt, pm, g = params.dt, params.particle_mass, params.gravity
    nv = [v + (dt / pm) * (force[:, k] + pm * g[k])
          for k, v in enumerate((ctx.vx, ctx.vy, ctx.vz))]
    pos, vel = _integrate(ctx, dt, nv, nv)
    active = ctx.active
    new_state = FluidState(
        pos=pos, vel=vel,
        pressure=torch.where(active, ops.pres, torch.zeros_like(ops.pres)),
        num_active=state.num_active)

    p_sub = dataclasses.replace(params, dt=params.dt / substeps)
    pvec = SP.build_pvec(p_sub, cfg, grid)
    es = estate
    for _ in range(substeps):
        es, ediag = elastic_step_cuda(es, statics, p_sub, ep, grid, cfg,
                                      f_ext=f_react, pvec=pvec)
    diag = _diagnostics(state, ops.dens, active, params.rest_density)
    # the fluid's ranges are exact (overflow 0); the body's too
    diag = dataclasses.replace(
        diag, seg_overflow=torch.maximum(diag.seg_overflow,
                                         ediag.seg_overflow))
    return new_state, es, diag
