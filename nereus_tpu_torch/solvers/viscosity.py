"""Implicit viscosity: Weiler et al. 2018 (PyTorch port of
``nereus_tpu.solvers.viscosity``; a stage beyond the reference, whose only
viscosity is the explicit Müller force).

Solves the backward-Euler viscous system (I − dt·ν·∇²)v = v* with
matrix-free conjugate gradient, one viscous-Laplacian sweep per matvec::

  (∇²v)_i = 10 Σ_j (m/ρ_j)(v_ij·x_ij)/(|x_ij|² + 0.01h²) ∇W_ij
            + 10 Σ_b (ψ_b/ρ_i)(v_ib·x_ib)/(…) ∇W_ib

warm-started at v* and iterated to the relative residual
``SimConfig.visc_cg_tol``, capped at ``visc_cg_max_iters``. Positions and
densities are frozen over the solve. With a moving wall the boundary rows
carry the wall velocity v_b into every matvec, as the JAX solve packs it,
so the operator is affine (A·v + c(v_b)) rather than linear and CG solves
it as if it were linear; the port follows the JAX package there. The steps
that run it (single-phase WCSPH and DFSPH) drop the explicit viscosity and
the wall friction from their force sweep (``include_viscosity=False``):
the solve owns both.

The JAX solve is one ``lax.while_loop``; here it is a
:class:`~.predicated_loop.PredicatedLoop` with its own :data:`LOOP` counts
that commits x, r, p and the residual and reads its condition on the host
once per :data:`SYNC_EVERY` launched iterations. On CUDA tensors the
Laplacian is the hand-written kernel of ``csrc/viscosity_sweep.cu``; on
CPU tensors its plain PyTorch version.
"""

from __future__ import annotations

import torch

from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from .predicated_loop import LoopCounts, PredicatedLoop
from .sweep_common import SweepCtx

_EPS = 1e-12

# CG iterations launched between two host reads of the loop condition
SYNC_EVERY = 2

# CG iterations launched and host reads of their condition
LOOP = LoopCounts()


def _dot(u, v):
    return torch.sum(u * v)


def cg_solve(matvec, b, cfg: SimConfig):
    """Matrix-free CG on (C, 3) velocity rows, warm-started at x0 = b;
    returns ``(x, iters, rel_residual)``, the last two 0-d tensors. The
    loop runs while rs > tol²·max(b·b, ε) and under the cap, with no
    minimum count: a system its warm start already solves keeps x = b and
    reports 0 iterations (the one iteration launched commits nothing)."""
    bnorm2 = torch.clamp(_dot(b, b), min=_EPS)
    x = b
    r = b - matvec(x)
    p = r
    loop = PredicatedLoop(LOOP, like=bnorm2,
                          tol=(cfg.visc_cg_tol ** 2) * bnorm2, min_iters=0,
                          max_iters=cfg.visc_cg_max_iters,
                          sync_every=SYNC_EVERY, err0=_dot(r, r))
    for _ in loop:
        rs = loop.err
        ap = matvec(p)
        alpha = rs / torch.clamp(_dot(p, ap), min=_EPS)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        rs_new = _dot(r_new, r_new)
        p_new = r_new + (rs_new / torch.clamp(rs, min=_EPS)) * p
        x = loop.commit(x_new, x)
        r = loop.commit(r_new, r)
        p = loop.commit(p_new, p)
        loop.advance(rs_new)
    return x, loop.it, torch.sqrt(loop.err / bnorm2)


def laplacian_operands(ctx: SweepCtx, params: SimParams, dens):
    """The Laplacian sweep's operands, loop-invariant: returns ``at(v) ->
    (q, src, seg_start, seg_end, pvec)``, which writes the (C, 3)
    velocities ``v`` in place into the query (``x y z v ρ 0``) and the
    fluid source rows (``x y z v m/ρ_j 0``; the boundary rows keep the
    wall velocity, 0 for a static wall, and ψ_b)."""
    z = torch.zeros_like(dens)
    q = ctx.queries(z, z, z, dens, width=8)
    src = ctx.pack((z, z, z),
                   params.particle_mass / torch.clamp(dens, min=_EPS))

    def at(v):
        q[:, 3:6] = v
        src[:ctx.c, 3:6] = v
        return q, src, ctx.seg_start, ctx.seg_end, ctx.pvec
    return at


def implicit_viscosity(ctx: SweepCtx, params: SimParams, cfg: SimConfig,
                       dens, v_star):
    """Solves (I − dt·ν·∇²)v = v* for the (C, 3) hash-sorted velocities
    ``v_star`` at the step's frozen positions and density ``dens``;
    returns ``(v, iters, rel_residual)``. The counterpart of
    ``implicit_viscosity_pallas``; its dot products run over every row,
    parked ones included (their Laplacian is 0)."""
    at = laplacian_operands(ctx, params, dens)
    nu_dt = params.viscosity * params.dt

    def matvec(v):
        return v - nu_dt * SP.visc_laplacian_sweep(cfg, *at(v),
                                                   plan=ctx.tile_plan)
    return cg_solve(matvec, v_star, cfg)
