"""The elastic step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.elastic_pallas``).

One step: the deformation-gradient sweep over the body's static pair
list → F = V·raw·C and the batched constitutive math
(:func:`~.elastic.stress_pc`, (N, 3, 3) ``bmm``/``einsum``) → one fused
force + hourglass sweep → symplectic Euler (:func:`~.elastic._integrate`).
The JAX package keeps the constitutive math in nine (N,) columns because
Mosaic tiles a rank-3 array's trailing (3, 3) to a full (8, 128) tile; on
the GPU the batched form is a handful of launches.

Both sweeps read one row per particle, the query and the source being the
same matrix, ``X x 0 0`` (8 wide) for F and ``X x PC F`` (24 wide) for
the forces, over the body's static pair list (the pairs of its reference
ranges within h, ``ElasticStatics.nbr_start``, ``nbr``). On CUDA
tensors the sweeps are the hand-written kernels of
``csrc/elastic_sweep.cu``; on CPU tensors their plain PyTorch versions.
"""

from __future__ import annotations

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from .elastic import (ElasticParams, ElasticState, ElasticStatics,
                      _integrate, stress_pc)


def f_gradient_operands(statics: ElasticStatics, cur, pvec):
    """The deformation-gradient sweep's ``(q, src, nbr_start, nbr, pvec)``:
    one (N, 8) ``X x 0 0`` matrix as both query and source, and the body's
    static pair list."""
    z = torch.zeros_like(cur[:, :2])
    q = torch.cat([statics.x0, cur, z], dim=1)
    return q, q, statics.nbr_start, statics.nbr, pvec


def f_gradient_sweep(statics: ElasticStatics, cur, params: SimParams,
                     grid: gridlib.Grid, cfg: SimConfig, pvec=None):
    """Σ_j (x_j − x_i) ⊗ ∇W(X_ij) (N, 9), row-major, at the current
    positions ``cur``; also made at x = X when the body is made."""
    if pvec is None:
        pvec = SP.build_pvec(params, cfg, grid)
    return SP.elastic_f_sweep(cfg, *f_gradient_operands(statics, cur, pvec))


def force_operands(statics: ElasticStatics, pos, pc, f, pvec):
    """The fused force + hourglass sweep's ``(q, src, nbr_start, nbr,
    pvec)``: one (N, 24) ``X x PC F`` matrix as both query and source, and
    the body's static pair list."""
    n = statics.n
    q = torch.cat([statics.x0, pos, pc.reshape(n, 9), f.reshape(n, 9)],
                  dim=1)
    return q, q, statics.nbr_start, statics.nbr, pvec


def elastic_step_cuda(state: ElasticState, statics: ElasticStatics,
                      params: SimParams, ep: ElasticParams,
                      grid: gridlib.Grid, cfg: SimConfig, f_ext=None,
                      pvec=None):
    """One elastic step; see :func:`~.elastic.elastic_step`. ``pvec``:
    the packed parameters of ``params`` when the caller has them (the
    coupled step's substeps share one)."""
    n = statics.n
    vol = statics.vol
    if pvec is None:
        pvec = SP.build_pvec(params, cfg, grid)
    raw = f_gradient_sweep(statics, state.pos, params, grid, cfg, pvec)
    f = torch.bmm(vol * raw.reshape(n, 3, 3), statics.corr)
    pc, e, plastic = stress_pc(f, statics.corr, ep, state.plastic,
                               params.dt)
    out = SP.elastic_force_hourglass_sweep(
        cfg, *force_operands(statics, state.pos, pc, f, pvec))
    f_el = (vol * vol) * out[:, :3]
    f_hg = (ep.hourglass * vol * vol) * out[:, 3:]
    force = f_el + f_hg if f_ext is None else f_el + f_hg + f_ext
    return _integrate(state, statics, params, ep, force, f, e, statics.miss,
                      plastic=plastic)
