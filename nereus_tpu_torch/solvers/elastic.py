"""Elastic and elastoplastic solids: total-Lagrangian corrected SPH
(PyTorch port of ``nereus_tpu.solvers.elastic``; Ganzenmüller 2015).

- Neighborhoods, kernels and kernel gradients live in the REFERENCE
  configuration X, so the neighbor problem is solved once, when the body
  is made: one hash sort, one set of exact cell ranges and the pair list
  of those ranges within h for the body's whole lifetime
  (:class:`ElasticStatics`), and a step is two sweeps over the list plus
  batched 3×3 math, with no per-step sort.
- Per particle the corrected deformation gradient
  ``F_i = V Σ_j (x_j − x_i) ⊗ ∇W(X_ij) · C_i`` with ``C_i = D_i⁻¹``,
  ``D_i = V Σ_j (X_j − X_i) ⊗ ∇W(X_ij)``: exact for every affine motion.
- St. Venant–Kirchhoff on the Green strain ``E = ½(FᵀF − I)``:
  ``S = 2µE + λ tr(E) I``, ``P = F S``; with ``plastic`` state the stress
  reads the elastic part of an additive von Mises split
  (:func:`plastic_flow`).
- Variational forces ``f_i = V² Σ_j (P_i C_iᵀ + P_j C_jᵀ) ∇W(X_ij)`` and
  Ganzenmüller's hourglass control ``α V² Σ_j ½ W/|X|² (δ_i + δ_j) x̂``.

A step (:mod:`.elastic_cuda`) is one deformation-gradient sweep, the
batched constitutive math, one fused force + hourglass sweep and the
symplectic Euler update of :func:`_integrate`. The sweeps are the CUDA
kernels of ``csrc/elastic_sweep.cu`` on a GPU and their plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import grid as gridlib
from ..ops.neighbors import cutoff_list, query_ranges
from ..params import SimConfig, SimParams, resolve_device


@dataclasses.dataclass(frozen=True)
class ElasticParams:
    """Material and regularization parameters, 0-d tensors (``box_lo`` and
    ``box_hi`` (3,)); build with :func:`elastic_params`. ``hourglass`` is
    Ganzenmüller's α, ``damping`` a mass-proportional coefficient (1/s)
    applied as ``v ← v/(1 + damping·dt)``, ``floor_y`` and the box a
    conservative penalty spring (±inf: none), ``yield_strain``, ``creep``
    and ``max_plastic`` the von Mises flow (inf: elastic)."""

    mu: torch.Tensor
    lam: torch.Tensor
    hourglass: torch.Tensor
    damping: torch.Tensor
    floor_y: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor
    yield_strain: torch.Tensor
    creep: torch.Tensor
    max_plastic: torch.Tensor


def elastic_params(young: float, poisson: float = 0.3, *,
                   hourglass: float = 10.0, damping: float = 0.0,
                   floor_y: float = -math.inf, box_lo=None, box_hi=None,
                   yield_strain: float = math.inf, creep: float = math.inf,
                   max_plastic: float = math.inf, dtype=torch.float32,
                   device=None) -> ElasticParams:
    """Lamé constants from Young's modulus and Poisson's ratio, on
    ``device`` (default: the CUDA device). ``yield_strain``, ``creep`` and
    ``max_plastic`` act only on bodies made with ``plastic=True``."""
    device = resolve_device(device)
    e, nu = float(young), float(poisson)
    mu = e / (2.0 * (1.0 + nu))
    lam = e * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    def s(v):
        return torch.as_tensor(np.asarray(v, np.float64)).to(
            dtype=dtype, device=device)
    inf3 = torch.full((3,), math.inf, dtype=dtype, device=device)
    return ElasticParams(mu=s(mu), lam=s(lam), hourglass=s(hourglass),
                         damping=s(damping), floor_y=s(floor_y),
                         box_lo=-inf3 if box_lo is None else s(box_lo),
                         box_hi=inf3 if box_hi is None else s(box_hi),
                         yield_strain=s(yield_strain), creep=s(creep),
                         max_plastic=s(max_plastic))


@dataclasses.dataclass(frozen=True)
class ElasticState:
    """Dynamic body state, (N, ...) in the order of ``statics.x0``, which
    never changes: positions, velocities and (``plastic`` bodies) the
    accumulated traceless plastic Green strain (N, 3, 3)."""

    pos: torch.Tensor
    vel: torch.Tensor
    plastic: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass(frozen=True)
class ElasticStatics:
    """What is solved once, when the body is made: the hash-sorted
    reference positions, their exact cell ranges (9, N) over themselves,
    the static pair list of those ranges within h (both sweeps of a step
    walk it; derived from ``x0`` and h, never stored in a checkpoint), and
    the gradient corrections C_i.

    The JAX package keeps a TPU window plan here (``anchors``, ``hash_f32``
    and the window width ``win``): solid lattices at spacing h/2 hold ~8
    particles per cell, so ``make_elastic_solid`` there widens the windows
    until the plan covers every reference pair. The port's pair list comes
    from the exact ranges, which cover every pair by construction, so
    there is nothing to widen and ``miss`` is 0."""

    x0: torch.Tensor           # (N, 3) reference positions, hash-sorted
    sorted_hash: torch.Tensor  # (N,) int32, ascending
    seg_start: torch.Tensor    # (9, N) int32 reference ranges
    seg_end: torch.Tensor
    nbr_start: torch.Tensor    # (N + 1,) int32: query i's pairs are
    nbr: torch.Tensor          # nbr[nbr_start[i]:nbr_start[i + 1]] (P,)
    miss: torch.Tensor         # () int32, 0: the ranges are exact
    corr: torch.Tensor         # (N, 3, 3) C_i = D_i⁻¹
    fixed: torch.Tensor        # (N,) bool, kinematically pinned
    vol: torch.Tensor          # () rest volume V = spacing³
    mass: torch.Tensor         # () particle mass ρ V

    @property
    def n(self) -> int:
        return self.x0.shape[0]


@dataclasses.dataclass(frozen=True)
class ElasticDiagnostics:
    elastic_energy: torch.Tensor   # Σ V ψ(E), the StVK strain energy
    max_stretch: torch.Tensor      # max_i ‖F_i − I‖_∞
    max_speed: torch.Tensor
    seg_overflow: torch.Tensor     # int32, 0: exact ranges


def sample_box_solid(lo, hi, spacing: float) -> np.ndarray:
    """Cubic-lattice particle block for an elastic body (host, float32)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    counts = np.maximum((np.floor((hi - lo) / spacing)).astype(int) + 1, 1)
    axes = [lo[k] + spacing * np.arange(counts[k]) for k in range(3)]
    g = np.meshgrid(*axes, indexing="ij")
    return np.stack([a.reshape(-1) for a in g], axis=1).astype(np.float32)


def _inv3(m, eps: float = 1e-6):
    """Batched closed-form 3×3 inverse; the identity where |det| ≤ ``eps``
    (isolated particles, degenerate sheets)."""
    a = m
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    c10 = a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2]
    c11 = a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0]
    c12 = a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1]
    c20 = a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1]
    c21 = a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2]
    c22 = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    det = (a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02)
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    ok = torch.abs(det) > eps
    inv = adj / torch.where(ok, det, torch.ones_like(det))[..., None, None]
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)
    return torch.where(ok[..., None, None], inv, eye)


def plastic_flow(e_total, plastic, ep: ElasticParams, dt):
    """Von Mises flow on the additive split ``E = E_el + E_p``: the
    deviatoric elastic strain beyond ``yield_strain`` flows into ``E_p`` at
    rate ``creep`` (ν·dt ≥ 1: instant radial return), capped at
    ``max_plastic``; the increment is deviatoric, so tr(E_p) stays 0.
    Returns ``(E_el, E_p′)``."""
    eye = torch.eye(3, dtype=e_total.dtype, device=e_total.device)
    eps = 1e-20
    e_el = e_total - plastic
    dev = e_el - (torch.einsum("naa->n", e_el) / 3.0)[:, None, None] * eye
    mag = torch.sqrt(torch.clamp(torch.einsum("nab,nab->n", dev, dev),
                                 min=eps))
    over = torch.clamp(mag - ep.yield_strain, min=0.0)
    # creep = inf with dt = 0 would make inf·0 = NaN
    rate = torch.where(torch.isfinite(ep.creep),
                       torch.clamp(ep.creep * dt, max=1.0),
                       torch.ones_like(ep.creep))
    p_new = plastic + (rate * over / mag)[:, None, None] * dev
    pmag = torch.sqrt(torch.clamp(torch.einsum("nab,nab->n", p_new, p_new),
                                  min=eps))
    scale = torch.clamp(ep.max_plastic / pmag, max=1.0)
    p_new = scale[:, None, None] * p_new
    return e_total - p_new, p_new


def stress_pc(f, corr, ep: ElasticParams, plastic=None, dt=None):
    """Batched constitutive update: Green strain, StVK stress
    P = F(2µE_el + λ tr(E_el) I) and the force-ready PC = P·Cᵀ. Returns
    ``(PC, E_el, E_p′)`` (``E_p′`` None for an elastic body)."""
    eye = torch.eye(3, dtype=f.dtype, device=f.device)
    e = 0.5 * (torch.einsum("nba,nbc->nac", f, f) - eye)
    p_new = None
    if plastic is not None:
        e, p_new = plastic_flow(e, plastic, ep, dt)
    tr = torch.einsum("naa->n", e)
    s = 2.0 * ep.mu * e + (ep.lam * tr)[:, None, None] * eye
    p = torch.bmm(f, s)
    pc = torch.bmm(p, corr.transpose(1, 2))
    return pc, e, p_new


def strain_energy(e, ep: ElasticParams, vol):
    """Total StVK strain energy Σ V (µ E:E + λ/2 tr²E)."""
    ee = torch.einsum("nab,nab->n", e, e)
    tr = torch.einsum("naa->n", e)
    return vol * torch.sum(ep.mu * ee + 0.5 * ep.lam * tr * tr)


def static_ranges(grid: gridlib.Grid, x0, h):
    """``(sorted_hash, seg_start, seg_end, nbr_start, nbr)`` of hash-sorted
    reference positions: the cell hashes, each particle's exact ranges
    (9, N) over the body itself, and the pair list of those ranges within
    the interaction radius ``h`` (0-d tensor; r² < h·h, as the sweeps'
    parameter vector holds it)."""
    sorted_hash = gridlib.hash_positions(grid, x0)
    seg_start, seg_end = query_ranges(grid, gridlib.cell_coords(grid, x0),
                                      sorted_hash)
    h = torch.as_tensor(h, dtype=x0.dtype, device=x0.device)
    nbr_start, nbr = cutoff_list(x0, seg_start, seg_end, h * h)
    return sorted_hash, seg_start, seg_end, nbr_start, nbr


def make_elastic_solid(positions, params: SimParams, cfg: SimConfig,
                       spacing: float, *, grid: Optional[gridlib.Grid] = None,
                       fixed=None, density=None, plastic: bool = False,
                       device=None):
    """Make an elastic body on ``device`` (default: the CUDA device): sort
    the reference lattice by cell hash (stably, as the JAX package does,
    so ``statics.x0`` comes in the same order), build its static ranges
    and pair list, and compute the gradient corrections from one
    deformation-gradient sweep at x = X. Returns ``(state, statics, grid)``.

    ``positions`` (N, 3) (:func:`sample_box_solid`); ``spacing`` the
    lattice constant (V = spacing³, m = ρV); ``fixed`` (N,) bool of pinned
    particles; ``density`` the body's (default the fluid ρ₀); ``grid`` by
    default ``fit_grid`` around the reference box with a 2h margin (the
    ranges and the pair list live in reference space, so the body may move
    anywhere)."""
    from .elastic_cuda import f_gradient_sweep
    device = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions)).to(dtype=cfg.dtype,
                                                    device=device)
    n = pos.shape[0]
    if grid is None:
        h = float(params.interaction_radius)
        p = pos.cpu().numpy()
        grid = gridlib.fit_grid(p.min(0), p.max(0), h, margin=2.0 * h,
                                dtype=cfg.dtype, device=device)
    fx = (torch.zeros((n,), dtype=torch.bool, device=device) if fixed is None
          else torch.as_tensor(np.asarray(fixed, bool), device=device))
    hashes = gridlib.hash_positions(grid, pos)
    _, _, (x0, fxs) = gridlib.sort_by_hash(hashes, pos, fx)
    sorted_hash, seg_start, seg_end, nbr_start, nbr = static_ranges(
        grid, x0, params.interaction_radius)
    sp = torch.tensor(spacing, dtype=cfg.dtype, device=device)
    vol = sp * sp * sp
    rho = (params.rest_density if density is None
           else torch.tensor(density, dtype=cfg.dtype, device=device))
    eye = torch.eye(3, dtype=cfg.dtype, device=device)
    statics = ElasticStatics(
        x0=x0, sorted_hash=sorted_hash, seg_start=seg_start,
        seg_end=seg_end, nbr_start=nbr_start, nbr=nbr,
        miss=torch.zeros((), dtype=torch.int32, device=device),
        corr=eye.expand(n, 3, 3).contiguous(), fixed=fxs, vol=vol,
        mass=rho * vol)
    # D_i from the accumulator that computes F every step, at x = X: then
    # C = D⁻¹ makes the rest F exactly I
    raw = f_gradient_sweep(statics, x0, params, grid, cfg)
    statics = dataclasses.replace(statics,
                                  corr=_inv3(vol * raw.reshape(n, 3, 3)))
    state = ElasticState(
        pos=x0, vel=torch.zeros_like(x0),
        plastic=(torch.zeros((n, 3, 3), dtype=cfg.dtype, device=device)
                 if plastic else None))
    return state, statics, grid


def elastic_step(state: ElasticState, statics: ElasticStatics,
                 params: SimParams, ep: ElasticParams, grid: gridlib.Grid,
                 cfg: SimConfig, f_ext=None):
    """One symplectic-Euler elastic step; returns ``(state,
    ElasticDiagnostics)``. ``f_ext`` (optional (N, 3), statics order):
    external per-particle forces held over the step (the fluid's reaction
    in the coupled step). The sweeps run the CUDA kernels on a GPU and
    their plain versions on the CPU."""
    from .elastic_cuda import elastic_step_cuda
    return elastic_step_cuda(state, statics, params, ep, grid, cfg,
                             f_ext=f_ext)


def _integrate(state, statics, params, ep, force, f_mat, e, seg_over,
               plastic=None):
    """Symplectic Euler under gravity, the floor and box penalty springs
    (ω = 0.2/dt, conservative), damping and the pinned particles."""
    dt = params.dt
    acc = force / statics.mass + params.gravity[None, :]
    depth = torch.clamp(ep.floor_y - state.pos[:, 1], min=0.0)
    omega = 0.2 / dt
    acc[:, 1] += omega * omega * depth
    # ±inf walls make both terms exactly 0
    acc = acc + (omega * omega) * (
        torch.clamp(ep.box_lo[None, :] - state.pos, min=0.0)
        - torch.clamp(state.pos - ep.box_hi[None, :], min=0.0))
    nv = (state.vel + dt * acc) / (1.0 + ep.damping * dt)
    nv = torch.where(statics.fixed[:, None], torch.zeros_like(nv), nv)
    np_ = state.pos + dt * nv
    eye = torch.eye(3, dtype=f_mat.dtype, device=f_mat.device)
    diag = ElasticDiagnostics(
        elastic_energy=strain_energy(e, ep, statics.vol),
        max_stretch=torch.max(torch.abs(f_mat - eye)),
        max_speed=torch.sqrt(torch.max(torch.sum(nv * nv, dim=1))),
        seg_overflow=seg_over)
    return ElasticState(pos=np_, vel=nv, plastic=plastic), diag
