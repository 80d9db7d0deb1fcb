"""SPH smoothing-kernel library (PyTorch port of ``nereus_tpu.kernels``).

Müller-2003 poly6 / spiky / viscosity kernels, the Monaghan cubic spline,
and the Akinci-2013 cohesion and boundary-adhesion kernels
(``common/kernels_impl.cuh:85-247``). Branchless tensor expressions over
arbitrary leading batch dimensions: ``r`` is a displacement ``(..., 3)``,
returns are ``(...)`` scalars or ``(..., 3)`` gradients. Gradients are
exactly zero (not NaN) at ``r = 0`` and outside the support radius. The
operation order follows the JAX functions, so float32 results agree to
the last bits.
"""

from __future__ import annotations

import math

import torch

from .params import KernelSet, SimParams

_EPS = 1e-12


def _sqnorm(r):
    return torch.sum(r * r, dim=-1)


def _norm(r):
    return torch.sqrt(_sqnorm(r))


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Müller et al. 2003 kernel set
# ---------------------------------------------------------------------------

def w_poly6(r, h, kpoly):
    """Poly6 W(r) = kpoly (h² − |r|²)³ for |r| ≤ h (``Wdefault``)."""
    r2 = _sqnorm(r)
    h2 = h * h
    d = h2 - r2
    return torch.where(r2 <= h2, kpoly * d * d * d, _zero(r2))


def w_poly6_grad(r, h, kpoly_grad):
    """∇Poly6 = kpoly_grad · r⃗ · (h² − |r|²)² (``Wdefault_grad``)."""
    r2 = _sqnorm(r)
    h2 = h * h
    d = h2 - r2
    scale = torch.where(r2 <= h2, kpoly_grad * d * d, _zero(r2))
    return scale[..., None] * r


def w_spiky_grad(r, h, kpress_grad):
    """Spiky ∇W = kpress_grad · (r⃗/|r|) · (h − |r|)² (``Wpressure_grad``)."""
    rl = _norm(r)
    c = (h - rl) * (h - rl)
    scale = torch.where((rl <= h) & (rl > _EPS),
                        kpress_grad * c / torch.clamp(rl, min=_EPS),
                        _zero(rl))
    return scale[..., None] * r


def w_viscosity_grad(r, h, kvisc_grad, kvisc_denum):
    """Müller viscosity-kernel gradient, kvisc_denum = 2h³
    (``Wviscosity_grad``)."""
    rl = _norm(r)
    h2 = h * h
    rl3 = torch.clamp(rl * rl * rl, min=_EPS)
    c = -(3.0 * rl / kvisc_denum) + (2.0 / h2) - (h / (2.0 * rl3))
    scale = torch.where((rl <= h) & (rl > _EPS), kvisc_grad * c, _zero(rl))
    return scale[..., None] * r


# ---------------------------------------------------------------------------
# Monaghan cubic spline, σ = 1/(4πh³), support 2h
# ---------------------------------------------------------------------------

def w_monaghan(r, h):
    """Monaghan cubic spline (``Wmonaghan``)."""
    sigma = 1.0 / (4.0 * math.pi * h * h * h)
    q = _norm(r) / h
    a = 2.0 - q
    b = 1.0 - q
    inner = a * a * a - 4.0 * b * b * b
    outer = a * a * a
    return sigma * torch.where(q < 1.0, inner,
                               torch.where(q < 2.0, outer, _zero(q)))


def w_monaghan_grad(r, h):
    """Gradient of the Monaghan spline (``Wmonaghan_grad``); zero at r = 0
    and beyond 2h."""
    sigma = 1.0 / (4.0 * math.pi * h * h * h)
    rl = _norm(r)
    q = rl / h
    a = 2.0 - q
    b = 1.0 - q
    s_inner = -3.0 * a * a + 12.0 * b * b
    s_outer = -3.0 * a * a
    scalar = torch.where(q < 1.0, s_inner,
                         torch.where(q < 2.0, s_outer, _zero(q)))
    scale = torch.where(rl > _EPS,
                        sigma * scalar / (h * torch.clamp(rl, min=_EPS)),
                        _zero(rl))
    return scale[..., None] * r


# ---------------------------------------------------------------------------
# Akinci 2013 cohesion / boundary adhesion
# ---------------------------------------------------------------------------

def c_akinci(r, h, ksurf1, ksurf2):
    """Akinci cohesion kernel C(r), ksurf1 = 32/(πh⁹), ksurf2 = h⁶/64
    (``Cakinci``)."""
    rl = _norm(r)
    hr = h - rl
    cube = hr * hr * hr * rl * rl * rl
    near = ksurf1 * (2.0 * cube - ksurf2)
    far = ksurf1 * cube
    return torch.where(
        (2.0 * rl > h) & (rl <= h), far,
        torch.where((rl > _EPS) & (2.0 * rl <= h), near, _zero(rl)))


def a_boundary(r, h, bpol):
    """Akinci boundary-adhesion kernel A(r) (``Aboundary``)."""
    rl = _norm(r)
    arg = -(4.0 * rl * rl) / h + 6.0 * rl - 2.0 * h
    val = bpol * torch.pow(torch.clamp(arg, min=0.0), 0.25)
    return torch.where((2.0 * rl > h) & (rl <= h), val, _zero(rl))


# ---------------------------------------------------------------------------
# Kernel-set dispatch (the reference's KERNEL_SET compile-time switch)
# ---------------------------------------------------------------------------

def w_value(kernel_set: KernelSet, r, p: SimParams):
    """W(r): density-style kernel value for the configured set."""
    if kernel_set == KernelSet.MULLER:
        return w_poly6(r, p.interaction_radius, p.kpoly)
    return w_monaghan(r, p.interaction_radius)


def w_default_grad(kernel_set: KernelSet, r, p: SimParams):
    """∇W of density-gradient-style terms (poly6 grad under Müller)."""
    if kernel_set == KernelSet.MULLER:
        return w_poly6_grad(r, p.interaction_radius, p.kpoly_grad)
    return w_monaghan_grad(r, p.interaction_radius)


def w_pressure_grad(kernel_set: KernelSet, r, p: SimParams):
    """∇W of the WCSPH pressure force (spiky under Müller)."""
    if kernel_set == KernelSet.MULLER:
        return w_spiky_grad(r, p.interaction_radius, p.kpress_grad)
    return w_monaghan_grad(r, p.interaction_radius)


def w_viscosity_grad_set(kernel_set: KernelSet, r, p: SimParams):
    """∇W of the WCSPH viscosity force."""
    if kernel_set == KernelSet.MULLER:
        return w_viscosity_grad(r, p.interaction_radius, p.kvisc_grad,
                                p.kvisc_denum)
    return w_monaghan_grad(r, p.interaction_radius)
