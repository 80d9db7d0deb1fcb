"""SPH pair formulas, their plain sweeps, and the sweep dispatchers
(PyTorch port of the main-path part of ``nereus_tpu.ops.pallas_sph``).

Parameter scalars travel as one packed vector (:func:`build_pvec`, the
same ``PV_*`` layout as the JAX package): the CUDA kernels read it from
device memory, the plain formulas index it.

Source matrices are (M, 8) float32 rows ``x y z vx vy vz s6 pad``. Slot 6
means different things by region: ρ_j (force sweep; its fluid rows are
the force queries ``x y z vx vy vz ρ pd2``, pd2_j in slot 7) or
p_j/ρ_j² (the implicit solvers' pressure force; κ_j/ρ_j in DFSPH's κ
correction) for fluid sources, ψ_b = ρ₀·V_b for boundary sources. The
density sweep reads a (M, 4) source ``x y z ψ`` (ψ = m for fluid rows,
ψ_b for boundary rows) whose fluid rows may be the density queries
themselves, IISPH's Σd_ij·p_j one (C, 4) matrix ``x y z p/ρ²`` as its
queries and source. Query matrices are (N, 4) ``x y z pad`` for density
(slot 3 unread) and (N, 8) ``x y z vx vy vz ρ pd2`` for forces. The IISPH
Jacobi sum reads an 8-wide source whose fluid rows carry
e_j = d_jj·p_j + Σd_jk·p_k in slots 3-5; its d_ii, ρ_adv and a_ii sweep
one (C + Mb, 12) wide matrix whose first C rows are its queries, fluid
rows ``x y z v_adv m v 1/ρ² 0``. The multiphase force sweep reads
one (C + Mb, 12) wide matrix (``WIDE_WIDTH``) whose first C rows are its
queries: fluid rows ``x y z vx vy vz V p·V² ρ0 1/m m 1/ρ̃``, boundary rows
``x y z v_b ψ_b 0…``. Multiphase DFSPH's dδ̂/dt reads one (C + Mb, 8)
matrix, its queries the first C rows: fluid rows ``x y z v s/m 0`` (s_i/m_i
read from the query alone), boundary rows ``x y z v_b ψ_b 0``.
DFSPH's density and factor α read the density's (M, 4) matrix ``x y z ψ``
in one walk, its first N rows the queries. The multiphase density sweep
reads a (M, 4) source ``x y z s`` whose fluid s it never reads and whose
boundary rows are ``x y z ψ_b``; the multiphase DFSPH α and κ sweeps and
PBF's λ and Δp sweeps a (M, 4) source ``x y z s`` (fluid s = 1/m_j, κV̂²_j
or λ_j, boundary s = ψ_b; PBF's λ sweep reads its fluid ψ = m from pvec).

The pair formulas keep the JAX functions' operation order, including the
float32 overflow discipline: r² is clamped to ε² before the rsqrt, so
every term but the density self term is exactly 0 at r = 0, and the Müller
viscosity bracket (~1e36 at the clamp) multiplies r² before its ~1e4
constant.

Every sweep dispatcher (``density_sweep``, ``fluid_force_sweep``, the
four IISPH sweeps (``dii_aii_sweep`` the TPU's two pre-loop sweeps in
one), PCISPH's ``predicted_density_sweep``, the DFSPH sweeps
(``density_alpha_sweep`` and ``density_alpha_sums_sweep`` the TPU's
density and α sweeps in one, and ``drho_sweep``), the
multiphase density and force sweeps, ``xsph_sweep``, the implicit
viscosity solve's ``visc_laplacian_sweep``, the three multiphase DFSPH
sweeps (``multiphase_density_alpha_sweep`` the TPU's multiphase density
and α̂ sweeps in one), PBF's λ, Δp, ω and N sweeps, the rigid-body
coupling's ``body_density_sweep``, ``body_force_sweep`` and
``multiphase_body_sweep``, the elastic solid's ``elastic_f_sweep`` and
``elastic_force_hourglass_sweep`` (both over the body's static pair list,
``nbr_start`` and ``nbr`` in the places of the ranges), the elastic
coupling's
``fluid_reaction_sweep``, and the DFSPH couplings' body sweeps
``pressure_force_body_sweep`` (and its reverse,
``pressure_force_body_rev_sweep``), ``body_density_alpha_sweep`` (the
TPU's density and α sweeps over a shell in one), ``drho_shell_sweep`` and
the three
``multiphase_*_body_sweep``, and the wall-only
``boundary_force_sweep``) routes by device:
a CPU tensor goes to the plain sweep, a CUDA float32 tensor to the
hand-written kernel (``ops/cuda_sweep.py``); anything else raises. The
two sweeps of the row-tiled engine (``pressure_force_sweep``,
``visc_laplacian_sweep``) take the step's tile plan as ``plan``, which
only the kernel reads.
"""

from __future__ import annotations

import math

import torch

from .. import kernels as K
from ..params import KernelSet, SimConfig, SimParams, SurfaceTensionModel
from .neighbors import list_sweep_plain, neighbor_sweep_plain

_EPS = 1e-12

# pvec layout (the JAX package's, and csrc/sweep_common.cuh's, which
# adds PV_PBF_EPS)
PV_H2 = 0
PV_PM = 1
PV_KPOLY = 2
PV_KPRESS = 3
PV_KVISC = 4
PV_KVISC_DEN = 5
PV_H = 6
PV_KAPPA = 7
PV_WDIAM = 8       # W(2·particle_radius), for the Becker clamp
PV_DIAM2 = 9
PV_BETA = 10
PV_VISC = 11
PV_CS = 12
PV_RD = 13
PV_K = 14          # Tait stiffness
PV_KSURF1 = 15
PV_KSURF2 = 16
PV_KPOLY_GRAD = 17
PV_OX = 18
PV_OY = 19
PV_OZ = 20
PV_INVCELL = 21
PV_DT = 22
PV_SCORR_S = 23
PV_STX = 24
PV_PBF_EPS = 25    # PBF's λ relaxation ε (the λ kernel's epilogue)
PV_LEN = 26

SRC_WIDTH = 8
WIDE_WIDTH = 12
# slots of the multiphase force's one (C + Mb, WIDE_WIDTH) matrix past
# x y z vx vy vz, in ``wcsph_cuda.multiphase_force_args``' column order (the
# kernel's MultiphaseForce in ``csrc/multiphase_sweep.cu`` names the same)
MP_V, MP_PV2, MP_RHO0, MP_INV_M, MP_MASS, MP_INV_RHO = range(6, 12)


def build_pvec(params: SimParams, cfg: SimConfig, grid):
    """The packed (PV_LEN,) parameter vector, in ``cfg.dtype`` on the
    params' device."""
    h = params.interaction_radius
    diam = 2.0 * params.particle_radius
    zero = torch.zeros_like(diam)
    wdiam = K.w_value(cfg.kernel_set,
                      torch.stack([diam, zero, zero])[None, :], params)[0]
    vals = [None] * PV_LEN
    vals[PV_H2] = h * h
    vals[PV_PM] = params.particle_mass
    vals[PV_KPOLY] = params.kpoly
    vals[PV_KPRESS] = params.kpress_grad
    vals[PV_KVISC] = params.kvisc_grad
    vals[PV_KVISC_DEN] = params.kvisc_denum
    vals[PV_H] = h
    vals[PV_KAPPA] = params.surface_tension
    vals[PV_WDIAM] = wdiam
    vals[PV_DIAM2] = diam * diam
    vals[PV_BETA] = params.beta
    vals[PV_VISC] = params.viscosity
    vals[PV_CS] = params.sound_speed
    vals[PV_RD] = params.rest_density
    vals[PV_K] = params.gas_stiffness
    vals[PV_KSURF1] = params.ksurf1
    vals[PV_KSURF2] = params.ksurf2
    vals[PV_KPOLY_GRAD] = params.kpoly_grad
    vals[PV_OX] = grid.origin[0]
    vals[PV_OY] = grid.origin[1]
    vals[PV_OZ] = grid.origin[2]
    vals[PV_INVCELL] = 1.0 / grid.cell[0]
    vals[PV_DT] = params.dt
    if cfg.pbf_scorr_k > 0.0:
        wdq = K.w_value(cfg.kernel_set,
                        torch.stack([cfg.pbf_scorr_dq * h, zero, zero])[None],
                        params)[0]
        vals[PV_SCORR_S] = (cfg.pbf_scorr_k ** 0.25) / torch.clamp(
            wdq, min=1e-30)
    else:
        vals[PV_SCORR_S] = zero
    vals[PV_STX] = torch.full_like(h, cfg.st_cross)
    vals[PV_PBF_EPS] = torch.full_like(h, cfg.pbf_eps)
    return torch.stack([v.to(device=h.device, dtype=cfg.dtype)
                        for v in vals])


# ---------------------------------------------------------------------------
# Smoothing-kernel pieces on pair vectors (cutoff applied by the caller)
# ---------------------------------------------------------------------------

def _rl_invrl(r2):
    """|r| and 1/|r| from one rsqrt of the ε²-clamped r² (finite at 0)."""
    inv = torch.rsqrt(torch.clamp(r2, min=_EPS * _EPS))
    return r2 * inv, inv


def _w_value(kernel_set, r2, rl, pv):
    if kernel_set == KernelSet.MULLER:
        d = torch.clamp(pv[PV_H2] - r2, min=0.0)
        return pv[PV_KPOLY] * d * d * d
    h = pv[PV_H]
    sigma = 1.0 / (4.0 * math.pi * h * h * h)
    q = rl / h
    a = torch.clamp(2.0 - q, min=0.0)
    bq = torch.clamp(1.0 - q, min=0.0)
    return sigma * (a * a * a - 4.0 * bq * bq * bq)


def _w_grad_scale_monaghan(rl, pv, invrl):
    h = pv[PV_H]
    sigma = 1.0 / (4.0 * math.pi * h * h * h)
    q = rl / h
    a = torch.clamp(2.0 - q, min=0.0)
    bq = torch.clamp(1.0 - q, min=0.0)
    scalar = -3.0 * a * a + 12.0 * bq * bq
    return (sigma / h) * scalar * invrl


def _w_grad_scale_default(kernel_set, r2, rl, pv, invrl):
    """s with ∇W = s·r⃗ for the poly6/default gradient."""
    if kernel_set == KernelSet.MULLER:
        d = torch.clamp(pv[PV_H2] - r2, min=0.0)
        return pv[PV_KPOLY_GRAD] * d * d
    return _w_grad_scale_monaghan(rl, pv, invrl)


def _w_grad_scale_press(kernel_set, r2, rl, pv, invrl):
    """s for the spiky pressure gradient (finite at r = 0 via invrl)."""
    if kernel_set == KernelSet.MULLER:
        hr = torch.clamp(pv[PV_H] - rl, min=0.0)
        return pv[PV_KPRESS] * hr * hr * invrl
    return _w_grad_scale_monaghan(rl, pv, invrl)


def _visc_rdotgrad(kernel_set, r2, rl, pv, invrl):
    """r⃗·∇W_visc. The Müller bracket multiplies r² BEFORE the KVISC
    constant: the other order overflows to inf at the clamp, and inf·0 is
    NaN."""
    if kernel_set == KernelSet.MULLER:
        inv3 = invrl * invrl * invrl
        c = ((2.0 / pv[PV_H2]) - rl * (3.0 / pv[PV_KVISC_DEN])
             - inv3 * (pv[PV_H] * 0.5))
        return (c * r2) * pv[PV_KVISC]
    return _w_grad_scale_monaghan(rl, pv, invrl) * r2


def _geometry(q, s):
    dx = q[:, 0] - s[:, 0]
    dy = q[:, 1] - s[:, 1]
    dz = q[:, 2] - s[:, 2]
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


# ---------------------------------------------------------------------------
# Pair formulas: (P, Fq) query rows × (P, 8) source rows → (P, k)
# ---------------------------------------------------------------------------

def density_pair(q, s, pv, *, kernel_set):
    """ψ_j·W(r): one formula for fluid (ψ = m) and boundary (ψ_b) sources
    (``computeCellDensity`` / ``computeBoundaryCellDensity``,
    ``sph_kernel_impl.cuh:290-360``), ψ_j in slot 3 of the (P, 4) source
    rows ``x y z ψ``. Returns (P, 1)."""
    _, _, _, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        # poly6 vanishes outside the cutoff through the clamp
        d = torch.clamp(pv[PV_H2] - r2, min=0.0)
        return ((d * d * d) * (s[:, 3] * pv[PV_KPOLY]))[:, None]
    rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    return (s[:, 3] * _w_value(kernel_set, r2, rl, pv) * okf)[:, None]


def fluid_force_pair(q, s, pv, *, kernel_set, st_model,
                     include_pressure=True, include_viscosity=True):
    """Fluid-source forces: Müller viscosity, Becker or Akinci surface
    tension, and symmetric Tait pressure. The source rows are force query
    rows ``x y z vx vy vz ρ pd2``: ρ_j in slot 6, pd2_j = p_j/ρ_j² in slot
    7, the step's own Tait p/ρ² (the JAX pair recomputes it from ρ_j).
    ``include_pressure=False`` drops the whole Tait term, pd2_i and pd2_j
    (the implicit solvers' advection forces; slot 7 unread);
    ``include_viscosity=False`` the viscosity (the implicit viscosity solve
    owns it). Returns (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    dens_j = torch.clamp(s[:, 6], min=_EPS)
    inv_dens = 1.0 / dens_j

    # pressure: −m²(pd2_i + pd2_j)·∇W_press
    if include_pressure:
        sp = _w_grad_scale_press(kernel_set, r2, rl, pv, invrl)
        cpd = (q[:, 7] + s[:, 7]) * (-pv[PV_PM] * pv[PV_PM]) * sp
    else:
        cpd = torch.zeros_like(r2)

    if st_model == SurfaceTensionModel.BECKER:
        # the reference's diameter clamp, as min(W, W(diam))
        w_eff = torch.minimum(_w_value(kernel_set, r2, rl, pv),
                              pv[PV_WDIAM])
        cpd = cpd + w_eff * (-pv[PV_KAPPA])
    elif st_model == SurfaceTensionModel.AKINCI:
        h = pv[PV_H]
        hr = torch.clamp(h - rl, min=0.0)
        cube = hr * hr * hr * rl * rl * rl
        near = pv[PV_KSURF1] * (2.0 * cube - pv[PV_KSURF2])
        far = pv[PV_KSURF1] * cube
        zero = torch.zeros_like(rl)
        c = torch.where((2.0 * rl > h) & (rl <= h), far,
                        torch.where((rl > _EPS) & (2.0 * rl <= h), near,
                                    zero))
        kij = 2.0 * pv[PV_RD] / (q[:, 6] + dens_j)
        cpd = cpd + (-pv[PV_KAPPA] * pv[PV_PM] * pv[PV_PM]) * kij * c * invrl

    cpd = cpd * okf
    if not include_viscosity:
        return torch.stack([cpd * dx, cpd * dy, cpd * dz], dim=1)
    # viscosity 2·m·μ·(m/ρ_j)(r·∇W_v)/(r² + 0.01h²)·(v_i − v_j); exact 1/x
    a = _visc_rdotgrad(kernel_set, r2, rl, pv, invrl)
    kv = (2.0 * pv[PV_PM] * pv[PV_VISC] * pv[PV_PM]) * inv_dens
    bden = r2 + 0.01 * pv[PV_H2]
    cvisc = kv * (a * (1.0 / bden)) * okf
    return torch.stack([cvisc * (q[:, 3] - s[:, 3]) + cpd * dx,
                        cvisc * (q[:, 4] - s[:, 4]) + cpd * dy,
                        cvisc * (q[:, 5] - s[:, 5]) + cpd * dz], dim=1)


def boundary_force_pair(q, s, pv, *, kernel_set, include_pressure=True,
                        include_friction=True, moving=False,
                        include_adhesion=True, pressure_sign=1.0,
                        consistent_pressure=False):
    """Boundary forces (``computeCellForces`` boundary loop,
    ``sph_kernel_impl.cuh:552-602``): β adhesion β·ψ·W·r⃗ (dropped with
    ``include_adhesion=False``), friction with max(v_i·r⃗, 0) (dropped with
    ``include_friction=False``: the implicit viscosity solve owns it), and
    the reference-scale boundary pressure +m²·ψ·pd2_i·∇W_dflt (the
    reference's sign and scale, kept for parity; dropped with
    ``include_pressure=False``). ``moving``: the source rows carry wall
    velocities in slots 3-5 and the friction reads (v_i − v_b)·r⃗.

    The rigid-body contact (``BodyForce``) is ``moving=True,
    include_adhesion=False, pressure_sign=-1, consistent_pressure=True``:
    the repulsive Akinci pressure at the consistent scale
    −m·ψ·max(pd2_i, 0)·∇W_dflt (the clamp drops free-surface tension).
    Returns (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    psi = s[:, 6]
    dens_i = torch.clamp(q[:, 6], min=_EPS)
    sd = _w_grad_scale_default(kernel_set, r2, rl, pv, invrl)
    cadh = 0.0
    if include_adhesion:
        cadh = (pv[PV_BETA] * psi) * _w_value(kernel_set, r2, rl, pv)
    cfric = 0.0
    if include_friction:
        nu = ((2.0 * pv[PV_PM] * pv[PV_PM] * pv[PV_VISC] * pv[PV_VISC]
               * pv[PV_H] * pv[PV_CS]) / (1.0 + 0.01 * pv[PV_H2])) \
            / (dens_i * dens_i)
        if moving:
            vdotr = ((q[:, 3] - s[:, 3]) * dx + (q[:, 4] - s[:, 4]) * dy
                     + (q[:, 5] - s[:, 5]) * dz)
        else:
            vdotr = q[:, 3] * dx + q[:, 4] * dy + q[:, 5] * dz
        cfric = nu * torch.clamp(vdotr, min=0.0) * psi * sd
    if include_pressure:
        if consistent_pressure:
            c = cadh + (cfric + (pressure_sign * pv[PV_PM]) * psi
                        * torch.clamp(q[:, 7], min=0.0) * sd)
        else:
            c = cadh + (cfric + (pressure_sign * pv[PV_PM] * pv[PV_PM])
                        * psi * q[:, 7] * sd)
    else:
        c = cadh + cfric
    c = c * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


# ---------------------------------------------------------------------------
# IISPH pair formulas (all with the default poly6/Monaghan gradient, as the
# reference's implicit kernels use it)
# ---------------------------------------------------------------------------

def _default_grad(q, s, pv, kernel_set):
    """(dx, dy, dz, r², s, okf) with ∇W_dflt = s·r⃗ and okf the cutoff
    mask; the Müller gradient is a function of r² alone."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    return dx, dy, dz, r2, _w_grad_scale_default(kernel_set, r2, rl, pv,
                                                 invrl), okf


def dii_rhoadv_pair(q, s, pv, *, kernel_set, vel_q_offset):
    """Fused IISPH predict terms: d_ii += −ψ_j·inv_ρ²_i·∇W and
    Δρ_adv += dt·ψ_j·(v_q − v_j)·∇W. ``vel_q_offset`` picks the query
    velocity: 3 = v_adv (fluid rows), 6 = the pre-advection v (boundary
    rows, whose source velocities are 0; ``rho_adv_boundary``,
    ``sph_kernel_impl.cuh:1007-1036``).
    q: x y z vax vay vaz vx vy vz inv_d2 pad pad. Returns (P, 4)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    psi = s[:, 6]
    cdii = -psi * q[:, 9] * sg * okf
    o = vel_q_offset
    dvx = q[:, o] - s[:, 3]
    dvy = q[:, o + 1] - s[:, 4]
    dvz = q[:, o + 2] - s[:, 5]
    cr = pv[PV_DT] * psi * sg * (dvx * dx + dvy * dy + dvz * dz) * okf
    return torch.stack([cdii * dx, cdii * dy, cdii * dz, cr], dim=1)


def aii_pair(q, s, pv, *, kernel_set):
    """a_ii += ψ_j·(d_ii − d_ji)·∇W with d_ji = (m/ρ_i²)∇W, one formula
    for fluid (ψ = m) and boundary rows (``compute_aii_cell[_boundary]``,
    ``sph_kernel_impl.cuh:1040-1108``). q: x y z d_ii(3) m/ρ_i² pad.
    Returns (P, 1)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    dii_dot_r = q[:, 3] * dx + q[:, 4] * dy + q[:, 5] * dz
    term = s[:, 6] * (sg * dii_dot_r - q[:, 6] * sg * sg * r2) * okf
    return term[:, None]


def sum_dij_pair(q, s, pv, *, kernel_set):
    """Σ_j d_ij·p_j = −Σ_j m·(p_j/ρ_j²)·∇W (``dijpjcell``,
    ``sph_kernel_impl.cuh:1224-1253``); slot 3 of the (P, 4) source rows
    ``x y z p/ρ²`` carries p_j/ρ_j². q: x y z (slot 3 unread). Returns
    (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = -pv[PV_PM] * s[:, 3] * sg * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


def jacobi_fluid_pair(q, s, pv, *, kernel_set):
    """Jacobi off-diagonal sum over fluid sources (``computePressure``
    fluid loop, ``sph_kernel_impl.cuh:1330-1445``):
    m·(Σd_ij p_j − e_j)·∇W + m·(m/ρ_i²)·p_i·s²·r² with
    e_j = d_jj p_j + Σd_jk p_k in slots 3-5 of the 8-wide source, and
    d_ji·p_i as the IISPH paper has it. The reference subtracts d_jj p_j
    and Σd_jk p_k one after the other: the same terms, another rounding.
    q: x y z Σd_ij·p_j(3) (m/ρ_i²)·p_i pad. Returns (P, 1)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    ix = q[:, 3] - s[:, 3]
    iy = q[:, 4] - s[:, 4]
    iz = q[:, 5] - s[:, 5]
    inner = sg * (ix * dx + iy * dy + iz * dz) + q[:, 6] * sg * sg * r2
    return (pv[PV_PM] * inner * okf)[:, None]


def jacobi_boundary_pair(q, s, pv, *, kernel_set):
    """Jacobi boundary sum ψ_b·(Σd_ij p_j)·∇W (``sph_kernel_impl.cuh:
    1445-1460``, over the boundary segment bounds, not the reference's
    fluid-start defect). Returns (P, 1)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    dot = sg * (q[:, 3] * dx + q[:, 4] * dy + q[:, 5] * dz)
    return (s[:, 6] * dot * okf)[:, None]


def grad_pressure_force_pair(q, s, pv, *, kernel_set, boundary,
                             boundary_sign=1.0):
    """Implicit-solver pressure force (``computePressureForce``,
    ``sph_kernel_impl.cuh:1497-1620``): fluid −m²(pd2_i + pd2_j)·∇W with
    pd2_j in slot 6; boundary ``boundary_sign``·m·ψ_b·pd2_i·∇W.
    q: x y z pd2. Returns (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    if boundary:
        c = boundary_sign * pv[PV_PM] * s[:, 6] * q[:, 3] * sg
    else:
        c = -pv[PV_PM] * pv[PV_PM] * (q[:, 3] + s[:, 6]) * sg
    c = c * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


# ---------------------------------------------------------------------------
# DFSPH pair formulas (default gradient)
# ---------------------------------------------------------------------------

def alpha_pair(q, s, pv, *, kernel_set, include_sq):
    """DFSPH factor accumulators: Σψ∇W (3) and Σ|ψ∇W|² (fluid rows,
    ``include_sq``; static boundaries add to the gradient sum alone).
    q: x y z pad; s: x y z ψ (the density's rows). Returns (P, 4)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = s[:, 3] * sg * okf
    sq = c * c * r2 if include_sq else torch.zeros_like(c)
    return torch.stack([c * dx, c * dy, c * dz, sq], dim=1)


def drho_pair(q, s, pv, *, kernel_set):
    """DFSPH velocity divergence Σψ_j(v_q − v_j)·∇W, one formula for both
    regions (boundary source velocities are packed 0). q: x y z vx vy vz
    pad pad. Returns (P, 1)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    dvx = q[:, 3] - s[:, 3]
    dvy = q[:, 4] - s[:, 4]
    dvz = q[:, 5] - s[:, 5]
    c = s[:, 6] * sg * (dvx * dx + dvy * dy + dvz * dz) * okf
    return c[:, None]


# ---------------------------------------------------------------------------
# Multiphase WCSPH pair formulas (Solenthaler adapted density, Hu–Adams
# volume-form forces) and XSPH
# ---------------------------------------------------------------------------

def _w_ok(q, s, pv, kernel_set):
    """(dx, dy, dz, r², W, okf); the rsqrt only for Monaghan, whose W
    needs |r|."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl = _rl_invrl(r2)[0] if kernel_set != KernelSet.MULLER else None
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    return dx, dy, dz, r2, _w_value(kernel_set, r2, rl, pv), okf


def multiphase_density_pair(q, s, pv, *, kernel_set):
    """Fluid rows of the multiphase density sweep: the number density
    δ = ΣW into column 0, no source scalar (the caller multiplies by the
    query's own mass, ρ̃_i = m_i·δ_i; the self pair gives W(0)).
    q: x y z pad. Returns (P, 2): [W, 0]."""
    _, _, _, _, w, okf = _w_ok(q, s, pv, kernel_set)
    d = w * okf
    return torch.stack([d, torch.zeros_like(d)], dim=1)


def multiphase_density_bpair(q, s, pv, *, kernel_set):
    """Boundary rows of the multiphase density sweep: Σψ_b·W into column 1,
    apart from the fluid sum, so that the caller rescales the baked
    ψ = ρ0_ref·V_b by each query's ρ0_i/ρ0_ref. s: x y z ψ_b.
    Returns (P, 2): [0, ψW]."""
    _, _, _, _, w, okf = _w_ok(q, s, pv, kernel_set)
    d = s[:, 3] * w * okf
    return torch.stack([torch.zeros_like(d), d], dim=1)


def multiphase_force_pair(q, s, pv, *, kernel_set, st_becker=False):
    """Fluid rows of the multiphase force sweep, as an acceleration:
    −(1/m_i)(p_iV_i² + p_jV_j²)∇W_press
    + 2μV_j(r·∇W_visc)/(r² + 0.01h²)(v_i − v_j), and with ``st_becker``
    −κ_eff(1/m_i)·min(W, W_diam)·r⃗ with κ_eff = κ·(ρ0_i == ρ0_j ? 1 :
    st_cross). Exact division (``_fast_recip`` in JAX).
    q and s rows of one matrix: x y z vx vy vz V pV² ρ0 1/m m 1/ρ̃ (q reads
    every slot but 6, s slots 0-8; ρ0_i and ρ0_j are one column, so the
    same-phase compare is exact). Returns (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    a = _visc_rdotgrad(kernel_set, r2, rl, pv, invrl)
    bden = r2 + 0.01 * pv[PV_H2]
    cvisc = (2.0 * pv[PV_VISC]) * s[:, MP_V] * (a * (1.0 / bden)) * okf
    sp = _w_grad_scale_press(kernel_set, r2, rl, pv, invrl)
    cp = -q[:, MP_INV_M] * (q[:, MP_PV2] + s[:, MP_PV2]) * sp * okf
    if st_becker:
        w_eff = torch.minimum(_w_value(kernel_set, r2, rl, pv),
                              pv[PV_WDIAM])
        same = (q[:, MP_RHO0] == s[:, MP_RHO0]).to(q.dtype)
        keff = pv[PV_KAPPA] * (same + (1.0 - same) * pv[PV_STX])
        cp = cp - (keff * q[:, MP_INV_M]) * w_eff * okf
    return torch.stack([cvisc * (q[:, 3] - s[:, 3]) + cp * dx,
                        cvisc * (q[:, 4] - s[:, 4]) + cp * dy,
                        cvisc * (q[:, 5] - s[:, 5]) + cp * dz], dim=1)


def multiphase_boundary_pair(q, s, pv, *, kernel_set, moving=False):
    """Boundary rows of the multiphase force sweep, as an acceleration: the
    wall penalty (β/m_i)ψ_b·W·r⃗ (ψ unscaled) and the friction
    2μ²h·c_s/(1 + 0.01h²)·m_i/ρ̃_i²·max(v_i·r⃗, 0)·ψ_b·∇W_dflt, with
    (v_i − v_b)·r⃗ when ``moving`` (wall velocities in source slots 3-5);
    no boundary pressure term. q as :func:`multiphase_force_pair` (1/m_i,
    m_i, 1/ρ̃_i in slots 9-11), src ψ_b in slot 6. Returns (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    psi = s[:, 6]
    inv_rho = q[:, MP_INV_RHO]
    w = _w_value(kernel_set, r2, rl, pv)
    sd = _w_grad_scale_default(kernel_set, r2, rl, pv, invrl)
    cadh = (pv[PV_BETA] * psi) * q[:, MP_INV_M] * w
    nu = ((2.0 * pv[PV_VISC] * pv[PV_VISC] * pv[PV_H] * pv[PV_CS])
          / (1.0 + 0.01 * pv[PV_H2])) * q[:, MP_MASS] * (inv_rho * inv_rho)
    if moving:
        vdotr = ((q[:, 3] - s[:, 3]) * dx + (q[:, 4] - s[:, 4]) * dy
                 + (q[:, 5] - s[:, 5]) * dz)
    else:
        vdotr = q[:, 3] * dx + q[:, 4] * dy + q[:, 5] * dz
    cfric = nu * torch.clamp(vdotr, min=0.0) * psi * sd
    c = (cadh + cfric) * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


def multiphase_body_pair(q, s, pv, *, kernel_set):
    """Rigid-body contact rows of the multiphase coupled step, as an
    acceleration: −bp_i·ψ_b·∇W_dflt (bp_i = (ρ0_i/ρ₀)·max(p_i, 0)/ρ̃_i²)
    plus K·fr_i·ψ_b·max((v_i − v_b)·r⃗, 0)·∇W_dflt with
    K = 2μ²h·c_s/(1 + 0.01h²) and fr_i = m_i/ρ̃_i²: the single-phase body
    contact divided by m_i at uniform phase. q: x y z vx vy vz bp_i fr_i;
    src: the body shell ``x y z v_b ψ_b 0``. Returns (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    psi = s[:, 6]
    sd = _w_grad_scale_default(kernel_set, r2, rl, pv, invrl)
    cpress = -q[:, 6] * psi * sd
    kf = ((2.0 * pv[PV_VISC] * pv[PV_VISC] * pv[PV_H] * pv[PV_CS])
          / (1.0 + 0.01 * pv[PV_H2]))
    vdotr = ((q[:, 3] - s[:, 3]) * dx + (q[:, 4] - s[:, 4]) * dy
             + (q[:, 5] - s[:, 5]) * dz)
    cfric = (kf * q[:, 7]) * torch.clamp(vdotr, min=0.0) * psi * sd
    c = (cpress + cfric) * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


def xsph_pair(q, s, pv, *, kernel_set):
    """Monaghan XSPH sum Σ 2m/max(ρ_i + ρ_j, ε)·(v_j − v_i)·W over fluid
    rows (exactly 0 at the self pair: v_i − v_i). q: x y z vx vy vz ρ pad;
    src: x y z vx vy vz ρ pad. Returns (P, 3), scaled by ε by the
    caller."""
    _, _, _, _, w, okf = _w_ok(q, s, pv, kernel_set)
    denom = torch.clamp(q[:, 6] + s[:, 6], min=_EPS)
    c = (2.0 * pv[PV_PM]) * w / denom * okf
    return torch.stack([c * (s[:, 3] - q[:, 3]), c * (s[:, 4] - q[:, 4]),
                        c * (s[:, 5] - q[:, 5])], dim=1)


# ---------------------------------------------------------------------------
# Multiphase DFSPH pair formulas (default gradient, adapted number-density
# domain) and the implicit viscosity Laplacian
# ---------------------------------------------------------------------------

def multiphase_alpha_pair(q, s, pv, *, kernel_set):
    """Fluid rows of the multiphase DFSPH factor sweep: the unweighted
    gradient sum G = Σ∇W (columns 0-2) and S = Σ|∇W|²/m_j (column 3).
    q: x y z pad; src: x y z 1/m_j. Returns (P, 7): [G, S, 0, 0, 0]."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = sg * okf
    z = torch.zeros_like(c)
    return torch.stack([c * dx, c * dy, c * dz, s[:, 3] * c * c * r2,
                        z, z, z], dim=1)


def multiphase_alpha_bpair(q, s, pv, *, kernel_set):
    """Boundary rows of the multiphase DFSPH factor sweep: B = Σψ_b∇W into
    columns 4-6, apart from G, since the caller scales it by each query's
    s_i/m_i. src: x y z ψ_b. Returns (P, 7): [0, 0, 0, 0, B]."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = s[:, 3] * sg * okf
    z = torch.zeros_like(c)
    return torch.stack([z, z, z, z, c * dx, c * dy, c * dz], dim=1)


def _dv_dot_grad(q, s, pv, kernel_set):
    """(s·(v_q − v_j)·r⃗·okf) with ∇W = s·r⃗: the velocity divergence term
    of one pair, without a source weight."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    dvx = q[:, 3] - s[:, 3]
    dvy = q[:, 4] - s[:, 4]
    dvz = q[:, 5] - s[:, 5]
    return sg, dvx * dx + dvy * dy + dvz * dz, okf


def multiphase_drho_pair(q, s, pv, *, kernel_set):
    """Fluid rows of the adapted number-density rate dδ̂/dt: Σ(v_q − v_j)·∇W
    into column 0, with no mass weight. q: x y z vx vy vz pad pad.
    Returns (P, 2)."""
    sg, dv, okf = _dv_dot_grad(q, s, pv, kernel_set)
    c = sg * dv * okf
    return torch.stack([c, torch.zeros_like(c)], dim=1)


def multiphase_drho_bpair(q, s, pv, *, kernel_set):
    """Boundary rows of dδ̂/dt: Σψ_b(v_q − v_b)·∇W into column 1 (scaled by
    s_i/m_i outside; wall velocities in source slots 3-5, 0 when static).
    Returns (P, 2)."""
    sg, dv, okf = _dv_dot_grad(q, s, pv, kernel_set)
    c = s[:, 6] * sg * dv * okf
    return torch.stack([torch.zeros_like(c), c], dim=1)


def multiphase_kappa_pair(q, s, pv, *, kernel_set):
    """Fluid rows of the multiphase stiffness correction: the positive sum
    Σ(κV̂²_i + κV̂²_j)∇W (the caller applies v −= dt/m_i·out).
    q: x y z κV̂²_i qc_i pad pad pad; src: x y z κV̂²_j. Returns (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = (q[:, 3] + s[:, 3]) * sg * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


def multiphase_kappa_bpair(q, s, pv, *, kernel_set):
    """Boundary rows of the multiphase stiffness correction: qc_i·Σψ_b∇W
    with qc_i = (s_i/m_i)·κV̂²_i (query column 4), into the same columns
    as the fluid rows. src: x y z ψ_b. Returns (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = q[:, 4] * s[:, 3] * sg * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


def visc_laplacian_pair(q, s, pv, *, kernel_set, boundary):
    """Weiler-2018 viscous Laplacian L(v)_i = 10·Σ coef·(v_ij·x_ij)/
    (|x_ij|² + 0.01h²)·∇W with coef = m/ρ_j for fluid sources (slot 6) and
    ψ_b/ρ_i for boundary sources (ψ_b in slot 6, ρ_i in query column 6;
    wall velocities in slots 3-5). Exact division (``_fast_recip`` in
    JAX). q: x y z vx vy vz ρ pad. Returns (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    if boundary:
        coef = s[:, 6] * (1.0 / torch.clamp(q[:, 6], min=_EPS))
    else:
        coef = s[:, 6]
    dvdotx = ((q[:, 3] - s[:, 3]) * dx + (q[:, 4] - s[:, 4]) * dy
              + (q[:, 5] - s[:, 5]) * dz)
    c = (10.0 * coef * sg) * dvdotx * (1.0 / (r2 + 0.01 * pv[PV_H2])) * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


# ---------------------------------------------------------------------------
# PBF pair formulas (default gradient; Macklin & Müller 2013)
# ---------------------------------------------------------------------------

def _w_grad(q, s, pv, kernel_set):
    """(dx, dy, dz, r², W, s, okf) with ∇W = s·r⃗ the default gradient;
    the rsqrt only for Monaghan."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    return (dx, dy, dz, r2, _w_value(kernel_set, r2, rl, pv),
            _w_grad_scale_default(kernel_set, r2, rl, pv, invrl), okf)


def pbf_lambda_pair(q, s, pv, *, kernel_set, include_sq):
    """PBF constraint sums ρ = Σψ_jW, Σψ_j∇W and (``include_sq``: fluid
    rows) Σ|ψ_j∇W|², one formula for fluid (ψ = m) and wall (ψ_b) sources;
    vorticity confinement's N = Σ(m/ρ_j·|ω_j|)∇W is the same sum on the
    fluid rows. q: x y z pad; src: x y z ψ. Returns (P, 5)."""
    dx, dy, dz, r2, w, sg, okf = _w_grad(q, s, pv, kernel_set)
    psi = s[:, 3]
    d = psi * w * okf
    c = psi * sg * okf
    sq = c * c * r2 if include_sq else torch.zeros_like(c)
    return torch.stack([d, c * dx, c * dy, c * dz, sq], dim=1)


def pbf_lambda_of(al, pv):
    """(ρ, λ) (N, 2) from the λ sums ``al`` (N, 5), in the JAX step's
    order (``pbf_pallas.py:71-75``): λ = −max(ρ/ρ₀ − 1, 0) / ((|Σψ∇W|² +
    Σ|ψ∇W|²)/ρ₀² + ε), ρ₀ and ε from ``pv``; the λ kernel's epilogue. The
    columns are contiguous (N,) planes, as the kernel writes them."""
    rd = pv[PV_RD]
    dens = al[:, 0]
    comp = torch.clamp(dens / rd - 1.0, min=0.0)
    denom = (al[:, 1] ** 2 + al[:, 2] ** 2 + al[:, 3] ** 2
             + al[:, 4]) / (rd * rd)
    return torch.stack([dens, -comp / (denom + pv[PV_PBF_EPS])]).t()


def pbf_dp_pair(q, s, pv, *, kernel_set, boundary):
    """PBF position correction (unscaled by 1/ρ₀): fluid sources
    m(λ_i + λ_j + scorr)∇W with scorr = −(W·s_corr)⁴ (``PV_SCORR_S``),
    wall sources ψ_b·λ_i·∇W. q: x y z λ_i; src: x y z (λ_j or ψ_b).
    Returns (P, 3)."""
    dx, dy, dz, r2, w, sg, okf = _w_grad(q, s, pv, kernel_set)
    if boundary:
        coef = s[:, 3] * q[:, 3] * sg
    else:
        t = w * pv[PV_SCORR_S]
        t2 = t * t
        scorr = -(t2 * t2)
        coef = pv[PV_PM] * (q[:, 3] + s[:, 3] + scorr) * sg
    coef = coef * okf
    return torch.stack([coef * dx, coef * dy, coef * dz], dim=1)


def pbf_omega_pair(q, s, pv, *, kernel_set):
    """PBF vorticity ω = Σ(m/ρ_j)(v_j − v_i)×∇W over fluid rows (exactly 0
    at the self pair). q: x y z vx vy vz pad pad; src: x y z vx vy vz
    m/ρ_j pad. Returns (P, 3)."""
    dx, dy, dz, r2, sg, okf = _default_grad(q, s, pv, kernel_set)
    c = s[:, 6] * sg * okf
    dvx = s[:, 3] - q[:, 3]
    dvy = s[:, 4] - q[:, 4]
    dvz = s[:, 5] - q[:, 5]
    return torch.stack([c * (dvy * dz - dvz * dy), c * (dvz * dx - dvx * dz),
                        c * (dvx * dy - dvy * dx)], dim=1)


# ---------------------------------------------------------------------------
# Elastic-solid pair formulas (total-Lagrangian SPH): the geometry, the
# r² < h² cutoff and the spiky-gradient scale read the REFERENCE positions X
# (query and source slots 0-2); the current positions x are payload. The
# force and hourglass sweeps read one (N, 24) row ``X x PC F`` (ELASTIC_*
# offsets, PC = P·Cᵀ and F row-major); the deformation-gradient sweep an
# (N, 8) row ``X x 0 0``.
# ---------------------------------------------------------------------------

ELASTIC_F_WIDTH = 8
ELASTIC_WIDTH = 24
ELASTIC_PC = 6      # PC_i, 9 slots
ELASTIC_F = 15      # F_i, 9 slots


def elastic_f_pair(q, s, pv, *, kernel_set):
    """Deformation-gradient accumulator (x_j − x_i) ⊗ ∇W(X_ij), row-major
    [3α+β] (α the current offset, β the reference gradient); exactly 0 at
    the self pair. q, src: ``X x 0 0``. Returns (P, 9)."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    sc = _w_grad_scale_press(kernel_set, r2, rl, pv, invrl) * okf
    g = (sc * dx, sc * dy, sc * dz)
    dc = (s[:, 3] - q[:, 3], s[:, 4] - q[:, 4], s[:, 5] - q[:, 5])
    return torch.stack([dc[a] * g[b] for a in range(3) for b in range(3)],
                       dim=1)


def elastic_force_pair(q, s, pv, *, kernel_set):
    """Variational elastic force (P_iC_iᵀ + P_jC_jᵀ)·∇W(X_ij), pairwise
    antisymmetric; V² applies outside. q, src: ``X x PC F``. Returns
    (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    sc = _w_grad_scale_press(kernel_set, r2, rl, pv, invrl) * okf
    g = (sc * dx, sc * dy, sc * dz)
    outs = []
    for a in range(3):
        acc = None
        for b in range(3):
            k = ELASTIC_PC + 3 * a + b
            t = (q[:, k] + s[:, k]) * g[b]
            acc = t if acc is None else acc + t
        outs.append(acc)
    return torch.stack(outs, dim=1)


def elastic_hourglass_pair(q, s, pv, *, kernel_set):
    """Ganzenmüller hourglass control without its α·V² prefactor:
    +½·W(X_ij)/|X_ij|²·(δ_i + δ_j)·x̂_ij with δ_k = (F_k X_ij − x_ij)·x̂_ij,
    so f = +kδx̂ (a stretched pair attracts). The mask (r² < h², r² > 0)
    multiplies W/|X|² before anything large meets it, so the self pair
    is exactly 0; the division is exact. q, src: ``X x PC F``. Returns
    (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    rl, invrl = _rl_invrl(r2)
    okf = ((r2 < pv[PV_H2]) & (r2 > 0)).to(q.dtype)
    w = _w_value(kernel_set, r2, rl, pv)
    inv_x2 = okf * w * (1.0 / torch.clamp(r2, min=_EPS * _EPS))
    dc = (q[:, 3] - s[:, 3], q[:, 4] - s[:, 4], q[:, 5] - s[:, 5])
    rc2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]
    invrc = torch.rsqrt(torch.clamp(rc2, min=_EPS * _EPS))
    dX = (dx, dy, dz)
    raw = None
    for a in range(3):
        k = ELASTIC_F + 3 * a
        fi = q[:, k] * dX[0] + q[:, k + 1] * dX[1] + q[:, k + 2] * dX[2]
        fj = s[:, k] * dX[0] + s[:, k + 1] * dX[1] + s[:, k + 2] * dX[2]
        t = (fi + fj - 2.0 * dc[a]) * dc[a]
        raw = t if raw is None else raw + t
    coef = 0.5 * inv_x2 * raw * (invrc * invrc)
    return torch.stack([coef * dc[0], coef * dc[1], coef * dc[2]], dim=1)


def elastic_force_hourglass_pair(q, s, pv, *, kernel_set):
    """The fused force + hourglass pair: (P, 6), the elastic force then the
    hourglass force, each unscaled (the caller applies V² and α·V²)."""
    return torch.cat([elastic_force_pair(q, s, pv, kernel_set=kernel_set),
                      elastic_hourglass_pair(q, s, pv,
                                             kernel_set=kernel_set)], dim=1)


def fluid_reaction_pair(q, s, pv, *, kernel_set, include_pressure=True):
    """Reverse Akinci contact: the force ON a body sample (query) FROM a
    fluid particle (source), the per-sample reaction of the body contact
    (``boundary_force_pair`` with ``moving=True, include_adhesion=False,
    pressure_sign=-1, consistent_pressure=True``) with the roles swapped:
    friction ν·max((v_b − v_i)·d, 0)·ψ·∇W with ν in the fluid density, and
    −m·ψ·max(pd2_i, 0)·∇W with pd2_i from the Tait EOS of the source
    density (dropped with ``include_pressure=False``: the DFSPH elastic
    coupling's non-pressure stage, where the stiffness solve pushes).
    q: ``x y z v_b ψ 0``; src (fluid rows): ``x y z v ρ 0``. Returns
    (P, 3)."""
    dx, dy, dz, r2 = _geometry(q, s)
    if kernel_set == KernelSet.MULLER:
        rl = invrl = None
    else:
        rl, invrl = _rl_invrl(r2)
    okf = (r2 < pv[PV_H2]).to(q.dtype)
    psi = q[:, 6]
    dens_i = torch.clamp(s[:, 6], min=_EPS)
    inv_dens = 1.0 / dens_i
    sd = _w_grad_scale_default(kernel_set, r2, rl, pv, invrl)
    nu = ((2.0 * pv[PV_PM] * pv[PV_PM] * pv[PV_VISC] * pv[PV_VISC]
           * pv[PV_H] * pv[PV_CS]) / (1.0 + 0.01 * pv[PV_H2])) \
        * (inv_dens * inv_dens)
    vdotr = ((q[:, 3] - s[:, 3]) * dx + (q[:, 4] - s[:, 4]) * dy
             + (q[:, 5] - s[:, 5]) * dz)
    cfric = nu * torch.clamp(vdotr, min=0.0) * psi * sd
    if not include_pressure:
        c = cfric * okf
        return torch.stack([c * dx, c * dy, c * dz], dim=1)
    ratio = dens_i * (1.0 / pv[PV_RD])
    ratio2 = ratio * ratio
    p_i = torch.clamp(pv[PV_K] * (ratio2 * ratio2 * ratio2 * ratio - 1.0),
                      min=0.0)
    pd2_i = p_i * inv_dens * inv_dens
    c = (cfric - pv[PV_PM] * psi * pd2_i * sd) * okf
    return torch.stack([c * dx, c * dy, c * dz], dim=1)


# ---------------------------------------------------------------------------
# Plain sweeps and the dispatchers
# ---------------------------------------------------------------------------

def density_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """ρ_i = Σ_j ψ_j W(r_ij) over the fluid rows and (18 rows) the
    boundary rows, self term included: q (N, 4), src (M, 4) ``x y z ψ``.
    Returns (N,)."""
    def pair(qq, ss):
        return density_pair(qq, ss, pvec, kernel_set=cfg.kernel_set)
    return neighbor_sweep_plain(pair, q, src, seg_start, seg_end, 1,
                                pair_fn_b=pair)[:, 0]


def fluid_force_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                            pvec, include_pressure=True,
                            include_viscosity=True, moving_boundary=False):
    """WCSPH forces: fluid pairs on rows 0-8, wall pairs on rows 9-17:
    q (N, 8) ``x y z v ρ pd2``, src (M, 8) fluid rows as the queries (pd2_j
    in slot 7), wall rows ``x y z v_b ψ_b 0``;
    ``include_pressure=False`` drops both pressure terms,
    ``include_viscosity=False`` the viscosity and the wall friction,
    ``moving_boundary=True`` makes the friction read the wall velocities
    of source slots 3-5. Returns (N, 3)."""
    def pair(qq, ss):
        return fluid_force_pair(qq, ss, pvec, kernel_set=cfg.kernel_set,
                                st_model=cfg.surface_tension_model,
                                include_pressure=include_pressure,
                                include_viscosity=include_viscosity)

    def pair_b(qq, ss):
        return boundary_force_pair(qq, ss, pvec, kernel_set=cfg.kernel_set,
                                   include_pressure=include_pressure,
                                   include_friction=include_viscosity,
                                   moving=moving_boundary)
    return neighbor_sweep_plain(pair, q, src, seg_start, seg_end, 3,
                                pair_fn_b=pair_b)


def _bind(pair_fn, cfg, pvec, **kw):
    def pair(qq, ss):
        return pair_fn(qq, ss, pvec, kernel_set=cfg.kernel_set, **kw)
    return pair


def dii_rhoadv_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                           pvec):
    """(d_ii xyz, Δρ_adv) (N, 4): q (N, 12), src (M, 8) with ψ in slot 6
    and v_adv in the fluid rows' velocity slots."""
    return neighbor_sweep_plain(
        _bind(dii_rhoadv_pair, cfg, pvec, vel_q_offset=3), q, src,
        seg_start, seg_end, 4,
        pair_fn_b=_bind(dii_rhoadv_pair, cfg, pvec, vel_q_offset=6))


def aii_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """a_ii (N,): q (N, 8), src (M, 8) with ψ in slot 6."""
    pair = _bind(aii_pair, cfg, pvec)
    return neighbor_sweep_plain(pair, q, src, seg_start, seg_end, 1,
                                pair_fn_b=pair)[:, 0]


def dii_aii_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """(d_ii xyz, Δρ_adv, a_ii) (N, 5), each column a contiguous plane, in
    the reference's order: :func:`dii_rhoadv_sweep_plain`, then
    :func:`aii_sweep_plain` on its d_ii, as the JAX step runs the two
    sweeps. src (M, 12), fluid rows ``x y z v_adv m v 1/ρ² 0`` (ψ = m in
    slot 6), then the wall rows ``x y z v_b ψ_b 0…``; q (N, 12) its first
    N rows."""
    n = q.shape[0]
    z2 = q.new_zeros((n, 2))
    # the two sweeps' own layouts: q x y z v_adv v 1/ρ² 0 0, src slots 0-7
    pr = dii_rhoadv_sweep_plain(
        cfg, torch.cat([q[:, :6], q[:, 7:11], z2], dim=1), src[:, :8],
        seg_start, seg_end, pvec)
    dpi = pvec[PV_PM] * q[:, 10]
    aii = aii_sweep_plain(
        cfg, torch.cat([q[:, :3], pr[:, :3], dpi[:, None], z2[:, :1]],
                       dim=1), src[:, :8], seg_start, seg_end, pvec)
    return torch.stack([*pr.unbind(1), aii]).t()


def sum_dij_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Σd_ij·p_j (N, 3) over the fluid rows only: ranges (9, N), q (N, 4)
    and src (M, 4) ``x y z p/ρ²`` (the step's one matrix)."""
    return neighbor_sweep_plain(_bind(sum_dij_pair, cfg, pvec), q, src,
                                seg_start, seg_end, 3)


def jacobi_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Jacobi off-diagonal sum (N,): q (N, 8), src (M, 8), fluid rows
    ``x y z e 0 0``, boundary rows ``x y z v_b ψ_b 0``."""
    return neighbor_sweep_plain(
        _bind(jacobi_fluid_pair, cfg, pvec), q, src, seg_start, seg_end, 1,
        pair_fn_b=_bind(jacobi_boundary_pair, cfg, pvec))[:, 0]


def pressure_force_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                               pvec, plan=None):
    """Implicit-solver pressure force (N, 3): q (N, 4) x y z pd2, src
    (M, 8) with pd2_j (fluid) / ψ_b (boundary) in slot 6; the boundary
    term repels (``boundary_sign=-1``). ``plan``, the CUDA kernel's tile
    plan, is not read."""
    return neighbor_sweep_plain(
        _bind(grad_pressure_force_pair, cfg, pvec, boundary=False), q, src,
        seg_start, seg_end, 3,
        pair_fn_b=_bind(grad_pressure_force_pair, cfg, pvec, boundary=True,
                        boundary_sign=-1.0))


def alpha_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """(Σψ∇W xyz, Σ|ψ∇W|²) (N, 4): q (N, 4), src (M, 4) ``x y z ψ``; the
    square sum over the fluid rows only (on 9 range rows, a shell's
    ``x y z ψ_b`` as the source: α's fluid form over the shell)."""
    return neighbor_sweep_plain(
        _bind(alpha_pair, cfg, pvec, include_sq=True), q, src, seg_start,
        seg_end, 4, pair_fn_b=_bind(alpha_pair, cfg, pvec, include_sq=False))


ALPHA_EPS = 1e-6    # α's denominator floor (dfsph_pallas.py's _EPS_DENOM)


def alpha_of(sums):
    """(ρ, α) (N, 2) from (ρ, Σψ∇W xyz, Σ|ψ∇W|²) (N, 5), in the JAX step's
    order: α = ρ / max(|Σψ∇W|² + Σ|ψ∇W|², ε); the fused kernel's epilogue.
    The columns are contiguous (N,) planes, as the kernel writes them."""
    dens = sums[:, 0]
    denom = (sums[:, 1] * sums[:, 1] + sums[:, 2] * sums[:, 2]
             + sums[:, 3] * sums[:, 3] + sums[:, 4])
    return torch.stack([dens, dens / torch.clamp(denom, min=ALPHA_EPS)]).t()


def density_alpha_sums_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                   seg_end, pvec):
    """ρ and α's sums (ρ, Σψ∇W xyz, Σ|ψ∇W|²) (N, 5), each column a
    contiguous plane: :func:`density_sweep_plain` and
    :func:`alpha_sweep_plain` on the density's operands, src (M, 4)
    ``x y z ψ`` (fluid ψ = m, walls ψ_b), q (N, 4)."""
    dens = density_sweep_plain(cfg, q, src, seg_start, seg_end, pvec)
    al = alpha_sweep_plain(cfg, q, src, seg_start, seg_end, pvec)
    return torch.cat([dens[None], al.t()]).t()


def density_alpha_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                              pvec):
    """DFSPH's (ρ, α) (N, 2), each column a contiguous plane:
    :func:`alpha_of` of :func:`density_alpha_sums_sweep_plain`."""
    return alpha_of(density_alpha_sums_sweep_plain(cfg, q, src, seg_start,
                                                   seg_end, pvec))


def drho_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Dρ/Dt (N,): q (N, 8) x y z v pad pad, src (M, 8) with the fluid
    velocities and ψ in slot 6."""
    pair = _bind(drho_pair, cfg, pvec)
    return neighbor_sweep_plain(pair, q, src, seg_start, seg_end, 1,
                                pair_fn_b=pair)[:, 0]


def multiphase_density_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                   seg_end, pvec):
    """(δ = ΣW, Σψ_b·W) (N, 2): q (N, 4), src (M, 4) fluid rows
    ``x y z s`` (s not read), boundary rows ``x y z ψ_b``."""
    return neighbor_sweep_plain(
        _bind(multiphase_density_pair, cfg, pvec), q, src, seg_start,
        seg_end, 2, pair_fn_b=_bind(multiphase_density_bpair, cfg, pvec))


def _st_becker(cfg: SimConfig) -> bool:
    """The multiphase force sweep's surface-tension switch: NONE or
    BECKER; AKINCI has no per-phase meaning and raises."""
    if cfg.surface_tension_model == SurfaceTensionModel.AKINCI:
        raise ValueError("the multiphase force sweep takes surface tension "
                         "NONE or BECKER, not AKINCI")
    return cfg.surface_tension_model == SurfaceTensionModel.BECKER


def multiphase_force_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                                 pvec, moving_boundary=False):
    """Multiphase acceleration (N, 3): q (N, 12), wide src (M, 12) (the
    layout of :func:`multiphase_force_pair`; on the step's path one matrix,
    the queries its first rows); ``moving_boundary=True`` makes the wall
    friction read the wall velocities of source slots 3-5."""
    return neighbor_sweep_plain(
        _bind(multiphase_force_pair, cfg, pvec, st_becker=_st_becker(cfg)),
        q, src, seg_start, seg_end, 3,
        pair_fn_b=_bind(multiphase_boundary_pair, cfg, pvec,
                        moving=moving_boundary))


def body_force_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                           include_pressure=True):
    """Rigid-body contact force (N, 3) on the fluid from one body shell:
    :func:`boundary_force_pair` in its body form over the body source
    alone (9 range rows); ``include_pressure=False`` the friction alone
    (the DFSPH couplings). q (N, 8) ``x y z v ρ pd2``, src (Mb, 8)
    ``x y z v_b ψ_b 0``."""
    return neighbor_sweep_plain(
        _bind(boundary_force_pair, cfg, pvec,
              include_pressure=include_pressure, moving=True,
              include_adhesion=False, pressure_sign=-1.0,
              consistent_pressure=True), q, src, seg_start, seg_end, 3)


def boundary_force_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                               pvec, include_pressure=True):
    """The wall-only force (N, 3) (``pallas_sph.boundary_force_sweep``):
    :func:`boundary_force_pair` at its defaults (static wall, adhesion,
    friction, the reference-scale pressure; ``include_pressure=False``
    drops the pressure) over the wall rows alone: q (N, 8) ``x y z v ρ
    pd2``, src (M, 8) ``x y z 0 0 0 ψ_b 0``, ranges (9, N) into src. Equals
    the fused force sweep's rows 9-17."""
    return neighbor_sweep_plain(
        _bind(boundary_force_pair, cfg, pvec,
              include_pressure=include_pressure), q, src, seg_start,
        seg_end, 3)


def multiphase_body_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                                pvec):
    """Multiphase rigid-body contact acceleration (N, 3) from one body
    shell (9 range rows): q (N, 8) ``x y z v bp fr``, src (Mb, 8)
    ``x y z v_b ψ_b 0``."""
    return neighbor_sweep_plain(_bind(multiphase_body_pair, cfg, pvec), q,
                                src, seg_start, seg_end, 3)


def xsph_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """XSPH sum (N, 3) over the fluid rows only: ranges (9, N), q (N, 8),
    src (M, 8) with the new velocities and ρ in slot 6."""
    return neighbor_sweep_plain(_bind(xsph_pair, cfg, pvec), q, src,
                                seg_start, seg_end, 3)


def visc_laplacian_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                              pvec, plan=None):
    """Viscous Laplacian L(v) (N, 3): q (N, 8) x y z v ρ pad, src (M, 8)
    with the velocities and m/ρ_j (fluid) / ψ_b (boundary) in slot 6.
    ``plan``, the CUDA kernel's tile plan, is not read."""
    return neighbor_sweep_plain(
        _bind(visc_laplacian_pair, cfg, pvec, boundary=False), q, src,
        seg_start, seg_end, 3,
        pair_fn_b=_bind(visc_laplacian_pair, cfg, pvec, boundary=True))


def multiphase_alpha_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                 seg_end, pvec):
    """(G, S, B) (N, 7): q (N, 4), src (M, 4) fluid rows ``x y z 1/m_j``,
    boundary rows ``x y z ψ_b``."""
    return neighbor_sweep_plain(
        _bind(multiphase_alpha_pair, cfg, pvec), q, src, seg_start, seg_end,
        7, pair_fn_b=_bind(multiphase_alpha_bpair, cfg, pvec))


def multiphase_density_alpha_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                         seg_end, pvec):
    """Multiphase DFSPH's density and α̂ sums (N, 9), each column a
    contiguous plane: (δ = ΣW, Σψ_b·W) of
    :func:`multiphase_density_sweep_plain`, then (G, S, B) of
    :func:`multiphase_alpha_sweep_plain`, on the one matrix both read: src
    (M, 4) fluid rows ``x y z 1/m_j``, boundary rows ``x y z ψ_b``,
    q (N, 4)."""
    dout = multiphase_density_sweep_plain(cfg, q, src, seg_start, seg_end,
                                          pvec)
    al = multiphase_alpha_sweep_plain(cfg, q, src, seg_start, seg_end, pvec)
    return torch.cat([dout.t(), al.t()]).t()


def multiphase_drho_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                                pvec):
    """dδ̂/dt (N,) = Σ(v_i − v_j)·∇W + (s_i/m_i)·Σψ_b(v_i − v_b)·∇W, the
    wall sum scaled by query slot 6 (``dfsph_pallas.py``'s
    ``d[:, 0] + sm * d[:, 1]``): q (N, 8) ``x y z v s/m``, src (M, 8) with
    the velocities, ψ_b in the boundary rows' slot 6."""
    d = neighbor_sweep_plain(
        _bind(multiphase_drho_pair, cfg, pvec), q, src, seg_start, seg_end,
        2, pair_fn_b=_bind(multiphase_drho_bpair, cfg, pvec))
    return d[:, 0] + q[:, 6] * d[:, 1]


def multiphase_kappa_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                 seg_end, pvec):
    """Multiphase stiffness correction (N, 3): q (N, 8) x y z κV̂² qc,
    src (M, 4) fluid rows ``x y z κV̂²_j``, boundary rows ``x y z ψ_b``."""
    return neighbor_sweep_plain(
        _bind(multiphase_kappa_pair, cfg, pvec), q, src, seg_start, seg_end,
        3, pair_fn_b=_bind(multiphase_kappa_bpair, cfg, pvec))


def pbf_grad_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """The λ sums (ρ, Σψ∇W xyz, Σ|ψ∇W|²) (N, 5): q (N, 4), src (M, 4)
    ``x y z ψ``; the walls (18 range rows, ψ_b) add to ρ and Σψ∇W, not to
    the square sum. On 9 range rows, one (N, 4) matrix as q and src:
    vorticity confinement's N (the CUDA kernel takes 9 rows only)."""
    return neighbor_sweep_plain(
        _bind(pbf_lambda_pair, cfg, pvec, include_sq=True), q, src,
        seg_start, seg_end, 5,
        pair_fn_b=_bind(pbf_lambda_pair, cfg, pvec, include_sq=False))


def pbf_lambda_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                           pvec):
    """PBF (ρ, λ) (N, 2), each column a contiguous plane:
    :func:`pbf_lambda_of` of the λ sums (:func:`pbf_grad_sweep_plain`)
    with ψ = m (``PV_PM``) on the fluid rows; q (N, 4), src (M, 4) whose
    first N rows are the queries (their slot 3 unread), then the boundary
    rows ``x y z ψ_b``."""
    n = q.shape[0]
    fluid = torch.cat([src[:n, :3], pvec[PV_PM].expand(n, 1)], dim=1)
    return pbf_lambda_of(pbf_grad_sweep_plain(
        cfg, q, torch.cat([fluid, src[n:]]), seg_start, seg_end, pvec),
        pvec)


def pbf_dp_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """PBF Δp·ρ₀ (N, 3): q (N, 4) ``x y z λ_i``, src (M, 4) fluid rows
    ``x y z λ_j``, boundary rows ``x y z ψ_b``."""
    return neighbor_sweep_plain(
        _bind(pbf_dp_pair, cfg, pvec, boundary=False), q, src, seg_start,
        seg_end, 3, pair_fn_b=_bind(pbf_dp_pair, cfg, pvec, boundary=True))


def pbf_omega_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """PBF vorticity ω (N, 3) over the fluid rows only: ranges (9, N),
    q (N, 8), src (M, 8) ``x y z v m/ρ 0``."""
    return neighbor_sweep_plain(_bind(pbf_omega_pair, cfg, pvec), q, src,
                                seg_start, seg_end, 3)


def elastic_f_sweep_plain(cfg: SimConfig, q, src, nbr_start, nbr, pvec):
    """Σ_j (x_j − x_i) ⊗ ∇W(X_ij) (N, 9) over a body's static pair list
    (``ElasticStatics.nbr_start``, ``nbr``: the pairs of its reference
    ranges within h): q and src the same (N, 8) ``X x 0 0`` rows."""
    return list_sweep_plain(_bind(elastic_f_pair, cfg, pvec), q, src,
                            nbr_start, nbr, 9)


def elastic_force_hourglass_sweep_plain(cfg: SimConfig, q, src, nbr_start,
                                        nbr, pvec):
    """(f_el xyz, f_hg xyz) (N, 6), both unscaled, over a body's static
    pair list (``ElasticStatics.nbr_start``, ``nbr``: the pairs of its
    reference ranges within h): q and src the same (N, 24) ``X x PC F``
    rows."""
    return list_sweep_plain(_bind(elastic_force_hourglass_pair, cfg, pvec),
                            q, src, nbr_start, nbr, 6)


def fluid_reaction_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end,
                               pvec, include_pressure=True):
    """The fluid's force on each body sample (Mb, 3): q (Mb, 8) ``x y z v_b
    ψ 0``, src the fluid rows (C, 8) ``x y z v ρ 0``, the samples' ranges
    over the fluid's sorted hashes (9 rows); ``include_pressure=False`` the
    friction alone."""
    return neighbor_sweep_plain(
        _bind(fluid_reaction_pair, cfg, pvec,
              include_pressure=include_pressure), q, src, seg_start, seg_end,
        3)


# The body forms of the DFSPH sweeps: a pair function's boundary formula
# over a source of boundary samples alone, on 9 range rows (a body shell
# as the source, or a body's samples as the queries against the fluid rows)

def pressure_force_body_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                    seg_end, pvec):
    """The κ impulse (N, 3) of a body shell alone:
    ``grad_pressure_force_pair(boundary=True, boundary_sign=-1)``,
    −m·ψ_b·(κ_i/ρ_i)·∇W; q (N, 4) ``x y z κ/ρ``, the shell (Mb, 8) with ψ_b
    in slot 6. With the roles swapped (q (Mb, 4) ``x y z ψ_b``, the fluid
    rows with κ/ρ in slot 6) the same formula is the per-sample reaction,
    exactly antisymmetric to the forward pair force."""
    return neighbor_sweep_plain(
        _bind(grad_pressure_force_pair, cfg, pvec, boundary=True,
              boundary_sign=-1.0), q, src, seg_start, seg_end, 3)


def alpha_body_sweep_plain(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Σψ_b∇W (N, 4) of a body shell alone, column 3 zero
    (``alpha_pair(include_sq=False)``): q (N, 4), the shell (Mb, 4)
    ``x y z ψ_b``."""
    return neighbor_sweep_plain(
        _bind(alpha_pair, cfg, pvec, include_sq=False), q, src, seg_start,
        seg_end, 4)


def body_density_alpha_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                    seg_end, pvec, include_sq=False):
    """A body shell's Σψ_b·W and α's shell sums Σψ_b∇W (N, 4), each column
    a contiguous plane: :func:`density_sweep_plain` and
    :func:`alpha_body_sweep_plain` (``alpha_pair(include_sq=False)``) on the
    shell's (Mb, 4) ``x y z ψ_b``, q (N, 4), ranges (9, N);
    ``include_sq=True`` :func:`alpha_sweep_plain` instead
    (``alpha_pair(include_sq=True)``, α's fluid form over the shell), its
    Σ|ψ_b∇W|² a fifth column."""
    dens = density_sweep_plain(cfg, q, src, seg_start, seg_end, pvec)
    sweep = alpha_sweep_plain if include_sq else alpha_body_sweep_plain
    al = sweep(cfg, q, src, seg_start, seg_end, pvec)
    return torch.cat([dens[None], al.t()[:4 if include_sq else 3]]).t()


def multiphase_alpha_body_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                      seg_end, pvec):
    """Σψ_b∇W of a body shell alone into columns 4-6 of (N, 7)
    (``multiphase_alpha_bpair``): q (N, 4), the shell (Mb, 4)
    ``x y z ψ_b``."""
    return neighbor_sweep_plain(_bind(multiphase_alpha_bpair, cfg, pvec), q,
                                src, seg_start, seg_end, 7)


def multiphase_drho_body_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                     seg_end, pvec):
    """Σψ_b(v_i − v_b)·∇W of a body shell alone into column 1 of (N, 2)
    (``multiphase_drho_bpair``): q (N, 8), the shell (Mb, 8) with its
    sample velocities."""
    return neighbor_sweep_plain(_bind(multiphase_drho_bpair, cfg, pvec), q,
                                src, seg_start, seg_end, 2)


def multiphase_kappa_body_sweep_plain(cfg: SimConfig, q, src, seg_start,
                                      seg_end, pvec):
    """qc_i·Σψ_b∇W (N, 3) of a body shell alone (``multiphase_kappa_bpair``):
    q (N, 8) ``x y z κV̂² qc``, the shell (Mb, 4) ``x y z ψ_b``."""
    return neighbor_sweep_plain(_bind(multiphase_kappa_bpair, cfg, pvec), q,
                                src, seg_start, seg_end, 3)


def _route(*tensors) -> str:
    """The sweep route: "plain" for CPU float32/float64 tensors, "cuda"
    for CUDA float32 ones; raises on anything else, or on mixed devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"sweep inputs on several devices: {devs}")
    dev = devs.pop()
    dtype = tensors[0].dtype
    if dev.type == "cpu" and dtype in (torch.float32, torch.float64):
        return "plain"
    if dev.type == "cuda" and dtype == torch.float32:
        return "cuda"
    raise TypeError(f"no sweep for {dtype} tensors on {dev}: CPU takes "
                    "float32/float64, CUDA takes float32")


def dispatch(tensors, plain, kernel_name, *args, **kw):
    """``plain(*args, **kw)`` when ``tensors`` lie on the CPU, the CUDA
    kernel's wrapper ``cuda_sweep.<kernel_name>(*args, **kw)`` when they
    lie on the card; raises as :func:`_route` on anything else."""
    if _route(*tensors) == "plain":
        return plain(*args, **kw)
    from . import cuda_sweep
    return getattr(cuda_sweep, kernel_name)(*args, **kw)


def _dispatcher(plain, kernel_name, name=None):
    """The sweep ``name`` (default: ``plain``'s name without ``_plain``),
    routed by device (:func:`dispatch`): ``plain`` for CPU tensors, the
    CUDA kernel ``cuda_sweep.<kernel_name>`` for GPU ones; keyword switches
    (``include_pressure``, ``include_viscosity``, ``moving_boundary``, a
    tiled kernel's ``plan``) go to both."""
    def sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec, **kw):
        return dispatch((q, src, pvec, seg_start), plain, kernel_name, cfg,
                        q, src, seg_start, seg_end, pvec, **kw)
    sweep.__name__ = name or plain.__name__.removesuffix("_plain")
    sweep.__doc__ = (f"``{plain.__name__}`` on CPU tensors, the CUDA kernel "
                     f"``cuda_sweep.{kernel_name}`` on GPU ones.")
    return sweep


density_sweep = _dispatcher(density_sweep_plain, "density_sweep")
fluid_force_sweep = _dispatcher(fluid_force_sweep_plain, "force_sweep")
dii_aii_sweep = _dispatcher(dii_aii_sweep_plain, "dii_aii_sweep")
sum_dij_sweep = _dispatcher(sum_dij_sweep_plain, "sum_dij_sweep")
jacobi_sweep = _dispatcher(jacobi_sweep_plain, "jacobi_sweep")
pressure_force_sweep = _dispatcher(pressure_force_sweep_plain,
                                   "pressure_force_sweep")
density_alpha_sweep = _dispatcher(density_alpha_sweep_plain,
                                  "density_alpha_sweep")
density_alpha_sums_sweep = _dispatcher(density_alpha_sums_sweep_plain,
                                       "density_alpha_sums_sweep")
drho_sweep = _dispatcher(drho_sweep_plain, "drho_sweep")
# PCISPH's predicted density ρ* at x*: the density sweep on the x* query
# and source rows over the start-of-step ranges (``density_pair`` with
# ``geom_offset=3`` on the TPU), its launches counted apart
predicted_density_sweep = _dispatcher(density_sweep_plain,
                                      "predicted_density_sweep",
                                      name="predicted_density_sweep")
multiphase_density_sweep = _dispatcher(multiphase_density_sweep_plain,
                                       "multiphase_density_sweep")
multiphase_force_sweep = _dispatcher(multiphase_force_sweep_plain,
                                     "multiphase_force_sweep")
# a body shell's ψ-density Σψ_b·W: the density sweep over the body source
# alone (9 range rows), its launches counted apart
body_density_sweep = _dispatcher(density_sweep_plain, "body_density_sweep",
                                 name="body_density_sweep")
body_force_sweep = _dispatcher(body_force_sweep_plain, "body_force_sweep")
boundary_force_sweep = _dispatcher(boundary_force_sweep_plain,
                                   "boundary_force_sweep")
multiphase_body_sweep = _dispatcher(multiphase_body_sweep_plain,
                                    "multiphase_body_sweep")
xsph_sweep = _dispatcher(xsph_sweep_plain, "xsph_sweep")
visc_laplacian_sweep = _dispatcher(visc_laplacian_sweep_plain,
                                   "visc_laplacian_sweep")
multiphase_density_alpha_sweep = _dispatcher(
    multiphase_density_alpha_sweep_plain, "multiphase_density_alpha_sweep")
multiphase_drho_sweep = _dispatcher(multiphase_drho_sweep_plain,
                                    "multiphase_drho_sweep")
multiphase_kappa_sweep = _dispatcher(multiphase_kappa_sweep_plain,
                                     "multiphase_kappa_sweep")
pbf_lambda_sweep = _dispatcher(pbf_lambda_sweep_plain, "pbf_lambda_sweep")
pbf_dp_sweep = _dispatcher(pbf_dp_sweep_plain, "pbf_dp_sweep")
pbf_omega_sweep = _dispatcher(pbf_omega_sweep_plain, "pbf_omega_sweep")
pbf_grad_sweep = _dispatcher(pbf_grad_sweep_plain, "pbf_grad_sweep")
elastic_f_sweep = _dispatcher(elastic_f_sweep_plain, "elastic_f_sweep")
elastic_force_hourglass_sweep = _dispatcher(
    elastic_force_hourglass_sweep_plain, "elastic_force_hourglass_sweep")
fluid_reaction_sweep = _dispatcher(fluid_reaction_sweep_plain,
                                   "fluid_reaction_sweep")
pressure_force_body_sweep = _dispatcher(pressure_force_body_sweep_plain,
                                        "pressure_force_body_sweep")
# the reverse κ impulse (a body's samples as queries against the fluid
# rows): the same formula and plain sweep, its kernel counted apart
pressure_force_body_rev_sweep = _dispatcher(
    pressure_force_body_sweep_plain, "pressure_force_body_rev_sweep",
    name="pressure_force_body_rev_sweep")
body_density_alpha_sweep = _dispatcher(body_density_alpha_sweep_plain,
                                       "body_density_alpha_sweep")
# Drho as it is over a body shell's 9 range rows (the shell's sample
# velocities), counted apart
drho_shell_sweep = _dispatcher(drho_sweep_plain, "drho_shell_sweep",
                               name="drho_shell_sweep")
multiphase_alpha_body_sweep = _dispatcher(multiphase_alpha_body_sweep_plain,
                                          "multiphase_alpha_body_sweep")
multiphase_drho_body_sweep = _dispatcher(multiphase_drho_body_sweep_plain,
                                         "multiphase_drho_body_sweep")
multiphase_kappa_body_sweep = _dispatcher(multiphase_kappa_body_sweep_plain,
                                          "multiphase_kappa_body_sweep")
