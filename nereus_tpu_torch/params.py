"""Simulation parameters (PyTorch port of ``nereus_tpu.params``).

* :class:`SimConfig` — static switches: kernel set, surface-tension model,
  dtype and the solver caps. The physics fields keep the JAX package's
  names and defaults, so one dict of fields builds both configs
  (``convert.config_from_jax_fields``). The Mosaic tuning knobs and the
  segment-engine windows have no meaning here: the CUDA sweeps walk exact
  cell ranges, so there is no window to size.
* :class:`SimParams` — a frozen dataclass of 0-d (gravity: (3,)) tensors.
  The smoothing-kernel normalisations are computed in float64 on the host
  and then cast, as the reference does at construction
  (``sph/sph.cpp:73-86``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Tuple

import numpy as np
import torch


class KernelSet(enum.Enum):
    """Smoothing-kernel family switch (reference: ``common/common.h:14-15``)."""

    MONAGHAN = 0
    MULLER = 1


class SurfaceTensionModel(enum.Enum):
    """Which surface-tension formulation the force pass uses."""

    NONE = 0
    BECKER = 1
    AKINCI = 2


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: ``device``, or
    the CUDA device when it is None. There is no probe and no fallback: on
    a host without CUDA, building on the default raises as torch raises."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static switches; hashable. Field meanings as in ``nereus_tpu``."""

    kernel_set: KernelSet = KernelSet.MULLER
    surface_tension_model: SurfaceTensionModel = SurfaceTensionModel.BECKER
    dtype: torch.dtype = torch.float32
    iisph_min_iters: int = 2
    iisph_max_iters: int = 100
    pcisph_min_iters: int = 3
    pcisph_max_iters: int = 100
    pcisph_warm_start: bool = True
    pcisph_warm_frac: float = 0.5
    dfsph_min_iters: int = 2
    dfsph_max_iters: int = 100
    dfsph_min_iters_v: int = 1
    dfsph_max_iters_v: int = 100
    dfsph_warm_start: bool = True
    pbf_iters: int = 4
    pbf_scorr_k: float = 0.001
    pbf_scorr_dq: float = 0.2
    pbf_eps: float = 100.0
    dfsph_strong_coupling: bool = True
    # "explicit" (Müller viscous force) or "implicit" (Weiler 2018 CG
    # solve, single-phase WCSPH and DFSPH; solvers/viscosity.py)
    viscosity_model: str = "explicit"
    visc_cg_max_iters: int = 100
    visc_cg_tol: float = 1e-4
    st_cross: float = 0.0


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Physics parameters: field-for-field the JAX ``SimParams``
    (``common/sph_kernel.cuh:13-59`` minus the grid block)."""

    gas_stiffness: torch.Tensor
    rest_density: torch.Tensor
    particle_radius: torch.Tensor
    dt: torch.Tensor
    viscosity: torch.Tensor
    surface_tension: torch.Tensor
    gravity: torch.Tensor          # (3,)
    interaction_radius: torch.Tensor
    particle_mass: torch.Tensor
    beta: torch.Tensor
    sound_speed: torch.Tensor
    kpoly: torch.Tensor
    kpoly_grad: torch.Tensor
    kpress_grad: torch.Tensor
    kvisc_grad: torch.Tensor
    kvisc_denum: torch.Tensor
    ksurf1: torch.Tensor
    ksurf2: torch.Tensor
    bpol: torch.Tensor


def make_params(
    *,
    gas_stiffness: float = 800.0,
    rest_density: float = 1000.0,
    particle_radius: float = 0.02,
    dt: float = 1e-3,
    viscosity: float = 0.005,
    surface_tension: float = 0.01,
    gravity: Tuple[float, float, float] = (0.0, -9.81, 0.0),
    interaction_radius: float = 0.0457,
    particle_mass: float | None = None,
    mass_factor: float = 0.5,
    beta: float = 450.0,
    sound_speed: float | None = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> SimParams:
    """WCSPH defaults (``sph/sph.cpp:29-93``); constants in float64, then
    cast to ``dtype`` on ``device`` (default: the CUDA device)."""
    device = resolve_device(device)
    h = float(interaction_radius)
    if particle_mass is None:
        particle_mass = mass_factor * h**3 * rest_density
    if sound_speed is None:
        eta, height = 0.01, 0.1
        vf = math.sqrt(2.0 * 9.81 * height)
        sound_speed = vf / math.sqrt(eta)

    pi = math.pi
    consts = dict(
        kpoly=315.0 / (64.0 * pi * h**9),
        kpoly_grad=-945.0 / (32.0 * pi * h**9),
        kpress_grad=-45.0 / (pi * h**6),
        kvisc_grad=15.0 / (2.0 * pi * h**3),
        kvisc_denum=2.0 * h**3,
        ksurf1=32.0 / (pi * h**9),
        ksurf2=h**6 / 64.0,
        bpol=0.007 / h**3.25,
    )

    def s(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(
            dtype=dtype, device=device)

    return SimParams(
        gas_stiffness=s(gas_stiffness),
        rest_density=s(rest_density),
        particle_radius=s(particle_radius),
        dt=s(dt),
        viscosity=s(viscosity),
        surface_tension=s(surface_tension),
        gravity=s(gravity),
        interaction_radius=s(h),
        particle_mass=s(particle_mass),
        beta=s(beta),
        sound_speed=s(sound_speed),
        **{k: s(v) for k, v in consts.items()},
    )


def iisph_params(**overrides) -> SimParams:
    """IISPH default parameter set (``sph/iisph/iisph.cpp:37-80``)."""
    defaults = dict(
        viscosity=0.01,
        surface_tension=0.01,
        interaction_radius=0.0537,
        beta=1050.0,
        mass_factor=0.5,
    )
    defaults.update(overrides)
    return make_params(**defaults)


def dfsph_params(**overrides) -> SimParams:
    """DFSPH default parameter set: the IISPH physical parameters
    (``sph/iisph/iisph.cpp:37-80``), since DFSPH replaces only the
    pressure solve."""
    defaults = dict(
        viscosity=0.01,
        surface_tension=0.01,
        interaction_radius=0.0537,
        beta=1050.0,
        mass_factor=0.5,
    )
    defaults.update(overrides)
    return make_params(**defaults)


def pbf_params(**overrides) -> SimParams:
    """PBF default parameter set: the IISPH physical parameters
    (``sph/iisph/iisph.cpp:37-80``), since PBF replaces only the pressure
    projection. Calibrate the mass (:func:`calibrate_mass`): the density
    constraint C = ρ/ρ₀ − 1 means nothing on a lattice that does not sum
    to ρ₀."""
    defaults = dict(
        viscosity=0.01,
        surface_tension=0.01,
        interaction_radius=0.0537,
        beta=1050.0,
        mass_factor=0.5,
    )
    defaults.update(overrides)
    return make_params(**defaults)


def pcisph_params(**overrides) -> SimParams:
    """PCISPH default parameter set (``sph/pcisph/pcisph.cpp:37-80``); the
    reference's PCISPH mass has no 0.5 factor (``pcisph.cpp:49``), so wrap
    it in :func:`calibrate_mass` for a real corrective solve."""
    defaults = dict(
        viscosity=0.005,
        surface_tension=0.0001,
        interaction_radius=0.0537,
        beta=650.0,
        mass_factor=1.0,
    )
    defaults.update(overrides)
    return make_params(**defaults)


def prototype_lattice(params: SimParams, cfg: SimConfig, spacing: float):
    """(P, 3) float64 offsets of a cubic lattice of ``spacing`` within the
    kernel's support radius (h for Müller, 2h for Monaghan), origin
    included: a particle's filled neighborhood at rest."""
    h = float(params.interaction_radius)
    support = h if cfg.kernel_set == KernelSet.MULLER else 2.0 * h
    k = int(math.ceil(support / spacing)) + 1
    ax = np.arange(-k, k + 1) * spacing
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
    return pts[np.sum(pts * pts, axis=-1) <= support * support]


def calibrate_mass(params: SimParams, cfg: SimConfig,
                   spacing: float | None = None) -> SimParams:
    """Return params with the mass set so a rest lattice sums to ρ₀:
    m = ρ₀ / Σ_k W(r_k) over a cubic lattice of the given spacing (default
    one particle diameter), self term included.

    The sum is taken as the JAX package takes it: W evaluated in the
    params' dtype, then summed by numpy in that dtype (pairwise), so the
    mass agrees to the last bit."""
    from . import kernels as K  # local import to avoid a cycle

    if spacing is None:
        spacing = 2.0 * float(params.particle_radius)
    pts = prototype_lattice(params, cfg, spacing)
    cpu = {f.name: getattr(params, f.name).cpu()
           for f in dataclasses.fields(params)}
    w = K.w_value(cfg.kernel_set,
                  torch.as_tensor(pts).to(params.kpoly.dtype),
                  SimParams(**cpu))
    w_sum = float(np.sum(w.numpy()))
    m = float(params.rest_density) / w_sum
    return dataclasses.replace(
        params, particle_mass=torch.as_tensor(m, dtype=torch.float64).to(
            dtype=params.particle_mass.dtype,
            device=params.particle_mass.device))
