"""Carry parameters, configuration and state across from the JAX package.

Everything crosses as numpy arrays (or plain attribute values), so this
module imports neither JAX nor ``nereus_tpu``: a caller turns a JAX
object into numpy (``np.asarray``) and hands it over. With these a test
gives both packages identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .grid import Grid, make_grid
from .params import (KernelSet, SimConfig, SimParams, SurfaceTensionModel,
                     resolve_device)
from .rigid import RigidBody
from .solvers.elastic import (ElasticParams, ElasticState, ElasticStatics,
                              static_ranges)
from .state import BoundaryData, FluidState

_ENUMS = {"kernel_set": KernelSet,
          "surface_tension_model": SurfaceTensionModel}
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _t(a, dtype=None, device=None):
    t = torch.from_numpy(np.array(a))
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def params_from_numpy(arrays: dict, device=None) -> SimParams:
    """SimParams from ``{field: numpy array}`` (every SimParams field), in
    the arrays' own dtype. Every converter builds on ``device``, by default
    the CUDA device."""
    return SimParams(**{f.name: _t(arrays[f.name], device=device)
                        for f in dataclasses.fields(SimParams)})


def config_from_jax_fields(src) -> SimConfig:
    """SimConfig from the shared physics fields of ``src``, a JAX
    ``SimConfig``. Enums cross by name and the dtype by its name; the
    JAX-only engine fields are ignored."""
    kw = {}
    for f in dataclasses.fields(SimConfig):
        v = getattr(src, f.name)
        if f.name in _ENUMS:
            v = _ENUMS[f.name][v.name if hasattr(v, "name") else v]
        elif f.name == "dtype":
            v = _DTYPES[str(np.dtype(v))]
        kw[f.name] = v
    return SimConfig(**kw)


def state_from_numpy(pos, vel, pressure, num_active, mass=None, rho0=None,
                     device=None) -> FluidState:
    """FluidState from numpy arrays, dtypes kept (num_active: int32)."""
    return FluidState(
        pos=_t(pos, device=device), vel=_t(vel, device=device),
        pressure=_t(pressure, device=device),
        num_active=_t(num_active, torch.int32, device=device),
        mass=None if mass is None else _t(mass, device=device),
        rho0=None if rho0 is None else _t(rho0, device=device))


def boundary_from_numpy(pos, psi, sorted_hash, vel=None,
                        device=None) -> BoundaryData:
    """BoundaryData from numpy arrays (already hash-sorted)."""
    return BoundaryData(
        pos=_t(pos, device=device), psi=_t(psi, device=device),
        sorted_hash=_t(sorted_hash, torch.int32, device=device),
        vel=None if vel is None else _t(vel, device=device))


def rigid_body_from_numpy(arrays: dict, device=None) -> RigidBody:
    """RigidBody from ``{field: numpy array}`` (every RigidBody field:
    offsets, psi, mass, inertia_body, com, R, vel, omega), dtypes kept."""
    return RigidBody(**{f.name: _t(arrays[f.name], device=device)
                        for f in dataclasses.fields(RigidBody)})


def grid_from_numpy(origin, size, cell, device=None) -> Grid:
    """Grid from its origin (3,), cell counts and cell edge (3,)."""
    origin = np.asarray(origin)
    return make_grid(origin, size, np.asarray(cell),
                     dtype=_DTYPES[str(origin.dtype)], device=device)


def elastic_params_from_numpy(arrays: dict, device=None) -> ElasticParams:
    """ElasticParams from ``{field: numpy array}`` (every ElasticParams
    field), dtypes kept."""
    return ElasticParams(**{f.name: _t(arrays[f.name], device=device)
                            for f in dataclasses.fields(ElasticParams)})


def elastic_state_from_numpy(pos, vel, plastic=None,
                             device=None) -> ElasticState:
    """ElasticState from numpy arrays in statics order, dtypes kept."""
    return ElasticState(
        pos=_t(pos, device=device), vel=_t(vel, device=device),
        plastic=None if plastic is None else _t(plastic, device=device))


def elastic_statics_from_numpy(x0, corr, fixed, vol, mass, grid: Grid, h,
                               device=None) -> ElasticStatics:
    """ElasticStatics from the JAX body's hash-sorted reference positions,
    corrections, pinned mask, volume and mass on ``grid`` (the body's,
    on ``device``). The static ranges and the pair list within the
    interaction radius ``h`` (the params' ``interaction_radius``, as
    ``make_elastic_solid`` takes it) are rebuilt from ``x0``; the JAX
    window plan (``anchors``, ``hash_f32``, ``win``) has no counterpart."""
    x0 = _t(x0, device=device)
    sorted_hash, seg_start, seg_end, nbr_start, nbr = static_ranges(
        grid, x0, h)
    return ElasticStatics(
        x0=x0, sorted_hash=sorted_hash, seg_start=seg_start,
        seg_end=seg_end, nbr_start=nbr_start, nbr=nbr,
        miss=torch.zeros((), dtype=torch.int32, device=x0.device),
        corr=_t(corr, device=device), fixed=_t(fixed, torch.bool, device),
        vol=_t(vol, device=device), mass=_t(mass, device=device))
