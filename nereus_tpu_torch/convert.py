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
