"""The single-phase WCSPH step on the sweep kernels (the counterpart of
``nereus_tpu.solvers.wcsph_pallas.wcsph_step_pallas``).

Density sweep (fluid ψ = m and boundary ψ_b, self term included) → Tait
EOS → pd2 = p/max(ρ, 1e-12)² → one fused fluid + boundary force sweep →
symplectic Euler under the ``active`` mask. On CUDA tensors the two
sweeps are the hand-written kernels of ``csrc/sph_sweep.cu``; on CPU
tensors their plain PyTorch versions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import grid as gridlib
from ..ops import sph_pairs as SP
from ..params import SimConfig, SimParams
from ..state import BoundaryData, FluidState
from .sweep_common import build_sweep_ctx
from .wcsph import StepDiagnostics, density_errors, tait_pressure


class Sweeps(NamedTuple):
    density: Callable
    force: Callable


# the device dispatchers (the step's default), and the plain versions on
# any device (to time the plain step on a GPU against the kernels)
DISPATCH = Sweeps(SP.density_sweep, SP.fluid_force_sweep)
PLAIN = Sweeps(SP.density_sweep_plain, SP.fluid_force_sweep_plain)


def wcsph_step_cuda(state: FluidState, params: SimParams,
                    grid: gridlib.Grid, cfg: SimConfig,
                    boundary: Optional[BoundaryData] = None, *,
                    sweeps: Sweeps = DISPATCH):
    """One single-phase WCSPH step; returns ``(new_state,
    StepDiagnostics)`` with the new state in hash-sorted order."""
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    active = ctx.active
    pm = params.particle_mass

    # -- density: fluid ψ = m, boundary ψ_b; self-pairs included -----------
    q4 = ctx.queries(width=4)
    dens = sweeps.density(cfg, q4, ctx.pack(vel, pm), ctx.seg_start,
                          ctx.seg_end, ctx.pvec)
    pres = tait_pressure(dens, params)

    # -- forces: viscosity + surface tension + pressure + boundary terms ---
    dens_safe = torch.clamp(dens, min=1e-12)
    pd2 = pres / (dens_safe * dens_safe)
    q8 = ctx.queries(*vel, dens, pd2)
    force = sweeps.force(cfg, q8, ctx.pack(vel, dens), ctx.seg_start,
                         ctx.seg_end, ctx.pvec)

    # -- symplectic Euler (``integrate_functor``) --------------------------
    dt = params.dt
    g = params.gravity
    nv = [v + (dt / pm) * (force[:, k] + pm * g[k])
          for k, v in enumerate(vel)]
    npos = [torch.where(active, p + dt * v, p)
            for p, v in zip((ctx.px, ctx.py, ctx.pz), nv)]
    nvel = [torch.where(active, v1, v0) for v1, v0 in zip(nv, vel)]

    new_state = FluidState(
        pos=torch.stack(npos, dim=1),
        vel=torch.stack(nvel, dim=1),
        pressure=torch.where(active, pres, torch.zeros_like(pres)),
        num_active=state.num_active)
    nact = torch.clamp(state.num_active.to(dens.dtype), min=1.0)
    mae, mc = density_errors(dens, active, nact, params.rest_density)
    zero_i = torch.zeros((), dtype=torch.int32, device=dens.device)
    diag = StepDiagnostics(
        max_density=torch.max(torch.where(active, dens,
                                          torch.zeros_like(dens))),
        mean_density_error=mae,
        mean_compression=mc,
        seg_overflow=zero_i,
        solver_iters=zero_i.clone(),
    )
    return new_state, diag
