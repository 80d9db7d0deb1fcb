"""Scene construction (PyTorch port of ``nereus_tpu.scene``): particle
seeding (``SPH::generateParticleCube``, ``sph/sph.cpp:341-386``) and the
demo scenes. Scenes are deterministic lattices built on the host in
float64 and moved to ``device`` once (default: the CUDA device)."""

from __future__ import annotations

import numpy as np

from . import boundary as bnd
from . import grid as gridlib
from .params import SimConfig, SimParams
from .state import make_fluid_state


def particle_cube(center, size, spacing):
    """Lattice filling an axis-aligned cube: inclusive loops from
    center−size/2 to center+size/2 at ``spacing`` (``sph.cpp:373-386``)."""
    center = np.asarray(center, dtype=np.float64)
    size = np.asarray(size, dtype=np.float64)
    axes = [np.arange(c - s / 2.0, c + s / 2.0 + spacing * 0.5, spacing)
            for c, s in zip(center, size)]
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)


def resting_block(params: SimParams, cfg: SimConfig, *,
                  n_target: int | None = None,
                  side: float | None = None,
                  capacity: int | None = None,
                  boundary_radius: float = 0.02,
                  spacing: float | None = None,
                  compress: float = 0.003,
                  impact_velocity: float = 0.0,
                  device=None):
    """A fluid block at rest-density packing on the floor of a boundary
    box, compressed by ``compress`` in density; pass
    ``calibrate_mass(params, cfg, spacing=spacing)`` params. Walls stand
    two spacings off the fluid on every face (one spacing is measured
    unstable on the JAX side). Returns ``(state, grid, boundary)``."""
    if spacing is None:
        spacing = 0.8 * float(params.interaction_radius)
    spacing = spacing * float(1.0 + compress) ** (-1.0 / 3.0)
    if side is None:
        side = spacing * ((n_target or 8000) ** (1.0 / 3.0))
    gap = 2.0 * spacing
    box_min = (0.0, 0.0, 0.0)
    box_max = (side + 2 * gap, 1.5 * side + gap, side + 2 * gap)
    cube_center = (gap + side / 2.0, gap + side / 2.0, gap + side / 2.0)
    pts = particle_cube(cube_center, (side, side, side), spacing)
    grid = gridlib.fit_grid(box_min, box_max,
                            float(params.interaction_radius),
                            dtype=cfg.dtype, device=device)
    vel = None
    if impact_velocity:
        vel = np.broadcast_to(
            np.asarray([0.0, impact_velocity, 0.0]), pts.shape)
    state = make_fluid_state(pts, velocities=vel, capacity=capacity,
                             dtype=cfg.dtype, device=device)
    boundary = bnd.box_boundary(grid, box_min, box_max, boundary_radius,
                                params, cfg.kernel_set, dtype=cfg.dtype,
                                device=device)
    return state, grid, boundary


def dam_break(params: SimParams, cfg: SimConfig, *,
              n_target: int | None = None,
              cube_center=(-0.4, 0.04, 0.5),
              cube_size=(0.5, 0.5, 0.5),
              box_min=(-1.0, -1.0, -1.0),
              box_max=(3.0, 3.0, 3.0),
              with_boundary: bool = True,
              capacity: int | None = None,
              capacity_factor: float = 1.0,
              boundary_radius: float = 0.02,
              device=None):
    """The demo scene (``main.cpp:533-555``): a fluid cube inside a
    boundary box, seeded at spacing h − 0.005 (``sph.cpp:375``). With
    ``n_target`` the cube is scaled at fixed spacing to about that many
    particles and the box grows to keep four spacings of room around it
    (``n_target=2**20`` gives 1,092,727 particles).

    Returns ``(state, grid, boundary_or_none)``.
    """
    spacing = float(params.interaction_radius) - 0.005
    if n_target is not None:
        side = spacing * (n_target ** (1.0 / 3.0))
        cube_size = (side, side, side)
        lo = np.minimum(np.asarray(cube_center) - side / 2.0 - 4 * spacing,
                        np.asarray(box_min))
        hi = np.maximum(np.asarray(cube_center) + side / 2.0 + 4 * spacing,
                        np.asarray(box_max))
        box_min, box_max = tuple(lo), tuple(hi)
    pts = particle_cube(cube_center, cube_size, spacing)
    grid = gridlib.fit_grid(box_min, box_max, float(params.interaction_radius),
                            dtype=cfg.dtype, device=device)
    if capacity is None and capacity_factor > 1.0:
        capacity = int(len(pts) * capacity_factor)
    state = make_fluid_state(pts, capacity=capacity, dtype=cfg.dtype,
                             device=device)
    boundary = None
    if with_boundary:
        boundary = bnd.box_boundary(grid, box_min, box_max, boundary_radius,
                                    params, cfg.kernel_set, dtype=cfg.dtype,
                                    device=device)
    return state, grid, boundary
