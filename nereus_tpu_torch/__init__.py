"""nereus_tpu_torch: the PyTorch + CUDA port of nereus_tpu.

The WCSPH step (single phase with optional XSPH and implicit viscosity,
and multiphase), the single-phase IISPH and PCISPH steps, the DFSPH step
(single phase with optional implicit viscosity, and multiphase), the PBF
step (with optional vorticity confinement and XSPH), moving boundaries
(``move_boundary``) for all of them, the WCSPH step with two-way
rigid-body coupling (single phase and multiphase), elastic and
elastoplastic solids (``elastic_step``), the WCSPH step with two-way
fluid–elastic coupling (``wcsph_elastic_step``), the DFSPH steps with
two-way rigid-body coupling (``dfsph_coupled_step``, single phase and
multiphase) and fluid–elastic coupling (``dfsph_elastic_step``), and the
triangle-mesh boundaries and bodies (``mesh_boundary``,
``make_rigid_mesh``), and particle lifecycle and grid refit
(``add_particles``, ``add_particles_traced``, ``remove_particles``,
``refit_grid``) of
``nereus_tpu`` on one NVIDIA GPU: the same public names and semantics for
the ported subset, with the neighbor sweeps as hand-written CUDA kernels
for Hopper (``csrc/``) and plain PyTorch versions of them on the CPU.
Entry points build on the CUDA device unless given another. Imports torch
and numpy, never JAX.
"""

from .params import (KernelSet, SimConfig, SimParams, SurfaceTensionModel,
                     calibrate_mass, dfsph_params, iisph_params, make_params,
                     pbf_params, pcisph_params)
from .grid import Grid, fit_grid, make_grid, refit_grid
from .state import (BoundaryData, FluidState, add_particles,
                    add_particles_traced, make_fluid_state,
                    remove_particles)
from .boundary import move_boundary, rehash_boundary, rotation_matrix
from .rigid import (RigidBody, body_body_contact, body_boundary,
                    concat_boundaries, integrate_rigid, make_rigid_box,
                    wall_contact_force)
from .solvers.wcsph import StepDiagnostics, cfl_dt, tait_pressure, wcsph_step
from .solvers.iisph import iisph_step
from .solvers.pcisph import (pcisph_delta, pcisph_delta_from_denom,
                             pcisph_grad_denom, pcisph_step)
from .solvers.dfsph import dfsph_step
from .solvers.pbf import pbf_step
from .solvers.coupled import wcsph_coupled_step
from .solvers.elastic import (ElasticDiagnostics, ElasticParams,
                              ElasticState, ElasticStatics, elastic_params,
                              elastic_step, make_elastic_solid,
                              sample_box_solid)
from .solvers.elastic_coupled import elastic_psi, wcsph_elastic_step
from .solvers.dfsph_coupled import dfsph_coupled_step
from .solvers.dfsph_elastic import dfsph_elastic_step
from .mesh import (load_obj, make_rigid_mesh, mesh_boundary,
                   mesh_mass_properties, sample_surface)

__version__ = "0.1.0"

__all__ = [
    "KernelSet", "SimConfig", "SimParams", "SurfaceTensionModel",
    "calibrate_mass", "make_params", "iisph_params", "pcisph_params",
    "dfsph_params", "pbf_params",
    "Grid", "fit_grid", "make_grid", "refit_grid",
    "BoundaryData", "FluidState", "make_fluid_state", "add_particles",
    "add_particles_traced", "remove_particles",
    "StepDiagnostics", "wcsph_step", "tait_pressure", "cfl_dt",
    "iisph_step", "pcisph_step", "pcisph_delta", "pcisph_delta_from_denom",
    "pcisph_grad_denom", "dfsph_step", "pbf_step",
    "move_boundary", "rehash_boundary", "rotation_matrix",
    "RigidBody", "make_rigid_box", "body_boundary", "body_body_contact",
    "concat_boundaries", "integrate_rigid", "wall_contact_force",
    "wcsph_coupled_step",
    "ElasticParams", "ElasticState", "ElasticStatics", "ElasticDiagnostics",
    "elastic_params", "sample_box_solid", "make_elastic_solid",
    "elastic_step", "elastic_psi", "wcsph_elastic_step",
    "dfsph_coupled_step", "dfsph_elastic_step",
    "load_obj", "sample_surface", "mesh_mass_properties", "mesh_boundary",
    "make_rigid_mesh",
]
