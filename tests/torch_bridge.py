"""Shared inputs for the PyTorch-port tests: one small scene built by the
JAX package and carried to the port through ``nereus_tpu_torch.convert``,
so both packages start from identical float32 arrays."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import nereus_tpu as jt
from nereus_tpu import scene as jscene
from nereus_tpu.ops import pallas_sph as PS
from nereus_tpu_torch import convert

# (kernel set, surface-tension model) grid of the port tests
MODELS = [
    (jt.KernelSet.MULLER, jt.SurfaceTensionModel.BECKER),
    (jt.KernelSet.MONAGHAN, jt.SurfaceTensionModel.AKINCI),
    (jt.KernelSet.MULLER, jt.SurfaceTensionModel.NONE),
]
MODEL_IDS = ["muller-becker", "monaghan-akinci", "muller-none"]


def jax_scene(with_boundary, kernel_set=jt.KernelSet.MULLER,
              st=jt.SurfaceTensionModel.BECKER, floor=-0.3, seed=0):
    """The ``tests/test_pallas.py`` dam-break scene (343 particles, cube
    0.25, boundary radius 0.04, dt 5e-4) with seeded random velocities in
    [−0.5, 0.5) m/s, so the viscosity and friction terms are non-zero.
    ``floor`` moves the box floor: −0.115 puts the bottom layer 0.04 from
    the wall, inside the kernel support."""
    cfg = jt.SimConfig(seg_window=48, kernel_set=kernel_set,
                       surface_tension_model=st, engine="segments")
    params = jt.make_params(dt=5e-4)
    state, grid, boundary = jscene.dam_break(
        params, cfg, cube_size=(0.25, 0.25, 0.25),
        cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, floor, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=with_boundary, boundary_radius=0.04)
    pos = np.asarray(state.pos)
    vel = np.random.default_rng(seed).uniform(-0.5, 0.5, pos.shape)
    state = jt.make_fluid_state(pos, vel.astype(np.float32))
    return cfg, params, state, grid, boundary


def params_to_port(params, device="cpu"):
    """The same params as port params on ``device``."""
    return convert.params_from_numpy(
        {f.name: np.asarray(getattr(params, f.name))
         for f in dataclasses.fields(params)}, device=device)


def to_port(cfg, params, state, grid, boundary, device="cpu"):
    """The same config, params, state (with a multiphase state's mass and
    ρ₀ columns), grid and boundary (with a moving boundary's wall
    velocities) as port objects on ``device``."""
    pparams = params_to_port(params, device)
    pboundary = None
    if boundary is not None:
        pboundary = convert.boundary_from_numpy(
            boundary.pos, boundary.psi, boundary.sorted_hash,
            vel=None if boundary.vel is None else np.asarray(boundary.vel),
            device=device)
    return (convert.config_from_jax_fields(cfg), pparams,
            convert.state_from_numpy(state.pos, state.vel, state.pressure,
                                     state.num_active, state.mass,
                                     state.rho0, device=device),
            convert.grid_from_numpy(grid.origin, grid.size, grid.cell,
                                    device=device),
            pboundary)


def body_to_port(body, device="cpu"):
    """The same JAX ``RigidBody`` as a port ``RigidBody`` on ``device``."""
    return convert.rigid_body_from_numpy(
        {f.name: np.asarray(getattr(body, f.name))
         for f in dataclasses.fields(body)}, device=device)


@pytest.fixture
def exact_reciprocal(monkeypatch):
    """Interpret mode evaluates the force pair's ``pl.reciprocal(approx=
    True)`` with a ~4e-3 relative error. The port divides exactly, as the
    JAX pair formulas do outside a Mosaic kernel (``_fast_recip``); hold
    both to the exact form so the tolerance measures the sweep. Import it
    into a test module to use it there."""
    monkeypatch.setattr(PS, "_fast_recip", lambda x: 1.0 / x)


def assert_columns_close(got, want, rtol, name=""):
    """Per output column: max|got − want| ≤ ``rtol``·max|want|, the
    reference column not all zero (the check would be vacuous), and the
    port's output finite."""
    got = np.asarray(got).reshape(len(got), -1)
    want = np.asarray(want).reshape(len(want), -1)
    assert np.isfinite(got).all(), name
    for col in range(want.shape[1]):
        scale = np.abs(want[:, col]).max()
        assert scale > 0.0, (name, col)
        err = np.abs(got[:, col] - want[:, col]).max()
        assert err <= rtol * scale, (name, col, err, scale)


def dense_pairs(pair, q, src, pv, **kw):
    """JAX's pair function ``pair`` summed over every (query, source) pair,
    its own r² < h² mask the cutoff: the sweep over every source in range.
    ``q`` (N, Fq) and ``src`` (M, Fs) port tensors; returns (N, out)."""
    jq = jnp.asarray(q.numpy())
    js = jnp.asarray(src.numpy().T)
    return np.asarray(pair(jq, js, jnp.ones((jq.shape[0], js.shape[1]),
                                            bool), pv, **kw))
