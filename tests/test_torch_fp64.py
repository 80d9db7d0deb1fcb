"""The port in float64 (the reference's ``DOUBLE_PRECISION`` switch,
``common/common.h:23-43``) against the JAX package's float64 segment
engine, and the CUDA route's refusal of float64.

The port's dtype is per tensor, so its CPU step runs float64 in this
process; JAX's ``jax_enable_x64`` is process-global, so JAX's side runs in
a subprocess, as ``tests/test_fp64.py`` runs it, on that file's dam-break
(216 particles in a walled box, 10 steps). Particles are matched by
nearest neighbour. Tolerance 1e-15 m on positions: two float64 engines
that sum in other orders (a scratch run measured 2.8e-17 m), eight orders
below float32's 1e-7.

This file imports no JAX itself, so its card test runs on a host without
JAX (``--noconftest``); the comparison skips there.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import nereus_tpu_torch as pt
from nereus_tpu_torch import scene
from nereus_tpu_torch.ops import sph_pairs as SP

torch.set_num_threads(1)

SCENE = dict(cube_size=(0.2, 0.2, 0.2), cube_center=(-0.3, 0.05, 0.5),
             box_min=(-0.8, -0.3, 0.0), box_max=(0.2, 0.7, 1.0),
             with_boundary=True, boundary_radius=0.04)
STEPS = 10

_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import json
import numpy as np
import jax.numpy as jnp
import nereus_tpu as nt
from nereus_tpu import scene

params = nt.make_params(dt=5e-4, dtype=jnp.float64)
cfg = nt.SimConfig(engine="segments", dtype=jnp.float64)
state, grid, boundary = scene.dam_break(params, cfg, **SCENE)
n = int(state.num_active)
step = jax.jit(lambda s: nt.wcsph_step(s, params, grid, cfg, boundary))
for _ in range(STEPS):
    state, diag = step(state)
print(json.dumps({"dtype": str(state.pos.dtype),
                  "pos": np.asarray(state.pos[:n]).tolist(),
                  "derr": float(diag.mean_density_error),
                  "overflow": int(diag.seg_overflow)}))
"""


def test_fp64_step_matches_jax_fp64():
    pytest.importorskip("jax")
    script = (f"SCENE = {SCENE!r}\nSTEPS = {STEPS}\n" + _SCRIPT)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["dtype"] == "float64" and ref["overflow"] == 0
    want = np.asarray(ref["pos"])

    params = pt.make_params(dt=5e-4, dtype=torch.float64, device="cpu")
    cfg = pt.SimConfig(dtype=torch.float64)
    state, grid, boundary = scene.dam_break(params, cfg, device="cpu",
                                            **SCENE)
    assert state.pos.dtype == torch.float64
    n = int(state.num_active)
    assert n == len(want) == 216
    for _ in range(STEPS):
        state, diag = pt.wcsph_step(state, params, grid, cfg, boundary)
    got = state.pos.numpy()[:n]
    assert state.pos.dtype == torch.float64 and np.isfinite(got).all()
    d2 = ((got[:, None, :] - want[None, :, :]) ** 2).sum(axis=2)
    nearest = d2.argmin(axis=1)
    assert len(set(nearest.tolist())) == n      # a one-to-one matching
    err = np.abs(got - want[nearest]).max()
    assert err < 1e-15, err
    # the particles moved: the match is not of the start lattice
    assert np.abs(got - scene.particle_cube(
        SCENE["cube_center"], SCENE["cube_size"],
        float(params.interaction_radius) - 0.005)).max() > 1e-4
    np.testing.assert_allclose(float(diag.mean_density_error), ref["derr"],
                               rtol=1e-12, atol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_route_refuses_fp64(cuda):
    """The sweeps take float64 on the CPU only: on a CUDA tensor ``_route``
    raises the TypeError that names both, as the JAX package refuses
    float64 Pallas on the TPU."""
    q = torch.zeros((8, 4), dtype=torch.float64, device=cuda)
    src = torch.zeros((5, 8), dtype=torch.float64, device=cuda)
    rng = torch.zeros((9, 8), dtype=torch.int32, device=cuda)
    pv = torch.zeros((SP.PV_LEN,), dtype=torch.float64, device=cuda)
    msg = (r"no sweep for torch.float64 tensors on cuda:0: CPU takes "
           r"float32/float64, CUDA takes float32")
    with pytest.raises(TypeError, match=msg):
        SP.density_sweep(pt.SimConfig(), q, src, rng, rng, pv)
    with pytest.raises(TypeError, match=msg):
        SP._route(q, src)
