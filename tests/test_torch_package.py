"""Package rules of the PyTorch port: no JAX, explicit device routing of
the sweeps, a CUDA build module that imports anywhere, and (on a CUDA
card only) the hand-written kernels held against their plain versions.

This file imports no JAX, so the card-only tests run on a machine that
has none: ``python -m pytest --noconftest tests/test_torch_package.py``
(the repository's conftest imports JAX).
"""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import nereus_tpu_torch
from nereus_tpu_torch import scene
from nereus_tpu_torch.ops import cuda_sweep
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

torch.set_num_threads(1)

PKG_DIR = os.path.dirname(nereus_tpu_torch.__file__)
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    [PKG_DIR], prefix="nereus_tpu_torch."))


def test_import_leaves_jax_out():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'nereus_tpu' or "
            "m.startswith('nereus_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(PKG_DIR)
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(MODULES) >= 12


def test_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|nereus_tpu)(\.|\s|$)",
                     re.M)
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    assert not pat.search(fh.read()), f


def _inputs(device="cpu", dtype=torch.float32, n=8, m=5, rows=9):
    return (torch.zeros((n, 4), dtype=dtype, device=device),
            torch.zeros((m, 8), dtype=dtype, device=device),
            torch.zeros((rows, n), dtype=torch.int32, device=device),
            torch.zeros((rows, n), dtype=torch.int32, device=device),
            torch.zeros((SP.PV_LEN,), dtype=dtype, device=device))


@pytest.mark.parametrize("device,dtype", [
    ("meta", torch.float32), ("cpu", torch.float16),
    ("cpu", torch.bfloat16), ("cpu", torch.int32)])
def test_dispatcher_raises_on_unsupported(device, dtype):
    q, src, s, e, pv = _inputs(device, dtype)
    cfg = nereus_tpu_torch.SimConfig()
    with pytest.raises(TypeError):
        SP.density_sweep(cfg, q, src, s, e, pv)
    q8 = torch.zeros((q.shape[0], 8), dtype=dtype, device=device)
    with pytest.raises(TypeError):
        SP.fluid_force_sweep(cfg, q8, src, s, e, pv)


def test_dispatcher_raises_on_mixed_devices():
    q, src, s, e, pv = _inputs()
    with pytest.raises(ValueError):
        SP.density_sweep(nereus_tpu_torch.SimConfig(), q,
                         src.to("meta"), s, e, pv)


def test_cpu_sweep_is_plain_and_launches_nothing():
    cuda_sweep.reset_launches()
    q, src, s, e, pv = _inputs()
    out = SP.density_sweep(nereus_tpu_torch.SimConfig(), q, src, s, e, pv)
    assert out.shape == (8,) and float(out.abs().max()) == 0.0
    assert [k.launches for k in cuda_sweep.KERNELS] == [0, 0]


def test_cuda_wrappers_reject_cpu_tensors():
    q, src, s, e, pv = _inputs()
    cfg = nereus_tpu_torch.SimConfig()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.density_sweep(cfg, q, src, s, e, pv)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.force_sweep(cfg, torch.zeros((8, 8)), src, s, e, pv)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0, 0]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_sweep, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sweep.build()
    assert cuda_sweep.sources() == [
        os.path.join(PKG_DIR, "csrc", "sph_sweep.cu")]


# ---------------------------------------------------------------------------
# On a CUDA card: the kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


MODELS = [("MULLER", "BECKER"), ("MONAGHAN", "AKINCI"), ("MULLER", "NONE")]


def _scene(kernel_set, st, with_boundary, device):
    """The small dam-break of the port's JAX comparisons (343 particles),
    floor 0.04 under the bottom layer, seeded velocities."""
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set],
        surface_tension_model=nereus_tpu_torch.SurfaceTensionModel[st])
    params = nereus_tpu_torch.make_params(dt=5e-4, device=device)
    state, grid, boundary = scene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.115, 0.0), box_max=(0.2, 0.7, 1.0),
        with_boundary=with_boundary, boundary_radius=0.04, device=device)
    pos = state.pos.cpu().numpy()
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    state = nereus_tpu_torch.make_fluid_state(pos, vel, device=device)
    return cfg, params, state, grid, boundary


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set,st", MODELS)
def test_kernels_match_plain_on_cuda(cuda, kernel_set, st, with_boundary):
    """Density rtol 1e-5; forces max|Δf| ≤ 1e-4·max|f| (FMA contraction,
    rsqrtf and the order of the plain version's atomic index_add_)."""
    cfg, params, state, grid, boundary = _scene(kernel_set, st,
                                                with_boundary, cuda)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    q4 = ctx.queries(width=4)
    src_d = ctx.pack(vel, params.particle_mass)
    cuda_sweep.reset_launches()
    dens = SP.density_sweep(cfg, q4, src_d, ctx.seg_start, ctx.seg_end,
                            ctx.pvec)
    ref = SP.density_sweep_plain(cfg, q4, src_d, ctx.seg_start,
                                 ctx.seg_end, ctx.pvec)
    torch.testing.assert_close(dens, ref, rtol=1e-5, atol=0)
    ds = dens.clamp(min=1e-12)
    pd2 = nereus_tpu_torch.tait_pressure(dens, params) / (ds * ds)
    q8 = ctx.queries(*vel, dens, pd2)
    src_f = ctx.pack(vel, dens)
    f = SP.fluid_force_sweep(cfg, q8, src_f, ctx.seg_start, ctx.seg_end,
                             ctx.pvec)
    f_ref = SP.fluid_force_sweep_plain(cfg, q8, src_f, ctx.seg_start,
                                       ctx.seg_end, ctx.pvec)
    torch.cuda.synchronize()
    assert [k.launches for k in cuda_sweep.KERNELS] == [1, 1]
    assert torch.isfinite(f).all()
    err = float((f - f_ref).abs().max())
    assert err <= 1e-4 * float(f_ref.abs().max()), err


@pytest.mark.requires_cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda):
    q, src, s, e, pv = _inputs(cuda)
    cfg = nereus_tpu_torch.SimConfig()
    with pytest.raises(TypeError):
        cuda_sweep.density_sweep(cfg, q.double(), src, s, e, pv)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sweep.density_sweep(cfg, torch.zeros((4, 8), device=cuda).t(),
                                 src, s, e, pv)
    with pytest.raises(ValueError, match="shape"):
        cuda_sweep.density_sweep(cfg, q, src[:, :4].contiguous(), s, e, pv)
    np.testing.assert_array_equal(
        cuda_sweep.density_sweep(cfg, q, src, s, e, pv).cpu().numpy(),
        np.zeros(8, np.float32))
