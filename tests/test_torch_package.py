"""Package rules of the PyTorch port: no JAX, explicit device routing of
the sweeps, a CUDA build module that imports anywhere, and (on a CUDA
card only) the hand-written kernels held against their plain versions.

This file imports no JAX, so the card-only tests run on a machine that
has none: ``python -m pytest --noconftest tests/test_torch_package.py``
(the repository's conftest imports JAX).
"""

import dataclasses
import functools
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
from nereus_tpu_torch.solvers import pcisph_cuda
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
from nereus_tpu_torch.solvers.wcsph import tait_pd2

torch.set_num_threads(1)

PKG_DIR = os.path.dirname(nereus_tpu_torch.__file__)
N_KERNELS = len(cuda_sweep.KERNELS)
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
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


def test_cuda_wrappers_reject_cpu_tensors():
    q, src, s, e, pv = _inputs()
    cfg = nereus_tpu_torch.SimConfig()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.density_sweep(cfg, q, src, s, e, pv)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.force_sweep(cfg, torch.zeros((8, 8)), src, s, e, pv)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_sweep, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_sweep.build()
    assert cuda_sweep.sources() == [
        os.path.join(PKG_DIR, "csrc", f) for f in (
            "cell_check.cu", "coupled_sweep.cu", "dfsph_multiphase_sweep.cu",
            "dfsph_sweep.cu", "elastic_sweep.cu", "iisph_sweep.cu",
            "layout_probe.cu", "multiphase_sweep.cu", "pbf_sweep.cu",
            "sph_sweep.cu", "viscosity_sweep.cu")]
    assert [f for f in cuda_sweep._inputs_of_build()
            if f.endswith(".cuh")] == [
        os.path.join(PKG_DIR, "csrc", f) for f in (
            "group_sweep.cuh", "sweep_common.cuh", "tiled_sweep.cuh")]


def test_a_newer_header_rebuilds(monkeypatch, tmp_path):
    """The library is stale when a shared header (the tiled engine's
    ``tiled_sweep.cuh``) is newer than it, and fresh when it is newer
    than every source."""
    lib = tmp_path / "libnereus_sweep.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(cuda_sweep, "LIB_PATH", str(lib))
    header = os.path.join(PKG_DIR, "csrc", "tiled_sweep.cuh")
    newest = max(os.path.getmtime(f) for f in cuda_sweep._inputs_of_build())
    os.utime(lib, (newest + 10, newest + 10))
    assert not cuda_sweep._stale()
    old = os.path.getmtime(header) - 10
    os.utime(lib, (old, old))
    assert cuda_sweep._stale()


# the IISPH sweeps, then PCISPH's and DFSPH's: (dispatcher, CUDA wrapper,
# query width, source width, range rows)
IISPH_SWEEPS = {
    "dii_aii": (SP.dii_aii_sweep, cuda_sweep.dii_aii_sweep, 12, 12, 18),
    "sum_dij": (SP.sum_dij_sweep, cuda_sweep.sum_dij_sweep, 4, 4, 9),
    "jacobi": (SP.jacobi_sweep, cuda_sweep.jacobi_sweep, 8, 8, 18),
    "pressure_force": (SP.pressure_force_sweep,
                       cuda_sweep.pressure_force_sweep, 4, 8, 18),
}
PCISPH_DFSPH_SWEEPS = {
    "predicted_density": (SP.predicted_density_sweep,
                          cuda_sweep.predicted_density_sweep, 4, 4, 18),
    # DFSPH's density and α in one walk: (ρ, α), and the couplings' sums
    "alpha": (SP.density_alpha_sweep, cuda_sweep.density_alpha_sweep, 4, 4,
              18),
    "alpha_sums": (SP.density_alpha_sums_sweep,
                   cuda_sweep.density_alpha_sums_sweep, 4, 4, 18),
    "drho": (SP.drho_sweep, cuda_sweep.drho_sweep, 8, 8, 18),
}


MULTIPHASE_XSPH_SWEEPS = {
    "multiphase_density": (SP.multiphase_density_sweep,
                           cuda_sweep.multiphase_density_sweep, 4, 4, 18),
    "multiphase_force": (SP.multiphase_force_sweep,
                         cuda_sweep.multiphase_force_sweep, 12, 12, 18),
    "xsph": (SP.xsph_sweep, cuda_sweep.xsph_sweep, 8, 8, 9),
}
VISC_MP_DFSPH_SWEEPS = {
    "visc_laplacian": (SP.visc_laplacian_sweep,
                       cuda_sweep.visc_laplacian_sweep, 8, 8, 18),
    # the multiphase density and α̂'s sums in one walk
    "multiphase_density_alpha": (SP.multiphase_density_alpha_sweep,
                                 cuda_sweep.multiphase_density_alpha_sweep,
                                 4, 4, 18),
    "multiphase_drho": (SP.multiphase_drho_sweep,
                        cuda_sweep.multiphase_drho_sweep, 8, 8, 18),
    "multiphase_kappa": (SP.multiphase_kappa_sweep,
                         cuda_sweep.multiphase_kappa_sweep, 8, 4, 18),
}
PBF_SWEEPS = {
    "pbf_lambda": (SP.pbf_lambda_sweep, cuda_sweep.pbf_lambda_sweep, 4, 4,
                   18),
    "pbf_dp": (SP.pbf_dp_sweep, cuda_sweep.pbf_dp_sweep, 4, 4, 18),
    "pbf_omega": (SP.pbf_omega_sweep, cuda_sweep.pbf_omega_sweep, 8, 8, 9),
    "pbf_grad": (SP.pbf_grad_sweep, cuda_sweep.pbf_grad_sweep, 4, 4, 9),
}
COUPLED_SWEEPS = {
    "body_density": (SP.body_density_sweep, cuda_sweep.body_density_sweep,
                     4, 4, 9),
    "body_force": (SP.body_force_sweep, cuda_sweep.body_force_sweep, 8, 8,
                   9),
    "multiphase_body": (SP.multiphase_body_sweep,
                        cuda_sweep.multiphase_body_sweep, 8, 8, 9),
}
ELASTIC_SWEEPS = {
    # 0 range rows: a static pair list (nbr_start, nbr) in their places
    "elastic_f": (SP.elastic_f_sweep, cuda_sweep.elastic_f_sweep, 8, 8, 0),
    "elastic_force_hourglass": (SP.elastic_force_hourglass_sweep,
                                cuda_sweep.elastic_force_hourglass_sweep,
                                24, 24, 0),
    "fluid_reaction": (SP.fluid_reaction_sweep,
                       cuda_sweep.fluid_reaction_sweep, 8, 8, 9),
}
# the DFSPH couplings' body sweeps over a shell's 9 range rows
DFSPH_BODY_SWEEPS = {
    "pressure_force_body": (SP.pressure_force_body_sweep,
                            cuda_sweep.pressure_force_body_sweep, 4, 8, 9),
    "pressure_force_body_rev": (SP.pressure_force_body_rev_sweep,
                                cuda_sweep.pressure_force_body_rev_sweep, 4,
                                8, 9),
    # the shell's ψ-density and α's sums, their boundary and fluid forms
    "body_density_alpha": (SP.body_density_alpha_sweep,
                           cuda_sweep.body_density_alpha_sweep, 4, 4, 9),
    "body_density_alpha_sq": (
        functools.partial(SP.body_density_alpha_sweep, include_sq=True),
        functools.partial(cuda_sweep.body_density_alpha_sweep,
                          include_sq=True), 4, 4, 9),
    "drho_shell": (SP.drho_shell_sweep, cuda_sweep.drho_shell_sweep, 8, 8,
                   9),
    "multiphase_alpha_body": (SP.multiphase_alpha_body_sweep,
                              cuda_sweep.multiphase_alpha_body_sweep, 4, 4,
                              9),
    "multiphase_drho_body": (SP.multiphase_drho_body_sweep,
                             cuda_sweep.multiphase_drho_body_sweep, 8, 8, 9),
    "multiphase_kappa_body": (SP.multiphase_kappa_body_sweep,
                              cuda_sweep.multiphase_kappa_body_sweep, 8, 4,
                              9),
}
ALL_SWEEPS = {**IISPH_SWEEPS, **PCISPH_DFSPH_SWEEPS, **MULTIPHASE_XSPH_SWEEPS,
              **VISC_MP_DFSPH_SWEEPS, **PBF_SWEEPS, **COUPLED_SWEEPS,
              **ELASTIC_SWEEPS, **DFSPH_BODY_SWEEPS}


def _sweep_inputs(key, device="cpu", dtype=torch.float32, n=8, m=8):
    """Zero operands (q, src, seg_start, seg_end, pvec) of the sweep
    ``key``, with ρ₀ and PBF's ε set in pvec (λ's formula divides by
    them); for a list sweep (0 range rows) an empty pair list
    (nbr_start, nbr) in the ranges' places."""
    _, _, fq, fs, rows = ALL_SWEEPS[key]
    pv = torch.zeros((SP.PV_LEN,), dtype=dtype, device=device)
    pv[SP.PV_RD] = 1000.0
    pv[SP.PV_PBF_EPS] = 100.0
    i32 = dict(dtype=torch.int32, device=device)
    ranges = ((torch.zeros((n + 1,), **i32), torch.zeros((0,), **i32))
              if rows == 0 else (torch.zeros((rows, n), **i32),
                                 torch.zeros((rows, n), **i32)))
    return (torch.zeros((n, fq), dtype=dtype, device=device),
            torch.zeros((m, fs), dtype=dtype, device=device), *ranges, pv)


def _routes_by_device(dispatch, wrapper, key):
    """CPU float32 runs the plain sweep and launches nothing; unsupported
    dtypes raise; the CUDA wrapper refuses CPU tensors."""
    cfg = nereus_tpu_torch.SimConfig()
    cuda_sweep.reset_launches()
    out = dispatch(cfg, *_sweep_inputs(key))
    assert out.shape[0] == 8 and float(out.abs().max()) == 0.0
    with pytest.raises(TypeError):
        dispatch(cfg, *_sweep_inputs(key, dtype=torch.float16))
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(cfg, *_sweep_inputs(key))
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


@pytest.mark.parametrize("key", sorted(IISPH_SWEEPS))
def test_iisph_dispatchers_route_by_device(key):
    _routes_by_device(*IISPH_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(PCISPH_DFSPH_SWEEPS))
def test_pcisph_dfsph_dispatchers_route_by_device(key):
    _routes_by_device(*PCISPH_DFSPH_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(MULTIPHASE_XSPH_SWEEPS))
def test_multiphase_xsph_dispatchers_route_by_device(key):
    _routes_by_device(*MULTIPHASE_XSPH_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(VISC_MP_DFSPH_SWEEPS))
def test_visc_mp_dfsph_dispatchers_route_by_device(key):
    _routes_by_device(*VISC_MP_DFSPH_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(PBF_SWEEPS))
def test_pbf_dispatchers_route_by_device(key):
    _routes_by_device(*PBF_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(COUPLED_SWEEPS))
def test_coupled_dispatchers_route_by_device(key):
    _routes_by_device(*COUPLED_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(ELASTIC_SWEEPS))
def test_elastic_dispatchers_route_by_device(key):
    _routes_by_device(*ELASTIC_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", sorted(DFSPH_BODY_SWEEPS))
def test_dfsph_body_dispatchers_route_by_device(key):
    _routes_by_device(*DFSPH_BODY_SWEEPS[key][:2], key)


@pytest.mark.parametrize("key", ["body_force", "fluid_reaction"])
def test_friction_only_contacts_route_by_device(key):
    """The body contact and the fluid reaction with
    ``include_pressure=False`` (the DFSPH couplings' friction) run the
    plain sweeps on CPU tensors, launching nothing, and their CUDA
    wrappers refuse them."""
    dispatch, wrapper = ALL_SWEEPS[key][:2]
    cfg = nereus_tpu_torch.SimConfig()
    cuda_sweep.reset_launches()
    out = dispatch(cfg, *_sweep_inputs(key), include_pressure=False)
    assert out.shape == (8, 3) and float(out.abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(cfg, *_sweep_inputs(key), include_pressure=False)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


def test_body_force_and_mp_density_alpha_take_their_g(monkeypatch):
    """The body contact force, both forms, passes its kernel the G of
    ``shell_group`` for its shell's size (a rigid box's 56 samples, an
    elastic cube's 4,096), and the multiphase density and α̂ sweep
    ``MP_DENSITY_ALPHA_G``, each to its own entry point and counter (the
    launch itself recorded, not made: no card here)."""
    calls = []

    def record(kernel, fn, cfg, q, fq, src, fs, s, e, pv, rows, cols,
               *switches, planes=False):
        calls.append((kernel, fn, src.shape[0], cols, switches, planes))
    monkeypatch.setattr(cuda_sweep, "_sweep", record)
    cfg = nereus_tpu_torch.SimConfig()
    want = []
    for m in (56, 4096):
        for p, kern, fn in ((True, cuda_sweep.BODY_FORCE, "body_force"),
                            (False, cuda_sweep.BODY_FORCE_P0,
                             "body_force_p0")):
            cuda_sweep.body_force_sweep(cfg, *_sweep_inputs("body_force",
                                                            m=m),
                                        include_pressure=p)
            want.append((kern, fn, m, 3, (cuda_sweep.shell_group(m),),
                         False))
    cuda_sweep.multiphase_density_alpha_sweep(
        cfg, *_sweep_inputs("multiphase_density_alpha"))
    want.append((cuda_sweep.MP_DENSITY_ALPHA, "multiphase_density_alpha",
                  8, 9, (cuda_sweep.MP_DENSITY_ALPHA_G,), True))
    assert calls == want
    assert [cuda_sweep.shell_group(m) for m in (56, 4096)] == [2, 8]


@pytest.mark.parametrize("key", ["body_density_alpha",
                                 "body_density_alpha_sq",
                                 "multiphase_kappa_body"])
def test_shell_sweeps_take_their_g(monkeypatch, key):
    """The shell's ψ-density and α sweep, both forms, and the multiphase κ̂
    correction over a shell pass their kernels the G of ``shell_group`` for
    the shell's size (a rigid box's 56 samples, an elastic cube's 4,096),
    each to its own entry point and counter, the fused sweep's output as
    planes (the launch itself recorded, not made: no card here)."""
    calls = []

    def record(kernel, fn, cfg, q, fq, src, fs, s, e, pv, rows, cols,
               *switches, planes=False):
        calls.append((kernel, fn, fq, src.shape, rows, cols, switches,
                      planes))
    monkeypatch.setattr(cuda_sweep, "_sweep", record)
    cfg = nereus_tpu_torch.SimConfig()
    wrapper = ALL_SWEEPS[key][1]
    fq, fs = ALL_SWEEPS[key][2:4]
    kernel, cols, planes = {
        "body_density_alpha": (cuda_sweep.BODY_DENSITY_ALPHA, 4, True),
        "body_density_alpha_sq": (cuda_sweep.BODY_DENSITY_ALPHA_SQ, 5, True),
        "multiphase_kappa_body": (cuda_sweep.MP_KAPPA_BODY, 3, False)}[key]
    for m in (56, 4096):
        wrapper(cfg, *_sweep_inputs(key, m=m))
    assert calls == [(kernel, key, fq, (m, fs), (9,), cols,
                      (cuda_sweep.shell_group(m),), planes)
                     for m in (56, 4096)]


@pytest.mark.parametrize("include_pressure", [True, False])
def test_moving_force_routes_by_device(include_pressure):
    """The force and multiphase force sweeps' ``moving_boundary=True`` run
    the plain sweeps on CPU tensors, launching nothing, and their CUDA
    wrappers refuse them."""
    cfg = nereus_tpu_torch.SimConfig()
    q, src, s, e, pv = _inputs()
    q8 = torch.zeros((q.shape[0], 8))
    kw = dict(include_pressure=include_pressure, moving_boundary=True)
    cuda_sweep.reset_launches()
    out = SP.fluid_force_sweep(cfg, q8, src, s, e, pv, **kw)
    assert out.shape == (8, 3) and float(out.abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.force_sweep(cfg, q8, src, s, e, pv, **kw)
    mq, msrc, ms, me, mpv = _sweep_inputs("multiphase_force")
    out = SP.multiphase_force_sweep(cfg, mq, msrc, ms, me, mpv,
                                    moving_boundary=True)
    assert out.shape == (8, 3) and float(out.abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.multiphase_force_sweep(cfg, mq, msrc, ms, me, mpv,
                                          moving_boundary=True)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


@pytest.mark.parametrize("include_pressure", [True, False])
def test_force_without_viscosity_routes_by_device(include_pressure):
    """The force sweep's ``include_viscosity=False`` runs the plain sweep on
    CPU tensors, launching nothing, and its CUDA wrapper refuses them."""
    cfg = nereus_tpu_torch.SimConfig()
    kw = dict(include_pressure=include_pressure, include_viscosity=False)
    q, src, s, e, pv = _inputs()
    q8 = torch.zeros((q.shape[0], 8))
    cuda_sweep.reset_launches()
    out = SP.fluid_force_sweep(cfg, q8, src, s, e, pv, **kw)
    assert out.shape == (8, 3) and float(out.abs().max()) == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.force_sweep(cfg, q8, src, s, e, pv, **kw)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


@pytest.mark.parametrize("include_pressure", [True, False])
def test_wall_force_routes_by_device(include_pressure):
    """The wall-only force sweep runs the plain sweep on CPU tensors,
    launching nothing, refuses float16 and 18 range rows, and its CUDA
    wrapper refuses CPU tensors."""
    cfg = nereus_tpu_torch.SimConfig()
    q, src, s, e, pv = _inputs()
    q8 = torch.zeros((q.shape[0], 8))
    kw = dict(include_pressure=include_pressure)
    cuda_sweep.reset_launches()
    out = SP.boundary_force_sweep(cfg, q8, src, s, e, pv, **kw)
    assert out.shape == (8, 3) and float(out.abs().max()) == 0.0
    with pytest.raises(TypeError):
        SP.boundary_force_sweep(cfg, q8.half(), src.half(), s, e, pv.half(),
                                **kw)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.boundary_force_sweep(cfg, q8, src, s, e, pv, **kw)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


def _probe_scene(device, capacity_extra=16):
    """A small dam-break with parked slots past its live count."""
    cfg = nereus_tpu_torch.SimConfig()
    params = nereus_tpu_torch.make_params(dt=5e-4, device=device)
    state, grid, boundary = scene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.095, 0.0), box_max=(0.2, 0.7, 1.0),
        boundary_radius=0.04, device=device)
    pos = state.pos.cpu().numpy()
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    state = nereus_tpu_torch.make_fluid_state(
        pos, vel, capacity=len(pos) + capacity_extra, device=device)
    return cfg, params, state, grid, boundary


def test_cell_check_routes_by_device():
    """The cell check's plain version on CPU tensors (its cells equal
    ``grid.cell_coords``; parked slots clamp to the last cell), launching
    nothing; float16 raises; the CUDA wrapper refuses CPU tensors and
    query widths other than 4 and 8."""
    from nereus_tpu_torch import grid as gridlib
    from nereus_tpu_torch.probes import cells
    cfg, params, state, grid, _ = _probe_scene("cpu")
    ctx = build_sweep_ctx(state, params, grid, cfg, None)
    cuda_sweep.reset_launches()
    q = ctx.queries(width=4)
    got = cells.cell_coords_in_kernel(q, ctx.pvec, grid)
    assert got.dtype == torch.int32 and got.shape == (state.capacity, 4)
    assert torch.equal(got[:, :3], gridlib.cell_coords(grid, q[:, :3]))
    assert got[-1, :3].tolist() == [g - 1 for g in grid.size]
    with pytest.raises(TypeError):
        cells.cell_coords_in_kernel(q.half(), ctx.pvec.half(), grid)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.cell_check(q, ctx.pvec, grid)
    with pytest.raises(ValueError, match=r"\(N, 4\) or \(N, 8\)"):
        cuda_sweep.cell_check(torch.zeros((8, 12)), ctx.pvec, grid)
    assert cells.cellcheck(state, params, grid, cfg, quiet=True) == 0
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


def test_layout_probe_routes_by_device():
    """The layout probe's plain version on CPU tensors, the same for both
    layouts, launching nothing; the CUDA wrapper refuses CPU tensors and a
    query count that is not a multiple of 128."""
    from nereus_tpu_torch.probes import layout
    anchors, q, src = (torch.from_numpy(a) for a in
                       layout.build_inputs(256, 16))
    cuda_sweep.reset_launches()
    aos = layout.layout_probe(anchors, q, src, 16)
    soa = layout.layout_probe(anchors, q, src.t().contiguous(), 16, soa=True)
    assert aos.shape == (4, 256) and torch.equal(aos, soa)
    assert not aos[3].any() and torch.isfinite(aos).all()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sweep.layout_probe(anchors, q, src, 16, False)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda_sweep.layout_probe(anchors, q[:, :200], src, 16, False)
    assert [k.launches for k in cuda_sweep.KERNELS] == [0] * N_KERNELS


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
    rsqrtf and the order of summation), each sweep on its one operand
    matrix (the queries its first rows, the matrix itself without walls)."""
    cfg, params, state, grid, boundary = _scene(kernel_set, st,
                                                with_boundary, cuda)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dargs = ctx.density_operands(params.particle_mass)
    assert dargs[0].data_ptr() == dargs[1].data_ptr()
    cuda_sweep.reset_launches()
    dens = SP.density_sweep(cfg, *dargs)
    ref = SP.density_sweep_plain(cfg, *dargs)
    torch.testing.assert_close(dens, ref, rtol=1e-5, atol=0)
    fargs = ctx.force_operands(vel, dens, tait_pd2(dens, params))
    assert (fargs[0] is fargs[1]) == (not with_boundary)
    f = SP.fluid_force_sweep(cfg, *fargs)
    f_ref = SP.fluid_force_sweep_plain(cfg, *fargs)
    torch.cuda.synchronize()
    assert ([k.launches for k in cuda_sweep.KERNELS]
            == [1, 1] + [0] * (N_KERNELS - 2))
    assert torch.isfinite(f).all()
    err = float((f - f_ref).abs().max())
    assert err <= 1e-4 * float(f_ref.abs().max()), err


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set,st", MODELS[:2])
def test_lane_groups_match_plain_on_cuda(cuda, kernel_set, st, large,
                                         monkeypatch):
    """At each lane-group size G the wrappers choose (``SMALL_N`` and
    ``SMALL_SHELL`` set so that the small scene takes the G of a large one
    and the box's shell that of a small one when ``large``, and the other
    way round when not): the density kernel on the small dam-break's one
    matrix and on a body shell's ``x y z ψ_b`` rows, and every force
    instance (pressure and viscosity each on and off, static and moving
    walls), and the IISPH Jacobi loop's SumDij and Jacobi on the step's
    operand builders, against their plain versions: density rtol 1e-5,
    the others max|Δ| ≤ 1e-4·max|ref| per column."""
    monkeypatch.setattr(cuda_sweep, "SMALL_N", 0 if large else 2 ** 31)
    monkeypatch.setattr(cuda_sweep, "SMALL_SHELL", 2 ** 31 if large else 0)
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import coupled_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, st, True, cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    for walls in (boundary, moving):
        ctx = build_sweep_ctx(state, params, grid, cfg, walls)
        dargs = ctx.density_operands(params.particle_mass)
        dens = cuda_sweep.density_sweep(cfg, *dargs)
        torch.testing.assert_close(dens, SP.density_sweep_plain(cfg, *dargs),
                                   rtol=1e-5, atol=0)
        fargs = ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens,
                                   tait_pd2(dens, params))
        for p in (True, False):
            for v in (True, False):
                kw = dict(include_pressure=p, include_viscosity=v,
                          moving_boundary=walls is moving)
                _assert_columns_close(
                    cuda_sweep.force_sweep(cfg, *fargs, **kw),
                    SP.fluid_force_sweep_plain(cfg, *fargs, **kw),
                    f"force G={cuda_sweep.force_group(len(fargs[0]), v)} "
                    f"{kw}")
    # the IISPH Jacobi loop's two kernels on the step's operand builders,
    # at a seeded pressure and d_ii standing in for Σd_ij·p_j
    from nereus_tpu_torch.solvers import iisph_cuda
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    inv_d2 = 1.0 / dens.clamp(min=1e-12) ** 2
    p = torch.from_numpy(np.random.default_rng(1).uniform(
        0.0, 2000.0, ctx.c).astype(np.float32)).to(cuda)
    sargs = iisph_cuda.sum_dij_operands(ctx, inv_d2)(p)
    sd = SP.sum_dij_sweep_plain(cfg, *sargs)
    _assert_columns_close(cuda_sweep.sum_dij_sweep(cfg, *sargs), sd,
                          f"sum_dij G={cuda_sweep.SUM_DIJ_G}")
    dii = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1) * 1e-3
    jargs = iisph_cuda.jacobi_operands(
        ctx, dii, params.particle_mass * inv_d2)[0](p, sd)
    _assert_columns_close(cuda_sweep.jacobi_sweep(cfg, *jargs),
                          SP.jacobi_sweep_plain(cfg, *jargs),
                          f"jacobi G={cuda_sweep.JACOBI_G}")
    box = nereus_tpu_torch.make_rigid_box(
        state.pos.mean(dim=0).cpu().numpy(), (0.08,) * 3,
        float(params.particle_radius), 500.0, params, device=cuda)
    (sh,) = coupled_cuda.body_shells(ctx, grid, (box,))
    bargs = (dargs[0], sh.src4, sh.seg_start, sh.seg_end, ctx.pvec)
    got = cuda_sweep.body_density_sweep(cfg, *bargs)
    ref = SP.density_sweep_plain(cfg, *bargs)
    assert float(ref.max()) > 0.0
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    torch.cuda.synchronize()


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
        cuda_sweep.density_sweep(cfg, q, src, s, e, pv)
    np.testing.assert_array_equal(
        cuda_sweep.density_sweep(cfg, q, src[:, :4].contiguous(), s, e,
                                 pv).cpu().numpy(),
        np.zeros(8, np.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_iisph_kernels_match_plain_on_cuda(cuda, kernel_set):
    """Each IISPH kernel and the pressure-off force kernel against its
    plain version on the operands of one IISPH step whose warm start
    carries a real pressure: max|Δ| ≤ 1e-4·max|ref| per output column
    (FMA contraction, rsqrtf, the plain version's atomic order)."""
    from nereus_tpu_torch.solvers import iisph_cuda
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set])
    base = nereus_tpu_torch.iisph_params(dt=5e-4, device=cuda)
    spacing = float(base.interaction_radius) - 0.005
    params = nereus_tpu_torch.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, boundary = scene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.115, 0.0), box_max=(0.2, 0.7, 1.0),
        boundary_radius=0.04, device=cuda)
    pos = state.pos.cpu().numpy()
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    state = nereus_tpu_torch.make_fluid_state(pos, vel, device=cuda)
    state, _ = nereus_tpu_torch.iisph_step(state, params, grid, cfg,
                                           boundary)
    assert float(state.pressure.max()) > 0.0
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    rows = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    zero = torch.zeros_like(ctx.px)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm = params.particle_mass
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(pm))
    inv_d2 = 1.0 / dens.clamp(min=1e-12) ** 2
    p = 0.5 * ctx.pres_prev
    dii3 = torch.stack(vel, dim=1) * 1e-3
    # v_adv: the state's v nudged, so the fluid and wall pairs read apart
    vel_adv = tuple(v + 0.1 * float(k + 1) for k, v in enumerate(vel))
    cases = {
        # the step's operand builders, d_ii standing in for Σd_ij·p_j
        "dii_aii": iisph_cuda.dii_aii_operands(ctx, vel_adv, pm, inv_d2),
        "sum_dij": iisph_cuda.sum_dij_operands(ctx, inv_d2)(p),
        "jacobi": iisph_cuda.jacobi_operands(ctx, dii3, pm * inv_d2)[0](
            p, dii3),
        "pressure_force": (ctx.queries(p * inv_d2),
                           ctx.pack((zero, zero, zero), p * inv_d2), *rows),
    }
    plain = {"dii_aii": SP.dii_aii_sweep_plain,
             "sum_dij": SP.sum_dij_sweep_plain,
             "jacobi": SP.jacobi_sweep_plain,
             "pressure_force": SP.pressure_force_sweep_plain}
    cuda_sweep.reset_launches()
    for key, args in cases.items():
        kw = {"plan": ctx.tile_plan} if key == "pressure_force" else {}
        got = IISPH_SWEEPS[key][0](cfg, *args, **kw)
        ref = plain[key](cfg, *args)
        _assert_columns_close(got, ref, key)
    fargs = ctx.force_operands(vel, dens, zero)
    got = SP.fluid_force_sweep(cfg, *fargs, include_pressure=False)
    _assert_columns_close(
        got, SP.fluid_force_sweep_plain(cfg, *fargs, include_pressure=False),
        "force_p0")
    torch.cuda.synchronize()
    _assert_launches({k: 1 for k in (
        cuda_sweep.FORCE_P0, cuda_sweep.DII_AII, cuda_sweep.SUM_DIJ,
        cuda_sweep.JACOBI, cuda_sweep.PRESSURE_FORCE)})
    assert iisph_cuda.SYNC_EVERY >= 1


def _assert_columns_close(got, ref, key):
    g, r = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    assert torch.isfinite(g).all(), key
    err = (g - r).abs().amax(dim=0)
    scale = r.abs().amax(dim=0)
    assert bool((scale > 0).all()), (key, scale)
    assert bool((err <= 1e-4 * scale).all()), (key, err, scale)


@pytest.mark.requires_cuda
def test_iisph_step_runs_kernels_on_cuda(cuda):
    """A few IISPH steps of the settled block on the card: every IISPH
    kernel launched, Σd_ij·p_j and Jacobi once per launched iteration."""
    from nereus_tpu_torch.solvers import iisph_cuda
    cfg = nereus_tpu_torch.SimConfig()
    base = nereus_tpu_torch.iisph_params(device=cuda)
    spacing = 0.8 * float(base.interaction_radius)
    params = nereus_tpu_torch.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=4000, spacing=spacing, impact_velocity=-1.0,
        device=cuda)
    cuda_sweep.reset_launches()
    iisph_cuda.LOOP.reset()
    iters = 0
    for _ in range(3):
        state, diag = nereus_tpu_torch.iisph_step(state, params, grid, cfg,
                                                  boundary)
        iters += int(diag.solver_iters)
    assert iters > 3 * cfg.iisph_min_iters
    launched = iisph_cuda.LOOP.launched
    assert launched >= iters
    _assert_launches({cuda_sweep.DENSITY: 3, cuda_sweep.FORCE_P0: 3,
                      cuda_sweep.DII_AII: 3, cuda_sweep.PRESSURE_FORCE: 3,
                      cuda_sweep.SUM_DIJ: launched,
                      cuda_sweep.JACOBI: launched})
    assert torch.isfinite(state.pos).all()
    assert float(state.pressure.min()) >= 0.0


def _settled_block(params_fn, cuda, n_target=4000):
    """The settled block of the PCISPH and DFSPH main paths at a small
    size: mass calibrated to the 0.8·h lattice, impact velocity −1 m/s."""
    cfg = nereus_tpu_torch.SimConfig()
    base = params_fn(device=cuda)
    spacing = 0.8 * float(base.interaction_radius)
    params = nereus_tpu_torch.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=n_target, spacing=spacing,
        impact_velocity=-1.0, device=cuda)
    return cfg, params, state, grid, boundary


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_pcisph_dfsph_kernels_match_plain_on_cuda(cuda, kernel_set):
    """The predicted-density kernel, DFSPH's density and α kernel in both
    forms ((ρ, α) and ρ with α's sums, on the density's one matrix) and
    the Dρ/Dt kernel against their plain versions on the small dam-break
    after one real DFSPH step, with x* moved up to 0.3·h: max|Δ| ≤
    1e-4·max|ref| per output column; the fused ρ equals the density
    kernel's at the same G, bit for bit."""
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set])
    base = nereus_tpu_torch.dfsph_params(dt=5e-4, device=cuda)
    spacing = float(base.interaction_radius) - 0.005
    params = nereus_tpu_torch.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, boundary = scene.dam_break(
        params, cfg, cube_size=(0.25,) * 3, cube_center=(-0.3, 0.05, 0.5),
        box_min=(-0.8, -0.115, 0.0), box_max=(0.2, 0.7, 1.0),
        boundary_radius=0.04, device=cuda)
    pos = state.pos.cpu().numpy()
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    state = nereus_tpu_torch.make_fluid_state(pos, vel, device=cuda)
    state, _ = nereus_tpu_torch.dfsph_step(state, params, grid, cfg,
                                           boundary)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    rows = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm = params.particle_mass
    shift = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.3, 0.3, (ctx.c, 3))).float().to(cuda) * params.interaction_radius
    x = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1) + shift
    cases = {
        "predicted_density":
            pcisph_cuda.predicted_density_operands(ctx, pm)(x),
        "alpha": ctx.density_operands(pm),
        "alpha_sums": ctx.density_operands(pm),
        "drho": (ctx.queries(*vel, width=8), ctx.pack(vel, pm), *rows),
    }
    plain = {"predicted_density": SP.density_sweep_plain,
             "alpha": SP.density_alpha_sweep_plain,
             "alpha_sums": SP.density_alpha_sums_sweep_plain,
             "drho": SP.drho_sweep_plain}
    cuda_sweep.reset_launches()
    got = {}
    for key, args in cases.items():
        got[key] = PCISPH_DFSPH_SWEEPS[key][0](cfg, *args)
        _assert_columns_close(got[key], plain[key](cfg, *args), key)
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.DENSITY_PRED: 1,
                      cuda_sweep.DENSITY_ALPHA: 1,
                      cuda_sweep.DENSITY_ALPHA_SUMS: 1, cuda_sweep.DRHO: 1})
    assert (cuda_sweep.density_group(ctx.c) == cuda_sweep.DENSITY_ALPHA_G)
    dens = cuda_sweep.density_sweep(cfg, *cases["alpha"])
    assert torch.equal(got["alpha"][:, 0], dens)
    assert torch.equal(got["alpha_sums"][:, 0], dens)
    assert all(got[k].t().is_contiguous() for k in ("alpha", "alpha_sums"))


@pytest.mark.requires_cuda
def test_pcisph_dfsph_steps_run_kernels_on_cuda(cuda):
    """A few PCISPH and DFSPH steps of the settled block on the card:
    every kernel of each path launched as often as its loops say."""
    from nereus_tpu_torch.solvers import dfsph_cuda
    cfg, params, state, grid, boundary = _settled_block(
        nereus_tpu_torch.pcisph_params, cuda)
    delta = nereus_tpu_torch.pcisph_delta(params, cfg)
    cuda_sweep.reset_launches()
    pcisph_cuda.LOOP.reset()
    iters = 0
    for _ in range(3):
        state, diag = nereus_tpu_torch.pcisph_step(
            state, params, grid, cfg, boundary, delta=delta, tol_frac=0.001)
        iters += int(diag.solver_iters)
    launched = pcisph_cuda.LOOP.launched
    assert launched >= iters > 3 * cfg.pcisph_min_iters
    _assert_launches({cuda_sweep.DENSITY: 3, cuda_sweep.FORCE_P0: 3,
                      cuda_sweep.PRESSURE_FORCE: launched + 3,
                      cuda_sweep.DENSITY_PRED: launched})
    assert torch.isfinite(state.pos).all()
    assert float(state.pressure.min()) >= 0.0

    cfg, params, state, grid, boundary = _settled_block(
        nereus_tpu_torch.dfsph_params, cuda)
    cuda_sweep.reset_launches()
    dfsph_cuda.LOOP.reset()
    dfsph_cuda.LOOP_V.reset()
    iters = 0
    for _ in range(3):
        state, diag = nereus_tpu_torch.dfsph_step(state, params, grid, cfg,
                                                  boundary)
        iters += int(diag.solver_iters)
    launched = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
    assert launched >= iters > 3 * (cfg.dfsph_min_iters
                                    + cfg.dfsph_min_iters_v)
    _assert_launches({cuda_sweep.DENSITY_ALPHA: 3, cuda_sweep.FORCE_P0: 3,
                      cuda_sweep.PRESSURE_FORCE: launched + 3,
                      cuda_sweep.DRHO: launched})
    assert torch.isfinite(state.pos).all()
    assert float(state.pressure.min()) >= 0.0


def _two_phase(state, params, device):
    """``state`` split as ``bench.py``'s ``multiphase_1M`` splits it: the
    top half of the fluid by y at 0.3·ρ₀, mass ρ0_i/ρ₀ of the calibrated
    mass."""
    pos = state.pos.cpu().numpy()
    rd = float(params.rest_density)
    rho0 = np.where(pos[:, 1] >= np.quantile(pos[:, 1], 0.5), 0.3 * rd, rd)
    return nereus_tpu_torch.make_fluid_state(
        pos, state.vel.cpu().numpy(),
        masses=rho0 * float(params.particle_mass) / rd, rest_densities=rho0,
        device=device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
@pytest.mark.parametrize("st", ["NONE", "BECKER"])
def test_multiphase_xsph_kernels_match_plain_on_cuda(cuda, kernel_set, st):
    """The multiphase density and force kernels on the operands of the
    first two-phase step of the small dam-break (st_cross 0.25), and the
    XSPH kernel on the first single-phase step's, against their plain
    versions: max|Δ| ≤ 1e-4·max|ref| per output column."""
    from nereus_tpu_torch.solvers import wcsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, st, True, cuda)
    cfg = dataclasses.replace(cfg, st_cross=0.25)
    ctx = build_sweep_ctx(_two_phase(state, params, cuda), params, grid,
                          cfg, boundary)
    dargs = wcsph_cuda.multiphase_density_operands(ctx)
    dout = SP.multiphase_density_sweep_plain(cfg, *dargs)
    fargs, _, _ = wcsph_cuda.multiphase_force_operands(ctx, params, dout)
    ctx1 = build_sweep_ctx(state, params, grid, cfg, boundary)
    dens = SP.density_sweep_plain(cfg, *ctx1.density_operands(
        params.particle_mass))
    xargs = wcsph_cuda.xsph_operands(ctx1, (ctx1.vx, ctx1.vy, ctx1.vz),
                                     dens)
    cuda_sweep.reset_launches()
    for key, args in (("multiphase_density", dargs),
                      ("multiphase_force", fargs), ("xsph", xargs)):
        dispatch = MULTIPHASE_XSPH_SWEEPS[key][0]
        plain = getattr(SP, f"{key}_sweep_plain")
        _assert_columns_close(dispatch(cfg, *args), plain(cfg, *args), key)
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.MP_DENSITY: 1, cuda_sweep.MP_FORCE: 1,
                      cuda_sweep.XSPH: 1})


@pytest.mark.requires_cuda
def test_multiphase_xsph_steps_run_kernels_on_cuda(cuda):
    """A few multiphase steps launch the multiphase density and force
    kernels once per step and nothing else; a few XSPH steps launch the
    density, force and XSPH kernels once per step."""
    cfg, params, state, grid, boundary = _scene("MULLER", "BECKER", True,
                                                cuda)
    mp = _two_phase(state, params, cuda)
    cuda_sweep.reset_launches()
    for _ in range(3):
        mp, diag = nereus_tpu_torch.wcsph_step(mp, params, grid, cfg,
                                               boundary)
    _assert_launches({cuda_sweep.MP_DENSITY: 3, cuda_sweep.MP_FORCE: 3})
    assert torch.isfinite(mp.pos).all() and mp.multiphase
    assert float(diag.mean_compression) < 0.1
    cuda_sweep.reset_launches()
    for _ in range(3):
        state, _ = nereus_tpu_torch.wcsph_step(state, params, grid, cfg,
                                               boundary, xsph_eps=0.3)
    _assert_launches({cuda_sweep.DENSITY: 3, cuda_sweep.FORCE: 3,
                      cuda_sweep.XSPH: 3})
    assert torch.isfinite(state.pos).all()


def _assert_launches(want):
    """Every kernel launched as ``want`` (``{Kernel: count}``) says, the
    others never."""
    assert ({k.name: k.launches for k in cuda_sweep.KERNELS}
            == {k.name: want.get(k, 0) for k in cuda_sweep.KERNELS})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_visc_mp_dfsph_kernels_match_plain_on_cuda(cuda, kernel_set):
    """The two force instances without viscosity and the Laplacian on the
    first-step operands of the small dam-break, and the three multiphase
    DFSPH kernels on those of its two-phase split (κ a positive stand-in),
    against their plain versions: max|Δ| ≤ 1e-4·max|ref| per output
    column."""
    from nereus_tpu_torch.solvers import dfsph_cuda, viscosity, wcsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, "BECKER", True,
                                                cuda)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    rows = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    fargs = ctx.force_operands(vel, dens, tait_pd2(dens, params))
    mp = build_sweep_ctx(_two_phase(state, params, cuda), params, grid, cfg,
                         boundary)
    dout = SP.multiphase_density_sweep_plain(
        cfg, *wcsph_cuda.multiphase_density_operands(mp))
    mp_dens = mp.mass * dout[:, 0] + (mp.rho0 / params.rest_density) \
        * dout[:, 1]
    sweeps = dfsph_cuda.MultiphaseKappaSweeps(mp, params, cfg, mp_dens)
    cases = {
        "visc_laplacian": viscosity.laplacian_operands(ctx, params, dens)(
            torch.stack(vel, dim=1)),
        "multiphase_density_alpha": dfsph_cuda.multiphase_alpha_operands(
            mp),
        "multiphase_drho": sweeps.drho_operands(
            torch.stack([mp.vx, mp.vy, mp.vz], dim=1)),
        "multiphase_kappa": sweeps.kappa_operands(
            1e3 * (mp.px.abs() + 0.5)),
    }
    cuda_sweep.reset_launches()
    for key, args in cases.items():
        dispatch = VISC_MP_DFSPH_SWEEPS[key][0]
        plain = getattr(SP, f"{key}_sweep_plain")
        kw = {"plan": ctx.tile_plan} if key == "visc_laplacian" else {}
        _assert_columns_close(dispatch(cfg, *args, **kw), plain(cfg, *args),
                              key)
    for p in (True, False):
        kw = dict(include_pressure=p, include_viscosity=False)
        _assert_columns_close(SP.fluid_force_sweep(cfg, *fargs, **kw),
                              SP.fluid_force_sweep_plain(cfg, *fargs, **kw),
                              f"force pressure={p} visc=0")
    torch.cuda.synchronize()
    _assert_launches({k: 1 for k in (
        cuda_sweep.FORCE_V0, cuda_sweep.FORCE_P0_V0,
        cuda_sweep.VISC_LAPLACIAN, cuda_sweep.MP_DENSITY_ALPHA,
        cuda_sweep.MP_DRHO, cuda_sweep.MP_KAPPA)})


@pytest.mark.requires_cuda
def test_visc_mp_dfsph_steps_run_kernels_on_cuda(cuda):
    """A few steps of the settled block on the card: DFSPH and WCSPH with
    the implicit viscosity solve (the Laplacian once per launched CG
    iteration plus once for r0, the force instances without viscosity)
    and multiphase DFSPH (its kernels as often as its loops say, none of
    the single-phase DFSPH kernels)."""
    from nereus_tpu_torch.solvers import dfsph_cuda, viscosity
    cfg, params, state, grid, boundary = _settled_block(
        lambda device: nereus_tpu_torch.dfsph_params(viscosity=5.0,
                                                     device=device), cuda)
    implicit = dataclasses.replace(cfg, viscosity_model="implicit")
    for loop in (dfsph_cuda.LOOP, dfsph_cuda.LOOP_V, viscosity.LOOP):
        loop.reset()
    cuda_sweep.reset_launches()
    s = state
    for _ in range(3):
        s, _ = nereus_tpu_torch.dfsph_step(s, params, grid, implicit,
                                           boundary)
    launched = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
    cg = viscosity.LOOP.launched
    assert cg >= 3 and int(viscosity.LOOP.last.it) > 0
    _assert_launches({cuda_sweep.DENSITY_ALPHA: 3,
                      cuda_sweep.FORCE_P0_V0: 3, cuda_sweep.DRHO: launched,
                      cuda_sweep.PRESSURE_FORCE: launched + 3,
                      cuda_sweep.VISC_LAPLACIAN: cg + 3})
    assert torch.isfinite(s.pos).all()

    viscosity.LOOP.reset()
    cuda_sweep.reset_launches()
    s = state
    for _ in range(3):
        s, _ = nereus_tpu_torch.wcsph_step(s, params, grid, implicit,
                                           boundary)
    _assert_launches({cuda_sweep.DENSITY: 3, cuda_sweep.FORCE_V0: 3,
                      cuda_sweep.VISC_LAPLACIAN: viscosity.LOOP.launched + 3})
    assert torch.isfinite(s.pos).all()

    for loop in (dfsph_cuda.LOOP, dfsph_cuda.LOOP_V):
        loop.reset()
    cuda_sweep.reset_launches()
    s = _two_phase(state, params, cuda)
    for _ in range(3):
        s, _ = nereus_tpu_torch.dfsph_step(s, params, grid, cfg, boundary)
    launched = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
    _assert_launches({cuda_sweep.MP_DENSITY_ALPHA: 3,
                      cuda_sweep.MP_FORCE: 3, cuda_sweep.MP_DRHO: launched,
                      cuda_sweep.MP_KAPPA: launched + 3})
    assert torch.isfinite(s.pos).all() and s.multiphase
    assert float(s.pressure.min()) >= 0.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_tiled_kernels_match_plain_on_cuda(cuda, kernel_set):
    """The row-tiled ViscLaplacian and PressureForce against their plain
    versions (max|Δ| ≤ 1e-4·max|ref| per output column) on the small
    dam-break with 40 parked slots, its walls moving at (0.8, 0, −0.4) m/s
    (the Laplacian's wall rows read the wall velocity) and its floor in
    support, under plans whose tiles end at cell-row boundaries (T = 32,
    64, 128, 256), and over the fluid rows alone (9 range rows, no wall
    phase): every plan gives the same bits, parked slots get exactly 0."""
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import viscosity
    from nereus_tpu_torch.solvers.sweep_common import pd2_operands
    cfg, params, state, grid, boundary = _scene(kernel_set, "BECKER", True,
                                                cuda)
    n = int(state.num_active)
    state = nereus_tpu_torch.make_fluid_state(
        state.pos.cpu().numpy(), state.vel.cpu().numpy(), capacity=n + 40,
        device=cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    ctx = build_sweep_ctx(state, params, grid, cfg, moving)
    vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    dens = torch.where(ctx.active, dens, torch.ones_like(dens))
    p = torch.where(ctx.active, 1e3 * (ctx.px.abs() + 0.5),
                    torch.zeros_like(dens))
    cases = {
        "visc_laplacian": (cuda_sweep.visc_laplacian_sweep,
                           SP.visc_laplacian_sweep_plain,
                           viscosity.laplacian_operands(ctx, params,
                                                        dens)(vel)),
        "pressure_force": (cuda_sweep.pressure_force_sweep,
                           SP.pressure_force_sweep_plain,
                           pd2_operands(ctx)(p / (dens * dens)))}
    cuda_sweep.reset_launches()
    runs = 0
    for key, (kern, plain, args) in cases.items():
        q, src, s, e, pv = args
        for rows in (18, 9):
            rs, re_ = s[:rows].contiguous(), e[:rows].contiguous()
            ref = plain(cfg, q, src, rs, re_, pv)
            first = None
            for tile in (64, 32, 128, 256):
                plan = cuda_sweep.tile_plan(ctx.sorted_hash, ctx.grid_size,
                                            tile=tile)
                got = kern(cfg, q, src, rs, re_, pv, plan=plan)
                torch.cuda.synchronize()
                runs += 1
                _assert_columns_close(got[:n], ref[:n], f"{key} {rows}")
                assert int(got[n:].abs().sum()) == 0, key
                first = got if first is None else first
                assert torch.equal(got, first), (key, rows, tile)
    _assert_launches({cuda_sweep.VISC_LAPLACIAN: runs // 2,
                      cuda_sweep.PRESSURE_FORCE: runs // 2})
    with pytest.raises(ValueError, match="TilePlan"):
        cuda_sweep.pressure_force_sweep(cfg, *cases["pressure_force"][2])


def _pbf_block(cuda, kernel_set="MULLER", n_target=4000):
    """The settled block of the ``pbf_256k_settled`` path at a small size:
    PBF parameters calibrated twice, as ``bench.py`` calibrates them, the
    second time to the 0.8·h lattice; impact velocity −1 m/s, so λ is
    non-zero from the first iteration. Under Monaghan kernels the block is
    seeded at 0.7·h: calibrate_mass sums that lattice out to the 2h
    support while the sweeps cut at h, so at 0.8·h it sits at 0.58·ρ₀."""
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set])
    base = nereus_tpu_torch.calibrate_mass(
        nereus_tpu_torch.pbf_params(device=cuda), cfg)
    h = float(base.interaction_radius)
    params = nereus_tpu_torch.calibrate_mass(base, cfg, spacing=0.8 * h)
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=n_target,
        spacing=(0.8 if kernel_set == "MULLER" else 0.7) * h,
        impact_velocity=-1.0, device=cuda)
    return cfg, params, state, grid, boundary


def _assert_lambda_close(got, ref, pvec, key):
    """(ρ, λ) (N, 2) of the λ kernel against its plain version: ρ within
    rtol 1e-5 (the density kernel's), λ within 1e-4·max|λ| plus what the
    two ρ's difference and two float32 ulps of ρ/ρ₀ make of it (λ =
    −max(ρ/ρ₀ − 1, 0)/(denom + ε) resolves ρ/ρ₀ to its ulp, over ε), and
    λ < 0 somewhere."""
    rd, eps = float(pvec[SP.PV_RD]), float(pvec[SP.PV_PBF_EPS])
    torch.testing.assert_close(got[:, 0], ref[:, 0], rtol=1e-5, atol=0,
                               msg=key)
    floor = ((got[:, 0] - ref[:, 0]).abs()
             + 2.0 * float(np.finfo(np.float32).eps) * ref[:, 0]) / rd / eps
    err = (got[:, 1] - ref[:, 1]).abs()
    scale = float(ref[:, 1].abs().max())
    assert float(ref[:, 1].min()) < 0.0, key
    assert bool((err <= 1e-4 * scale + floor).all()), (key, float(err.max()),
                                                       scale)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_pbf_kernels_match_plain_on_cuda(cuda, kernel_set, large,
                                         monkeypatch):
    """The λ, Δp, ω and N kernels against their plain versions on the
    first PBF step's operands of the small settled block, built by the
    step's own operand functions, with seeded velocities for ω, at each
    lane-group size G the wrappers choose (``SMALL_N`` set so that the
    small block takes the G of a large one when ``large``): (ρ, λ) as
    :func:`_assert_lambda_close`, the others max|Δ| ≤ 1e-4·max|ref| per
    output column."""
    from nereus_tpu_torch.solvers import pbf_cuda
    monkeypatch.setattr(cuda_sweep, "SMALL_N", 0 if large else 2 ** 31)
    cfg, params, state, grid, boundary = _pbf_block(cuda, kernel_set)
    ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                          cfg, boundary)
    x = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    lam_at, dp_at = pbf_cuda.pbf_operands(ctx, params.particle_mass)
    largs = tuple(t.clone() for t in lam_at(x))
    dens, lam = SP.pbf_lambda_sweep_plain(cfg, *largs).unbind(1)
    dargs = dp_at(lam)
    vel = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (ctx.c, 3))).float().to(cuda)
    v = vel.unbind(1)
    mrho = params.particle_mass / dens.clamp(min=1e-12)
    oargs = pbf_cuda.omega_operands(ctx, v, mrho)
    om = SP.pbf_omega_sweep_plain(cfg, *oargs)
    nargs = pbf_cuda.grad_operands(ctx, mrho * om.norm(dim=1))
    cuda_sweep.reset_launches()
    _assert_lambda_close(SP.pbf_lambda_sweep(cfg, *largs),
                         SP.pbf_lambda_sweep_plain(cfg, *largs), ctx.pvec,
                         f"pbf_lambda G={cuda_sweep.PBF_LAMBDA_G}")
    _assert_columns_close(SP.pbf_dp_sweep(cfg, *dargs),
                          SP.pbf_dp_sweep_plain(cfg, *dargs),
                          f"pbf_dp G={cuda_sweep.pbf_dp_group(ctx.c)}")
    _assert_columns_close(SP.pbf_omega_sweep(cfg, *oargs), om, "pbf_omega")
    _assert_columns_close(SP.pbf_grad_sweep(cfg, *nargs)[:, :4],
                          SP.pbf_grad_sweep_plain(cfg, *nargs)[:, :4],
                          f"pbf_grad G={cuda_sweep.PBF_GRAD_G}")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.PBF_LAMBDA: 1, cuda_sweep.PBF_DP: 1,
                      cuda_sweep.PBF_OMEGA: 1, cuda_sweep.PBF_GRAD: 1})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_xsph_omega_groups_match_plain_on_cuda(cuda, kernel_set, large):
    """The XSPH and ω kernels at the lane-group sizes built for them
    (``XSPH_G``, ``PBF_OMEGA_G``), each on its one (C, 8) matrix built by
    the steps' own operand functions (the query and the source at once),
    on the settled PBF block at 4,000 queries and, when ``large``, at
    2¹⁹ or more, with seeded velocities in ±0.5 m/s (so that the sums are
    not zero) and ρ from the plain density, against their plain versions:
    max|Δ| ≤ 1e-4·max|ref| per column (``chip_smoke.FORCE_TOL``)."""
    from nereus_tpu_torch.solvers import pbf_cuda, wcsph_cuda
    cfg, params, state, grid, boundary = _pbf_block(
        cuda, kernel_set, n_target=600_000 if large else 4000)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    assert (ctx.c >= 2 ** 19) == large, ctx.c
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    v = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (ctx.c, 3)).astype(np.float32)).to(cuda).unbind(1)
    xargs = wcsph_cuda.xsph_operands(ctx, v, dens)
    oargs = pbf_cuda.omega_operands(
        ctx, v, params.particle_mass / dens.clamp(min=1e-12))
    assert xargs[0] is xargs[1] and oargs[0] is oargs[1]
    cuda_sweep.reset_launches()
    _assert_columns_close(cuda_sweep.xsph_sweep(cfg, *xargs),
                          SP.xsph_sweep_plain(cfg, *xargs),
                          f"xsph n={ctx.c} G={cuda_sweep.XSPH_G}")
    _assert_columns_close(cuda_sweep.pbf_omega_sweep(cfg, *oargs),
                          SP.pbf_omega_sweep_plain(cfg, *oargs),
                          f"pbf_omega n={ctx.c} G={cuda_sweep.PBF_OMEGA_G}")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.XSPH: 1, cuda_sweep.PBF_OMEGA: 1})


@pytest.mark.requires_cuda
def test_group_sweeps_build_only_their_g(cuda):
    """Each entry point of the lane-group engine launches at the G its
    wrapper can pick (below and above ``SMALL_N`` queries, ``SMALL_SHELL``
    shell samples or ``SMALL_BODY`` body samples) and returns −1 for any
    other group value, launching nothing."""
    lib = cuda_sweep.load()
    picks = {
        "dii_aii": {cuda_sweep.DII_AII_G},
        "sum_dij": {cuda_sweep.SUM_DIJ_G},
        "jacobi": {cuda_sweep.JACOBI_G},
        "pbf_lambda": {cuda_sweep.PBF_LAMBDA_G},
        "pbf_dp": {cuda_sweep.pbf_dp_group(1),
                   cuda_sweep.pbf_dp_group(cuda_sweep.SMALL_N)},
        "pbf_grad": {cuda_sweep.PBF_GRAD_G},
        "pbf_omega": {cuda_sweep.PBF_OMEGA_G},
        "xsph": {cuda_sweep.XSPH_G},
        "drho": {cuda_sweep.DRHO_G},
        "density_alpha": {cuda_sweep.DENSITY_ALPHA_G},
        "density_alpha_sums": {cuda_sweep.DENSITY_ALPHA_G},
        "multiphase_density": {cuda_sweep.density_group(1),
                               cuda_sweep.density_group(cuda_sweep.SMALL_N)},
        "multiphase_drho": {cuda_sweep.MP_DRHO_G},
        "multiphase_density_alpha": {cuda_sweep.MP_DENSITY_ALPHA_G},
        # the κ impulse forward, Dρ/Dt and the body contact force (both
        # forms) over a shell by its size, the reverse κ impulse at one G
        **{fn: {cuda_sweep.shell_group(1),
                cuda_sweep.shell_group(cuda_sweep.SMALL_SHELL)}
           for fn in ("pressure_force_body", "drho_shell", "body_force",
                      "body_force_p0", "body_density_alpha",
                      "body_density_alpha_sq", "multiphase_kappa_body")},
        "pressure_force_body_rev": {cuda_sweep.BODY_REV_G},
        # the multiphase force's four instances (st_model, moving)
        **{("multiphase_force", st, m): {
            cuda_sweep.mp_force_group(1, bool(m)),
            cuda_sweep.mp_force_group(cuda_sweep.SMALL_N, bool(m))}
           for st in (0, 1) for m in (0, 1)},
        # the list form: the two elastic kernels over the body's pair list
        **{f"{fn}_list": {cuda_sweep.elastic_group(1),
                          cuda_sweep.elastic_group(cuda_sweep.SMALL_BODY)}
           for fn in ("elastic_f", "elastic_force_hourglass")}}
    n = 8
    q = torch.zeros((n, 24), device=cuda)
    seg = torch.zeros((18, n), dtype=torch.int32, device=cuda)
    pv = _sweep_inputs("pbf_lambda", device=cuda)[4]
    out = torch.zeros((n, 16), device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ks = nereus_tpu_torch.KernelSet.MULLER.value
    for fn, want in picks.items():
        rows = 9 if fn in ("sum_dij", "pbf_grad", "pbf_omega", "xsph",
                           "pressure_force_body", "pressure_force_body_rev",
                           "drho_shell", "body_force", "body_force_p0",
                           "body_density_alpha", "body_density_alpha_sq",
                           "multiphase_kappa_body") else 18
        built = set()
        for g in (1, 2, 4, 8, 16, 32, 3):
            if isinstance(fn, tuple):
                rc = lib.nereus_multiphase_force_sweep(
                    q.data_ptr(), q.data_ptr(), seg.data_ptr(),
                    seg.data_ptr(), n, rows, pv.data_ptr(), ks, *fn[1:], g,
                    out.data_ptr(), stream)
            elif fn.endswith("_list"):
                # an empty list: nbr_start all 0
                rc = getattr(lib, f"nereus_{fn}_sweep")(
                    q.data_ptr(), q.data_ptr(), seg.data_ptr(),
                    seg.data_ptr(), n, pv.data_ptr(), ks, g, out.data_ptr(),
                    stream)
            else:
                rc = getattr(lib, f"nereus_{fn}_sweep")(
                    q.data_ptr(), q.data_ptr(), seg.data_ptr(),
                    seg.data_ptr(), n, rows, pv.data_ptr(), ks, g,
                    out.data_ptr(), stream)
            assert rc in (0, -1), (fn, g, rc)
            if rc == 0:
                built.add(g)
        assert built == want, (fn, built, want)
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_pbf_steps_run_kernels_on_cuda(cuda):
    """A few PBF steps of the small settled block launch the λ and Δp
    kernels ``pbf_iters`` times each per step and nothing else; with
    vorticity confinement and XSPH one N, one ω and one XSPH launch per
    step."""
    cfg, params, state, grid, boundary = _pbf_block(cuda)
    it = cfg.pbf_iters
    for kw, extra in (({}, {}),
                      (dict(xsph_eps=0.02, vorticity_eps=0.01),
                       {cuda_sweep.PBF_OMEGA: 3, cuda_sweep.PBF_GRAD: 3,
                        cuda_sweep.XSPH: 3})):
        cuda_sweep.reset_launches()
        s = state
        for _ in range(3):
            s, diag = nereus_tpu_torch.pbf_step(s, params, grid, cfg,
                                                boundary, **kw)
        _assert_launches({cuda_sweep.PBF_LAMBDA: 3 * it,
                          cuda_sweep.PBF_DP: 3 * it, **extra})
        assert torch.isfinite(s.pos).all()
        assert int(diag.solver_iters) == it
        assert float(s.pressure.max()) <= 0.0


WALL_VEL = (0.8, 0.0, -0.4)


def _friction_args(args, zero_col, pv_beta0=False):
    """``args`` (q, src, seg_start, seg_end, pvec) of a wall sweep with the
    fluid ranges emptied, query column ``zero_col`` at 0 (pd2, or 1/m_i for
    the multiphase sweep) and, with ``pv_beta0``, β at 0: the wall friction
    alone."""
    q, src, s, e, pv = args
    q = q.clone()
    q[:, zero_col] = 0.0
    e = e.clone()
    e[:9] = s[:9]
    if pv_beta0:
        pv = pv.clone()
        pv[SP.PV_BETA] = 0.0
    return q, src, s, e, pv


def _zero_col(args, col):
    """``args`` (q, src, seg_start, seg_end, pvec) of a body contact sweep
    with query column ``col`` at 0 (pd2 of BodyForce, bp of
    MultiphaseBody): the friction alone. The sweep walks the shell's rows
    only, so its ranges stay."""
    q = args[0].clone()
    q[:, col] = 0.0
    return (q, *args[1:])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_moving_and_body_kernels_match_plain_on_cuda(cuda, kernel_set):
    """On the small dam-break with its walls moving at (0.8, 0, −0.4) m/s
    and a moving, spinning 0.08 box in the fluid: the force kernel's MOVING
    instances (pressure on and off), MultiphaseForce<MOVING>, BodyForce and
    MultiphaseBody against their plain versions, each also on its friction
    alone (walls: β, pd2 and 1/m_i at 0, fluid ranges empty; body: pd2 resp.
    bp at 0): max|Δ| ≤ 1e-4·max|ref| per output column; the wall friction
    reads the wall velocity (it differs from the static instance's) and
    the body friction the shell's sample velocities (it differs from the
    result with slots 3-5 of the body rows at 0)."""
    import dataclasses as dc
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import coupled_cuda, wcsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, "BECKER", True,
                                                cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    ctx = build_sweep_ctx(state, params, grid, cfg, moving)
    assert ctx.moving_boundary
    pos = state.pos.cpu().numpy()
    body = dc.replace(
        nereus_tpu_torch.make_rigid_box(pos.mean(axis=0), (0.08,) * 3,
                                        float(params.particle_radius), 500.0,
                                        params, device=cuda),
        vel=torch.tensor([0.05, -0.1, 0.02], device=cuda),
        omega=torch.tensor([0.2, -0.1, 0.3], device=cuda))
    shells = coupled_cuda.body_shells(ctx, grid, (body,))
    sh = shells[0]
    _, fargs, _, _ = coupled_cuda.coupled_operands(ctx, params, cfg, shells)
    mctx = build_sweep_ctx(_two_phase(state, params, cuda), params, grid,
                           cfg, moving)
    margs, q8b, _, _ = coupled_cuda.coupled_multiphase_operands(
        mctx, params, cfg, coupled_cuda.body_shells(mctx, grid, (body,)))
    bargs = (fargs[0], sh.src, sh.seg_start, sh.seg_end, ctx.pvec)
    mbargs = (q8b, *coupled_cuda.body_shells(mctx, grid, (body,))[0],
              mctx.pvec)
    cases = []
    for p in (True, False):
        kw = dict(include_pressure=p, moving_boundary=True)
        cases += [("force", SP.fluid_force_sweep, SP.fluid_force_sweep_plain,
                   fargs, kw),
                  ("force friction", SP.fluid_force_sweep,
                   SP.fluid_force_sweep_plain,
                   _friction_args(fargs, 7, pv_beta0=True), kw)]
    mkw = dict(moving_boundary=True)
    cases += [("mp force", SP.multiphase_force_sweep,
               SP.multiphase_force_sweep_plain, margs, mkw),
              ("mp force friction", SP.multiphase_force_sweep,
               SP.multiphase_force_sweep_plain,
               _friction_args(margs, SP.MP_INV_M), mkw),
              ("body", SP.body_force_sweep, SP.body_force_sweep_plain,
               bargs, {}),
              ("body friction", SP.body_force_sweep,
               SP.body_force_sweep_plain, _zero_col(bargs, 7), {}),
              ("mp body", SP.multiphase_body_sweep,
               SP.multiphase_body_sweep_plain, mbargs, {}),
              ("mp body friction", SP.multiphase_body_sweep,
               SP.multiphase_body_sweep_plain, _zero_col(mbargs, 6), {})]
    cuda_sweep.reset_launches()
    for key, dispatch, plain, args, kw in cases:
        got = dispatch(cfg, *args, **kw)
        _assert_columns_close(got, plain(cfg, *args, **kw), key)
        if "body friction" in key:
            q, src, *rest = args
            still = src.clone()
            still[:, 3:6] = 0.0
            assert not torch.equal(dispatch(cfg, q, still, *rest), got), key
        elif "friction" in key:
            static = {k: v for k, v in kw.items() if k != "moving_boundary"}
            assert not torch.equal(dispatch(cfg, *args, **static), got), key
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.FORCE_MOVING: 2,
                      cuda_sweep.FORCE_P0_MOVING: 2, cuda_sweep.FORCE: 1,
                      cuda_sweep.FORCE_P0: 1, cuda_sweep.MP_FORCE_MOVING: 2,
                      cuda_sweep.MP_FORCE: 1, cuda_sweep.BODY_FORCE: 3,
                      cuda_sweep.MP_BODY: 3})


@pytest.mark.requires_cuda
def test_moving_and_coupled_steps_run_kernels_on_cuda(cuda):
    """A few steps with moving walls launch the MOVING force kernel and not
    the static one (WCSPH; multiphase WCSPH its MOVING instance; IISPH the
    pressure-off MOVING one); a few coupled steps launch one body density
    and one body contact sweep per step and body, single- and multiphase,
    and keep the bodies finite with R orthonormal."""
    from nereus_tpu_torch import boundary as B
    cfg, params, state, grid, boundary = _scene("MULLER", "BECKER", True,
                                                cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    K = cuda_sweep
    cuda_sweep.reset_launches()
    s = state
    for _ in range(3):
        s, _ = nereus_tpu_torch.wcsph_step(s, params, grid, cfg, moving)
    _assert_launches({K.DENSITY: 3, K.FORCE_MOVING: 3})
    mp = _two_phase(state, params, cuda)
    cuda_sweep.reset_launches()
    for _ in range(3):
        mp, _ = nereus_tpu_torch.wcsph_step(mp, params, grid, cfg, moving)
    _assert_launches({K.MP_DENSITY: 3, K.MP_FORCE_MOVING: 3})
    pos = state.pos.cpu().numpy()
    body = nereus_tpu_torch.make_rigid_box(
        pos.mean(axis=0) + np.array([0.0, 0.2, 0.0]), (0.08,) * 3,
        float(params.particle_radius), 500.0, params, device=cuda)
    for fluid, want in ((state, {K.DENSITY: 3, K.FORCE: 3,
                                 K.BODY_DENSITY: 6, K.BODY_FORCE: 6}),
                        (_two_phase(state, params, cuda),
                         {K.MP_DENSITY: 3, K.MP_FORCE: 3,
                          K.BODY_DENSITY: 6, K.MP_BODY: 6})):
        bodies = (body, dataclasses.replace(
            body, com=body.com + torch.tensor([0.2, 0.0, 0.0],
                                              device=cuda)))
        cuda_sweep.reset_launches()
        s = fluid
        for _ in range(3):
            s, bodies, diag = nereus_tpu_torch.wcsph_coupled_step(
                s, params, grid, cfg, bodies, boundary)
        _assert_launches(want)
        assert torch.isfinite(s.pos).all()
        for b in bodies:
            assert torch.isfinite(b.com).all()
            eye = torch.eye(3, device=cuda)
            assert float((b.R @ b.R.T - eye).abs().max()) < 1e-5


def _elastic_body(cuda, kernel_set="MULLER", n=(6, 5, 4), **kw):
    """A small elastic block at spacing h/2 (``test_elastic.py``'s bar
    widened): ``(cfg, params, state, statics, grid, sp)``."""
    from nereus_tpu_torch.solvers.elastic import sample_box_solid
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set])
    params = nereus_tpu_torch.make_params(dt=1e-4, device=cuda)
    sp = 0.5 * float(params.interaction_radius)
    pts = sample_box_solid((0.0, 0.0, 0.0),
                           tuple((k - 1) * sp for k in n), sp)
    state, statics, grid = nereus_tpu_torch.make_elastic_solid(
        pts, params, cfg, sp, device=cuda, **kw)
    return cfg, params, state, statics, grid, sp


def _deformed(x0, sp, seed=0):
    """``x0`` stretched 2 % along x, sheared (x += 0.1·y), rotated 20°
    about (1, 2, 3) about its centre and perturbed by a seeded noise of
    0.05·spacing: non-affine, so the hourglass term is live."""
    x = x0.double().cpu().numpy()
    c = x.mean(axis=0)
    a = np.array([[1.02, 0.1, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    ax = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    t = np.deg2rad(20.0)
    r = np.eye(3) + np.sin(t) * k + (1.0 - np.cos(t)) * (k @ k)
    x = (x - c) @ (r @ a).T + c
    x += np.random.default_rng(seed).uniform(-0.05, 0.05, x.shape) * sp
    return torch.as_tensor(x, dtype=torch.float32, device=x0.device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_elastic_kernels_match_plain_on_cuda(cuda, kernel_set):
    """ElasticF and ElasticForceHourglass on a deformed block (every output
    column nonzero, the hourglass half too), and FluidReaction on a moving,
    spinning cube inside the small dam-break's fluid, as it is and on its
    friction alone (the fluid density clamped to ρ₀), against their plain
    versions: max|Δ| ≤ 1e-4·max|ref| per column; the friction reads the
    sample velocities."""
    from nereus_tpu_torch.solvers import elastic_coupled, elastic_cuda
    from nereus_tpu_torch.solvers.elastic import stress_pc
    cfg, params, state, statics, grid, sp = _elastic_body(cuda, kernel_set)
    pv = SP.build_pvec(params, cfg, grid)
    x = _deformed(statics.x0, sp)
    fargs = elastic_cuda.f_gradient_operands(statics, x, pv)
    raw = SP.elastic_f_sweep_plain(cfg, *fargs)
    f = torch.bmm(statics.vol * raw.reshape(-1, 3, 3), statics.corr)
    ep = nereus_tpu_torch.elastic_params(1e5, device=cuda)
    pc, _, _ = stress_pc(f, statics.corr, ep)
    hargs = elastic_cuda.force_operands(statics, x, pc, f, pv)

    fcfg, fparams, fstate, fgrid, _ = _scene(kernel_set, "BECKER", False,
                                             cuda)
    centre = fstate.pos.mean(dim=0)
    _, bstat, _ = nereus_tpu_torch.make_elastic_solid(
        (statics.x0 - statics.x0.mean(dim=0) + centre).cpu().numpy(),
        fparams, fcfg, sp, grid=fgrid, device=cuda)
    r = bstat.x0 - bstat.x0.mean(dim=0)
    vel = torch.tensor([0.3, -0.5, 0.2], device=cuda) + torch.linalg.cross(
        torch.tensor([1.0, -2.0, 0.5], device=cuda).expand_as(r), r)
    body = nereus_tpu_torch.ElasticState(pos=bstat.x0, vel=vel)
    ctx = build_sweep_ctx(fstate, fparams, fgrid, fcfg, None)
    psi = nereus_tpu_torch.elastic_psi(bstat, fparams, fcfg)
    rargs = elastic_coupled.elastic_operands(ctx, fparams, fcfg, fgrid, body,
                                             psi).rargs
    q, src, s, e, rpv = rargs
    assert int((e - s).sum(dim=0).gt(0).sum()) > 0
    fric = src.clone()
    fric[:, 6] = torch.clamp(fric[:, 6], max=float(fparams.rest_density))
    cuda_sweep.reset_launches()
    for key, dispatch, plain, c, args in (
            ("elastic F", SP.elastic_f_sweep, SP.elastic_f_sweep_plain, cfg,
             fargs),
            ("force+hourglass", SP.elastic_force_hourglass_sweep,
             SP.elastic_force_hourglass_sweep_plain, cfg, hargs),
            ("reaction", SP.fluid_reaction_sweep,
             SP.fluid_reaction_sweep_plain, fcfg, rargs),
            ("reaction friction", SP.fluid_reaction_sweep,
             SP.fluid_reaction_sweep_plain, fcfg, (q, fric, s, e, rpv))):
        got = dispatch(c, *args)
        _assert_columns_close(got, plain(c, *args), key)
    still = q.clone()
    still[:, 3:6] = 0.0
    assert not torch.equal(SP.fluid_reaction_sweep(fcfg, still, fric, s, e,
                                                    rpv), got)
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.ELASTIC_F: 1, cuda_sweep.ELASTIC_FORCE_HG: 1,
                      cuda_sweep.FLUID_REACTION: 3})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("side", [16, 80])
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_elastic_list_kernel_groups_match_plain_on_cuda(cuda, kernel_set,
                                                        large, side,
                                                        monkeypatch):
    """The two elastic kernels over the body's pair list, the deformation
    gradient's and the force + hourglass, on a deformed side³ block at
    spacing h/2 (16: a coupled cell's 4,096 samples; 80: elastic_512k's
    512,000), at each lane-group size G their wrappers can pick
    (``SMALL_BODY`` set so that the block takes the G of a large body when
    ``large``, of a small one when not), against their plain versions:
    max|Δ| ≤ 1e-4·max|ref| per column, the hourglass half live; the F
    kernel also against ``elastic_f_pair`` walked over the body's ranges
    (the list is built in torch, the range walk tested r² < h² itself); the
    list holds as many pairs as the ranges hold within h."""
    from nereus_tpu_torch.solvers import elastic_cuda
    from nereus_tpu_torch.solvers.elastic import stress_pc
    cfg, params, state, statics, grid, sp = _elastic_body(
        cuda, kernel_set, n=(side,) * 3)
    monkeypatch.setattr(cuda_sweep, "SMALL_BODY", 0 if large else 2 ** 31)
    pv = SP.build_pvec(params, cfg, grid)
    ns, nb = statics.nbr_start, statics.nbr
    s, e = statics.seg_start, statics.seg_end
    from nereus_tpu_torch.ops.neighbors import neighbor_sweep_plain, row_pairs
    inside = 0
    for r in range(9):
        qi, sj = row_pairs(s[r], e[r])
        d = statics.x0[qi] - statics.x0[sj]
        inside += int(((d * d).sum(dim=1) < pv[SP.PV_H2]).sum())
    assert int(ns[-1]) == nb.shape[0] == inside
    x = _deformed(statics.x0, sp)
    fargs = elastic_cuda.f_gradient_operands(statics, x, pv)
    raw = SP.elastic_f_sweep_plain(cfg, *fargs)
    f = torch.bmm(statics.vol * raw.reshape(-1, 3, 3), statics.corr)
    pc, _, _ = stress_pc(f, statics.corr,
                         nereus_tpu_torch.elastic_params(1e5, device=cuda))
    hargs = elastic_cuda.force_operands(statics, x, pc, f, pv)
    g = cuda_sweep.elastic_group(statics.n)
    cuda_sweep.reset_launches()
    got_f = cuda_sweep.elastic_f_sweep(cfg, *fargs)
    _assert_columns_close(got_f, raw, f"elastic_f n={statics.n} G={g}")
    walk = neighbor_sweep_plain(
        lambda a, b: SP.elastic_f_pair(a, b, pv, kernel_set=cfg.kernel_set),
        fargs[0], fargs[1], s, e, 9)
    _assert_columns_close(got_f, walk, f"elastic_f n={statics.n} G={g} "
                          "against the range walk")
    got = cuda_sweep.elastic_force_hourglass_sweep(cfg, *hargs)
    ref = SP.elastic_force_hourglass_sweep_plain(cfg, *hargs)
    _assert_columns_close(got, ref, f"elastic_force_hg n={statics.n} G={g}")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.ELASTIC_F: 1,
                      cuda_sweep.ELASTIC_FORCE_HG: 1})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_drho_groups_match_plain_on_cuda(cuda, kernel_set):
    """The Dρ/Dt kernel at its lane-group size ``DRHO_G`` on the step's
    one operand matrix (``KappaSweeps.drho_operands``, the queries its
    first rows) with static and moving walls, and on a separate query
    matrix, against its plain version: max|Δ| ≤ 1e-4·max|ref|."""
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import dfsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, "NONE", True,
                                                cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    cuda_sweep.reset_launches()
    for walls in (boundary, moving):
        ctx = build_sweep_ctx(state, params, grid, cfg, walls)
        vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
        dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
            params.particle_mass))
        sweeps = dfsph_cuda.KappaSweeps(ctx, params, cfg, dens)
        args = sweeps.drho_operands(vel)
        assert args[0].data_ptr() == args[1].data_ptr()
        sep = (ctx.queries(ctx.vx, ctx.vy, ctx.vz, width=8), *args[1:])
        for a in (args, sep):
            _assert_columns_close(
                cuda_sweep.drho_sweep(cfg, *a), SP.drho_sweep_plain(cfg, *a),
                f"drho G={cuda_sweep.DRHO_G}")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.DRHO: 4})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("st", ["NONE", "BECKER"])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_multiphase_groups_match_plain_on_cuda(cuda, kernel_set, st, large,
                                               monkeypatch):
    """The multiphase force kernel at each G its wrapper picks
    (``SMALL_N`` set so that the small two-phase dam-break takes the G of
    ``multiphase_1M`` when ``large`` and that of the 256k cells when not),
    static and MOVING, on the step's one operand matrix (the queries its
    first rows) and the MOVING one on its wall friction alone; and the
    dδ̂/dt kernel at ``MP_DRHO_G`` on its one matrix, with the light phase's
    mass scaled so that s_i/m_i differs by phase, and on a separate query
    matrix; static and moving walls, st_cross 0.25: max|Δ| ≤ 1e-4·max|ref|
    per column, and the MOVING friction differs from the static one's."""
    monkeypatch.setattr(cuda_sweep, "SMALL_N", 0 if large else 2 ** 31)
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import dfsph_cuda, wcsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, st, True, cuda)
    cfg = dataclasses.replace(cfg, st_cross=0.25)
    mp = _two_phase(state, params, cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    cuda_sweep.reset_launches()
    for walls in (boundary, moving):
        ctx = build_sweep_ctx(mp, params, grid, cfg, walls)
        dout = SP.multiphase_density_sweep_plain(
            cfg, *wcsph_cuda.multiphase_density_operands(ctx))
        fargs, dens, _ = wcsph_cuda.multiphase_force_operands(ctx, params,
                                                              dout)
        assert fargs[0].data_ptr() == fargs[1].data_ptr()
        g = cuda_sweep.mp_force_group(ctx.c, walls is moving)
        kw = dict(moving_boundary=walls is moving)
        cases = [(f"mp force G={g} {kw}", fargs, kw)]
        if walls is moving:
            cases.append((f"mp force friction G={g}",
                          _friction_args(fargs, SP.MP_INV_M), kw))
        for key, args, kwk in cases:
            got = cuda_sweep.multiphase_force_sweep(cfg, *args, **kwk)
            _assert_columns_close(
                got, SP.multiphase_force_sweep_plain(cfg, *args, **kwk), key)
            if "friction" in key:
                assert not torch.equal(
                    cuda_sweep.multiphase_force_sweep(cfg, *args), got), key
        light = ctx.rho0 < ctx.rho0.max()
        sctx = dataclasses.replace(
            ctx, mass=ctx.mass * torch.where(light, 1.5, 1.0))
        sweeps = dfsph_cuda.MultiphaseKappaSweeps(sctx, params, cfg, dens)
        assert len(torch.unique(sweeps.sm)) == 2
        args = sweeps.drho_operands(torch.stack([ctx.vx, ctx.vy, ctx.vz],
                                                dim=1))
        assert args[0].data_ptr() == args[1].data_ptr()
        sep = (args[0].clone(), *args[1:])
        for a in (args, sep):
            _assert_columns_close(
                cuda_sweep.multiphase_drho_sweep(cfg, *a),
                SP.multiphase_drho_sweep_plain(cfg, *a),
                f"mp drho G={cuda_sweep.MP_DRHO_G} {kw}")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.MP_FORCE: 2, cuda_sweep.MP_FORCE_MOVING: 2,
                      cuda_sweep.MP_DRHO: 4})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_multiphase_density_groups_match_plain_on_cuda(cuda, kernel_set,
                                                       large, monkeypatch):
    """The multiphase density kernel at each G its wrapper picks
    (``SMALL_N`` set so that the small two-phase dam-break takes the G of
    ``multiphase_1M`` when ``large`` and that of the 256k cells when not),
    static and moving walls, on the multiphase WCSPH step's one matrix
    (fluid rows ``x y z 0``) and on the multiphase DFSPH step's (the α
    sweep's ``x y z 1/m``): max|Δ| ≤ 1e-4·max|ref| per column, and the two
    matrices give the same δ and Σψ_bW bit for bit (no fluid row's slot 3
    is read)."""
    monkeypatch.setattr(cuda_sweep, "SMALL_N", 0 if large else 2 ** 31)
    from nereus_tpu_torch import boundary as B
    from nereus_tpu_torch.solvers import dfsph_cuda, wcsph_cuda
    cfg, params, state, grid, boundary = _scene(kernel_set, "NONE", True,
                                                cuda)
    mp = _two_phase(state, params, cuda)
    moving = B.move_boundary(boundary, grid, velocity=WALL_VEL)
    cuda_sweep.reset_launches()
    for walls in (boundary, moving):
        ctx = build_sweep_ctx(mp, params, grid, cfg, walls)
        g = cuda_sweep.density_group(ctx.c)
        assert g == (2 if large else 4)
        outs = []
        for args in (wcsph_cuda.multiphase_density_operands(ctx),
                     dfsph_cuda.multiphase_alpha_operands(ctx)):
            q, src = args[:2]
            assert q.data_ptr() == src.data_ptr() and q.shape == (ctx.c, 4)
            outs.append(cuda_sweep.multiphase_density_sweep(cfg, *args))
            _assert_columns_close(
                outs[-1], SP.multiphase_density_sweep_plain(cfg, *args),
                f"mp density G={g} moving={walls is moving}")
        assert torch.equal(outs[0], outs[1])
        assert float(outs[0][:, 1].abs().max()) > 0.0
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.MP_DENSITY: 4})


def _body_force_shell(cuda, kernel_set, shell):
    """The small dam-break (walls on, seeded velocities) and one body shell
    in its fluid, as the coupled steps build their operands: ``"box"`` the
    rigid 0.15 m box of ``coupled_256k`` (56 samples), moving at (0.3,
    −0.5, 0.2) m/s and spinning at (1, −2, 0.5) rad/s; ``"cube"`` a 16³
    elastic cube at h/2 (4,096 samples, those of ``wcsph_elastic_256k`` and
    ``dfsph_elastic_256k``) around the whole fluid, so that every query's
    runs hold up to ~216 candidates. ``(cfg, (q, src, seg_start, seg_end,
    pvec))``: the force sweep's query with the shell's ψ-density in ρ."""
    from nereus_tpu_torch.solvers import coupled_cuda, elastic_coupled
    from nereus_tpu_torch.solvers.elastic import sample_box_solid
    cfg, params, state, grid, boundary = _scene(kernel_set, "NONE", True,
                                                cuda)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    c = state.pos.mean(dim=0).cpu().numpy()
    if shell == "box":
        body = dataclasses.replace(
            nereus_tpu_torch.make_rigid_box(
                c, (0.15,) * 3, float(params.particle_radius), 500.0, params,
                device=cuda),
            vel=torch.tensor([0.3, -0.5, 0.2], device=cuda),
            omega=torch.tensor([1.0, -2.0, 0.5], device=cuda))
        shells = coupled_cuda.body_shells(ctx, grid, (body,))
        _, fargs, _, _ = coupled_cuda.coupled_operands(ctx, params, cfg,
                                                       shells)
        sh = shells[0]
    else:
        sp = 0.5 * float(params.interaction_radius)
        es, statics, _ = nereus_tpu_torch.make_elastic_solid(
            sample_box_solid(c - 7.5 * sp, c + 7.6 * sp, sp), params, cfg,
            sp, grid=grid, density=400.0, device=cuda)
        psi = nereus_tpu_torch.elastic_psi(statics, params, cfg)
        ops = elastic_coupled.elastic_operands(ctx, params, cfg, grid, es,
                                               psi)
        fargs, sh = ops.fargs, ops.shell
    assert sh.src.shape[0] == (56 if shell == "box" else 4096)
    return cfg, (fargs[0], sh.src, sh.seg_start, sh.seg_end, ctx.pvec)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shell", ["box", "cube"])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_body_force_groups_match_plain_on_cuda(cuda, kernel_set, shell,
                                               monkeypatch):
    """BodyForce, both forms (with the Akinci pressure, and the friction
    alone), at every G built for it (``shell_group`` below and above
    ``SMALL_SHELL``), over :func:`_body_force_shell`'s 56-sample box and
    4,096-sample cube: twice, bit for bit, and against
    ``body_force_sweep_plain``, max|Δ| ≤ 1e-4·max|ref| per column."""
    cfg, args = _body_force_shell(cuda, kernel_set, shell)
    busy = int((args[3] - args[2]).sum(dim=0).gt(0).sum())
    assert busy > 0
    groups = sorted({cuda_sweep.shell_group(1),
                     cuda_sweep.shell_group(cuda_sweep.SMALL_SHELL)})
    cuda_sweep.reset_launches()
    for g in groups:
        monkeypatch.setattr(cuda_sweep, "shell_group", lambda m, g=g: g)
        for p in (True, False):
            got = SP.body_force_sweep(cfg, *args, include_pressure=p)
            assert torch.equal(SP.body_force_sweep(cfg, *args,
                                                   include_pressure=p), got)
            _assert_columns_close(
                got, SP.body_force_sweep_plain(cfg, *args,
                                               include_pressure=p),
                f"body force {shell} G={g} pressure={p} ({busy} busy)")
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.BODY_FORCE: 2 * len(groups),
                      cuda_sweep.BODY_FORCE_P0: 2 * len(groups)})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shell", ["box", "cube"])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_shell_density_alpha_and_kappa_groups_match_plain_on_cuda(
        cuda, kernel_set, shell, monkeypatch):
    """The shell's ψ-density and α's sums in one walk, both forms
    (``include_sq`` False / True), and the multiphase κ̂ correction over the
    shell, at every G built for them (``shell_group`` below and above
    ``SMALL_SHELL``), over :func:`_body_force_shell`'s 56-sample box and
    4,096-sample cube (its ``x y z ψ_b`` rows; κ̂'s query ``x y z κV̂² qc``
    with seeded κV̂² and qc): twice, bit for bit, and against their plain
    twins, max|Δ| ≤ 1e-4·max|ref| per column; the Σψ_bW plane bit for bit
    the density kernel's ``<body>`` at G 2, a G both build."""
    from nereus_tpu_torch.solvers.sweep_common import psi_rows
    cfg, (q8, src, s, e, pv) = _body_force_shell(cuda, kernel_set, shell)
    q4 = q8[:, :4].contiguous()
    src4 = psi_rows(src)
    kq = q8.clone()
    kq[:, 3:5] = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, (len(kq), 2)).astype(np.float32)).to(cuda)
    kq[:, 5:] = 0.0
    busy = int((e - s).sum(dim=0).gt(0).sum())
    assert busy > 0
    groups = sorted({cuda_sweep.shell_group(1),
                     cuda_sweep.shell_group(cuda_sweep.SMALL_SHELL)})
    cuda_sweep.reset_launches()
    for g in groups:
        monkeypatch.setattr(cuda_sweep, "shell_group", lambda m, g=g: g)
        for sq in (False, True):
            got = SP.body_density_alpha_sweep(cfg, q4, src4, s, e, pv,
                                              include_sq=sq)
            assert got.shape == (len(q4), 5 if sq else 4)
            assert torch.equal(SP.body_density_alpha_sweep(
                cfg, q4, src4, s, e, pv, include_sq=sq), got)
            _assert_columns_close(
                got, SP.body_density_alpha_sweep_plain(
                    cfg, q4, src4, s, e, pv, include_sq=sq),
                f"density alpha {shell} G={g} sq={sq} ({busy} busy)")
        got = SP.multiphase_kappa_body_sweep(cfg, kq, src4, s, e, pv)
        assert torch.equal(SP.multiphase_kappa_body_sweep(
            cfg, kq, src4, s, e, pv), got)
        _assert_columns_close(
            got, SP.multiphase_kappa_body_sweep_plain(cfg, kq, src4, s, e,
                                                      pv),
            f"mp kappa body {shell} G={g} ({busy} busy)")
    monkeypatch.setattr(cuda_sweep, "shell_group", lambda m: 2)
    monkeypatch.setattr(cuda_sweep, "body_group", lambda m: 2)
    for sq in (False, True):
        assert torch.equal(
            SP.body_density_alpha_sweep(cfg, q4, src4, s, e, pv,
                                        include_sq=sq)[:, 0],
            cuda_sweep.body_density_sweep(cfg, q4, src4, s, e, pv))
    torch.cuda.synchronize()
    n = len(groups)
    _assert_launches({cuda_sweep.BODY_DENSITY_ALPHA: 2 * n + 1,
                      cuda_sweep.BODY_DENSITY_ALPHA_SQ: 2 * n + 1,
                      cuda_sweep.MP_KAPPA_BODY: 2 * n,
                      cuda_sweep.BODY_DENSITY: 2})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("with_boundary", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_multiphase_density_alpha_matches_plain_on_cuda(cuda, kernel_set,
                                                        with_boundary,
                                                        monkeypatch):
    """The multiphase density and α̂ kernel at ``MP_DENSITY_ALPHA_G`` on the
    two-phase split's one matrix (``dfsph_cuda.multiphase_alpha_operands``),
    with walls and without: against its plain twin, max|Δ| ≤ 1e-4·max|ref|
    per column (without walls the four wall columns exactly 0); its δ and
    Σψ_bW planes bit for bit the multiphase density kernel's at the same G
    (``SMALL_N`` set so that ``density_group`` picks it)."""
    from nereus_tpu_torch.solvers import dfsph_cuda
    g = cuda_sweep.MP_DENSITY_ALPHA_G
    assert g in (2, 4), "density_group builds the multiphase density at 2, 4"
    monkeypatch.setattr(cuda_sweep, "SMALL_N", 2 ** 31 if g == 4 else 0)
    cfg, params, state, grid, boundary = _scene(kernel_set, "NONE",
                                                with_boundary, cuda)
    mp = build_sweep_ctx(_two_phase(state, params, cuda), params, grid, cfg,
                         boundary)
    args = dfsph_cuda.multiphase_alpha_operands(mp)
    assert cuda_sweep.density_group(mp.c) == g
    cuda_sweep.reset_launches()
    got = cuda_sweep.multiphase_density_alpha_sweep(cfg, *args)
    ref = SP.multiphase_density_alpha_sweep_plain(cfg, *args)
    walls = [1, 6, 7, 8]
    live = [c for c in range(9) if with_boundary or c not in walls]
    _assert_columns_close(got[:, live], ref[:, live],
                          f"mp density alpha G={g} walls={with_boundary}")
    if not with_boundary:
        assert not bool(got[:, walls].any())
    assert torch.equal(got[:, :2],
                       cuda_sweep.multiphase_density_sweep(cfg, *args))
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.MP_DENSITY_ALPHA: 1,
                      cuda_sweep.MP_DENSITY: 1})


@pytest.mark.requires_cuda
def test_elastic_steps_run_kernels_on_cuda(cuda):
    """Elastic and elastoplastic steps launch one ElasticF and one
    ElasticForceHourglass per step and nothing else; a coupled step launches
    the fluid's density and force, the body's ψ-density and contact, one
    FluidReaction and, per substep, the two elastic kernels."""
    K = cuda_sweep
    for plastic in (False, True):
        cfg, params, state, statics, grid, sp = _elastic_body(
            cuda, plastic=plastic)
        ep = nereus_tpu_torch.elastic_params(
            1e5, yield_strain=0.02 if plastic else float("inf"),
            device=cuda)
        s = dataclasses.replace(state, pos=_deformed(statics.x0, sp))
        cuda_sweep.reset_launches()
        for _ in range(3):
            s, d = nereus_tpu_torch.elastic_step(s, statics, params, ep,
                                                 grid, cfg)
        _assert_launches({K.ELASTIC_F: 3, K.ELASTIC_FORCE_HG: 3})
        assert torch.isfinite(s.pos).all() and int(d.seg_overflow) == 0
        assert (s.plastic is not None) == plastic
    cfg, params, state, grid, boundary = _scene("MULLER", "BECKER", True,
                                                cuda)
    sp = 0.5 * float(params.interaction_radius)
    from nereus_tpu_torch.solvers.elastic import sample_box_solid
    c = state.pos.mean(dim=0).cpu().numpy()
    cube = sample_box_solid(c - 1.5 * sp, c + 1.5 * sp, sp)
    es, statics, _ = nereus_tpu_torch.make_elastic_solid(
        cube, params, cfg, sp, grid=grid, density=400.0, device=cuda)
    ep = nereus_tpu_torch.elastic_params(1e5, damping=5.0, device=cuda)
    psi = nereus_tpu_torch.elastic_psi(statics, params, cfg)
    cuda_sweep.reset_launches()
    s = state
    for _ in range(2):
        s, es, diag = nereus_tpu_torch.wcsph_elastic_step(
            s, params, grid, cfg, es, statics, ep, psi, boundary, substeps=3)
    _assert_launches({K.DENSITY: 2, K.FORCE: 2, K.BODY_DENSITY: 2,
                      K.BODY_FORCE: 2, K.FLUID_REACTION: 2, K.ELASTIC_F: 6,
                      K.ELASTIC_FORCE_HG: 6})
    assert torch.isfinite(s.pos).all() and torch.isfinite(es.pos).all()
    assert int(diag.seg_overflow) == 0


def _dfsph_body_cases(cfg, params, state, grid, cuda):
    """Every body sweep of the DFSPH couplings on the small dam-break with
    a moving, spinning 0.08 box (single phase, then the two-phase split)
    and a 3³ elastic cube in its fluid, on each step's first divergence
    iteration: ``[(key, dispatch, plain, args, kwargs)]``."""
    from nereus_tpu_torch.solvers import dfsph_coupled_cuda as DC
    from nereus_tpu_torch.solvers import dfsph_elastic as DE
    from nereus_tpu_torch.solvers.elastic import sample_box_solid
    from nereus_tpu_torch.solvers.elastic_coupled import elastic_shell
    dt = float(params.dt)
    centre = state.pos.mean(dim=0)
    body = dataclasses.replace(
        nereus_tpu_torch.make_rigid_box(centre.cpu().numpy(), (0.08,) * 3,
                                        float(params.particle_radius), 500.0,
                                        params, device=cuda),
        vel=torch.tensor([0.3, -0.5, 0.2], device=cuda),
        omega=torch.tensor([1.0, -2.0, 0.5], device=cuda))
    bv = (body.vel, body.omega)
    cases = []
    ctx = build_sweep_ctx(state, params, grid, cfg, None)
    (t,) = DC.body_terms(ctx, grid, (body,))
    rows = t.ranges(ctx.pvec)
    dens, alpha = DC.coupled_density_alpha(ctx, params, cfg, [t])
    sw = DC.CoupledSweeps(ctx, params, cfg, dens, [t])
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    kq = sw.kappa_operands(
        torch.clamp(sw.drho(v, [bv]), min=0.0) * alpha / dt)[0]
    src_v = t.src_at(bv).clone()
    q8 = ctx.queries(ctx.vx, ctx.vy, ctx.vz, dens, torch.zeros_like(dens))
    q4 = ctx.queries(width=4)
    p0 = dict(include_pressure=False)
    cases += [
        ("kappa body", SP.pressure_force_body_sweep,
         SP.pressure_force_body_sweep_plain, (kq, t.shell.src, *rows), {}),
        ("density alpha body", SP.body_density_alpha_sweep,
         SP.body_density_alpha_sweep_plain, (q4, t.src4, *rows), {}),
        ("density alpha shell", SP.body_density_alpha_sweep,
         SP.body_density_alpha_sweep_plain, (q4, t.src4, *rows),
         dict(include_sq=True)),
        ("drho shell", SP.drho_shell_sweep, SP.drho_sweep_plain,
         (sw.q_v, src_v, *rows), {}),
        ("body friction", SP.body_force_sweep, SP.body_force_sweep_plain,
         (q8, src_v, *rows), p0)]
    mctx = build_sweep_ctx(_two_phase(state, params, cuda), params, grid,
                           cfg, None)
    (mt,) = DC.body_terms(mctx, grid, (body,))
    mrows = mt.ranges(mctx.pvec)
    mdens, _, malpha = DC.coupled_density_alpha_multiphase(mctx, params,
                                                           cfg, [mt])
    msw = DC.MultiphaseCoupledSweeps(mctx, params, cfg, mdens, [mt])
    mv = torch.stack([mctx.vx, mctx.vy, mctx.vz], dim=1)
    mkq = msw.kappa_operands(
        torch.clamp(msw.drho(mv, [bv]), min=0.0) * malpha / dt)[0]
    cases += [
        ("mp alpha body", SP.multiphase_alpha_body_sweep,
         SP.multiphase_alpha_body_sweep_plain,
         (mctx.queries(width=4), mt.src4, *mrows), {}),
        ("mp drho body", SP.multiphase_drho_body_sweep,
         SP.multiphase_drho_body_sweep_plain,
         (msw.q_v, mt.src_at(bv).clone(), *mrows), {}),
        ("mp kappa body", SP.multiphase_kappa_body_sweep,
         SP.multiphase_kappa_body_sweep_plain, (mkq, mt.src4, *mrows), {})]
    sp = 0.5 * float(params.interaction_radius)
    c = centre.cpu().numpy()
    estate, statics, _ = nereus_tpu_torch.make_elastic_solid(
        sample_box_solid(c - sp, c + sp, sp), params, cfg, sp, grid=grid,
        device=cuda)
    r = statics.x0 - statics.x0.mean(dim=0)
    estate = dataclasses.replace(estate, vel=body.vel + torch.linalg.cross(
        body.omega.expand_as(r), r))
    es = elastic_shell(ctx, grid, estate,
                       nereus_tpu_torch.elastic_psi(statics, params, cfg))
    esw = DE.ElasticSweeps(ctx, params, cfg, dens, es, statics.mass)
    drho = torch.clamp(esw.drho(v, (es.shell.src[:, 3:6],)), min=0.0)
    src = esw.kappa_operands(drho * alpha / dt)[1]
    rev = (es.r_start, es.r_end, ctx.pvec)
    src_f = ctx.pack((ctx.vx, ctx.vy, ctx.vz), dens)[:ctx.c]
    cases += [
        ("reverse kappa", SP.pressure_force_body_rev_sweep,
         SP.pressure_force_body_sweep_plain, (esw.q_b, src, *rev), {}),
        ("reaction friction", SP.fluid_reaction_sweep,
         SP.fluid_reaction_sweep_plain, (es.shell.src, src_f, *rev), p0)]
    return cases


# output columns a body form leaves at exactly 0
_ZERO_COLS = {"mp alpha body": [0, 1, 2, 3], "mp drho body": [0]}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_dfsph_body_kernels_match_plain_on_cuda(cuda, kernel_set):
    """The DFSPH couplings' instances (the body form of PressureForce,
    the shell's ψ-density with α's sums in both forms, the three
    multiphase DFSPH functors' body forms, Drho over a shell, BodyForce
    and FluidReaction without pressure) against their
    plain versions on a moving, spinning box and elastic cube in the small
    dam-break's fluid: max|Δ| ≤ 1e-4·max|ref| per nonzero column, the
    body forms' other columns exactly 0; the two friction sweeps read the
    sample velocities."""
    cfg, params, state, grid, _ = _scene(kernel_set, "NONE", False, cuda)
    cases = _dfsph_body_cases(cfg, params, state, grid, cuda)
    cuda_sweep.reset_launches()
    for key, dispatch, plain, args, kw in cases:
        got = dispatch(cfg, *args, **kw)
        ref = plain(cfg, *args, **kw)
        zero = _ZERO_COLS.get(key, [])
        live = [k for k in range(got.reshape(len(got), -1).shape[1])
                if k not in zero]
        g2, r2 = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
        _assert_columns_close(g2[:, live], r2[:, live], key)
        assert not bool(g2[:, zero].any()), key
        if "friction" in key:
            q, src, *rest = args
            if key == "reaction friction":
                still = (q.clone(), src)
                still[0][:, 3:6] = 0.0
            else:
                still = (q, src.clone())
                still[1][:, 3:6] = 0.0
            assert not torch.equal(dispatch(cfg, *still, *rest, **kw),
                                   got), key
    torch.cuda.synchronize()
    K = cuda_sweep
    _assert_launches({K.PRESSURE_FORCE_BODY: 1,
                      K.PRESSURE_FORCE_BODY_REV: 1, K.BODY_DENSITY_ALPHA: 1,
                      K.BODY_DENSITY_ALPHA_SQ: 1, K.DRHO_SHELL: 1,
                      K.BODY_FORCE_P0: 2, K.MP_ALPHA_BODY: 1,
                      K.MP_DRHO_BODY: 1, K.MP_KAPPA_BODY: 1,
                      K.FLUID_REACTION_P0: 2})


def _warp_mix_operands(cuda, fq, fs, rows, n=101, m=1024, seed=0):
    """Synthetic operands of a range sweep whose warps hold queries with
    few candidates, a mix of few and many, and many, then a partial warp:
    ``(q, src, seg_start, seg_end)``, q (n, fq) and src (m, fs), positions
    uniform in [−h/2, h/2]³ and [−h, h]³ of the small dam-break's h (about
    half the candidates inside the cutoff), the other columns uniform in
    [0.5, 1.5). Candidates per query: warp 0 all under 32, warp 1 32, 31,
    0 and one from 32 to 216 in turns, warp 2 all from 32 to 216, the rest
    from 0 to 216; each count split into ``rows`` runs of contiguous source
    rows (rows 9-17 in the last quarter, the wall rows)."""
    t = 32
    rng = np.random.default_rng(seed)
    h = float(nereus_tpu_torch.make_params(device="cpu").interaction_radius)
    turns = np.array([t, t - 1, 0, 0])
    counts = np.concatenate([
        rng.integers(0, t, 32), np.where(np.arange(32) % 4 == 3,
                                         rng.integers(t, 217, 32),
                                         turns[np.arange(32) % 4]),
        rng.integers(t, 217, 32), rng.integers(0, 217, n - 96)])
    counts[0], counts[64] = t - 1, t
    walls = 3 * m // 4 if rows == 18 else m
    start = np.zeros((rows, n), np.int32)
    end = np.zeros((rows, n), np.int32)
    for i, c in enumerate(counts):
        cuts = np.sort(rng.integers(0, c + 1, rows - 1))
        lens = np.diff(np.concatenate([[0], cuts, [c]]))
        for r, ln in enumerate(lens):
            lo, hi = (0, walls) if r < 9 else (walls, m)
            start[r, i] = rng.integers(lo, hi - ln + 1)
            end[r, i] = start[r, i] + ln
    q = rng.uniform(0.5, 1.5, (n, fq))
    q[:, :3] = rng.uniform(-0.5 * h, 0.5 * h, (n, 3))
    src = rng.uniform(0.5, 1.5, (m, fs))
    src[:, :3] = rng.uniform(-h, h, (m, 3))
    return tuple(torch.tensor(a, dtype=torch.float32, device=cuda)
                 for a in (q, src)) + tuple(
        torch.tensor(a, device=cuda) for a in (start, end))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_kappa_kernels_match_plain_on_cuda(cuda, kernel_set, large,
                                           monkeypatch):
    """On :func:`_warp_mix_operands`: the forward κ impulse at each G its
    wrapper picks (``SMALL_SHELL`` set so that the 1,024-row source takes
    the G of a large shell when ``large`` and of a small one when not),
    twice, bit for bit; the reverse at ``BODY_REV_G``; the
    multiphase κ correction over 18 rows: max|Δ| ≤ 1e-4·max|ref| per
    column of each warp."""
    monkeypatch.setattr(cuda_sweep, "SMALL_SHELL", 0 if large else 2 ** 31)
    cfg, params, _, grid, _ = _scene(kernel_set, "NONE", False, cuda)
    pv = SP.build_pvec(params, cfg, grid)
    body = _warp_mix_operands(cuda, 4, 8, 9)
    kappa = _warp_mix_operands(cuda, 8, 4, 18, seed=1)
    cuda_sweep.reset_launches()
    fwd = SP.pressure_force_body_sweep(cfg, *body, pv)
    assert torch.equal(SP.pressure_force_body_sweep(cfg, *body, pv), fwd)
    cases = [
        (f"forward G={cuda_sweep.shell_group(1024)}", fwd,
         SP.pressure_force_body_sweep_plain(cfg, *body, pv)),
        (f"reverse G={cuda_sweep.BODY_REV_G}",
         SP.pressure_force_body_rev_sweep(cfg, *body, pv),
         SP.pressure_force_body_sweep_plain(cfg, *body, pv)),
        ("mp kappa", SP.multiphase_kappa_sweep(cfg, *kappa, pv),
         SP.multiphase_kappa_sweep_plain(cfg, *kappa, pv))]
    for key, got, ref in cases:
        assert torch.isfinite(got).all(), key
        assert float(ref.abs().max()) > 0.0, key
        for w in range(0, len(ref), 32):
            err = (got[w:w + 32] - ref[w:w + 32]).abs().amax(dim=0)
            scale = ref[w:w + 32].abs().amax(dim=0)
            assert bool((err <= 1e-4 * scale).all()), (key, w, err, scale)
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.PRESSURE_FORCE_BODY: 2,
                      cuda_sweep.PRESSURE_FORCE_BODY_REV: 1,
                      cuda_sweep.MP_KAPPA: 1})


@pytest.mark.requires_cuda
@pytest.mark.parametrize("large", [False, True])
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_shell_drho_matches_plain_on_cuda(cuda, kernel_set, large,
                                          monkeypatch):
    """On :func:`_warp_mix_operands` (8-wide queries and shell rows, 9
    range rows): the shell's Dρ/Dt at each G its wrapper picks
    (``SMALL_SHELL`` set so that the 1,024-row shell takes the G of a
    large shell when ``large`` and of a small one when not),
    twice, bit for bit, against its plain version: max|Δ| ≤ 1e-4·max|ref|
    in each warp."""
    monkeypatch.setattr(cuda_sweep, "SMALL_SHELL", 0 if large else 2 ** 31)
    cfg, params, _, grid, _ = _scene(kernel_set, "NONE", False, cuda)
    pv = SP.build_pvec(params, cfg, grid)
    args = (*_warp_mix_operands(cuda, 8, 8, 9, seed=2), pv)
    cuda_sweep.reset_launches()
    got = SP.drho_shell_sweep(cfg, *args)
    assert torch.equal(SP.drho_shell_sweep(cfg, *args), got)
    ref = SP.drho_sweep_plain(cfg, *args)
    key = f"drho shell G={cuda_sweep.shell_group(1024)}"
    assert torch.isfinite(got).all(), key
    assert float(ref.abs().max()) > 0.0, key
    for w in range(0, len(ref), 32):
        err = float((got[w:w + 32] - ref[w:w + 32]).abs().max())
        scale = float(ref[w:w + 32].abs().max())
        assert err <= 1e-4 * scale, (key, w, err, scale)
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.DRHO_SHELL: 2})


@pytest.mark.requires_cuda
def test_dfsph_coupled_steps_run_kernels_on_cuda(cuda):
    """Two coupled DFSPH steps with two bodies (single phase, then
    multiphase) and two coupled DFSPH + elastic steps launch each kernel
    as their loops say: per step one density and α (and per body one
    shell ψ-density and α sweep; multiphase: one body density and one
    body-form α̂), per launched iteration one Dρ/Dt and one κ
    correction plus one per body, one more κ correction for the warm
    start, one pressure-off force and one friction per body; the elastic
    step also one reverse κ per correction (its own counter), one
    reaction friction and the elastic kernels per substep."""
    from nereus_tpu_torch.solvers import dfsph_cuda
    from nereus_tpu_torch.solvers.elastic import sample_box_solid
    K = cuda_sweep
    cfg, params, state, grid, boundary = _scene("MULLER", "NONE", True, cuda)
    pos = state.pos.cpu().numpy()
    body = nereus_tpu_torch.make_rigid_box(
        pos.mean(axis=0), (0.08,) * 3, float(params.particle_radius), 500.0,
        params, device=cuda)
    bodies0 = (body, dataclasses.replace(
        body, com=body.com + torch.tensor([0.0, 0.2, 0.0], device=cuda)))
    for fluid, mp in ((state, False), (_two_phase(state, params, cuda),
                                       True)):
        cuda_sweep.reset_launches()
        dfsph_cuda.LOOP.reset()
        dfsph_cuda.LOOP_V.reset()
        s, bodies = fluid, bodies0
        for _ in range(2):
            s, bodies, diag = nereus_tpu_torch.dfsph_coupled_step(
                s, params, grid, cfg, bodies, boundary)
        it = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
        corr = it + 2
        if mp:
            want = {K.MP_DENSITY_ALPHA: 2, K.BODY_DENSITY: 4,
                    K.MP_ALPHA_BODY: 4, K.MP_DRHO: it, K.MP_DRHO_BODY: 2 * it,
                    K.MP_KAPPA: corr, K.MP_KAPPA_BODY: 2 * corr,
                    K.MP_FORCE: 2, K.MP_BODY: 4}
        else:
            want = {K.DENSITY_ALPHA_SUMS: 2, K.BODY_DENSITY_ALPHA: 4,
                    K.DRHO: it, K.DRHO_SHELL: 2 * it,
                    K.PRESSURE_FORCE: corr, K.PRESSURE_FORCE_BODY: 2 * corr,
                    K.FORCE_P0: 2, K.BODY_FORCE_P0: 4}
        _assert_launches(want)
        assert torch.isfinite(s.pos).all()
        for b in bodies:
            assert torch.isfinite(b.vel).all()
            eye = torch.eye(3, device=cuda)
            assert float((b.R @ b.R.T - eye).abs().max()) < 1e-5
    sp = 0.5 * float(params.interaction_radius)
    c = state.pos.mean(dim=0).cpu().numpy()
    es, statics, _ = nereus_tpu_torch.make_elastic_solid(
        sample_box_solid(c - 1.5 * sp, c + 1.5 * sp, sp), params, cfg, sp,
        grid=grid, density=400.0, device=cuda)
    ep = nereus_tpu_torch.elastic_params(1e5, damping=5.0, device=cuda)
    psi = nereus_tpu_torch.elastic_psi(statics, params, cfg)
    cuda_sweep.reset_launches()
    dfsph_cuda.LOOP.reset()
    dfsph_cuda.LOOP_V.reset()
    s = state
    for _ in range(2):
        s, es, diag = nereus_tpu_torch.dfsph_elastic_step(
            s, params, grid, cfg, es, statics, ep, psi, boundary, substeps=3)
    it = dfsph_cuda.LOOP.launched + dfsph_cuda.LOOP_V.launched
    corr = it + 2
    _assert_launches({K.DENSITY_ALPHA_SUMS: 2, K.BODY_DENSITY_ALPHA_SQ: 2,
                      K.DRHO: it, K.DRHO_SHELL: it,
                      K.PRESSURE_FORCE: corr, K.PRESSURE_FORCE_BODY: corr,
                      K.PRESSURE_FORCE_BODY_REV: corr, K.FORCE_P0: 2,
                      K.BODY_FORCE_P0: 2, K.FLUID_REACTION_P0: 2,
                      K.ELASTIC_F: 6, K.ELASTIC_FORCE_HG: 6})
    assert torch.isfinite(s.pos).all() and torch.isfinite(es.pos).all()
    assert int(diag.seg_overflow) == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("kernel_set", ["MULLER", "MONAGHAN"])
def test_wall_force_and_cell_check_match_plain_on_cuda(cuda, kernel_set):
    """The wall-only force kernel, both pressure instances, against its
    plain version (max|Δ| ≤ 1e-4·max|ref|) and against fused − fluid-only;
    the cell check kernel equal to ``grid.cell_coords_cols`` on the live
    and the parked slots, on the compact and on a padded grid past 2²⁴
    cells."""
    from nereus_tpu_torch.probes import cells
    cfg, params, state, grid, walls = _probe_scene(cuda)
    cfg = nereus_tpu_torch.SimConfig(
        kernel_set=nereus_tpu_torch.KernelSet[kernel_set])
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dens = SP.density_sweep_plain(cfg, *ctx.density_operands(
        params.particle_mass))
    q8, src = ctx.force_operands(vel, dens, tait_pd2(dens, params))[:2]
    w_s = (ctx.seg_start[9:] - ctx.c).contiguous()
    w_e = (ctx.seg_end[9:] - ctx.c).contiguous()
    fluid_end = ctx.seg_end.clone()
    fluid_end[9:] = ctx.seg_start[9:]
    cuda_sweep.reset_launches()
    for p in (True, False):
        got = SP.boundary_force_sweep(cfg, q8, ctx.b_src, w_s, w_e, ctx.pvec,
                                      include_pressure=p)
        ref = SP.boundary_force_sweep_plain(cfg, q8, ctx.b_src, w_s, w_e,
                                            ctx.pvec, include_pressure=p)
        _assert_columns_close(got, ref, f"wall force {p}")
        diff = (cuda_sweep.force_sweep(cfg, q8, src, ctx.seg_start,
                                       ctx.seg_end, ctx.pvec,
                                       include_pressure=p)
                - cuda_sweep.force_sweep(cfg, q8, src, ctx.seg_start,
                                         fluid_end, ctx.pvec,
                                         include_pressure=p))
        _assert_columns_close(diff, ref, f"fused - fluid {p}")
    for g in (grid, cells.pad_below(grid, 2 ** 24 // (grid.size[0]
                                                      * grid.size[1]) + 1)):
        gctx = build_sweep_ctx(state, params, g, cfg, None)
        q4 = gctx.queries(width=4)
        assert torch.equal(cells.cell_coords_in_kernel(q4, gctx.pvec, g),
                           cells.cell_coords_plain(q4, gctx.pvec, g))
        assert cells.cellcheck(state, params, g, cfg, quiet=True) == 0
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.WALL_FORCE: 1, cuda_sweep.WALL_FORCE_P0: 1,
                      cuda_sweep.FORCE: 2, cuda_sweep.FORCE_P0: 2,
                      cuda_sweep.CELL_CHECK: 4})


@pytest.mark.requires_cuda
def test_layout_probe_matches_plain_on_cuda(cuda):
    """Both layouts of the probe kernel against the plain version on the
    TPU probe's inputs, query by query (``layout.mismatched_queries``:
    |Δ| ≤ 1e-3·|ref| + 1e-4 per element, exactly 0 where ref is 0, finite,
    row 3 zero); the same check flags both planted faults."""
    from nereus_tpu_torch.probes import layout
    anchors, q, aos, soa = layout.device_inputs(2 ** 12, 64, cuda)
    ref = layout.probe_plain(anchors, q, aos, 64)
    assert int((ref[:3] != 0).any(dim=0).sum()) > 100
    for fault, wrong in layout.planted_faults(anchors, q, aos, 64,
                                              ref).items():
        assert layout.mismatched_queries(wrong, ref).any(), fault
    cuda_sweep.reset_launches()
    for src, is_soa in ((aos, False), (soa, True)):
        got = layout.layout_probe(anchors, q, src, 64, is_soa)
        bad = layout.mismatched_queries(got, ref)
        assert not bad.any(), (is_soa, int(bad.sum()))
    torch.cuda.synchronize()
    _assert_launches({cuda_sweep.LAYOUT_AOS: 1, cuda_sweep.LAYOUT_SOA: 1})
