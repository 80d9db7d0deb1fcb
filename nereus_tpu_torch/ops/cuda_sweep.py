"""Build, load and launch the hand-written CUDA sweep kernels
(``csrc/sph_sweep.cu``; the counterpart of ``nereus_tpu.ops.pallas_neighbors``).

The sources are compiled with nvcc for ``sm_90a`` into a shared library
with a plain C interface, in this package's ``build/`` directory, at first
use and again whenever a source is newer than the library; the library is
loaded with ctypes. Importing this module needs no nvcc and no GPU.

Each wrapper checks device, dtype, shape, contiguity and alignment, and
raises on anything else; allocates its output with ``torch.empty``;
launches on the current stream without synchronising; counts the launch
in its kernel's ``launches``; and raises if ``cudaGetLastError`` reports
a failure.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from ..params import SimConfig

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libnereus_sweep.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class Kernel:
    """A kernel of the library with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


DENSITY = Kernel("density_sweep_kernel")
FORCE = Kernel("force_sweep_kernel")
KERNELS = (DENSITY, FORCE)

_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc_path() -> str | None:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    return shutil.which("nvcc")


def build() -> str:
    """Compile the kernels into ``LIB_PATH``; returns nvcc's output (the
    ptxas register and spill report). Raises RuntimeError if nvcc is
    missing or the build fails."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA sweep "
                           "kernels need the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *sources()],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
        return res.stdout + res.stderr
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def load():
    """The loaded library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build()
        lib = ctypes.CDLL(LIB_PATH)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nereus_density_sweep.restype = i32
        lib.nereus_density_sweep.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, ptr, i32, ptr, ptr]
        lib.nereus_force_sweep.restype = i32
        lib.nereus_force_sweep.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, ptr, i32, i32, ptr, ptr]
        lib.nereus_cuda_error_string.restype = ctypes.c_char_p
        lib.nereus_cuda_error_string.argtypes = [i32]
        _lib = lib
        return _lib


def _check(name, t, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_inputs(q, fq, src, seg_start, seg_end, pvec):
    from .sph_pairs import PV_LEN, SRC_WIDTH
    n = q.shape[0]
    n_rows = seg_start.shape[0] if seg_start.dim() == 2 else -1
    if n_rows not in (9, 18):
        raise ValueError(f"seg_start must be (9 or 18, N), got "
                         f"{tuple(seg_start.shape)}")
    _check("q", q, torch.float32, (n, fq))
    _check("src", src, torch.float32, (src.shape[0], SRC_WIDTH))
    _check("seg_start", seg_start, torch.int32, (n_rows, n))
    _check("seg_end", seg_end, torch.int32, (n_rows, n))
    _check("pvec", pvec, torch.float32, (PV_LEN,))
    devs = {t.device for t in (q, src, seg_start, seg_end, pvec)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return n, n_rows


def _raise_on(lib, kernel: Kernel, rc: int):
    if rc != 0:
        msg = (lib.nereus_cuda_error_string(rc).decode() if rc > 0
               else "unknown kernel switch value")
        raise RuntimeError(f"{kernel.name} launch failed ({rc}): {msg}")


def density_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """ρ (N,) from the density kernel: q (N, 4), src (M, 8)."""
    n, n_rows = _check_inputs(q, 4, src, seg_start, seg_end, pvec)
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nereus_density_sweep(
            q.data_ptr(), src.data_ptr(), seg_start.data_ptr(),
            seg_end.data_ptr(), n, n_rows, pvec.data_ptr(),
            cfg.kernel_set.value, out.data_ptr(), stream)
    DENSITY.launches += 1
    _raise_on(lib, DENSITY, rc)
    return out


def force_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Forces (N, 3) from the fused fluid + boundary force kernel:
    q (N, 8), src (M, 8)."""
    n, n_rows = _check_inputs(q, 8, src, seg_start, seg_end, pvec)
    out = torch.empty((n, 3), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    lib = load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.nereus_force_sweep(
            q.data_ptr(), src.data_ptr(), seg_start.data_ptr(),
            seg_end.data_ptr(), n, n_rows, pvec.data_ptr(),
            cfg.kernel_set.value, cfg.surface_tension_model.value,
            out.data_ptr(), stream)
    FORCE.launches += 1
    _raise_on(lib, FORCE, rc)
    return out
