"""ctypes loader for the native C++ host components (``native/``).

The same ``native/nereus_native.cpp`` the JAX package loads, compiled with
g++ into this package's ``build/`` directory on first use (and again when
the source is newer than the library). Every entry point returns None
when no compiler is present, and the callers then take their numpy path.
This is one-time host set-up (the boundary samples' volumes), not the
per-step kernel path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "nereus_native.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_LIB_PATH = os.path.join(_BUILD, "libnereus_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # compile to a private name, then rename: concurrent test workers
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_LIB_PATH) or \
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.nereus_compute_vbi.restype = None
        lib.nereus_compute_vbi.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def compute_vbi(positions, interaction_radius, kernel_set_id: int
                ) -> np.ndarray | None:
    """Native Akinci volume computation; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float64)
    m = pos.shape[0]
    out = np.empty((m,), dtype=np.float64)
    lib.nereus_compute_vbi(_dptr(pos), m, float(interaction_radius),
                           int(kernel_set_id), _dptr(out))
    return out
