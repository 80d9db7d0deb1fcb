"""Build, load and launch the hand-written CUDA sweep kernels
(``csrc/sph_sweep.cu`` for the density and force sweeps,
``csrc/iisph_sweep.cu`` for IISPH, ``csrc/dfsph_sweep.cu`` for DFSPH,
``csrc/multiphase_sweep.cu`` for multiphase WCSPH and XSPH,
``csrc/dfsph_multiphase_sweep.cu`` for multiphase DFSPH,
``csrc/viscosity_sweep.cu`` for the implicit viscosity solve,
``csrc/pbf_sweep.cu`` for PBF, ``csrc/coupled_sweep.cu`` for the
rigid-body contact, ``csrc/elastic_sweep.cu`` for the elastic solid and
its fluid coupling, and the body forms of the DFSPH sweeps for the DFSPH
couplings in the files of their functors; the counterpart of
``nereus_tpu.ops.pallas_neighbors``), and the two probes of
``nereus_tpu_torch.probes``: ``csrc/cell_check.cu`` (in-kernel cell
coordinates) and ``csrc/layout_probe.cu`` (the source-layout probe).

Each ``csrc/*.cu`` is compiled with nvcc for ``sm_90a`` into an object,
all at once in parallel, and the objects are linked into one shared
library with a plain C interface, in this package's ``build/`` directory,
at first use and again whenever a source is newer than the library; the
library is loaded with ctypes. Importing this module needs no nvcc and no
GPU.

Each wrapper checks device, dtype, shape, contiguity and alignment, and
raises on anything else; allocates its output with ``torch.empty``;
launches on the current stream without synchronising; counts the launch
in its kernel's ``launches``; and raises if ``cudaGetLastError`` reports
a failure.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
              "-O3", "-Xcompiler", "-fPIC")


class Kernel:
    """A kernel of the library with its launch count."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


DENSITY = Kernel("density_sweep_kernel")
FORCE = Kernel("force_sweep_kernel")
FORCE_P0 = Kernel("force_sweep_kernel<PRESSURE=0>")
# IISPH's d_ii, ρ_adv and a_ii: one walk, a_ii formed in its epilogue
DII_AII = Kernel("group_pair_sweep_kernel<DiiAii>")
SUM_DIJ = Kernel("group_pair_sweep_kernel<SumDij>")
JACOBI = Kernel("group_pair_sweep_kernel<Jacobi>")
PRESSURE_FORCE = Kernel("tiled_pair_sweep_kernel<PressureForce>")
# the density kernel at PCISPH's predicted positions, counted apart
DENSITY_PRED = Kernel("density_sweep_kernel<predicted>")
# DFSPH's density and factor α in one walk: (ρ, α), and the couplings'
# form (ρ and α's four sums), each counted apart
DENSITY_ALPHA = Kernel("group_pair_sweep_kernel<DensityAlpha>")
DENSITY_ALPHA_SUMS = Kernel("group_pair_sweep_kernel<DensityAlpha<SUMS>>")
DRHO = Kernel("group_pair_sweep_kernel<Drho>")
MP_DENSITY = Kernel("group_pair_sweep_kernel<MultiphaseDensity>")
MP_FORCE = Kernel("group_pair_sweep_kernel<MultiphaseForce>")
XSPH = Kernel("group_pair_sweep_kernel<Xsph>")
# the force kernel without the viscosity and the wall friction (the
# implicit viscosity solve owns both): WCSPH's, then DFSPH's pressure-off
FORCE_V0 = Kernel("force_sweep_kernel<VISC=0>")
FORCE_P0_V0 = Kernel("force_sweep_kernel<PRESSURE=0,VISC=0>")
VISC_LAPLACIAN = Kernel("tiled_pair_sweep_kernel<ViscLaplacian>")
# multiphase DFSPH's density and α̂'s sums in one walk
MP_DENSITY_ALPHA = Kernel("group_pair_sweep_kernel<MultiphaseDensityAlpha>")
MP_DRHO = Kernel("group_pair_sweep_kernel<MultiphaseDrho>")
MP_KAPPA = Kernel("pair_sweep_kernel<MultiphaseKappa>")
# PBF's (ρ, λ), Δp and ω, and vorticity confinement's N (the λ sums over
# the fluid rows), each counted apart
PBF_LAMBDA = Kernel("group_pair_sweep_kernel<PbfLambda>")
PBF_DP = Kernel("group_pair_sweep_kernel<PbfDp>")
PBF_OMEGA = Kernel("group_pair_sweep_kernel<PbfOmega>")
PBF_GRAD = Kernel("group_pair_sweep_kernel<PbfGrad>")
# the force kernels whose wall friction reads a moving wall's velocity:
# WCSPH's, then the implicit solvers' pressure-off one; the multiphase one
FORCE_MOVING = Kernel("force_sweep_kernel<MOVING=1>")
FORCE_P0_MOVING = Kernel("force_sweep_kernel<PRESSURE=0,MOVING=1>")
MP_FORCE_MOVING = Kernel(
    "group_pair_sweep_kernel<MultiphaseForce,MOVING>")
# the rigid-body coupling: a body shell's ψ-density (the density kernel
# over the body source, counted apart) and the two contact sweeps
BODY_DENSITY = Kernel("density_sweep_kernel<body>")
BODY_FORCE = Kernel("group_pair_sweep_kernel<BodyForce>")
MP_BODY = Kernel("pair_sweep_kernel<MultiphaseBody>")
# the elastic solid's deformation gradient and fused force + hourglass
# (both over the body's static pair list), and the fluid's reaction on an
# elastic body's samples
ELASTIC_F = Kernel("group_list_sweep_kernel<ElasticF>")
ELASTIC_FORCE_HG = Kernel(
    "group_list_sweep_kernel<ElasticForceHourglass>")
FLUID_REACTION = Kernel("pair_sweep_kernel<FluidReaction>")
# the DFSPH couplings: the two contacts' friction alone, the body forms of
# the DFSPH sweeps over a body shell (rows 0-8), the shell's ψ-density with
# α's shell sums in one walk (their boundary form, and with Σ|ψ_b∇W|², the
# fluid form) and Drho over a shell's 9 rows, each counted apart; the κ
# impulse forward (the fluid rows as queries over a shell) and reverse (a
# body's samples as queries over the fluid rows) apart
BODY_FORCE_P0 = Kernel("group_pair_sweep_kernel<BodyForce<PRESSURE=0>>")
FLUID_REACTION_P0 = Kernel("pair_sweep_kernel<FluidReaction<PRESSURE=0>>")
PRESSURE_FORCE_BODY = Kernel(
    "group_pair_sweep_kernel<BodyPressureForce><shell>")
PRESSURE_FORCE_BODY_REV = Kernel(
    "group_pair_sweep_kernel<BodyPressureForce>")
BODY_DENSITY_ALPHA = Kernel("group_pair_sweep_kernel<ShellDensityAlpha>")
BODY_DENSITY_ALPHA_SQ = Kernel(
    "group_pair_sweep_kernel<ShellDensityAlpha<SQ>>")
DRHO_SHELL = Kernel("group_pair_sweep_kernel<DrhoShell>")
MP_ALPHA_BODY = Kernel("pair_sweep_kernel<BoundaryForm<MultiphaseAlpha>>")
MP_DRHO_BODY = Kernel("pair_sweep_kernel<BoundaryForm<MultiphaseDrho>>")
MP_KAPPA_BODY = Kernel(
    "group_pair_sweep_kernel<GroupBoundaryForm<MultiphaseKappa>>")
# the wall-only force (the JAX package's boundary_force_sweep), with and
# without the wall pressure
WALL_FORCE = Kernel("pair_sweep_kernel<WallForce>")
WALL_FORCE_P0 = Kernel("pair_sweep_kernel<WallForce<PRESSURE=0>>")
# the probes: the in-kernel cell check and the two source layouts
CELL_CHECK = Kernel("cell_check_kernel")
LAYOUT_AOS = Kernel("layout_probe<AoS>")
LAYOUT_SOA = Kernel("layout_probe<SoA>")
KERNELS = (DENSITY, FORCE, FORCE_P0, DII_AII, SUM_DIJ, JACOBI, PRESSURE_FORCE,
           DENSITY_PRED, DENSITY_ALPHA, DENSITY_ALPHA_SUMS, DRHO, MP_DENSITY,
           MP_FORCE, XSPH, FORCE_V0, FORCE_P0_V0, VISC_LAPLACIAN,
           MP_DENSITY_ALPHA,
           MP_DRHO, MP_KAPPA, PBF_LAMBDA, PBF_DP, PBF_OMEGA, FORCE_MOVING,
           FORCE_P0_MOVING, MP_FORCE_MOVING, BODY_DENSITY, BODY_FORCE,
           MP_BODY, ELASTIC_F, ELASTIC_FORCE_HG, FLUID_REACTION,
           BODY_FORCE_P0, FLUID_REACTION_P0, PRESSURE_FORCE_BODY,
           BODY_DENSITY_ALPHA, BODY_DENSITY_ALPHA_SQ, DRHO_SHELL,
           MP_ALPHA_BODY, MP_DRHO_BODY, MP_KAPPA_BODY, WALL_FORCE,
           WALL_FORCE_P0, CELL_CHECK, LAYOUT_AOS, LAYOUT_SOA, PBF_GRAD,
           PRESSURE_FORCE_BODY_REV)

_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in KERNELS:
        k.launches = 0


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _inputs_of_build():
    return sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def nvcc_path() -> str | None:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    return shutil.which("nvcc")


def _run_all(cmds, timeout=900):
    """Runs the commands side by side; returns their combined output and
    raises RuntimeError naming the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for c, p in zip(cmds, procs):
            out, _ = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(c)}\n{out}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return "".join(outs)


def build() -> str:
    """Compile the kernels into ``LIB_PATH``, one nvcc per source, all
    started together, then one link; returns nvcc's output (the ptxas
    register and spill report). Raises RuntimeError if nvcc is missing or
    the build fails."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA sweep "
                           "kernels need the CUDA toolkit")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o")
                for s in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", s,
                         "-o", o] for s, o in zip(sources(), objs)])
        lib = os.path.join(tmpdir, "lib.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, LIB_PATH)
        return log
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in _inputs_of_build())


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
        for fn, n_switches in _SWEEP_FNS.items():
            f = getattr(lib, f"nereus_{fn}_sweep")
            f.restype = i32
            f.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, i32,
                          *[i32] * n_switches, ptr, ptr]
        for fn in _LIST_FNS:
            f = getattr(lib, f"nereus_{fn}_list_sweep")
            f.restype = i32
            f.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i32, i32, ptr, ptr]
        for fn in _TILED_FNS:
            f = getattr(lib, f"nereus_{fn}_tiled_sweep")
            f.restype = i32
            f.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, i32,
                          i32, ptr, i32, ptr, ptr]
        lib.nereus_cell_check.restype = i32
        lib.nereus_cell_check.argtypes = [ptr, i32, i32, ptr, i32, i32, i32,
                                          ptr, ptr]
        lib.nereus_layout_probe.restype = i32
        lib.nereus_layout_probe.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                            i32, ptr, ptr]
        lib.nereus_empty_kernel.restype = i32
        lib.nereus_empty_kernel.argtypes = [ptr]
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


def _check_inputs(q, fq, src, seg_start, seg_end, pvec, fs=None,
                  rows=(9, 18)):
    """Checks a sweep's operands: q (N, fq), src (M, fs) (default the
    8-wide source), ranges (n_rows, N) with n_rows in ``rows``."""
    from .sph_pairs import PV_LEN, SRC_WIDTH
    n = q.shape[0]
    n_rows = seg_start.shape[0] if seg_start.dim() == 2 else -1
    if n_rows not in rows:
        raise ValueError(f"seg_start must be ({' or '.join(map(str, rows))}"
                         f", N), got {tuple(seg_start.shape)}")
    _check("q", q, torch.float32, (n, fq))
    _check("src", src, torch.float32, (src.shape[0], fs or SRC_WIDTH))
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


# the C entry points nereus_<fn>_sweep(q, src, seg_start, seg_end, n,
# n_rows, pvec, kernel_set, *switches, out, stream), by their number of
# int switches after kernel_set
_SWEEP_FNS = {"density": 1, "force": 5, "dii_aii": 1, "sum_dij": 1,
              "jacobi": 1, "density_alpha": 1, "density_alpha_sums": 1,
              "drho": 1, "drho_shell": 1,
              "multiphase_density": 1, "multiphase_force": 3,
              "xsph": 1, "multiphase_density_alpha": 1,
              "multiphase_drho": 1, "multiphase_kappa": 0, "pbf_lambda": 1,
              "pbf_dp": 1, "pbf_omega": 1, "pbf_grad": 1, "body_force": 1,
              "body_force_p0": 1,
              "multiphase_body": 0, "fluid_reaction": 1,
              "pressure_force_body": 1, "pressure_force_body_rev": 1,
              "body_density_alpha": 1, "body_density_alpha_sq": 1,
              "multiphase_alpha_body": 0, "multiphase_drho_body": 0,
              "multiphase_kappa_body": 1, "wall_force": 1}


def _launch(kernel: Kernel, fn: str, device, *args):
    """Launches the entry point ``nereus_<fn>`` with ``args`` and the
    current stream of ``device``; counts and checks the launch."""
    lib = load()
    with torch.cuda.device(device):
        rc = getattr(lib, f"nereus_{fn}")(
            *args, torch.cuda.current_stream().cuda_stream)
    kernel.launches += 1
    _raise_on(lib, kernel, rc)


def _sweep(kernel: Kernel, fn: str, cfg: SimConfig, q, fq, src, fs,
           seg_start, seg_end, pvec, rows, out_cols, *switches,
           planes=False):
    """Checks and launches one kernel of ``_SWEEP_FNS``: q (N, fq),
    src (M, fs), ranges with a row count in ``rows``, the entry point's
    int ``switches``; the output is (N, out_cols), or (N,) for
    out_cols 0, or with ``planes`` the (N, out_cols) transpose of the
    (out_cols, N) planes the kernel writes (each column contiguous)."""
    n, n_rows = _check_inputs(q, fq, src, seg_start, seg_end, pvec, fs=fs,
                              rows=rows)
    shape = (out_cols, n) if planes else (n, out_cols) if out_cols else (n,)
    out = torch.empty(shape, dtype=torch.float32, device=q.device)
    if n:
        _launch(kernel, f"{fn}_sweep", q.device, q.data_ptr(),
                src.data_ptr(), seg_start.data_ptr(), seg_end.data_ptr(), n,
                n_rows, pvec.data_ptr(), cfg.kernel_set.value, *switches,
                out.data_ptr())
    return out.t() if planes else out


# the C entry points nereus_<fn>_list_sweep(q, src, nbr_start, nbr, n,
# pvec, kernel_set, group, out, stream) of group_list_sweep_kernel
_LIST_FNS = ("elastic_f", "elastic_force_hourglass")


def _list(kernel: Kernel, fn: str, cfg: SimConfig, q, fq, src, fs,
          nbr_start, nbr, pvec, out_cols, group):
    """Checks and launches one kernel of ``_LIST_FNS`` at lane-group size
    ``group``: q (N, fq), src (M, fs), the static pair list nbr_start
    (N + 1,) and nbr (P,) int32; the output is (N, out_cols)."""
    from .sph_pairs import PV_LEN
    n = q.shape[0]
    _check("q", q, torch.float32, (n, fq))
    _check("src", src, torch.float32, (src.shape[0], fs))
    _check("nbr_start", nbr_start, torch.int32, (n + 1,))
    _check("nbr", nbr, torch.int32, (nbr.shape[0],))
    _check("pvec", pvec, torch.float32, (PV_LEN,))
    devs = {t.device for t in (q, src, nbr_start, nbr, pvec)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    out = torch.empty((n, out_cols), dtype=torch.float32, device=q.device)
    if n:
        _launch(kernel, f"{fn}_list_sweep", q.device, q.data_ptr(),
                src.data_ptr(), nbr_start.data_ptr(), nbr.data_ptr(), n,
                pvec.data_ptr(), cfg.kernel_set.value, group, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# The row-tiled engine (csrc/tiled_sweep.cuh): its tile plan and launch
# ---------------------------------------------------------------------------

# the C entry points nereus_<fn>_tiled_sweep of tiled_pair_sweep_kernel
_TILED_FNS = ("visc_laplacian", "pressure_force")
# queries per tile (threads per CTA): of 64 / 128 / 256, timed alike by
# chip_smoke.py's tile_stats on the H100, 128 gives the least launches per
# step × kernel ms on the two kernels' worst paths, the 1M dam-break's
# viscosity CG and PCISPH's corrective loop; 64 is faster on the settled
# DFSPH block's CG (PERF.md §6)
TILE = 128


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The tiles of a step's hash-sorted queries (:func:`tile_plan`).

    Tile t holds the queries ``bounds[t]`` .. ``bounds[t + 1] − 1`` for t
    below ``n_tiles`` ((1,) int32 on the device); ``bounds`` is (n_ctas +
    1,) int32, n for the slots past the tile count. The kernel launches
    ``n_ctas`` CTAs, an upper bound that needs no host read, and the CTAs
    past the count exit. ``sorted_hash`` tells the kernel a parked tile."""

    bounds: torch.Tensor
    n_tiles: torch.Tensor
    sorted_hash: torch.Tensor
    tile: int

    @property
    def n_ctas(self) -> int:
        return self.bounds.shape[0] - 1


def tile_plan(sorted_hash, grid_size, tile: int = TILE) -> TilePlan:
    """The tile plan of the hash-sorted queries ``sorted_hash`` (N,) int32
    on a grid of ``grid_size`` cells, in torch on their device, with no
    host read: a tile starts at each (y, z) cell row's first query (hash
    // gx; parked slots, ``INT32_MAX``, sort last, a row of their own) and
    every ``tile`` queries after it, so a row of k queries makes
    ceil(k / tile) tiles and at most ``min(N, ceil(N / tile) + gy·gz)``
    tiles exist."""
    if tile < 32 or tile % 32 or tile > 256:
        raise ValueError(f"tile must be a multiple of 32 in [32, 256], got "
                         f"{tile}")
    n = sorted_hash.shape[0]
    _, gy, gz = (int(g) for g in grid_size)
    dev = sorted_hash.device
    n_ctas = max(1, min(n, -(-n // tile) + gy * gz))
    key = (sorted_hash // int(grid_size[0])).contiguous()
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    start = (idx - torch.searchsorted(key, key, out_int32=True)) % tile == 0
    # the 1-based tile number of each query; tile t starts at the first
    # query numbered t + 1 (n past the last tile)
    number = torch.cumsum(start, 0, dtype=torch.int32)
    bounds = torch.searchsorted(
        number, torch.arange(1, n_ctas + 2, dtype=torch.int32, device=dev),
        out_int32=True)
    n_tiles = (number[-1:] if n else torch.zeros(1, dtype=torch.int32,
                                                 device=dev))
    return TilePlan(bounds, n_tiles, sorted_hash, tile)


def tile_spans(plan: TilePlan, seg_start, seg_end):
    """(n_tiles, n_rows, 2) int64: per tile and range row the span ``lo``
    and its length, as the kernel computes them: [s of the tile's first
    query, e of its last), empty (0, 0) for a parked tile. The plain
    version of the kernel's span step, for tests and statistics; reads
    ``n_tiles`` to the host."""
    from ..grid import INT32_MAX
    nt = int(plan.n_tiles[0])
    b = plan.bounds[:nt + 1].long()
    first, last = b[:-1], b[1:] - 1
    lo = seg_start.long().index_select(1, first)
    length = (seg_end.long().index_select(1, last) - lo).clamp(min=0)
    length = torch.where(plan.sorted_hash[first] == INT32_MAX, 0, length)
    lo = torch.where(length > 0, lo, 0)
    return torch.stack([lo, length], dim=-1).transpose(0, 1)


def _check_plan(plan, n: int, device):
    if not isinstance(plan, TilePlan):
        raise ValueError("the tiled sweeps need a TilePlan "
                         "(cuda_sweep.tile_plan) of their queries")
    if plan.sorted_hash.shape[0] != n or plan.bounds.device != device:
        raise ValueError(f"the tile plan is for {plan.sorted_hash.shape[0]} "
                         f"queries on {plan.bounds.device}, not {n} on "
                         f"{device}")


def _tiled(kernel: Kernel, fn: str, cfg: SimConfig, q, fq, src, fs,
           seg_start, seg_end, pvec, plan, out_cols):
    """Checks and launches one kernel of ``_TILED_FNS`` over ``plan``:
    q (N, fq), src (M, fs), ranges (9 or 18, N); the output is
    (N, out_cols)."""
    n, n_rows = _check_inputs(q, fq, src, seg_start, seg_end, pvec, fs=fs)
    _check_plan(plan, n, q.device)
    out = torch.empty((n, out_cols), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    _launch(kernel, f"{fn}_tiled_sweep", q.device, q.data_ptr(),
            src.data_ptr(), seg_start.data_ptr(), seg_end.data_ptr(), n,
            n_rows, plan.bounds.data_ptr(), plan.n_tiles.data_ptr(),
            plan.sorted_hash.data_ptr(), plan.n_ctas, plan.tile,
            pvec.data_ptr(), cfg.kernel_set.value, out.data_ptr())
    return out


# lanes per query G of the density and force kernels (csrc/sph_sweep.cu,
# which builds only the instances these choose), by query count and
# switches, as measured on the H100 (PERF.md section 6): below ``SMALL_N``
# queries 4 lanes per query fill the card best; above it the density takes
# 2, the force 1 (its lone lane loading the next candidate ahead) when the
# pair carries the viscosity's divisions, else 2. A body shell's
# ψ-density runs over ranges that are empty for nearly every query (under
# 1 % on the 256k cells): below ``SMALL_SHELL`` samples (a rigid box's
# 56) the few busy queries have few candidates, and 2 lanes per query
# build the empty queries' row tables more cheaply; a larger shell (an
# elastic cube's 4,096) gives its busy queries many, which 4 lanes split.
SMALL_N = 2 ** 19
SMALL_SHELL = 512


def density_group(n: int) -> int:
    """The density kernel's G for ``n`` queries, and the multiphase density
    kernel's (``csrc/multiphase_sweep.cu`` builds these two), as measured
    for it by ``tools/group_scan.py --keys multiphase_density`` (PERF.md
    section 6): at ``multiphase_1M``'s 1,092,727 queries G 4 took 7 % more
    than G 2, at the multiphase DFSPH block's 262,144 G 2 4 % more than
    G 4."""
    return 4 if n < SMALL_N else 2


def force_group(n: int, include_viscosity=True) -> int:
    """The force kernel's G for ``n`` queries."""
    if n < SMALL_N:
        return 4
    return 1 if include_viscosity else 2


def body_group(m: int) -> int:
    """The density kernel's G over a body shell of ``m`` samples."""
    return 2 if m < SMALL_SHELL else 4


# lanes per query G of the IISPH Jacobi loop's two kernels
# (``csrc/iisph_sweep.cu``, which builds only these), one each at every
# query count, as measured on the H100 at 1,092,727 queries (PERF.md
# section 6): SumDij, a 16-byte row and a few operations per pair over 9
# rows like the density's, takes the density's G 2 there (4 took 9 % and 1
# 15 % more time); Jacobi, whose 18 rows the engine walks as one list,
# takes 4 (2 took 7 % and 8 lanes 27 % more time). No path runs IISPH
# below ``SMALL_N`` queries, where the density takes 4.
SUM_DIJ_G = 2
JACOBI_G = 4
# And of the pre-loop sweep of d_ii, ρ_adv and a_ii, once per step: 4
# (``tools/group_scan.py --solver iisph``: 2 took 2.6 % and 8 21 % more
# time). Its Müller instance spills 4 bytes, the parameter vector's
# pointer, stored once before the row scan and reloaded after it, outside
# the candidate loop.
DII_AII_G = 4


# lanes per query G of the PBF loop's λ and Δp kernels and of N
# (``csrc/pbf_sweep.cu``, which builds only these), as measured on the
# H100 (``tools/group_scan.py``; PERF.md section 6): λ takes 2 at every
# query count (4 took 6 % more time at 1,092,727 queries and 1 % less at
# 262,144); Δp 4 below ``SMALL_N`` queries and 2 above, as the density (4
# lost 7 % above, 2 lost 4 % below); N, the λ sums over the 9 fluid rows
# of ``pbf_1M_vort_xsph``'s 1,092,727 queries, 2 (4 and 1 lost 14 % and
# 11 %).
PBF_LAMBDA_G = 2
PBF_GRAD_G = 2
# And of ω, (m/ρ_j)(v_j − v_i) × ∇W over the fluid rows of
# ``pbf_1M_vort_xsph``'s one (C, 8) matrix (1,092,727 queries), once per
# step: 2, the one instance built (``tools/group_scan.py --solver
# pbf_vort_xsph --keys pbf_omega``: G 1, 4 and 8 took 15 %, 8 % and 44 %
# more time; no path runs it below ``SMALL_N``).
PBF_OMEGA_G = 2


def pbf_dp_group(n: int) -> int:
    """The Δp kernel's G for ``n`` queries."""
    return 4 if n < SMALL_N else 2


# lanes per query G of DFSPH's Dρ/Dt kernel (``csrc/dfsph_sweep.cu``, which
# builds only this one), as measured on the H100 at the settled
# 262,144-particle block (``tools/group_scan.py --solver dfsph``; PERF.md
# section 6: 2 took 19 % and 8 22 % more time).
DRHO_G = 4
# And of its density and factor α in one walk, both forms (the one instance
# of each built), as measured at the settled 262,144-particle block, the
# size of every path that runs them (``tools/group_scan.py --solver dfsph
# --keys density_alpha``: G 1, 2 and 8 took 35 %, 6 % and 23 % more
# time).
DENSITY_ALPHA_G = 4


# lanes per query G of the multiphase force kernel
# (``csrc/multiphase_sweep.cu``, which builds only these), as measured on
# the H100 (``tools/group_scan.py``; PERF.md section 6): 4 below
# ``SMALL_N`` queries (the 262,144-particle multiphase DFSPH and coupled
# cells: G 1, 2 and 8 took 4-19 % more time); above it (``multiphase_1M``,
# 1,092,727) 2 with static walls, as fast as G 1, whose instances spill,
# and 4 with moving walls (G 2 took 6 % more time there). And of
# multiphase DFSPH's dδ̂/dt kernel (``csrc/dfsph_multiphase_sweep.cu``,
# the one instance built), 4 at every query count (G 2 took 10 % and G 8
# 24 % more time at 262,144 queries; no path runs it above ``SMALL_N``).
MP_DRHO_G = 4
# And of XSPH (``csrc/multiphase_sweep.cu``, the one instance built), over
# the fluid rows of its one (C, 8) matrix: 2 at every query count, as
# measured at the two paths that run it, ``wcsph_1M_xsph`` and
# ``pbf_1M_vort_xsph``, both 1,092,727 queries (``tools/group_scan.py
# --keys xsph``: G 4 and 8 took 11 % / 14 % and 38 % / 45 % more time; G
# 1 2 % more at the first and 1 % less at the second, one G for both; no
# path runs it below ``SMALL_N``).
XSPH_G = 2
# And of multiphase DFSPH's density and α̂ sums in one walk
# (``csrc/dfsph_multiphase_sweep.cu``, the one instance built): 4, as
# measured on an NVIDIA H100 80GB HBM3 at 700.00 W at the two paths that
# run it, ``dfsph_mp_256k_settled`` and ``dfsph_mp_coupled_256k``, both
# 262,144 queries (``tools/group_scan.py --keys mp_density_alpha``: G 1,
# 2 and 8 took 25 %, 12 % and 23 % more time; the multiphase density
# kernel and α̂'s one-thread walk it replaces 83 % more; no path runs it
# above ``SMALL_N``).
MP_DENSITY_ALPHA_G = 4


def mp_force_group(n: int, moving_boundary=False) -> int:
    """The multiphase force kernel's G for ``n`` queries."""
    return 4 if n < SMALL_N or moving_boundary else 2


# lanes per query G of the two elastic kernels over the body's pair list,
# the deformation gradient's and the force + hourglass
# (``csrc/elastic_sweep.cu``, which builds only these), as measured on an
# NVIDIA H100 80GB HBM3 at 700.00 W (``tools/group_scan.py --solver
# elastic`` and ``wcsph_elastic``; PERF.md section 6): 16 below
# ``SMALL_BODY`` queries (a 16³ cube's 4,096: at 8 and 32 the force +
# hourglass took 13 % more time, ElasticF 6 % and 10 %), 4 above (the 80³
# block's 512,000: at 2 and 8 the force + hourglass took 6 % and 10 %
# more, ElasticF 1 % and 19 %); between the two sizes not measured.
SMALL_BODY = 2 ** 16


def elastic_group(n: int) -> int:
    """The elastic kernels' G for ``n`` queries."""
    return 16 if n < SMALL_BODY else 4


# The sweeps of the fluid rows as queries over a body shell, the DFSPH
# couplings' κ impulse (``csrc/iisph_sweep.cu``), Dρ/Dt and the ψ-density
# with α's sums (``csrc/dfsph_sweep.cu``), the multiphase κ̂ correction
# (``csrc/dfsph_multiphase_sweep.cu``) and the body contact force, both
# forms (``csrc/coupled_sweep.cu``), which build only these, by the shell's
# size, as measured on an NVIDIA H100 80GB HBM3 at 700.00 W
# (``tools/group_scan.py --solver dfsph_coupled``, ``dfsph_elastic``;
# PERF.md section 6): under
# ``SMALL_SHELL`` samples (the rigid boxes' 56, nearly every query's runs
# empty) G 2 (both 4-5 % under one thread per query with its 9 bounds loaded
# at once; G 4 10-26 % over G 2); over a larger shell (an elastic cube's
# 4,096, in mid-fluid, whose busy queries fill whole warps) G 8 (G 4 and 16
# took 2-41 % more, one thread per query 35 %). The body contact force takes
# the same two (``--solver coupled``, ``wcsph_elastic``, ``dfsph_coupled``,
# ``dfsph_elastic``): at the 56-sample box G 2 0.0071 / 0.0080 ms against
# G 1 0.0070 / 0.0095, G 4 0.0094 / 0.0102 and the one-thread walk it
# replaced 0.0106 / 0.0093; at the 4,096-sample cube G 8 0.0218 / 0.0278
# against G 4 0.0237 / 0.0373, G 16 0.0330 / 0.0336 and the walk 0.0464 /
# 0.0528 (with the pressure at coupled_256k and wcsph_elastic_256k / its
# friction alone at the DFSPH couplings). The shell's ψ-density with α's
# sums in one walk and the multiphase κ̂ correction over a shell take the
# same two (``--keys body_density_alpha``, ``body_density_alpha_sq``,
# ``mp_kappa_body``): at the 56-sample box G 2 0.0068 / 0.0072 ms against
# G 1 0.0077 / 0.0082, G 4 0.0096 / 0.0098 and the walks they replaced
# 0.0157 (the density kernel with α's walk) / 0.0079; at the 4,096-sample
# cube G 8 0.0252 against G 4 0.0339, G 16 0.0335 and 0.0632. The reverse
# κ impulse, a body's samples as queries over the fluid rows: 16 lanes per
# sample at the 16³ cube's 4,096, the one body size a path runs (G 4 took
# 86 %, G 8 29 % and G 32 3 % more); the one instance built.
BODY_REV_G = 16


def shell_group(m: int) -> int:
    """The G of the sweeps over a body shell of ``m`` samples, the forward
    κ impulse, Dρ/Dt, the body contact force, the shell's ψ-density with
    α's sums and the multiphase κ̂ correction."""
    return 2 if m < SMALL_SHELL else 8


def _density(kernel, cfg, q, src, seg_start, seg_end, pvec, rows, group):
    return _sweep(kernel, "density", cfg, q, 4, src, 4, seg_start, seg_end,
                  pvec, rows, 0, group)


def density_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """ρ (N,) from the density kernel: q (N, 4) (slot 3 unread), src (M, 4)
    ``x y z ψ``."""
    return _density(DENSITY, cfg, q, src, seg_start, seg_end, pvec,
                    (9, 18), density_group(q.shape[0]))


def force_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                include_pressure=True, include_viscosity=True,
                moving_boundary=False):
    """Forces (N, 3) from the fused fluid + boundary force kernel:
    q (N, 8) ``x y z v ρ pd2``, src (M, 8) with pd2_j in the fluid rows'
    slot 7 (the fluid rows may be the query itself);
    ``include_pressure=False`` launches the pressure-off instance (the
    implicit solvers' advection forces; slot 7 unread),
    ``include_viscosity=False`` the instance without viscosity and wall
    friction (the implicit viscosity solve owns both),
    ``moving_boundary=True`` the instance whose wall friction reads the
    wall velocities of the boundary rows (without friction no wall term
    reads them, and the static instance runs), each counted in its own
    ``Kernel``."""
    moving = bool(moving_boundary) and bool(include_viscosity)
    kernel = {(True, True, False): FORCE, (False, True, False): FORCE_P0,
              (True, False, False): FORCE_V0,
              (False, False, False): FORCE_P0_V0,
              (True, True, True): FORCE_MOVING,
              (False, True, True): FORCE_P0_MOVING}[
        bool(include_pressure), bool(include_viscosity), moving]
    return _sweep(kernel, "force", cfg, q, 8, src, 8, seg_start, seg_end,
                  pvec, (9, 18), 3, cfg.surface_tension_model.value,
                  int(bool(include_pressure)), int(bool(include_viscosity)),
                  int(moving), force_group(q.shape[0], include_viscosity))


def dii_aii_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """(d_ii xyz, Δρ_adv, a_ii) (N, 5), each column a contiguous (N,)
    plane: src (M, 12), fluid rows ``x y z v_adv m v 1/ρ² 0``, then the
    wall rows ``x y z v_b ψ_b 0…``; q (N, 12) its first N rows
    (``iisph_cuda.dii_aii_operands``)."""
    from .sph_pairs import WIDE_WIDTH
    return _sweep(DII_AII, "dii_aii", cfg, q, 12, src, WIDE_WIDTH, seg_start,
                  seg_end, pvec, (9, 18), 5, DII_AII_G, planes=True)


def sum_dij_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Σd_ij·p_j (N, 3) over the fluid rows only: q (N, 4) and src (M, 4)
    ``x y z p/ρ²`` (the step's one matrix), ranges (9, N)."""
    return _sweep(SUM_DIJ, "sum_dij", cfg, q, 4, src, 4, seg_start,
                  seg_end, pvec, (9,), 3, SUM_DIJ_G)


def jacobi_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Jacobi off-diagonal sum (N,): q (N, 8), src (M, 8) with
    e_j = d_jj·p_j + Σd_jk·p_k in the fluid rows' slots 3-5."""
    return _sweep(JACOBI, "jacobi", cfg, q, 8, src, 8, seg_start, seg_end,
                  pvec, (9, 18), 0, JACOBI_G)


def pressure_force_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                         plan: TilePlan | None = None):
    """Implicit-solver pressure force (N, 3): q (N, 4), src (M, 8), the
    row-tiled kernel over ``plan`` (:func:`tile_plan` of the queries)."""
    return _tiled(PRESSURE_FORCE, "pressure_force", cfg, q, 4, src, 8,
                  seg_start, seg_end, pvec, plan, 3)


def predicted_density_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                            pvec):
    """PCISPH's predicted density ρ* (N,) from the density kernel, counted
    in ``DENSITY_PRED``: q (N, 4) and the source (M, 4) whose fluid rows
    hold the predicted positions, over the start-of-step ranges."""
    return _density(DENSITY_PRED, cfg, q, src, seg_start, seg_end, pvec,
                    (9, 18), density_group(q.shape[0]))


def density_alpha_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """DFSPH's (ρ, α) (N, 2), each column a contiguous (N,) plane, from one
    walk: src (M, 4) ``x y z ψ`` (the density's matrix, fluid rows ψ = m,
    wall rows ψ_b), q (N, 4) its first N rows (slot 3 unread)."""
    return _sweep(DENSITY_ALPHA, "density_alpha", cfg, q, 4, src, 4,
                  seg_start, seg_end, pvec, (9, 18), 2, DENSITY_ALPHA_G,
                  planes=True)


def density_alpha_sums_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                             pvec):
    """ρ and α's sums (Σψ∇W xyz, Σ|ψ∇W|²) (N, 5), each column a contiguous
    (N,) plane, from the walk of :func:`density_alpha_sweep` on the same
    operands, counted in ``DENSITY_ALPHA_SUMS``."""
    return _sweep(DENSITY_ALPHA_SUMS, "density_alpha_sums", cfg, q, 4, src,
                  4, seg_start, seg_end, pvec, (9, 18), 5, DENSITY_ALPHA_G,
                  planes=True)


def drho_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """DFSPH Dρ/Dt (N,): q (N, 8) ``x y z v`` (slots 0-5 read), src (M, 8)
    ``x y z v ψ 0`` (on the step's path one matrix, the queries its first
    rows, ``KappaSweeps.drho_operands``)."""
    return _sweep(DRHO, "drho", cfg, q, 8, src, 8, seg_start, seg_end,
                  pvec, (9, 18), 0, DRHO_G)


def multiphase_density_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                             pvec):
    """(δ = ΣW, Σψ_b·W) (N, 2): src (M, 4), fluid rows ``x y z s`` (s not
    read), wall rows ``x y z ψ_b``; q (N, 4) (on the step's path its first
    N rows)."""
    return _sweep(MP_DENSITY, "multiphase_density", cfg, q, 4, src, 4,
                  seg_start, seg_end, pvec, (9, 18), 2,
                  density_group(q.shape[0]))


def multiphase_force_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                           pvec, moving_boundary=False):
    """Multiphase acceleration (N, 3): q (N, 12), src (M, 12), on the
    step's path one matrix whose first N rows are the queries (fluid rows
    ``x y z v V pV² ρ0 1/m m 1/ρ̃``, then the walls,
    ``wcsph_cuda.multiphase_force_args``); the BECKER instance for Becker
    surface tension, the plain one for NONE (AKINCI raises);
    ``moving_boundary=True`` the MOVING instance (wall friction against the
    wall velocities), counted in ``MP_FORCE_MOVING``."""
    from .sph_pairs import WIDE_WIDTH, _st_becker
    _st_becker(cfg)
    moving = bool(moving_boundary)
    return _sweep(MP_FORCE_MOVING if moving else MP_FORCE,
                  "multiphase_force", cfg, q, 12, src, WIDE_WIDTH, seg_start,
                  seg_end, pvec, (9, 18), 3,
                  cfg.surface_tension_model.value, int(moving),
                  mp_force_group(q.shape[0], moving))


def xsph_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """XSPH sum (N, 3) over the fluid rows only: q (N, 8) ``x y z v ρ 0``,
    src (M, 8) (on the step's path the query itself,
    ``wcsph_cuda.xsph_operands``), ranges (9, N)."""
    return _sweep(XSPH, "xsph", cfg, q, 8, src, 8, seg_start, seg_end,
                  pvec, (9,), 3, XSPH_G)


def visc_laplacian_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                         plan: TilePlan | None = None):
    """Viscous Laplacian L(v) (N, 3): q (N, 8), src (M, 8), the row-tiled
    kernel over ``plan`` (:func:`tile_plan` of the queries)."""
    return _tiled(VISC_LAPLACIAN, "visc_laplacian", cfg, q, 8, src, 8,
                  seg_start, seg_end, pvec, plan, 3)


def multiphase_density_alpha_sweep(cfg: SimConfig, q, src, seg_start,
                                   seg_end, pvec):
    """Multiphase DFSPH's density and α̂ sums from one walk (N, 9), each
    column a contiguous (N,) plane: δ = ΣW, Σψ_b·W, G = Σ∇W (3),
    S = Σ|∇W|²/m_j, B = Σψ_b∇W (3); src (M, 4) fluid rows ``x y z 1/m_j``,
    wall rows ``x y z ψ_b`` (``dfsph_cuda.multiphase_alpha_operands``), q
    (N, 4) its first N rows."""
    return _sweep(MP_DENSITY_ALPHA, "multiphase_density_alpha", cfg, q, 4,
                  src, 4, seg_start, seg_end, pvec, (9, 18), 9,
                  MP_DENSITY_ALPHA_G, planes=True)


def multiphase_drho_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Adapted number-density rate dδ̂/dt (N,): the fluid sum plus the wall
    sum scaled by the query's s_i/m_i (slot 6), q (N, 8) ``x y z v s/m``,
    src (M, 8) ``x y z v`` with ψ_b in the wall rows' slot 6 (on the step's
    path one matrix, the queries its first rows,
    ``MultiphaseKappaSweeps.drho_operands``)."""
    return _sweep(MP_DRHO, "multiphase_drho", cfg, q, 8, src, 8, seg_start,
                  seg_end, pvec, (9, 18), 0, MP_DRHO_G)


def multiphase_kappa_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                           pvec):
    """Multiphase stiffness correction (N, 3): q (N, 8) ``x y z κV̂² qc``,
    src (M, 4) fluid rows ``x y z κV̂²_j``, wall rows ``x y z ψ_b``."""
    return _sweep(MP_KAPPA, "multiphase_kappa", cfg, q, 8, src, 4, seg_start,
                  seg_end, pvec, (9, 18), 3)


def pbf_lambda_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """PBF (ρ, λ) (N, 2), each column a contiguous (N,) plane: q (N, 4),
    src (M, 4) whose first N rows are the queries (ψ = m, slot 3 unread),
    then the wall rows ``x y z ψ_b``."""
    return _sweep(PBF_LAMBDA, "pbf_lambda", cfg, q, 4, src, 4, seg_start,
                  seg_end, pvec, (9, 18), 2, PBF_LAMBDA_G, planes=True)


def pbf_dp_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """PBF position correction Δp·ρ₀ (N, 3): q (N, 4) ``x y z λ_i``,
    src (M, 4) fluid rows ``x y z λ_j``, wall rows ``x y z ψ_b``."""
    return _sweep(PBF_DP, "pbf_dp", cfg, q, 4, src, 4, seg_start, seg_end,
                  pvec, (9, 18), 3, pbf_dp_group(q.shape[0]))


def pbf_omega_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """PBF vorticity ω (N, 3) over the fluid rows only: q (N, 8)
    ``x y z v m/ρ 0``, src (M, 8) (on the step's path the query itself,
    ``pbf_cuda.omega_operands``), ranges (9, N)."""
    return _sweep(PBF_OMEGA, "pbf_omega", cfg, q, 8, src, 8, seg_start,
                  seg_end, pvec, (9,), 3, PBF_OMEGA_G)


def pbf_grad_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Vorticity confinement's N: the λ sums (ρ, Σψ∇W, Σ|ψ∇W|²) (N, 5)
    over the fluid rows only, q and src one (N, 4) ``x y z ψ`` matrix,
    ranges (9, N)."""
    return _sweep(PBF_GRAD, "pbf_grad", cfg, q, 4, src, 4, seg_start,
                  seg_end, pvec, (9,), 5, PBF_GRAD_G)


def body_density_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """A body shell's Σψ_b·W (N,) from the density kernel, counted in
    ``BODY_DENSITY``: q (N, 4), the shell (Mb, 4) ``x y z ψ_b``, ranges
    (9, N)."""
    return _density(BODY_DENSITY, cfg, q, src, seg_start, seg_end, pvec,
                    (9,), body_group(src.shape[0]))


def body_force_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                     include_pressure=True):
    """Rigid-body contact force (N, 3), friction and pressure: q (N, 8),
    the body source (Mb, 8), ranges (9, N); ``include_pressure=False``
    launches the friction-only instance, counted in ``BODY_FORCE_P0``; G by
    the shell's size (``shell_group``)."""
    p = bool(include_pressure)
    return _sweep(BODY_FORCE if p else BODY_FORCE_P0,
                  "body_force" if p else "body_force_p0", cfg, q, 8, src, 8,
                  seg_start, seg_end, pvec, (9,), 3,
                  shell_group(src.shape[0]))


def multiphase_body_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Multiphase rigid-body contact acceleration (N, 3): q (N, 8), the
    body source (Mb, 8), ranges (9, N)."""
    return _sweep(MP_BODY, "multiphase_body", cfg, q, 8, src, 8, seg_start,
                  seg_end, pvec, (9,), 3)


def elastic_f_sweep(cfg: SimConfig, q, src, nbr_start, nbr, pvec):
    """Deformation-gradient accumulator (N, 9): q and src the body's
    (N, 8) ``X x 0 0`` rows, its static pair list ``nbr_start`` (N + 1,),
    ``nbr`` (P,) (``ElasticStatics``)."""
    return _list(ELASTIC_F, "elastic_f", cfg, q, 8, src, 8, nbr_start, nbr,
                 pvec, 9, elastic_group(q.shape[0]))


def elastic_force_hourglass_sweep(cfg: SimConfig, q, src, nbr_start, nbr,
                                  pvec):
    """Elastic and hourglass forces (N, 6), unscaled: q and src the body's
    (N, 24) ``X x PC F`` rows, its static pair list ``nbr_start`` (N + 1,),
    ``nbr`` (P,) (``ElasticStatics``)."""
    return _list(ELASTIC_FORCE_HG, "elastic_force_hourglass", cfg, q, 24,
                 src, 24, nbr_start, nbr, pvec, 6, elastic_group(q.shape[0]))


def fluid_reaction_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                         include_pressure=True):
    """The fluid's force on each body sample (Mb, 3): q (Mb, 8) ``x y z v_b
    ψ 0``, src the fluid rows (C, 8) ``x y z v ρ 0``, ranges (9, Mb);
    ``include_pressure=False`` launches the friction-only instance, counted
    in ``FLUID_REACTION_P0``."""
    p = bool(include_pressure)
    return _sweep(FLUID_REACTION if p else FLUID_REACTION_P0,
                  "fluid_reaction", cfg, q, 8, src, 8, seg_start, seg_end,
                  pvec, (9,), 3, int(p))


def pressure_force_body_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                              pvec):
    """The κ impulse −m·ψ_b·pd2_i·∇W of a body shell alone (N, 3): q (N, 4)
    ``x y z κ/ρ``, the shell (Mb, 8) with ψ_b in slot 6, ranges (9, N);
    G by the shell's size (``shell_group``)."""
    return _sweep(PRESSURE_FORCE_BODY, "pressure_force_body", cfg, q, 4, src,
                  8, seg_start, seg_end, pvec, (9,), 3,
                  shell_group(src.shape[0]))


def pressure_force_body_rev_sweep(cfg: SimConfig, q, src, seg_start,
                                  seg_end, pvec):
    """The reverse κ impulse (Mb, 3), the same formula: q (Mb, 4)
    ``x y z ψ_b`` of a body's samples, the fluid rows (C, 8) with κ/ρ in
    slot 6, ranges (9, Mb); counted in ``PRESSURE_FORCE_BODY_REV``."""
    return _sweep(PRESSURE_FORCE_BODY_REV, "pressure_force_body_rev", cfg, q,
                  4, src, 8, seg_start, seg_end, pvec, (9,), 3, BODY_REV_G)


def body_density_alpha_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                              pvec, include_sq=False):
    """A body shell's Σψ_b·W and α's shell sums Σψ_b∇W (N, 4) from one
    walk, each column a contiguous (N,) plane: q (N, 4), the shell (Mb, 4)
    ``x y z ψ_b`` (``Shell.src4``), ranges (9, N); ``include_sq=True``
    (α's fluid form over the shell, strong coupling) adds Σ|ψ_b∇W|² as a
    fifth, counted in ``BODY_DENSITY_ALPHA_SQ``; G by the shell's size
    (``shell_group``)."""
    sq = bool(include_sq)
    return _sweep(BODY_DENSITY_ALPHA_SQ if sq else BODY_DENSITY_ALPHA,
                  "body_density_alpha_sq" if sq else "body_density_alpha",
                  cfg, q, 4, src, 4, seg_start, seg_end, pvec, (9,),
                  5 if sq else 4, shell_group(src.shape[0]), planes=True)


def drho_shell_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec):
    """Σψ_b(v_i − v_b)·∇W (N,) of a body shell with its sample velocities in
    slots 3-5, counted in ``DRHO_SHELL``: q (N, 8), ranges (9, N); G by the
    shell's size (``shell_group``)."""
    return _sweep(DRHO_SHELL, "drho_shell", cfg, q, 8, src, 8, seg_start,
                  seg_end, pvec, (9,), 0, shell_group(src.shape[0]))


def multiphase_alpha_body_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                                pvec):
    """Σψ_b∇W of a body shell alone into columns 4-6 of (N, 7): q (N, 4),
    the shell (Mb, 4) ``x y z ψ_b``, ranges (9, N)."""
    return _sweep(MP_ALPHA_BODY, "multiphase_alpha_body", cfg, q, 4, src, 4,
                  seg_start, seg_end, pvec, (9,), 7)


def multiphase_drho_body_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                               pvec):
    """Σψ_b(v_i − v_b)·∇W of a body shell alone into column 1 of (N, 2):
    q (N, 8), the shell (Mb, 8) with its sample velocities, ranges (9, N)."""
    return _sweep(MP_DRHO_BODY, "multiphase_drho_body", cfg, q, 8, src, 8,
                  seg_start, seg_end, pvec, (9,), 2)


def multiphase_kappa_body_sweep(cfg: SimConfig, q, src, seg_start, seg_end,
                                pvec):
    """qc_i·Σψ_b∇W of a body shell alone (N, 3): q (N, 8) ``x y z κV̂² qc``,
    the shell (Mb, 4) ``x y z ψ_b``, ranges (9, N); G by the shell's size
    (``shell_group``)."""
    return _sweep(MP_KAPPA_BODY, "multiphase_kappa_body", cfg, q, 8, src, 4,
                  seg_start, seg_end, pvec, (9,), 3,
                  shell_group(src.shape[0]))


def boundary_force_sweep(cfg: SimConfig, q, src, seg_start, seg_end, pvec,
                         include_pressure=True):
    """The wall-only force (N, 3), adhesion, friction and (unless
    ``include_pressure=False``, counted in ``WALL_FORCE_P0``) the
    reference-scale wall pressure: q (N, 8), the wall source (M, 8),
    ranges (9, N) into it."""
    p = bool(include_pressure)
    return _sweep(WALL_FORCE if p else WALL_FORCE_P0, "wall_force", cfg, q,
                  8, src, 8, seg_start, seg_end, pvec, (9,), 3, int(p))


def empty_kernel(device):
    """Launches an empty kernel on the current stream of ``device``: the
    floor under a launch, timed beside the sweeps (not counted)."""
    lib = load()
    with torch.cuda.device(device):
        rc = lib.nereus_empty_kernel(torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed ({rc}): "
                           f"{lib.nereus_cuda_error_string(rc).decode()}")


def cell_check(q, pvec, grid):
    """In-kernel cell coordinates (N, 4) int32 of the queries q (N, 4 or
    8): floor((v − o)·(1/cell)) clamped to [0, g − 1] per axis, o and
    1/cell read from pvec's ``PV_OX``-``PV_INVCELL``, g from ``grid.size``;
    column 3 is 0."""
    from .sph_pairs import PV_LEN
    n, qw = q.shape
    if qw not in (4, 8):
        raise ValueError(f"q must be (N, 4) or (N, 8), got {tuple(q.shape)}")
    _check("q", q, torch.float32, (n, qw))
    _check("pvec", pvec, torch.float32, (PV_LEN,))
    if pvec.device != q.device:
        raise ValueError(f"inputs on several devices: {q.device}, "
                         f"{pvec.device}")
    gx, gy, gz = (int(g) for g in grid.size)
    out = torch.empty((n, 4), dtype=torch.int32, device=q.device)
    if n:
        _launch(CELL_CHECK, "cell_check", q.device, q.data_ptr(), n, qw,
                pvec.data_ptr(), gx, gy, gz, out.data_ptr())
    return out


def layout_probe(anchors, q, src, ws: int, soa: bool):
    """The source-layout probe's synthetic force sweep (4, m): anchors
    (m/128·18,) int32, q (8, m), src (M, 8) rows (AoS) or, ``soa``, (8, M)
    columns, windows of ``ws`` source rows; counted in ``LAYOUT_SOA`` resp.
    ``LAYOUT_AOS``."""
    m = q.shape[1]
    if m % 128 or ws <= 0:
        raise ValueError(f"m ({m}) must be a multiple of 128 and ws ({ws}) "
                         "positive")
    m_src = src.shape[1] if soa else src.shape[0]
    if m_src < ws:
        raise ValueError(f"{m_src} source rows < window {ws}")
    _check("anchors", anchors, torch.int32, (m // 128 * 18,))
    _check("q", q, torch.float32, (8, m))
    _check("src", src, torch.float32, (8, m_src) if soa else (m_src, 8))
    if len({anchors.device, q.device, src.device}) != 1:
        raise ValueError("inputs on several devices")
    out = torch.empty((4, m), dtype=torch.float32, device=q.device)
    _launch(LAYOUT_SOA if soa else LAYOUT_AOS, "layout_probe", q.device,
            anchors.data_ptr(), q.data_ptr(), src.data_ptr(), m, m_src, ws,
            int(bool(soa)), out.data_ptr())
    return out
