"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build the CUDA sweep kernels from ``nereus_tpu_torch/csrc`` with nvcc;
3. kernel against plain version on the card: a ~32k-particle dam-break
   with its floor inside the kernel support of the bottom layer and
   seeded velocities, both kernel sets and all three surface-tension
   models (density rtol 1e-5; forces max|Δf| ≤ 1e-4·max|f|: FMA
   contraction, rsqrtf and the plain version's atomic index_add_ order);
4. the WCSPH main path: ``dam_break(n_target=2**20)`` with its boundary
   shell (1,092,727 fluid particles), 300 ``wcsph_step`` calls at
   dt = 1e-3 through the floor impact near step 180, steps 51-300 timed
   with CUDA events; every step must launch both kernels, with zero
   overflow, finite positions, nothing below the floor and mean
   compression < 0.1; then both kernels against their plain versions at
   these shapes, timed, and one plain-sweep step timed at the same size;
5. the IISPH kernels against their plain versions on the phase-3
   dam-break (IISPH parameters, mass calibrated to the lattice), fed the
   operands of one real IISPH step: the five IISPH sweeps for both kernel
   sets and the pressure-off force sweep for all six kernel-set ×
   surface-tension combinations (max|Δ| ≤ 1e-4·max|ref| per output
   column, and finite);
6. the IISPH main path: ``resting_block(n_target=2**20)`` (1,092,727
   fluid particles on the floor of a tight box, impact velocity −1 m/s,
   mass calibrated to the 0.8·h lattice), 60 ``iisph_step`` calls with
   tol = 1 kg/m³ and omega = 0.5, steps 11-60 timed with CUDA events;
   gates on the iteration counts, the convergence bound, finite
   positions, the floor, pressure ≥ 0 and the kernels' launches; then
   each IISPH kernel against its plain version at these shapes, timed in
   turns.

Each kernel's bound (``bound_ms``) is the larger of the bytes the
neighbor sweep must move (the queries, each source row once with a 4-byte
cell key, the parameters, the output) over 3.35 TB/s and its operations
(candidate pairs of this run's ranges × the pair formula's operations)
over 67 TFLOP/s, the H100 SXM's published float32 peaks.
``bound_ranges_ms`` is the same bound of this port's interface, which
also reads the (9 or 18, N) int32 range rows the port builds per step.

The last two lines are a JSON object with each kernel's launches, error,
times and bound, and ``{"ok": true, "device": {...}}``. Without a CUDA
device the script fails before it prints either.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_STEPS = 300
TIMED_FROM = 50          # steps 51..300 are timed
SMALL_N = 2 ** 15
MAIN_N = 2 ** 20
DENS_RTOL = 1e-5
FORCE_TOL = 1e-4
IISPH_STEPS = 60
IISPH_TIMED_FROM = 10    # steps 11..60 are timed
IISPH_TOL = 1.0          # kg/m^3
IISPH_OMEGA = 0.5
IISPH_FLUID = 1_092_727
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per candidate pair (fluid rows, boundary rows) of each pair
# formula on the main paths (Muller kernels, Becker surface tension),
# counted in the CUDA source with every add, multiply, compare, min/max,
# division and rsqrt as one
PAIR_OPS = {"density": (15, 15), "force": (71, 41), "force_p0": (52, 37),
            "dii_rhoadv": (36, 36), "aii": (26, 26), "sum_dij": (23, 0),
            "jacobi": (35, 22), "pressure_force": (24, 24)}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def events_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(key, args, out):
    """(bound_ms, bound_by, bound_ranges_ms) of one sweep call on
    ``args = (q, src, seg_start, seg_end, pvec)`` with output ``out``:
    the queries, each source row once with its 4-byte cell key, pvec and
    the output moved once, against the candidate pairs of these ranges;
    ``bound_ranges_ms`` also reads the range rows."""
    q, src, s, e, pv = args
    nbytes = (sum(t.numel() * t.element_size() for t in (q, src, pv, out))
              + 4 * src.shape[0])
    ranges = sum(t.numel() * t.element_size() for t in (s, e))
    cand = (e - s).clamp(min=0).sum(dim=1, dtype=torch.int64)
    fluid, bnd = PAIR_OPS[key]
    ops = int(cand[:9].sum()) * fluid + int(cand[9:].sum()) * bnd
    t_ops = ops / F32_OPS_PER_S * 1e3
    t_bytes, t_ranges = (b / HBM_BYTES_PER_S * 1e3
                         for b in (nbytes, nbytes + ranges))
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (max(t_ranges, t_ops),)


def sweep_inputs(ctx, params, dens=None):
    """Density and force sweep operands of one step, as the step builds
    them (``solvers/wcsph_cuda.py``)."""
    from nereus_tpu_torch import tait_pressure
    vel = (ctx.vx, ctx.vy, ctx.vz)
    dargs = (ctx.queries(width=4), ctx.pack(vel, params.particle_mass),
             ctx.seg_start, ctx.seg_end, ctx.pvec)
    if dens is None:
        return dargs, None
    ds = dens.clamp(min=1e-12)
    pd2 = tait_pressure(dens, params) / (ds * ds)
    fargs = (ctx.queries(*vel, dens, pd2), ctx.pack(vel, dens),
             ctx.seg_start, ctx.seg_end, ctx.pvec)
    return dargs, fargs


def compare(cfg, ctx, params, label, time_it=False):
    """Kernel vs plain on the same CUDA tensors; returns per-kernel
    (max_abs_err, ms, plain_ms)."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    dargs, _ = sweep_inputs(ctx, params)
    dens = cuda_sweep.density_sweep(cfg, *dargs)
    dens_ref = SP.density_sweep_plain(cfg, *dargs)
    d_err = float((dens - dens_ref).abs().max())
    if not torch.allclose(dens, dens_ref, rtol=DENS_RTOL, atol=0.0):
        rel = float(((dens - dens_ref).abs() / dens_ref.abs()).max())
        fail(f"{label}: density kernel vs plain rel err {rel:.3g} "
             f"> {DENS_RTOL}")
    _, fargs = sweep_inputs(ctx, params, dens_ref)
    f = cuda_sweep.force_sweep(cfg, *fargs)
    f_ref = SP.fluid_force_sweep_plain(cfg, *fargs)
    f_err = float((f - f_ref).abs().max())
    f_max = float(f_ref.abs().max())
    if not (torch.isfinite(f).all() and f_err <= FORCE_TOL * f_max):
        fail(f"{label}: force kernel vs plain max|df| {f_err:.3g} > "
             f"{FORCE_TOL}*max|f| = {FORCE_TOL * f_max:.3g}")
    print(f"  {label}: density max|dρ| {d_err:.3g} (max ρ "
          f"{float(dens_ref.max()):.6g}); force max|df| {f_err:.3g} "
          f"(max|f| {f_max:.6g})")
    if not time_it:
        return None
    out = {}
    for name, kern, plain, args, err in (
            ("density", cuda_sweep.density_sweep, SP.density_sweep_plain,
             dargs, d_err),
            ("force", cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
             fargs, f_err)):
        out[name] = (err, *time_turns(name, lambda: kern(cfg, *args),
                                      lambda: plain(cfg, *args)),
                     *bound(name, args, kern(cfg, *args)))
    return out


def time_turns(name, kern, plain, reps=20):
    """(kernel ms, plain ms), each the better of two turns in the order
    plain, kernel, kernel, plain."""
    kern()
    plain()
    p1 = events_ms(plain, 3)
    k1 = events_ms(kern, reps)
    k2 = events_ms(kern, reps)
    p2 = events_ms(plain, 3)
    print(f"  {name} sweep at main-path shapes: kernel {k1:.4f} / "
          f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    return min(k1, k2), min(p1, p2)


def iisph_operands(cfg, ctx, params):
    """The operands of every sweep of one IISPH step from ``ctx`` (with
    p = ½·p_prev), built as ``solvers/iisph_cuda.py`` builds them, each
    from the plain versions' upstream results: ``{key: (kernel, plain,
    args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm, dt = params.particle_mass, params.dt
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    q4 = ctx.queries(width=4)
    dens = SP.density_sweep_plain(cfg, q4, ctx.pack(vel, pm), *rng)
    ds = dens.clamp(min=1e-12)
    inv_d2 = 1.0 / (ds * ds)
    zero = torch.zeros_like(dens)
    fargs = (ctx.queries(*vel, dens, zero), ctx.pack(vel, dens), *rng)
    f_adv = SP.fluid_force_sweep_plain(cfg, *fargs, include_pressure=False)
    vel_adv = tuple(v + (dt / pm) * (f_adv[:, k] + pm * params.gravity[k])
                    for k, v in enumerate(vel))
    src_p = ctx.pack(vel_adv, pm)
    dargs = (ctx.queries(*vel_adv, *vel, inv_d2, width=12), src_p, *rng)
    dii = SP.dii_rhoadv_sweep_plain(cfg, *dargs)[:, :3].unbind(1)
    dpi = pm * inv_d2
    p = 0.5 * ctx.pres_prev
    src_pd = ctx.pack((zero, zero, zero), p * inv_d2)
    sargs = (q4, src_pd, ctx.seg_start_f, ctx.seg_end_f, ctx.pvec)
    sd = SP.sum_dij_sweep_plain(cfg, *sargs).unbind(1)
    off = dict(include_pressure=False)
    return {
        "force_p0": (cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
                     fargs, off),
        "dii_rhoadv": (cuda_sweep.dii_rhoadv_sweep,
                       SP.dii_rhoadv_sweep_plain, dargs, {}),
        "aii": (cuda_sweep.aii_sweep, SP.aii_sweep_plain,
                (ctx.queries(*dii, dpi, width=8), src_p, *rng), {}),
        "sum_dij": (cuda_sweep.sum_dij_sweep, SP.sum_dij_sweep_plain, sargs,
                    {}),
        "jacobi": (cuda_sweep.jacobi_sweep, SP.jacobi_sweep_plain,
                   (ctx.queries(*sd, dpi * p, width=8),
                    ctx.pack_wide([*dii, p, *sd]), *rng), {}),
        "pressure_force": (cuda_sweep.pressure_force_sweep,
                           SP.pressure_force_sweep_plain,
                           (ctx.queries(p * inv_d2), src_pd, *rng), {}),
    }


def compare_iisph(cfg, ctx, params, label, keys=None, time_it=False):
    """Each IISPH kernel (``keys``, default all) against its plain version
    on one step's operands: max|Δ| ≤ FORCE_TOL·max|ref| per output column,
    and finite. Returns per-kernel (max_abs_err, ms, plain_ms, bound_ms,
    bound_by, bound_ranges_ms) when timed."""
    ops = iisph_operands(cfg, ctx, params)
    out, msg = {}, []
    for key in keys or ops:
        kern, plain, args, kw = ops[key]
        got = kern(cfg, *args, **kw)
        ref = plain(cfg, *args, **kw)
        g2, r2 = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
        err = (g2 - r2).abs().amax(dim=0)
        scale = r2.abs().amax(dim=0)
        if not bool(torch.isfinite(got).all()):
            fail(f"{label}: {key} kernel output not finite")
        if not bool((scale > 0).all()):
            fail(f"{label}: {key} plain output has an all-zero column "
                 f"(max|ref| {scale.tolist()}): the check would be vacuous")
        if not bool((err <= FORCE_TOL * scale).all()):
            fail(f"{label}: {key} kernel vs plain max|d| {err.tolist()} > "
                 f"{FORCE_TOL}*max|ref| {scale.tolist()}")
        msg.append(f"{key} {float(err.max()):.3g}/{float(scale.max()):.4g}")
        if time_it:
            out[key] = (float(err.max()),
                        *time_turns(key, lambda: kern(cfg, *args, **kw),
                                    lambda: plain(cfg, *args, **kw)),
                        *bound(key, args, got))
    print(f"  {label}: max|d|/max|ref| " + ", ".join(msg))
    return out


def wcsph_main_path(dev):
    """The WCSPH main path's scene: ``dam_break(n_target=2**20)`` with its
    boundary shell; returns ``(cfg, params, state, grid, boundary)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    params = nt.make_params(device=dev)
    state, grid, boundary = scene.dam_break(params, cfg, n_target=MAIN_N,
                                            device=dev)
    return cfg, params, state, grid, boundary


def run_wcsph(cfg, params, state, grid, boundary):
    """``N_STEPS`` WCSPH steps from ``state``, the steps after
    ``TIMED_FROM`` timed with CUDA events; returns ``(state, diag,
    ms/step, max seg_overflow)``."""
    import nereus_tpu_torch as nt
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    overflow = torch.zeros((), dtype=torch.int32, device=state.pos.device)
    for i in range(N_STEPS):
        if i == TIMED_FROM:
            start.record()
        state, diag = nt.wcsph_step(state, params, grid, cfg, boundary)
        overflow = torch.maximum(overflow, diag.seg_overflow)
    end.record()
    torch.cuda.synchronize()
    return (state, diag, start.elapsed_time(end) / (N_STEPS - TIMED_FROM),
            int(overflow))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on an NVIDIA GPU and has no CPU fallback")
    # the port itself, before anything is printed: without it (the script
    # alone in a directory) the run fails with no output
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.solvers import iisph_cuda
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    from nereus_tpu_torch.solvers.wcsph_cuda import PLAIN, wcsph_step_cuda

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    log = cuda_sweep.build()
    cuda_sweep.load()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernel vs plain, every kernel set and surface-tension model -------
    print(f"kernel vs plain, dam-break n_target={SMALL_N}, floor in "
          "support, seeded velocities:")
    for ks, st in (("MULLER", "BECKER"), ("MULLER", "AKINCI"),
                   ("MULLER", "NONE"), ("MONAGHAN", "BECKER"),
                   ("MONAGHAN", "AKINCI"), ("MONAGHAN", "NONE")):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           surface_tension_model=nt.SurfaceTensionModel[st])
        params = nt.make_params(device=dev)
        spacing = float(params.interaction_radius) - 0.005
        side = spacing * SMALL_N ** (1.0 / 3.0)
        # bottom layer at y = 0.04 - side/2; floor 0.04 below it
        floor = 0.04 - side / 2.0 - 0.04
        state, grid, boundary = scene.dam_break(
            params, cfg, cube_size=(side,) * 3, cube_center=(-0.4, 0.04, 0.5),
            box_min=(-1.2, floor, -0.5), box_max=(0.8, 1.5, 1.5),
            device=dev)
        pos = state.pos.cpu().numpy()
        vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
        state = nt.make_fluid_state(pos, vel, device=dev)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        compare(cfg, ctx, params,
                f"{ks}+{st} n={state.capacity} nb={boundary.num_boundaries}")
    torch.cuda.synchronize()

    # -- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    cfg, params, state, grid, boundary = wcsph_main_path(dev)
    torch.cuda.synchronize()
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    print(f"main path: dam_break n_target=2**20: {n} fluid particles, "
          f"{boundary.num_boundaries} boundary samples, grid {grid.size}, "
          f"dt {float(params.dt)}, floor y {floor:.6g}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    if n != 1_092_727:
        fail(f"expected 1,092,727 fluid particles, got {n}")

    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diag, ms, overflow = run_wcsph(cfg, params, state, grid,
                                          boundary)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}

    pos = state.pos[:n]
    min_y = float(pos[:, 1].min())
    mc = float(diag.mean_compression)
    print(f"main path: {N_STEPS} steps in {t_host:.2f} s host; steps "
          f"{TIMED_FROM + 1}-{N_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"main path: launches {launches}, seg_overflow max "
          f"{overflow}, min y {min_y:.6g}, mean_compression {mc:.6g}, "
          f"mean_density_error {float(diag.mean_density_error):.6g}, "
          f"max_density {float(diag.max_density):.6g}")
    for k in cuda_sweep.KERNELS:
        want = N_STEPS if k in (cuda_sweep.DENSITY, cuda_sweep.FORCE) else 0
        if k.launches != want:
            fail(f"{k.name} launched {k.launches} times in {N_STEPS} WCSPH "
                 f"steps, expected {want}")
    if overflow != 0:
        fail(f"seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("non-finite positions")
    if min_y < floor:
        fail(f"floor penetration: min y {min_y} < floor {floor}")
    if not mc < 0.1:
        fail(f"mean_compression {mc} >= 0.1")

    # kernel vs plain at the main path's shapes, on its last state
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    timing = compare(cfg, ctx, params, f"main path after {N_STEPS} steps",
                     time_it=True)

    # the step with the plain sweeps at the same size, in turns with the
    # kernels (plain, kernel, kernel, plain), all from the last state
    def plain_step():
        wcsph_step_cuda(state, params, grid, cfg, boundary, sweeps=PLAIN)

    def kernel_step():
        wcsph_step_cuda(state, params, grid, cfg, boundary)
    plain_step()
    p1 = events_ms(plain_step, 2)
    k1 = events_ms(kernel_step, 20)
    k2 = events_ms(kernel_step, 20)
    p2 = events_ms(plain_step, 2)
    print(f"one step at n={n}: kernels {k1:.4f} / {k2:.4f} ms, plain "
          f"sweeps {p1:.4f} / {p2:.4f} ms; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    wcsph_launches = launches
    del state, diag, ctx, boundary, grid
    torch.cuda.empty_cache()

    # -- 5. IISPH kernels vs plain, on one real IISPH step's operands --------
    print(f"IISPH kernels vs plain, dam-break n_target={SMALL_N}, mass "
          "calibrated to the lattice, floor in support, seeded velocities:")
    for ks, st in (("MULLER", "BECKER"), ("MULLER", "AKINCI"),
                   ("MULLER", "NONE"), ("MONAGHAN", "BECKER"),
                   ("MONAGHAN", "AKINCI"), ("MONAGHAN", "NONE")):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           surface_tension_model=nt.SurfaceTensionModel[st])
        base = nt.iisph_params(device=dev)
        spacing = float(base.interaction_radius) - 0.005
        params = nt.calibrate_mass(base, cfg, spacing=spacing)
        side = spacing * SMALL_N ** (1.0 / 3.0)
        floor = 0.04 - side / 2.0 - 0.04
        state, grid, boundary = scene.dam_break(
            params, cfg, cube_size=(side,) * 3, cube_center=(-0.4, 0.04, 0.5),
            box_min=(-1.2, floor, -0.5), box_max=(0.8, 1.5, 1.5),
            device=dev)
        pos = state.pos.cpu().numpy()
        vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
        state = nt.make_fluid_state(pos, vel, device=dev)
        # one step carries a real pressure into the operands' warm start
        state, diag = nt.iisph_step(state, params, grid, cfg, boundary,
                                    tol=IISPH_TOL, omega=IISPH_OMEGA)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        # the pressure-off force sweep for every model, the five IISPH
        # sweeps (which read no surface-tension model) once per kernel set
        keys = None if st == "BECKER" else ("force_p0",)
        compare_iisph(cfg, ctx, params,
                      f"{ks}+{st} n={state.capacity} "
                      f"nb={boundary.num_boundaries} iters "
                      f"{int(diag.solver_iters)} max p "
                      f"{float(state.pressure.max()):.4g}", keys=keys)
    torch.cuda.synchronize()

    # -- 6. the IISPH main path --------------------------------------------
    cfg = nt.SimConfig()
    base = nt.iisph_params(device=dev)
    spacing = 0.8 * float(base.interaction_radius)
    params = nt.calibrate_mass(base, cfg, spacing=spacing)
    t0 = time.perf_counter()
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=MAIN_N, spacing=spacing, impact_velocity=-1.0,
        device=dev)
    torch.cuda.synchronize()
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    print(f"IISPH main path: resting_block n_target=2**20: {n} fluid "
          f"particles, {boundary.num_boundaries} boundary samples, grid "
          f"{grid.size}, dt {float(params.dt)}, mass "
          f"{float(params.particle_mass):.6g}, floor y {floor:.6g}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    if n != IISPH_FLUID:
        fail(f"expected {IISPH_FLUID:,} fluid particles, got {n}")

    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    iisph_cuda.LOOP.reset()
    iters, errs = [], []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t_host = time.perf_counter()
    for i in range(IISPH_STEPS):
        if i == IISPH_TIMED_FROM:
            start.record()
            syncs_before = iisph_cuda.LOOP.syncs
        state, diag = nt.iisph_step(state, params, grid, cfg, boundary,
                                    tol=IISPH_TOL, omega=IISPH_OMEGA)
        iters.append(diag.solver_iters)
        errs.append(diag.mean_density_error)
    end.record()
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t_host
    timed = IISPH_STEPS - IISPH_TIMED_FROM
    ms = start.elapsed_time(end) / timed
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    iters = torch.stack(iters).cpu().numpy()
    errs = torch.stack(errs).cpu().numpy()
    syncs = (iisph_cuda.LOOP.syncs - syncs_before) / timed
    pos = state.pos[:n]
    min_y = float(pos[:, 1].min())
    print(f"IISPH main path: {IISPH_STEPS} steps in {t_host:.2f} s host; "
          f"steps {IISPH_TIMED_FROM + 1}-{IISPH_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"IISPH main path: solver_iters mean {iters.mean():.4g} max "
          f"{iters.max()} (per step {iters.tolist()}); Jacobi iterations "
          f"launched {iisph_cuda.LOOP.launched} for {int(iters.sum())} "
          f"converged; host syncs per step {syncs:.4g} (one per "
          f"{iisph_cuda.SYNC_EVERY} launched iterations)")
    print(f"IISPH main path: launches {launches}, min y {min_y:.6g}, "
          f"mean_density_error last {errs[-1]:.6g} max {errs.max():.6g}, "
          f"min pressure {float(state.pressure.min()):.6g}, max pressure "
          f"{float(state.pressure.max()):.6g}")
    if not iters.mean() > cfg.iisph_min_iters:
        fail(f"mean solver_iters {iters.mean()} <= iisph_min_iters "
             f"{cfg.iisph_min_iters}")
    rest = np.float32(float(params.rest_density))
    unconverged = (errs > np.float32(IISPH_TOL) / rest) & (
        iters != cfg.iisph_max_iters)
    if unconverged.any():
        fail(f"steps {np.flatnonzero(unconverged).tolist()} end above tol "
             "before iisph_max_iters")
    if not bool(torch.isfinite(state.pos).all()):
        fail("non-finite positions")
    if min_y < floor:
        fail(f"floor penetration: min y {min_y} < floor {floor}")
    if float(state.pressure.min()) < 0.0:
        fail("negative pressure")
    for k, want in ((cuda_sweep.DENSITY, IISPH_STEPS), (cuda_sweep.FORCE, 0),
                    (cuda_sweep.FORCE_P0, IISPH_STEPS),
                    (cuda_sweep.DII_RHOADV, IISPH_STEPS),
                    (cuda_sweep.AII, IISPH_STEPS),
                    (cuda_sweep.PRESSURE_FORCE, IISPH_STEPS)):
        if k.launches != want:
            fail(f"{k.name} launched {k.launches} times in {IISPH_STEPS} "
                 f"IISPH steps, expected {want}")
    for k in (cuda_sweep.SUM_DIJ, cuda_sweep.JACOBI):
        if k.launches != iisph_cuda.LOOP.launched or \
                k.launches < int(iters.sum()):
            fail(f"{k.name} launched {k.launches} times for "
                 f"{iisph_cuda.LOOP.launched} launched and "
                 f"{int(iters.sum())} converged iterations")
    iisph_launches = launches

    # each IISPH kernel vs plain at these shapes, on the last state
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    iisph_timing = compare_iisph(cfg, ctx, params,
                                 f"IISPH main path after {IISPH_STEPS} steps",
                                 time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = []
    sph_src = "nereus_tpu_torch/csrc/sph_sweep.cu"
    iisph_src = "nereus_tpu_torch/csrc/iisph_sweep.cu"
    for key, name, src, rep, path_launches, t in (
            ("density", cuda_sweep.DENSITY.name, sph_src,
             "nereus_tpu/ops/pallas_sph.py:1193", wcsph_launches, timing),
            ("force", cuda_sweep.FORCE.name, sph_src,
             "nereus_tpu/ops/pallas_sph.py:1207", wcsph_launches, timing),
            ("force_p0", cuda_sweep.FORCE_P0.name, sph_src,
             "nereus_tpu/ops/pallas_sph.py:1207", iisph_launches,
             iisph_timing),
            ("dii_rhoadv", cuda_sweep.DII_RHOADV.name, iisph_src,
             "nereus_tpu/ops/pallas_sph.py:475", iisph_launches,
             iisph_timing),
            ("aii", cuda_sweep.AII.name, iisph_src,
             "nereus_tpu/ops/pallas_sph.py:506", iisph_launches,
             iisph_timing),
            ("sum_dij", cuda_sweep.SUM_DIJ.name, iisph_src,
             "nereus_tpu/ops/pallas_sph.py:524", iisph_launches,
             iisph_timing),
            ("jacobi", cuda_sweep.JACOBI.name, iisph_src,
             "nereus_tpu/ops/pallas_sph.py:543", iisph_launches,
             iisph_timing),
            ("pressure_force", cuda_sweep.PRESSURE_FORCE.name, iisph_src,
             "nereus_tpu/ops/pallas_sph.py:922", iisph_launches,
             iisph_timing)):
        err, kms, pms, bms, by, brms = t[key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "path": "iisph_1M_settled" if t is iisph_timing else "wcsph_1M",
            "launches": path_launches[name], "max_abs_err": err, "ms": kms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "bound_ranges_ms": brms,
            # no single PyTorch call computes a range-walk neighbor sweep
            "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
