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
4. the main path: ``dam_break(n_target=2**20)`` with its boundary shell
   (1,092,727 fluid particles), 300 ``wcsph_step`` calls at dt = 1e-3
   through the floor impact near step 180, steps 51-300 timed with CUDA
   events; every step must launch both kernels, with zero overflow,
   finite positions, nothing below the floor and mean compression < 0.1;
   then both kernels against their plain versions at these shapes, timed,
   and one plain-sweep step timed at the same size.

The last two lines are a JSON object with each kernel's launches, error
and times, and ``{"ok": true, "device": {...}}``. Without a CUDA device
the script fails before it prints either.
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
    for name, kern, plain, args, reps in (
            ("density", cuda_sweep.density_sweep, SP.density_sweep_plain,
             dargs, 20),
            ("force", cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
             fargs, 20)):
        kern(cfg, *args)
        plain(cfg, *args)
        # plain, kernel, kernel, plain
        p1 = events_ms(lambda: plain(cfg, *args), 3)
        k1 = events_ms(lambda: kern(cfg, *args), reps)
        k2 = events_ms(lambda: kern(cfg, *args), reps)
        p2 = events_ms(lambda: plain(cfg, *args), 3)
        print(f"  {name} sweep at main-path shapes: kernel {k1:.4f} / "
              f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
        out[name] = (d_err if name == "density" else f_err,
                     min(k1, k2), min(p1, p2))
    return out


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on an NVIDIA GPU and has no CPU fallback")
    # the port itself, before anything is printed: without it (the script
    # alone in a directory) the run fails with no output
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    from nereus_tpu_torch.ops import cuda_sweep
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
    cfg = nt.SimConfig()
    params = nt.make_params(device=dev)
    t0 = time.perf_counter()
    state, grid, boundary = scene.dam_break(params, cfg, n_target=MAIN_N,
                                            device=dev)
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    t_host = time.perf_counter()
    for i in range(N_STEPS):
        if i == TIMED_FROM:
            start.record()
        state, diag = nt.wcsph_step(state, params, grid, cfg, boundary)
        overflow = torch.maximum(overflow, diag.seg_overflow)
    end.record()
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}

    ms = start.elapsed_time(end) / (N_STEPS - TIMED_FROM)
    pos = state.pos[:n]
    min_y = float(pos[:, 1].min())
    mc = float(diag.mean_compression)
    print(f"main path: {N_STEPS} steps in {t_host:.2f} s host; steps "
          f"{TIMED_FROM + 1}-{N_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"main path: launches {launches}, seg_overflow max "
          f"{int(overflow)}, min y {min_y:.6g}, mean_compression {mc:.6g}, "
          f"mean_density_error {float(diag.mean_density_error):.6g}, "
          f"max_density {float(diag.max_density):.6g}")
    for k, c in launches.items():
        if c != N_STEPS:
            fail(f"{k} launched {c} times in {N_STEPS} steps")
    if int(overflow) != 0:
        fail(f"seg_overflow {int(overflow)}")
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

    src = "nereus_tpu_torch/csrc/sph_sweep.cu"
    kernels = []
    for key, k, rep in (
            ("density", cuda_sweep.DENSITY,
             "nereus_tpu/ops/pallas_sph.py:1193"),
            ("force", cuda_sweep.FORCE,
             "nereus_tpu/ops/pallas_sph.py:1207")):
        err, kms, pms = timing[key]
        kernels.append({"name": k.name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[k.name],
                        "max_abs_err": err, "ms": kms, "plain_ms": pms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
