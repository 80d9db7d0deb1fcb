"""Where the time of one step of the PyTorch port goes, on a CUDA card.

    python3 tools/profile_torch_step.py --solver SOLVER \
        [--warmup N] [--steps N] [--sync-every K] [--cg-sync-every K]

Builds the SOLVER's main-path scene of ``chip_smoke.py`` (wcsph: the
``dam_break(n_target=2**20)`` with its boundary shell; multiphase: the
same scene split in two phases as ``bench.py``'s ``multiphase_1M``; xsph:
the same scene stepped with ``xsph_eps = 0.3``; wcsph_visc: the same scene
with the implicit viscosity solve at ν = 5; iisph: the settled
``resting_block(n_target=2**20)``; pcisph, dfsph, dfsph_visc, dfsph_mp:
the settled ``resting_block(n_target=256_000)`` of ``bench.py``'s
``*_256k_settled`` cells, dfsph_mp split in two phases; pbf: ``bench.py``'s
``pbf_1M`` dam-break with its boundary shell; pbf_vort: the same stepped
with ``xsph_eps = 0.02`` and ``vorticity_eps = 0.01``; pbf_settled: the
settled ``pbf_256k_settled`` block; wavemaker, mp_wavemaker: the wcsph
and multiphase scenes under ``chip_smoke.wavemaker`` (the CLI's
``--wavemaker x:0.05:2``); coupled, mp_coupled: ``chip_smoke.
coupled_scene``, ``bench.py``'s mp_coupled_256k and its single-phase
twin, a rigid box dropped on the settled 256k block; elastic,
elastic_plastic: ``chip_smoke.elastic_block``, ``bench.py``'s
elastic_512k and elastic_plastic_512k; wcsph_elastic:
``chip_smoke.wcsph_elastic_scene``, ``bench.py``'s wcsph_elastic_256k;
dfsph_coupled, dfsph_mp_coupled, dfsph_elastic:
``chip_smoke.dfsph_coupled_scene``, ``bench.py``'s dfsph_coupled_256k, its
two-phase split and the settled block with phase 30's elastic cube over
it; wide12M: ``bench.py``'s wcsph_wide12M, the 12M dam-break on its grid
stretched past 2^24 cells; lifecycle: ``chip_smoke.py``'s
wcsph_1M_lifecycle without its refits and drop, each step an
``add_particles_traced`` patch every 10 steps, the step, and
``remove_particles`` under the drain plane), runs
``--warmup`` steps, times ``--steps`` steps with CUDA events and the host
clock, then profiles the next ``--steps`` steps with
``torch.profiler`` and prints, for those steps, the device time per step
by kernel and the device busy time per step (the sum of all device time:
one stream, so nothing overlaps). The profiler slows the host's launches,
so the idle share is taken against the unprofiled steps' CUDA-event time
(pick ``--warmup`` so that both windows run the same solver iterations);
the profiled window's own idle share is printed beside it.
``--sync-every`` sets the solver loop's host-read interval (the
``SYNC_EVERY`` of ``solvers/{iisph,pcisph,dfsph}_cuda.py``; for DFSPH its
density loop), ``--cg-sync-every`` the implicit viscosity CG's
(``solvers/viscosity.py``), to price them: the iterations do not depend
on them.
Imports no JAX; needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(solver, dev):
    """``(state, step, loops)``: the main-path scene of ``solver``, its
    step function and the ``LoopCounts`` of its solver loops."""
    import dataclasses

    import chip_smoke as smoke
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.solvers import (dfsph_cuda, iisph_cuda,
                                          pcisph_cuda, viscosity)
    if solver in ("pbf", "pbf_vort", "pbf_settled"):
        cfg, params, state, grid, boundary = smoke.pbf_main_path(
            dev, settled=solver == "pbf_settled")
        kw = (dict(xsph_eps=smoke.PBF_XSPH_EPS,
                   vorticity_eps=smoke.PBF_VORTICITY_EPS)
              if solver == "pbf_vort" else {})

        def step(s):
            return nt.pbf_step(s, params, grid, cfg, boundary, **kw)
        return state, step, ()
    if solver in ("elastic", "elastic_plastic"):
        cfg, params, ep, state, statics, grid, _ = smoke.elastic_block(
            dev, solver == "elastic_plastic")

        def step(s):
            return nt.elastic_step(s, statics, params, ep, grid, cfg)
        return state, step, ()
    if solver == "wcsph_elastic":
        (cfg, params, state, grid, walls, estate, statics, ep, psi,
         _) = smoke.wcsph_elastic_scene(dev)
        held = {"body": estate}

        def step(s):
            s, held["body"], d = nt.wcsph_elastic_step(
                s, params, grid, cfg, held["body"], statics, ep, psi, walls,
                substeps=smoke.WEL_SUBSTEPS)
            return s, d
        return state, step, ()
    if solver in ("dfsph_coupled", "dfsph_mp_coupled", "dfsph_elastic"):
        kind = {"dfsph_coupled": "rigid", "dfsph_mp_coupled": "mp",
                "dfsph_elastic": "elastic"}[solver]
        cfg, params, state, grid, walls, body = smoke.dfsph_coupled_scene(
            dev, kind)
        if kind == "elastic":
            estate, statics, ep, psi = body
            held = {"body": estate}

            def step(s):
                s, held["body"], d = nt.dfsph_elastic_step(
                    s, params, grid, cfg, held["body"], statics, ep, psi,
                    walls, substeps=smoke.WEL_SUBSTEPS, tol=smoke.DFSPH_TOL,
                    tol_v=smoke.DFSPH_TOL)
                return s, d
        else:
            held = {"body": body}

            def step(s):
                s, held["body"], d = nt.dfsph_coupled_step(
                    s, params, grid, cfg, held["body"], walls,
                    tol=smoke.DFSPH_TOL, tol_v=smoke.DFSPH_TOL)
                return s, d
        return state, step, (dfsph_cuda.LOOP_V, dfsph_cuda.LOOP)
    if solver in ("coupled", "mp_coupled"):
        cfg, params, state, grid, walls, body = smoke.coupled_scene(
            dev, solver == "mp_coupled")
        held = {"body": body}

        def step(s):
            s, held["body"], d = nt.wcsph_coupled_step(
                s, params, grid, cfg, held["body"], walls)
            return s, d
        return state, step, ()
    if solver == "wide12M":
        from nereus_tpu_torch import scene
        from nereus_tpu_torch.probes import cells
        cfg, params = nt.SimConfig(), nt.make_params(device=dev)
        state, grid, _ = scene.dam_break(params, cfg, n_target=smoke.WIDE_N,
                                         with_boundary=False, device=dev)
        grid = cells.stretch_grid(grid)

        def step(s):
            return nt.wcsph_step(s, params, grid, cfg, None)
        return state, step, ()
    if solver == "lifecycle":
        from nereus_tpu_torch import scene
        cfg, params = nt.SimConfig(), nt.make_params(device=dev)
        state, grid, walls = scene.dam_break(
            params, cfg, n_target=smoke.MAIN_N,
            capacity_factor=smoke.LIFE_CAPACITY, device=dev)
        patch = smoke.emit_patch(params)
        n0 = int(state.num_active)
        drain_y = float(state.pos[:n0, 1].min()) - smoke.DRAIN_DEPTH
        count = [0]

        def step(s):
            count[0] += 1
            if count[0] % smoke.EMIT_EVERY == 0:
                s, _ = nt.add_particles_traced(s, patch, smoke.EMIT_VEL)
            s, d = nt.wcsph_step(s, params, grid, cfg, walls)
            return nt.remove_particles(s, s.pos[:, 1] >= drain_y), d
        return state, step, ()
    if solver in ("wavemaker", "mp_wavemaker"):
        cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
        if solver == "mp_wavemaker":
            state = smoke.two_phase(state, params)
        grid, bd_at = smoke.wavemaker(grid, boundary, params)

        def step(s):
            return nt.wcsph_step(s, params, grid, cfg, bd_at())
        return state, step, ()
    if solver in ("wcsph", "multiphase", "xsph", "wcsph_visc"):
        cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
        if solver == "multiphase":
            state = smoke.two_phase(state, params)
        if solver == "wcsph_visc":
            cfg = dataclasses.replace(cfg, viscosity_model="implicit")
            params = nt.make_params(viscosity=smoke.VISC_NU, device=dev)
        eps = smoke.XSPH_EPS if solver == "xsph" else None

        def step(s):
            return nt.wcsph_step(s, params, grid, cfg, boundary,
                                 xsph_eps=eps)
        return state, step, ((viscosity.LOOP,) if solver == "wcsph_visc"
                             else ())
    n = smoke.MAIN_N if solver == "iisph" else smoke.SETTLED_N
    _, _, state, _, _, step = smoke.settled_main_path(solver, dev, n)
    dfsph = (dfsph_cuda.LOOP_V, dfsph_cuda.LOOP)
    loops = {"iisph": (iisph_cuda.LOOP,), "pcisph": (pcisph_cuda.LOOP,),
             "dfsph": dfsph, "dfsph_mp": dfsph,
             "dfsph_visc": dfsph + (viscosity.LOOP,)}[solver]
    return state, step, loops


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", choices=(
        "wcsph", "multiphase", "xsph", "wcsph_visc", "iisph", "pcisph",
        "dfsph", "dfsph_visc", "dfsph_mp", "pbf", "pbf_vort", "pbf_settled",
        "wavemaker", "mp_wavemaker", "coupled", "mp_coupled", "elastic",
        "elastic_plastic", "wcsph_elastic", "dfsph_coupled",
        "dfsph_mp_coupled", "dfsph_elastic", "wide12M", "lifecycle"),
        required=True)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--sync-every", type=int)
    ap.add_argument("--cg-sync-every", type=int)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    state, step, loops = build(args.solver, dev)
    if args.sync_every is not None:
        import importlib
        name = args.solver.split("_")[0]
        importlib.import_module(
            f"nereus_tpu_torch.solvers.{name}_cuda").SYNC_EVERY = \
            args.sync_every
        print(f"{name}: SYNC_EVERY = {args.sync_every}")
    if args.cg_sync_every is not None:
        from nereus_tpu_torch.solvers import viscosity
        viscosity.SYNC_EVERY = args.cg_sync_every
        print(f"viscosity CG: SYNC_EVERY = {args.cg_sync_every}")
    iters = []
    for _ in range(args.warmup):
        state, diag = step(state)
    torch.cuda.synchronize()

    for lp in loops:
        lp.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.steps):
        state, diag = step(state)
        iters.append(getattr(diag, "solver_iters", 0))
    end.record()
    t_host = (time.perf_counter() - t0) * 1e3 / args.steps
    torch.cuda.synchronize()
    ms_plain = start.elapsed_time(end) / args.steps
    n_it = [int(i) for i in iters]
    print(f"{args.solver}: steps {args.warmup + 1}-{args.warmup + args.steps}"
          f": {ms_plain:.4f} ms/step (CUDA events), host loop "
          f"{t_host:.4f} ms/step"
          f" to the last enqueue; solver_iters {n_it}, iterations launched "
          f"{[lp.launched for lp in loops]}, host syncs "
          f"{[lp.syncs for lp in loops]} (per solver loop)")

    from torch.profiler import ProfilerActivity, profile
    iters = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.steps):
            state, diag = step(state)
            iters.append(getattr(diag, "solver_iters", 0))
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.steps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the device-side events only: a CPU operator's entry repeats the
    # device time of the kernels it launched
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e3 / args.steps
    print(f"profiled steps {args.warmup + args.steps + 1}-"
          f"{args.warmup + 2 * args.steps}: {ms:.4f} ms/step (CUDA events), "
          f"device busy {busy:.4f} ms/step, idle share "
          f"{max(0.0, 1.0 - busy / ms):.3f}; solver_iters "
          f"{[int(i) for i in iters]}")
    print(f"idle share of the unprofiled steps: "
          f"{max(0.0, 1.0 - busy / ms_plain):.4f}")
    print(f"{'device ms/step':>14} {'calls/step':>10}  kernel")
    for us, count, key in rows[:args.top]:
        print(f"{us / 1e3 / args.steps:14.4f} {count / args.steps:10.1f}  "
              f"{key[:100]}")
    groups = {"sweep kernels": 0.0, "sort": 0.0, "searchsorted": 0.0,
              "copies (cat/stack/index)": 0.0,
              "batched 3x3 products (gemm)": 0.0, "other": 0.0}
    for us, _, key in rows:
        k = key.lower()
        if "sweep_kernel" in k:
            g = "sweep kernels"
        elif "gemm" in k or "bmm" in k:
            g = "batched 3x3 products (gemm)"
        elif "sort" in k and "searchsorted" not in k:
            g = "sort"
        elif "searchsorted" in k:
            g = "searchsorted"
        elif any(w in k for w in ("cat", "copy", "index", "gather",
                                  "stack", "memcpy", "memset")):
            g = "copies (cat/stack/index)"
        else:
            g = "other"
        groups[g] += us / 1e3 / args.steps
    print("by group, device ms/step: " + ", ".join(
        f"{g} {v:.4f}" for g, v in groups.items()))


if __name__ == "__main__":
    main()
