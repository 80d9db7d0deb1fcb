"""The main-path step time of two checkouts of the PyTorch port, in turns
on one CUDA card, and a hash of each run's final state.

    python3 tools/step_turns.py PARENT_DIR CHANGE_DIR [--pairs N]
        [--solver wcsph|iisph|wcsph_visc|pcisph]

Each run is a fresh process in the root of one checkout, so that it
imports that checkout's package and builds its CUDA kernels (the first
run of a checkout compiles them, the later ones load the library). Both
sides are driven by this repository's ``chip_smoke.py``: wcsph, its
``wcsph_main_path`` (``dam_break(n_target=2**20)`` with its boundary
shell, 1,092,727 fluid particles) and ``run_wcsph`` (300 steps, steps
51-300 timed with CUDA events); wcsph_visc, the same at ν = 5 with the
implicit viscosity solve (``wcsph_1M_visc``; prints the CG iterations
launched); iisph, its ``settled_main_path`` (the settled
1,092,727-particle block) and ``run_steps`` (60 steps, steps 11-60
timed); pcisph, the settled 262,144-particle block of
``pcisph_256k_settled`` and ``run_steps`` (60 steps, steps 11-60 timed);
the implicit ones also print the run's total ``solver_iters``. Every run
prints a SHA-256 prefix of its final positions and velocities. After the
steps, the runs of wcsph_visc, iisph and pcisph also time their
solver's kernel on the final state, built as the step builds its
operands (the viscous Laplacian at the state's velocities; the pressure
force at its pressure, p/ρ²), by CUDA events over 2 × 20 launches, the
better of two, and print a hash of its output: the parent's kernel
against the change's at the same operands when the states agree. Pair k
runs the parent first when k is even and the change first when k is
odd. Prints every run, then each side's median and quartiles and whether
the two sides' final states and kernel outputs are bit-identical.
"""

import argparse
import os
import statistics
import subprocess
import sys

SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")

# run in the checkout's root: its package comes first on sys.path
RUN = r"""
import dataclasses, hashlib, importlib.util, sys
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
import nereus_tpu_torch as nt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import viscosity
from nereus_tpu_torch.solvers.sweep_common import (build_sweep_ctx,
                                                   pd2_operands)


def sha(*tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


dev = torch.device("cuda")
solver = sys.argv[2]
if solver in ("wcsph", "wcsph_visc"):
    cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
    if solver == "wcsph_visc":
        cfg = dataclasses.replace(cfg, viscosity_model="implicit")
        params = nt.make_params(viscosity=smoke.VISC_NU, device=dev)
    viscosity.LOOP.reset()
    state, _, ms, _ = smoke.run_wcsph(cfg, params, state, grid, boundary)
    iters = viscosity.LOOP.launched
else:
    n = smoke.MAIN_N if solver == "iisph" else smoke.SETTLED_N
    cfg, params, state, grid, boundary, step = smoke.settled_main_path(
        solver, dev, n)
    state, diags, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                           smoke.IMPLICIT_TIMED_FROM)
    iters = sum(int(d.solver_iters) for d in diags)
assert bool(torch.isfinite(state.pos).all())
kernel_ms, kernel_sha = 0.0, "-"
if solver != "wcsph":
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    # the change's tiled kernels take the step's tile plan, the parent's
    # kernels none
    kw = {"plan": ctx.tile_plan} if hasattr(ctx, "tile_plan") else {}
    vel = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dens = SP.density_sweep(cfg, ctx.queries(width=4),
                            ctx.pack(vel.unbind(1), params.particle_mass),
                            ctx.seg_start, ctx.seg_end, ctx.pvec)
    if solver == "wcsph_visc":
        sweep = SP.visc_laplacian_sweep
        args = viscosity.laplacian_operands(ctx, params, dens)(vel)
    else:
        sweep = SP.pressure_force_sweep
        ds = dens.clamp(min=1e-12)
        args = pd2_operands(ctx)(ctx.pres_prev / (ds * ds))
    out = sweep(cfg, *args, **kw)
    kernel_sha = sha(out)
    times = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            sweep(cfg, *args, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 20)
    kernel_ms = min(times)
print(ms, iters, sha(state.pos, state.vel), kernel_ms, kernel_sha)
"""

SOLVERS = ("wcsph", "iisph", "wcsph_visc", "pcisph")


def run(root, solver):
    """(ms/step, iterations, state hash, kernel ms, kernel output hash) of
    one run in the checkout ``root``: the total ``solver_iters`` (CG
    iterations launched for wcsph_visc, 0 for wcsph; no kernel timed for
    wcsph)."""
    res = subprocess.run([sys.executable, "-c", RUN, SMOKE, solver],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        sys.exit(f"step_turns: run in {root} failed:\n{res.stderr}")
    ms, iters, digest, kms, kdigest = \
        res.stdout.strip().splitlines()[-1].split()
    return float(ms), int(iters), digest, float(kms), kdigest


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--solver", choices=SOLVERS, default="wcsph")
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    times = {"parent": [], "change": []}
    kernel = {"parent": [], "change": []}
    hashes = {"parent": set(), "change": set()}
    khashes = {"parent": set(), "change": set()}
    for k in range(args.pairs):
        order = ("parent", "change") if k % 2 == 0 else ("change", "parent")
        for side in order:
            ms, iters, digest, kms, kdigest = run(roots[side], args.solver)
            times[side].append(ms)
            kernel[side].append(kms)
            hashes[side].add(digest)
            khashes[side].add(kdigest)
            print(f"pair {k + 1} {side}: {args.solver} {ms:.4f} ms/step, "
                  f"iterations {iters}, state {digest}, kernel {kms:.4f} "
                  f"ms, output {kdigest}", flush=True)
    def quartiles(x):
        return statistics.quantiles(x, n=4)[::2] if len(x) > 1 else x * 2

    for side, t in times.items():
        q1, q3 = quartiles(t)
        kq1, kq3 = quartiles(kernel[side])
        print(f"{side}: {args.solver} median {statistics.median(t):.4f} "
              f"ms/step, quartiles {q1:.4f}-{q3:.4f}, runs {len(t)}, "
              f"state hashes {sorted(hashes[side])}; kernel median "
              f"{statistics.median(kernel[side]):.4f} ms, quartiles "
              f"{kq1:.4f}-{kq3:.4f}, output hashes {sorted(khashes[side])}")
    for what, h in (("final positions and velocities", hashes),
                    ("kernel outputs", khashes)):
        same = h["parent"] == h["change"] and len(h["parent"]) == 1
        print(f"{args.solver}: {what} "
              + ("bit-identical on both sides" if same else "differ"))


if __name__ == "__main__":
    main()
