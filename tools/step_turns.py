"""The main-path step time of two checkouts of the PyTorch port, in turns
on one CUDA card.

    python3 tools/step_turns.py PARENT_DIR CHANGE_DIR [--pairs N]
        [--solver wcsph|iisph]

Each run is a fresh process in the root of one checkout, so that it
imports that checkout's package and builds its CUDA kernels (the first
run of a checkout compiles them, the later ones load the library). Both
sides are driven by this repository's ``chip_smoke.py``: wcsph, its
``wcsph_main_path`` (``dam_break(n_target=2**20)`` with its boundary
shell, 1,092,727 fluid particles) and ``run_wcsph`` (300 steps, steps
51-300 timed with CUDA events); iisph, its ``settled_main_path`` (the
settled 1,092,727-particle block) and ``run_steps`` (60 steps, steps 11-60
timed), which also prints the run's total ``solver_iters``. Pair k runs
the parent first when k is even and the change first when k is odd.
Prints every run, then each side's median and quartiles.
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
import importlib.util, sys
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
dev = torch.device("cuda")
if sys.argv[2] == "wcsph":
    cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
    state, _, ms, _ = smoke.run_wcsph(cfg, params, state, grid, boundary)
    iters = 0
else:
    *_, state, _, _, step = smoke.settled_main_path("iisph", dev,
                                                    smoke.MAIN_N)
    state, diags, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                           smoke.IMPLICIT_TIMED_FROM)
    iters = sum(int(d.solver_iters) for d in diags)
assert bool(torch.isfinite(state.pos).all())
print(ms, iters)
"""


def run(root, solver):
    """(ms/step, total solver_iters) of one run in the checkout ``root``."""
    res = subprocess.run([sys.executable, "-c", RUN, SMOKE, solver],
                         cwd=root, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        sys.exit(f"step_turns: run in {root} failed:\n{res.stderr}")
    ms, iters = res.stdout.strip().splitlines()[-1].split()
    return float(ms), int(iters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--solver", choices=("wcsph", "iisph"), default="wcsph")
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    times = {"parent": [], "change": []}
    for k in range(args.pairs):
        order = ("parent", "change") if k % 2 == 0 else ("change", "parent")
        for side in order:
            ms, iters = run(roots[side], args.solver)
            times[side].append(ms)
            print(f"pair {k + 1} {side}: {args.solver} {ms:.4f} ms/step, "
                  f"solver_iters {iters}", flush=True)
    for side, t in times.items():
        q1, _, q3 = statistics.quantiles(t, n=4)
        print(f"{side}: {args.solver} median {statistics.median(t):.4f} "
              f"ms/step, quartiles {q1:.4f}-{q3:.4f}, runs {len(t)}")


if __name__ == "__main__":
    main()
