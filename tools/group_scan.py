"""Time the PBF loop's lane-group kernels of the PyTorch port at several
lane counts G on one path's operands, on one CUDA card.

    python3 tools/group_scan.py [--solver pbf|pbf_settled|pbf_vort_xsph]
        [--groups 1 2 4] [--keys pbf_lambda pbf_dp pbf_grad]

The port's own library builds only the G that ``ops/cuda_sweep.py`` can
pick. This tool compiles a library of its own from the same sources: one
file that includes ``csrc/pbf_sweep.cu`` (its functors) and adds one entry
point per key, built for every G asked for (``NEREUS_GROUP_SWEEP`` of
``csrc/group_sweep.cuh``; G 1 loads the next candidate's row ahead), into
``nereus_tpu_torch/build/scan/``, and prints ptxas's registers and spills
of each instance. It drives the path as ``tools/step_turns.py`` does
(``chip_smoke.py``'s ``pbf_main_path`` and ``run_steps``), builds the
kernels' operands at the state advected from the final one with
``chip_smoke.py``'s ``pbf_path_operands``, checks each G's output against
the wrapper's (``chip_smoke.py``'s ``check_lambda`` for λ, max|Δ| ≤
1e-4·max|ref| per column for the others) and times it host-free
(``chip_smoke.graph_ms``) in three interleaved rounds, the better of each.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
import nereus_tpu_torch as nt  # noqa: E402
from nereus_tpu_torch.ops import cuda_sweep  # noqa: E402
from nereus_tpu_torch.solvers import pbf_cuda  # noqa: E402
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx  # noqa

# key → the functor of csrc/pbf_sweep.cu it launches
FUNCTORS = {"pbf_lambda": "PbfLambda", "pbf_dp": "PbfDp",
            "pbf_grad": "PbfGrad"}
SCAN_DIR = os.path.join(cuda_sweep.BUILD_DIR, "scan")


def build(keys, groups):
    """The scan library's path: entry ``nereus_scan_<key>_sweep`` per key,
    built for ``groups``; prints ptxas's report of its instances."""
    os.makedirs(SCAN_DIR, exist_ok=True)
    src = os.path.join(SCAN_DIR, "scan.cu")
    gs = ", ".join(str(g) for g in groups)
    with open(src, "w") as f:
        f.write(f'#include "{os.path.join(cuda_sweep.CSRC, "pbf_sweep.cu")}"'
                '\nextern "C" {\n')
        for key in keys:
            f.write(f"NEREUS_GROUP_SWEEP(scan_{key}, {FUNCTORS[key]}, {gs})\n")
        f.write("}\n")
    lib = os.path.join(SCAN_DIR, "libscan.so")
    res = subprocess.run(
        [cuda_sweep.nvcc_path(), *cuda_sweep.NVCC_FLAGS, "-Xptxas", "-v",
         "-shared", "-o", lib, src], capture_output=True, text=True,
        timeout=900)
    if res.returncode != 0:
        sys.exit(f"group_scan: nvcc failed:\n{res.stdout}{res.stderr}")
    smoke.ptxas_report(res.stdout + res.stderr)
    return lib


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="pbf",
                    choices=("pbf", "pbf_settled", "pbf_vort_xsph"))
    ap.add_argument("--groups", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--keys", nargs="+", default=["pbf_lambda", "pbf_dp"],
                    choices=sorted(FUNCTORS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("group_scan: needs a CUDA card")
    lib = ctypes.CDLL(build(args.keys, args.groups))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda")
    settled = args.solver == "pbf_settled"
    cfg, params, state, grid, boundary = smoke.pbf_main_path(dev, settled)
    kw = (dict(xsph_eps=smoke.PBF_XSPH_EPS,
               vorticity_eps=smoke.PBF_VORTICITY_EPS)
          if args.solver == "pbf_vort_xsph" else {})
    steps = ((smoke.IMPLICIT_STEPS, smoke.IMPLICIT_TIMED_FROM) if settled
             else (smoke.N_STEPS, smoke.TIMED_FROM))
    state, _, ms, *_ = smoke.run_steps(
        lambda s: nt.pbf_step(s, params, grid, cfg, boundary, **kw), state,
        *steps)
    ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                          cfg, boundary)
    ops = smoke.pbf_path_operands(cfg, ctx, params,
                                  vorticity="pbf_grad" in args.keys)
    print(f"{args.solver}: {ctx.c} queries, {ms:.4f} ms/step over the "
          f"timed steps; {torch.cuda.get_device_name(0)}")
    for key in args.keys:
        kern, _, a, kwk = ops[key]
        q, src, s, e, pv = a
        ref = kern(cfg, *a, **kwk)
        f = getattr(lib, f"nereus_scan_{key}_sweep")
        f.restype = i32
        f.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, i32, i32, ptr, ptr]

        def launch(g, out):
            rc = f(q.data_ptr(), src.data_ptr(), s.data_ptr(),
                   e.data_ptr(), q.shape[0], s.shape[0], pv.data_ptr(),
                   cfg.kernel_set.value, g, out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"group_scan: {key} G {g} launch failed ({rc})")
        outs = {}
        for g in args.groups:
            out = torch.empty_like(ref)
            launch(g, out)
            torch.cuda.synchronize()
            if key == "pbf_lambda":
                smoke.check_lambda(out, ref, pv, f"{key} G {g}")
                torch.testing.assert_close(out[:, 0], ref[:, 0], rtol=1e-5,
                                           atol=0)
            else:
                err = (out - ref).abs().amax(dim=0)
                if not bool((err <= 1e-4 * ref.abs().amax(dim=0)).all()):
                    sys.exit(f"group_scan: {key} G {g} differs from the "
                             f"wrapper's output by {err.tolist()}")
            outs[g] = out
        best = {}
        for _ in range(3):
            for g in args.groups:
                t = smoke.graph_ms(lambda: launch(g, outs[g]))
                best[g] = min(best.get(g, t), t)
        wrapper = smoke.graph_ms(lambda: kern(cfg, *a, **kwk))
        print(f"{key} at {args.solver}: host-free ms by G: "
              + ", ".join(f"G{g} {t:.4f}" for g, t in best.items())
              + f"; the wrapper's own {wrapper:.4f}")


if __name__ == "__main__":
    main()
