"""Time the lane-group kernels of the PyTorch port at several lane counts G
on one path's operands, on one CUDA card.

    python3 tools/group_scan.py [--solver pbf|pbf_settled|pbf_vort_xsph|
                                 elastic|wcsph_elastic|dfsph|dfsph_visc|
                                 multiphase|multiphase_wavemaker|dfsph_mp|
                                 mp_coupled|dfsph_mp_coupled]
        [--groups 1 2 4] [--keys pbf_lambda pbf_dp pbf_grad drho
                                 elastic_force_hg mp_force mp_force_moving
                                 mp_drho mp_drho_cols]

The port's own library builds only the G that ``ops/cuda_sweep.py`` can
pick. This tool compiles libraries of its own from the same sources: per
source file of the keys asked for, one file that includes it (its
functors) and adds one entry point per key, built for every G asked for,
into ``nereus_tpu_torch/build/scan/``, all compiled at once, and prints
ptxas's registers and spills of each instance. A key names a functor and
an engine (``FUNCTORS``): the range walk ``NEREUS_GROUP_SWEEP`` of
``csrc/group_sweep.cuh`` (G 1 loads the next candidate's row ahead), or
its list form ``NEREUS_LIST_SWEEP`` over a static pair list.
``elastic_force_hg`` is the elastic force + hourglass kernel over the
body's pair list; ``mp_force`` and ``mp_force_moving`` the multiphase
force's Becker instances (static and moving walls); ``mp_drho`` the
dδ̂/dt kernel, which forms its one (N,) rate in its epilogue, and
``mp_drho_cols`` the same walk without the epilogue, writing the fluid
and wall sums as two columns, timed with the multiply and add that then
form the rate (``d[:, 0] + q[:, 6] * d[:, 1]``) and checked after them.

It drives the path as ``tools/step_turns.py`` does (``chip_smoke.py``'s
``pbf_main_path`` or ``settled_main_path`` and ``run_steps``) and builds
the kernels' operands with ``chip_smoke.py``'s ``pbf_path_operands`` (at
the state advected from the final one) or ``dfsph_operands`` (at the final
state). The multiphase paths run ``multiphase_1M`` (``wcsph_main_path``
split by ``two_phase``, ``N_STEPS`` steps), ``multiphase_1M_wavemaker``
(the same under ``wavemaker``), ``dfsph_mp_256k_settled``
(``settled_main_path``), ``mp_coupled_256k`` (``coupled_scene``) or
``dfsph_mp_coupled_256k`` (``dfsph_coupled_scene(kind="mp")``, the final
state lowered to 0.5·h over the floor as ``run_dfsph_coupled`` holds its
fluid kernels) and build their operands with ``multiphase_operands``,
``mp_dfsph_operands`` or ``coupled_operands``; the elastic paths build their body (``elastic_block``, the 80³
block of elastic_512k, or ``wcsph_elastic_scene``'s 16³ cube) and take
``elastic_kernel_ops`` at ``deformed`` positions, as ``chip_smoke.py``
holds the kernel, without steps. Each G's output is checked against the
wrapper's (``chip_smoke.py``'s ``check_lambda`` for λ, max|Δ| ≤
1e-4·max|ref| per column for the others) and timed host-free
(``chip_smoke.graph_ms``) in three interleaved rounds, the better of each.
"""

import argparse
import dataclasses
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

# key → (source of its functor, functor, engine: "ranges" or "list")
FUNCTORS = {"pbf_lambda": ("pbf_sweep.cu", "PbfLambda", "ranges"),
            "pbf_dp": ("pbf_sweep.cu", "PbfDp", "ranges"),
            "pbf_grad": ("pbf_sweep.cu", "PbfGrad", "ranges"),
            "drho": ("dfsph_sweep.cu", "Drho", "ranges"),
            "elastic_force_hg": ("elastic_sweep.cu", "ElasticForceHourglass",
                                 "list"),
            "mp_force": ("multiphase_sweep.cu",
                         "MultiphaseForce<true, false>", "ranges"),
            "mp_force_moving": ("multiphase_sweep.cu",
                                "MultiphaseForce<true, true>", "ranges"),
            "mp_drho": ("dfsph_multiphase_sweep.cu", "MultiphaseDrho",
                        "ranges"),
            "mp_drho_cols": ("dfsph_multiphase_sweep.cu", "MultiphaseDrhoCols",
                             "ranges")}
# functors the scan file defines: dδ̂/dt's pair without its epilogue
SCAN_FUNCTORS = {"MultiphaseDrhoCols": """
struct MultiphaseDrhoCols {
  static constexpr int QW = MultiphaseDrho::QW, SW = MultiphaseDrho::SW,
                       OW = MultiphaseDrho::OW;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    MultiphaseDrho::pair<KS, B>(q, a, src, j, p, acc);
  }
};
"""}
# the keys each path's operands feed
PATH_KEYS = {"pbf": ("pbf_lambda", "pbf_dp", "pbf_grad"),
             "dfsph": ("drho",),
             "elastic": ("elastic_force_hg",),
             "multiphase": ("mp_force",),
             "multiphase_wavemaker": ("mp_force_moving",),
             "dfsph_mp": ("mp_force", "mp_drho", "mp_drho_cols"),
             "mp_coupled": ("mp_force",),
             "dfsph_mp_coupled": ("mp_force", "mp_drho", "mp_drho_cols")}
MP_SOLVERS = ("multiphase", "multiphase_wavemaker", "dfsph_mp", "mp_coupled",
              "dfsph_mp_coupled")
SCAN_DIR = os.path.join(cuda_sweep.BUILD_DIR, "scan")


def build(keys, groups):
    """``{key: ctypes function}``: entry ``nereus_scan_<key>_sweep`` (or
    ``_list_sweep``) per key, built for ``groups``, one library per source
    file, compiled at once; prints ptxas's report of their instances."""
    os.makedirs(SCAN_DIR, exist_ok=True)
    gs = ", ".join(str(g) for g in groups)
    by_src = {}
    for key in keys:
        by_src.setdefault(FUNCTORS[key][0], []).append(key)
    cmds, libs = [], {}
    for src, ks in by_src.items():
        stem = os.path.splitext(src)[0]
        cu = os.path.join(SCAN_DIR, f"scan_{stem}.cu")
        with open(cu, "w") as f:
            f.write(f'#include "{os.path.join(cuda_sweep.CSRC, src)}"\n')
            for key in ks:
                _, functor, _ = FUNCTORS[key]
                f.write(SCAN_FUNCTORS.get(functor, ""))
                f.write(f"using scan_{key}_t = {functor};\n")
            f.write('extern "C" {\n')
            for key in ks:
                macro = ("NEREUS_LIST_SWEEP" if FUNCTORS[key][2] == "list"
                         else "NEREUS_GROUP_SWEEP")
                f.write(f"{macro}(scan_{key}, scan_{key}_t, {gs})\n")
            f.write("}\n")
        lib = os.path.join(SCAN_DIR, f"libscan_{stem}.so")
        cmds.append([cuda_sweep.nvcc_path(), *cuda_sweep.NVCC_FLAGS,
                     "-Xptxas", "-v", "-shared", "-o", lib, cu])
        libs[src] = lib
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log = ""
    for c, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            sys.exit(f"group_scan: nvcc failed:\n{' '.join(c)}\n{out}")
        log += out
    smoke.ptxas_report(log)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for src, ks in by_src.items():
        lib = ctypes.CDLL(libs[src])
        for key in ks:
            if FUNCTORS[key][2] == "list":
                f = getattr(lib, f"nereus_scan_{key}_list_sweep")
                f.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i32, i32, ptr,
                              ptr]
            else:
                f = getattr(lib, f"nereus_scan_{key}_sweep")
                f.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, i32, i32,
                              ptr, ptr]
            f.restype = i32
            fns[key] = f
    return fns


def path_operands(solver, keys, dev):
    """``(cfg, {key: (wrapper, args, kwargs)}, description)``: the path's
    operands of each key, each with the wrapper of the port's own
    kernel."""
    if solver in MP_SOLVERS:
        return mp_operands(solver, dev)
    if solver.startswith("pbf"):
        settled = solver == "pbf_settled"
        cfg, params, state, grid, boundary = smoke.pbf_main_path(dev,
                                                                 settled)
        kw = (dict(xsph_eps=smoke.PBF_XSPH_EPS,
                   vorticity_eps=smoke.PBF_VORTICITY_EPS)
              if solver == "pbf_vort_xsph" else {})
        steps = ((smoke.IMPLICIT_STEPS, smoke.IMPLICIT_TIMED_FROM)
                 if settled else (smoke.N_STEPS, smoke.TIMED_FROM))
        state, _, ms, *_ = smoke.run_steps(
            lambda s: nt.pbf_step(s, params, grid, cfg, boundary, **kw),
            state, *steps)
        ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params,
                              grid, cfg, boundary)
        ops = smoke.pbf_path_operands(cfg, ctx, params,
                                      vorticity="pbf_grad" in keys)
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                     }, f"{ctx.c} queries, {ms:.4f} ms/step"
    if solver.startswith("dfsph"):
        cfg, params, state, grid, boundary, step = smoke.settled_main_path(
            solver, dev, smoke.SETTLED_N)
        state, _, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                           smoke.IMPLICIT_TIMED_FROM)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        ops = smoke.dfsph_operands(cfg, ctx, params)
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                     }, f"{ctx.c} queries, {ms:.4f} ms/step"
    if solver == "elastic":
        cfg, params, ep, _, statics, grid, sp = smoke.elastic_block(dev,
                                                                    False)
    else:
        (cfg, params, _, grid, _, _, statics, ep, _,
         sp) = smoke.wcsph_elastic_scene(dev)
    ops = smoke.elastic_kernel_ops(cfg, params, grid, statics,
                                   smoke.deformed(statics.x0, sp), ep)
    kern, _, a, kw = ops["elastic_force_hg"]
    return cfg, {"elastic_force_hg": (kern, a, kw)}, (
        f"{statics.n} queries, {int(a[3].shape[0])} pairs in the list")


def mp_operands(solver, dev):
    """``path_operands`` of the multiphase paths (``MP_SOLVERS``): the
    multiphase force (``mp_force``; ``mp_force_moving`` under the
    wavemaker) and, on the DFSPH paths, dδ̂/dt (``mp_drho``, and
    ``mp_drho_cols`` on the same operands)."""
    lowered = False
    if solver.startswith("multiphase"):
        cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
        state = smoke.two_phase(state, params)
        steps = (smoke.N_STEPS, smoke.TIMED_FROM)
        bd_at = None
        if solver == "multiphase_wavemaker":
            grid, bd_at = smoke.wavemaker(grid, boundary, params)

        def step(s):
            return nt.wcsph_step(s, params, grid, cfg,
                                 bd_at() if bd_at else boundary)
    elif solver == "dfsph_mp":
        cfg, params, state, grid, boundary, step = smoke.settled_main_path(
            solver, dev, smoke.SETTLED_N)
        steps = (smoke.IMPLICIT_STEPS, smoke.IMPLICIT_TIMED_FROM)
    else:
        if solver == "mp_coupled":
            cfg, params, state, grid, boundary, body = smoke.coupled_scene(
                dev, True)
            fn = nt.wcsph_coupled_step
            kw = {}
        else:
            cfg, params, state, grid, boundary, body = (
                smoke.dfsph_coupled_scene(dev, "mp"))
            fn = nt.dfsph_coupled_step
            kw = dict(tol=smoke.DFSPH_TOL, tol_v=smoke.DFSPH_TOL)
            lowered = True
        held = {"body": body}

        def step(s):
            s, held["body"], d = fn(s, params, grid, cfg, held["body"],
                                    boundary, **kw)
            return s, d
        steps = (smoke.IMPLICIT_STEPS, smoke.IMPLICIT_TIMED_FROM)
    state, _, ms, *_ = smoke.run_steps(step, state, *steps)
    if solver == "multiphase_wavemaker":
        boundary = bd_at.last[0]
    if lowered:
        # as run_dfsph_coupled holds its fluid kernels: the block lowered
        # until its bottom layer lies 0.5·h over the floor
        n = int(state.num_active)
        h = float(params.interaction_radius)
        drop = (float(state.pos[:n, 1].min())
                - (float(boundary.pos[:, 1].min()) + 0.5 * h))
        state = dataclasses.replace(state, pos=state.pos - torch.tensor(
            [0.0, max(drop, 0.0), 0.0], device=dev))
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    if solver.startswith("multiphase"):
        ops = smoke.multiphase_operands(cfg, ctx, params)
        if solver == "multiphase_wavemaker":
            ops = {"mp_force_moving": smoke.moving(ops["mp_force"])}
    elif solver == "mp_coupled":
        ops = smoke.coupled_operands(cfg, ctx, params, grid, held["body"])
    else:
        ops = smoke.mp_dfsph_operands(cfg, ctx, params)
        ops["mp_drho_cols"] = ops["mp_drho"]
    return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                 }, f"{ctx.c} queries, {ms:.4f} ms/step"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="pbf",
                    choices=("pbf", "pbf_settled", "pbf_vort_xsph",
                             "elastic", "wcsph_elastic", "dfsph",
                             "dfsph_visc", *MP_SOLVERS))
    ap.add_argument("--groups", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--keys", nargs="+", choices=sorted(FUNCTORS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("group_scan: needs a CUDA card")
    family = (args.solver if args.solver in MP_SOLVERS
              else "pbf" if args.solver.startswith("pbf") else "dfsph"
              if args.solver.startswith("dfsph") else "elastic")
    keys = args.keys or list(PATH_KEYS[family][:2])
    if not set(keys) <= set(PATH_KEYS[family]):
        sys.exit(f"group_scan: --solver {args.solver} feeds the keys "
                 f"{PATH_KEYS[family]}, not {keys}")
    fns = build(keys, args.groups)
    dev = torch.device("cuda")
    cfg, ops, desc = path_operands(args.solver, keys, dev)
    print(f"{args.solver}: {desc}; {torch.cuda.get_device_name(0)}")
    for key in keys:
        kern, a, kwk = ops[key]
        q, src, s, e, pv = a
        ref = kern(cfg, *a, **kwk)
        f = fns[key]
        cols = key == "mp_drho_cols"

        def launch(g, out):
            lead = ((q.data_ptr(), src.data_ptr(), s.data_ptr(),
                     e.data_ptr(), q.shape[0])
                    + (() if FUNCTORS[key][2] == "list" else (s.shape[0],)))
            rc = f(*lead, pv.data_ptr(), cfg.kernel_set.value, g,
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"group_scan: {key} G {g} launch failed ({rc})")
            # the two-column form: the rate formed after the kernel
            return out[:, 0] + q[:, 6] * out[:, 1] if cols else out
        outs = {}
        for g in args.groups:
            out = (q.new_empty((q.shape[0], 2)) if cols
                   else torch.empty_like(ref))
            got = launch(g, out)
            torch.cuda.synchronize()
            if key == "pbf_lambda":
                smoke.check_lambda(out, ref, pv, f"{key} G {g}")
                torch.testing.assert_close(out[:, 0], ref[:, 0], rtol=1e-5,
                                           atol=0)
            else:
                o2, r2 = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
                err = (o2 - r2).abs().amax(dim=0)
                if not bool((err <= 1e-4 * r2.abs().amax(dim=0)).all()):
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
