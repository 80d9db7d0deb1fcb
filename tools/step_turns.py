"""The main-path step time of two checkouts of the PyTorch port, in turns
on one CUDA card, their kernels' times on the final state, and how far
the two final states lie apart.

    python3 tools/step_turns.py PARENT_DIR CHANGE_DIR [--pairs N]
        [--solver wcsph|wcsph_wide12M|xsph|iisph|wcsph_visc|pcisph|pbf|
                  pbf_settled|pbf_vort_xsph|dfsph|dfsph_visc|elastic|
                  wcsph_elastic|dfsph_elastic|multiphase|
                  multiphase_wavemaker|dfsph_mp|coupled|dfsph_coupled|
                  dfsph_mp_coupled]
    python3 tools/step_turns.py PARENT_DIR CHANGE_DIR --smoke [--pairs N]
        [--log DIR]
    python3 tools/step_turns.py PARENT_DIR CHANGE_DIR --drift STEPS
        [--solver ...]

Each run is a fresh process in the root of one checkout, so that it
imports that checkout's package and builds its CUDA kernels (the first
run of a checkout compiles them, the later ones load the library). Both
sides' scenes and steps are driven by this repository's ``chip_smoke.py``:
wcsph, its ``wcsph_main_path`` (``dam_break(n_target=2**20)`` with its
boundary shell, 1,092,727 fluid particles) and ``run_wcsph`` (300 steps,
steps 51-300 timed with CUDA events); xsph, the same scene stepped with
``XSPH_EPS`` (``wcsph_1M_xsph``) by ``run_steps`` (300 steps, steps
51-300 timed); wcsph_wide12M, its
``wide_main_path`` (``bench.py``'s 12M dam-break on the grid stretched past
2^24 cells) and ``WIDE_WARMUP`` + ``WIDE_TIMED`` steps, the last
``WIDE_TIMED`` timed; wcsph_visc, the 1M dam-break at ν = 5 with the
implicit viscosity solve (``wcsph_1M_visc``; prints the CG iterations
launched); iisph, its ``settled_main_path`` (the settled 1,092,727-particle
block) and ``run_steps`` (60 steps, steps 11-60 timed); pcisph, the
settled 262,144-particle block of ``pcisph_256k_settled`` and ``run_steps``
(60 steps, steps 11-60 timed); the implicit ones also print the run's
total ``solver_iters``. pbf, its ``pbf_main_path`` (``pbf_1M``, the
1,092,727-particle dam-break with its 119,688-sample shell) and
``run_steps`` over ``pbf_step`` as ``run_pbf_path`` drives it (300 steps,
steps 51-300 timed); pbf_settled, ``pbf_main_path(settled=True)``
(``pbf_256k_settled``, 60 steps, steps 11-60 timed); pbf_vort_xsph,
``pbf_1M`` with ``PBF_XSPH_EPS`` and ``PBF_VORTICITY_EPS``
(``pbf_1M_vort_xsph``); dfsph and dfsph_visc, ``settled_main_path``'s
262,144-particle blocks of ``dfsph_256k_settled`` and
``dfsph_visc_256k_settled`` and ``run_steps`` (60 steps, steps 11-60
timed); elastic, ``elastic_block`` (``elastic_512k``, the 80³ block) and
``run_steps`` over ``elastic_step`` (60 steps, steps 11-60 timed);
wcsph_elastic, ``wcsph_elastic_scene`` (``wcsph_elastic_256k``, 4
substeps) and dfsph_elastic, ``dfsph_coupled_scene(kind="elastic")``
(``dfsph_elastic_256k``), each 60 steps, steps 11-60 timed; multiphase,
``wcsph_main_path`` split by ``two_phase`` (``multiphase_1M``), and
multiphase_wavemaker, the same under ``wavemaker``
(``multiphase_1M_wavemaker``), each 300 steps, steps 51-300 timed;
dfsph_mp, ``settled_main_path``'s two-phase block
(``dfsph_mp_256k_settled``), 60 steps, steps 11-60 timed; dfsph_coupled
and dfsph_mp_coupled, ``dfsph_coupled_scene`` with its rigid box
(``dfsph_coupled_256k``, ``dfsph_mp_coupled_256k``), 60 steps, steps 11-60
timed; coupled, ``coupled_scene`` (``coupled_256k``, its rigid box over
the settled block) stepped by ``wcsph_coupled_step``, 60 steps, steps
11-60 timed.

After the steps each run times its own kernels on its final state with the
operands built by its own checkout's ``chip_smoke.py`` (its
``sweep_inputs``, ``wcsph_visc_operands``, ``iisph_operands``,
``pcisph_operands``, ``xsph_path_operands`` or ``pbf_path_operands``, so
that each side feeds its kernels in its own contract): the density and
force kernels on the WCSPH, XSPH, IISPH and PCISPH paths, and XSPH's
kernel (xsph), the Laplacian (wcsph_visc), the pressure force (iisph,
pcisph), the pre-loop sweep of d_ii, ρ_adv and a_ii (key ``dii_aii``,
which an earlier checkout runs as two, keys ``dii_rhoadv`` and ``aii``)
and the Jacobi loop's Σd_ij·p_j and Jacobi sums (iisph), the PBF loop's
λ and Δp kernels and, with vorticity confinement, N (key ``pbf_grad``,
which an earlier checkout computes with its λ kernel), ω and XSPH, at
the state advected from the final one (pbf*), Dρ/Dt (dfsph*,
``dfsph_operands``; with the pressure force at dfsph_coupled; and over
the body's shell at dfsph_coupled and dfsph_elastic, key ``drho_shell``,
from ``dfsph_coupled_held_ops``, the body in the middle of the lowered
fluid, the body contact's friction alone, key ``body_force_p0``, and
the shell's ψ-density with α's shell sums, key ``body_density_alpha``
(``body_density_alpha_sq`` at dfsph_elastic), which an earlier checkout
runs as two, keys ``body_density`` and ``alpha_body`` (``alpha_shell``);
at dfsph_mp_coupled the body density and the shell's κ̂ correction, keys
``body_density`` and ``mp_kappa_body``),
the body contact force at coupled (with the density, force and body
density kernels, ``coupled_operands``) and wcsph_elastic (key
``body_force``, ``elastic_coupled_ops``), each with the body moved into
the middle of the fluid, the multiphase density and force (multiphase,
``multiphase_operands``; MultiphaseForce<MOVING> under the wavemaker)
and the multiphase density and α̂'s sums (key ``mp_density_alpha``,
which an earlier checkout runs as two, keys ``mp_density`` and
``mp_alpha``), the multiphase force, dδ̂/dt and κV̂² correction (dfsph_mp,
dfsph_mp_coupled, ``mp_dfsph_operands``), and the elastic kernels on the
body's statics at ``deformed`` positions (elastic, wcsph_elastic,
dfsph_elastic, ``elastic_kernel_ops``), each host-free (20 launches
captured in a CUDA graph, the replay timed with CUDA events, the better
of two), and prints a hash of each output. Pair k
runs the parent first when k is even and the change first when k is odd.
On the paths driven by ``run_steps`` (all but wcsph, wcsph_visc and
wcsph_wide12M; xsph, multiphase and multiphase_wavemaker too) each run also
times its host loop on the host's clock:
ms/step from the first timed step's call to the last step's return, the
last enqueue, before the wait for the card. Prints every run, then each side's median and quartiles, and the largest
position and velocity difference between the two sides' final states of
the first pair: each particle of the parent's state against the nearest
particle of the change's (the states come out in hash order, which a
difference of rounding may change). Every run prints a SHA-256 prefix of
its final positions and velocities.

With ``--drift 1,10,300`` each checkout runs once, and the change once
more with every live position one float32 ulp up before the first step;
after each of the steps named, the change's live state is held against
the parent's and against the nudged run's. The nudged run shows how far
the path carries a difference of one rounding, to set beside the distance
between the two checkouts.

With ``--smoke`` each run is instead the checkout's own ``chip_smoke.py``,
whole: wherever it times a kernel (its ``time_turns``), the kernel is also
timed host-free here, the better of three, on that run's operands, and
recorded under the label of the path (the ``label`` its ``compare`` or
``compare_kernels`` was called with) and the kernel's key. So each side
builds its operands by its own contract and calls its own wrappers, and
the parent's kernels are timed host-free on every path where its smoke run
times them (a kernel whose launches cannot be captured in a graph is left
out). Prints, per path and kernel, the better of each side's runs (the
pairs interleaved as above) and their ratio; the smoke runs' own output
goes to ``--log`` DIR, and a failed smoke run stops the tool.
"""

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

SMOKE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "chip_smoke.py")

# host-free mean ms of fn: reps launches captured in a CUDA graph, its
# replay timed with CUDA events, the better of two
GRAPH_MS = r"""
def graph_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best

"""

# run in the checkout's root: its package comes first on sys.path; argv:
# this repository's chip_smoke.py, the solver, the file for the final state
# and, for --drift, the steps after which the live state is saved too (to
# that file's name + ".<step>") and "1" to move every live position one
# float32 ulp up before the first step
RUN = r"""
import dataclasses, hashlib, importlib.util, json, os, sys, time
import torch


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


smoke = load("chip_smoke", sys.argv[1])
own = load("own_smoke", os.path.join(os.getcwd(), "chip_smoke.py"))
import nereus_tpu_torch as nt
from nereus_tpu_torch.ops import sph_pairs as SP
from nereus_tpu_torch.solvers import pbf_cuda, viscosity
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx


def sha(*tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes()
                                   for t in tensors)).hexdigest()[:16]


GRAPH_MS
# the host's clock over the timed steps: from the first timed step's call
# to the last step's return, before run_steps waits for the card
host = {"calls": 0, "t0": None, "t1": None, "timed_from": None}
marks = ({int(k) for k in sys.argv[4].split(",")} if len(sys.argv) > 4
         else set())
nudge = len(sys.argv) > 5 and sys.argv[5] == "1"


def save(state, path):
    live = state.active_mask()
    torch.save({"pos": state.pos[live].cpu(), "vel": state.vel[live].cpu(),
                "h": float(params.interaction_radius)}, path)


def clocked(step, timed_from):
    host["timed_from"] = timed_from

    def wrapped(s):
        if nudge and host["calls"] == 0:
            up = torch.nextafter(s.pos, torch.full_like(s.pos, float("inf")))
            s = dataclasses.replace(s, pos=torch.where(
                s.active_mask()[:, None], up, s.pos))
        if host["calls"] == timed_from:
            host["t0"] = time.perf_counter()
        out = step(s)
        host["calls"] += 1
        host["t1"] = time.perf_counter()
        if host["calls"] in marks:
            save(out[0], f"{sys.argv[3]}.{host['calls']}")
        return out
    return wrapped


dev = torch.device("cuda")
solver = sys.argv[2]
iters = 0
if solver in ("wcsph", "wcsph_visc"):
    cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
    if solver == "wcsph_visc":
        cfg = dataclasses.replace(cfg, viscosity_model="implicit")
        params = nt.make_params(viscosity=smoke.VISC_NU, device=dev)
    viscosity.LOOP.reset()
    state, _, ms, _ = smoke.run_wcsph(cfg, params, state, grid, boundary)
    iters = viscosity.LOOP.launched
elif solver == "wcsph_wide12M":
    cfg, params, state, grid, boundary = smoke.wide_main_path(dev)
    for _ in range(smoke.WIDE_WARMUP):
        state, _ = nt.wcsph_step(state, params, grid, cfg, None)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(smoke.WIDE_TIMED):
        state, _ = nt.wcsph_step(state, params, grid, cfg, None)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / smoke.WIDE_TIMED
elif solver == "xsph":
    cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
    state, _, ms, *_ = smoke.run_steps(
        clocked(lambda s: nt.wcsph_step(s, params, grid, cfg, boundary,
                                        xsph_eps=smoke.XSPH_EPS),
                smoke.TIMED_FROM), state, smoke.N_STEPS, smoke.TIMED_FROM)
elif solver.startswith("multiphase"):
    cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
    state = smoke.two_phase(state, params)
    bd_at = None
    if solver == "multiphase_wavemaker":
        grid, bd_at = smoke.wavemaker(grid, boundary, params)
    state, _, ms, *_ = smoke.run_steps(
        clocked(lambda s: nt.wcsph_step(s, params, grid, cfg,
                                        bd_at() if bd_at else boundary),
                smoke.TIMED_FROM), state, smoke.N_STEPS, smoke.TIMED_FROM)
    if bd_at:
        boundary = bd_at.last[0]
elif solver.startswith("pbf"):
    settled = solver == "pbf_settled"
    cfg, params, state, grid, boundary = smoke.pbf_main_path(dev, settled)
    kw = (dict(xsph_eps=smoke.PBF_XSPH_EPS,
               vorticity_eps=smoke.PBF_VORTICITY_EPS)
          if solver == "pbf_vort_xsph" else {})
    steps = ((smoke.IMPLICIT_STEPS, smoke.IMPLICIT_TIMED_FROM) if settled
             else (smoke.N_STEPS, smoke.TIMED_FROM))
    state, diags, ms, *_ = smoke.run_steps(
        clocked(lambda s: nt.pbf_step(s, params, grid, cfg, boundary, **kw),
                steps[1]), state, *steps)
    iters = sum(int(d.solver_iters) for d in diags)
elif solver == "coupled":
    cfg, params, state, grid, boundary, body = smoke.coupled_scene(dev,
                                                                   False)
    held = {"body": body}

    def step(s):
        s, held["body"], d = nt.wcsph_coupled_step(s, params, grid, cfg,
                                                   held["body"], boundary)
        return s, d
    state, diags, ms, *_ = smoke.run_steps(
        clocked(step, smoke.IMPLICIT_TIMED_FROM), state, smoke.IMPLICIT_STEPS,
        smoke.IMPLICIT_TIMED_FROM)
elif solver in ("dfsph_coupled", "dfsph_mp_coupled"):
    cfg, params, state, grid, boundary, body = smoke.dfsph_coupled_scene(
        dev, "rigid" if solver == "dfsph_coupled" else "mp")
    held = {"body": body}

    def step(s):
        s, held["body"], d = nt.dfsph_coupled_step(
            s, params, grid, cfg, held["body"], boundary,
            tol=smoke.DFSPH_TOL, tol_v=smoke.DFSPH_TOL)
        return s, d
    state, diags, ms, *_ = smoke.run_steps(
        clocked(step, smoke.IMPLICIT_TIMED_FROM), state, smoke.IMPLICIT_STEPS,
        smoke.IMPLICIT_TIMED_FROM)
    iters = sum(int(d.solver_iters) for d in diags)
elif solver in ("elastic", "wcsph_elastic", "dfsph_elastic"):
    if solver == "elastic":
        cfg, params, ep, state, statics, grid, sp = smoke.elastic_block(
            dev, False)
        boundary = None

        def step(s):
            return nt.elastic_step(s, statics, params, ep, grid, cfg)
    else:
        if solver == "wcsph_elastic":
            (cfg, params, state, grid, boundary, estate, statics, ep, psi,
             sp) = smoke.wcsph_elastic_scene(dev)
            fn, kw = nt.wcsph_elastic_step, {}
        else:
            cfg, params, state, grid, boundary, body = (
                smoke.dfsph_coupled_scene(dev, "elastic"))
            estate, statics, ep, psi = body
            sp = 0.5 * float(params.interaction_radius)
            fn, kw = nt.dfsph_elastic_step, dict(tol=smoke.DFSPH_TOL,
                                                 tol_v=smoke.DFSPH_TOL)
        held = {"body": estate}

        def step(s):
            s, held["body"], d = fn(s, params, grid, cfg, held["body"],
                                    statics, ep, psi, boundary,
                                    substeps=smoke.WEL_SUBSTEPS, **kw)
            return s, d
    state, diags, ms, *_ = smoke.run_steps(
        clocked(step, smoke.IMPLICIT_TIMED_FROM), state, smoke.IMPLICIT_STEPS,
        smoke.IMPLICIT_TIMED_FROM)
    if solver == "dfsph_elastic":
        iters = sum(int(d.solver_iters) for d in diags)
else:
    n = smoke.MAIN_N if solver == "iisph" else smoke.SETTLED_N
    cfg, params, state, grid, boundary, step = smoke.settled_main_path(
        solver, dev, n)
    state, diags, ms, *_ = smoke.run_steps(
        clocked(step, smoke.IMPLICIT_TIMED_FROM), state, smoke.IMPLICIT_STEPS,
        smoke.IMPLICIT_TIMED_FROM)
    iters = sum(int(d.solver_iters) for d in diags)
assert bool(torch.isfinite(state.pos).all())
live = (torch.ones(len(state.pos), dtype=torch.bool, device=dev)
        if solver == "elastic" else state.active_mask())
torch.save({"pos": state.pos[live].cpu(), "vel": state.vel[live].cpu(),
            "h": float(params.interaction_radius)}, sys.argv[3])
ctx = None if solver == "elastic" else build_sweep_ctx(
    pbf_cuda.advected(state, params) if solver.startswith("pbf") else state,
    params, grid, cfg, boundary)
if solver.endswith("elastic"):
    ops = {k: (kern, args, kw) for k, (kern, _, args, kw)
           in own.elastic_kernel_ops(cfg, params, grid, statics,
                                     own.deformed(statics.x0, sp),
                                     ep).items()}
    if solver == "wcsph_elastic":
        # the body contact with the cube moved, at its last velocities,
        # into the middle of the fluid, as chip_smoke.py holds it
        b = held["body"]
        nf = int(state.num_active)
        inside = dataclasses.replace(
            b, pos=b.pos - b.pos.mean(dim=0) + state.pos[:nf].mean(dim=0))
        kern, _, args, kw = own.elastic_coupled_ops(
            cfg, ctx, params, grid, inside, psi)["body_force"]
        ops["body_force"] = (kern, args, kw)
    if solver == "dfsph_elastic":
        kern, _, args, kw = own.dfsph_operands(cfg, ctx, params)["drho"]
        ops["drho"] = (kern, args, kw)
elif solver == "coupled":
    # the body moved, at its last velocities, into the middle of the fluid
    nf = int(state.num_active)
    inside = dataclasses.replace(held["body"],
                                 com=state.pos[:nf].mean(dim=0))
    ops = {k: (kern, args, kw) for k, (kern, _, args, kw)
           in own.coupled_operands(cfg, ctx, params, grid, inside).items()}
elif solver in ("wcsph", "wcsph_wide12M"):
    dargs, _ = own.sweep_inputs(ctx, params)
    _, fargs = own.sweep_inputs(ctx, params,
                                SP.density_sweep(cfg, *dargs))
    ops = {"density": (SP.density_sweep, dargs, {}),
           "force": (SP.fluid_force_sweep, fargs, {})}
elif solver == "xsph":
    ops = {k: (kern, args, kw) for k, (kern, _, args, kw)
           in own.xsph_path_operands(cfg, ctx, params).items()}
elif solver.startswith("pbf"):
    ops = {{"pbf_lambda_n": "pbf_grad"}.get(k, k): (kern, args, kw)
           for k, (kern, _, args, kw) in own.pbf_path_operands(
               cfg, ctx, params, vorticity=solver == "pbf_vort_xsph").items()}
else:
    operands_of = {"wcsph_visc": own.wcsph_visc_operands,
                   "iisph": own.iisph_operands,
                   "pcisph": own.pcisph_operands,
                   "dfsph": own.dfsph_operands,
                   "dfsph_visc": own.dfsph_operands,
                   "dfsph_coupled": own.dfsph_operands,
                   "dfsph_mp_coupled": own.mp_dfsph_operands,
                   "multiphase": own.multiphase_operands,
                   "multiphase_wavemaker": own.multiphase_operands,
                   "dfsph_mp": own.mp_dfsph_operands}[solver]
    keep = {"wcsph_visc": ("density", "force_v0", "visc_laplacian"),
            # dii_rhoadv and aii: the two sweeps an earlier checkout runs
            # where a later one runs dii_aii
            "iisph": ("density", "force_p0", "dii_rhoadv", "aii", "dii_aii",
                      "sum_dij", "jacobi", "pressure_force"),
            "pcisph": ("density", "force_p0", "density_pred",
                       "pressure_force"),
            # density and alpha: the two sweeps an earlier checkout runs
            # where a later one runs density_alpha
            "dfsph": ("density", "alpha", "density_alpha", "drho",
                      "pressure_force"),
            "dfsph_visc": ("density", "alpha", "density_alpha", "drho",
                           "visc_laplacian"),
            "dfsph_coupled": ("density", "alpha", "density_alpha", "drho",
                              "pressure_force"),
            # mp_density and mp_alpha: the two sweeps an earlier checkout
            # runs where a later one runs mp_density_alpha
            "dfsph_mp_coupled": ("mp_density", "mp_alpha",
                                 "mp_density_alpha", "mp_force", "mp_drho",
                                 "mp_kappa"),
            "multiphase": ("mp_density", "mp_force"),
            "multiphase_wavemaker": ("mp_density", "mp_force"),
            "dfsph_mp": ("mp_density", "mp_alpha", "mp_density_alpha",
                         "mp_force", "mp_drho", "mp_kappa")}[solver]
    ops = {k: (kern, args, kw) for k, (kern, _, args, kw)
           in operands_of(cfg, ctx, params).items() if k in keep}
    if solver == "multiphase_wavemaker":
        kern, args, kw = ops.pop("mp_force")
        ops["mp_force_moving"] = (kern, args,
                                  {**kw, "moving_boundary": True})
if solver in ("dfsph_coupled", "dfsph_elastic", "dfsph_mp_coupled"):
    _, body_ops = own.dfsph_coupled_held_ops(
        cfg, params, state, grid, boundary, held["body"], body,
        {"dfsph_coupled": "rigid", "dfsph_elastic": "elastic",
         "dfsph_mp_coupled": "mp"}[solver])
    # body_density and alpha_body / alpha_shell: the two sweeps an earlier
    # checkout runs where a later one runs body_density_alpha(_sq)
    for key in ("drho_shell", "body_force_p0", "body_density", "alpha_body",
                "alpha_shell", "body_density_alpha", "body_density_alpha_sq",
                "mp_kappa_body"):
        if key in body_ops:
            kern, _, args, kw = body_ops[key]
            ops[key] = (kern, args, kw)
kernels = {}
for key, (kern, args, kw) in ops.items():
    out = kern(cfg, *args, **kw)
    kernels[key] = [graph_ms(lambda: kern(cfg, *args, **kw)), sha(out)]
host_ms = (None if host["t0"] is None else (host["t1"] - host["t0"]) * 1e3
           / (host["calls"] - host["timed_from"]))
print(json.dumps({"ms": ms, "host_ms": host_ms, "iters": iters,
                  "state": sha(state.pos, state.vel), "kernels": kernels}))
""".replace("GRAPH_MS\n", GRAPH_MS)

# run in the checkout's root: its own chip_smoke.py, whole, each kernel it
# times also timed here; prints {"label: key": ms} as its last line
RUN_SMOKE = r"""
import importlib.util, inspect, json, sys
import torch

spec = importlib.util.spec_from_file_location("own_smoke", "chip_smoke.py")
own = importlib.util.module_from_spec(spec)
spec.loader.exec_module(own)
GRAPH_MS
times, where = {}, [None]


def labelled(orig):
    sig = inspect.signature(orig)

    def wrapped(*a, **kw):
        where[0] = sig.bind(*a, **kw).arguments["label"]
        try:
            return orig(*a, **kw)
        finally:
            where[0] = None
    return wrapped


def timed(orig):
    def wrapped(name, kern, plain, *a, **kw):
        if where[0] is not None:
            key = f"{where[0]}: {name}"
            try:
                ms = min(graph_ms(kern) for _ in range(3))
                times[key] = min(times.get(key, ms), ms)
            except RuntimeError:   # a wrapper that cannot be captured
                torch.cuda.synchronize()
        return orig(name, kern, plain, *a, **kw)
    return wrapped


own.compare = labelled(own.compare)
own.compare_kernels = labelled(own.compare_kernels)
own.time_turns = timed(own.time_turns)
sys.stdout = sys.stderr
own.main()
sys.stdout = sys.__stdout__
print(json.dumps(times))
""".replace("GRAPH_MS\n", GRAPH_MS)

SOLVERS = ("wcsph", "wcsph_wide12M", "xsph", "iisph", "wcsph_visc", "pcisph",
           "pbf", "pbf_settled", "pbf_vort_xsph", "dfsph", "dfsph_visc",
           "elastic", "wcsph_elastic", "dfsph_elastic", "multiphase",
           "multiphase_wavemaker", "dfsph_mp", "coupled", "dfsph_coupled",
           "dfsph_mp_coupled")


def run(root, solver, state_file, *drift):
    """The run's record: ms/step, the host loop's ms/step (None on the
    WCSPH paths), iterations (the total ``solver_iters``,
    for PBF ``pbf_iters`` per step; CG iterations launched for wcsph_visc,
    0 for the WCSPH, XSPH, elastic and wcsph_elastic paths), state
    hash, and per kernel [host-free ms, output hash]; its final live
    positions and velocities go to ``state_file``. ``drift``: the steps
    to save the state after and the nudge switch, as in :func:`drift`."""
    res = subprocess.run([sys.executable, "-c", RUN, SMOKE, solver,
                          state_file, *drift], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        sys.exit(f"step_turns: run in {root} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def run_smoke(root, log=None):
    """``{"label: key": host-free ms}`` of one whole smoke run of the
    checkout in ``root``; its own output goes to the file ``log``."""
    res = subprocess.run([sys.executable, "-c", RUN_SMOKE], cwd=root,
                         capture_output=True, text=True, timeout=1500)
    if log:
        with open(log, "w") as f:
            f.write(res.stderr)
    if res.returncode != 0:
        sys.exit(f"step_turns: smoke run in {root} failed:\n"
                 f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def smoke_turns(roots, pairs, log_dir=None):
    """Both checkouts' smoke runs in turns; prints each kernel's better
    time of each side and the ratio. Each run's own output goes to
    ``log_dir``/SIDE-K.log when given."""
    best = {"parent": {}, "change": {}}
    for k in range(pairs):
        order = ("parent", "change") if k % 2 == 0 else ("change", "parent")
        for side in order:
            log = log_dir and os.path.join(log_dir, f"{side}-{k + 1}.log")
            for key, ms in run_smoke(roots[side], log).items():
                best[side][key] = min(best[side].get(key, ms), ms)
            print(f"pair {k + 1} {side}: {len(best[side])} kernels timed",
                  flush=True)
    for key in sorted(best["parent"].keys() | best["change"].keys()):
        p, c = best["parent"].get(key), best["change"].get(key)
        ratio = f", ratio {c / p:.3f}" if p and c else ""
        print(f"{key}: parent {p if p is None else f'{p:.4f}'} ms, change "
              f"{c if c is None else f'{c:.4f}'} ms host-free{ratio}")


def state_difference(a, b):
    """(max|Δx|, max|Δv|) of every particle of state ``a`` against the
    nearest particle of state ``b``, searched in the 27 cells of size h
    around it (``a``, ``b``: the saved live positions and velocities)."""
    dev = torch.device("cuda")
    pa, va = a["pos"].to(dev), a["vel"].to(dev)
    pb, vb = b["pos"].to(dev), b["vel"].to(dev)
    h = a["h"]
    lo = torch.minimum(pa.min(0).values, pb.min(0).values) - h
    ca = ((pa - lo) / h).long() + 1
    cb = ((pb - lo) / h).long() + 1
    dims = torch.maximum(ca.max(0).values, cb.max(0).values) + 2

    def key(c):
        return (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    kb, order = torch.sort(key(cb))
    pb, vb = pb[order], vb[order]
    best = torch.full((len(pa),), float("inf"), device=dev)
    match = torch.zeros(len(pa), dtype=torch.long, device=dev)
    for off in itertools.product((-1, 0, 1), repeat=3):
        k = key(ca + torch.tensor(off, device=dev))
        s = torch.searchsorted(kb, k)
        cnt = torch.searchsorted(kb, k, right=True) - s
        qi = torch.repeat_interleave(torch.arange(len(pa), device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = s[qi] + torch.arange(len(qi), device=dev) - first[qi]
        d = ((pa[qi] - pb[j]) ** 2).sum(dim=1)
        m = torch.full_like(best, float("inf")).scatter_reduce(
            0, qi, d, "amin")
        better = m < best
        hit = better[qi] & (d == m[qi])
        match[qi[hit]] = j[hit]
        best = torch.where(better, m, best)
    dx = float(best.max().sqrt())
    dv = float((va - vb[match]).abs().max())
    return dx, dv


def drift(roots, solver, marks):
    """One run of each checkout and one of the change with every live
    position one float32 ulp up before the first step (``nudged``); prints,
    after each step of ``marks`` ("1,10,..."), how far the change's state
    lies from the parent's and from the nudged run's, as
    :func:`state_difference` measures it: how a difference of one rounding
    grows along the path, beside the one between the two checkouts."""
    sides = {"parent": ("parent", "0"), "change": ("change", "0"),
             "nudged": ("change", "1")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (side, nudged) in sides.items():
            rec = run(roots[side], solver, os.path.join(tmp, name), marks,
                      nudged)
            print(f"{name}: {solver}, state {rec['state']}", flush=True)
        for k in marks.split(","):
            got = {name: torch.load(os.path.join(tmp, f"{name}.{k}"))
                   for name in sides}
            pdx, pdv = state_difference(got["parent"], got["change"])
            ndx, ndv = state_difference(got["nudged"], got["change"])
            print(f"{solver} after step {k}: change against parent max|dx| "
                  f"{pdx:.6g} m, max|dv| {pdv:.6g} m/s; against the nudged "
                  f"change max|dx| {ndx:.6g} m, max|dv| {ndv:.6g} m/s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--solver", choices=SOLVERS, default="wcsph")
    ap.add_argument("--smoke", action="store_true",
                    help="time every kernel of each side's own smoke run")
    ap.add_argument("--log", help="with --smoke: a directory for the smoke "
                    "runs' own output")
    ap.add_argument("--drift", metavar="STEPS",
                    help="instead of timing, the states' distances after "
                    "each of these steps (\"1,10,300\"), and those from a "
                    "run of the change nudged by one ulp")
    args = ap.parse_args()
    roots = {"parent": os.path.abspath(args.parent),
             "change": os.path.abspath(args.change)}
    if args.drift:
        drift(roots, args.solver, args.drift)
        return
    if args.smoke:
        if args.log:
            os.makedirs(args.log, exist_ok=True)
        smoke_turns(roots, args.pairs, args.log)
        return
    recs = {"parent": [], "change": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k in range(args.pairs):
            order = (("parent", "change") if k % 2 == 0
                     else ("change", "parent"))
            for side in order:
                rec = run(roots[side], args.solver,
                          os.path.join(tmp, f"{side}{k}.pt"))
                recs[side].append(rec)
                kern = ", ".join(f"{key} {ms:.4f} ms ({h})" for key, (ms, h)
                                 in rec["kernels"].items())
                hm = rec["host_ms"]
                hm = "" if hm is None else f" (host loop {hm:.4f})"
                print(f"pair {k + 1} {side}: {args.solver} {rec['ms']:.4f} "
                      f"ms/step{hm}, iterations {rec['iters']}, state "
                      f"{rec['state']}; kernels host-free: {kern}",
                      flush=True)
        dx, dv = state_difference(
            torch.load(os.path.join(tmp, "parent0.pt")),
            torch.load(os.path.join(tmp, "change0.pt")))

    def quartiles(x):
        return statistics.quantiles(x, n=4)[::2] if len(x) > 1 else x * 2

    for side, rs in recs.items():
        t = [r["ms"] for r in rs]
        q1, q3 = quartiles(t)
        kern = []
        for key in rs[0]["kernels"]:
            km = [r["kernels"][key][0] for r in rs]
            kq1, kq3 = quartiles(km)
            kern.append(f"{key} median {statistics.median(km):.4f} ms "
                        f"({kq1:.4f}-{kq3:.4f}), hashes "
                        f"{sorted({r['kernels'][key][1] for r in rs})}")
        hm = [r["host_ms"] for r in rs if r["host_ms"] is not None]
        if hm:
            h1, h3 = quartiles(hm)
            hm = (f", host loop median {statistics.median(hm):.4f} ms/step, "
                  f"quartiles {h1:.4f}-{h3:.4f}")
        print(f"{side}: {args.solver} median {statistics.median(t):.4f} "
              f"ms/step, quartiles {q1:.4f}-{q3:.4f}{hm or ''}, runs "
              f"{len(t)}, state hashes {sorted({r['state'] for r in rs})}; "
              + "; ".join(kern))
    same = ({r["state"] for r in recs["parent"]}
            == {r["state"] for r in recs["change"]})
    print(f"{args.solver}: final states of pair 1, change against parent: "
          f"max|dx| {dx:.6g} m, max|dv| {dv:.6g} m/s (each parent particle "
          f"against the nearest change particle); state hashes "
          + ("equal" if same else "differ"))


if __name__ == "__main__":
    main()
