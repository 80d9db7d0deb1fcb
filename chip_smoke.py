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
   operands of one real IISPH step: the four IISPH sweeps for both kernel
   sets, and the pressure-off force sweep and the d_ii, ρ_adv and a_ii
   sweep for all six kernel-set × surface-tension combinations (max|Δ| ≤
   1e-4·max|ref| per output column, and finite);
6. the IISPH main path: ``resting_block(n_target=2**20)`` (1,092,727
   fluid particles on the floor of a tight box, impact velocity −1 m/s,
   mass calibrated to the 0.8·h lattice), 60 ``iisph_step`` calls with
   tol = 1 kg/m³ and omega = 0.5, steps 11-60 timed with CUDA events;
   gates on the iteration counts, the convergence bound, finite
   positions, the floor, pressure ≥ 0 and the kernels' launches; then
   each kernel of the path against its plain version at these shapes,
   timed in turns;
7. every kernel of the PCISPH and the DFSPH step (density, pressure-off
   force, pressure force with p⁰/ρ² resp. κ/ρ, predicted density, α,
   Dρ/Dt) against its plain version on the phase-3 dam-break (mass
   calibrated to the lattice, PCISPH resp. DFSPH parameters), fed the
   operands of one real step of each solver, built by the solvers' own
   operand functions, for both kernel sets (max|Δ| ≤ 1e-4·max|ref| per
   output column, and finite);
8. the PCISPH main path: ``bench.py``'s ``pcisph_256k_settled`` cell,
   ``resting_block(n_target=256_000)`` (262,144 fluid particles, impact
   velocity −1 m/s, mass calibrated to the 0.8·h lattice), 60
   ``pcisph_step`` calls at tol_frac = 0.001, steps 11-60 timed with CUDA
   events; gates on convergence (each solver loop within its own
   tolerance or at its own cap), finite positions, the floor, pressure
   ≥ 0 and every kernel's launches; then every kernel of the path against
   its plain version at these shapes, timed in turns;
9. the DFSPH main path: ``bench.py``'s ``dfsph_256k_settled`` cell, the
   same block with DFSPH parameters, 60 ``dfsph_step`` calls at tol =
   tol_v = 1 kg/m³, with the same gates for both of its loops; then every
   kernel of the path against its plain version at these shapes, timed
   in turns.

10. the multiphase density and force kernels against their plain versions
    on the phase-3 dam-break split in two phases as ``bench.py`` splits
    ``multiphase_1M`` (the top half by y at 0.3·ρ₀, mass ρ0_i/ρ₀·m), fed
    the operands of its first multiphase step built by the step's own
    operand functions, both kernel sets × {NONE, BECKER with st_cross =
    0.25}; and the XSPH kernel (``group_pair_sweep_kernel<Xsph>``) on the
    first XSPH step's one (C, 8) operand matrix of the single-phase
    dam-break, both kernel sets (max|Δ| ≤ 1e-4·max|ref| per output column,
    and finite);
11. the multiphase main path, ``bench.py``'s ``multiphase_1M``: phase 4's
    dam-break with its boundary shell, split in two phases, 300
    ``wcsph_step`` calls at dt = 1e-3, steps 51-300 timed with CUDA
    events; gates: each multiphase kernel launched once per step and no
    other kernel, finite positions, nothing below the floor, mean
    compression (against each particle's own ρ₀) < 0.1, the light phase's
    mean height above the heavy phase's; then both kernels against their
    plain versions at these shapes, timed in turns;
12. the XSPH path ``wcsph_1M_xsph``: phase 4's dam-break, 300 steps with
    ``xsph_eps = 0.3``, phase 4's gates plus one XSPH launch
    (``group_pair_sweep_kernel<Xsph>``) per step; then the density, force
    and XSPH kernels against their plain versions at these shapes, timed
    in turns;
13. the force kernel's two instances without viscosity and wall friction
    (pressure on and off) and the viscous-Laplacian kernel against their
    plain versions on the phase-3 dam-break (DFSPH parameters at ν = 5,
    mass calibrated to the lattice), fed its first step's operands; and
    the three multiphase DFSPH kernels (the density and α̂ sums in one
    walk, dδ̂/dt, κV̂² correction)
    on the first step's operands of its two-phase split (phase 10's),
    κ from the first divergence iteration; both kernel sets
    (max|Δ| ≤ 1e-4·max|ref| per output column, and finite);
14. the WCSPH path with the implicit viscosity solve, ``wcsph_1M_visc``:
    phase 4's dam-break at ν = 5 (the CLI's ``--implicit-viscosity 5``),
    300 steps, phase 4's gates, the force kernel without viscosity once per
    step and the Laplacian once per launched CG iteration plus once per
    step (for r0), each CG solve within ``visc_cg_tol`` or at its cap;
    then its kernels against their plain versions at these shapes, timed;
15. the DFSPH path with the implicit viscosity solve, ``bench.py``'s
    ``dfsph_visc_256k_settled`` (built as ``bench.py:376-404``: the
    settled block with ``dfsph_params(viscosity=5.0)``), 60 steps, phase
    9's gates plus the CG gates of phase 14 and no launch of the force
    instances with viscosity; then its kernels against their plain
    versions, timed;
16. the multiphase DFSPH path ``dfsph_mp_256k_settled``: phase 9's block
    split by phase 10's ``two_phase`` (the CLI's ``--solver dfsph
    --second-phase 0.3:0.5`` on that block), 60 steps, phase 9's gates on
    the multiphase kernels (none of the single-phase DFSPH kernels) and
    the light phase's mean height above the heavy phase's; then its
    kernels against their plain versions, timed;
17. the four PBF kernels ((ρ, λ), Δp, ω and vorticity confinement's N,
    the λ sums over the fluid rows) against their plain versions on a
    ~32k-particle settled block (PBF parameters, mass calibrated to the
    0.8·h lattice, impact velocity −1 m/s, so λ ≠ 0 from the first
    iteration; seeded at 0.7·h under Monaghan kernels), fed the first
    step's operands built by the step's own operand functions
    (``solvers/pbf_cuda.py``): the first iteration's λ and Δp, then ω and
    N at the velocities after the iterations, both kernel sets (max|Δ| ≤
    1e-4·max|ref| per output column, and finite; λ as
    :func:`check_lambda`);
18. the PBF path ``pbf_1M`` (``bench.py:355``, built as ``bench.py:392-
    393, 112``): ``dam_break(calibrate_mass(pbf_params()), n_target=
    2**20)`` with its boundary shell, 300 ``pbf_step`` calls at dt = 1e-3,
    steps 51-300 timed with CUDA events; gates: the λ and Δp kernels
    launched ``pbf_iters`` times per step and no other kernel, zero
    overflow, finite positions, nothing below the floor, mean compression
    < 0.1 on every step; then both kernels against their plain versions at
    these shapes, timed in turns;
19. the PBF path ``pbf_256k_settled`` (``bench.py:356``): the settled
    262,144-particle block with PBF parameters calibrated twice
    (``bench.py:392-393, 399-403``), 60 steps, steps 11-60 timed, phase
    18's gates; then both kernels against their plain versions, timed;
20. the PBF path ``pbf_1M_vort_xsph``: phase 18's dam-break with
    ``xsph_eps = 0.02`` and ``vorticity_eps = 0.01`` (the CLI's ``--solver
    pbf --xsph 0.02 --vorticity 0.01``), 300 steps, phase 18's gates with
    N, ω and XSPH launched once per step (ω and XSPH the lane-group
    ``group_pair_sweep_kernel<PbfOmega>`` and ``<Xsph>``, each on its one
    (C, 8) matrix); then the λ, Δp, N, ω and XSPH kernels against their
    plain versions at these shapes, timed.

21. the moving-wall kernels against their plain versions on the phase-3
    dam-break with its walls moving at (0.8, 0, −0.4) m/s
    (``tests/test_moving_boundary.py:96``; multiphase: its two-phase
    split), both kernel sets: the force kernel's MOVING instances
    (pressure on and off) and MultiphaseForce<MOVING>, each also on its
    wall friction alone (fluid ranges empty, the penalty and pressure
    terms zeroed: the friction is ~1e-10 of the wall force, so only this
    shows the wall velocity is read, and the static instance must differ
    there), and the unchanged kernels that read the wall rows' velocity
    slots (DiiAii, under all three surface-tension models, Drho,
    MultiphaseDrho, ViscLaplacian);
22. the wavemaker path ``wcsph_1M_wavemaker``: phase 4's dam-break under
    the CLI's ``--wavemaker x:0.05:2`` (``nereus_tpu/app/cli.py:285-297,
    776-788``: the grid widened by A + cell along x, the walls re-sorted
    against it, then moved every step to offset A·sin ωt with velocity
    A·ω·cos ωt), 300 steps, steps 51-300 timed; gates: the density and
    the MOVING force kernel once per step and no other kernel (the static
    force never), zero overflow, finite positions, no active particle
    outside the moved box by more than h, mean compression < 0.1 on every
    step; then both kernels against their plain versions, timed, and the
    MOVING force kernel on its wall friction alone at these shapes, as in
    phase 21;
23. ``multiphase_1M_wavemaker``: phase 11's two-phase dam-break under the
    same wavemaker, phase 22's gates on MultiphaseDensity and
    MultiphaseForce<MOVING>;
24. ``dfsph_256k_wavemaker``: phase 9's block under the same wavemaker,
    phase 9's gates with the pressure-off MOVING force kernel in place of
    the static one;
25. ``mp_coupled_256k`` (``bench.py:200-237``): the settled block of
    ``make_params()`` calibrated to the 0.8·h lattice, split at its median
    height with the top half at 0.4·ρ₀, and a 0.15 m box of 600 kg/m³
    dropped from 0.1 above the water; BodyDensity and MultiphaseBody held
    against their plain versions on the first step's operands, and
    MultiphaseBody on its friction alone (bp at 0) with the box moving at
    (0.3, −0.5, 0.2) m/s and spinning at (1, −2, 0.5) rad/s, which must
    differ from its result with the shell's sample velocities at 0; then 60
    ``wcsph_coupled_step`` calls, steps 11-60 timed; gates: one
    multiphase density, multiphase force, body density and
    MultiphaseBody launch per step and no other kernel, zero overflow,
    finite fluid and body state, R orthonormal within 1e-5 on every step,
    the body's centre above the floor, mean compression < 0.1 on every
    step; then every kernel of the path against its plain version, timed
    (the body kernels on the first step's operands: the body has left the
    water by the last), and the dense body-wall contact timed apart;
26. ``coupled_256k``: the same block and box, single phase (the CLI's
    ``--rigid-box`` on that block), phase 25's gates on the density,
    force, body density and BodyForce kernels (BodyForce on its friction
    alone with pd2 at 0);
27. the elastic kernels against their plain versions, both kernel sets:
    ElasticF and ElasticForceHourglass (both over the block's static pair
    list) on a 12×10×8 block at spacing h/2
    stretched 2 % along x, sheared, rotated and perturbed by a seeded
    noise of 0.05·spacing (the hourglass term is exactly 0 on affine
    motion); FluidReaction on a 6³ cube moving at (0.3, −0.5, 0.2) m/s and
    spinning at (1, −2, 0.5) rad/s inside phase 3's dam-break, as it is
    and on its friction alone (the fluid density clamped to ρ₀, so the
    Tait pressure is 0), which must differ from its result with the
    samples' velocities at 0; some samples must have fluid in their
    ranges; max|Δ| ≤ 1e-4·max|ref| per output column, none all zero;
28. ``elastic_512k`` (``bench.py:136-163``): ``make_params(dt=1e-4)``, an
    80³ block (512,000 samples) at spacing h/2 over its penalty floor at
    y = 0, E = 2e5, ν = 0.3, damping 5; 60 ``elastic_step`` calls, steps
    11-60 timed; gates: one ElasticF and one ElasticForceHourglass launch
    per step and no other kernel, finite positions and velocities,
    ``seg_overflow`` 0, ``max_stretch`` < 0.1 and min y ≥ −0.01·spacing on
    every step; then both kernels against their plain versions at the
    path's shapes, timed, and ElasticF also under each of the six
    (kernel set, surface-tension model) pairs of ``MODELS``. The block
    starts 0.5·spacing above its floor and falls freely for ~480 steps, so
    over these 60 its F is I to rounding: the kernels are held on its
    statics and pair list at the deformed positions of phase 27;
29. ``elastic_plastic_512k``: phase 28 with ``plastic=True`` and
    ``yield_strain=0.02``; E_p also finite and traceless within
    1e-5·max|E_p|;
30. ``wcsph_elastic_256k`` (``bench.py:165-198``): the 256k dam-break with
    its walls and a 16³ cube of 400 kg/m³ at E = 1e5 standing 2·spacing
    over the floor 0.3 m downstream of the fluid, 4 substeps, 60
    ``wcsph_elastic_step`` calls, steps 11-60 timed; gates per step: one
    density, force, body density, BodyForce and FluidReaction launch, 4
    ElasticF and 4 ElasticForceHourglass launches, no other kernel, finite
    fluid and body, mean compression < 0.1, zero overflow; prints how many
    samples feel the fluid at the last step (the water may not reach the
    cube in 60 steps); then every kernel of the path against its plain
    version, timed: the elastic ones on the body's deformed positions
    (ElasticF also under each model of ``MODELS``), the others on the last
    state with the body moved into the middle of the fluid, FluidReaction
    also on its friction alone.

31. the DFSPH couplings' instances against their plain versions, both
    kernel sets, on phase 7's DFSPH dam-break with a 0.08 box moving at
    (0.3, −0.5, 0.2) m/s and spinning at (1, −2, 0.5) rad/s in the middle
    of its fluid (single phase, then its two-phase split) and a 6³ elastic
    cube moving and spinning alike, each step's first divergence
    iteration built by the steps' own classes
    (``solvers/dfsph_coupled_cuda.py``, ``solvers/dfsph_elastic.py``): the
    body forms of PressureForce (forward, and reverse with the cube's
    samples as queries), Alpha and the three multiphase DFSPH functors,
    Alpha and Drho over a shell, and BodyForce, MultiphaseBody and
    FluidReaction on their friction alone (pressure off, bp at 0); max|Δ|
    ≤ 1e-4·max|ref| per output column, none all zero but the columns a
    body form leaves at exactly 0 (``ZERO_COLS``, checked 0), candidates
    inside the cutoff > 0, and each friction unlike its result with the
    sample velocities at 0;
32. ``dfsph_coupled_256k`` (``bench.py:239-268``): the settled block of
    ``dfsph_params(dt=5e-4)`` calibrated to the 0.8·h lattice (262,144
    fluid particles) and a 0.15 m box of 400 kg/m³ dropped from 0.1 above
    the water, 60 ``dfsph_coupled_step`` calls, steps 11-60 timed; gates:
    the density, α, body density, body-form α, pressure-off force and
    body friction once per step, Dρ/Dt and Drho over the shell once per
    launched iteration, PressureForce and its body form once per launched
    iteration plus the warm start's, no other kernel; zero overflow;
    finite fluid and body; R orthonormal within 1e-5; each loop of each
    step within its tolerance or at its cap. The box does not reach the
    water in 60 steps, so every kernel of the path is then held against
    its plain version, timed, on the last state with the box moved into
    the middle of the fluid, and Drho over its 56-sample shell (G 2)
    also under each model of ``MODELS``;
33. ``dfsph_mp_coupled_256k``: phase 32's block split as phase 25 splits
    it (the top half by y at 0.4·ρ₀), phase 32's gates on the multiphase
    DFSPH kernels, their body forms and MultiphaseBody (bp = 0);
34. ``dfsph_elastic_256k``: phase 32's block and phase 30's 16³ cube
    (4,096 samples of 400 kg/m³, E = 1e5, ν = 0.3, damping 5, 4
    substeps) centred in x and z, its bottom 0.5 fluid spacings above the
    water, 60 ``dfsph_elastic_step`` calls; phase 32's gates with Alpha
    over the shell in place of the body-form α, the body form of
    PressureForce twice per correction (forward and reverse),
    FluidReaction without pressure once per step, ElasticF and
    ElasticForceHourglass 4 times per step; then every kernel of the path
    against its plain version, timed, the fluid and contact kernels on the
    last state with the cube moved into the middle of the fluid, the body
    form of PressureForce both forward and reverse (two entries of the
    ``kernels`` line, told apart by ``op``); Drho over the cube's
    4,096-sample shell (G 8) and ElasticF also under each model
    of ``MODELS``.

35. ``wcsph_wide12M`` (``bench.py:307-313, 405-411``): the 12,000,000
    target dam-break without a boundary on the grid stretched along z past
    2^24 cells (gx, gy, origin kept), 5 warm-up and 20 timed
    ``wcsph_step`` calls, ms/step, particle-steps/s and peak memory;
    gates: density and force launched every step, finite, the cell check
    (``probes/cells.py``) 0 mismatches on the first and the last state,
    10 steps compact against stretched bit-identical and compact against
    ``pad_below`` (every hash past 2^24) within 1e-5 m; then the density,
    force and cell-check kernels against their plain versions, timed;
36. ``wcsph_1M_lifecycle``: phase 4's dam-break at capacity factor 2 (the
    CLI's ``--emit`` capacity) on a grid 0.7 m wider than its walls, 200
    steps with the CLI's 3×3 emitter patch every 10 steps
    (``add_particles_traced``), its drop cube every 100 (``add_particles``),
    a drain plane 0.03 m under the fluid (``remove_particles``, every
    step) and ``refit_grid`` + ``rehash_boundary`` every 50; gates: finite,
    emit overflow 0, the live count equal to start + emitted + dropped −
    drained (counted apart), drained > 0, every live particle inside each
    refit grid with the cell check 0, one step on the old grid against the
    path's step on the first refit grid (positions 1e-6 m, velocities 1e-5
    m/s); ms/step and ms per refit + rehash, remove and traced add; then
    the density, force and cell-check kernels against their plain versions;
37. the wall-only force (``WallForce``, both pressure instances, driven
    through ``sph_pairs.boundary_force_sweep``) on phase 4's first-step
    operands with the fluid lowered to 0.04 m over its floor (1,092,727
    queries, 99,606 wall samples), against its plain version and fused −
    fluid-only within FORCE_TOL, timed;
38. the layout probe (``probes/layout.py``): both layouts against the plain
    version query by query (``layout.mismatched_queries``: every force
    element within 1e-3·|ref| + 1e-4, exactly 0 where the plain one is,
    finite) at m = 2^14 and 2^20 (ws = 192), the check shown to flag two
    planted faults (pass-1 windows skipped; one median query 1 % off);
    both timed at 2^20.

Phases 21-23 run right after phase 12, on its scene; 24-34 after 20;
35-38 after 34.
Phases 8 and 9 print the mean ``solver_iters`` of steps 1-10 beside the
JAX package's v5e record (``BASELINE.md``: 41.8 PCISPH, 10.2 DFSPH) as a
physics cross-check, not a gate. Each launch gate counts one main-path
run: the counters are set to 0 just before it and read just after.

Each kernel's bound (``bound_ms``) is the larger of the bytes the
neighbor sweep must move (the queries, each source row once with a 4-byte
cell key, the parameters, the output) over 3.35 TB/s and its operations
(candidate pairs of this run's ranges × the pair formula's operations)
over 67 TFLOP/s, the H100 SXM's published float32 peaks. The reaction,
density, force, SumDij, Jacobi, PBF (ω included), XSPH, Dρ/Dt (over the
fluid and walls and over a shell), multiphase force, dδ̂/dt, κ impulse,
multiphase density and α̂ and body contact kernels stop after the geometry
on a candidate outside the cutoff: there only those operations count
(``GUARDED``), and the candidates inside the cutoff are counted from this
run's positions. The body contact reads a shell row's second float4 only
inside the cutoff: a shell row counts 16 B, or 32 where some query has it
inside the cutoff in this run (``SPLIT_ROWS``). The two elastic kernels
(ElasticF and the force + hourglass) walk the body's static pair list,
every pair inside the cutoff (``LISTED``): their operations are the
list's pairs × the pair's, the work inside the cutoff whatever walks it.
The elastic, SumDij, N, ω and XSPH sweeps read one matrix as queries and
source, the density, force, PBF, Dρ/Dt, multiphase force, dδ̂/dt and
multiphase density and α̂ sweeps one whose first rows are the queries: its
bytes count once.
SumDij, Jacobi, PBF's, XSPH, Dρ/Dt, the multiphase force, dδ̂/dt, the
κV̂² correction, the κ impulse, the two elastic kernels and the
one-thread walks count only the columns their pairs read
(``READ_BYTES``) and no cell key.
``bound_ranges_ms`` is the same bound of this port's interface, which
also reads the (9 or 18, N) int32 range rows the port builds per step
(the pair list of a ``LISTED`` kernel).
Kernel times (``ms``) are host-free: ``graph_ms`` captures 20 launches in
a CUDA graph and times its replay, the better of three rounds; each row
also prints the kernel's eager time and an empty kernel's (the floor set
by the host). The plain versions are timed eagerly by CUDA events.
The row-tiled kernels (ViscLaplacian, PressureForce) run over the path's
tile plan, as the step launches them; where they are timed they also
print the plan (tiles, CTAs, non-empty spans) and their time at each tile
size of ``TILE_SIZES``, timed alike, every plan bit-identical to the
default (their ``kernels`` entries carry these under ``tiled``). The
lane-group kernels (density, force, SumDij, Jacobi, PBF's, Dρ/Dt over the
fluid and walls and over a shell, the multiphase force and dδ̂/dt, the
multiphase density and α̂, the κ impulse, the body contact force, the two
elastic kernels over their list) print the lane-group
size G they take and the queries with candidates (their entries carry
these under ``grouped``); the build prints the density and force
kernels' registers and spills by G, and each instance of
``group_pair_sweep_kernel``'s and ``group_list_sweep_kernel``'s.

The run's total wall time is printed before the card's name and power
limit. The last two lines are a JSON object with one entry per kernel and
main path that launched it (the path's launches, the kernel's error, times and
bound at the path's shapes), and ``{"ok": true, "device": {...}}``. The
run fails if a path launched a kernel it did not hold against its plain
version. Without a CUDA device the script fails before it prints either.
"""

import dataclasses
import functools
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
IMPLICIT_STEPS = 60
IMPLICIT_TIMED_FROM = 10    # steps 11..60 are timed
IISPH_TOL = 1.0          # kg/m^3
IISPH_OMEGA = 0.5
WCSPH_FLUID = 1_092_727  # dam_break(n_target=2**20)
IISPH_FLUID = 1_092_727
SETTLED_N = 256_000      # bench.py's *_256k_settled cells
SETTLED_FLUID = 262_144
PCISPH_TOL_FRAC = 0.001  # bench.py's settled PCISPH tolerance
DFSPH_TOL = 1.0          # kg/m^3, tol and tol_v
V5E_ITERS_1_10 = {"pcisph": 41.8, "dfsph": 10.2}   # BASELINE.md:98, :101
MP_RATIO = 0.3           # bench.py's multiphase_1M: the top half at 0.3*rho0
MP_ST_CROSS = 0.25       # the cross-phase cohesion of phase 10
XSPH_EPS = 0.3           # tests/test_xsph.py's epsilon
VISC_NU = 5.0            # bench.py's dfsph_visc_256k_settled viscosity
PBF_FLUID = 1_092_727    # dam_break(calibrate_mass(pbf_params()), 2**20)
PBF_XSPH_EPS = 0.02      # tests/test_pbf.py:40, inside the CLI's PBF range
PBF_VORTICITY_EPS = 0.01
WALL_VEL = (0.8, 0.0, -0.4)      # tests/test_moving_boundary.py:96
WAVEMAKER = (0, 0.05, 2.0)       # the CLI's --wavemaker x:0.05:2: axis, m, Hz
COUPLED_N = 256_000              # bench.py:200-237, mp_coupled_256k
COUPLED_RATIO = 0.4              # bench.py:214-219: the top half at 0.4·ρ₀
BODY_SIZE = 0.15                 # bench.py:227-230: a 0.15 m box of
BODY_DENSITY = 600.0             # 600 kg/m³ dropped from water_top + 0.1
BODY_DROP = 0.1
BODY_VEL = (0.3, -0.5, 0.2)      # m/s and rad/s of the body whose contact
BODY_OMEGA = (1.0, -2.0, 0.5)    # friction alone is held (not a path's)
ELASTIC_DT = 1e-4                # bench.py:136-163, elastic_512k: an 80³
ELASTIC_SIDE = 80                # block at spacing h/2, E = 2e5, ν = 0.3,
ELASTIC_N = 512_000              # damping 5, its floor at y = 0
ELASTIC_E = 2e5
ELASTIC_DAMPING = 5.0
ELASTIC_YIELD = 0.02             # elastic_plastic_512k's yield strain
WEL_N = 256_000                  # bench.py:165-198, wcsph_elastic_256k:
WEL_E = 1e5                      # the 256k dam-break and a 16³ cube of
WEL_SIDE = 15                    # 400 kg/m³ at E = 1e5, 0.3 m downstream,
WEL_DENSITY = 400.0              # 4 elastic substeps per step
WEL_GAP = 0.3
WEL_SUBSTEPS = 4
DFSPH_BODY_DENSITY = 400.0       # bench.py:239-268, dfsph_coupled_256k
DFSPH_COUPLED_DT = 5e-4
ELASTIC_NOISE = 0.05             # ·spacing: the kernel checks' non-affine
                                 # perturbation
WIDE_N = 12_000_000              # bench.py:307-313, wcsph_wide12M
WIDE_WARMUP = 5
WIDE_TIMED = 20
WIDE_AB_STEPS = 10               # steps of each wide-grid A/B
PAD_TOL = 1e-5                   # m, compact against pad_below
LIFE_STEPS = 200                 # wcsph_1M_lifecycle
LIFE_CAPACITY = 2.0              # the CLI's --emit capacity (cli.py:273-277)
EMIT_AT = (0.25, 2.6, 0.25)      # the CLI's --emit 3x3 patch (cli.py:955-
EMIT_VEL = (0.0, -1.0, 0.0)      # 971), 0.5 m over the 1M fluid, falling
EMIT_EVERY = 10
DROP_CENTER = (-1.0, 2.5, 0.5)   # the CLI's drop cube (cli.py:940-947), its
DROP_SIZE = 0.12                 # 0.12 m edge, over the 1M fluid
DROP_EVERY = 100
DRAIN_DEPTH = 0.03               # m: the drain plane under the fluid's
                                 # bottom, which the falling front crosses
REFIT_EVERY = 50                 # the CLI's --refit-every (cli.py:1036-1046)
REFIT_PAD = 0.7                  # m: the lifecycle cell starts on a grid this
                                 # much wider than its walls on every face
                                 # (tests/test_grid.py:132's oversized frame)
LAYOUT_WS = 192                  # tools/probe_transposed.py's defaults
LAYOUT_M = 2 ** 20
LAYOUT_CHECK_M = 2 ** 14
# (kernel set, surface-tension model) of the kernel-vs-plain phases
MODELS = (("MULLER", "BECKER"), ("MULLER", "AKINCI"), ("MULLER", "NONE"),
          ("MONAGHAN", "BECKER"), ("MONAGHAN", "AKINCI"),
          ("MONAGHAN", "NONE"))
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per candidate pair (fluid rows, boundary rows) of each pair
# formula on the main paths (Muller kernels, Becker surface tension),
# counted in the CUDA source with every add, multiply, compare, min/max,
# division and rsqrt as one
PAIR_OPS = {"density": (15, 15), "force": (56, 40), "force_p0": (48, 36),
            "dii_aii": (33, 33), "sum_dij": (22, 0),
            "jacobi": (28, 21), "pressure_force": (24, 24),
            "density_pred": (15, 15), "density_alpha": (30, 27),
            "density_alpha_sums": (30, 27), "drho": (25, 25),
            "mp_density": (16, 17), "mp_force": (72, 48), "xsph": (29, 0),
            "force_v0": (39, 31), "force_p0_v0": (31, 27),
            "visc_laplacian": (33, 34), "mp_density_alpha": (27, 25),
            "mp_drho": (24, 25), "mp_kappa": (22, 22), "pbf_lambda": (28, 25),
            "pbf_dp": (30, 21), "pbf_grad": (28, 0), "pbf_omega": (33, 0),
            "force_moving": (56, 43), "force_p0_moving": (48, 39),
            "mp_force_moving": (72, 51), "body_density": (15, 0),
            "body_force": (50, 0), "mp_body": (45, 0), "elastic_f": (40, 0),
            "elastic_force_hg": (120, 0), "fluid_reaction": (58, 0),
            "body_force_p0": (44, 0), "fluid_reaction_p0": (43, 0),
            "pressure_force_body": (23, 0),
            "pressure_force_body_rev": (23, 0),
            "body_density_alpha": (27, 0), "body_density_alpha_sq": (30, 0),
            "drho_shell": (25, 0),
            "mp_alpha_body": (21, 0), "mp_drho_body": (25, 0),
            "mp_kappa_body": (22, 0), "wall_force": (53, 0),
            "wall_force_p0": (49, 0)}
# the kernels that return after the geometry and the cutoff compare on a
# candidate outside the cutoff: those candidates cost this many operations,
# the others PAIR_OPS's (the density and force kernels count the test once
# per candidate and the rest of the pair on the pairs inside the cutoff)
GUARDED = {"drho_shell": 9, "fluid_reaction": 9, "fluid_reaction_p0": 9,
           "density": 9, "density_pred": 9, "body_density": 9, "force": 9,
           "force_p0": 9, "force_v0": 9, "force_p0_v0": 9,
           "force_moving": 9, "force_p0_moving": 9, "sum_dij": 9,
           "jacobi": 9, "pbf_lambda": 9, "pbf_dp": 9, "pbf_grad": 9,
           "drho": 9, "mp_force": 9, "mp_force_moving": 9, "mp_drho": 9,
           "pressure_force_body": 9, "pressure_force_body_rev": 9,
           "dii_aii": 9, "xsph": 9, "pbf_omega": 9, "density_alpha": 9,
           "density_alpha_sums": 9, "mp_density": 9,
           "mp_density_alpha": 9, "body_force": 9, "body_force_p0": 9,
           "body_density_alpha": 9, "body_density_alpha_sq": 9,
           "mp_kappa_body": 9}
# the kernels that walk a static pair list (q, src, nbr_start, nbr, pvec)
# instead of ranges: every pair of the list is inside the cutoff, so their
# operations are the list's pairs × PAIR_OPS, the same work a range walk
# of the same body does inside the cutoff (its test of the candidates
# outside is the walk's own cost, not the function's); ElasticF's pair
# (40) is the range walk's (41) without its cutoff compare
LISTED = ("elastic_force_hg", "elastic_f")
# bytes each pair reads of a query row, a fluid source row and a wall
# source row, for the kernels whose rows carry columns their pair never
# reads: SumDij's one matrix x y z p/rho^2 (queries and source), Jacobi's
# query x y z sd (m/rho^2)p (not its pad), fluid rows x y z e (not the two
# zero slots), wall rows x y z psi_b (not v_b, not the pad); PBF's one
# matrix, its fluid rows the queries: lambda reads x y z of a fluid row (m
# is a parameter) and x y z psi_b of a wall row, Delta p x y z lambda and
# x y z psi_b; N's x y z psi; D rho / Dt x y z v of a query (not its slot
# 6 or pad), x y z v psi of a fluid row and x y z v_b psi_b of a wall row,
# over a shell x y z v of a query and x y z v_b psi_b of a shell row; the
# elastic force + hourglass the whole 24-wide row X x PC F of its one
# matrix, ElasticF X x of its one matrix; the multiphase force's one
# matrix, its fluid rows the queries: a query row all but its slot 6
# (V_i), a fluid row x y z v V pV^2 rho0 (the union with the query: the
# whole 48-byte row), a wall row x y z psi_b (static) or x y z v_b psi_b
# (MOVING); d delta-hat / dt's x y z v s/m of a query, x y z v of a fluid
# row (the union: 28 bytes) and x y z v_b psi_b of a wall row; the
# kappa-V-hat^2 correction x y z kv2 qc of a query and x y z kv2_j or
# x y z psi_b of a source row; the kappa impulse over a body shell x y z
# kappa/rho of a query and x y z psi_b of a shell row, its reverse x y z
# psi_b of a sample and x y z kappa/rho of a fluid row (a body sweep's
# source rows all of one kind: no wall bytes, None); IISPH's d_ii, rho_adv
# and a_ii one matrix, its fluid rows the queries: x y z v_adv m v 1/rho^2
# of a fluid row (the union with the query: 44 bytes), x y z v_b psi_b of
# a wall row; XSPH's one matrix x y z v rho of a row (x y z vx alone for a
# candidate outside the cutoff), omega's x y z v m/rho (x y z vx alone
# outside), each the queries and the source; DFSPH's density and alpha
# x y z psi of a row of the density's one matrix, the queries its fluid
# rows; the multiphase density x y z of a fluid row (the queries its first
# rows), x y z psi_b of a wall row; a shell's psi-density with alpha's
# sums (body_density_alpha, both forms) x y z of a query, x y z psi_b of a
# shell row; the shell's kappa-V-hat^2 x y z qc of a query, x y z psi_b of
# a shell row. The one-thread walks: the multiphase alpha sums x y z of a
# query, x y z 1/m_j or x y z psi_b of a source row (over a shell the same);
# the shell's multiphase d delta-hat / dt x y z v of a query, x y z v_b
# psi_b of a shell row; the body contact x y z v rho pd2 of a query (no pd2
# without the pressure), x y z v_b psi_b of a shell row; the multiphase body
# contact x y z v bp fr of a query; the fluid reaction x y z v_b psi of a
# sample, x y z v rho of a fluid row. Their bound counts these and no cell
# key: the port's ranges are exact, so no kernel reads a key. Where the
# queries are the source's first rows they are read once.
READ_BYTES = {"sum_dij": (16, 16, 0), "jacobi": (28, 24, 16),
              "pbf_lambda": (12, 12, 16), "pbf_dp": (16, 16, 16),
              "pbf_grad": (16, 16, 0), "drho": (24, 28, 28),
              "elastic_force_hg": (96, 96, 0),
              "mp_force": (44, 48, 16), "mp_force_moving": (44, 48, 28),
              "mp_drho": (28, 28, 28), "mp_kappa": (20, 16, 16),
              "pressure_force_body": (16, 16, None),
              "pressure_force_body_rev": (16, 16, None),
              "dii_aii": (44, 44, 28), "density_alpha": (16, 16, 16),
              "density_alpha_sums": (16, 16, 16),
              "body_density_alpha": (12, 16, None),
              "body_density_alpha_sq": (12, 16, None),
              "drho_shell": (24, 28, None), "xsph": (28, 28, 0),
              "pbf_omega": (24, 28, 0), "mp_density": (12, 12, 16),
              "mp_density_alpha": (12, 16, 16),
              "mp_alpha_body": (12, 16, None),
              "mp_drho_body": (24, 28, None),
              "mp_kappa_body": (16, 16, None), "body_force": (32, 28, None),
              "body_force_p0": (28, 28, None), "mp_body": (32, 28, None),
              "fluid_reaction": (28, 28, None),
              "fluid_reaction_p0": (28, 28, None),
              "elastic_f": (24, 24, 0)}
# the guarded kernels over a body shell that read a shell row's first
# float4 (x y z vb_x) to test it and its second (vb_y vb_z psi_b) only
# inside the cutoff: a shell row counts 16 B unless some query has it
# inside the cutoff in this run, then its whole 32-byte row (the body
# contact force, both forms); their queries as READ_BYTES says
SPLIT_ROWS = {"body_force": (16, 32), "body_force_p0": (16, 32)}
# the lane-group kernels (csrc/sph_sweep.cu, and group_pair_sweep_kernel
# and group_list_sweep_kernel of csrc/group_sweep.cuh), whose rows name
# their G
GROUPED = ("density", "density_pred", "body_density", "force", "force_p0",
           "force_v0", "force_p0_v0", "force_moving", "force_p0_moving",
           "sum_dij", "jacobi", "pbf_lambda", "pbf_dp", "pbf_grad", "drho",
           "elastic_force_hg", "elastic_f", "mp_force", "mp_force_moving",
           "mp_drho", "pressure_force_body", "pressure_force_body_rev",
           "drho_shell", "dii_aii", "xsph", "pbf_omega", "density_alpha",
           "density_alpha_sums", "mp_density", "mp_density_alpha",
           "body_force", "body_force_p0", "body_density_alpha",
           "body_density_alpha_sq", "mp_kappa_body")
# the output columns a body form leaves at exactly 0 (its pair function
# writes the other columns): checked 0, and no scale for the tolerance
ZERO_COLS = {"mp_alpha_body": (0, 1, 2, 3), "mp_drho_body": (0,)}


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
    the queries, each source row once with its 4-byte cell key (for the
    kernels of ``READ_BYTES``, the columns their pairs read and no key),
    pvec and the output moved once, against the candidate pairs of these
    ranges (a ``LISTED`` kernel's args carry its pair list in the ranges'
    places, and its pairs are the list's); ``bound_ranges_ms`` also reads
    the range rows (the list)."""
    q, src, s, e, pv = args
    # the elastic sweeps read one matrix as queries and source, the density
    # and force sweeps one whose first rows are the queries: once
    shared = q.data_ptr() == src.data_ptr()
    if key in READ_BYTES:
        # the source's first rows are the queries' fluid rows, then walls;
        # a body sweep's source rows are all of one kind
        qb, fb, wb = READ_BYTES[key]
        n, m = q.shape[0], src.shape[0]
        nbytes = ((0 if shared else qb * n) + fb * m if wb is None
                  else (0 if shared else qb * n) + fb * n + wb * (m - n))
        if key in SPLIT_ROWS:
            from nereus_tpu_torch.ops.sph_pairs import PV_H2
            test, whole = SPLIT_ROWS[key]
            hit = rows_inside(q, src, s, e, float(pv[PV_H2]))
            nbytes = qb * n + test * (m - hit) + whole * hit
        nbytes += sum(t.numel() * t.element_size() for t in (pv, out))
    else:
        ins = (src, pv, out) if shared else (q, src, pv, out)
        nbytes = (sum(t.numel() * t.element_size() for t in ins)
                  + 4 * src.shape[0])
    ranges = sum(t.numel() * t.element_size() for t in (s, e))
    fluid, bnd = PAIR_OPS[key]
    if key in LISTED:
        # s, e: the pair list nbr_start (N + 1,), nbr (P,)
        ops = e.shape[0] * fluid
    else:
        cand = (e - s).clamp(min=0).sum(dim=1, dtype=torch.int64)
        ops = int(cand[:9].sum()) * fluid + int(cand[9:].sum()) * bnd
    if key in GUARDED:
        from nereus_tpu_torch.ops.sph_pairs import PV_H2
        inside = cutoff_pairs(q, src, s, e, float(pv[PV_H2]), by_row=True)
        test = GUARDED[key]
        ops = (int(cand.sum()) * test + sum(inside[:9]) * (fluid - test)
               + sum(inside[9:]) * (bnd - test))
    t_ops = ops / F32_OPS_PER_S * 1e3
    t_bytes, t_ranges = (b / HBM_BYTES_PER_S * 1e3
                         for b in (nbytes, nbytes + ranges))
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (max(t_ranges, t_ops),)


def cutoff_pairs(q, src, s, e, h2, by_row=False):
    """The candidate pairs of the ranges ``s``, ``e`` whose positions
    (columns 0-2 of ``q`` and ``src``) lie within r² < ``h2``; with
    ``by_row``, a list of the counts of each range row."""
    from nereus_tpu_torch.ops.neighbors import row_pairs
    n = []
    for r in range(s.shape[0]):
        qi, sj = row_pairs(s[r], e[r])
        d = q[qi, :3] - src[sj, :3]
        n.append(int(((d * d).sum(dim=1) < h2).sum()))
    return n if by_row else sum(n)


def rows_inside(q, src, s, e, h2):
    """The number of source rows that lie within r² < ``h2`` of some query
    of the ranges ``s``, ``e`` (positions in columns 0-2)."""
    from nereus_tpu_torch.ops.neighbors import row_pairs
    hit = torch.zeros(src.shape[0], dtype=torch.bool, device=src.device)
    for r in range(s.shape[0]):
        qi, sj = row_pairs(s[r], e[r])
        d = q[qi, :3] - src[sj, :3]
        hit[sj[(d * d).sum(dim=1) < h2]] = True
    return int(hit.sum())


def sweep_inputs(ctx, params, dens=None):
    """Density and force sweep operands of one step, as the step builds
    them (``solvers/wcsph_cuda.py``)."""
    from nereus_tpu_torch.solvers.wcsph import tait_pd2
    dargs = ctx.density_operands(params.particle_mass)
    if dens is None:
        return dargs, None
    return dargs, ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens,
                                     tait_pd2(dens, params))


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
                     *bound(name, args, kern(cfg, *args)),
                     group_stats(name, args, {}))
    return out


def profiler_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs, the sum of the
    device time ``torch.profiler`` records for them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    return us / 1e3 / reps


def graph_ms(fn, reps=20):
    """Host-free mean device time of ``fn``: ``reps`` runs captured in one
    CUDA graph, its replay timed with CUDA events (the better of two
    replays), so that the host's launch rate does not enter. Where the
    capture fails, the device time ``torch.profiler`` records
    (:func:`profiler_ms`). A kernel's wrapper counts its launches at the
    capture, once per run, and never at a replay."""
    torch.cuda.synchronize()
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as exc:
        torch.cuda.synchronize()
        print(f"  graph capture failed ({exc}); profiler device time")
        return profiler_ms(fn, reps)
    graph.replay()
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def launch_floor(dev):
    """(graph ms, eager ms) of one empty kernel: the floor under a
    host-free time, and the host's launch rate that bounds an eager one."""
    from nereus_tpu_torch.ops import cuda_sweep
    def empty():
        cuda_sweep.empty_kernel(dev)
    return graph_ms(empty), events_ms(empty, 20)


def time_turns(name, kern, plain, reps=20):
    """(kernel ms, plain ms): the kernel's host-free time
    (:func:`graph_ms`), the better of three rounds, and the plain
    version's by CUDA events, the better of two turns, in the order plain,
    kernel, kernel, kernel, plain. Prints the kernel's eager time (CUDA
    events over ``reps`` launches) and an empty kernel's (the floor set by
    the host) beside them."""
    kern()
    plain()
    p1 = events_ms(plain, 3)
    ks = [graph_ms(kern, reps) for _ in range(3)]
    p2 = events_ms(plain, 3)
    eager = events_ms(kern, reps)
    floor_g, floor_e = launch_floor(torch.device("cuda"))
    print(f"  {name} sweep at main-path shapes: kernel "
          + " / ".join(f"{k:.4f}" for k in ks)
          + f" ms host-free ({eager:.4f} eager), plain {p1:.4f} / "
          f"{p2:.4f} ms; empty kernel {floor_g:.4f} host-free, "
          f"{floor_e:.4f} eager")
    return min(ks), min(p1, p2)


def group_stats(key, args, kw):
    """The lane-group size G the kernel's wrapper takes for these operands
    (``cuda_sweep.density_group``, ``force_group``, ``body_group``,
    ``DII_AII_G``, ``SUM_DIJ_G``, ``JACOBI_G``, ``PBF_LAMBDA_G``,
    ``pbf_dp_group``, ``PBF_GRAD_G``, ``PBF_OMEGA_G``, ``XSPH_G``,
    ``DRHO_G``, ``DENSITY_ALPHA_G``, ``MP_DENSITY_ALPHA_G``,
    ``mp_force_group``, ``MP_DRHO_G``, ``elastic_group``, ``shell_group``,
    ``BODY_REV_G``) and the
    queries that have a candidate in their ranges (pairs in the list of a
    ``LISTED`` kernel)."""
    from nereus_tpu_torch.ops import cuda_sweep
    q, src, s, e, _ = args
    n = q.shape[0]
    if key in LISTED:
        g = cuda_sweep.elastic_group(n)
        busy = int((s[1:] > s[:-1]).sum())
        print(f"  {key} lane groups: G {g}; {busy} of {n} queries have "
              f"pairs in the list ({e.shape[0]} pairs)")
        return {"group": g, "queries_with_candidates": busy,
                "list_pairs": int(e.shape[0])}
    if key.startswith("force"):
        g = cuda_sweep.force_group(n, kw.get("include_viscosity", True))
    elif key == "body_density":
        g = cuda_sweep.body_group(src.shape[0])
    elif key == "dii_aii":
        g = cuda_sweep.DII_AII_G
    elif key == "sum_dij":
        g = cuda_sweep.SUM_DIJ_G
    elif key == "jacobi":
        g = cuda_sweep.JACOBI_G
    elif key == "pbf_lambda":
        g = cuda_sweep.PBF_LAMBDA_G
    elif key == "pbf_dp":
        g = cuda_sweep.pbf_dp_group(n)
    elif key == "pbf_grad":
        g = cuda_sweep.PBF_GRAD_G
    elif key == "pbf_omega":
        g = cuda_sweep.PBF_OMEGA_G
    elif key == "xsph":
        g = cuda_sweep.XSPH_G
    elif key == "drho":
        g = cuda_sweep.DRHO_G
    elif key.startswith("density_alpha"):
        g = cuda_sweep.DENSITY_ALPHA_G
    elif key == "mp_density_alpha":
        g = cuda_sweep.MP_DENSITY_ALPHA_G
    elif key.startswith("mp_force"):
        g = cuda_sweep.mp_force_group(n, kw.get("moving_boundary", False))
    elif key == "mp_drho":
        g = cuda_sweep.MP_DRHO_G
    elif key == "pressure_force_body_rev":
        g = cuda_sweep.BODY_REV_G
    elif key in ("pressure_force_body", "drho_shell", "body_force",
                 "body_force_p0", "body_density_alpha",
                 "body_density_alpha_sq", "mp_kappa_body"):
        g = cuda_sweep.shell_group(src.shape[0])
    else:
        g = cuda_sweep.density_group(n)
    busy = int(((e - s).clamp(min=0).sum(dim=0) > 0).sum())
    print(f"  {key} lane groups: G {g}; {busy} of {n} queries have "
          f"candidates")
    return {"group": g, "queries_with_candidates": busy}


def start_operands(cfg, ctx, params):
    """The density and pressure-off force sweeps' operands of an implicit
    step from ``ctx`` (on the state's velocities), built as the solvers
    build them, the force's from the plain density (without viscosity and
    wall friction, key ``force_p0_v0``, under ``viscosity_model=
    "implicit"``): ``(ops, dens, f_adv)`` with ``ops = {key: (kernel,
    plain, args, kwargs)}`` and the plain density and advection force."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    dargs = ctx.density_operands(params.particle_mass)
    dens = SP.density_sweep_plain(cfg, *dargs)
    fargs = ctx.force_operands((ctx.vx, ctx.vy, ctx.vz), dens,
                               torch.zeros_like(dens))
    implicit = cfg.viscosity_model == "implicit"
    off = dict(include_pressure=False, include_viscosity=not implicit)
    f_adv = SP.fluid_force_sweep_plain(cfg, *fargs, **off)
    return ({"density": (cuda_sweep.density_sweep, SP.density_sweep_plain,
                         dargs, {}),
             "force_p0_v0" if implicit else "force_p0": (
                 cuda_sweep.force_sweep, SP.fluid_force_sweep_plain, fargs,
                 off)}, dens, f_adv)


def tiled(kern, ctx):
    """The row-tiled kernel ``kern`` over ``ctx``'s tile plan, as the step
    launches it (the plain version takes no plan); ``ctx`` rides along for
    the plan's statistics and the tile-size variants (:func:`tile_stats`)."""
    k = functools.partial(kern, plan=ctx.tile_plan)
    k.ctx = ctx
    return k


def laplacian_op(ctx, params, dens, v):
    """The viscous-Laplacian sweep's ``(kernel, plain, args, kwargs)`` at
    the (C, 3) velocities ``v``, built by ``solvers/viscosity.py``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers.viscosity import laplacian_operands
    return (tiled(cuda_sweep.visc_laplacian_sweep, ctx),
            SP.visc_laplacian_sweep_plain,
            laplacian_operands(ctx, params, dens)(v), {})


def iisph_operands(cfg, ctx, params):
    """The operands of every sweep of one IISPH step from ``ctx`` (with
    p = ½·p_prev), built by ``solvers/iisph_cuda.py``'s own operand
    functions as the step builds them, each from the plain versions'
    upstream results: ``{key: (kernel, plain, args, kwargs)}``. The
    Σd_ij·p_j matrix is also the pressure force's query, and (a copy of)
    the Jacobi source, through ``pressure_source``, its source."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers.iisph_cuda import (dii_aii_operands,
                                                     jacobi_operands,
                                                     pressure_source,
                                                     sum_dij_operands)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    pm, dt = params.particle_mass, params.dt
    rng = (ctx.seg_start, ctx.seg_end, ctx.pvec)
    ops, dens, f_adv = start_operands(cfg, ctx, params)
    ds = dens.clamp(min=1e-12)
    inv_d2 = 1.0 / (ds * ds)
    vel_adv = tuple(v + (dt / pm) * (f_adv[:, k] + pm * params.gravity[k])
                    for k, v in enumerate(vel))
    dargs = dii_aii_operands(ctx, vel_adv, pm, inv_d2)
    dii = SP.dii_aii_sweep_plain(cfg, *dargs)[:, :3]
    dpi = pm * inv_d2
    p = 0.5 * ctx.pres_prev
    sargs = sum_dij_operands(ctx, inv_d2)(p)
    sd = SP.sum_dij_sweep_plain(cfg, *sargs)
    pq = sargs[0]
    jacobi_at, jsrc = jacobi_operands(ctx, dii, dpi)
    jargs = jacobi_at(p, sd)
    return {
        **ops,
        "dii_aii": (cuda_sweep.dii_aii_sweep, SP.dii_aii_sweep_plain,
                    dargs, {}),
        "sum_dij": (cuda_sweep.sum_dij_sweep, SP.sum_dij_sweep_plain, sargs,
                    {}),
        "jacobi": (cuda_sweep.jacobi_sweep, SP.jacobi_sweep_plain, jargs,
                   {}),
        # a copy: the Jacobi check reads its source as the loop leaves it
        "pressure_force": (tiled(cuda_sweep.pressure_force_sweep, ctx),
                           SP.pressure_force_sweep_plain,
                           (pq, pressure_source(jsrc.clone(), pq), *rng),
                           {}),
    }


def pcisph_operands(cfg, ctx, params):
    """The operands of every sweep of one PCISPH step from ``ctx``, built
    by ``solvers/pcisph_cuda.py``'s own operand functions, each from the
    plain versions' upstream results: the density, the pressure-off
    force, the pressure force of the warm start p⁰ (p⁰/ρ² in the pd2
    slot) and the predicted density at the first corrective iteration's
    x*. ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers.pcisph_cuda import (
        predicted_density_operands)
    from nereus_tpu_torch.solvers.sweep_common import pd2_operands
    pos3 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    vel3 = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    pm, dt = params.particle_mass, params.dt
    ops, dens, f_adv = start_operands(cfg, ctx, params)
    ds = dens.clamp(min=1e-12)
    p0 = cfg.pcisph_warm_frac * torch.clamp(
        torch.where(ctx.active, ctx.pres_prev, torch.zeros_like(dens)),
        min=0.0)
    pargs = pd2_operands(ctx)(p0 / (ds * ds))
    f_p = SP.pressure_force_sweep_plain(cfg, *pargs)
    x = pos3 + dt * (vel3 + (dt / pm) * (f_adv + pm * params.gravity + f_p))
    return {
        **ops,
        "pressure_force": (tiled(cuda_sweep.pressure_force_sweep, ctx),
                           SP.pressure_force_sweep_plain, pargs, {}),
        "density_pred": (cuda_sweep.predicted_density_sweep,
                         SP.density_sweep_plain,
                         predicted_density_operands(ctx, pm)(x), {}),
    }


def dfsph_operands(cfg, ctx, params, sums=False):
    """The operands of every sweep of one DFSPH step from ``ctx``, built
    by ``solvers/dfsph_cuda.py``'s own operand functions on the plain
    density: the density and α in one sweep (key ``density_alpha``; with
    ``sums``, the DFSPH couplings' form ``density_alpha_sums``), the
    pressure-off force and Dρ/Dt on the state's velocities, the κ
    correction of the warm start ½·κ_prev (κ/ρ in the pd2 slot), and under
    ``viscosity_model="implicit"`` the Laplacian of the CG's first matvec
    (at v* after the plain advection force). ``{key: (kernel, plain, args,
    kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers.dfsph_cuda import KappaSweeps
    ops, dens, f_adv = start_operands(cfg, ctx, params)
    dargs = ops.pop("density")[2]
    sweeps = KappaSweeps(ctx, params, cfg, dens)
    kap = 0.5 * torch.clamp(
        torch.where(ctx.active, ctx.pres_prev, torch.zeros_like(dens)),
        min=0.0)
    if cfg.viscosity_model == "implicit":
        pm = params.particle_mass
        v_star = (torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
                  + (params.dt / pm) * (f_adv + pm * params.gravity))
        ops["visc_laplacian"] = laplacian_op(ctx, params, dens, v_star)
    return {
        **ops,
        **({"density_alpha_sums": (cuda_sweep.density_alpha_sums_sweep,
                                   SP.density_alpha_sums_sweep_plain, dargs,
                                   {})} if sums else
           {"density_alpha": (cuda_sweep.density_alpha_sweep,
                              SP.density_alpha_sweep_plain, dargs, {})}),
        "drho": (cuda_sweep.drho_sweep, SP.drho_sweep_plain,
                 sweeps.drho_operands(
                     torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)), {}),
        "pressure_force": (tiled(cuda_sweep.pressure_force_sweep, ctx),
                           SP.pressure_force_sweep_plain,
                           sweeps.kappa_operands(kap), {}),
    }


def two_phase(state, params, ratio=MP_RATIO):
    """``state`` split as ``bench.py:416-431`` splits ``multiphase_1M``
    (the CLI's ``--second-phase 0.3:0.5``): the top half of the fluid by
    y at ``ratio``·ρ₀ (``bench.py:214-219``'s mp_coupled_256k: 0.4), mass
    ρ0_i·m/ρ₀; parked slots keep ρ₀."""
    n = int(state.num_active)
    pos = state.pos[:n].cpu().numpy()
    y_cut = np.quantile(pos[:, 1], 0.5)
    rd = float(params.rest_density)
    pm = float(params.particle_mass)
    rho0 = np.full(state.capacity, rd)
    rho0[:n] = np.where(pos[:, 1] >= y_cut, rd * ratio, rd)
    dev = state.pos.device
    return dataclasses.replace(
        state, mass=torch.tensor(rho0 * (pm / rd), dtype=torch.float32,
                                 device=dev),
        rho0=torch.tensor(rho0, dtype=torch.float32, device=dev))


def multiphase_operands(cfg, ctx, params):
    """The operands of both sweeps of one multiphase step from ``ctx``,
    built by ``solvers/wcsph_cuda.py``'s own operand functions, the
    force's from the plain density: ``{key: (kernel, plain, args,
    kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import wcsph_cuda
    dargs = wcsph_cuda.multiphase_density_operands(ctx)
    dout = SP.multiphase_density_sweep_plain(cfg, *dargs)
    fargs, _, _ = wcsph_cuda.multiphase_force_operands(ctx, params, dout)
    return {"mp_density": (cuda_sweep.multiphase_density_sweep,
                           SP.multiphase_density_sweep_plain, dargs, {}),
            "mp_force": (cuda_sweep.multiphase_force_sweep,
                         SP.multiphase_force_sweep_plain, fargs, {})}


def xsph_path_operands(cfg, ctx, params):
    """The operands of the three sweeps of one XSPH step from ``ctx``, as
    ``solvers/wcsph_cuda.py`` builds them, each from the plain versions'
    upstream results (the XSPH sweep's from the plain density and the
    velocity after the plain force): ``{key: (kernel, plain, args,
    kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import wcsph_cuda
    dargs, _ = sweep_inputs(ctx, params)
    dens = SP.density_sweep_plain(cfg, *dargs)
    _, fargs = sweep_inputs(ctx, params, dens)
    f = SP.fluid_force_sweep_plain(cfg, *fargs)
    pm, dt = params.particle_mass, params.dt
    nv = [v + (dt / pm) * (f[:, k] + pm * params.gravity[k])
          for k, v in enumerate((ctx.vx, ctx.vy, ctx.vz))]
    return {"density": (cuda_sweep.density_sweep, SP.density_sweep_plain,
                        dargs, {}),
            "force": (cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
                      fargs, {}),
            "xsph": (cuda_sweep.xsph_sweep, SP.xsph_sweep_plain,
                     wcsph_cuda.xsph_operands(ctx, nv, dens), {})}


def wcsph_visc_operands(cfg, ctx, params):
    """The operands of the three sweeps of one WCSPH step with the implicit
    viscosity solve from ``ctx``, as ``solvers/wcsph_cuda.py`` builds
    them, each from the plain versions' upstream results: the density,
    the force without viscosity and wall friction, and the Laplacian of
    the CG's first matvec (at the velocities after that force).
    ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    dargs, _ = sweep_inputs(ctx, params)
    dens = SP.density_sweep_plain(cfg, *dargs)
    _, fargs = sweep_inputs(ctx, params, dens)
    off = dict(include_viscosity=False)
    f = SP.fluid_force_sweep_plain(cfg, *fargs, **off)
    pm, dt = params.particle_mass, params.dt
    nv = (torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
          + (dt / pm) * (f + pm * params.gravity))
    return {"density": (cuda_sweep.density_sweep, SP.density_sweep_plain,
                        dargs, {}),
            "force_v0": (cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
                         fargs, off),
            "visc_laplacian": laplacian_op(ctx, params, dens, nv)}


def mp_dfsph_operands(cfg, ctx, params):
    """The operands of every sweep of one multiphase DFSPH step from
    ``ctx``, built by ``solvers/dfsph_cuda.py``'s own operand functions,
    each from the plain versions' upstream results: the density, α̂, the
    non-pressure forces (zero pressure) and dδ̂/dt on the state's
    velocities, and the κV̂² correction of the first divergence iteration
    (κᵛ = max(dδ̂/dt, 0)·α̂/dt). ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import dfsph_cuda, wcsph_cuda
    mass, rho0 = ctx.mass, ctx.rho0
    # the density and α̂'s sums: one sweep of one matrix
    aargs = dfsph_cuda.multiphase_alpha_operands(ctx)
    out = SP.multiphase_density_alpha_sweep_plain(cfg, *aargs)
    delta = out[:, 0]
    dens = mass * delta + (rho0 / params.rest_density) * out[:, 1]
    sweeps = dfsph_cuda.MultiphaseKappaSweeps(ctx, params, cfg, dens)
    al = out[:, 2:]
    g = al[:, 0:3] + sweeps.sm[:, None] * al[:, 4:7]
    alpha = mass * sweeps.delta_hat ** 2 / torch.clamp(
        (g * g).sum(dim=1) + mass * al[:, 3], min=1e-6)
    vel = (ctx.vx, ctx.vy, ctx.vz)
    vargs = sweeps.drho_operands(torch.stack(vel, dim=1))
    d = SP.multiphase_drho_sweep_plain(cfg, *vargs)
    kappa = torch.clamp(d, min=0.0) * alpha / params.dt
    fargs = wcsph_cuda.multiphase_force_args(
        ctx, vel, 1.0 / torch.clamp(delta, min=1e-12),
        1.0 / torch.clamp(dens, min=1e-12), torch.zeros_like(dens))
    return {"mp_density_alpha": (cuda_sweep.multiphase_density_alpha_sweep,
                                 SP.multiphase_density_alpha_sweep_plain,
                                 aargs, {}),
            "mp_force": (cuda_sweep.multiphase_force_sweep,
                         SP.multiphase_force_sweep_plain, fargs, {}),
            "mp_drho": (cuda_sweep.multiphase_drho_sweep,
                        SP.multiphase_drho_sweep_plain, vargs, {}),
            "mp_kappa": (cuda_sweep.multiphase_kappa_sweep,
                         SP.multiphase_kappa_sweep_plain,
                         sweeps.kappa_operands(kappa), {})}


def pbf_path_operands(cfg, ctx, params, vorticity=False):
    """The operands of every sweep of one PBF step from ``ctx`` (built at
    x*, ``pbf_cuda.advected``), by ``solvers/pbf_cuda.py``'s own operand
    functions, each from the plain versions' upstream results: the first
    iteration's λ and Δp (its λ from the plain λ); with
    ``vorticity``, also ω and N (key ``pbf_grad``) at the velocities after
    the ``pbf_iters`` plain iterations, and XSPH at those after the plain
    confinement. ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import pbf_cuda, wcsph_cuda
    rest, pm = params.rest_density, params.particle_mass
    lam_at, dp_at = pbf_cuda.pbf_operands(ctx, pm)
    x0 = torch.stack([ctx.px, ctx.py, ctx.pz], dim=1)
    x = x0
    ops = {}
    for _ in range(cfg.pbf_iters):
        largs = lam_at(x)
        dens, lam = SP.pbf_lambda_sweep_plain(cfg, *largs).unbind(1)
        dargs = dp_at(lam)
        if not ops:
            # the first iteration's operands, kept from the in-place writes
            # (the λ sweeps do not read the λ in the fluid rows' slot 3),
            # the queries still the first rows of the source
            src = dargs[1].clone()
            args = (src[:ctx.c], src, *dargs[2:])
            ops = {"pbf_lambda": (cuda_sweep.pbf_lambda_sweep,
                                  SP.pbf_lambda_sweep_plain, args, {}),
                   "pbf_dp": (cuda_sweep.pbf_dp_sweep,
                              SP.pbf_dp_sweep_plain, args, {})}
            if not vorticity:
                return ops
        dp = SP.pbf_dp_sweep_plain(cfg, *dargs)
        x = torch.where(ctx.active[:, None], x + dp / rest, x)
    v_star = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    v = (v_star + (x - x0) / params.dt).unbind(1)
    mrho = pm / torch.clamp(dens, min=1e-12)
    oargs = pbf_cuda.omega_operands(ctx, v, mrho)
    om = SP.pbf_omega_sweep_plain(cfg, *oargs)
    ox, oy, oz = om.unbind(1)
    nargs = pbf_cuda.grad_operands(
        ctx, mrho * torch.sqrt(ox * ox + oy * oy + oz * oz))
    al = SP.pbf_grad_sweep_plain(cfg, *nargs)
    nx, ny, nz = al[:, 1], al[:, 2], al[:, 3]
    ninv = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-20))
    k = params.dt * PBF_VORTICITY_EPS
    v = (v[0] + k * (ny * oz - nz * oy) * ninv,
         v[1] + k * (nz * ox - nx * oz) * ninv,
         v[2] + k * (nx * oy - ny * ox) * ninv)
    return {**ops,
            "pbf_omega": (cuda_sweep.pbf_omega_sweep,
                          SP.pbf_omega_sweep_plain, oargs, {}),
            "pbf_grad": (cuda_sweep.pbf_grad_sweep, SP.pbf_grad_sweep_plain,
                         nargs, {}),
            "xsph": (cuda_sweep.xsph_sweep, SP.xsph_sweep_plain,
                     wcsph_cuda.xsph_operands(ctx, v, dens), {})}


def moving(op, **kw):
    """``op`` (kernel, plain, args, kwargs) with ``moving_boundary=True``
    and ``kw`` added to its keyword switches."""
    kern, plain, args, okw = op
    return kern, plain, args, {**okw, "moving_boundary": True, **kw}


def friction_only(op, zero_col, beta0=False):
    """A wall-force sweep's op on its wall friction alone: the fluid ranges
    emptied, query column ``zero_col`` at 0 (pd2 of the force sweep, 1/m_i
    of the multiphase one, dropping the wall pressure resp. penalty) and,
    with ``beta0``, β at 0 (the force sweep's penalty). The friction is
    ~1e-10 of the wall force at these parameters, so the whole sweep
    cannot show that it reads the wall velocity."""
    from nereus_tpu_torch.ops import sph_pairs as SP
    kern, plain, (q, src, s, e, pv), kw = op
    q = q.clone()
    q[:, zero_col] = 0.0
    e = e.clone()
    e[:9] = s[:9]
    if beta0:
        pv = pv.clone()
        pv[SP.PV_BETA] = 0.0
    return kern, plain, (q, src, s, e, pv), kw


def moving_wall_operands(cfg, ctx, params):
    """On ``ctx`` built with a moving wall: the force sweep's MOVING
    instances (pressure on: the WCSPH step's operands; off: the implicit
    solvers' advection operands), each also on its friction alone, and the
    unchanged kernels that read the wall rows' velocity slots (IISPH's
    d_ii, ρ_adv and a_ii, DFSPH's Dρ/Dt, the viscous Laplacian), each from
    the plain
    versions' upstream results. ``{key: (kernel, plain, args, kwargs)}``."""
    dens_ops = xsph_path_operands(cfg, ctx, params)
    iisph = iisph_operands(cfg, ctx, params)
    ops = {"force_moving": moving(dens_ops["force"]),
           "force_p0_moving": moving(iisph["force_p0"])}
    ops["force_moving_friction"] = friction_only(ops["force_moving"], 7,
                                                 beta0=True)
    ops["force_p0_moving_friction"] = friction_only(ops["force_p0_moving"],
                                                    7, beta0=True)
    ops["dii_aii"] = iisph["dii_aii"]
    ops["drho"] = dfsph_operands(cfg, ctx, params)["drho"]
    ops["visc_laplacian"] = wcsph_visc_operands(cfg, ctx,
                                                params)["visc_laplacian"]
    return ops


def moving_wall_mp_operands(cfg, ctx, params):
    """On a two-phase ``ctx`` with a moving wall: MultiphaseForce<MOVING>,
    also on its friction alone, and the unchanged dδ̂/dt kernel."""
    from nereus_tpu_torch.ops.sph_pairs import MP_INV_M
    ops = {"mp_force_moving": moving(multiphase_operands(cfg, ctx,
                                                         params)["mp_force"])}
    ops["mp_force_moving_friction"] = friction_only(ops["mp_force_moving"],
                                                    MP_INV_M)
    ops["mp_drho"] = mp_dfsph_operands(cfg, ctx, params)["mp_drho"]
    return ops


def check_reads_wall_velocity(cfg, ops, label):
    """Fails unless each ``*_friction`` op's kernel gives another result
    with the static switch: the MOVING instance reads the wall velocity."""
    for key, (kern, _, args, kw) in ops.items():
        if key.endswith("_friction"):
            static = {k: v for k, v in kw.items() if k != "moving_boundary"}
            if torch.equal(kern(cfg, *args, **static), kern(cfg, *args, **kw)):
                fail(f"{label}: {key}: the MOVING kernel's wall friction "
                     "equals the static one's")


def check_body_friction(cfg, ctx, params, grid, body, label):
    """The body contact kernel of ``ctx``'s phase (BodyForce; MultiphaseBody
    on a multiphase ``ctx``) on its friction alone: pd2 resp. bp at 0, on
    ``body`` set moving at ``BODY_VEL`` and spinning at ``BODY_OMEGA``, so
    its shell's rows carry sample velocities v + ω × r in slots 3-5. The
    friction is ~1e-10 of the pressure term, so the whole sweep cannot show
    that the kernel reads them. Held against its plain version at
    FORCE_TOL; fails if the kernel gives the same result with those slots
    at 0."""
    dev = body.com.device
    moved = dataclasses.replace(
        body, vel=torch.tensor(BODY_VEL, dtype=torch.float32, device=dev),
        omega=torch.tensor(BODY_OMEGA, dtype=torch.float32, device=dev))
    ops = coupled_operands(cfg, ctx, params, grid, moved)
    key, col = ("mp_body", 6) if ctx.mass is not None else ("body_force", 7)
    kern, plain, (q, src, s, e, pv), kw = ops[key]
    q = q.clone()
    q[:, col] = 0.0
    compare_kernels(cfg, {f"{key}_friction": (kern, plain,
                                              (q, src, s, e, pv), kw)},
                    f"{label}, body at {BODY_VEL} m/s and {BODY_OMEGA} "
                    "rad/s")
    still = src.clone()
    still[:, 3:6] = 0.0
    if torch.equal(kern(cfg, q, src, s, e, pv, **kw),
                   kern(cfg, q, still, s, e, pv, **kw)):
        fail(f"{label}: {key}: the body friction equals the one with the "
             "shell's sample velocities at 0")


def coupled_operands(cfg, ctx, params, grid, body):
    """The operands of every sweep of one coupled step (single phase:
    density, force, body density, BodyForce; a multiphase ``ctx``:
    multiphase density and force, body density, MultiphaseBody) with one
    ``body``, built by ``solvers/coupled_cuda.py``'s own operand
    functions. ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import coupled_cuda, wcsph_cuda
    shells = coupled_cuda.body_shells(ctx, grid, (body,))
    sh = shells[0]
    rows = (sh.src, sh.seg_start, sh.seg_end, ctx.pvec)
    bdens = (cuda_sweep.body_density_sweep, SP.density_sweep_plain,
             (ctx.queries(width=4), sh.src4, *rows[1:]), {})
    if ctx.mass is None:
        dargs, fargs, _, _ = coupled_cuda.coupled_operands(ctx, params, cfg,
                                                           shells)
        return {"density": (cuda_sweep.density_sweep, SP.density_sweep_plain,
                            dargs, {}),
                "force": (cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
                          fargs, {}),
                "body_density": bdens,
                "body_force": (cuda_sweep.body_force_sweep,
                               SP.body_force_sweep_plain,
                               (fargs[0], *rows), {})}
    fargs, q8b, _, _ = coupled_cuda.coupled_multiphase_operands(
        ctx, params, cfg, shells)
    return {"mp_density": (cuda_sweep.multiphase_density_sweep,
                           SP.multiphase_density_sweep_plain,
                           wcsph_cuda.multiphase_density_operands(ctx), {}),
            "mp_force": (cuda_sweep.multiphase_force_sweep,
                         SP.multiphase_force_sweep_plain, fargs, {}),
            "body_density": bdens,
            "mp_body": (cuda_sweep.multiphase_body_sweep,
                        SP.multiphase_body_sweep_plain, (q8b, *rows), {})}


def deformed(x0, sp, seed=0):
    """Reference positions ``x0`` stretched 2 % along x, sheared (x +=
    0.1·y), rotated 20° about (1, 2, 3) about their centre and perturbed by
    a seeded noise of ``ELASTIC_NOISE``·``sp`` per component: non-affine,
    so the hourglass term, exactly 0 on affine motion, is live."""
    x = x0.double().cpu().numpy()
    c = x.mean(axis=0)
    a = np.array([[1.02, 0.1, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    ax = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    k = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    t = np.deg2rad(20.0)
    r = np.eye(3) + np.sin(t) * k + (1.0 - np.cos(t)) * (k @ k)
    x = (x - c) @ (r @ a).T + c
    x += np.random.default_rng(seed).uniform(
        -ELASTIC_NOISE, ELASTIC_NOISE, x.shape) * sp
    return torch.as_tensor(x, dtype=torch.float32, device=x0.device)


def elastic_kernel_ops(cfg, params, grid, statics, pos, ep):
    """ElasticF's and ElasticForceHourglass's operands at positions
    ``pos``, built by ``solvers/elastic_cuda.py``'s operand functions from
    the plain F and ``stress_pc``. ``{key: (kernel, plain, args,
    kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import elastic_cuda
    from nereus_tpu_torch.solvers.elastic import stress_pc
    pv = SP.build_pvec(params, cfg, grid)
    fargs = elastic_cuda.f_gradient_operands(statics, pos, pv)
    raw = SP.elastic_f_sweep_plain(cfg, *fargs)
    f = torch.bmm(statics.vol * raw.reshape(-1, 3, 3), statics.corr)
    pc, _, _ = stress_pc(f, statics.corr, ep)
    hargs = elastic_cuda.force_operands(statics, pos, pc, f, pv)
    return {"elastic_f": (cuda_sweep.elastic_f_sweep,
                          SP.elastic_f_sweep_plain, fargs, {}),
            "elastic_force_hg": (cuda_sweep.elastic_force_hourglass_sweep,
                                 SP.elastic_force_hourglass_sweep_plain,
                                 hargs, {})}


def elastic_coupled_ops(cfg, ctx, params, grid, estate, psi):
    """The operands of every sweep of one fluid–elastic coupled step
    (density, force, body density, BodyForce, FluidReaction) with the body
    at ``estate``, built by ``solvers/elastic_coupled.py``'s
    ``elastic_operands``. ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import elastic_coupled
    ops = elastic_coupled.elastic_operands(ctx, params, cfg, grid, estate,
                                           psi)
    sh = ops.shell
    rows = (sh.src, sh.seg_start, sh.seg_end, ctx.pvec)
    return {"density": (cuda_sweep.density_sweep, SP.density_sweep_plain,
                        ops.dargs, {}),
            "force": (cuda_sweep.force_sweep, SP.fluid_force_sweep_plain,
                      ops.fargs, {}),
            "body_density": (cuda_sweep.body_density_sweep,
                             SP.density_sweep_plain,
                             (ops.dargs[0], sh.src4, *rows[1:]), {}),
            "body_force": (cuda_sweep.body_force_sweep,
                           SP.body_force_sweep_plain, (ops.fargs[0], *rows),
                           {}),
            "fluid_reaction": (cuda_sweep.fluid_reaction_sweep,
                               SP.fluid_reaction_sweep_plain, ops.rargs, {})}


def spinning(estate, statics):
    """``estate`` with every sample moving at ``BODY_VEL`` plus
    ``BODY_OMEGA`` × (X − centre)."""
    dev = statics.x0.device
    r = statics.x0 - statics.x0.mean(dim=0)
    v = torch.tensor(BODY_VEL, device=dev) + torch.linalg.cross(
        torch.tensor(BODY_OMEGA, device=dev).expand_as(r), r)
    return dataclasses.replace(estate, vel=v)


def check_reaction(cfg, ops, params, label):
    """FluidReaction of ``ops`` (:func:`elastic_coupled_ops`) against its
    plain version, as it is and on its friction alone: the fluid density
    of the source rows clamped to ρ₀, so the Tait pressure is 0 (the
    friction is ~1e-9 of the pressure term and a whole sweep cannot show
    that the kernel reads the sample velocities); fails unless some
    samples have fluid in their ranges and the friction differs from its
    result with the samples' velocities at 0."""
    kern, plain, (q, src, s, e, pv), kw = ops["fluid_reaction"]
    live = int((e - s).sum(dim=0).gt(0).sum())
    print(f"  {label}: {live} of {q.shape[0]} body samples have fluid in "
          "their ranges")
    if live == 0:
        fail(f"{label}: no body sample has fluid in its ranges")
    fric = src.clone()
    fric[:, 6] = torch.clamp(fric[:, 6], max=float(params.rest_density))
    compare_kernels(cfg, {"fluid_reaction": ops["fluid_reaction"],
                          "fluid_reaction_friction": (
                              kern, plain, (q, fric, s, e, pv), kw)}, label)
    still = q.clone()
    still[:, 3:6] = 0.0
    if torch.equal(kern(cfg, q, fric, s, e, pv), kern(cfg, still, fric, s,
                                                      e, pv)):
        fail(f"{label}: the reaction's friction equals the one with the "
             "samples' velocities at 0")


def elastic_block(dev, plastic):
    """``bench.py:136-163``'s elastic_512k (``plastic``: its
    elastic_plastic_512k): ``make_params(dt=1e-4)``, an 80³ block at
    spacing h/2 whose bottom layer sits 0.5·spacing above the penalty
    floor at y = 0, E = 2e5, ν = 0.3, damping 5 (yield strain 0.02).
    Returns ``(cfg, params, ep, state, statics, grid, sp)``."""
    import nereus_tpu_torch as nt
    cfg = nt.SimConfig()
    params = nt.make_params(dt=ELASTIC_DT, device=dev)
    sp = 0.5 * float(params.interaction_radius)
    side = (ELASTIC_SIDE - 1) * sp
    pts = nt.sample_box_solid((0.0, 0.5 * sp, 0.0),
                              (side + 0.1 * sp, 0.5 * sp + side + 0.1 * sp,
                               side + 0.1 * sp), sp)
    ep = nt.elastic_params(
        ELASTIC_E, 0.3, damping=ELASTIC_DAMPING, floor_y=0.0,
        yield_strain=ELASTIC_YIELD if plastic else float("inf"), device=dev)
    state, statics, grid = nt.make_elastic_solid(pts, params, cfg, sp,
                                                 plastic=plastic, device=dev)
    return cfg, params, ep, state, statics, grid, sp


def run_elastic(name, dev, plastic):
    """``IMPLICIT_STEPS`` elastic steps of :func:`elastic_block`, steps
    after ``IMPLICIT_TIMED_FROM`` timed. Gates: one ElasticF and one
    ElasticForceHourglass launch per step and no other kernel; finite
    positions and velocities; ``seg_overflow`` 0; ``max_stretch`` < 0.1
    and min y ≥ −0.01·spacing on every step; ``plastic``: E_p finite and
    traceless within 1e-5·max|E_p|. Then both kernels against their plain
    versions at the path's shapes (its statics and pair list) on
    :func:`deformed` positions, timed, and ElasticF so under each model of
    ``MODELS``. Returns ``(timing, launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    t0 = time.perf_counter()
    cfg, params, ep, state, statics, grid, sp = elastic_block(dev, plastic)
    torch.cuda.synchronize()
    n = statics.n
    print(f"{name}: {n} samples at spacing {sp:.6g}, grid {grid.size}, dt "
          f"{float(params.dt)}, floor y 0, plastic {plastic}; set-up (sort, "
          f"ranges, D sweep) {time.perf_counter() - t0:.1f} s")
    if n != ELASTIC_N:
        fail(f"{name}: expected {ELASTIC_N:,} samples, got {n}")
    min_y = []

    def step(s):
        s, d = nt.elastic_step(s, statics, params, ep, grid, cfg)
        min_y.append(s.pos[:, 1].min())
        return s, d
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diags, ms, _, _ = run_steps(step, state, IMPLICIT_STEPS,
                                       IMPLICIT_TIMED_FROM)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    stretch = torch.stack([d.max_stretch for d in diags]).cpu().numpy()
    energy = torch.stack([d.elastic_energy for d in diags]).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    low = float(torch.stack(min_y).min())
    print(f"{name}: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; steps "
          f"{IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, "
          f"max_stretch max {stretch.max():.6g}, elastic energy last "
          f"{energy[-1]:.6g} J, min y {low:.6g} (floor 0; the block falls "
          f"from 0.5·spacing), max speed {float(diags[-1].max_speed):.6g}")
    check_launches(name, {cuda_sweep.ELASTIC_F: IMPLICIT_STEPS,
                          cuda_sweep.ELASTIC_FORCE_HG: IMPLICIT_STEPS})
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    if not (bool(torch.isfinite(state.pos).all())
            and bool(torch.isfinite(state.vel).all())):
        fail(f"{name}: non-finite positions or velocities")
    if not stretch.max() < 0.1:
        fail(f"{name}: max_stretch {stretch.max()} >= 0.1")
    if not low >= -0.01 * sp:
        fail(f"{name}: min y {low} below -0.01·spacing")
    if plastic:
        ep_max = float(state.plastic.abs().max())
        tr = float(torch.einsum("naa->n", state.plastic).abs().max())
        print(f"{name}: max|E_p| {ep_max:.6g}, max|tr E_p| {tr:.3g}")
        if not (bool(torch.isfinite(state.plastic).all())
                and tr <= 1e-5 * ep_max):
            fail(f"{name}: E_p not finite or not traceless ({tr} > "
                 f"1e-5·{ep_max})")
    ops = elastic_kernel_ops(cfg, params, grid, statics,
                             deformed(statics.x0, sp), ep)
    label = f"{name}: its statics, deformed positions"
    timing = compare_kernels(cfg, ops, label, time_it=True)
    check_models(ops, ("elastic_f",), label)
    return timing, launches


def wcsph_elastic_scene(dev):
    """``bench.py:165-198``'s wcsph_elastic_256k: ``dam_break(make_params(),
    n_target=256_000)`` with its walls, and a 16³ cube at spacing h/2 of
    400 kg/m³ at E = 1e5, ν = 0.3, damping 5, standing 2·spacing over the
    floor (its penalty floor) ``WEL_GAP`` downstream of the fluid. Returns
    ``(cfg, params, state, grid, walls, estate, statics, ep, psi, sp)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    params = nt.make_params(device=dev)
    state, grid, walls = scene.dam_break(params, cfg, n_target=WEL_N,
                                         with_boundary=True, device=dev)
    sp = 0.5 * float(params.interaction_radius)
    posf = state.pos[:int(state.num_active)]
    floor_y = float(walls.pos[:, 1].min())
    cx = float(posf[:, 0].max()) + WEL_GAP
    cz = float(posf[:, 2].mean())
    side = WEL_SIDE * sp
    cube = nt.sample_box_solid(
        (cx, floor_y + 2 * sp, cz - side / 2),
        (cx + side + 0.1 * sp, floor_y + 2 * sp + side + 0.1 * sp,
         cz + side / 2 + 0.1 * sp), sp)
    ep = nt.elastic_params(WEL_E, 0.3, damping=5.0, floor_y=floor_y,
                           device=dev)
    estate, statics, _ = nt.make_elastic_solid(
        cube, params, cfg, sp, grid=grid, density=WEL_DENSITY, device=dev)
    psi = nt.elastic_psi(statics, params, cfg)
    return cfg, params, state, grid, walls, estate, statics, ep, psi, sp


def run_wcsph_elastic(name, dev):
    """``IMPLICIT_STEPS`` coupled steps of :func:`wcsph_elastic_scene` at
    ``WEL_SUBSTEPS`` substeps, steps after ``IMPLICIT_TIMED_FROM`` timed.
    Gates per step: one density, force, body density, BodyForce and
    FluidReaction launch and ``WEL_SUBSTEPS`` ElasticF and
    ElasticForceHourglass launches, no other kernel; finite fluid and body;
    mean compression < 0.1; zero overflow. Prints how many body samples
    feel the fluid at the last step. Then every kernel of the path against
    its plain version at the path's shapes, timed: the elastic kernels on
    the body's statics at :func:`deformed` positions (ElasticF also under
    each model of ``MODELS``); the fluid and contact
    kernels on the last state with the body moved, at its last velocities,
    into the middle of the fluid (at its own place the water has not
    reached it), FluidReaction also on its friction alone. Returns
    ``(timing, launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import elastic_coupled
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    t0 = time.perf_counter()
    (cfg, params, state, grid, walls, estate, statics, ep, psi,
     sp) = wcsph_elastic_scene(dev)
    nf = int(state.num_active)
    n = nf + statics.n
    print(f"{name}: {nf} fluid particles, {walls.num_boundaries} wall "
          f"samples, a body of {statics.n} samples ({WEL_DENSITY} kg/m³, E "
          f"{WEL_E}) at x {float(statics.x0[:, 0].min()):.6g} (the fluid's "
          f"front at {float(state.pos[:nf, 0].max()):.6g}), grid "
          f"{grid.size}, dt {float(params.dt)}, {WEL_SUBSTEPS} substeps; "
          f"set-up {time.perf_counter() - t0:.1f} s")
    held = {"body": estate}
    mcs = []

    def step(s):
        s, held["body"], d = nt.wcsph_elastic_step(
            s, params, grid, cfg, held["body"], statics, ep, psi, walls,
            substeps=WEL_SUBSTEPS)
        mcs.append(d.mean_compression)
        return s, d
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diags, ms, _, _ = run_steps(step, state, IMPLICIT_STEPS,
                                       IMPLICIT_TIMED_FROM)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    body = held["body"]
    mc = torch.stack(mcs).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    print(f"{name}: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; steps "
          f"{IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s ({nf} fluid + "
          f"{statics.n} body)")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, "
          f"mean_compression max {mc.max():.6g} last {mc[-1]:.6g}, body "
          f"min y {float(body.pos[:, 1].min()):.6g}, mean velocity "
          f"{body.vel.mean(dim=0).tolist()}")
    steps = IMPLICIT_STEPS
    check_launches(name, {
        cuda_sweep.DENSITY: steps, cuda_sweep.FORCE: steps,
        cuda_sweep.BODY_DENSITY: steps, cuda_sweep.BODY_FORCE: steps,
        cuda_sweep.FLUID_REACTION: steps,
        cuda_sweep.ELASTIC_F: WEL_SUBSTEPS * steps,
        cuda_sweep.ELASTIC_FORCE_HG: WEL_SUBSTEPS * steps})
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    finite = [bool(torch.isfinite(t).all()) for t in (
        state.pos, state.vel, body.pos, body.vel)]
    if not all(finite):
        fail(f"{name}: non-finite fluid or body state {finite}")
    if not mc.max() < 0.1:
        fail(f"{name}: mean_compression {mc.max()} >= 0.1 at step "
             f"{int(mc.argmax()) + 1}")
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    rargs = elastic_coupled.elastic_operands(ctx, params, cfg, grid, body,
                                             psi).rargs
    felt = int(SP.fluid_reaction_sweep(cfg, *rargs).abs().amax(
        dim=1).gt(0).sum())
    print(f"{name}: {felt} of {statics.n} body samples feel the fluid at "
          "the last step")
    eops = elastic_kernel_ops(cfg, params, grid, statics,
                              deformed(statics.x0, sp), ep)
    label = f"{name}: the body's statics, deformed positions"
    timing = compare_kernels(cfg, eops, label, time_it=True)
    check_models(eops, ("elastic_f",), label)
    centre = state.pos[:nf].mean(dim=0)
    inside = dataclasses.replace(
        body, pos=body.pos - body.pos.mean(dim=0) + centre)
    ops = elastic_coupled_ops(cfg, ctx, params, grid, inside, psi)
    check_reaction(cfg, ops, params, f"{name}: the body in mid-fluid")
    timing.update(compare_kernels(
        cfg, ops, f"{name} after {steps} steps, the body in mid-fluid",
        time_it=True))
    return timing, launches


def dfsph_body_ops(cfg, ctx, params, grid, body):
    """The operands of one coupled DFSPH step's body sweeps with one
    rigid ``body`` (multiphase on a two-phase ``ctx``), built by
    ``solvers/dfsph_coupled_cuda.py``'s own classes: the shell's
    ψ-density with the body form of α in one sweep (multiphase: the body
    density and the body form of α̂), Dρ/Dt (dδ̂/dt) over the shell at the
    body's sample velocities and the κ correction over the shell, both on
    the first divergence iteration (κᵛ = max(Dρ/Dt, 0)·α/dt), and the
    friction alone (pressure off; multiphase: bp at 0) at the state's
    velocities.
    ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import dfsph_coupled_cuda as DC
    (t,) = DC.body_terms(ctx, grid, (body,))
    rows = t.ranges(ctx.pvec)
    bv = (body.vel, body.omega)
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    dt = float(params.dt)
    q4 = ctx.queries(width=4)
    zero = torch.zeros_like(ctx.px)
    if ctx.mass is None:
        dens, alpha = DC.coupled_density_alpha(ctx, params, cfg, [t])
        sw = DC.CoupledSweeps(ctx, params, cfg, dens, [t])
        drho = torch.clamp(sw.drho(v, [bv]), min=0.0)
        kq = sw.kappa_operands(drho * alpha / dt)[0].clone()
        q_v = sw.q_v.clone()
        q8 = ctx.queries(ctx.vx, ctx.vy, ctx.vz, dens, zero)
        src_v = t.src_at(bv).clone()
        return {"body_density_alpha": (cuda_sweep.body_density_alpha_sweep,
                                       SP.body_density_alpha_sweep_plain,
                                       (q4, t.src4, *rows), {}),
                "drho_shell": (cuda_sweep.drho_shell_sweep,
                               SP.drho_sweep_plain, (q_v, src_v, *rows), {}),
                "pressure_force_body": (
                    cuda_sweep.pressure_force_body_sweep,
                    SP.pressure_force_body_sweep_plain,
                    (kq, t.shell.src, *rows), {}),
                "body_force_p0": (cuda_sweep.body_force_sweep,
                                  SP.body_force_sweep_plain,
                                  (q8, src_v, *rows),
                                  {"include_pressure": False})}
    dens, _, alpha = DC.coupled_density_alpha_multiphase(ctx, params, cfg,
                                                         [t])
    sw = DC.MultiphaseCoupledSweeps(ctx, params, cfg, dens, [t])
    dhat = torch.clamp(sw.drho(v, [bv]), min=0.0)
    kq = sw.kappa_operands(dhat * alpha / dt)[0].clone()
    q_v = sw.q_v.clone()
    inv_rho = 1.0 / torch.clamp(dens, min=1e-12)
    q8b = ctx.queries(ctx.vx, ctx.vy, ctx.vz, zero,
                      ctx.mass * inv_rho * inv_rho)
    src_v = t.src_at(bv).clone()
    return {"body_density": (cuda_sweep.body_density_sweep,
                             SP.density_sweep_plain, (q4, t.src4, *rows),
                             {}),
            "mp_alpha_body": (cuda_sweep.multiphase_alpha_body_sweep,
                              SP.multiphase_alpha_body_sweep_plain,
                              (q4, t.src4, *rows), {}),
            "mp_drho_body": (cuda_sweep.multiphase_drho_body_sweep,
                             SP.multiphase_drho_body_sweep_plain,
                             (q_v, src_v, *rows), {}),
            "mp_kappa_body": (cuda_sweep.multiphase_kappa_body_sweep,
                              SP.multiphase_kappa_body_sweep_plain,
                              (kq, t.src4, *rows), {}),
            "mp_body": (cuda_sweep.multiphase_body_sweep,
                        SP.multiphase_body_sweep_plain, (q8b, src_v, *rows),
                        {})}


def dfsph_elastic_ops(cfg, ctx, params, grid, estate, statics, psi):
    """The operands of one coupled DFSPH + elastic step's body sweeps with
    the body at ``estate``, built by ``solvers/dfsph_elastic.py``'s own
    classes: the shell's ψ-density with α's sums over the shell in one
    sweep (their fluid form: strong coupling), Drho over the shell at the
    sample velocities, the κ correction of the first divergence iteration
    forward over the shell and reverse (the samples as queries against
    the fluid rows, key ``*_rev``), and the friction alone both ways at
    the state's velocities. ``{key: (kernel, plain, args, kwargs)}``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers import dfsph_elastic as DE
    from nereus_tpu_torch.solvers.elastic_coupled import elastic_shell
    es = elastic_shell(ctx, grid, estate, psi)
    rows = (es.shell.seg_start, es.shell.seg_end, ctx.pvec)
    rev = (es.r_start, es.r_end, ctx.pvec)
    dens, alpha = DE.elastic_density_alpha(ctx, params, cfg, es,
                                           statics.mass)
    sw = DE.ElasticSweeps(ctx, params, cfg, dens, es, statics.mass)
    v = torch.stack([ctx.vx, ctx.vy, ctx.vz], dim=1)
    vb = es.shell.src[:, 3:6]
    drho = torch.clamp(sw.drho(v, (vb,)), min=0.0)
    kq, ksrc = (t.clone() for t in sw.kappa_operands(
        drho * alpha / float(params.dt))[:2])
    q_v = sw.q_v.clone()
    q4 = ctx.queries(width=4)
    zero = torch.zeros_like(dens)
    q8 = ctx.queries(ctx.vx, ctx.vy, ctx.vz, dens, zero)
    src_f = ctx.pack((ctx.vx, ctx.vy, ctx.vz), dens)[:ctx.c]
    p0 = {"include_pressure": False}
    plain = SP.pressure_force_body_sweep_plain
    return {"body_density_alpha_sq": (
                cuda_sweep.body_density_alpha_sweep,
                SP.body_density_alpha_sweep_plain,
                (q4, es.shell.src4, *rows), {"include_sq": True}),
            "drho_shell": (cuda_sweep.drho_shell_sweep, SP.drho_sweep_plain,
                           (q_v, es.shell.src, *rows), {}),
            "pressure_force_body": (cuda_sweep.pressure_force_body_sweep,
                                    plain, (kq, es.shell.src, *rows), {}),
            "pressure_force_body_rev": (
                cuda_sweep.pressure_force_body_rev_sweep, plain,
                (sw.q_b, ksrc, *rev), {}),
            "body_force_p0": (cuda_sweep.body_force_sweep,
                              SP.body_force_sweep_plain,
                              (q8, es.shell.src, *rows), p0),
            "fluid_reaction_p0": (cuda_sweep.fluid_reaction_sweep,
                                  SP.fluid_reaction_sweep_plain,
                                  (es.shell.src, src_f, *rev), p0)}


def check_dfsph_body_ops(cfg, ops, params, label):
    """Every op of :func:`dfsph_body_ops` / :func:`dfsph_elastic_ops`
    against its plain version (``compare_kernels``); fails unless each has
    candidate pairs inside the cutoff and each friction op (BodyForce and
    FluidReaction without pressure, MultiphaseBody at bp = 0) differs from
    its result with the sample velocities at 0."""
    from nereus_tpu_torch.ops.sph_pairs import PV_H2
    for key, (_, _, (q, src, s, e, pv), _) in ops.items():
        if cutoff_pairs(q, src, s, e, float(pv[PV_H2])) == 0:
            fail(f"{label}: {key} has no candidate inside the cutoff")
    compare_kernels(cfg, ops, label)
    for key in ("body_force_p0", "mp_body", "fluid_reaction_p0"):
        if key not in ops:
            continue
        kern, _, (q, src, s, e, pv), kw = ops[key]
        # the samples' velocities: the query rows of the reverse sweep,
        # the source rows of the forward ones
        q0, src0 = q.clone(), src.clone()
        (q0 if key == "fluid_reaction_p0" else src0)[:, 3:6] = 0.0
        if torch.equal(kern(cfg, q, src, s, e, pv, **kw),
                       kern(cfg, q0, src0, s, e, pv, **kw)):
            fail(f"{label}: {key}: the friction equals the one with the "
                 "sample velocities at 0")


def dfsph_coupled_scene(dev, kind):
    """``bench.py:239-268``'s dfsph_coupled_256k: ``resting_block(n_target=
    256_000)`` under ``dfsph_params(dt=5e-4)`` calibrated to the 0.8·h
    lattice, impact velocity −1 m/s, with its wall shell, and a 0.15 m box
    of 400 kg/m³ centred over the block ``BODY_DROP`` above the water
    (``kind`` "rigid"); "mp": the block split at its median height with
    the top half at 0.4·ρ₀ (phase 25's split); "elastic": phase 30's 16³
    cube (400 kg/m³, E = 1e5, ν = 0.3, damping 5, its penalty floor at the
    walls' floor) centred in x and z, its bottom 0.5 fluid spacings above
    the water. Returns ``(cfg, params, state, grid, walls, body)`` with
    ``body`` the rigid body or ``(estate, statics, ep, psi)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    base = nt.dfsph_params(dt=DFSPH_COUPLED_DT, device=dev)
    spacing = 0.8 * float(base.interaction_radius)
    params = nt.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, walls = scene.resting_block(
        params, cfg, n_target=COUPLED_N, spacing=spacing,
        impact_velocity=-1.0, device=dev)
    if kind == "mp":
        state = two_phase(state, params, ratio=COUPLED_RATIO)
    posf = state.pos[:int(state.num_active)]
    top = float(posf[:, 1].max())
    cx, cz = float(posf[:, 0].mean()), float(posf[:, 2].mean())
    if kind != "elastic":
        body = nt.make_rigid_box((cx, top + BODY_DROP, cz), (BODY_SIZE,) * 3,
                                 float(params.particle_radius),
                                 DFSPH_BODY_DENSITY, params, device=dev)
        return cfg, params, state, grid, walls, body
    sp = 0.5 * float(params.interaction_radius)
    side = WEL_SIDE * sp
    y0 = top + 0.5 * spacing
    cube = nt.sample_box_solid(
        (cx - side / 2, y0, cz - side / 2),
        (cx + side / 2 + 0.1 * sp, y0 + side + 0.1 * sp,
         cz + side / 2 + 0.1 * sp), sp)
    ep = nt.elastic_params(WEL_E, 0.3, damping=5.0,
                           floor_y=float(walls.pos[:, 1].min()), device=dev)
    estate, statics, _ = nt.make_elastic_solid(
        cube, params, cfg, sp, grid=grid, density=WEL_DENSITY, device=dev)
    psi = nt.elastic_psi(statics, params, cfg)
    return cfg, params, state, grid, walls, (estate, statics, ep, psi)


def run_dfsph_coupled(name, dev, kind):
    """``IMPLICIT_STEPS`` coupled DFSPH steps of :func:`dfsph_coupled_scene`
    (``kind`` "rigid", "mp" or "elastic", the last at ``WEL_SUBSTEPS``
    substeps), steps after ``IMPLICIT_TIMED_FROM`` timed. Gates: each
    kernel of the path launched once per step, once per launched
    iteration or once per κ correction as the step says, no other kernel;
    zero overflow; finite fluid and body; a rigid body's R orthonormal
    within 1e-5 on every step; each run of both loops within its
    tolerance or at its cap. Then every kernel of the path against its
    plain version at the path's shapes, timed: the fluid kernels on the
    last state, the body kernels with the body moved, at its last
    velocities, into the middle of the fluid, the elastic kernels on the
    body's statics at :func:`deformed` positions; the block lowered until
    its bottom layer lies 0.5·h over the floor (in 60 steps it does not
    reach the walls' support). The shell's Dρ/Dt, its ψ-density and α
    sweep and ElasticF (the multiphase: the shell's κ̂ correction) also so
    under each model of ``MODELS``. Returns ``(timing, launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.solvers import dfsph_cuda
    t0 = time.perf_counter()
    cfg, params, state, grid, walls, body = dfsph_coupled_scene(dev, kind)
    n = int(state.num_active)
    elastic = kind == "elastic"
    if elastic:
        estate, statics, ep, psi = body
        desc = (f"a {statics.n}-sample cube ({WEL_DENSITY} kg/m³, E "
                f"{WEL_E}, {WEL_SUBSTEPS} substeps), bottom "
                f"{float(estate.pos[:, 1].min()):.6g}")
    else:
        desc = (f"a box of {body.num_samples} samples at "
                f"{body.com.tolist()} ({DFSPH_BODY_DENSITY} kg/m³)")
    print(f"{name}: {n} fluid particles (water top "
          f"{float(state.pos[:n, 1].max()):.6g}), {walls.num_boundaries} "
          f"wall samples, {desc}, grid {grid.size}, dt {float(params.dt)}, "
          f"multiphase {state.multiphase}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    if n != SETTLED_FLUID:
        fail(f"{name}: expected {SETTLED_FLUID:,} fluid particles, got {n}")
    held = {"body": estate if elastic else body}
    orth = []

    def step(s):
        if elastic:
            s, held["body"], d = nt.dfsph_elastic_step(
                s, params, grid, cfg, held["body"], statics, ep, psi, walls,
                substeps=WEL_SUBSTEPS, tol=DFSPH_TOL, tol_v=DFSPH_TOL)
        else:
            s, held["body"], d = nt.dfsph_coupled_step(
                s, params, grid, cfg, held["body"], walls, tol=DFSPH_TOL,
                tol_v=DFSPH_TOL)
            R = held["body"].R
            orth.append((R @ R.T - torch.eye(3, device=R.device)).abs().max())
        return s, d
    loops = {"divergence": dfsph_cuda.LOOP_V, "density": dfsph_cuda.LOOP}
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    for lp in loops.values():
        lp.reset()
    t_host = time.perf_counter()
    state, diags, ms, window, ends = run_steps(
        step, state, IMPLICIT_STEPS, IMPLICIT_TIMED_FROM,
        tuple(loops.values()))
    t_host = time.perf_counter() - t_host
    timed = IMPLICIT_STEPS - IMPLICIT_TIMED_FROM
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    b = held["body"]
    iters = torch.stack([d.solver_iters for d in diags]).cpu().numpy()
    mcs = torch.stack([d.mean_compression for d in diags]).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    it = sum(lp.launched for lp in loops.values())
    print(f"{name}: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; steps "
          f"{IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s; iterations launched "
          f"{it} for {int(iters.sum())} converged, host syncs "
          f"{sum(w[1] for w in window) / timed:.4g} per timed step")
    if elastic:
        body_desc = (f"body min y {float(b.pos[:, 1].min()):.6g}, mean "
                     f"velocity {b.vel.mean(dim=0).tolist()}")
    else:
        body_desc = (f"body com {b.com.tolist()} vel {b.vel.tolist()} omega "
                     f"{b.omega.tolist()}, max |R Rᵀ − I| "
                     f"{float(torch.stack(orth).max()):.3g}")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, "
          f"solver_iters {iters.tolist()}, mean_compression max "
          f"{mcs.max():.6g} last {mcs[-1]:.6g}, {body_desc}")
    check_loop_ends(name, loops, ends)
    steps = IMPLICIT_STEPS
    corr = it + steps     # the warm start's correction on every step
    K = cuda_sweep
    if kind == "mp":
        want = {K.MP_DENSITY_ALPHA: steps, K.BODY_DENSITY: steps,
                K.MP_ALPHA_BODY: steps,
                K.MP_DRHO: it, K.MP_DRHO_BODY: it, K.MP_KAPPA: corr,
                K.MP_KAPPA_BODY: corr, K.MP_FORCE: steps, K.MP_BODY: steps}
    else:
        want = {K.DENSITY_ALPHA_SUMS: steps, K.DRHO: it, K.DRHO_SHELL: it,
                K.PRESSURE_FORCE: corr, K.FORCE_P0: steps,
                K.BODY_FORCE_P0: steps}
        if elastic:
            want.update({K.BODY_DENSITY_ALPHA_SQ: steps,
                         K.PRESSURE_FORCE_BODY: corr,
                         K.PRESSURE_FORCE_BODY_REV: corr,
                         K.FLUID_REACTION_P0: steps,
                         K.ELASTIC_F: WEL_SUBSTEPS * steps,
                         K.ELASTIC_FORCE_HG: WEL_SUBSTEPS * steps})
        else:
            want.update({K.BODY_DENSITY_ALPHA: steps,
                         K.PRESSURE_FORCE_BODY: corr})
    check_launches(name, want)
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    parts = (state.pos, state.vel, b.pos, b.vel) if elastic else (
        state.pos, state.vel, b.com, b.vel, b.omega, b.R)
    finite = [bool(torch.isfinite(t).all()) for t in parts]
    if not all(finite):
        fail(f"{name}: non-finite fluid or body state {finite}")
    if orth and not float(torch.stack(orth).max()) < 1e-5:
        fail(f"{name}: R drifts from orthonormal")
    ops, body_ops = dfsph_coupled_held_ops(cfg, params, state, grid, walls,
                                           held["body"], body, kind)
    check_dfsph_body_ops(cfg, body_ops, params,
                         f"{name} after {steps} steps, the body in "
                         "mid-fluid")
    ops.update(body_ops)
    label = f"{name} after {steps} steps"
    timing = compare_kernels(cfg, ops, label, time_it=True)
    check_models(ops, ("mp_kappa_body",) if kind == "mp" else
                 ("drho_shell", "elastic_f", "body_density_alpha_sq")
                 if elastic else ("drho_shell", "body_density_alpha"), label)
    return timing, launches


def dfsph_coupled_held_ops(cfg, params, state, grid, walls, b, body, kind):
    """``(ops, body_ops)`` of a DFSPH coupled path (``kind`` as
    :func:`dfsph_coupled_scene`'s) at its final ``state`` and body ``b``,
    as :func:`run_dfsph_coupled` holds them: the block has not reached the
    walls' support in 60 steps, so its fluid kernels are held on the state
    lowered until its bottom layer lies 0.5·h over the floor (the wall sums
    live; ``dfsph_operands`` or ``mp_dfsph_operands``), and its body
    kernels with the body moved, at its last velocities, into the middle of
    that fluid (``dfsph_body_ops``, ``dfsph_elastic_ops``, which with the
    elastic kernels on the body's statics at :func:`deformed` positions
    join ``ops``); ``body`` the scene's (an elastic one's statics, ep,
    psi)."""
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    n = int(state.num_active)
    h = float(params.interaction_radius)
    floor = float(walls.pos[:, 1].min())
    drop = float(state.pos[:n, 1].min()) - (floor + 0.5 * h)
    low = dataclasses.replace(state, pos=state.pos - torch.tensor(
        [0.0, max(drop, 0.0), 0.0], device=state.pos.device))
    ctx = build_sweep_ctx(low, params, grid, cfg, walls)
    centre = low.pos[:n].mean(dim=0)
    if kind == "mp":
        ops = mp_dfsph_operands(cfg, ctx, params)
    else:
        ops = dfsph_operands(cfg, ctx, params, sums=True)
    if kind == "elastic":
        _, statics, ep, psi = body
        inside = dataclasses.replace(
            b, pos=b.pos - b.pos.mean(dim=0) + centre)
        body_ops = dfsph_elastic_ops(cfg, ctx, params, grid, inside, statics,
                                     psi)
        ops.update(elastic_kernel_ops(cfg, params, grid, statics,
                                      deformed(statics.x0, 0.5 * h), ep))
    else:
        body_ops = dfsph_body_ops(cfg, ctx, params, grid,
                                  dataclasses.replace(b, com=centre))
    return ops, body_ops


def compare_kernels(cfg, ops, label, keys=None, time_it=False):
    """Each kernel of ``ops`` (``{key: (kernel, plain, args, kwargs)}``;
    ``keys``, default all) against its plain version on the same operands:
    max|Δ| ≤ FORCE_TOL·max|ref| per output column (the λ of PBF's (ρ, λ)
    by :func:`check_lambda`), and finite. Returns
    per-kernel (max_abs_err, ms, plain_ms, bound_ms, bound_by,
    bound_ranges_ms) when timed."""
    out, msg = {}, []
    for key in keys or ops:
        kern, plain, args, kw = ops[key]
        got = kern(cfg, *args, **kw)
        ref = plain(cfg, *args, **kw)
        g2, r2 = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
        zero = list(ZERO_COLS.get(key.removesuffix("_rev"), ()))
        if zero and (bool(g2[:, zero].any()) or bool(r2[:, zero].any())):
            fail(f"{label}: {key} writes its zero columns {zero}")
        # the λ column of (ρ, λ) is held by check_lambda
        apart = (1,) if key == "pbf_lambda" else ()
        if apart:
            check_lambda(got, ref, args[4], f"{label}: {key}")
        live = [c for c in range(g2.shape[1]) if c not in zero + list(apart)]
        g2, r2 = g2[:, live], r2[:, live]
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
        if key.startswith("density_alpha"):
            check_fused_density(cfg, args, got, f"{label}: {key}")
        elif key.startswith("body_density_alpha"):
            check_fused_body_density(cfg, args, got, f"{label}: {key}")
        elif key == "mp_density_alpha":
            check_fused_mp_density(cfg, args, got, f"{label}: {key}")
        if time_it:
            out[key] = (float(err.max()),
                        *time_turns(key, lambda: kern(cfg, *args, **kw),
                                    lambda: plain(cfg, *args, **kw)),
                        *bound(key, args, got))
            if hasattr(kern, "ctx"):
                out[key] += (tile_stats(key, kern, cfg, args, got),)
            elif key in GROUPED:
                out[key] += (group_stats(key, args, kw),)
    print(f"  {label}: max|d|/max|ref| " + ", ".join(msg))
    return out


def check_fused_density(cfg, args, got, label):
    """Prints the fused density and α kernel's ρ (column 0 of ``got``)
    against the density kernel's on the same operands, each at its own G:
    bit for bit, or the largest difference."""
    from nereus_tpu_torch.ops import cuda_sweep
    dens = cuda_sweep.density_sweep(cfg, *args)
    groups = (cuda_sweep.DENSITY_ALPHA_G,
              cuda_sweep.density_group(args[0].shape[0]))
    diff = float((got[:, 0] - dens).abs().max())
    same = bool(torch.equal(got[:, 0], dens))
    print(f"  {label}: ρ against the density kernel's (G {groups[0]} / "
          f"{groups[1]}): " + ("bit for bit" if same else
                              f"max|d| {diff:.3g} of max ρ "
                              f"{float(dens.max()):.6g}"))


def check_fused_body_density(cfg, args, got, label):
    """Prints the shell's fused ψ-density and α kernel's Σψ_bW (column 0
    of ``got``) against the density kernel's ``<body>`` on the same
    operands, each at its own G: bit for bit, or the largest difference."""
    from nereus_tpu_torch.ops import cuda_sweep
    dens = cuda_sweep.body_density_sweep(cfg, *args)
    m = args[1].shape[0]
    groups = (cuda_sweep.shell_group(m), cuda_sweep.body_group(m))
    diff = float((got[:, 0] - dens).abs().max())
    same = bool(torch.equal(got[:, 0], dens))
    print(f"  {label}: Σψ_bW against the density kernel's <body> (G "
          f"{groups[0]} / {groups[1]}): " + ("bit for bit" if same else
                                             f"max|d| {diff:.3g} of max "
                                             f"{float(dens.max()):.6g}"))


def check_fused_mp_density(cfg, args, got, label):
    """Prints the multiphase density and α̂ kernel's δ and Σψ_bW (columns
    0-1 of ``got``) against the multiphase density kernel's on the same
    operands, each at its own G: bit for bit, or the largest difference."""
    from nereus_tpu_torch.ops import cuda_sweep
    dout = cuda_sweep.multiphase_density_sweep(cfg, *args)
    groups = (cuda_sweep.MP_DENSITY_ALPHA_G,
              cuda_sweep.density_group(args[0].shape[0]))
    diff = float((got[:, :2] - dout).abs().max())
    same = bool(torch.equal(got[:, :2], dout))
    print(f"  {label}: δ and Σψ_bW against the multiphase density "
          f"kernel's (G {groups[0]} / {groups[1]}): "
          + ("bit for bit" if same else f"max|d| {diff:.3g} of max δ "
             f"{float(dout[:, 0].max()):.6g}"))


def check_models(ops, keys, label):
    """The kernels ``keys`` of ``ops`` (``{key: (kernel, plain, args,
    kwargs)}``, a path's operands) against their plain versions under each
    (kernel set, surface-tension model) of ``MODELS``, as
    :func:`compare_kernels` holds them."""
    import nereus_tpu_torch as nt
    for ks, st in MODELS:
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           surface_tension_model=nt.SurfaceTensionModel[st])
        compare_kernels(cfg, ops, f"{label}, {ks}+{st}", keys=keys)


def check_lambda(got, ref, pvec, label):
    """The λ kernel's (ρ, λ) against its plain version's: λ within
    FORCE_TOL·max|λ| plus what the two ρ's difference and two float32 ulps
    of ρ/ρ₀ make of it (λ = −max(ρ/ρ₀ − 1, 0)/(denom + ε) resolves ρ/ρ₀
    to its ulp, over ε), and finite. ρ is held by :func:`compare_kernels`'
    column check. A state under ρ₀ everywhere has λ = 0, and the check
    then holds the clamp alone: phase 17 gates λ < 0 on its operands."""
    from nereus_tpu_torch.ops.sph_pairs import PV_PBF_EPS, PV_RD
    rd, eps = float(pvec[PV_RD]), float(pvec[PV_PBF_EPS])
    floor = ((got[:, 0] - ref[:, 0]).abs()
             + 2.0 * float(np.finfo(np.float32).eps) * ref[:, 0]) / rd / eps
    err = (got[:, 1] - ref[:, 1]).abs()
    scale = float(ref[:, 1].abs().max())
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: kernel output not finite")
    if not bool((err <= FORCE_TOL * scale + floor).all()):
        fail(f"{label}: λ max|d| {float(err.max()):.3g} > {FORCE_TOL}·"
             f"max|λ| {scale:.3g} + the ρ rounding floor")
    print(f"  {label}: λ max|d| {float(err.max()):.3g}/{scale:.4g} (floor "
          f"≤ {float(floor.max()):.3g}), min λ {float(ref[:, 1].min()):.4g}")


TILE_SIZES = (64, 128, 256)


def tile_stats(key, kern, cfg, args, got):
    """The tile plan of a row-tiled kernel's op (T, tiles, CTAs, non-empty
    spans, every one walked from device memory) and the kernel's time with
    each tile size of ``TILE_SIZES``, the default's included, timed alike:
    three rounds, each timing every size in turn over 20 launches, the
    best round per size. Each plan must give ``got`` bit for bit: the
    order of summation does not depend on the tiling."""
    from nereus_tpu_torch.ops import cuda_sweep
    plan, ctx = kern.keywords["plan"], kern.ctx
    sp = cuda_sweep.tile_spans(plan, args[2], args[3])
    stats = {"tile": plan.tile, "tiles": int(plan.n_tiles[0]),
             "ctas": plan.n_ctas, "spans": int((sp[..., 1] > 0).sum()),
             "tile_ms": {}}
    runs = {}
    for tile in TILE_SIZES:
        f = functools.partial(kern.func, plan=cuda_sweep.tile_plan(
            ctx.sorted_hash, ctx.grid_size, tile=tile))
        if not torch.equal(f(cfg, *args), got):
            fail(f"{key}: the tiled kernel with T = {tile} differs from "
                 f"its result with the default plan")
        runs[tile] = f
    for _ in range(3):
        for tile, f in runs.items():
            ms = graph_ms(lambda: f(cfg, *args))
            stats["tile_ms"][tile] = min(stats["tile_ms"].get(tile, ms), ms)
    print(f"  {key} tiles: T {plan.tile}, {stats['tiles']} tiles in "
          f"{plan.n_ctas} CTAs, {stats['spans']} non-empty spans per launch,"
          f" all walked from device memory; by tile size, bit-identical: "
          + ", ".join(f"T{k} {v:.4f} ms"
                      for k, v in stats["tile_ms"].items()))
    return stats


def small_dam_break(nt, params, cfg, dev):
    """Phase 3's ~32k-particle dam-break: floor 0.04 under the bottom
    layer (inside the kernel support), seeded velocities in ±0.5 m/s."""
    from nereus_tpu_torch import scene
    spacing = float(params.interaction_radius) - 0.005
    side = spacing * SMALL_N ** (1.0 / 3.0)
    # bottom layer at y = 0.04 - side/2; floor 0.04 below it
    floor = 0.04 - side / 2.0 - 0.04
    state, grid, boundary = scene.dam_break(
        params, cfg, cube_size=(side,) * 3, cube_center=(-0.4, 0.04, 0.5),
        box_min=(-1.2, floor, -0.5), box_max=(0.8, 1.5, 1.5), device=dev)
    pos = state.pos.cpu().numpy()
    vel = np.random.default_rng(0).uniform(-0.5, 0.5, pos.shape)
    return nt.make_fluid_state(pos, vel, device=dev), grid, boundary


def settled_main_path(solver, dev, n_target):
    """The settled block of ``bench.py``'s ``*_settled`` cells for
    ``solver`` (iisph, pcisph, dfsph, dfsph_visc: implicit viscosity at
    ν = ``VISC_NU``, dfsph_mp: the block split by :func:`two_phase`, or
    dfsph_wavemaker: the DFSPH block, whose walls
    :func:`run_settled_path` moves), built as ``bench.py:376-449`` builds
    it: ``(cfg, params, state, grid,
    boundary, step)`` with ``step(state) -> (state, diag)`` at the cell's
    tolerances."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    if solver == "iisph":
        base = nt.iisph_params(device=dev)
    elif solver == "pcisph":
        base = nt.calibrate_mass(nt.pcisph_params(device=dev), cfg)
    elif solver == "dfsph_visc":
        cfg = nt.SimConfig(viscosity_model="implicit")
        base = nt.dfsph_params(viscosity=VISC_NU, device=dev)
    else:
        base = nt.dfsph_params(device=dev)
    spacing = 0.8 * float(base.interaction_radius)
    params = nt.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=n_target, spacing=spacing, impact_velocity=-1.0,
        device=dev)
    if solver == "dfsph_mp":
        state = two_phase(state, params)
    if solver == "iisph":
        def step(s):
            return nt.iisph_step(s, params, grid, cfg, boundary,
                                 tol=IISPH_TOL, omega=IISPH_OMEGA)
    elif solver == "pcisph":
        delta = nt.pcisph_delta(params, cfg)

        def step(s):
            return nt.pcisph_step(s, params, grid, cfg, boundary,
                                  delta=delta, tol_frac=PCISPH_TOL_FRAC)
    else:
        def step(s):
            return nt.dfsph_step(s, params, grid, cfg, boundary,
                                 tol=DFSPH_TOL, tol_v=DFSPH_TOL)
    return cfg, params, state, grid, boundary, step


def pbf_block(cfg, dev, n_target, lattice=0.8):
    """The settled block of ``bench.py``'s ``pbf_256k_settled`` at
    ``n_target`` particles: ``pbf_params()`` calibrated twice, the second
    time to the 0.8·h lattice (``bench.py:392-393, 399-403``), impact
    velocity −1 m/s, seeded at ``lattice``·h. Returns ``(cfg, params,
    state, grid, boundary)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    base = nt.calibrate_mass(nt.pbf_params(device=dev), cfg)
    h = float(base.interaction_radius)
    params = nt.calibrate_mass(base, cfg, spacing=0.8 * h)
    state, grid, boundary = scene.resting_block(
        params, cfg, n_target=n_target, spacing=lattice * h,
        impact_velocity=-1.0, device=dev)
    return cfg, params, state, grid, boundary


def pbf_main_path(dev, settled=False):
    """The PBF cells' scenes: ``pbf_1M`` (``bench.py:355``, built as
    ``bench.py:392-393, 112``: ``dam_break(calibrate_mass(pbf_params()),
    n_target=2**20)``, here with its boundary shell) or, ``settled``,
    ``pbf_256k_settled``. Returns ``(cfg, params, state, grid,
    boundary)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    if settled:
        return pbf_block(cfg, dev, SETTLED_N)
    params = nt.calibrate_mass(nt.pbf_params(device=dev), cfg)
    state, grid, boundary = scene.dam_break(params, cfg, n_target=MAIN_N,
                                            device=dev)
    return cfg, params, state, grid, boundary


def run_steps(step, state, n_steps, timed_from, loops=()):
    """``n_steps`` calls of ``step`` from ``state``, the steps after
    ``timed_from`` timed with CUDA events; returns ``(state, diags,
    ms/step, window, ends)`` with ``window`` the (launched, syncs) of each
    of ``loops`` (``LoopCounts``) over the timed steps and ``ends`` each
    step's last run of each loop (``LoopCounts.last``)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    diags, at, ends = [], [], []
    for i in range(n_steps):
        if i == timed_from:
            start.record()
            at = [(lp.launched, lp.syncs) for lp in loops]
        state, diag = step(state)
        diags.append(diag)
        ends.append([lp.last for lp in loops])
    end.record()
    torch.cuda.synchronize()
    window = [(lp.launched - a, lp.syncs - s)
              for lp, (a, s) in zip(loops, at)]
    return (state, diags, start.elapsed_time(end) / (n_steps - timed_from),
            window, ends)


def check_launches(label, want):
    """Fails unless every kernel launched as ``want`` says (``{Kernel:
    count}``; a kernel not named must not have launched)."""
    from nereus_tpu_torch.ops import cuda_sweep
    for k in cuda_sweep.KERNELS:
        if k.launches != want.get(k, 0):
            fail(f"{label}: {k.name} launched {k.launches} times, expected "
                 f"{want.get(k, 0)}")


def check_loop_ends(name, loops, ends):
    """Fails unless every run of each loop of ``loops`` (``{label:
    LoopCounts}``) recorded in ``ends`` (one list of ``LoopCounts.last``
    per step, :func:`run_steps`) ended within its own tolerance or at its
    own cap, compared as the loop compares."""
    for j, label in enumerate(loops):
        runs = [e[j] for e in ends]
        its = torch.stack([r.it for r in runs]).cpu().numpy()
        bad = torch.stack([(r.err > r.tol) & (r.it < r.max_iters)
                           for r in runs]).cpu().numpy()
        print(f"{name} {label} loop: iterations per step {its.tolist()}, "
              f"final error last {float(runs[-1].err):.6g} (tol "
              f"{float(runs[-1].tol):.6g}, cap {runs[-1].max_iters})")
        if bad.any():
            fail(f"{name}: {label} loop of steps "
                 f"{np.flatnonzero(bad).tolist()} ends above its tol before "
                 "its max iterations")


def print_cg(name, cg, ends, window, steps, timed):
    """The CG loop's iterations launched and converged (the last of
    ``ends`` per step), in all and per timed step, and its host syncs."""
    its = torch.stack([e[-1].it for e in ends]).cpu().numpy()
    print(f"{name}: CG iterations launched / converged {cg.launched} / "
          f"{int(its.sum())} in {steps} steps; over the last {timed} steps "
          f"per step: launched {window[-1][0] / timed:.4g}, converged "
          f"{float(its[-timed:].mean()):.4g}, host syncs "
          f"{window[-1][1] / timed:.4g}")


def run_settled_path(solver, dev, loops, cg=None):
    """Phases 8, 9, 15, 16 and 24: ``SETTLED_N`` block, ``IMPLICIT_STEPS``
    steps, gates; ``loops`` names the solver's loops (``{name:
    LoopCounts}``), ``cg`` the implicit viscosity solve's loop (its
    iterations are not in ``solver_iters``); ``dfsph_wavemaker`` moves the
    walls as the CLI's ``--wavemaker`` does (:func:`wavemaker`). Returns
    ``(cfg, params, state, grid, boundary, iters, launches)``, the grid and
    walls of the last step."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    t0 = time.perf_counter()
    cfg, params, state, grid, boundary, step = settled_main_path(
        solver, dev, SETTLED_N)
    moving = solver.endswith("_wavemaker")
    if moving:
        # the CLI's --wavemaker on the settled block: the walls move every
        # step (pcisph/iisph/dfsph take it alike; DFSPH here)
        grid, bd_at = wavemaker(grid, boundary, params)

        def step(s):
            return nt.dfsph_step(s, params, grid, cfg, bd_at(),
                                 tol=DFSPH_TOL, tol_v=DFSPH_TOL)
    torch.cuda.synchronize()
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    name = solver.upper()
    print(f"{name} main path: resting_block n_target={SETTLED_N}: {n} "
          f"fluid particles, {boundary.num_boundaries} boundary samples, "
          f"grid {grid.size}, dt {float(params.dt)}, mass "
          f"{float(params.particle_mass):.6g}, viscosity "
          f"{float(params.viscosity):.6g} ({cfg.viscosity_model}), floor y "
          f"{floor:.6g}; set-up {time.perf_counter() - t0:.1f} s")
    if n != SETTLED_FLUID:
        fail(f"{name}: expected {SETTLED_FLUID:,} fluid particles, got {n}")
    all_loops = {**loops, **({"CG": cg} if cg is not None else {})}
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    for lp in all_loops.values():
        lp.reset()
    t_host = time.perf_counter()
    state, diags, ms, window, ends = run_steps(
        step, state, IMPLICIT_STEPS, IMPLICIT_TIMED_FROM,
        tuple(all_loops.values()))
    t_host = time.perf_counter() - t_host
    timed = IMPLICIT_STEPS - IMPLICIT_TIMED_FROM
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    iters = torch.stack([d.solver_iters for d in diags]).cpu().numpy()
    errs = torch.stack([d.mean_density_error for d in diags]).cpu().numpy()
    launched = sum(lp.launched for lp in loops.values())
    pos = state.pos[:n]
    min_y = float(pos[:, 1].min())
    early = float(iters[:IMPLICIT_TIMED_FROM].mean())
    v5e = V5E_ITERS_1_10.get(solver)
    print(f"{name} main path: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; "
          f"steps {IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"{name} main path: solver_iters per step {iters.tolist()}; mean "
          f"steps 1-{IMPLICIT_TIMED_FROM} {early:.4g}"
          + (f" (JAX package on the v5e, BASELINE.md: {v5e})" if v5e else "")
          + f", steps {IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS} "
          f"{float(iters[IMPLICIT_TIMED_FROM:].mean()):.4g}")
    print(f"{name} main path: iterations launched / converged "
          + ", ".join(f"{lp.launched}" for lp in loops.values())
          + f" / {int(iters.sum())} in {IMPLICIT_STEPS} steps; over steps "
          f"{IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: launched "
          f"{sum(w[0] for w in window[:len(loops)]) / timed:.4g}, host syncs "
          f"{sum(w[1] for w in window) / timed:.4g} per step")
    if cg is not None:
        print_cg(f"{name} main path", cg, ends, window, IMPLICIT_STEPS, timed)
    print(f"{name} main path: launches {launches}, min y {min_y:.6g}, "
          f"mean_density_error last {errs[-1]:.6g} max {errs.max():.6g}, "
          f"min pressure {float(state.pressure.min()):.6g}, max pressure "
          f"{float(state.pressure.max()):.6g}")
    check_loop_ends(name, all_loops, ends)
    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{name}: non-finite positions")
    if min_y < floor:
        fail(f"{name}: floor penetration: min y {min_y} < floor {floor}")
    if float(state.pressure.min()) < 0.0:
        fail(f"{name}: negative pressure")
    if launched < int(iters.sum()):
        fail(f"{name}: {launched} iterations launched for "
             f"{int(iters.sum())} converged")
    if state.multiphase:
        light = state.rho0[:n] < 0.5 * float(params.rest_density)
        y_light = float(pos[light, 1].mean())
        y_heavy = float(pos[~light, 1].mean())
        print(f"{name} main path: {int(light.sum())} particles at "
              f"{MP_RATIO}·ρ₀, mean y light {y_light:.6g} heavy "
              f"{y_heavy:.6g}")
        if not y_light > y_heavy:
            fail(f"{name}: light phase's mean height {y_light} not above "
                 f"the heavy phase's {y_heavy}")
    steps = IMPLICIT_STEPS
    if solver == "pcisph":
        # the warm sweep runs on every step (PCISPH warm start on)
        want = {cuda_sweep.DENSITY: steps, cuda_sweep.FORCE_P0: steps,
                cuda_sweep.DENSITY_PRED: launched,
                cuda_sweep.PRESSURE_FORCE: launched + steps}
    elif solver == "dfsph_mp":
        # the warm κ̂ is applied on every step (DFSPH warm start on)
        want = {cuda_sweep.MP_DENSITY_ALPHA: steps,
                cuda_sweep.MP_FORCE: steps, cuda_sweep.MP_DRHO: launched,
                cuda_sweep.MP_KAPPA: launched + steps}
    else:
        # the warm κ is applied on every step (DFSPH warm start on); the
        # implicit viscosity solve runs its Laplacian once for r0 and once
        # per launched CG iteration, after the force without viscosity
        want = {cuda_sweep.DENSITY_ALPHA: steps, cuda_sweep.DRHO: launched,
                cuda_sweep.PRESSURE_FORCE: launched + steps}
        if cg is None:
            want[cuda_sweep.FORCE_P0_MOVING if moving
                 else cuda_sweep.FORCE_P0] = steps
        else:
            want[cuda_sweep.FORCE_P0_V0] = steps
            want[cuda_sweep.VISC_LAPLACIAN] = cg.launched + steps
    check_launches(f"{name} main path", want)
    if moving:
        boundary, off = bd_at.last
        print(f"{name} main path: last wall offset {float(off):.6g} m")
    return cfg, params, state, grid, boundary, iters, launches


def run_pbf_path(name, scene, n_steps, timed_from, **kw):
    """``n_steps`` ``pbf_step`` calls on ``scene`` (``(cfg, params, state,
    grid, boundary)``) with ``kw`` (``xsph_eps``, ``vorticity_eps``), the
    steps after ``timed_from`` timed with CUDA events. Gates: λ and Δp
    launched ``pbf_iters`` times per step, N and ω once with vorticity
    confinement, XSPH once with its option, no other kernel;
    ``solver_iters`` = ``pbf_iters``; zero overflow; finite positions;
    nothing below the floor; mean compression < 0.1 on every step.
    Returns ``(state, launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    cfg, params, state, grid, boundary = scene
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    print(f"{name}: {n} fluid particles, {boundary.num_boundaries} boundary "
          f"samples, grid {grid.size}, dt {float(params.dt)}, mass "
          f"{float(params.particle_mass):.6g}, pbf_iters {cfg.pbf_iters}, "
          f"options {kw}, floor y {floor:.6g}")
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diags, ms, _, _ = run_steps(
        lambda s: nt.pbf_step(s, params, grid, cfg, boundary, **kw), state,
        n_steps, timed_from)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    mcs = torch.stack([d.mean_compression for d in diags]).cpu().numpy()
    iters = torch.stack([d.solver_iters for d in diags]).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    min_y = float(state.pos[:n, 1].min())
    print(f"{name}: {n_steps} steps in {t_host:.2f} s host; steps "
          f"{timed_from + 1}-{n_steps}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, min y "
          f"{min_y:.6g}, mean_compression max {mcs.max():.6g} (step "
          f"{int(mcs.argmax()) + 1}) last {mcs[-1]:.6g}, max_density last "
          f"{float(diags[-1].max_density):.6g}, min λ "
          f"{float(state.pressure.min()):.6g}")
    it = cfg.pbf_iters
    want = {cuda_sweep.PBF_LAMBDA: n_steps * it,
            cuda_sweep.PBF_DP: n_steps * it}
    if kw.get("vorticity_eps") is not None:
        want[cuda_sweep.PBF_OMEGA] = n_steps
        want[cuda_sweep.PBF_GRAD] = n_steps
    if kw.get("xsph_eps") is not None:
        want[cuda_sweep.XSPH] = n_steps
    check_launches(name, want)
    if (iters != it).any():
        fail(f"{name}: solver_iters {sorted(set(iters.tolist()))} != "
             f"pbf_iters {it}")
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{name}: non-finite positions")
    if min_y < floor:
        fail(f"{name}: floor penetration: min y {min_y} < floor {floor}")
    if not mcs.max() < 0.1:
        fail(f"{name}: mean_compression {mcs.max()} >= 0.1 at step "
             f"{int(mcs.argmax()) + 1}")
    return state, launches


def wavemaker(grid, boundary, params):
    """The CLI's ``--wavemaker x:0.05:2`` (``nereus_tpu/app/cli.py:285-297,
    776-788``): the grid widened by A + cell along the axis and the wall
    set re-sorted against it; returns ``(grid, bd_at)`` with ``bd_at()``
    the wall set moved to the current time (offset A·sin ωt, velocity
    A·ω·cos ωt along the axis), which then advances the time by dt. The
    time stays on the device: no host synchronisation per step."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.boundary import move_boundary, rehash_boundary
    axis, amp, freq = WAVEMAKER
    cell = float(grid.cell[0])
    lo = grid.origin.double().cpu().numpy()
    hi = lo + np.asarray(grid.size, np.float64) * cell
    pad = np.zeros(3)
    pad[axis] = amp + cell
    dev = grid.origin.device
    grid = nt.fit_grid(lo - pad, hi + pad, cell, device=dev)
    boundary = rehash_boundary(boundary, grid)
    om = 2.0 * np.pi * freq
    unit = torch.zeros(3, device=dev)
    unit[axis] = 1.0
    clock = {"t": torch.zeros((), device=dev)}

    def bd_at():
        t = clock["t"]
        bd = move_boundary(boundary, grid,
                           offset=unit * (amp * torch.sin(om * t)),
                           velocity=unit * (amp * om * torch.cos(om * t)))
        clock["t"] = t + params.dt
        bd_at.last = (bd, amp * torch.sin(om * t))
        return bd
    return grid, bd_at


def run_wavemaker(name, scene):
    """``N_STEPS`` WCSPH steps of ``scene`` (``(cfg, params, state, grid,
    boundary)``; a multiphase state runs the multiphase step) under the
    wavemaker, the steps after ``TIMED_FROM`` timed. Gates: the density
    and the MOVING force kernel (multiphase: MultiphaseForce<MOVING>) once
    per step and no other kernel, zero overflow, finite positions, no
    active particle outside the moved box by more than h, mean compression
    < 0.1 on every step. Returns ``(state, grid, last moved walls, ms,
    launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    cfg, params, state, grid, boundary = scene
    grid, bd_at = wavemaker(grid, boundary, params)
    n = int(state.num_active)
    h = float(params.interaction_radius)
    box_lo = boundary.pos.min(dim=0).values.cpu().numpy()
    box_hi = boundary.pos.max(dim=0).values.cpu().numpy()
    axis, amp, freq = WAVEMAKER
    print(f"{name}: {n} fluid particles, {boundary.num_boundaries} wall "
          f"samples, grid widened to {grid.size}, wavemaker axis {axis} "
          f"amplitude {amp} m at {freq} Hz, multiphase {state.multiphase}")
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diags, ms, _, _ = run_steps(
        lambda s: nt.wcsph_step(s, params, grid, cfg, bd_at()), state,
        N_STEPS, TIMED_FROM)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    bd, off = bd_at.last
    off = float(off)
    mcs = torch.stack([d.mean_compression for d in diags]).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    pos = state.pos[:n].cpu().numpy()
    shift = np.zeros(3)
    shift[axis] = off
    out = float(np.maximum(box_lo + shift - pos, pos - box_hi - shift).max())
    print(f"{name}: {N_STEPS} steps in {t_host:.2f} s host; steps "
          f"{TIMED_FROM + 1}-{N_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, last "
          f"wall offset {off:.6g} m, largest distance outside the moved box "
          f"{out:.6g} (h {h:.6g}), mean_compression max {mcs.max():.6g} "
          f"last {mcs[-1]:.6g}")
    if state.multiphase:
        want = {cuda_sweep.MP_DENSITY: N_STEPS,
                cuda_sweep.MP_FORCE_MOVING: N_STEPS}
    else:
        want = {cuda_sweep.DENSITY: N_STEPS,
                cuda_sweep.FORCE_MOVING: N_STEPS}
    check_launches(name, want)
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail(f"{name}: non-finite positions")
    if out > h:
        fail(f"{name}: a particle lies {out} outside the moved box")
    if not mcs.max() < 0.1:
        fail(f"{name}: mean_compression {mcs.max()} >= 0.1 at step "
             f"{int(mcs.argmax()) + 1}")
    return state, grid, bd, ms, launches


def coupled_scene(dev, multiphase):
    """``bench.py:200-237``'s mp_coupled_256k (``multiphase``) or its
    single-phase twin (the CLI's ``--rigid-box`` on the same block):
    ``resting_block(n_target=256_000)`` under ``make_params()`` calibrated
    to the 0.8·h lattice, impact velocity −1 m/s, with its wall shell;
    multiphase: split at the median height, the top half at 0.4·ρ₀; a
    0.15 m box of 600 kg/m³ centred over the block, ``BODY_DROP`` above the
    water. Returns ``(cfg, params, state, grid, walls, body)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    cfg = nt.SimConfig()
    base = nt.make_params(device=dev)
    spacing = 0.8 * float(base.interaction_radius)
    params = nt.calibrate_mass(base, cfg, spacing=spacing)
    state, grid, walls = scene.resting_block(
        params, cfg, n_target=COUPLED_N, spacing=spacing,
        impact_velocity=-1.0, device=dev)
    if multiphase:
        state = two_phase(state, params, ratio=COUPLED_RATIO)
    n = int(state.num_active)
    posf = state.pos[:n]
    center = (float(posf[:, 0].mean()),
              float(posf[:, 1].max()) + BODY_DROP, float(posf[:, 2].mean()))
    body = nt.make_rigid_box(center, (BODY_SIZE,) * 3,
                             float(params.particle_radius), BODY_DENSITY,
                             params, device=dev)
    return cfg, params, state, grid, walls, body


def run_coupled(name, dev, multiphase):
    """``IMPLICIT_STEPS`` coupled steps of :func:`coupled_scene`, steps
    after ``IMPLICIT_TIMED_FROM`` timed, after its body kernels were held
    against their plain versions on the first step's operands, and on
    their friction alone (:func:`check_body_friction`). Gates: per
    step one density, force, body density and body contact launch of the
    phase's kernels and no other; zero overflow; finite fluid and body
    state; R orthonormal within 1e-5 on every step; the body's centre above
    the floor; mean compression < 0.1 on every step. Returns ``(timing,
    launches)``, the timing of every kernel of the path (the body kernels
    on the first step's operands, the others on the last step's), and the
    dense body-wall contact timed apart."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.rigid import wall_contact_force
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    t0 = time.perf_counter()
    cfg, params, state, grid, walls, body = coupled_scene(dev, multiphase)
    n = int(state.num_active)
    floor = float(walls.pos[:, 1].min())
    print(f"{name}: {n} fluid particles, {walls.num_boundaries} wall "
          f"samples, body of {body.num_samples} samples at "
          f"{body.com.tolist()} ({BODY_DENSITY} kg/m³, {BODY_SIZE} m), "
          f"grid {grid.size}, dt {float(params.dt)}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    ops = coupled_operands(cfg, ctx, params, grid, body)
    body_keys = [k for k in ops if k.startswith(("body", "mp_body"))]
    compare_kernels(cfg, ops, f"{name} first step", keys=body_keys)
    check_body_friction(cfg, ctx, params, grid, body,
                        f"{name} first step, friction alone")
    held = {"body": body}
    coms, orth = [], []

    def step(s):
        s, held["body"], d = nt.wcsph_coupled_step(s, params, grid, cfg,
                                                   held["body"], walls)
        b = held["body"]
        coms.append(b.com)
        eye = torch.eye(3, device=b.R.device)
        orth.append((b.R @ b.R.T - eye).abs().max())
        return s, d
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diags, ms, _, _ = run_steps(step, state, IMPLICIT_STEPS,
                                       IMPLICIT_TIMED_FROM)
    t_host = time.perf_counter() - t_host
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    body = held["body"]
    mcs = torch.stack([d.mean_compression for d in diags]).cpu().numpy()
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    com_y = torch.stack(coms)[:, 1].cpu().numpy()
    orth = float(torch.stack(orth).max())
    print(f"{name}: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; steps "
          f"{IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"{name}: launches {launches}, seg_overflow max {overflow}, body "
          f"com {body.com.tolist()} vel {body.vel.tolist()} omega "
          f"{body.omega.tolist()}, min com y {com_y.min():.6g} (floor "
          f"{floor:.6g}), max |R Rᵀ − I| {orth:.3g}, mean_compression max "
          f"{mcs.max():.6g} last {mcs[-1]:.6g}")
    steps = IMPLICIT_STEPS
    if multiphase:
        want = {cuda_sweep.MP_DENSITY: steps, cuda_sweep.MP_FORCE: steps,
                cuda_sweep.BODY_DENSITY: steps, cuda_sweep.MP_BODY: steps}
    else:
        want = {cuda_sweep.DENSITY: steps, cuda_sweep.FORCE: steps,
                cuda_sweep.BODY_DENSITY: steps,
                cuda_sweep.BODY_FORCE: steps}
    check_launches(name, want)
    if overflow != 0:
        fail(f"{name}: seg_overflow {overflow}")
    finite = [bool(torch.isfinite(t).all()) for t in (
        state.pos, body.com, body.vel, body.omega, body.R)]
    if not all(finite):
        fail(f"{name}: non-finite fluid or body state {finite}")
    if not orth < 1e-5:
        fail(f"{name}: R drifts from orthonormal by {orth}")
    if not com_y.min() > floor:
        fail(f"{name}: the body's centre {com_y.min()} below the floor")
    if not mcs.max() < 0.1:
        fail(f"{name}: mean_compression {mcs.max()} >= 0.1 at step "
             f"{int(mcs.argmax()) + 1}")
    # the body kernels on the first step's operands (the body meets the
    # water in the first step and has left it by the last), the fluid
    # kernels on the last step's (the block reaches the walls only then)
    timing = compare_kernels(cfg, ops, f"{name} first-step operands",
                             keys=body_keys, time_it=True)
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    last = coupled_operands(cfg, ctx, params, grid, body)
    timing.update(compare_kernels(
        cfg, last, f"{name} after {IMPLICIT_STEPS} steps",
        keys=[k for k in last if k not in body_keys], time_it=True))
    walls_ms = events_ms(lambda: wall_contact_force(
        body, walls, params, kernel_set=cfg.kernel_set), 20)
    print(f"{name}: dense body-wall contact ({body.num_samples} × "
          f"{walls.num_boundaries} pairs) {walls_ms:.4f} ms per call")
    return timing, launches


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


def run_wcsph(cfg, params, state, grid, boundary, xsph_eps=None):
    """``N_STEPS`` WCSPH steps from ``state`` (with ``xsph_eps``; a
    multiphase state runs the multiphase step), the steps after
    ``TIMED_FROM`` timed with CUDA events; returns ``(state, diag,
    ms/step, max seg_overflow)``."""
    import nereus_tpu_torch as nt
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    overflow = torch.zeros((), dtype=torch.int32, device=state.pos.device)
    for i in range(N_STEPS):
        if i == TIMED_FROM:
            start.record()
        state, diag = nt.wcsph_step(state, params, grid, cfg, boundary,
                                    xsph_eps=xsph_eps)
        overflow = torch.maximum(overflow, diag.seg_overflow)
    end.record()
    torch.cuda.synchronize()
    return (state, diag, start.elapsed_time(end) / (N_STEPS - TIMED_FROM),
            int(overflow))


def flat_bound(nbytes, ops):
    """(bound_ms, bound_by, bound_ranges_ms) of a kernel that reads no
    range rows: ``nbytes`` over 3.35 TB/s against ``ops`` over 67 TFLOP/s."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    b = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return b + (b[0],)


def cell_check_entry(cfg, ctx, grid, label):
    """The cell check kernel against its plain version on ``ctx``'s queries,
    timed: (max_abs_err, ms, plain_ms, bound...); fails on any mismatch."""
    from nereus_tpu_torch.probes import cells
    from nereus_tpu_torch.ops import cuda_sweep
    q = ctx.queries(width=4)
    got = cuda_sweep.cell_check(q, ctx.pvec, grid)
    ref = cells.cell_coords_plain(q, ctx.pvec, grid)
    err = int((got - ref).abs().max())
    if err:
        fail(f"{label}: cell check kernel vs grid.cell_coords_cols max|d| "
             f"{err}")
    print(f"  {label}: cell check kernel equal to its plain version on "
          f"{q.shape[0]} queries")
    nbytes = sum(t.numel() * t.element_size() for t in (q, ctx.pvec, got))
    # per query and axis: subtract, multiply, floor, max, min, convert
    times = time_turns("cell_check",
                       lambda: cuda_sweep.cell_check(q, ctx.pvec, grid),
                       lambda: cells.cell_coords_plain(q, ctx.pvec, grid))
    return (float(err), *times, *flat_bound(nbytes, 18 * q.shape[0]))


def wide_main_path(dev, stretch=True):
    """``(cfg, params, state, grid, None)`` of ``wcsph_wide12M``: the
    ``WIDE_N`` dam-break without a boundary on ``bench.py``'s grid
    stretched along z past 2²⁴ cells (``probes.cells.stretch_grid``;
    ``stretch=False``: the compact grid it was built on)."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    from nereus_tpu_torch.probes import cells
    cfg = nt.SimConfig()
    params = nt.make_params(device=dev)
    state, grid, _ = scene.dam_break(params, cfg, n_target=WIDE_N,
                                     with_boundary=False, device=dev)
    return (cfg, params, state,
            cells.stretch_grid(grid) if stretch else grid, None)


def run_wide(dev):
    """Phase 35, ``wcsph_wide12M``: the 12M dam-break without a boundary on
    ``bench.py``'s stretched grid (gx, gy and the origin kept, gz past
    2²⁴ cells), through ``wcsph_step``; the cell check on the first and the
    last state; the stretch A/B (bit-identical) and the ``pad_below`` A/B
    (hashes past 2²⁴, within ``PAD_TOL``); then the density, force and cell
    check kernels against their plain versions at these shapes. Returns
    ``(timing, launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.probes import cells
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    t0 = time.perf_counter()
    cfg, params, state0, grid, _ = wide_main_path(dev, stretch=False)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    wide = cells.stretch_grid(grid)
    n = int(state0.num_active)
    cells_n = int(np.prod(wide.size))
    print(f"wcsph_wide12M: {n} fluid particles, grid {grid.size} stretched "
          f"to {wide.size} = {cells_n} cells (2^24 = {cells.HASH24}); "
          f"set-up (lattice, state on the card) {t_setup:.1f} s")
    if cells_n <= cells.HASH24:
        fail(f"wcsph_wide12M: {cells_n} cells, not past 2^24")
    torch.cuda.reset_peak_memory_stats()
    cuda_sweep.reset_launches()
    bad0 = cells.cellcheck(state0, params, wide, cfg)
    state = state0
    for _ in range(WIDE_WARMUP):
        state, diag = nt.wcsph_step(state, params, wide, cfg, None)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(WIDE_TIMED):
        state, diag = nt.wcsph_step(state, params, wide, cfg, None)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / WIDE_TIMED
    bad1 = cells.cellcheck(state, params, wide, cfg)
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steps = WIDE_WARMUP + WIDE_TIMED
    print(f"wcsph_wide12M: steps {WIDE_WARMUP + 1}-{steps}: {ms:.4f} "
          f"ms/step = {n / (ms * 1e-3):.4g} particle-steps/s; peak memory "
          f"{peak / 2**30:.3f} GiB ({peak} bytes); cell check mismatches "
          f"{bad0} (first state), {bad1} (last state); max_density "
          f"{float(diag.max_density):.6g}, mean_compression "
          f"{float(diag.mean_compression):.6g}")
    check_launches("wcsph_wide12M", {cuda_sweep.DENSITY: steps,
                                     cuda_sweep.FORCE: steps,
                                     cuda_sweep.CELL_CHECK: 2})
    if bad0 or bad1:
        fail(f"wcsph_wide12M: cell check mismatches {bad0}, {bad1}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("wcsph_wide12M: non-finite positions")
    d, identical = cells.steps_ab(state0, params, grid, wide, cfg,
                                  WIDE_AB_STEPS)
    print(f"wcsph_wide12M: {WIDE_AB_STEPS} steps compact {grid.size} vs "
          f"stretched {wide.size}: max|dpos| {d:.6g} m, bit-identical "
          f"{identical}")
    if not identical:
        fail(f"wcsph_wide12M: the stretched grid's positions differ from "
             f"the compact grid's by {d} m (same hashes: expected 0)")
    k = cells.HASH24 // (grid.size[0] * grid.size[1]) + 1
    padded = cells.pad_below(grid, k)
    d, identical = cells.steps_ab(state0, params, grid, padded, cfg,
                                  WIDE_AB_STEPS)
    print(f"wcsph_wide12M: {WIDE_AB_STEPS} steps compact vs pad_below {k} "
          f"({padded.size}, origin z {float(padded.origin[2]):.6g}, every "
          f"hash >= {k * grid.size[0] * grid.size[1]}): max|dpos| {d:.6g} "
          f"m, bit-identical {identical}")
    if not d <= PAD_TOL:
        fail(f"wcsph_wide12M: pad_below max|dpos| {d} > {PAD_TOL} m")
    del state0
    ctx = build_sweep_ctx(state, params, wide, cfg, None)
    timing = compare(cfg, ctx, params, f"wcsph_wide12M after {steps} steps",
                     time_it=True)
    timing["cell_check"] = cell_check_entry(cfg, ctx, wide,
                                            "wcsph_wide12M")
    return timing, launches


def unsorted(new_state, perm):
    """``new_state``'s positions and velocities back in the order of the
    state the step started from."""
    return (torch.empty_like(new_state.pos).index_copy_(0, perm,
                                                        new_state.pos),
            torch.empty_like(new_state.vel).index_copy_(0, perm,
                                                        new_state.vel))


def emit_patch(params):
    """The CLI's ``--emit`` patch at ``EMIT_AT``: 3×3 particles two radii
    apart, across the velocity's dominant axis (y)."""
    sp = 2.0 * float(params.particle_radius)
    return np.asarray([[EMIT_AT[0] + a, EMIT_AT[1], EMIT_AT[2] + b]
                       for a in (-sp, 0.0, sp) for b in (-sp, 0.0, sp)],
                      np.float32)


def run_lifecycle(dev):
    """Phase 36, ``wcsph_1M_lifecycle``: the ``wcsph_1M`` cell at capacity
    factor 2 on a grid ``REFIT_PAD`` wider than its walls (the first refit
    shrinks it to the walls' box, a new origin and extent; the later ones
    give that box back), 200 steps with the CLI's lifecycle options: the
    3×3 emitter patch every 10 steps (``add_particles_traced``), a drop
    cube every 100
    (``add_particles``), a drain plane every step (``remove_particles``),
    and every 50 steps ``refit_grid`` + ``rehash_boundary``, in the CLI's
    order (refit, emit, drop, step, drain). Gates: finite; emit overflow
    0 (read once, at the end); the final live count equals the start's +
    emitted + dropped − drained, counted apart; drained > 0; after each
    refit every live particle inside the new grid and the cell check 0; at
    the first refit one step on the old grid against the path's step on
    the new one (positions atol 1e-6 m, velocities 1e-5 m/s,
    ``tests/test_torch_lifecycle.py``'s refit test). Returns ``(timing,
    launches)``."""
    import nereus_tpu_torch as nt
    from nereus_tpu_torch import scene
    from nereus_tpu_torch.boundary import rehash_boundary
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.probes import cells
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    cfg = nt.SimConfig()
    params = nt.make_params(device=dev)
    state, _, walls = scene.dam_break(params, cfg, n_target=MAIN_N,
                                      capacity_factor=LIFE_CAPACITY,
                                      device=dev)
    h = float(params.interaction_radius)
    n0 = int(state.num_active)
    patch = emit_patch(params)
    cube = scene.particle_cube(DROP_CENTER, (DROP_SIZE,) * 3, h - 0.005)
    drain_y = float(state.pos[:n0, 1].min()) - DRAIN_DEPTH
    # the walls pin the live AABB, so a refit of the cell's own grid gives
    # it back unchanged: start from the oversized frame a refit fixes
    grid = nt.fit_grid(walls.pos.amin(dim=0).cpu().numpy() - REFIT_PAD,
                       walls.pos.amax(dim=0).cpu().numpy() + REFIT_PAD, h,
                       device=dev)
    walls = rehash_boundary(walls, grid)
    print(f"wcsph_1M_lifecycle: {n0} fluid particles, capacity "
          f"{state.capacity}, {walls.num_boundaries} wall samples, grid "
          f"{grid.size}; emit {len(patch)} every {EMIT_EVERY} steps at "
          f"{EMIT_AT} m, {EMIT_VEL} m/s; drop {len(cube)} every "
          f"{DROP_EVERY}; drain below y {drain_y:.6g}; refit every "
          f"{REFIT_EVERY}")

    def ev():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    drained = torch.zeros((), dtype=torch.int64, device=dev)
    emitted = dropped = 0
    spans = {"wcsph_step": [], "refit+rehash": [], "remove_particles": [],
             "add_particles_traced": []}
    t_start = ev()
    for i in range(LIFE_STEPS):
        if i and i % REFIT_EVERY == 0:
            e0 = ev()
            new_grid = nt.refit_grid(state, h, boundary=walls)
            new_walls = rehash_boundary(walls, new_grid)
            spans["refit+rehash"].append((e0, ev()))
            live = state.pos[state.active_mask()]
            lo = new_grid.origin
            hi = lo + torch.tensor(new_grid.size, device=dev) * new_grid.cell
            if not bool(((live > lo) & (live < hi)).all()):
                fail(f"wcsph_1M_lifecycle: a live particle outside the grid "
                     f"refit at step {i}")
            bad = cells.cellcheck(state, params, new_grid, cfg, new_walls)
            if bad:
                fail(f"wcsph_1M_lifecycle: cell check {bad} after the refit "
                     f"at step {i}")
            if i == REFIT_EVERY:
                prev = (grid, walls)
            print(f"wcsph_1M_lifecycle: step {i}: grid {grid.size} origin "
                  f"{grid.origin.tolist()} -> {new_grid.size} origin "
                  f"{new_grid.origin.tolist()}, live {int(state.num_active)}")
            grid, walls = new_grid, new_walls
        if i and i % EMIT_EVERY == 0:
            e0 = ev()
            state, ovf = nt.add_particles_traced(state, patch, EMIT_VEL)
            spans["add_particles_traced"].append((e0, ev()))
            overflow += ovf
            emitted += len(patch)
        if i and i % DROP_EVERY == 0:
            state = nt.add_particles(state, cube)
            dropped += len(cube)
        if i == REFIT_EVERY:
            # the path's step on the refit grid against one on the old grid,
            # from the same state
            before = state
            old, _ = nt.wcsph_step(before, params, prev[0], cfg, prev[1])
        e0 = ev()
        state, diag = nt.wcsph_step(state, params, grid, cfg, walls)
        spans["wcsph_step"].append((e0, ev()))
        if i == REFIT_EVERY:
            p_old, v_old = unsorted(old, cells.step_order(before, prev[0]))
            p_new, v_new = unsorted(state, cells.step_order(before, grid))
            act = before.active_mask()
            dp = float((p_old - p_new)[act].abs().max())
            dv = float((v_old - v_new)[act].abs().max())
            print(f"wcsph_1M_lifecycle: one step on the old grid vs the "
                  f"refit grid: max|dpos| {dp:.6g} m, max|dvel| {dv:.6g} m/s")
            if not (dp <= 1e-6 and dv <= 1e-5):
                fail(f"wcsph_1M_lifecycle: refit changes the step: "
                     f"{dp} m, {dv} m/s")
        drained += ((state.pos[:, 1] < drain_y)
                    & state.active_mask()).sum()
        e0 = ev()
        state = nt.remove_particles(state, state.pos[:, 1] >= drain_y)
        spans["remove_particles"].append((e0, ev()))
    t_end = ev()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    ms = t_start.elapsed_time(t_end) / LIFE_STEPS
    n = int(state.num_active)
    drained, overflow = int(drained), int(overflow)
    per = {k: sum(a.elapsed_time(b) for a, b in v) / len(v)
           for k, v in spans.items()}
    refits = len(spans["refit+rehash"])
    print(f"wcsph_1M_lifecycle: {LIFE_STEPS} steps: {ms:.4f} ms/step over "
          f"the loop (lifecycle and checks included); per call: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per.items())
          + f"; emitted {emitted}, dropped {dropped}, drained {drained}, "
          f"emit overflow {overflow}, live {n0} -> {n}, refits {refits}; "
          f"launches {launches}")
    check_launches("wcsph_1M_lifecycle", {
        cuda_sweep.DENSITY: LIFE_STEPS + 1, cuda_sweep.FORCE: LIFE_STEPS + 1,
        cuda_sweep.CELL_CHECK: refits})
    if overflow:
        fail(f"wcsph_1M_lifecycle: emit overflow {overflow}")
    if n != n0 + emitted + dropped - drained:
        fail(f"wcsph_1M_lifecycle: live {n} != {n0} + {emitted} + "
             f"{dropped} - {drained}")
    if not drained > 0:
        fail("wcsph_1M_lifecycle: nothing drained")
    if not bool(torch.isfinite(state.pos).all()):
        fail("wcsph_1M_lifecycle: non-finite positions")
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    timing = compare(cfg, ctx, params, f"wcsph_1M_lifecycle after "
                     f"{LIFE_STEPS} steps", time_it=True)
    timing["cell_check"] = cell_check_entry(cfg, ctx, grid,
                                            "wcsph_1M_lifecycle")
    return timing, launches


def lowered(state, boundary, gap):
    """``state`` moved down so its lowest particle sits ``gap`` over the
    lowest wall sample."""
    import nereus_tpu_torch as nt
    n = int(state.num_active)
    pos = state.pos[:n].clone()
    pos[:, 1] += float(boundary.pos[:, 1].min()) + gap - float(
        pos[:, 1].min())
    return nt.make_fluid_state(pos.cpu().numpy(), device=state.pos.device)


def run_wall_force(cfg, params, state, grid, walls):
    """Phase 37: the wall-only force on the ``wcsph_1M`` cell's first-step
    operands, the fluid lowered to 0.04 m over its floor (at the start the
    walls are 0.17 m away, beyond the support, and every wall force is 0).
    The port's entry point ``sph_pairs.boundary_force_sweep`` for both
    pressure switches is the path; then each kernel against its plain
    version and fused − fluid-only = wall-only within ``FORCE_TOL``.
    Returns ``(timing, launches)``."""
    from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    state = lowered(state, walls, 0.04)
    ctx = build_sweep_ctx(state, params, grid, cfg, walls)
    dargs, _ = sweep_inputs(ctx, params)
    _, fargs = sweep_inputs(ctx, params, SP.density_sweep_plain(cfg, *dargs))
    q8, src = fargs[0], fargs[1]
    w_rng = tuple((r[9:] - ctx.c).contiguous()
                  for r in (ctx.seg_start, ctx.seg_end))
    wargs = (q8, ctx.b_src, *w_rng, ctx.pvec)
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    for p in (True, False):
        SP.boundary_force_sweep(cfg, *wargs, include_pressure=p)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    check_launches("wcsph_1M_wall_force", {cuda_sweep.WALL_FORCE: 1,
                                           cuda_sweep.WALL_FORCE_P0: 1})
    inside = cutoff_pairs(q8, ctx.b_src, *w_rng, float(ctx.pvec[SP.PV_H2]))
    print(f"wall-only force: {ctx.c} queries, {walls.num_boundaries} wall "
          f"samples, the fluid 0.04 m over its floor: "
          f"{int(((w_rng[1] - w_rng[0]).sum(dim=0) > 0).sum())} queries with "
          f"wall candidates, {inside} pairs inside the cutoff")
    if not inside:
        fail("wall-only force: no wall pair inside the cutoff")
    ops = {"wall_force": (cuda_sweep.boundary_force_sweep,
                          SP.boundary_force_sweep_plain, wargs, {}),
           "wall_force_p0": (cuda_sweep.boundary_force_sweep,
                             SP.boundary_force_sweep_plain, wargs,
                             dict(include_pressure=False))}
    timing = compare_kernels(cfg, ops, "wall-only force (lowered wcsph_1M)",
                             time_it=True)
    fluid_end = ctx.seg_end.clone()
    fluid_end[9:] = ctx.seg_start[9:]
    for key, (_, _, _, kw) in ops.items():
        p = kw.get("include_pressure", True)
        wall = cuda_sweep.boundary_force_sweep(cfg, *wargs, **kw)
        diff = (cuda_sweep.force_sweep(cfg, q8, src, ctx.seg_start,
                                       ctx.seg_end, ctx.pvec,
                                       include_pressure=p)
                - cuda_sweep.force_sweep(cfg, q8, src, ctx.seg_start,
                                         fluid_end, ctx.pvec,
                                         include_pressure=p))
        err = (diff - wall).abs().amax(dim=0)
        scale = wall.abs().amax(dim=0)
        print(f"  {key}: fused - fluid-only vs wall-only max|d| "
              f"{err.tolist()} (max|wall| {scale.tolist()})")
        if not bool((scale > 0).all() & (err <= FORCE_TOL * scale).all()):
            fail(f"{key}: fused - fluid-only != wall-only: {err.tolist()} "
                 f"> {FORCE_TOL}*{scale.tolist()}")
    return timing, launches


def layout_mismatches(layout, got, ref, label):
    """Fails unless the layout probe's output ``got`` (4, m) agrees with
    ``ref`` query by query (``layout.mismatched_queries``: every element
    within RTOL·|ref| + ATOL, exactly 0 where ``ref`` is, finite, row 3
    zero); returns max|got − ref| over the force rows."""
    bad = layout.mismatched_queries(got, ref)
    err = float((got[:3] - ref[:3]).abs().max())
    if bool(bad.any()):
        i = int(torch.nonzero(bad)[0, 0])
        fail(f"layout probe {label}: {int(bad.sum())} of {bad.numel()} "
             f"queries outside {layout.RTOL}*|ref| + {layout.ATOL}, first "
             f"{i}: got {got[:, i].tolist()} ref {ref[:, i].tolist()}")
    return err


def run_layout(dev):
    """Phase 38: the layout probe, both layouts against the plain version
    query by query at m = 2^14 and ws = 192, where two planted faults must
    be caught by the same check; then the probe's timing entry point at m =
    2^20 (the path: both layouts timed), each held against the plain
    version there too. Returns ``(timing, launches)``."""
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.probes import layout as L
    a, q, aos, soa = L.device_inputs(LAYOUT_CHECK_M, LAYOUT_WS, dev)
    ref = L.probe_plain(a, q, aos, LAYOUT_WS)
    live = int((ref[:3] != 0).any(dim=0).sum())
    for fault, wrong in L.planted_faults(a, q, aos, LAYOUT_WS, ref).items():
        caught = int(L.mismatched_queries(wrong, ref).sum())
        print(f"  layout probe check, planted fault '{fault}': {caught} "
              f"queries flagged")
        if caught == 0:
            fail(f"layout probe check misses the planted fault '{fault}'")
    for name, src, is_soa in (("AoS", aos, False), ("SoA", soa, True)):
        got = cuda_sweep.layout_probe(a, q, src, LAYOUT_WS, is_soa)
        err = layout_mismatches(L, got, ref, f"{name} m={LAYOUT_CHECK_M}")
        print(f"  layout probe {name} m={LAYOUT_CHECK_M} ws={LAYOUT_WS}: "
              f"every query within {L.RTOL}*|ref| + {L.ATOL} ({live} with a "
              f"force), max|d| {err}")
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    ms = L.time_layouts(LAYOUT_M, LAYOUT_WS)
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    if not (launches[cuda_sweep.LAYOUT_AOS.name] > 0
            and launches[cuda_sweep.LAYOUT_SOA.name] > 0):
        fail(f"layout probe: launches {launches}")
    a, q, aos, soa = L.device_inputs(LAYOUT_M, LAYOUT_WS, dev)
    nb = LAYOUT_M // L.B
    slots_tpu = nb * L.N_ROWS * 1.3 * LAYOUT_WS * L.B
    slots = L.window_slots(a, LAYOUT_WS)
    ref = L.probe_plain(a, q, aos, LAYOUT_WS)
    plain_ms = events_ms(lambda: L.probe_plain(a, q, aos, LAYOUT_WS), 2)
    timing = {}
    for key, name, src, is_soa in (("layout_aos", "AoS", aos, False),
                                   ("layout_soa", "SoA", soa, True)):
        got = cuda_sweep.layout_probe(a, q, src, LAYOUT_WS, is_soa)
        err = layout_mismatches(L, got, ref, f"{name} m={LAYOUT_M}")
        per = ms[name] * 1e-3
        print(f"layout probe {name} m={LAYOUT_M} ws={LAYOUT_WS}: "
              f"{ms[name]:.4f} ms/sweep, {slots_tpu / per / 1e9:.1f} G "
              f"slots/s as the TPU probe counts them ({slots / per / 1e9:.1f}"
              f" G for the {slots} slots evaluated), "
              f"{LAYOUT_M / per / 1e6:.2f} M q/s; plain {plain_ms:.4f} ms; "
              f"every query within {L.RTOL}*|ref| + {L.ATOL}, max|d| {err}")
        nbytes = sum(t.numel() * t.element_size() for t in (a, q, src, got))
        timing[key] = (err, ms[name], plain_ms,
                       *flat_bound(nbytes, slots * L.OPS_PER_SLOT))
    print(f"layout probe: SoA / AoS time {ms['SoA'] / ms['AoS']:.4f}")
    return timing, launches


def ptxas_report(log):
    """Prints nvcc's ``-Xptxas -v`` lines: the row-tiled kernels by name,
    and for the lane-group kernels (density, force) by G the range of
    registers and spill stores over their instances and the main path's
    instance (Müller kernels, Becker surface tension, pressure, viscosity,
    static walls)."""
    import re
    entry, groups = "", {}
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else ""
            continue
        if not ("registers" in line or "spill" in line):
            continue
        m = re.search(r"(density_sweep_kernel|force_sweep_kernel)I((?:L[ib]"
                      r"-?\d+E)+)E", entry)
        if m is None:
            # the row-tiled kernels by name (their shared memory too)
            tag = (f"{entry}: " if "tiled_pair_sweep_kernel" in entry
                   or "group_pair_sweep_kernel" in entry
                   or "group_list_sweep_kernel" in entry else "")
            print("  ptxas:", tag + line.strip())
            continue
        # template ints <KS[, ST, PRESSURE, VISC, MOVING], G>, then the
        # force's load-ahead flag
        targs = tuple(int(v) for v in re.findall(r"Li(-?\d+)E", m[2]))
        pf = "Lb1E" in m[2]
        rec = groups.setdefault((m[1], targs[-1], pf),
                                {"regs": [], "spill": []})
        main_path = targs[:-1] in ((1,), (1, 1, 1, 1, 0))
        if "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line)[1])
            rec["regs"].append(regs)
            if main_path:
                rec["main"] = line.strip()
        else:
            rec["spill"].append(int(re.search(r"(\d+) bytes spill stores",
                                              line)[1]))
    for (name, g, pf), rec in sorted(groups.items()):
        print(f"  ptxas: {name} G={g}{' prefetch' if pf else ''}: "
              f"{len(rec['regs'])} instances, {min(rec['regs'])}-"
              f"{max(rec['regs'])} registers, spill stores up to "
              f"{max(rec['spill'])} bytes; main path: {rec.get('main', '-')}")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures "
             "the port on an NVIDIA GPU and has no CPU fallback")
    # the port itself, before anything is printed: without it (the script
    # alone in a directory) the run fails with no output
    import nereus_tpu_torch as nt
    from nereus_tpu_torch.ops import cuda_sweep
    from nereus_tpu_torch.ops.sph_pairs import MP_INV_M
    from nereus_tpu_torch.solvers import (dfsph_cuda, iisph_cuda, pbf_cuda,
                                          pcisph_cuda, viscosity)
    from nereus_tpu_torch.boundary import move_boundary
    from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx
    from nereus_tpu_torch.solvers.wcsph_cuda import PLAIN, wcsph_step_cuda

    t_run = time.perf_counter()
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
    ptxas_report(log)

    # -- 3. kernel vs plain, every kernel set and surface-tension model -------
    print(f"kernel vs plain, dam-break n_target={SMALL_N}, floor in "
          "support, seeded velocities:")
    for ks, st in MODELS:
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           surface_tension_model=nt.SurfaceTensionModel[st])
        params = nt.make_params(device=dev)
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        compare(cfg, ctx, params,
                f"{ks}+{st} n={state.capacity} nb={boundary.num_boundaries}")
    torch.cuda.synchronize()

    # -- 4. the main path ----------------------------------------------------
    t0 = time.perf_counter()
    cfg, params, state, grid, boundary = wcsph_main_path(dev)
    # phases 11 and 12 start from the same scene (the steps never write
    # their input state)
    dam_1m = (cfg, params, state, grid, boundary)
    torch.cuda.synchronize()
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    print(f"main path: dam_break n_target=2**20: {n} fluid particles, "
          f"{boundary.num_boundaries} boundary samples, grid {grid.size}, "
          f"dt {float(params.dt)}, floor y {floor:.6g}; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    if n != WCSPH_FLUID:
        fail(f"expected {WCSPH_FLUID:,} fluid particles, got {n}")

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
    check_launches("WCSPH main path", {cuda_sweep.DENSITY: N_STEPS,
                                       cuda_sweep.FORCE: N_STEPS})
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
    for ks, st in MODELS:
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           surface_tension_model=nt.SurfaceTensionModel[st])
        base = nt.iisph_params(device=dev)
        params = nt.calibrate_mass(
            base, cfg, spacing=float(base.interaction_radius) - 0.005)
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        # one step carries a real pressure into the operands' warm start
        state, diag = nt.iisph_step(state, params, grid, cfg, boundary,
                                    tol=IISPH_TOL, omega=IISPH_OMEGA)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        # the pressure-off force sweep and the d_ii, rho_adv and a_ii sweep
        # for every model, the other IISPH sweeps (which read no
        # surface-tension model) once per kernel set
        keys = None if st == "BECKER" else ("force_p0", "dii_aii")
        compare_kernels(cfg, iisph_operands(cfg, ctx, params),
                        f"{ks}+{st} n={state.capacity} "
                        f"nb={boundary.num_boundaries} iters "
                        f"{int(diag.solver_iters)} max p "
                        f"{float(state.pressure.max()):.4g}", keys=keys)
    torch.cuda.synchronize()

    # -- 6. the IISPH main path --------------------------------------------
    t0 = time.perf_counter()
    cfg, params, state, grid, boundary, step = settled_main_path(
        "iisph", dev, MAIN_N)
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
    t_host = time.perf_counter()
    state, diags, ms, window, _ = run_steps(
        step, state, IMPLICIT_STEPS, IMPLICIT_TIMED_FROM, (iisph_cuda.LOOP,))
    t_host = time.perf_counter() - t_host
    timed = IMPLICIT_STEPS - IMPLICIT_TIMED_FROM
    launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    iters = torch.stack([d.solver_iters for d in diags]).cpu().numpy()
    errs = torch.stack([d.mean_density_error for d in diags]).cpu().numpy()
    syncs = window[0][1] / timed
    pos = state.pos[:n]
    min_y = float(pos[:, 1].min())
    print(f"IISPH main path: {IMPLICIT_STEPS} steps in {t_host:.2f} s host; "
          f"steps {IMPLICIT_TIMED_FROM + 1}-{IMPLICIT_STEPS}: {ms:.4f} ms/step = "
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
    if iisph_cuda.LOOP.launched < int(iters.sum()):
        fail(f"{iisph_cuda.LOOP.launched} Jacobi iterations launched for "
             f"{int(iters.sum())} converged")
    check_launches("IISPH main path", {
        cuda_sweep.DENSITY: IMPLICIT_STEPS, cuda_sweep.FORCE_P0: IMPLICIT_STEPS,
        cuda_sweep.DII_AII: IMPLICIT_STEPS,
        cuda_sweep.PRESSURE_FORCE: IMPLICIT_STEPS,
        cuda_sweep.SUM_DIJ: iisph_cuda.LOOP.launched,
        cuda_sweep.JACOBI: iisph_cuda.LOOP.launched})
    iisph_launches = launches

    # each IISPH kernel vs plain at these shapes, on the last state
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    iisph_timing = compare_kernels(
        cfg, iisph_operands(cfg, ctx, params),
        f"IISPH main path after {IMPLICIT_STEPS} steps", time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, diags, ctx, boundary, grid
    torch.cuda.empty_cache()

    # -- 7. PCISPH and DFSPH kernels vs plain, on one real step's operands ---
    print(f"PCISPH / DFSPH kernels vs plain, dam-break n_target={SMALL_N}, "
          "mass calibrated to the lattice, floor in support, seeded "
          "velocities:")
    for ks in ("MULLER", "MONAGHAN"):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        for solver, params_fn in (("pcisph", nt.pcisph_params),
                                  ("dfsph", nt.dfsph_params)):
            base = params_fn(device=dev)
            params = nt.calibrate_mass(
                base, cfg, spacing=float(base.interaction_radius) - 0.005)
            state, grid, boundary = small_dam_break(nt, params, cfg, dev)
            # one step carries a real pressure (κ) into the operands
            if solver == "pcisph":
                state, diag = nt.pcisph_step(
                    state, params, grid, cfg, boundary,
                    delta=nt.pcisph_delta(params, cfg),
                    tol_frac=PCISPH_TOL_FRAC)
                ops = pcisph_operands
            else:
                state, diag = nt.dfsph_step(state, params, grid, cfg,
                                            boundary, tol=DFSPH_TOL,
                                            tol_v=DFSPH_TOL)
                ops = dfsph_operands
            ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
            compare_kernels(cfg, ops(cfg, ctx, params),
                            f"{solver} {ks} n={state.capacity} "
                            f"nb={boundary.num_boundaries} iters "
                            f"{int(diag.solver_iters)} max p "
                            f"{float(state.pressure.max()):.4g}")
    torch.cuda.synchronize()

    # -- 8. the PCISPH main path -------------------------------------------
    cfg, params, state, grid, boundary, _, pcisph_launches = \
        run_settled_path("pcisph", dev, {"corrective": pcisph_cuda.LOOP})
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    pcisph_timing = compare_kernels(
        cfg, pcisph_operands(cfg, ctx, params),
        f"PCISPH main path after {IMPLICIT_STEPS} steps", time_it=True)
    del state, ctx, boundary, grid

    # -- 9. the DFSPH main path --------------------------------------------
    cfg, params, state, grid, boundary, _, dfsph_launches = \
        run_settled_path("dfsph", dev, {"divergence": dfsph_cuda.LOOP_V,
                                        "density": dfsph_cuda.LOOP})
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    dfsph_timing = compare_kernels(
        cfg, dfsph_operands(cfg, ctx, params),
        f"DFSPH main path after {IMPLICIT_STEPS} steps", time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, ctx, boundary, grid

    # -- 10. multiphase and XSPH kernels vs plain, on one real step's operands
    print(f"multiphase / XSPH kernels vs plain, dam-break n_target="
          f"{SMALL_N} (multiphase: top half by y at {MP_RATIO}·ρ₀), floor in "
          "support, seeded velocities:")
    for ks in ("MULLER", "MONAGHAN"):
        params = nt.make_params(device=dev)
        for st, cross in (("NONE", 0.0), ("BECKER", MP_ST_CROSS)):
            cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                               surface_tension_model=nt.SurfaceTensionModel[
                                   st], st_cross=cross)
            state, grid, boundary = small_dam_break(nt, params, cfg, dev)
            # the first step's operands: a step of this uncalibrated scene
            # lifts its bottom layer off the floor under Monaghan kernels
            ctx = build_sweep_ctx(two_phase(state, params), params, grid,
                                  cfg, boundary)
            compare_kernels(cfg, multiphase_operands(cfg, ctx, params),
                            f"multiphase {ks}+{st} st_cross {cross} "
                            f"n={state.capacity} "
                            f"nb={boundary.num_boundaries}")
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        compare_kernels(cfg, xsph_path_operands(cfg, ctx, params),
                        f"xsph {ks} n={state.capacity}", keys=("xsph",))
    torch.cuda.synchronize()

    # -- 11. the multiphase main path (bench.py's multiphase_1M) -----------
    cfg, params, state, grid, boundary = dam_1m
    state = two_phase(state, params)
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    rd = float(params.rest_density)
    light = state.rho0[:n] < 0.5 * rd
    print(f"multiphase main path: {n} fluid particles ({int(light.sum())} "
          f"at {MP_RATIO}·ρ₀), {boundary.num_boundaries} boundary samples, "
          f"surface tension {cfg.surface_tension_model.name} st_cross "
          f"{cfg.st_cross}")
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diag, ms, overflow = run_wcsph(cfg, params, state, grid,
                                          boundary)
    t_host = time.perf_counter() - t_host
    mp_launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    y = state.pos[:n, 1]
    light = state.rho0[:n] < 0.5 * rd
    y_light, y_heavy = float(y[light].mean()), float(y[~light].mean())
    min_y = float(y.min())
    mc = float(diag.mean_compression)
    print(f"multiphase main path: {N_STEPS} steps in {t_host:.2f} s host; "
          f"steps {TIMED_FROM + 1}-{N_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"multiphase main path: launches {mp_launches}, seg_overflow max "
          f"{overflow}, min y {min_y:.6g}, mean_compression {mc:.6g}, "
          f"mean_density_error {float(diag.mean_density_error):.6g}, "
          f"max_density {float(diag.max_density):.6g}, mean y light "
          f"{y_light:.6g} heavy {y_heavy:.6g}")
    check_launches("multiphase main path", {cuda_sweep.MP_DENSITY: N_STEPS,
                                            cuda_sweep.MP_FORCE: N_STEPS})
    if overflow != 0:
        fail(f"multiphase: seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("multiphase: non-finite positions")
    if min_y < floor:
        fail(f"multiphase: floor penetration: min y {min_y} < floor {floor}")
    if not mc < 0.1:
        fail(f"multiphase: mean_compression {mc} >= 0.1")
    if not y_light > y_heavy:
        fail(f"multiphase: light phase's mean height {y_light} not above "
             f"the heavy phase's {y_heavy}")
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    mp_timing = compare_kernels(
        cfg, multiphase_operands(cfg, ctx, params),
        f"multiphase main path after {N_STEPS} steps", time_it=True)
    del state, diag, ctx

    # -- 12. the XSPH path -------------------------------------------------
    cfg, params, state, grid, boundary = dam_1m
    n = int(state.num_active)
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    t_host = time.perf_counter()
    state, diag, ms, overflow = run_wcsph(cfg, params, state, grid,
                                          boundary, xsph_eps=XSPH_EPS)
    t_host = time.perf_counter() - t_host
    xsph_launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    min_y = float(state.pos[:n, 1].min())
    mc = float(diag.mean_compression)
    print(f"XSPH path (xsph_eps {XSPH_EPS}): {N_STEPS} steps in "
          f"{t_host:.2f} s host; steps {TIMED_FROM + 1}-{N_STEPS}: "
          f"{ms:.4f} ms/step = {n / (ms * 1e-3):.4g} particle-steps/s")
    print(f"XSPH path: launches {xsph_launches}, seg_overflow max "
          f"{overflow}, min y {min_y:.6g}, mean_compression {mc:.6g}, "
          f"mean_density_error {float(diag.mean_density_error):.6g}, "
          f"max_density {float(diag.max_density):.6g}")
    check_launches("XSPH path", {cuda_sweep.DENSITY: N_STEPS,
                                 cuda_sweep.FORCE: N_STEPS,
                                 cuda_sweep.XSPH: N_STEPS})
    if overflow != 0:
        fail(f"XSPH: seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("XSPH: non-finite positions")
    if min_y < floor:
        fail(f"XSPH: floor penetration: min y {min_y} < floor {floor}")
    if not mc < 0.1:
        fail(f"XSPH: mean_compression {mc} >= 0.1")
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    xsph_timing = compare_kernels(
        cfg, xsph_path_operands(cfg, ctx, params),
        f"XSPH path after {N_STEPS} steps", time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, diag, ctx

    # -- 21. the moving-wall kernels vs plain, on a moving wall's operands --
    print(f"moving-wall kernels vs plain, dam-break n_target={SMALL_N}, "
          f"walls at {WALL_VEL} m/s, floor in support, seeded velocities "
          f"(multiphase: top half by y at {MP_RATIO}·ρ₀):")
    for ks in ("MULLER", "MONAGHAN"):
        params = nt.make_params(device=dev)
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        moved = move_boundary(boundary, grid, velocity=WALL_VEL)
        label = (f"moving walls {ks} n={state.capacity} "
                 f"nb={moved.num_boundaries}")
        ctx = build_sweep_ctx(state, params, grid, cfg, moved)
        ops = moving_wall_operands(cfg, ctx, params)
        compare_kernels(cfg, ops, label)
        check_reads_wall_velocity(cfg, ops, label)
        # the d_ii, rho_adv and a_ii sweep under the other two models
        for st in ("AKINCI", "NONE"):
            scfg = dataclasses.replace(
                cfg, surface_tension_model=nt.SurfaceTensionModel[st])
            compare_kernels(scfg, {"dii_aii": ops["dii_aii"]},
                            f"{label} {st}")
        ctx = build_sweep_ctx(two_phase(state, params), params, grid, cfg,
                              moved)
        ops = moving_wall_mp_operands(cfg, ctx, params)
        compare_kernels(cfg, ops, f"multiphase {label}")
        check_reads_wall_velocity(cfg, ops, f"multiphase {label}")
    torch.cuda.synchronize()
    del state, ctx, ops, boundary, moved

    # -- 22. the WCSPH path under the wavemaker ------------------------------
    cfg, params, _, _, _ = dam_1m
    state, wgrid, moved, _, wm_launches = run_wavemaker(
        "wcsph_1M_wavemaker", dam_1m)
    ctx = build_sweep_ctx(state, params, wgrid, cfg, moved)
    ops = xsph_path_operands(cfg, ctx, params)
    wm_timing = compare_kernels(
        cfg, {"density": ops["density"],
              "force_moving": moving(ops["force"])},
        f"wcsph_1M_wavemaker after {N_STEPS} steps", time_it=True)
    fric = {"force_moving_friction": friction_only(moving(ops["force"]), 7,
                                                   beta0=True)}
    compare_kernels(cfg, fric, f"wcsph_1M_wavemaker after {N_STEPS} steps")
    check_reads_wall_velocity(cfg, fric, "wcsph_1M_wavemaker")
    del state, ctx, ops, fric, moved

    # -- 23. the multiphase path under the wavemaker -------------------------
    cfg, params, state, grid, boundary = dam_1m
    state, wgrid, moved, _, mwm_launches = run_wavemaker(
        "multiphase_1M_wavemaker",
        (cfg, params, two_phase(state, params), grid, boundary))
    ctx = build_sweep_ctx(state, params, wgrid, cfg, moved)
    ops = multiphase_operands(cfg, ctx, params)
    mwm_timing = compare_kernels(
        cfg, {"mp_density": ops["mp_density"],
              "mp_force_moving": moving(ops["mp_force"])},
        f"multiphase_1M_wavemaker after {N_STEPS} steps", time_it=True)
    fric = {"mp_force_moving_friction": friction_only(
        moving(ops["mp_force"]), MP_INV_M)}
    compare_kernels(cfg, fric,
                    f"multiphase_1M_wavemaker after {N_STEPS} steps")
    check_reads_wall_velocity(cfg, fric, "multiphase_1M_wavemaker")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, ctx, ops, fric, moved, boundary, grid

    # -- 13. the kernels of the implicit viscosity solve and of multiphase
    # DFSPH vs plain, on the first step's operands ---------------------------
    print(f"implicit viscosity / multiphase DFSPH kernels vs plain, "
          f"dam-break n_target={SMALL_N} (DFSPH parameters, ν {VISC_NU}, "
          f"mass calibrated to the lattice; multiphase: top half by y at "
          f"{MP_RATIO}·ρ₀), floor in support, seeded velocities:")
    for ks in ("MULLER", "MONAGHAN"):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks],
                           viscosity_model="implicit")
        base = nt.dfsph_params(viscosity=VISC_NU, device=dev)
        params = nt.calibrate_mass(
            base, cfg, spacing=float(base.interaction_radius) - 0.005)
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        label = f"{ks} n={state.capacity} nb={boundary.num_boundaries}"
        compare_kernels(cfg, dfsph_operands(cfg, ctx, params),
                        f"DFSPH implicit viscosity {label}",
                        keys=("force_p0_v0", "visc_laplacian"))
        compare_kernels(cfg, wcsph_visc_operands(cfg, ctx, params),
                        f"WCSPH implicit viscosity {label}",
                        keys=("force_v0", "visc_laplacian"))
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        ctx = build_sweep_ctx(two_phase(state, params), params, grid, cfg,
                              boundary)
        compare_kernels(cfg, mp_dfsph_operands(cfg, ctx, params),
                        f"multiphase DFSPH {label}",
                        keys=("mp_density_alpha", "mp_drho", "mp_kappa"))
    torch.cuda.synchronize()
    del state, ctx, boundary, grid

    # -- 14. the WCSPH path with the implicit viscosity solve ---------------
    cfg, _, state, grid, boundary = dam_1m
    cfg = dataclasses.replace(cfg, viscosity_model="implicit")
    params = nt.make_params(viscosity=VISC_NU, device=dev)
    n = int(state.num_active)
    floor = float(boundary.pos[:, 1].min())
    print(f"WCSPH implicit viscosity path: {n} fluid particles, "
          f"{boundary.num_boundaries} boundary samples, viscosity "
          f"{float(params.viscosity)}, CG tol {cfg.visc_cg_tol} cap "
          f"{cfg.visc_cg_max_iters}, host read every "
          f"{viscosity.SYNC_EVERY} launched iterations")
    torch.cuda.synchronize()
    cuda_sweep.reset_launches()
    viscosity.LOOP.reset()
    t_host = time.perf_counter()
    state, diags, ms, window, ends = run_steps(
        lambda s: nt.wcsph_step(s, params, grid, cfg, boundary), state,
        N_STEPS, TIMED_FROM, (viscosity.LOOP,))
    t_host = time.perf_counter() - t_host
    wvisc_launches = {k.name: k.launches for k in cuda_sweep.KERNELS}
    diag = diags[-1]
    overflow = int(torch.stack([d.seg_overflow for d in diags]).max())
    min_y = float(state.pos[:n, 1].min())
    mc = float(diag.mean_compression)
    print(f"WCSPH implicit viscosity path: {N_STEPS} steps in {t_host:.2f} s "
          f"host; steps {TIMED_FROM + 1}-{N_STEPS}: {ms:.4f} ms/step = "
          f"{n / (ms * 1e-3):.4g} particle-steps/s")
    print_cg("WCSPH implicit viscosity path", viscosity.LOOP, ends, window,
             N_STEPS, N_STEPS - TIMED_FROM)
    print(f"WCSPH implicit viscosity path: launches {wvisc_launches}, "
          f"seg_overflow max {overflow}, min y {min_y:.6g}, mean_compression "
          f"{mc:.6g}, mean_density_error "
          f"{float(diag.mean_density_error):.6g}, max_density "
          f"{float(diag.max_density):.6g}")
    check_loop_ends("WCSPH implicit viscosity path", {"CG": viscosity.LOOP},
                    ends)
    check_launches("WCSPH implicit viscosity path", {
        cuda_sweep.DENSITY: N_STEPS, cuda_sweep.FORCE_V0: N_STEPS,
        cuda_sweep.VISC_LAPLACIAN: viscosity.LOOP.launched + N_STEPS})
    if overflow != 0:
        fail(f"WCSPH implicit viscosity: seg_overflow {overflow}")
    if not bool(torch.isfinite(state.pos).all()):
        fail("WCSPH implicit viscosity: non-finite positions")
    if min_y < floor:
        fail(f"WCSPH implicit viscosity: floor penetration: min y {min_y} < "
             f"floor {floor}")
    if not mc < 0.1:
        fail(f"WCSPH implicit viscosity: mean_compression {mc} >= 0.1")
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    wvisc_timing = compare_kernels(
        cfg, wcsph_visc_operands(cfg, ctx, params),
        f"WCSPH implicit viscosity path after {N_STEPS} steps", time_it=True)
    del state, diags, ctx, dam_1m, boundary, grid
    torch.cuda.empty_cache()

    # -- 15. the DFSPH path with the implicit viscosity solve ---------------
    cfg, params, state, grid, boundary, _, dvisc_launches = run_settled_path(
        "dfsph_visc", dev, {"divergence": dfsph_cuda.LOOP_V,
                            "density": dfsph_cuda.LOOP}, cg=viscosity.LOOP)
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    dvisc_timing = compare_kernels(
        cfg, dfsph_operands(cfg, ctx, params),
        f"DFSPH_VISC main path after {IMPLICIT_STEPS} steps", time_it=True)
    del state, ctx, boundary, grid

    # -- 16. the multiphase DFSPH path --------------------------------------
    cfg, params, state, grid, boundary, _, dmp_launches = run_settled_path(
        "dfsph_mp", dev, {"divergence": dfsph_cuda.LOOP_V,
                          "density": dfsph_cuda.LOOP})
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    dmp_timing = compare_kernels(
        cfg, mp_dfsph_operands(cfg, ctx, params),
        f"DFSPH_MP main path after {IMPLICIT_STEPS} steps", time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, ctx, boundary, grid

    # -- 17. PBF kernels vs plain, on the first step's operands --------------
    print(f"PBF kernels vs plain, resting_block n_target={SMALL_N} (PBF "
          "parameters, mass calibrated to the 0.8·h lattice, impact velocity "
          "-1 m/s; Monaghan seeded at 0.7·h):")
    for ks in ("MULLER", "MONAGHAN"):
        # calibrate_mass sums Monaghan's lattice out to its 2h support while
        # the sweeps cut at h: a 0.8·h block sits at 0.58·ρ₀ and never
        # compresses, and its λ would be 0; at 0.7·h it is at 1.18·ρ₀
        cfg, params, state, grid, boundary = pbf_block(
            nt.SimConfig(kernel_set=nt.KernelSet[ks]), dev, SMALL_N,
            lattice=0.8 if ks == "MULLER" else 0.7)
        ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                              cfg, boundary)
        ops = pbf_path_operands(cfg, ctx, params, vorticity=True)
        lam = ops["pbf_dp"][2][0][:, 3]
        if not float(lam.min()) < 0.0:
            fail(f"PBF {ks}: the first iteration's λ is all 0: the check "
                 "would not reach the λ terms")
        compare_kernels(cfg, ops, f"PBF {ks} n={state.capacity} nb="
                        f"{boundary.num_boundaries} min λ "
                        f"{float(lam.min()):.4g}",
                        keys=("pbf_lambda", "pbf_dp", "pbf_omega",
                              "pbf_grad"))
    torch.cuda.synchronize()
    del state, ctx, boundary, grid, ops

    # -- 18. the PBF path pbf_1M -------------------------------------------
    pbf_1m = pbf_main_path(dev)
    if int(pbf_1m[2].num_active) != PBF_FLUID:
        fail(f"pbf_1M: expected {PBF_FLUID:,} fluid particles, got "
             f"{int(pbf_1m[2].num_active)}")
    cfg, params, _, grid, boundary = pbf_1m
    state, pbf_launches = run_pbf_path("PBF pbf_1M", pbf_1m, N_STEPS,
                                       TIMED_FROM)
    ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                          cfg, boundary)
    pbf_timing = compare_kernels(cfg, pbf_path_operands(cfg, ctx, params),
                                 f"pbf_1M after {N_STEPS} steps",
                                 time_it=True)
    del state, ctx

    # -- 19. the PBF path pbf_256k_settled ----------------------------------
    settled = pbf_main_path(dev, settled=True)
    if int(settled[2].num_active) != SETTLED_FLUID:
        fail(f"pbf_256k_settled: expected {SETTLED_FLUID:,} fluid particles, "
             f"got {int(settled[2].num_active)}")
    cfg, params, _, grid, boundary = settled
    state, pbfs_launches = run_pbf_path(
        "PBF pbf_256k_settled", settled, IMPLICIT_STEPS, IMPLICIT_TIMED_FROM)
    ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                          cfg, boundary)
    pbfs_timing = compare_kernels(
        cfg, pbf_path_operands(cfg, ctx, params),
        f"pbf_256k_settled after {IMPLICIT_STEPS} steps", time_it=True)
    del state, ctx, settled, boundary, grid

    # -- 20. the PBF path with vorticity confinement and XSPH ---------------
    cfg, params, _, grid, boundary = pbf_1m
    state, pbfv_launches = run_pbf_path(
        "PBF pbf_1M_vort_xsph", pbf_1m, N_STEPS, TIMED_FROM,
        xsph_eps=PBF_XSPH_EPS, vorticity_eps=PBF_VORTICITY_EPS)
    ctx = build_sweep_ctx(pbf_cuda.advected(state, params), params, grid,
                          cfg, boundary)
    pbfv_timing = compare_kernels(
        cfg, pbf_path_operands(cfg, ctx, params, vorticity=True),
        f"pbf_1M_vort_xsph after {N_STEPS} steps", time_it=True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del state, ctx, pbf_1m, boundary, grid

    # -- 24. the DFSPH path under the wavemaker ------------------------------
    cfg, params, state, grid, boundary, _, dwm_launches = run_settled_path(
        "dfsph_wavemaker", dev, {"divergence": dfsph_cuda.LOOP_V,
                                 "density": dfsph_cuda.LOOP})
    ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
    ops = dfsph_operands(cfg, ctx, params)
    ops["force_p0_moving"] = moving(ops.pop("force_p0"))
    dwm_timing = compare_kernels(
        cfg, ops, f"DFSPH_WAVEMAKER main path after {IMPLICIT_STEPS} steps",
        time_it=True)
    del state, ctx, ops, boundary, grid

    # -- 25-26. the rigid-body coupled paths ---------------------------------
    mpc_timing, mpc_launches = run_coupled("mp_coupled_256k", dev, True)
    cpl_timing, cpl_launches = run_coupled("coupled_256k", dev, False)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 27. the elastic kernels and FluidReaction vs plain -----------------
    print("elastic kernels vs plain: a 12×10×8 block at spacing h/2 "
          "stretched 2 % along x, sheared, rotated, noise "
          f"{ELASTIC_NOISE}·spacing; FluidReaction: a 6³ cube moving at "
          f"{BODY_VEL} m/s and spinning at {BODY_OMEGA} rad/s inside the "
          "phase-3 dam-break:")
    for ks in ("MULLER", "MONAGHAN"):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        params = nt.make_params(dt=ELASTIC_DT, device=dev)
        sp = 0.5 * float(params.interaction_radius)
        pts = nt.sample_box_solid((0.0, 0.0, 0.0),
                                  (11 * sp, 9 * sp, 7 * sp), sp)
        _, statics, grid = nt.make_elastic_solid(pts, params, cfg, sp,
                                                 device=dev)
        ep = nt.elastic_params(ELASTIC_E, device=dev)
        compare_kernels(cfg, elastic_kernel_ops(
            cfg, params, grid, statics, deformed(statics.x0, sp), ep),
            f"elastic {ks} n={statics.n}")
        params = nt.make_params(device=dev)
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        c = state.pos[:int(state.num_active)].mean(dim=0).cpu().numpy()
        cube = nt.sample_box_solid(c - 2.5 * sp, c + 2.5 * sp, sp)
        estate, statics, _ = nt.make_elastic_solid(cube, params, cfg, sp,
                                                   grid=grid, device=dev)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        ops = elastic_coupled_ops(cfg, ctx, params, grid,
                                  spinning(estate, statics),
                                  nt.elastic_psi(statics, params, cfg))
        check_reaction(cfg, ops, params, f"FluidReaction {ks} n="
                       f"{state.capacity} body {statics.n}")
    torch.cuda.synchronize()
    del state, ctx, boundary, grid, ops, statics, estate

    # -- 28-29. the elastic paths elastic_512k, elastic_plastic_512k --------
    el_timing, el_launches = run_elastic("elastic_512k", dev, False)
    elp_timing, elp_launches = run_elastic("elastic_plastic_512k", dev, True)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 30. the fluid-elastic coupled path wcsph_elastic_256k --------------
    wel_timing, wel_launches = run_wcsph_elastic("wcsph_elastic_256k", dev)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 31. the DFSPH couplings' instances vs plain ------------------------
    print(f"DFSPH coupling kernels vs plain, dam-break n_target={SMALL_N} "
          "(DFSPH parameters, mass calibrated to the lattice), a 0.08 box "
          f"and a 6³ cube moving at {BODY_VEL} m/s and spinning at "
          f"{BODY_OMEGA} rad/s in its middle (multiphase: top half by y at "
          f"{MP_RATIO}·ρ₀), first divergence iteration:")
    for ks in ("MULLER", "MONAGHAN"):
        cfg = nt.SimConfig(kernel_set=nt.KernelSet[ks])
        base = nt.dfsph_params(device=dev)
        params = nt.calibrate_mass(
            base, cfg, spacing=float(base.interaction_radius) - 0.005)
        state, grid, boundary = small_dam_break(nt, params, cfg, dev)
        c = state.pos[:int(state.num_active)].mean(dim=0)
        box = dataclasses.replace(
            nt.make_rigid_box(c.cpu().numpy(), (0.08,) * 3,
                              float(params.particle_radius),
                              DFSPH_BODY_DENSITY, params, device=dev),
            vel=torch.tensor(BODY_VEL, device=dev),
            omega=torch.tensor(BODY_OMEGA, device=dev))
        label = f"{ks} n={state.capacity} nb={boundary.num_boundaries}"
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        check_dfsph_body_ops(cfg, dfsph_body_ops(cfg, ctx, params, grid,
                                                 box), params,
                             f"DFSPH coupled {label} box {box.num_samples}")
        mctx = build_sweep_ctx(two_phase(state, params), params, grid, cfg,
                               boundary)
        check_dfsph_body_ops(cfg, dfsph_body_ops(cfg, mctx, params, grid,
                                                 box), params,
                             f"multiphase DFSPH coupled {label}")
        sp = 0.5 * float(params.interaction_radius)
        cube = nt.sample_box_solid((c - 2.5 * sp).cpu().numpy(),
                                   (c + 2.5 * sp).cpu().numpy(), sp)
        estate, statics, _ = nt.make_elastic_solid(cube, params, cfg, sp,
                                                   grid=grid, device=dev)
        check_dfsph_body_ops(
            cfg, dfsph_elastic_ops(cfg, ctx, params, grid,
                                   spinning(estate, statics), statics,
                                   nt.elastic_psi(statics, params, cfg)),
            params, f"DFSPH elastic {label} body {statics.n}")
    torch.cuda.synchronize()
    del state, ctx, mctx, boundary, grid, statics, estate

    # -- 32-34. the DFSPH coupled paths ---------------------------------------
    dcp_timing, dcp_launches = run_dfsph_coupled("dfsph_coupled_256k", dev,
                                                 "rigid")
    dmc_timing, dmc_launches = run_dfsph_coupled("dfsph_mp_coupled_256k",
                                                 dev, "mp")
    dec_timing, dec_launches = run_dfsph_coupled("dfsph_elastic_256k", dev,
                                                 "elastic")
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 35. the wide grid wcsph_wide12M -----------------------------------
    t0 = time.perf_counter()
    wide_timing, wide_launches = run_wide(dev)
    print(f"phase 35: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- 36. particle lifecycle and grid refit wcsph_1M_lifecycle -----------
    t0 = time.perf_counter()
    life_timing, life_launches = run_lifecycle(dev)
    print(f"phase 36: {time.perf_counter() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # -- 37. the wall-only force on the wcsph_1M cell -----------------------
    t0 = time.perf_counter()
    wall_timing, wall_launches = run_wall_force(*wcsph_main_path(dev))
    print(f"phase 37: {time.perf_counter() - t0:.1f} s")

    # -- 38. the layout probe ------------------------------------------------
    t0 = time.perf_counter()
    layout_timing, layout_launches = run_layout(dev)
    print(f"phase 38: {time.perf_counter() - t0:.1f} s")

    # one entry per kernel and path: every kernel a path launched is held
    # against its plain version at that path's shapes and operands
    sph_src = "nereus_tpu_torch/csrc/sph_sweep.cu"
    iisph_src = "nereus_tpu_torch/csrc/iisph_sweep.cu"
    dfsph_src = "nereus_tpu_torch/csrc/dfsph_sweep.cu"
    mp_src = "nereus_tpu_torch/csrc/multiphase_sweep.cu"
    visc_src = "nereus_tpu_torch/csrc/viscosity_sweep.cu"
    mpd_src = "nereus_tpu_torch/csrc/dfsph_multiphase_sweep.cu"
    pbf_src = "nereus_tpu_torch/csrc/pbf_sweep.cu"
    cpl_src = "nereus_tpu_torch/csrc/coupled_sweep.cu"
    el_src = "nereus_tpu_torch/csrc/elastic_sweep.cu"
    rep = "nereus_tpu/ops/pallas_sph.py:"
    info = {"density": (cuda_sweep.DENSITY, sph_src, rep + "1193"),
            "force": (cuda_sweep.FORCE, sph_src, rep + "1207"),
            "force_p0": (cuda_sweep.FORCE_P0, sph_src, rep + "1207"),
            # dii_rhoadv_pair (:475) and aii_pair (:506), fused
            "dii_aii": (cuda_sweep.DII_AII, iisph_src, rep + "475,506"),
            "sum_dij": (cuda_sweep.SUM_DIJ, iisph_src, rep + "524"),
            "jacobi": (cuda_sweep.JACOBI, iisph_src, rep + "543"),
            "pressure_force": (cuda_sweep.PRESSURE_FORCE, iisph_src,
                               rep + "922"),
            "density_pred": (cuda_sweep.DENSITY_PRED, sph_src, rep + "1193"),
            # density_sweep (:1193) and alpha_pair (:578), fused
            "density_alpha": (cuda_sweep.DENSITY_ALPHA, dfsph_src,
                              rep + "1193,578"),
            "density_alpha_sums": (cuda_sweep.DENSITY_ALPHA_SUMS, dfsph_src,
                                   rep + "1193,578"),
            "drho": (cuda_sweep.DRHO, dfsph_src, rep + "903"),
            "mp_density": (cuda_sweep.MP_DENSITY, mp_src, rep + "628"),
            "mp_force": (cuda_sweep.MP_FORCE, mp_src, rep + "657"),
            "xsph": (cuda_sweep.XSPH, mp_src, rep + "603"),
            "force_v0": (cuda_sweep.FORCE_V0, sph_src, rep + "1207"),
            "force_p0_v0": (cuda_sweep.FORCE_P0_V0, sph_src, rep + "1207"),
            "visc_laplacian": (cuda_sweep.VISC_LAPLACIAN, visc_src,
                               rep + "984"),
            # multiphase_density_pair (:628) and multiphase_alpha_pair
            # (:799), fused
            "mp_density_alpha": (cuda_sweep.MP_DENSITY_ALPHA, mpd_src,
                                 rep + "628,799"),
            "mp_drho": (cuda_sweep.MP_DRHO, mpd_src, rep + "836"),
            "mp_kappa": (cuda_sweep.MP_KAPPA, mpd_src, rep + "871"),
            "pbf_lambda": (cuda_sweep.PBF_LAMBDA, pbf_src, rep + "949"),
            "pbf_dp": (cuda_sweep.PBF_DP, pbf_src, rep + "1044"),
            "pbf_omega": (cuda_sweep.PBF_OMEGA, pbf_src, rep + "1019"),
            # N: pbf_lambda_pair's sums over the fluid rows
            "pbf_grad": (cuda_sweep.PBF_GRAD, pbf_src, rep + "949"),
            "force_moving": (cuda_sweep.FORCE_MOVING, sph_src, rep + "326"),
            "force_p0_moving": (cuda_sweep.FORCE_P0_MOVING, sph_src,
                                rep + "326"),
            "mp_force_moving": (cuda_sweep.MP_FORCE_MOVING, mp_src,
                                rep + "710"),
            "body_density": (cuda_sweep.BODY_DENSITY, sph_src, rep + "1193"),
            "body_force": (cuda_sweep.BODY_FORCE, cpl_src, rep + "326"),
            "mp_body": (cuda_sweep.MP_BODY, cpl_src, rep + "757"),
            "elastic_f": (cuda_sweep.ELASTIC_F, el_src, rep + "1092"),
            # elastic_force_pair (:1113) and elastic_hourglass_pair
            # (:1139), fused
            "elastic_force_hg": (cuda_sweep.ELASTIC_FORCE_HG, el_src,
                                 rep + "1113"),
            "fluid_reaction": (cuda_sweep.FLUID_REACTION, el_src,
                               rep + "409"),
            "body_force_p0": (cuda_sweep.BODY_FORCE_P0, cpl_src,
                              rep + "326"),
            "fluid_reaction_p0": (cuda_sweep.FLUID_REACTION_P0, el_src,
                                  rep + "409"),
            "pressure_force_body": (cuda_sweep.PRESSURE_FORCE_BODY,
                                    iisph_src, rep + "922"),
            # the same pair, the elastic samples as queries against the
            # fluid rows (the reverse κ)
            "pressure_force_body_rev": (cuda_sweep.PRESSURE_FORCE_BODY_REV,
                                        iisph_src, rep + "922"),
            # density_sweep (:1193) and alpha_pair (:578) over a shell,
            # fused
            "body_density_alpha": (cuda_sweep.BODY_DENSITY_ALPHA, dfsph_src,
                                   rep + "1193,578"),
            "body_density_alpha_sq": (cuda_sweep.BODY_DENSITY_ALPHA_SQ,
                                      dfsph_src, rep + "1193,578"),
            "drho_shell": (cuda_sweep.DRHO_SHELL, dfsph_src, rep + "903"),
            "mp_alpha_body": (cuda_sweep.MP_ALPHA_BODY, mpd_src, rep + "820"),
            "mp_drho_body": (cuda_sweep.MP_DRHO_BODY, mpd_src, rep + "854"),
            "mp_kappa_body": (cuda_sweep.MP_KAPPA_BODY, mpd_src,
                              rep + "887"),
            "wall_force": (cuda_sweep.WALL_FORCE, sph_src, rep + "1236"),
            "wall_force_p0": (cuda_sweep.WALL_FORCE_P0, sph_src,
                              rep + "1236"),
            "cell_check": (cuda_sweep.CELL_CHECK,
                           "nereus_tpu_torch/csrc/cell_check.cu",
                           "tools/wideprobe.py:35"),
            "layout_aos": (cuda_sweep.LAYOUT_AOS,
                           "nereus_tpu_torch/csrc/layout_probe.cu",
                           "tools/probe_transposed.py:101"),
            "layout_soa": (cuda_sweep.LAYOUT_SOA,
                           "nereus_tpu_torch/csrc/layout_probe.cu",
                           "tools/probe_transposed.py:101")}
    kernels = []
    for path, t, path_launches in (
            ("wcsph_1M", timing, wcsph_launches),
            ("iisph_1M_settled", iisph_timing, iisph_launches),
            ("pcisph_256k_settled", pcisph_timing, pcisph_launches),
            ("dfsph_256k_settled", dfsph_timing, dfsph_launches),
            ("multiphase_1M", mp_timing, mp_launches),
            ("wcsph_1M_xsph", xsph_timing, xsph_launches),
            ("wcsph_1M_visc", wvisc_timing, wvisc_launches),
            ("dfsph_visc_256k_settled", dvisc_timing, dvisc_launches),
            ("dfsph_mp_256k_settled", dmp_timing, dmp_launches),
            ("pbf_1M", pbf_timing, pbf_launches),
            ("pbf_256k_settled", pbfs_timing, pbfs_launches),
            ("pbf_1M_vort_xsph", pbfv_timing, pbfv_launches),
            ("wcsph_1M_wavemaker", wm_timing, wm_launches),
            ("multiphase_1M_wavemaker", mwm_timing, mwm_launches),
            ("dfsph_256k_wavemaker", dwm_timing, dwm_launches),
            ("mp_coupled_256k", mpc_timing, mpc_launches),
            ("coupled_256k", cpl_timing, cpl_launches),
            ("elastic_512k", el_timing, el_launches),
            ("elastic_plastic_512k", elp_timing, elp_launches),
            ("wcsph_elastic_256k", wel_timing, wel_launches),
            ("dfsph_coupled_256k", dcp_timing, dcp_launches),
            ("dfsph_mp_coupled_256k", dmc_timing, dmc_launches),
            ("dfsph_elastic_256k", dec_timing, dec_launches),
            ("wcsph_wide12M", wide_timing, wide_launches),
            ("wcsph_1M_lifecycle", life_timing, life_launches),
            ("wcsph_1M_wall_force", wall_timing, wall_launches),
            ("layout_probe", layout_timing, layout_launches)):
        ran = {k for k, c in path_launches.items() if c}
        held = {info[key][0].name for key in t}
        if ran != held:
            fail(f"{path}: kernels launched {sorted(ran)} but held against "
                 f"their plain versions {sorted(held)}")
        for key, (err, kms, pms, bms, by, brms, *extra) in t.items():
            kern, src, replaces = info[key]
            kernels.append({
                **({("tiled" if "tile" in extra[0] else "grouped"): extra[0]}
                   if extra else {}),
                "name": kern.name, "route": "cuda", "source": src,
                "replaces": replaces, "path": path, "op": key,
                "launches": path_launches[kern.name], "max_abs_err": err,
                "ms": kms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                "bound_ranges_ms": brms,
                # no single PyTorch call computes a range-walk neighbor
                # sweep, a clamped cell index or the probe's windows
                "library_ms": None})
    print(f"total wall time {time.perf_counter() - t_run:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
