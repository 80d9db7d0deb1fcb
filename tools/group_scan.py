"""Time the lane-group kernels of the PyTorch port at several lane counts G
on one path's operands, beside the one-thread walks they replace, on one
CUDA card.

    python3 tools/group_scan.py [--solver pbf|pbf_settled|pbf_vort_xsph|
                                 xsph|iisph|elastic|wcsph_elastic|dfsph|
                                 dfsph_visc|
                                 multiphase|multiphase_wavemaker|dfsph_mp|
                                 mp_coupled|dfsph_mp_coupled|coupled|
                                 dfsph_coupled|dfsph_elastic]
        [--groups 1 2 4]
        [--keys pbf_lambda pbf_dp pbf_grad pbf_omega xsph drho alpha
                density_alpha elastic_force_hg elastic_f mp_force
                mp_force_moving mp_drho mp_drho_cols mp_kappa
                multiphase_density pressure_force_body
                pressure_force_body_rev drho_shell dii_aii body_force
                body_force_p0 mp_density_alpha body_density_alpha
                body_density_alpha_sq mp_kappa_body]

The port's own library builds only the G that ``ops/cuda_sweep.py`` can
pick. This tool compiles libraries of its own from the same sources: per
source file of the keys asked for, one file that includes it (its
functors) and adds one entry point per variant of each key, built for
every G asked for, into ``nereus_tpu_torch/build/scan/``, all
compiled at once, and prints ptxas's registers and spills of each
instance. A key names its variants (``FUNCTORS``), each a functor and an
engine: the range walk ``NEREUS_GROUP_SWEEP`` of ``csrc/group_sweep.cuh``
(G 1 loads the next candidate's row ahead), its list form
``NEREUS_LIST_SWEEP`` over a static pair list, or ``pair_sweep_kernel``'s
one-thread walk ``NEREUS_PAIR_SWEEP`` (the parent's, "parent"; another
functor's, "masked"). ``elastic_force_hg``
is the elastic force + hourglass kernel over the body's pair list,
``elastic_f`` the deformation-gradient kernel over it ("G") beside the
same pair walked over the body's (9, N) ranges by ``pair_sweep_kernel``,
the candidate tested against the cutoff first ("parent"); ``mp_force`` and
``mp_force_moving`` the multiphase force's Becker instances (static and
moving walls); ``mp_drho`` the dδ̂/dt kernel, which forms its one (N,)
rate in its epilogue, and ``mp_drho_cols`` the same walk without the
epilogue, writing the fluid and wall sums as two columns, timed with the
multiply and add that then form the rate (``d[:, 0] + q[:, 6] * d[:, 1]``)
and checked after them; ``mp_kappa`` the κV̂² correction (the lane groups
by G beside the port's one-thread walk); ``pressure_force_body`` the κ
impulse of a body shell on the fluid (the lane groups by G,
``MaskedForm<BodyPressureForce>`` on ``pair_sweep_kernel``, the
parent's ``BoundaryForm<PressureForce>``) and ``pressure_force_body_rev``
its reverse, a body's samples over the fluid rows; ``drho_shell`` Dρ/Dt over
a body shell (the lane groups by G, ``MaskedForm<Drho>`` on
``pair_sweep_kernel``, "masked"); ``dii_aii`` IISPH's pre-loop sweep of
d_ii, ρ_adv and a_ii on the port's one (C + Mb, 12) matrix ("G") and on the
parent's two operands ("split": a (C, 12) query ``x y z v_adv v 1/ρ² 0 0``
beside an 8-wide source ``x y z v_adv m 0``, walls ``x y z v_b ψ_b 0``),
each at every G, and each also timed with its operands built as a step
builds them ("columns": the one matrix stacked column by column into its
rows); ``xsph`` and ``pbf_omega`` XSPH and PBF's vorticity ω on their one
(C, 8) matrix (the lane groups by G) beside the one-thread walk of the
pair as it was before it moved onto lane groups ("thread": both float4s
of every candidate's row loaded, the pair on every candidate and masked
by the cutoff, XSPH's exact division skipped outside it), each also timed
with its operands built as a step builds them (G: the one matrix through
planes; thread: XSPH's query and source, ω's one matrix, each stacked
column by column); ``multiphase_density`` the number density on its one
matrix (the lane groups by G) beside the parent's one-thread walk
("thread": every candidate's W, masked by the cutoff), each also timed
with its operands built (G: the step's one matrix; thread: the parent's
query stacked column by column and copied again behind the walls, at the
multiphase DFSPH paths also the α sweep's own pair of them, which the
change's shared matrix replaces), and the density kernel timed on the
same matrix beside them; ``density_alpha`` DFSPH's density and α
in one walk on the density's matrix ("B", by G) beside the density kernel
followed by α's sums alone and α formed in torch as the step formed it
("A": the sums on the lane groups over the same matrix, by G; "thread":
the parent's one-thread walk over its 8-wide source ``x y z v ψ 0``, also
timed with that source built as the parent's step built it), and
``alpha`` α's sums alone ("A" by G, "thread"), checked against the
columns of the couplings' form ``density_alpha_sums``. ``body_force``
and ``body_force_p0`` the body contact force with and without the Akinci
pressure (the lane groups by G) beside the one-thread walk it replaced
("thread": both float4s of every candidate's row loaded, the pair on
every candidate and masked by the cutoff), each on the operands its path
builds for it; ``mp_density_alpha`` the multiphase DFSPH density and
α̂'s sums in one walk (the lane groups by G) beside the parent's step
("thread": the multiphase density kernel and α̂'s one-thread walk, each
on the same matrix), each also timed with that matrix built;
``body_density_alpha`` and ``body_density_alpha_sq`` a body shell's
ψ-density and α's shell sums in one walk, their boundary form (the
rigid box) and their fluid form (the elastic cube under strong
coupling), by G, beside the parent's step ("thread": the density kernel
over the shell at ``body_group``'s G and α's one-thread walk, every
candidate masked, ``BoundaryForm<MaskedForm<AlphaSums>>`` /
``MaskedForm<AlphaSums>``); ``mp_kappa_body`` the multiphase κ̂
correction over a shell (the lane groups by G,
``GroupBoundaryForm<MultiphaseKappa>``) beside the parent's one-thread
walk ("thread", ``BoundaryForm<MaskedForm<MultiphaseKappa>>``); these
three also timed with the shell's ``x y z ψ_b`` rows built from its
8-wide rows, as the step builds them (``Shell.src4``), on both sides.

It drives the path as ``tools/step_turns.py`` does (``chip_smoke.py``'s
``pbf_main_path`` or ``settled_main_path`` and ``run_steps``) and builds
the kernels' operands with ``chip_smoke.py``'s ``pbf_path_operands`` (at
the state advected from the final one; ``--keys pbf_grad``, ``pbf_omega``
or ``xsph`` take the vorticity path's operands) or ``dfsph_operands`` (at
the final state); xsph runs ``wcsph_1M_xsph`` (``wcsph_main_path`` and
``run_wcsph`` with ``XSPH_EPS``, ``N_STEPS`` steps) and takes
``xsph_path_operands`` at the final state; iisph runs
``iisph_1M_settled`` (``settled_main_path``, 60 steps) and takes
``iisph_operands`` at the final state. The multiphase paths run
``multiphase_1M`` (``wcsph_main_path`` split by ``two_phase``,
``N_STEPS`` steps), ``multiphase_1M_wavemaker``
(the same under ``wavemaker``), ``dfsph_mp_256k_settled``
(``settled_main_path``), ``mp_coupled_256k`` (``coupled_scene``) or
``dfsph_mp_coupled_256k`` (``dfsph_coupled_scene(kind="mp")``, the final
state lowered to 0.5·h over the floor as ``run_dfsph_coupled`` holds its
fluid kernels) and build their operands with ``multiphase_operands``,
``mp_dfsph_operands`` or ``coupled_operands``; the elastic paths build
their body (``elastic_block``, the 80³ block of elastic_512k, or
``wcsph_elastic_scene``'s 16³ cube) and take ``elastic_kernel_ops`` at
``deformed`` positions, as ``chip_smoke.py`` holds the kernel, without
steps; the DFSPH couplings ``dfsph_coupled_256k`` and
``dfsph_elastic_256k`` (``dfsph_coupled_scene``, 60 steps) take the body
sweeps' operands of ``dfsph_coupled_held_ops``, the body in the middle of
the lowered fluid; coupled takes ``coupled_256k``'s first-step operands
(``coupled_scene``, ``coupled_operands``) and wcsph_elastic, for
``body_force``, ``wcsph_elastic_256k`` after 60 steps with the cube
moved into the middle of the fluid (``elastic_coupled_ops``). Each
variant's output is checked against the wrapper's
(``chip_smoke.py``'s ``check_lambda`` for λ, max|Δ| ≤ 1e-4·max|ref| per
column for the others) and timed host-free (``chip_smoke.graph_ms``) in
three interleaved rounds, the better of each.
"""

import argparse
import dataclasses
import ctypes
import os
import re
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
import nereus_tpu_torch as nt  # noqa: E402
from nereus_tpu_torch.ops import cuda_sweep, sph_pairs as SP  # noqa: E402
from nereus_tpu_torch.solvers import pbf_cuda  # noqa: E402
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx  # noqa

# key → (source of its functor, [(variant, engine, functor)]): engine
# "ranges" (NEREUS_GROUP_SWEEP) or "list" (NEREUS_LIST_SWEEP), scanned over
# --groups; "pair" (NEREUS_PAIR_SWEEP), a one-thread walk, once
FUNCTORS = {"pbf_lambda": ("pbf_sweep.cu", [("G", "ranges", "PbfLambda")]),
            "pbf_dp": ("pbf_sweep.cu", [("G", "ranges", "PbfDp")]),
            "pbf_grad": ("pbf_sweep.cu", [("G", "ranges", "PbfGrad")]),
            "pbf_omega": ("pbf_sweep.cu", [
                ("G", "ranges", "PbfOmega"),
                ("thread", "pair", "PbfOmegaWalk")]),
            "xsph": ("multiphase_sweep.cu", [
                ("G", "ranges", "Xsph"),
                ("thread", "pair", "XsphWalk")]),
            "drho": ("dfsph_sweep.cu", [("G", "ranges", "Drho")]),
            "alpha": ("dfsph_sweep.cu", [
                ("A", "ranges", "AlphaSums"),
                ("thread", "pair", "AlphaWalk")]),
            "density_alpha": ("dfsph_sweep.cu", [
                ("B", "ranges", "DensityAlpha<false>"),
                ("A", "ranges", "AlphaSums"),
                ("thread", "pair", "AlphaWalk")]),
            "multiphase_density": ("multiphase_sweep.cu", [
                ("G", "ranges", "MultiphaseDensity"),
                ("thread", "pair", "MultiphaseDensityWalk")]),
            "elastic_force_hg": ("elastic_sweep.cu",
                                 [("G", "list", "ElasticForceHourglass")]),
            "elastic_f": ("elastic_sweep.cu", [
                ("G", "list", "ElasticF"),
                ("parent", "pair", "ElasticFRange")]),
            "mp_force": ("multiphase_sweep.cu",
                         [("G", "ranges", "MultiphaseForce<true, false>")]),
            "mp_force_moving": ("multiphase_sweep.cu", [
                ("G", "ranges", "MultiphaseForce<true, true>")]),
            "mp_drho": ("dfsph_multiphase_sweep.cu",
                        [("G", "ranges", "MultiphaseDrho")]),
            "mp_drho_cols": ("dfsph_multiphase_sweep.cu",
                             [("G", "ranges", "MultiphaseDrhoCols")]),
            "mp_kappa": ("dfsph_multiphase_sweep.cu", [
                ("G", "ranges", "MultiphaseKappa"),
                ("parent", "pair", "MultiphaseKappa")]),
            "pressure_force_body": ("iisph_sweep.cu", [
                ("G", "ranges", "BodyPressureForce"),
                ("masked", "pair",
                 "nereus_sweep::MaskedForm<BodyPressureForce>"),
                ("parent", "pair",
                 "nereus_sweep::BoundaryForm<PressureForce>")]),
            "pressure_force_body_rev": ("iisph_sweep.cu", [
                ("G", "ranges", "BodyPressureForce"),
                ("parent", "pair",
                 "nereus_sweep::BoundaryForm<PressureForce>")]),
            "drho_shell": ("dfsph_sweep.cu", [
                ("G", "ranges", "DrhoShell"),
                ("masked", "pair", "nereus_sweep::MaskedForm<Drho>")]),
            "dii_aii": ("iisph_sweep.cu", [
                ("G", "ranges", "DiiAii"),
                ("columns", "ranges", "DiiAii"),
                ("split", "ranges", "DiiAiiSplit")]),
            "body_force": ("coupled_sweep.cu", [
                ("G", "ranges", "BodyForce<true>"),
                ("thread", "pair", "BodyForceWalk<true>")]),
            "body_force_p0": ("coupled_sweep.cu", [
                ("G", "ranges", "BodyForce<false>"),
                ("thread", "pair", "BodyForceWalk<false>")]),
            "mp_density_alpha": ("dfsph_multiphase_sweep.cu", [
                ("G", "ranges", "MultiphaseDensityAlpha"),
                ("thread", "pair", "MultiphaseAlpha")]),
            "body_density_alpha": ("dfsph_sweep.cu", [
                ("G", "ranges", "ShellDensityAlpha<false>"),
                ("thread", "pair",
                 "nereus_sweep::BoundaryForm<"
                 "nereus_sweep::MaskedForm<AlphaSums>>")]),
            "body_density_alpha_sq": ("dfsph_sweep.cu", [
                ("G", "ranges", "ShellDensityAlpha<true>"),
                ("thread", "pair", "nereus_sweep::MaskedForm<AlphaSums>")]),
            "mp_kappa_body": ("dfsph_multiphase_sweep.cu", [
                ("G", "ranges",
                 "nereus_sweep::GroupBoundaryForm<MultiphaseKappa>"),
                ("thread", "pair",
                 "nereus_sweep::BoundaryForm<"
                 "nereus_sweep::MaskedForm<MultiphaseKappa>>")])}
# functors the scan file defines (by name, without template arguments):
# dδ̂/dt's pair without its epilogue, ElasticF's pair behind the range
# walk's cutoff test, α's sums alone (AlphaSums, the lane-group pair whose
# MaskedForm was α's one-thread walk over a shell), and the one-thread
# walks of XSPH, ω, α's sums, the multiphase density and the body contact
# force as they were before they moved onto lane groups
SCAN_FUNCTORS = {"AlphaSums": """
struct AlphaSums {
  static constexpr int QW = 4, SW = 4, OW = 4;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const nereus_sweep::Geom g = nereus_sweep::default_geom<KS>(q, a, p);
    const float c = a.w * g.s;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
    if constexpr (!B) acc[3] += c * c * g.r2;
  }
};
""", "BodyForceWalk": """
template <bool PRESSURE>
struct BodyForceWalk {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const BodyGeom g = body_geom<KS>(q, src, j, p);
    const float di = fmaxf(q[6], 1e-12f);
    const float nu = ((2.0f * p.pm * p.pm * p.visc * p.visc * p.h * p.cs) /
                      (1.0f + 0.01f * p.h2)) /
                     (di * di);
    const float cfric = nu * fmaxf(g.vdotr, 0.0f) * g.psi * g.s;
    float c = cfric;
    if constexpr (PRESSURE) {
      c = cfric + (-p.pm) * g.psi * fmaxf(q[7], 0.0f) * g.s;
    }
    c *= g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};
""", "MultiphaseDensityWalk": """
struct MultiphaseDensityWalk {
  static constexpr int QW = 4, SW = 4, OW = 2;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 a = nereus_sweep::src_f4(src, SW, j, 0);
    const WGeom g = w_geom<KS>(q, a, p);
    if constexpr (B) {
      acc[1] += a.w * g.w * g.okf;
    } else {
      acc[0] += g.w * g.okf;
    }
  }
};
""", "AlphaWalk": """
struct AlphaWalk {
  static constexpr int QW = 4, SW = 8, OW = 4;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 a = nereus_sweep::src_f4(src, SW, j, 0);
    const float psi = nereus_sweep::src_f4(src, SW, j, 1).z;
    const nereus_sweep::Geom g = nereus_sweep::default_geom<KS>(q, a, p);
    const float c = psi * g.s * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
    if constexpr (!B) acc[3] += c * c * g.r2;
  }
};
""", "XsphWalk": """
struct XsphWalk {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 a = nereus_sweep::src_f4(src, SW, j, 0);
    const float4 b = nereus_sweep::src_f4(src, SW, j, 1);
    const WGeom g = w_geom<KS>(q, a, p);
    const float denom = fmaxf(q[6] + b.z, 1e-12f);
    const float c = g.okf != 0.0f ? (2.0f * p.pm) * g.w / denom : 0.0f;
    acc[0] += c * (a.w - q[3]);
    acc[1] += c * (b.x - q[4]);
    acc[2] += c * (b.y - q[5]);
  }
};
""", "PbfOmegaWalk": """
struct PbfOmegaWalk {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 a = nereus_sweep::src_f4(src, SW, j, 0);
    const float4 b = nereus_sweep::src_f4(src, SW, j, 1);
    const nereus_sweep::Geom g = nereus_sweep::default_geom<KS>(q, a, p);
    const float c = b.z * g.s * g.okf;
    const float dvx = a.w - q[3];
    const float dvy = b.x - q[4];
    const float dvz = b.y - q[5];
    acc[0] += c * (dvy * g.dz - dvz * g.dy);
    acc[1] += c * (dvz * g.dx - dvx * g.dz);
    acc[2] += c * (dvx * g.dy - dvy * g.dx);
  }
};
""", "ElasticFRange": """
struct ElasticFRange {
  static constexpr int QW = ElasticF::QW, SW = ElasticF::SW,
                       OW = ElasticF::OW;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 a = nereus_sweep::src_f4(src, SW, j, 0);
    const float dx = q[0] - a.x;
    const float dy = q[1] - a.y;
    const float dz = q[2] - a.z;
    if (!(dx * dx + dy * dy + dz * dz < p.h2)) return;
    ElasticF::pair<KS, B>(q, a, src, j, p, acc);
  }
};
""", "MultiphaseDrhoCols": """
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
""", "DiiAiiSplit": """
struct DiiAiiSplit {
  static constexpr int QW = 12, SW = 8, OW = 5, OUTW = 5;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j,
                              const nereus_sweep::Params& p,
                              float (&acc)[OW]) {
    const float4 b = nereus_sweep::src_f4(src, SW, j, 1);
    const nereus_sweep::Geom g = nereus_sweep::default_geom<KS>(q, a, p);
    const float c = b.z * g.s;
    constexpr int o = B ? 6 : 3;
    const float dvx = q[o] - a.w;
    const float dvy = q[o + 1] - b.x;
    const float dvz = q[o + 2] - b.y;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
    acc[3] += c * g.s * g.r2;
    acc[4] += c * (dvx * g.dx + dvy * g.dy + dvz * g.dz);
  }
  __device__ static void epilogue(const float (&q)[QW],
                                  const float (&acc)[OW],
                                  const nereus_sweep::Params& p,
                                  float (&o)[OUTW]) {
    const float inv = q[9];
    o[0] = -inv * acc[0];
    o[1] = -inv * acc[1];
    o[2] = -inv * acc[2];
    o[3] = p.dt * acc[4];
    o[4] = (o[0] * acc[0] + o[1] * acc[1] + o[2] * acc[2]) -
           (p.pm * inv) * acc[3];
  }
};
"""}


def split_operands(args):
    """The parent's two operands of the d_ii, ρ_adv and a_ii sweep from the
    port's one (C + Mb, 12) matrix: the (C, 12) query ``x y z v_adv v 1/ρ²
    0 0`` and the (C + Mb, 8) source ``x y z v_adv m 0`` (walls ``x y z v_b
    ψ_b 0``)."""
    q, src, s, e, pv = args
    z = q.new_zeros((q.shape[0], 2))
    src8 = src[:, :8].clone()
    src8[:, 7] = 0.0
    return (torch.cat([q[:, :6], q[:, 7:11], z], dim=1), src8, s, e, pv)


# the elastic body's (9, N) reference ranges, for ElasticF's range walk
RANGES = {}


def range_operands(args):
    """ElasticF's pair-list operands with the body's ranges in the list's
    places."""
    q, src, _, _, pv = args
    return (q, src, *RANGES["elastic"], pv)


def alpha8_operands(args):
    """The parent's α operands from the density's ``(q, src4, ...)``: the
    8-wide source ``x y z 0 0 0 ψ 0`` (walls ``x y z v_b ψ_b 0``, whose
    velocity the pair never reads)."""
    q, src4, s, e, pv = args
    src8 = src4.new_zeros((src4.shape[0], 8))
    src8[:, :3] = src4[:, :3]
    src8[:, 6] = src4[:, 3]
    return (q, src8, s, e, pv)


# variants fed other operands than the wrapper's: functor → converter
VARIANT_OPERANDS = {"DiiAiiSplit": split_operands,
                    "ElasticFRange": range_operands,
                    "AlphaWalk": alpha8_operands}
# (key, variant) pairs timed as the parent's step ran them: α's sums alone
# with the density kernel before them and α formed in torch after them;
# the multiphase α̂'s walk with the multiphase density kernel beside it
COMPOSED = {("density_alpha", "A"), ("density_alpha", "thread"),
            ("mp_density_alpha", "thread"), ("body_density_alpha", "thread"),
            ("body_density_alpha_sq", "thread")}


def dii_aii_makers(ctx, params, args):
    """``{variant: build}`` of the d_ii, ρ_adv and a_ii sweep: ``build()``
    makes the variant's operands as a step would, from the step's columns
    (v_adv, 1/ρ², taken from the one matrix ``args``, and the sorted
    state's v): "G" by ``iisph_cuda.dii_aii_operands`` (through planes,
    ``SweepCtx.pack_wide``), "columns" the same matrix stacked column by
    column into its rows (``SweepCtx._one_matrix``), "split" its query
    and its source each stacked in place (the walls copied behind)."""
    from nereus_tpu_torch.solvers import iisph_cuda
    c, src = ctx.c, args[1]
    vel_adv = [src[:c, k].clone() for k in (3, 4, 5)]
    inv = src[:c, 10].clone()
    pm = params.particle_mass
    vel = (ctx.vx, ctx.vy, ctx.vz)
    z = torch.zeros_like(inv)

    def split():
        q = ctx.queries(*vel_adv, *vel, inv, width=12)
        return (q, ctx._one_matrix([*vel_adv, pm.expand(c), z],
                                   ctx.b_src)[1], *args[2:])

    def columns():
        m = ctx._one_matrix([*vel_adv, pm.expand(c), *vel, inv, z],
                            ctx._b_src_wide)[1]
        return (m[:c], m, *args[2:])
    return {"G": lambda: iisph_cuda.dii_aii_operands(ctx, vel_adv, pm, inv),
            "split": split, "columns": columns}


def fluid_matrix_makers(ctx, args, build, own_query):
    """``{variant: build}`` of a sweep over the fluid rows on one (C, 8)
    matrix ``x y z v s 0`` (``args``), from its columns: "G" by the step's
    own ``build(ctx, v, s)`` (through planes), "thread" as the step built
    its operands before, the source stacked column by column
    (``SweepCtx.pack``) and, with ``own_query`` (XSPH), the query stacked
    apart (``SweepCtx.queries``), else the source as both (ω)."""
    m = args[0]
    v = [m[:, k].clone() for k in (3, 4, 5)]
    col = m[:, 6].clone()

    def thread():
        src = ctx.pack(v, col, boundary=False)
        q = ctx.queries(*v, col, width=8) if own_query else src
        return (q, src, *args[2:])
    return {"G": lambda: build(ctx, v, col), "thread": thread}


def alpha_sums(cfg, q, src, s, e, pv):
    """α's sums (N, 4), rows: columns 1-4 of the couplings' form of the
    density and α kernel on the same operands."""
    return cuda_sweep.density_alpha_sums_sweep(cfg, q, src, s, e,
                                               pv)[:, 1:].contiguous()


def alpha_makers(ctx, params):
    """``{variant: build}`` of DFSPH's density and α: both sides build the
    density's one matrix (``SweepCtx.density_operands``); the parent's
    one-thread walk ("thread") also its 8-wide source, built as its step
    built it (``SweepCtx.pack``)."""
    pm = params.particle_mass

    def thread():
        q, _, *rest = ctx.density_operands(pm)
        return (q, ctx.pack((ctx.vx, ctx.vy, ctx.vz), pm), *rest)
    return {"B": lambda: ctx.density_operands(pm),
            "A": lambda: ctx.density_operands(pm), "thread": thread}


def mp_density_makers(ctx, dfsph):
    """``{variant: build}`` of the multiphase density: "G" the step's one
    matrix (``wcsph_cuda.multiphase_density_operands``; on the multiphase
    DFSPH paths ``dfsph_cuda.multiphase_alpha_operands``, which the α
    sweep shares); "thread" the parent's query stacked column by column
    and copied again behind the walls (``SweepCtx.pack_psi``), on the
    DFSPH paths with the α sweep's own pair built after it."""
    from nereus_tpu_torch.solvers import dfsph_cuda, wcsph_cuda
    rest = (ctx.seg_start, ctx.seg_end, ctx.pvec)

    def thread():
        q = ctx.queries(width=4)
        src = ctx.pack_psi(q)
        if dfsph:
            ctx.pack_psi(ctx.queries(1.0 / ctx.mass))
        return (q, src, *rest)
    return {"G": lambda: (dfsph_cuda.multiphase_alpha_operands(ctx) if dfsph
                          else wcsph_cuda.multiphase_density_operands(ctx)),
            "thread": thread}


def shell_makers(args, src8):
    """``{variant: build}`` of a sweep over a body shell's ``x y z ψ_b``
    rows (``args``): both sides build them from the shell's 8-wide rows
    ``src8`` (ψ_b in slot 6) as the step does (``Shell.src4``, one
    ``psi_rows``); the queries are the step's own."""
    from nereus_tpu_torch.solvers.sweep_common import psi_rows

    def build():
        return (args[0], psi_rows(src8), *args[2:])
    return {"G": build, "thread": build}


# per key, the makers of its variants' operands (time with the build)
MAKERS = {}
# the keys each path's operands feed
PATH_KEYS = {"pbf": ("pbf_lambda", "pbf_dp", "pbf_grad", "pbf_omega",
                     "xsph"),
             "xsph": ("xsph",),
             "dfsph": ("drho", "alpha", "density_alpha"),
             "elastic": ("elastic_force_hg", "elastic_f"),
             "wcsph_elastic": ("elastic_force_hg", "elastic_f",
                               "body_force"),
             "coupled": ("body_force",),
             "multiphase": ("mp_force", "multiphase_density"),
             "multiphase_wavemaker": ("mp_force_moving",),
             "dfsph_mp": ("mp_force", "mp_drho", "mp_drho_cols", "mp_kappa",
                          "multiphase_density", "mp_density_alpha"),
             "mp_coupled": ("mp_force",),
             "dfsph_mp_coupled": ("mp_force", "mp_drho", "mp_drho_cols",
                                  "mp_kappa", "mp_density_alpha",
                                  "mp_kappa_body"),
             "dfsph_coupled": ("pressure_force_body", "drho_shell",
                               "body_force_p0", "body_density_alpha"),
             "dfsph_elastic": ("pressure_force_body",
                               "pressure_force_body_rev", "drho_shell",
                               "body_force_p0", "body_density_alpha_sq"),
             "iisph": ("dii_aii",)}
MP_SOLVERS = ("multiphase", "multiphase_wavemaker", "dfsph_mp", "mp_coupled",
              "dfsph_mp_coupled")
BODY_SOLVERS = ("coupled", "wcsph_elastic", "dfsph_coupled",
                "dfsph_elastic")
SCAN_DIR = os.path.join(cuda_sweep.BUILD_DIR, "scan")
MACROS = {"ranges": "NEREUS_GROUP_SWEEP", "list": "NEREUS_LIST_SWEEP",
          "pair": "NEREUS_PAIR_SWEEP"}


def build(keys, groups):
    """``{(key, variant): ctypes function}``: entry
    ``nereus_scan_<key>_<k>_sweep`` (``_list_sweep``) per variant k of each
    key, built for ``groups`` (a one-thread walk once),
    one library per source file, compiled at once; prints ptxas's report of
    their instances."""
    os.makedirs(SCAN_DIR, exist_ok=True)
    values = {"ranges": groups, "list": groups}
    by_src = {}
    for key in keys:
        by_src.setdefault(FUNCTORS[key][0], []).append(key)
    cmds, libs = [], {}
    for src, ks in by_src.items():
        stem = os.path.splitext(src)[0]
        cu = os.path.join(SCAN_DIR, f"scan_{stem}.cu")
        with open(cu, "w") as f:
            f.write(f'#include "{os.path.join(cuda_sweep.CSRC, src)}"\n')
            lines, written = [], set()
            for key in ks:
                for k, (_, engine, functor) in enumerate(FUNCTORS[key][1]):
                    for name in re.findall(r"\w+", functor):
                        if name in SCAN_FUNCTORS and name not in written:
                            f.write(SCAN_FUNCTORS[name])
                            written.add(name)
                    f.write(f"using scan_{key}_{k}_t = {functor};\n")
                    args = [f"scan_{key}_{k}", f"scan_{key}_{k}_t",
                            *map(str, values.get(engine, ()))]
                    lines.append(f"{MACROS[engine]}({', '.join(args)})\n")
            f.write('extern "C" {\n' + "".join(lines) + "}\n")
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
            for k, (variant, engine, functor) in enumerate(
                    FUNCTORS[key][1]):
                if engine == "list":
                    f = getattr(lib, f"nereus_scan_{key}_{k}_list_sweep")
                    f.argtypes = [ptr, ptr, ptr, ptr, i32, ptr, i32, i32,
                                  ptr, ptr]
                else:
                    f = getattr(lib, f"nereus_scan_{key}_{k}_sweep")
                    f.argtypes = ([ptr, ptr, ptr, ptr, i32, i32, ptr, i32]
                                  + ([] if engine == "pair" else [i32])
                                  + [ptr, ptr])
                f.restype = i32
                fns[key, variant] = (f, engine, values.get(engine, [None]),
                                     VARIANT_OPERANDS.get(functor))
    return fns


def path_operands(solver, keys, dev):
    """``(cfg, {key: (wrapper, args, kwargs)}, description)``: the path's
    operands of each key, each with the wrapper of the port's own
    kernel."""
    if solver in MP_SOLVERS:
        return mp_operands(solver, dev)
    if solver in BODY_SOLVERS:
        return body_operands(solver, keys, dev)
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
        ops = smoke.pbf_path_operands(
            cfg, ctx, params,
            vorticity=bool({"pbf_grad", "pbf_omega", "xsph"} & set(keys)))
        if "xsph" in ops:
            from nereus_tpu_torch.solvers import wcsph_cuda
            MAKERS["xsph"] = fluid_matrix_makers(
                ctx, ops["xsph"][2], wcsph_cuda.xsph_operands, True)
            MAKERS["pbf_omega"] = fluid_matrix_makers(
                ctx, ops["pbf_omega"][2], pbf_cuda.omega_operands, False)
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                     }, f"{ctx.c} queries, {ms:.4f} ms/step"
    if solver == "xsph":
        from nereus_tpu_torch.solvers import wcsph_cuda
        cfg, params, state, grid, boundary = smoke.wcsph_main_path(dev)
        state, _, ms, _ = smoke.run_wcsph(cfg, params, state, grid,
                                          boundary, xsph_eps=smoke.XSPH_EPS)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        ops = smoke.xsph_path_operands(cfg, ctx, params)
        MAKERS["xsph"] = fluid_matrix_makers(
            ctx, ops["xsph"][2], wcsph_cuda.xsph_operands, True)
        return cfg, {"xsph": (ops["xsph"][0], ops["xsph"][2], {})}, (
            f"{ctx.c} queries, {ms:.4f} ms/step")
    if solver == "iisph":
        cfg, params, state, grid, boundary, step = smoke.settled_main_path(
            solver, dev, smoke.MAIN_N)
        state, _, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                           smoke.IMPLICIT_TIMED_FROM)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        ops = smoke.iisph_operands(cfg, ctx, params)
        MAKERS["dii_aii"] = dii_aii_makers(ctx, params,
                                               ops["dii_aii"][2])
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                     }, f"{ctx.c} queries, {ms:.4f} ms/step"
    if solver.startswith("dfsph"):
        cfg, params, state, grid, boundary, step = smoke.settled_main_path(
            solver, dev, smoke.SETTLED_N)
        state, _, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                           smoke.IMPLICIT_TIMED_FROM)
        ctx = build_sweep_ctx(state, params, grid, cfg, boundary)
        ops = smoke.dfsph_operands(cfg, ctx, params)
        dargs = ops["density_alpha"][2]
        ops["alpha"] = (alpha_sums, None, dargs, {})
        MAKERS["density_alpha"] = alpha_makers(ctx, params)
        MAKERS["alpha"] = MAKERS["density_alpha"]
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                     }, f"{ctx.c} queries, {ms:.4f} ms/step"
    return elastic_operands(solver, dev)


def elastic_operands(solver, dev):
    """``path_operands`` of the elastic kernels over a body's statics at
    ``deformed`` positions, without steps: ``elastic_512k``'s 80³ block
    (elastic) or ``wcsph_elastic_256k``'s 16³ cube (wcsph_elastic)."""
    if solver == "elastic":
        cfg, params, ep, _, statics, grid, sp = smoke.elastic_block(dev,
                                                                    False)
    else:
        (cfg, params, _, grid, _, _, statics, ep, _,
         sp) = smoke.wcsph_elastic_scene(dev)
    ops = smoke.elastic_kernel_ops(cfg, params, grid, statics,
                                   smoke.deformed(statics.x0, sp), ep)
    RANGES["elastic"] = (statics.seg_start, statics.seg_end)
    return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()}, (
        f"{statics.n} queries, {int(statics.nbr.shape[0])} pairs in the "
        "list")


def mp_operands(solver, dev):
    """``path_operands`` of the multiphase paths (``MP_SOLVERS``): the
    multiphase force (``mp_force``; ``mp_force_moving`` under the
    wavemaker) and, on the DFSPH paths, dδ̂/dt (``mp_drho``, and
    ``mp_drho_cols`` on the same operands); on ``dfsph_mp_coupled`` also
    the shell's κ̂ correction (``mp_kappa_body``, ``dfsph_body_ops``)."""
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
        else:
            ops["multiphase_density"] = ops["mp_density"]
            MAKERS["multiphase_density"] = mp_density_makers(ctx, False)
    elif solver == "mp_coupled":
        ops = smoke.coupled_operands(cfg, ctx, params, grid, held["body"])
    else:
        from nereus_tpu_torch.solvers import dfsph_cuda
        ops = smoke.mp_dfsph_operands(cfg, ctx, params)
        ops["mp_drho_cols"] = ops["mp_drho"]
        ops["multiphase_density"] = (
            cuda_sweep.multiphase_density_sweep,
            SP.multiphase_density_sweep_plain, ops["mp_density_alpha"][2],
            {})
        MAKERS["multiphase_density"] = mp_density_makers(ctx, True)
        # both sides walk the one matrix the step builds
        build = {v: (lambda: dfsph_cuda.multiphase_alpha_operands(ctx))
                 for v in ("G", "thread")}
        MAKERS["mp_density_alpha"] = build
        if solver == "dfsph_mp_coupled":
            # the shell's κ̂ correction with the body moved, at its last
            # velocities, into the middle of the lowered fluid, as
            # dfsph_coupled_held_ops holds it
            n = int(state.num_active)
            body = dataclasses.replace(held["body"],
                                       com=state.pos[:n].mean(dim=0))
            bops = smoke.dfsph_body_ops(cfg, ctx, params, grid, body)
            ops["mp_kappa_body"] = bops["mp_kappa_body"]
            MAKERS["mp_kappa_body"] = shell_makers(
                bops["mp_kappa_body"][2], bops["mp_drho_body"][2][1])
    return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()
                 }, f"{ctx.c} queries, {ms:.4f} ms/step"


def body_operands(solver, keys, dev):
    """``path_operands`` of the body paths (``BODY_SOLVERS``).
    ``coupled_256k`` (coupled): the body contact force (``body_force``) on
    the first step's operands, as ``run_coupled`` holds it (the body meets
    the water in the first step). ``wcsph_elastic_256k`` (wcsph_elastic):
    with ``body_force`` asked for, 60 steps at 4 substeps, then the body
    contact force with the cube moved into the middle of the fluid as
    ``run_wcsph_elastic`` holds it, beside the elastic kernels on the
    body's statics (else those alone, without steps).
    ``dfsph_coupled_256k`` and ``dfsph_elastic_256k``
    (``dfsph_coupled_scene``, ``kind`` "rigid" and "elastic", 60 steps):
    the κ impulse forward (``pressure_force_body``) and, on the elastic
    path, reverse (``pressure_force_body_rev``), the shell's Dρ/Dt
    (``drho_shell``), the friction alone (``body_force_p0``) and the
    shell's ψ-density with α's sums (``body_density_alpha``; on the
    elastic path ``body_density_alpha_sq``), with the body moved into the
    middle of the lowered fluid as ``run_dfsph_coupled`` holds them
    (``dfsph_coupled_held_ops``)."""
    if solver == "coupled":
        cfg, params, state, grid, walls, body = smoke.coupled_scene(dev,
                                                                    False)
        ctx = build_sweep_ctx(state, params, grid, cfg, walls)
        ops = smoke.coupled_operands(cfg, ctx, params, grid, body)
        q, src = ops["body_force"][2][:2]
        return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw)
                     in ops.items()}, (
            f"{q.shape[0]} queries over {src.shape[0]} body samples, the "
            "first step's operands")
    if solver == "wcsph_elastic" and "body_force" not in keys:
        return elastic_operands(solver, dev)
    kind = {"wcsph_elastic": "wcsph", "dfsph_elastic": "elastic"}.get(
        solver, "rigid")
    if kind == "wcsph":
        (cfg, params, state, grid, walls, estate, statics, ep, psi,
         sp) = smoke.wcsph_elastic_scene(dev)
        held = {"body": estate}
        body = None
    else:
        cfg, params, state, grid, walls, body = smoke.dfsph_coupled_scene(
            dev, kind)
        held = {"body": body[0] if kind == "elastic" else body}
    kw = dict(tol=smoke.DFSPH_TOL, tol_v=smoke.DFSPH_TOL)

    def step(s):
        if kind == "wcsph":
            s, held["body"], d = nt.wcsph_elastic_step(
                s, params, grid, cfg, held["body"], statics, ep, psi, walls,
                substeps=smoke.WEL_SUBSTEPS)
        elif kind == "elastic":
            _, statics_e, ep_e, psi_e = body
            s, held["body"], d = nt.dfsph_elastic_step(
                s, params, grid, cfg, held["body"], statics_e, ep_e, psi_e,
                walls, substeps=smoke.WEL_SUBSTEPS, **kw)
        else:
            s, held["body"], d = nt.dfsph_coupled_step(
                s, params, grid, cfg, held["body"], walls, **kw)
        return s, d
    state, _, ms, *_ = smoke.run_steps(step, state, smoke.IMPLICIT_STEPS,
                                       smoke.IMPLICIT_TIMED_FROM)
    if kind == "wcsph":
        # as run_wcsph_elastic holds the contact kernels: the body moved,
        # at its last velocities, into the middle of the fluid
        ctx = build_sweep_ctx(state, params, grid, cfg, walls)
        nf = int(state.num_active)
        b = held["body"]
        inside = dataclasses.replace(
            b, pos=b.pos - b.pos.mean(dim=0) + state.pos[:nf].mean(dim=0))
        ops = smoke.elastic_coupled_ops(cfg, ctx, params, grid, inside, psi)
        ops.update(smoke.elastic_kernel_ops(
            cfg, params, grid, statics, smoke.deformed(statics.x0, sp), ep))
        RANGES["elastic"] = (statics.seg_start, statics.seg_end)
        key = "body_force"
    else:
        _, ops = smoke.dfsph_coupled_held_ops(cfg, params, state, grid,
                                              walls, held["body"], body,
                                              kind)
        for k in ("body_density_alpha", "body_density_alpha_sq"):
            if k in ops:
                MAKERS[k] = shell_makers(ops[k][2], ops["drho_shell"][2][1])
        key = "pressure_force_body"
    q, src = ops[key][2][:2]
    return cfg, {k: (kern, a, kw) for k, (kern, _, a, kw) in ops.items()}, (
        f"{q.shape[0]} queries over {src.shape[0]} body samples, "
        f"{ms:.4f} ms/step")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--solver", default="pbf",
                    choices=("pbf", "pbf_settled", "pbf_vort_xsph", "xsph",
                             "iisph", "elastic", "dfsph", "dfsph_visc",
                             *MP_SOLVERS, *BODY_SOLVERS))
    ap.add_argument("--groups", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--keys", nargs="+", choices=sorted(FUNCTORS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("group_scan: needs a CUDA card")
    family = (args.solver if args.solver in MP_SOLVERS + BODY_SOLVERS
              else "pbf" if args.solver.startswith("pbf") else "dfsph"
              if args.solver.startswith("dfsph") else args.solver
              if args.solver in ("iisph", "xsph") else "elastic")
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
        ref = kern(cfg, *a, **kwk)
        cols = key == "mp_drho_cols"

        def launch(f, engine, v, out, vargs, composed=False):
            q, src, s, e, pv = vargs
            lead = ((q.data_ptr(), src.data_ptr(), s.data_ptr(),
                     e.data_ptr(), q.shape[0])
                    + (() if engine == "list" else (s.shape[0],)))
            rc = f(*lead, pv.data_ptr(), cfg.kernel_set.value,
                   *(() if v is None else (v,)), out.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                sys.exit(f"group_scan: {key} {engine} {v} launch failed "
                         f"({rc})")
            if composed and key == "mp_density_alpha":
                # the parent's step: the multiphase density kernel and α̂'s
                # walk on the same matrix
                return cuda_sweep.multiphase_density_sweep(cfg, *a), out
            if composed and key.startswith("body_density_alpha"):
                # the parent's step: the density kernel over the shell and
                # α's walk over it
                return cuda_sweep.body_density_sweep(cfg, *vargs), out
            if composed:
                # the parent's step: the density kernel, α formed after
                dens = cuda_sweep.density_sweep(cfg, *a)
                denom = (out[:, 0] * out[:, 0] + out[:, 1] * out[:, 1]
                         + out[:, 2] * out[:, 2] + out[:, 3])
                return dens, dens / torch.clamp(denom, min=SP.ALPHA_EPS)
            # the two-column form: the rate formed after the kernel
            return out[:, 0] + q[:, 6] * out[:, 1] if cols else out
        runs = {}
        for (k, variant), (f, engine, vals, convert) in fns.items():
            if k != key:
                continue
            vargs = convert(a) if convert else a
            composed = (key, variant) in COMPOSED
            for v in vals:
                n = a[0].shape[0]
                out = (a[0].new_empty((n, 2)) if cols
                       else a[0].new_empty((n, 7)) if composed
                       and key == "mp_density_alpha"
                       else a[0].new_empty((n, 4)) if composed
                       else torch.empty_like(ref))
                got = launch(f, engine, v, out, vargs, composed)
                if composed and key == "mp_density_alpha":
                    got = torch.cat(got, dim=1)
                elif composed and key.startswith("body_density_alpha"):
                    got = torch.cat([got[0][:, None],
                                     got[1][:, :ref.shape[1] - 1]], dim=1)
                elif composed:
                    got = torch.stack(got).t()
                torch.cuda.synchronize()
                label = variant + ("" if v is None else f"{v}")
                if key == "pbf_lambda":
                    smoke.check_lambda(out, ref, a[4], f"{key} {label}")
                    torch.testing.assert_close(out[:, 0], ref[:, 0],
                                               rtol=1e-5, atol=0)
                else:
                    o2 = got.reshape(len(got), -1)
                    r2 = ref.reshape(len(ref), -1)
                    err = (o2 - r2).abs().amax(dim=0)
                    if not bool((err <= 1e-4 * r2.abs().amax(dim=0)).all()):
                        sys.exit(f"group_scan: {key} {label} differs from "
                                 f"the wrapper's output by {err.tolist()}")
                runs[label] = (f, engine, v, out, vargs, variant, composed)
        best, built = {}, {}
        for _ in range(3):
            for label, (f, engine, v, out, vargs, variant,
                        composed) in runs.items():
                t = smoke.graph_ms(lambda: launch(f, engine, v, out, vargs,
                                                  composed))
                best[label] = min(best.get(label, t), t)
                make = MAKERS.get(key, {}).get(variant)
                if make:
                    t = smoke.graph_ms(
                        lambda: launch(f, engine, v, out, make(), composed))
                    built[label] = min(built.get(label, t), t)
        wrapper = smoke.graph_ms(lambda: kern(cfg, *a, **kwk))
        print(f"{key} at {args.solver}: host-free ms: "
              + ", ".join(f"{label} {t:.4f}" for label, t in best.items())
              + f"; the wrapper's own {wrapper:.4f}")
        if key == "multiphase_density":
            dens = min(smoke.graph_ms(lambda: cuda_sweep.density_sweep(
                cfg, *a)) for _ in range(3))
            print(f"{key} at {args.solver}: the density kernel on the same "
                  f"matrix (G {cuda_sweep.density_group(a[0].shape[0])}) "
                  f"{dens:.4f}")
        if built:
            print(f"{key} at {args.solver}: host-free ms with the operands "
                  "built: " + ", ".join(f"{label} {t:.4f}"
                                        for label, t in built.items()))


if __name__ == "__main__":
    main()
