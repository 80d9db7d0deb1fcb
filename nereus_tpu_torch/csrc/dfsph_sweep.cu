// Pair functions of the single-phase DFSPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the two
// DFSPH pair functions of pallas_sph.py, alpha_pair and drho_pair, and the
// density sweep of the same step (density_pair, pallas_sph.py:1193;
// solvers/dfsph_pallas.py::dfsph_step_pallas, lines 202-214). Its kappa
// correction is the PressureForce functor of iisph_sweep.cu with kappa/rho
// in the pd2 slot. The DFSPH couplings (solvers/dfsph_coupled.py,
// dfsph_elastic.py) run density_pair with alpha_pair(include_sq=False)
// over a body shell alone (rows 0-8), or with alpha_pair as it is over a
// shell's 9 rows (the elastic body's sum |psi grad W|^2 under strong
// coupling), and drho_pair over a shell's 9 rows (the shell's sample
// velocities in Drho's velocity slots).
//
// The density and the factor alpha (once per step) are one walk,
// group_pair_sweep_kernel<DensityAlpha<SUMS>, KS, G> on the lane-group
// engine of group_sweep.cuh. What held them back: the density kernel
// walked the ranges, then alpha's one thread per query walked the same 18
// runs again in series, every candidate loading both float4s of its
// 32-byte row (of which it read x y z and psi) and running the pair,
// multiplied by 0 outside the cutoff (~85 % of the candidates). What the
// design does: G lanes per query walk the flattened fluid and wall runs of
// the density's one (C + Mb, 4) matrix x y z psi (fluid rows psi = m, wall
// rows psi_b; solvers/sweep_common.py::SweepCtx.density_operands), so the
// step builds no other matrix; a candidate's one float4 is the engine's own
// load, and inside the cutoff the pair adds psi W to rho in the density
// kernel's per-pair expression (sph_sweep.cu), so rho is the density
// kernel's at the same G, and alpha's sums. Lane 0's epilogue
// writes rho and alpha = rho / max(|sum psi grad W|^2 + sum |psi grad W|^2,
// 1e-6) as two (N,) planes (the single-phase step), or rho and the four
// sums as five (SUMS: the DFSPH couplings add a shell's sums, and under
// strong coupling its mobility, before they form alpha). G:
// ops/cuda_sweep.py::DENSITY_ALPHA_G (the one instance of each built).
// Measured at the settled 262,144-particle block (PERF.md section 6): the
// one walk took 0.0410 ms for rho and alpha, about the density kernel's
// time alone; the sums alone on the same engine and matrix (0.0410 by
// themselves, tools/group_scan.py's AlphaSums) took 0.0975 with
// the density kernel before them and alpha formed in torch after them,
// and the parent's one-thread walk so 0.1198.
//
// Over a body shell (the DFSPH couplings, once per step) the shell's
// psi-density and alpha's shell sums are one walk,
// group_pair_sweep_kernel<ShellDensityAlpha<SQ>, KS, G>, on the same
// engine. What held them back: the density kernel walked the shell's 9
// range rows, then alpha's one thread per query walked the same rows again
// in series, every candidate masked by the cutoff; a shell's ranges are
// empty for nearly every query, so over a small shell (a rigid box's 56
// samples) both walks are their range rows' bytes, read twice, and over a
// large one (an elastic cube's 4,096 samples) the one-thread walk's busy
// queries diverge from their warp's empty lanes. What the design does: G
// lanes per query walk the shell's (Mb, 4) rows x y z psi_b (Shell.src4)
// once; inside the cutoff the pair is DensityAlpha's, so the shell's
// sum psi_b W is the density kernel's at the same G, bit for bit, and
// alpha's sums: sum psi_b grad W and, for SQ (the fluid form, an elastic
// body under strong coupling), sum |psi_b grad W|^2. Lane 0's epilogue
// writes the four or five sums as planes. G: ops/cuda_sweep.py::
// shell_group, the shell's size.
//
// Drho runs once per iteration of both solver loops (~4 times per step)
// on the lane-group engine group_pair_sweep_kernel<Drho, KS, G>. What held
// it back on pair_sweep_kernel: one thread per query walking 18 runs in
// series, and every candidate loading both float4s of its 32-byte row and
// running the whole pair, multiplied by 0 outside the cutoff. What the
// design does: G lanes per query walk the flattened fluid and wall runs as
// one list; a candidate loads x y z vx, tests the cutoff, and only inside
// it loads vy vz psi and runs the pair. Its operands are one (C + Mb, 8)
// matrix x y z vx | vy vz psi pad whose first C rows are the queries
// (solvers/dfsph_cuda.py::KappaSweeps), so each iteration writes the
// velocities once. G: ops/cuda_sweep.py::DRHO_G (the one instance built).
//
// Drho over a rigid or elastic shell (the DFSPH couplings, as often as
// Drho) is DrhoShell, the same pair over the shell's 9 rows, on the same
// engine, group_pair_sweep_kernel<DrhoShell, KS, G>, at a G picked by the
// shell's size (ops/cuda_sweep.py::shell_group, as the kappa impulse's).
// Over a small shell (a rigid box's 56 samples) nearly every fluid
// query's runs are empty and G 2 lanes scan them; over a large one (an
// elastic cube's 4,096 samples in mid-fluid) the busy queries fill whole
// warps, which G 8 lanes per query split. vy vz psi_b load only inside
// the cutoff, where MaskedForm<Drho> on pair_sweep_kernel, the walk it
// replaces, loaded every candidate's whole row and ran the pair masked.
//
// Numerics: the default (poly6 / Monaghan) gradient is exactly 0 at the
// self pair only because r^2 is clamped before the rsqrt, so self pairs
// stay in the ranges; the Muller gradient skips the rsqrt. The division
// of alpha is exact. Bound: memory traffic (sweep_common.cuh).
//
// Layouts (row-major float32, 16-byte aligned rows):
//   density_alpha: src (C + Mb, 4) x y z psi (fluid rows psi = m, wall
//          rows psi_b); q its first C rows; out (2, N) planes rho, alpha,
//          or (SUMS) (5, N) planes rho, sum psi grad W (3),
//          sum |psi grad W|^2 (fluid rows)
//   body_density_alpha(_sq): q (N, 4) x y z (slot 3 unread); src a
//          shell's (Mb, 4) rows x y z psi_b; ranges (9, N); out (4, N)
//          planes sum psi_b W, sum psi_b grad W (3), or (_sq) (5, N)
//          with sum |psi_b grad W|^2
//   drho:  src (C + Mb, 8) x y z vx vy vz psi pad (fluid rows psi = m,
//          wall rows their velocities, 0 for a static wall, and psi_b);
//          q its first C rows (slots 0-5 read); out (N,)
//   drho_shell: q (N, 8) x y z vx vy vz (slots 0-5 read); src a shell's
//          (Mb, 8) rows x y z v_b psi_b 0; ranges (9, N); out (N,)

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// rho = sum psi W over all rows (self term included), in the density
// kernel's per-pair expression, and alpha's sums (sum psi grad W, and
// sum |psi grad W|^2 over the fluid rows only: static boundaries add to
// the gradient sum alone), in one walk over the density's matrix
// x y z psi; the engine calls it inside the cutoff with a = x y z psi of
// row j. The epilogue writes rho and alpha, or (SUMS) rho and the four
// sums.
template <bool SUMS>
struct DensityAlpha {
  static constexpr int QW = 4, SW = 4, OW = 5, OUTW = SUMS ? 5 : 2;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    const float dx = q[0] - a.x, dy = q[1] - a.y, dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    float rl = 0.0f, invrl = 0.0f;
    if constexpr (KS == MULLER) {
      const float d = p.h2 - r2;
      acc[0] += (d * d * d) * (a.w * p.kpoly);
    } else {
      rl_invrl(r2, rl, invrl);
      acc[0] += a.w * w_value<KS>(r2, rl, p);
    }
    const float c = a.w * grad_scale_default<KS>(r2, rl, invrl, p);
    acc[1] += c * dx;
    acc[2] += c * dy;
    acc[3] += c * dz;
    if constexpr (!B) acc[4] += c * c * r2;
  }
  __device__ static void epilogue(const float (&)[QW],
                                  const float (&acc)[OW], const Params&,
                                  float (&o)[OUTW]) {
    if constexpr (SUMS) {
#pragma unroll
      for (int k = 0; k < OW; ++k) o[k] = acc[k];
    } else {
      const float denom =
          acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3] + acc[4];
      o[0] = acc[0];
      o[1] = acc[0] / fmaxf(denom, 1e-6f);
    }
  }
};

// a body shell's sum psi_b W and alpha's shell sums in one walk over its 9
// rows x y z psi_b: DensityAlpha's pair, sum |psi_b grad W|^2 only for SQ
// (alpha's fluid form over a shell); the epilogue writes sum psi_b W,
// sum psi_b grad W (3) and (SQ) sum |psi_b grad W|^2 as planes
template <bool SQ>
struct ShellDensityAlpha {
  static constexpr int QW = 4, SW = 4, OW = 5, OUTW = SQ ? 5 : 4;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    DensityAlpha<true>::template pair<KS, !SQ>(q, a, src, j, p, acc);
  }
  __device__ static void epilogue(const float (&)[QW],
                                  const float (&acc)[OW], const Params&,
                                  float (&o)[OUTW]) {
#pragma unroll
    for (int k = 0; k < OUTW; ++k) o[k] = acc[k];
  }
};

// D rho / Dt = sum psi_j (v_q - v_j) . grad W, one formula for both
// regions; the engine calls it inside the cutoff, with a = x y z vx of
// row j
struct Drho {
  static constexpr int QW = 8, SW = 8, OW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz psi pad
    const Geom g = default_geom<KS>(q, a, p);
    const float dvx = q[3] - a.w;
    const float dvy = q[4] - b.x;
    const float dvz = q[5] - b.y;
    acc[0] += b.z * g.s * (dvx * g.dx + dvy * g.dy + dvz * g.dz);
  }
};

// Drho over a body shell's 9 range rows: the same pair, with the shell's
// sample velocities and psi_b in the source row's slots 3-6
struct DrhoShell : Drho {
  static constexpr bool BOUNDARY_ROWS = false;
};

}  // namespace

extern "C" {

// the G of ops/cuda_sweep.py::DENSITY_ALPHA_G
NEREUS_GROUP_SWEEP(density_alpha, DensityAlpha<false>, 4)
NEREUS_GROUP_SWEEP(density_alpha_sums, DensityAlpha<true>, 4)
// over a body shell's 9 rows, at the G of ops/cuda_sweep.py::shell_group:
// sum psi_b W and sum psi_b grad W, and (_sq) sum |psi_b grad W|^2 too
NEREUS_GROUP_SWEEP(body_density_alpha, ShellDensityAlpha<false>, 2, 8)
NEREUS_GROUP_SWEEP(body_density_alpha_sq, ShellDensityAlpha<true>, 2, 8)
// the G of ops/cuda_sweep.py::DRHO_G
NEREUS_GROUP_SWEEP(drho, Drho, 4)
// over a body shell's 9 rows, at the G of ops/cuda_sweep.py::shell_group
NEREUS_GROUP_SWEEP(drho_shell, DrhoShell, 2, 8)

}  // extern "C"
