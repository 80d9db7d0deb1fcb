// Pair functions of the multiphase DFSPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the six
// pair functions of solvers/dfsph_pallas.py::dfsph_multiphase_pallas, on the
// adapted number-density domain (delta-hat, alpha-hat, kappa V-hat^2):
// multiphase_alpha_pair / _bpair, multiphase_drho_pair / _bpair and
// multiphase_kappa_pair / _bpair, and the three _bpair alone over a body
// shell (BoundaryForm<...>, kappa's GroupBoundaryForm<...>, rows 0-8:
// solvers/dfsph_coupled.py::_coupled_mp_pallas; the shell's alpha and
// kappa source is 4 wide, x y z psi_b), and, fused with the first, the step's density sweep
// (multiphase_density_pair / _bpair, dfsph_pallas.py's density before
// alpha-hat). Its non-pressure force sweep is the MultiphaseForce functor
// of multiphase_sweep.cu.
//
// Design: one functor per fluid / wall pair, the fluid rows the B = false
// branch and the wall rows the B = true one, in the operation order of
// ops/sph_pairs.py. All use the default (poly6 / Monaghan) gradient,
// exactly 0 at the self pair (r^2 is clamped before the rsqrt), so
// self-pairs stay in the ranges; the Muller gradient skips the rsqrt.
// The wall sums the caller rescales by each query's s_i / m_i (alpha's
// B vector) keep columns of their own.
//
// The adapted density and the factor alpha-hat (once per step) are one
// walk, group_pair_sweep_kernel<MultiphaseDensityAlpha, KS, G> on the
// lane-group engine of group_sweep.cuh. What held them back: the
// multiphase density kernel walked the ranges of the step's one
// (C + Mb, 4) matrix, then alpha-hat's one thread per query walked the same
// 18 runs again in series, every candidate masked by the cutoff (~85 % of
// them outside it). What the design does: G lanes per query walk the
// flattened fluid and wall runs of that matrix (fluid rows x y z 1/m_j,
// wall rows x y z psi_b; solvers/dfsph_cuda.py::multiphase_alpha_operands)
// once; a candidate's one float4 is the engine's own load, and inside the
// cutoff the pair adds W (fluid) or psi_b W (wall) as the multiphase
// density kernel does (the same mp_geom and mp_density_add of
// sweep_common.cuh, explicit intrinsics), so delta is that kernel's at the
// same G, bit for bit, and alpha-hat's seven sums. Lane 0's epilogue
// writes the nine sums as (9, N) planes; the caller forms rho~ and
// alpha-hat from them, as alpha-hat needs s_i = rho0_i / rho0, which the
// matrix does not carry. G: ops/cuda_sweep.py::MP_DENSITY_ALPHA_G (the one
// instance built). Over a
// rigid body's shell the wall sums alone keep the one-thread walk,
// BoundaryForm<MultiphaseAlpha> (rows 0-8, every candidate masked).
//
// d delta-hat / dt runs once per iteration of both solver loops on the
// lane-group engine group_pair_sweep_kernel<MultiphaseDrho, KS, G> of
// group_sweep.cuh. What held it back on pair_sweep_kernel: one thread per
// query walking 18 runs in series, every candidate loading both float4s
// of its 32-byte row and running the whole pair, multiplied by 0 outside
// the cutoff (~85 % of the candidates), and two output columns that the
// caller combined in two more launches. What the design does: G lanes per
// query walk the flattened fluid and wall runs as one list; a candidate
// loads x y z vx, tests the cutoff, and only inside it loads vy vz psi_b
// and runs the pair; lane 0's epilogue writes the one rate
// sum_fluid + (s_i / m_i) sum_wall, the query's s_i / m_i read from slot 6
// of its row (dfsph_pallas.py's d[:, 0] + sm * d[:, 1]). Its operands are
// one (C + Mb, 8) matrix whose first C rows are the queries
// (solvers/dfsph_cuda.py::MultiphaseKappaSweeps), so each iteration
// writes the velocities once. G: ops/cuda_sweep.py::MP_DRHO_G (the one
// instance built). Over a rigid body's shell (the multiphase DFSPH
// coupling) the wall formula alone keeps the parent's one-thread walk,
// BoundaryForm<MaskedForm<MultiphaseDrho>> (the two sums, no epilogue): a
// shell's ranges are empty for nearly every query, and a lane group's row
// scan of an empty query costs more than one thread's (PERF.md section 6,
// the DFSPH couplings' shell Drho).
//
// The kappa-V-hat^2 correction, once per correction of both loops (5.2
// launches per step), stays on pair_sweep_kernel, one thread per query and
// every candidate masked by the cutoff: on group_pair_sweep_kernel at its
// best G, 4, it took 4 % more at DM, G 2 and 8 more still (PERF.md
// section 6). Its
// source is one 16-byte row per candidate (x y z kv2_j, wall rows x y z
// psi_b), which both walks load once, and the 18 range rows and the
// candidate gathers are most of its time; a pair this cheap gains nothing
// from the guard. Over a rigid body's shell (the wall formula alone, as
// often) it runs on the lane-group engine,
// group_pair_sweep_kernel<GroupBoundaryForm<MultiphaseKappa>, KS, G>.
// What held it back on the one-thread walk (BoundaryForm<MaskedForm<
// MultiphaseKappa>>): a shell's ranges are empty for nearly every query,
// and one thread per query loaded its 9 range rows' bounds in series, so
// the walk sat at its with-ranges bound, the bounds' latency. What the
// design does: G lanes per query load the 9 bounds at once and walk the
// few candidates G at a time, the pair only inside the cutoff. G:
// ops/cuda_sweep.py::shell_group, the shell's size.
//
// Bound: memory traffic (sweep_common.cuh). The alpha and kappa sources
// are 16-byte rows (x y z and one scalar: 1 / m_j or kappa V-hat_j^2 on
// fluid rows, psi_b on wall rows), the drho source a 32-byte row (the
// velocities and psi_b).
//
// Layouts (row-major float32, 16-byte aligned rows):
//   density_alpha: src (C + Mb, 4) fluid x y z 1/m_j, wall x y z psi_b;
//          q its first C rows (x y z read); out (9, N) planes sum W,
//          sum psi_b W, sum grad W (3), sum |grad W|^2 / m_j (fluid rows),
//          sum psi_b grad W (3, wall rows)
//   alpha_body: q (N, 4) x y z pad; src a shell's (Mb, 4) rows x y z psi_b;
//          ranges (9, N); out (N, 7), sum psi_b grad W in columns 4-6 and
//          columns 0-3 exactly 0
//   drho:  src (C + Mb, 8) fluid rows x y z vx vy vz s_i/m_i 0, wall rows
//          x y z vb vb vb psi_b 0 (the wall velocity 0 for a static wall);
//          q its first C rows (slots 0-6 read); out (N,)
//          sum (v_i - v_j) . grad W (fluid rows, no mass weight)
//          + (s_i / m_i) sum psi_b (v_i - v_b) . grad W (wall rows)
//   drho_body: q (N, 8) x y z vx vy vz (slots 0-5 read); src a shell's
//          (Mb, 8) rows x y z v_b psi_b 0; ranges (9, N); out (N, 2), the
//          shell's sum in column 1 and column 0 exactly 0
//   kappa: q (N, 8) x y z kv2_i qc_i pad pad pad; src (M, 4) fluid x y z
//          kv2_j, wall x y z psi_b; out (N, 3)
//          sum (kv2_i + kv2_j) grad W + qc_i sum psi_b grad W
//   kappa_body: q as kappa's; src a shell's (Mb, 4) rows x y z psi_b;
//          ranges (9, N); out (N, 3) qc_i sum psi_b grad W

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// G = sum grad W and S = sum |grad W|^2 / m_j over the fluid rows,
// B = sum psi_b grad W over the wall rows, on every candidate, masked by
// the cutoff: the one-thread walk's functor, whose wall formula
// BoundaryForm<MultiphaseAlpha> runs over a body shell
struct MultiphaseAlpha {
  static constexpr int QW = 4, SW = 4, OW = 7;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z (1/m_j or psi_b)
    const Geom g = default_geom<KS>(q, a, p);
    if constexpr (B) {
      const float c = a.w * g.s * g.okf;
      acc[4] += c * g.dx;
      acc[5] += c * g.dy;
      acc[6] += c * g.dz;
    } else {
      const float c = g.s * g.okf;
      acc[0] += c * g.dx;
      acc[1] += c * g.dy;
      acc[2] += c * g.dz;
      acc[3] += a.w * c * c * g.r2;
    }
  }
};

// the multiphase density and alpha-hat's sums in one walk of the one
// (C + Mb, 4) matrix x y z 1/m_j (fluid rows) / x y z psi_b (wall rows):
// delta = sum W (acc 0) and sum psi_b W (acc 1) as the multiphase density
// kernel adds them (multiphase_sweep.cu's MultiphaseDensity: the same
// mp_geom and mp_density_add, whose explicit intrinsics the compiler
// cannot contract otherwise here), then MultiphaseAlpha's
// G = sum grad W (acc 2-4) and
// S = sum |grad W|^2 / m_j (acc 5) over the fluid rows and
// B = sum psi_b grad W (acc 6-8) over the wall rows, without the cutoff
// mask; the engine calls it inside the cutoff with a = row j. The
// epilogue writes the nine sums as (9, N) planes.
struct MultiphaseDensityAlpha {
  static constexpr int QW = 4, SW = 4, OW = 9, OUTW = 9;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    const MpGeom g = mp_geom<KS>(q, a, p);
    mp_density_add<B>(g, a, acc[0], acc[1]);
    const float s = grad_scale_default<KS>(g.r2, g.rl, g.invrl, p);
    if constexpr (B) {
      const float c = a.w * s;
      acc[6] += c * g.dx;
      acc[7] += c * g.dy;
      acc[8] += c * g.dz;
    } else {
      acc[2] += s * g.dx;
      acc[3] += s * g.dy;
      acc[4] += s * g.dz;
      acc[5] += a.w * s * s * g.r2;
    }
  }
  __device__ static void epilogue(const float (&)[QW],
                                  const float (&acc)[OW], const Params&,
                                  float (&o)[OUTW]) {
#pragma unroll
    for (int k = 0; k < OW; ++k) o[k] = acc[k];
  }
};

// d delta-hat / dt: sum (v_i - v_j) . grad W over the fluid rows (acc 0),
// sum psi_b (v_i - v_b) . grad W over the wall rows (acc 1), combined by
// lane 0 as acc0 + (s_i / m_i) acc1; the engine calls the pair inside the
// cutoff, with a = x y z vx of row j
struct MultiphaseDrho {
  static constexpr int QW = 8, SW = 8, OW = 2, OUTW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz (psi_b) pad
    const Geom g = default_geom<KS>(q, a, p);
    const float dv = (q[3] - a.w) * g.dx + (q[4] - b.x) * g.dy +
                     (q[5] - b.y) * g.dz;
    if constexpr (B) {
      acc[1] += b.z * g.s * dv;
    } else {
      acc[0] += g.s * dv;
    }
  }
  __device__ static void epilogue(const float (&q)[QW],
                                  const float (&acc)[OW], const Params&,
                                  float (&o)[OUTW]) {
    o[0] = acc[0] + q[6] * acc[1];
  }
};

// the stiffness correction sum (kv2_i + kv2_j) grad W over the fluid rows
// plus qc_i sum psi_b grad W over the wall rows, into the same columns;
// source row j is x y z kv2_j (fluid) or x y z psi_b (wall). Two forms of
// one formula: pair_sweep_kernel's, on every candidate, masked by the
// cutoff; and the engine's, inside the cutoff, with a the row j it loaded
// (GroupBoundaryForm's wall formula over a body shell).
struct MultiphaseKappa {
  static constexpr int QW = 8, SW = 4, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  template <bool B>
  __device__ static float coef(const float (&q)[QW], float4 a,
                               const Geom& g) {
    return B ? q[4] * a.w * g.s : (q[3] + a.w) * g.s;
  }
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const Geom g = default_geom<KS>(q, a, p);
    const float c = coef<B>(q, a, g) * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    const Geom g = default_geom<KS>(q, a, p);
    const float c = coef<B>(q, a, g);
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

}  // namespace

extern "C" {

// the G of ops/cuda_sweep.py::MP_DENSITY_ALPHA_G
NEREUS_GROUP_SWEEP(multiphase_density_alpha, MultiphaseDensityAlpha, 4)
// the G of ops/cuda_sweep.py::MP_DRHO_G
NEREUS_GROUP_SWEEP(multiphase_drho, MultiphaseDrho, 4)
NEREUS_PAIR_SWEEP(multiphase_kappa, MultiphaseKappa)
// the wall columns alone over a body shell (the multiphase DFSPH coupling)
NEREUS_PAIR_SWEEP(multiphase_alpha_body, BoundaryForm<MultiphaseAlpha>)
NEREUS_PAIR_SWEEP(multiphase_drho_body,
                  BoundaryForm<MaskedForm<MultiphaseDrho>>)
// at the G of ops/cuda_sweep.py::shell_group
NEREUS_GROUP_SWEEP(multiphase_kappa_body, GroupBoundaryForm<MultiphaseKappa>,
                   2, 8)

}  // extern "C"
