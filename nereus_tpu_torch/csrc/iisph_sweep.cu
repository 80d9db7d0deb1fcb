// Pair functions of the IISPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the five
// IISPH pair functions of pallas_sph.py: dii_rhoadv_pair and aii_pair (two
// TPU sweeps, one kernel here), sum_dij_pair, jacobi_fluid_pair +
// jacobi_boundary_pair, and grad_pressure_force_pair
// (solvers/iisph_pallas.py::iisph_step_pallas; the last is also PCISPH's
// and DFSPH's pressure / kappa correction). Its boundary form alone
// (grad_pressure_force_pair(boundary=True, boundary_sign=-1) on rows 0-8,
// BodyPressureForce) is the kappa impulse of solvers/dfsph_coupled.py and
// dfsph_elastic.py over a body shell, and with the roles swapped (a body's
// samples as queries, x y z psi_b, against the fluid rows with kappa/rho
// in slot 6) the per-sample reverse kappa of the elastic coupling: one
// functor, two entry points.
//
// Design: PressureForce runs on the row-tiled engine
// tiled_pair_sweep_kernel<Pair, KS> of tiled_sweep.cuh (PCISPH's
// corrective loop launches it ~45 times per step over one tile plan); the
// other functors on the lane-group engine group_pair_sweep_kernel<Pair,
// KS, G> of group_sweep.cuh. All use the default (poly6 / Monaghan)
// gradient, whose terms are exactly 0 at the self pair, so self-pairs stay
// in the ranges.
//
// What bounds a range-walk sweep on this card: one thread per query
// walking 9 or 18 runs of 0-6 candidates in series waits on each run's
// bounds and diverges on trip counts, and loading each candidate's whole
// source row for a pair that only ~15 % of them pass wastes most of the
// bytes. What the engine does: G lanes per query walk the flattened runs
// (group_sweep.cuh); each candidate loads one float4, x y z and one value,
// and tests the cutoff; only a pair inside it runs and loads the rest of
// the row it reads; fluid and wall rows are one list.
//
// DiiAii (once per step) replaces the two sweeps that ran the TPU's
// dii_rhoadv_pair and aii_pair over the same pairs, one after the other.
// d_ii is the query's own value, so a_ii needs no second walk: with
// S = sum psi s r, T = sum psi s^2 r^2 and R = sum psi s (v_q - v_j) . r
// over one walk (grad W = s r), the epilogue forms
// d_ii = -inv_rho2 S, rho_adv's sum dt R and a_ii = d_ii . S - (m inv_rho2) T
// (the reference's sum of psi (s d_ii . r - (m/rho_i^2) s^2 r^2), its two
// terms summed apart). Its operands are one (C + Mb, 12) matrix whose
// first C rows are the queries (solvers/iisph_cuda.py::dii_aii_operands);
// a candidate reads x y z v_x, and inside the cutoff v_y v_z psi.
//
// SumDij and Jacobi, the relaxed-Jacobi solve's two sweeps (launched once
// per iteration, 2-7 times per step): measured at 1,092,727 queries
// (PERF.md section 6) 35 % and 32 % under the earlier one-thread-per-query
// kernels. Their operands are narrow, and each iteration writes them once
// (solvers/iisph_cuda.py):
// - SumDij reads one (C, 4) matrix x y z p/rho^2 as query and source;
//   after the loop, holding the final p/rho^2, it is the pressure force's
//   query.
// - Jacobi's fluid source rows carry e_j = d_jj p_j + sum_k d_jk p_k,
//   written by one elementwise pass per iteration, so the pair no longer
//   forms d_jj p_j + sum_k d_jk p_k once per (i, j): it computes
//   sd_i - e_j, where the reference computes (sd_i - d_jj p_j) - sd_j (the
//   same terms rounded in another order). Only its fluid pairs load a
//   second float4 (e_y e_z), its wall pairs psi_b alone.
// G per kernel: ops/cuda_sweep.py (DII_AII_G, SUM_DIJ_G, JACOBI_G); only
// those instances are built.
//
// The kappa impulse over a body shell, once per correction of both DFSPH
// loops (5.2 launches per step), was BoundaryForm<PressureForce> on
// pair_sweep_kernel: one thread per query, both float4s of every
// candidate's 32-byte row loaded and the pair run masked. Two shapes want
// opposite designs (PERF.md section 6). Forward, the 262,144 fluid rows
// over a shell: nearly every query's runs are empty. It runs on the
// lane-group engine at the shell's G (ops/cuda_sweep.py::shell_group, as
// the shell's Drho): G 2 over a rigid box's 56 samples (under
// SMALL_SHELL), where 2 lanes scan an empty query's 9 rows; G 8 over an
// elastic cube's 4,096 samples in mid-fluid, whose few thousand busy
// queries fill whole warps.
// Reverse, a body's 4,096 samples over the fluid rows: one thread per
// sample put 32 blocks on the card; G 16 lanes per sample fill it.
// BodyPressureForce loads kappa/rho or psi_b (slot 6) only inside the
// cutoff.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   dii_aii:    src (C + Mb, 12) fluid rows x y z vax | vay vaz m vx |
//               vy vz inv_rho2 0 (v_adv, the pre-advection v, 1/rho^2),
//               wall rows x y z v_b | psi_b 0 ...; q its first C rows;
//               out (5, N) planes d_ii xyz, rho_adv's sum, a_ii
//   sum_dij:    q = src (C, 4) x y z p/rho2, the same matrix; fluid rows
//               only (n_rows = 9); out (N, 3)
//   jacobi:     q (N, 8) x y z sdx sdy sdz (m/rho2)*p pad;
//               src (M, 8) fluid x y z ex ey ez 0 0, boundary
//               x y z v_b psi 0 (the step's wall rows); out (N,)
//   pressure:   q (N, 4) x y z pd2; src (M, 8) slot 6 = pd2_j (fluid) or
//               psi (boundary); out (N, 3)

#include "group_sweep.cuh"
#include "tiled_sweep.cuh"

namespace {

using namespace nereus_sweep;

// S = sum psi s r (acc 0-2), T = sum psi s^2 r^2 (acc 3) and
// R = sum psi s (v_q - v_j) . r (acc 4), one formula for fluid (psi = m)
// and wall rows (psi_b); the query velocity is v_adv (slots 3-5) on fluid
// rows and the pre-advection v (slots 7-9) on wall rows, whose v_j is the
// wall's. The engine calls it inside the cutoff, with a = x y z vx of row
// j; the epilogue forms d_ii, rho_adv's sum and a_ii from the sums.
struct DiiAii {
  static constexpr int QW = 12, SW = 12, OW = 5, OUTW = 5;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz psi .
    const Geom g = default_geom<KS>(q, a, p);
    const float c = b.z * g.s;
    constexpr int o = B ? 7 : 3;
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
                                  const float (&acc)[OW], const Params& p,
                                  float (&o)[OUTW]) {
    const float inv = q[10];
    o[0] = -inv * acc[0];
    o[1] = -inv * acc[1];
    o[2] = -inv * acc[2];
    o[3] = p.dt * acc[4];
    o[4] = (o[0] * acc[0] + o[1] * acc[1] + o[2] * acc[2]) -
           (p.pm * inv) * acc[3];
  }
};

// sum_j d_ij p_j = -sum_j m (p_j / rho_j^2) grad W, fluid rows only; the
// engine calls it inside the cutoff, with a = x y z p/rho^2 of row j
struct SumDij {
  static constexpr int QW = 4, SW = 4, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    const Geom g = default_geom<KS>(q, a, p);
    const float c = -p.pm * a.w * g.s;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

// Jacobi off-diagonal sum: fluid m (s (sd_i - e_j) . r + (m/rho_i^2) p_i
// s^2 r^2) with e_j = d_jj p_j + sd_j; boundary psi s sd_i . r. The engine
// calls it inside the cutoff, with a = x y z e_x (fluid) or x y z v_bx
// (wall) of row j.
struct Jacobi {
  static constexpr int QW = 8, SW = 8, OW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const Geom g = default_geom<KS>(q, a, p);
    if constexpr (B) {
      const float psi = __ldg(src + static_cast<size_t>(j) * SW + 6);
      acc[0] += psi * (g.s * (q[3] * g.dx + q[4] * g.dy + q[5] * g.dz));
    } else {
      const float4 b = src_f4(src, SW, j, 1);  // ey ez 0 0
      const float ix = q[3] - a.w;
      const float iy = q[4] - b.x;
      const float iz = q[5] - b.y;
      const float inner = g.s * (ix * g.dx + iy * g.dy + iz * g.dz) +
                          q[6] * g.s * g.s * g.r2;
      acc[0] += p.pm * inner;
    }
  }
};

// the kappa impulse of a body shell alone, -1 m psi_b pd2_i grad W
// (PressureForce's boundary formula in its order): forward q x y z kappa/rho
// over the shell's rows, psi_b in slot 6; reverse q x y z psi_b of a body's
// samples over the fluid rows, kappa/rho in slot 6. The engine calls it
// inside the cutoff with a = x y z . of row j; slot 6 is loaded here.
struct BodyPressureForce {
  static constexpr int QW = 4, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float s6 = __ldg(src + static_cast<size_t>(j) * SW + 6);
    const Geom g = default_geom<KS>(q, a, p);
    const float c = -1.0f * p.pm * s6 * q[3] * g.s;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

// pressure force: fluid -m^2 (pd2_i + pd2_j) grad W; boundary -m psi pd2_i
// grad W (boundary_sign = -1)
struct PressureForce {
  static constexpr int QW = 4, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const float s6 = src_f4(src, SW, j, 1).z;
    const Geom g = default_geom<KS>(q, a, p);
    float c;
    if constexpr (B) {
      c = -1.0f * p.pm * s6 * q[3] * g.s;
    } else {
      c = -p.pm * p.pm * (q[3] + s6) * g.s;
    }
    c = c * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

}  // namespace

extern "C" {

// the G of ops/cuda_sweep.py at every query count: DiiAii 4, SumDij 2,
// Jacobi 4
NEREUS_GROUP_SWEEP(dii_aii, DiiAii, 4)
NEREUS_GROUP_SWEEP(sum_dij, SumDij, 2)
NEREUS_GROUP_SWEEP(jacobi, Jacobi, 4)
NEREUS_TILED_SWEEP(pressure_force, PressureForce)
// the DFSPH couplings' kappa impulse of a body shell on the fluid, the
// fluid rows as queries, at the G of ops/cuda_sweep.py::shell_group
NEREUS_GROUP_SWEEP(pressure_force_body, BodyPressureForce, 2, 8)
// the reverse kappa of the elastic coupling: a body's samples as queries
// against the fluid rows, at ops/cuda_sweep.py::BODY_REV_G
NEREUS_GROUP_SWEEP(pressure_force_body_rev, BodyPressureForce, 16)

}  // extern "C"
