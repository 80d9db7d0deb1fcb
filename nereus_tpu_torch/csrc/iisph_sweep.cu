// Pair functions of the IISPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the five
// IISPH pair functions of pallas_sph.py: dii_rhoadv_pair, aii_pair,
// sum_dij_pair, jacobi_fluid_pair + jacobi_boundary_pair, and
// grad_pressure_force_pair (solvers/iisph_pallas.py::iisph_step_pallas; the
// last is also PCISPH's and DFSPH's pressure / kappa correction). Its
// boundary form alone (grad_pressure_force_pair(boundary=True,
// boundary_sign=-1) on rows 0-8, BodyPressureForce) is the kappa impulse
// of solvers/dfsph_coupled.py and dfsph_elastic.py over a body shell, and
// with the roles swapped (a body's samples as queries, x y z psi_b,
// against the fluid rows with kappa/rho in slot 6) the per-sample reverse
// kappa of the elastic coupling: one functor, two entry points.
//
// Design: one functor each. DiiRhoAdv and Aii (once per step) run on the
// range-walk template pair_sweep_kernel<Pair, KS> of sweep_common.cuh;
// PressureForce on the row-tiled engine tiled_pair_sweep_kernel<Pair, KS>
// of tiled_sweep.cuh (PCISPH's corrective loop launches it ~45 times per
// step over one tile plan).
// All five use the default (poly6 / Monaghan) gradient, which is exactly 0
// at the self pair, so self-pairs stay in the ranges.
//
// SumDij and Jacobi, the relaxed-Jacobi solve's two sweeps (launched once
// per iteration, 2-7 times per step), run on the lane-group engine
// group_pair_sweep_kernel<Pair, KS, G> of group_sweep.cuh. What bounds
// them on this card: one thread per query walking 9 or 18 runs of 0-6
// candidates in series waits on each run's bounds and diverges on trip
// counts, and loading each candidate's whole source row (SumDij 32 B,
// Jacobi 48 B in the earlier layouts) for a pair that only ~15 % of them
// pass wastes most of the bytes. What the design does: G lanes per query
// walk the flattened runs (group_sweep.cuh); each candidate loads one
// float4, x y z and one value, and tests the cutoff; only a pair inside it
// runs, and only Jacobi's loads a second float4 (e_y e_z, or psi_b on a
// wall row); Jacobi's fluid and wall rows are one list. Measured at
// 1,092,727 queries (PERF.md section 6): SumDij 35 % and Jacobi 32 % under
// the earlier one-thread-per-query kernels. The operands are narrow, and
// each iteration writes them once (solvers/iisph_cuda.py):
// - SumDij reads one (C, 4) matrix x y z p/rho^2 as query and source;
//   after the loop, holding the final p/rho^2, it is the pressure force's
//   query.
// - Jacobi's fluid source rows carry e_j = d_jj p_j + sum_k d_jk p_k,
//   written by one elementwise pass per iteration, so the pair no longer
//   forms d_jj p_j + sum_k d_jk p_k once per (i, j): it computes
//   sd_i - e_j, where the reference computes (sd_i - d_jj p_j) - sd_j (the
//   same terms rounded in another order).
// G per kernel: ops/cuda_sweep.py (SUM_DIJ_G, JACOBI_G); only those
// instances are built.
//
// The kappa impulse over a body shell, once per correction of both DFSPH
// loops (5.2 launches per step), was BoundaryForm<PressureForce> on
// pair_sweep_kernel: one thread per query, both float4s of every
// candidate's 32-byte row loaded and the pair run masked. Two shapes want
// opposite designs (PERF.md section 6). Forward, the 262,144 fluid rows
// over a shell: nearly every query's runs are empty. Over a rigid box's 56
// samples (under SMALL_SHELL) it runs thread_sweep_kernel of
// group_sweep.cuh (one thread per query, all bounds in flight, the pair
// only inside the cutoff); over an elastic cube's 4,096 samples in
// mid-fluid, whose few thousand busy queries fill whole warps, the
// lane-group engine at G 8.
// Reverse, a body's 4,096 samples over the fluid rows: one thread per
// sample put 32 blocks on the card; G 16 lanes per sample fill it.
// BodyPressureForce loads kappa/rho or psi_b (slot 6) only inside the
// cutoff.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   dii_rhoadv: q (N, 12) x y z vax vay vaz vx vy vz inv_rho2 pad pad;
//               src (M, 8) x y z vax vay vaz psi pad; out (N, 4)
//   aii:        q (N, 8) x y z diix diiy diiz m/rho2 pad; src as above;
//               out (N,)
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

// d_ii += -psi inv_rho2_i grad W ; rho_adv += dt psi (v_q - v_j) . grad W
struct DiiRhoAdv {
  static constexpr int QW = 12, SW = 8, OW = 4;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z vx
    const float4 b = src_f4(src, SW, j, 1);  // vy vz psi pad
    const Geom g = default_geom<KS>(q, a, p);
    const float psi = b.z;
    const float cdii = -psi * q[9] * g.s * g.okf;
    constexpr int o = B ? 6 : 3;  // v (boundary rows) or v_adv (fluid)
    const float dvx = q[o] - a.w;
    const float dvy = q[o + 1] - b.x;
    const float dvz = q[o + 2] - b.y;
    const float cr = p.dt * psi * g.s *
                     (dvx * g.dx + dvy * g.dy + dvz * g.dz) * g.okf;
    acc[0] += cdii * g.dx;
    acc[1] += cdii * g.dy;
    acc[2] += cdii * g.dz;
    acc[3] += cr;
  }
};

// a_ii += psi (s d_ii . r - (m/rho_i^2) s^2 r^2), fluid and boundary alike
struct Aii {
  static constexpr int QW = 8, SW = 8, OW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const float psi = src_f4(src, SW, j, 1).z;
    const Geom g = default_geom<KS>(q, a, p);
    const float dii_dot_r = q[3] * g.dx + q[4] * g.dy + q[5] * g.dz;
    acc[0] += psi * (g.s * dii_dot_r - q[6] * g.s * g.s * g.r2) * g.okf;
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

NEREUS_PAIR_SWEEP(dii_rhoadv, DiiRhoAdv)
NEREUS_PAIR_SWEEP(aii, Aii)
// the G of ops/cuda_sweep.py at every query count: SumDij 2, Jacobi 4
NEREUS_GROUP_SWEEP(sum_dij, SumDij, 2)
NEREUS_GROUP_SWEEP(jacobi, Jacobi, 4)
NEREUS_TILED_SWEEP(pressure_force, PressureForce)
// the DFSPH couplings' kappa impulse of a body shell on the fluid, the
// fluid rows as queries, by the shell's size (ops/cuda_sweep.py::
// body_kappa_group): group 1, thread_sweep_kernel (one thread per query);
// group 8, lane groups. Returns cudaGetLastError() (0 on success), or -1
// for an unknown kernel set or group.
int nereus_pressure_force_body_sweep(const float* q, const float* src,
                                     const int* seg_start,
                                     const int* seg_end, int n, int n_rows,
                                     const float* pvec, int kernel_set,
                                     int group, float* out, void* stream) {
  if (group == 1) {
    return nereus_sweep::launch_thread_sweep<BodyPressureForce>(
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, out,
        stream);
  }
  return nereus_sweep::launch_group_sweep<BodyPressureForce, 8>(
      q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, group, out,
      stream);
}
// the reverse kappa of the elastic coupling: a body's samples as queries
// against the fluid rows, at ops/cuda_sweep.py::BODY_REV_G
NEREUS_GROUP_SWEEP(pressure_force_body_rev, BodyPressureForce, 16)

}  // extern "C"
