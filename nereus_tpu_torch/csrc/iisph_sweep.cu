// Pair functions of the IISPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the five
// IISPH pair functions of pallas_sph.py: dii_rhoadv_pair, aii_pair,
// sum_dij_pair, jacobi_fluid_pair + jacobi_boundary_pair, and
// grad_pressure_force_pair (solvers/iisph_pallas.py::iisph_step_pallas; the
// last is also PCISPH's and DFSPH's pressure / kappa correction). Its
// boundary form alone (grad_pressure_force_pair(boundary=True,
// boundary_sign=-1) on rows 0-8, BoundaryForm<PressureForce>) is the kappa
// impulse of solvers/dfsph_coupled.py and dfsph_elastic.py over a body
// shell, and with the roles swapped (a body's samples as queries, x y z
// psi_b, against the fluid rows with kappa/rho in slot 6) the per-sample
// reverse kappa of the elastic coupling: one instance for both.
//
// Design: one functor each for the range-walk template
// pair_sweep_kernel<Pair, KS> of sweep_common.cuh, except PressureForce,
// which runs on the row-tiled engine tiled_pair_sweep_kernel<Pair, KS> of
// tiled_sweep.cuh (PCISPH's corrective loop launches it ~45 times per step
// over one tile plan; its boundary form stays on pair_sweep_kernel). All
// five use the default (poly6 / Monaghan) gradient, which is exactly 0 at
// the self pair, so self-pairs stay in the ranges. Bound: memory traffic
// (sweep_common.cuh, tiled_sweep.cuh).
//
// The Jacobi source is 12 floats wide, not the TPU's 16: fluid rows carry
// x y z, d_jj (3), p_j and sum_k d_jk p_k (3), 10 values, and the port
// needs no hash payload in the source (its ranges are exact), so 12 is the
// least multiple of 4 (one float4 load each) that holds them; 16 would
// read a third more bytes per candidate for nothing.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   dii_rhoadv: q (N, 12) x y z vax vay vaz vx vy vz inv_rho2 pad pad;
//               src (M, 8) x y z vax vay vaz psi pad; out (N, 4)
//   aii:        q (N, 8) x y z diix diiy diiz m/rho2 pad; src as above;
//               out (N,)
//   sum_dij:    q (N, 4) x y z pad; src (M, 8) slot 6 = p/rho2; fluid
//               rows only (n_rows = 9); out (N, 3)
//   jacobi:     q (N, 8) x y z sdx sdy sdz (m/rho2)*p pad;
//               src (M, 12) fluid x y z djj(3) p sd(3) pad pad,
//               boundary x y z 0 0 0 psi 0 0 0 0 0; out (N,)
//   pressure:   q (N, 4) x y z pd2; src (M, 8) slot 6 = pd2_j (fluid) or
//               psi (boundary); out (N, 3)

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

// sum_j d_ij p_j = -sum_j m (p_j / rho_j^2) grad W, fluid rows only
struct SumDij {
  static constexpr int QW = 4, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const float pd2 = src_f4(src, SW, j, 1).z;
    const Geom g = default_geom<KS>(q, a, p);
    const float c = -p.pm * pd2 * g.s * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

// Jacobi off-diagonal sum: fluid m (sd_i - d_jj p_j - sd_j) . grad W +
// (m/rho_i^2) p_i s^2 r^2; boundary psi sd_i . grad W
struct Jacobi {
  static constexpr int QW = 8, SW = 12, OW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z djjx
    const float4 b = src_f4(src, SW, j, 1);  // djjy djjz p_j|psi sdx
    const Geom g = default_geom<KS>(q, a, p);
    if constexpr (B) {
      const float dot = g.s * (q[3] * g.dx + q[4] * g.dy + q[5] * g.dz);
      acc[0] += b.z * dot * g.okf;
    } else {
      const float4 c = src_f4(src, SW, j, 2);  // sdy sdz pad pad
      const float p_j = b.z;
      const float ix = q[3] - a.w * p_j - b.w;
      const float iy = q[4] - b.x * p_j - c.x;
      const float iz = q[5] - b.y * p_j - c.y;
      const float inner = g.s * (ix * g.dx + iy * g.dy + iz * g.dz) +
                          q[6] * g.s * g.s * g.r2;
      acc[0] += p.pm * inner * g.okf;
    }
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
NEREUS_PAIR_SWEEP(sum_dij, SumDij)
NEREUS_PAIR_SWEEP(jacobi, Jacobi)
NEREUS_TILED_SWEEP(pressure_force, PressureForce)
// the boundary form alone over a body shell (the DFSPH couplings' kappa
// impulse between fluid and body), or with a body's samples as queries
// against the fluid rows (the reverse kappa of the elastic coupling)
NEREUS_PAIR_SWEEP(pressure_force_body, BoundaryForm<PressureForce>)

}  // extern "C"
