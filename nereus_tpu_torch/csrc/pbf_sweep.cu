// Pair functions of the PBF step (Position Based Fluids, Macklin & Muller
// 2013), for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the three
// PBF pair functions of pallas_sph.py that solvers/pbf_pallas.py runs:
// pbf_lambda_pair (the constraint sums, and vorticity confinement's N),
// pbf_dp_pair (the position correction) and pbf_omega_pair (the vorticity).
// Its XSPH pass is the Xsph functor of multiphase_sweep.cu.
//
// Design: one functor each for the range-walk template
// pair_sweep_kernel<Pair, KS> of sweep_common.cuh, the fluid rows the
// B = false branch and the wall rows the B = true one, in the operation
// order of ops/sph_pairs.py. Every sweep of a step walks the ranges built
// from the advected positions x*, while the queries and sources carry the
// current iterate (the frozen-neighborhood contract; the TPU kernel's
// geom_offset = 4). The self pair stays in the ranges: it gives rho its
// m W(0), and every gradient term is exactly 0 there (r^2 is clamped
// before the rsqrt; the Muller gradient is a function of r^2 alone).
// Nothing divides, so no pair needs a guard.
//
// Bound: memory traffic (sweep_common.cuh). The lambda and dp sources are
// 16-byte rows (x y z and one scalar), the omega source a 32-byte row.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   lambda: q (N, 4) x y z pad; src (M, 4) fluid x y z psi (m, or
//           m / rho_j |omega_j| for N), wall x y z psi_b; out (N, 5)
//           sum psi W, sum psi grad W (3), sum |psi grad W|^2 (fluid rows)
//   dp:     q (N, 4) x y z lambda_i; src (M, 4) fluid x y z lambda_j, wall
//           x y z psi_b; out (N, 3) sum m (lambda_i + lambda_j + scorr)
//           grad W + sum psi_b lambda_i grad W (the caller scales by 1/rho0)
//   omega:  q (N, 8) x y z vx vy vz pad pad; src (M, 8) x y z vx vy vz
//           m/rho_j pad, fluid rows only (9 range rows); out (N, 3)

#include "sweep_common.cuh"

namespace {

using namespace nereus_sweep;

// (dx, dy, dz, r^2, W, s, okf) of a pair with grad W = s * r, the default
// gradient; the rsqrt only for Monaghan
struct WsGeom {
  float dx, dy, dz, r2, w, s, okf;
};

template <int KS>
__device__ __forceinline__ WsGeom ws_geom(const float* q, float4 a,
                                          const Params& p) {
  WsGeom g;
  g.dx = q[0] - a.x;
  g.dy = q[1] - a.y;
  g.dz = q[2] - a.z;
  g.r2 = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(g.r2, rl, invrl);
  g.w = w_value<KS>(g.r2, rl, p);
  g.s = grad_scale_default<KS>(g.r2, rl, invrl, p);
  g.okf = g.r2 < p.h2 ? 1.0f : 0.0f;
  return g;
}

// rho = sum psi W, sum psi grad W, and sum |psi grad W|^2 over the fluid
// rows only (the walls add to rho and the gradient sum)
struct PbfLambda {
  static constexpr int QW = 4, SW = 4, OW = 5;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z psi
    const WsGeom g = ws_geom<KS>(q, a, p);
    acc[0] += a.w * g.w * g.okf;
    const float c = a.w * g.s * g.okf;
    acc[1] += c * g.dx;
    acc[2] += c * g.dy;
    acc[3] += c * g.dz;
    if constexpr (!B) acc[4] += c * c * g.r2;
  }
};

// the position correction: m (lambda_i + lambda_j - (W s_corr)^4) grad W
// over the fluid rows, psi_b lambda_i grad W over the wall rows
struct PbfDp {
  static constexpr int QW = 4, SW = 4, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z (lambda_j or psi_b)
    const WsGeom g = ws_geom<KS>(q, a, p);
    float coef;
    if constexpr (B) {
      coef = a.w * q[3] * g.s;
    } else {
      const float t = g.w * p.scorr_s;
      const float t2 = t * t;
      const float scorr = -(t2 * t2);
      coef = p.pm * (q[3] + a.w + scorr) * g.s;
    }
    coef = coef * g.okf;
    acc[0] += coef * g.dx;
    acc[1] += coef * g.dy;
    acc[2] += coef * g.dz;
  }
};

// omega = sum (m / rho_j) (v_j - v_i) x grad W over the fluid rows
struct PbfOmega {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z vx
    const float4 b = src_f4(src, SW, j, 1);  // vy vz m/rho_j pad
    const Geom g = default_geom<KS>(q, a, p);
    const float c = b.z * g.s * g.okf;
    const float dvx = a.w - q[3];
    const float dvy = b.x - q[4];
    const float dvz = b.y - q[5];
    acc[0] += c * (dvy * g.dz - dvz * g.dy);
    acc[1] += c * (dvz * g.dx - dvx * g.dz);
    acc[2] += c * (dvx * g.dy - dvy * g.dx);
  }
};

}  // namespace

extern "C" {

NEREUS_PAIR_SWEEP(pbf_lambda, PbfLambda)
NEREUS_PAIR_SWEEP(pbf_dp, PbfDp)
NEREUS_PAIR_SWEEP(pbf_omega, PbfOmega)

}  // extern "C"
