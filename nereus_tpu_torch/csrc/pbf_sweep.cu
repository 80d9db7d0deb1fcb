// Pair functions of the PBF step (Position Based Fluids, Macklin & Muller
// 2013), for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the three
// PBF pair functions of pallas_sph.py that solvers/pbf_pallas.py runs:
// pbf_lambda_pair (the constraint sums, and vorticity confinement's N),
// pbf_dp_pair (the position correction) and pbf_omega_pair (the vorticity),
// and the lambda formula that pbf_step_pallas applies to the sums.
// Its XSPH pass is the Xsph functor of multiphase_sweep.cu.
//
// Design. The lambda and dp sweeps (each launched pbf_iters times per
// step), N and omega (once per step with vorticity confinement) run on the
// lane-group engine group_pair_sweep_kernel<Pair, KS, G> of
// group_sweep.cuh. What bounded them on this card as one thread per query:
// the 9 or 18 runs of 0-6 candidates walked in series, each run's bounds
// loaded after the previous run ended, lanes diverging on trip counts, and
// the pair math (W, the gradient scale, the rsqrt under Monaghan kernels,
// dp's s_corr) and every float4 of the row on every candidate, multiplied
// by 0 for the ~85 % outside the cutoff. What the design does:
// - G lanes per query walk the flattened runs, fluid and wall rows one
//   list; the pair runs only inside the cutoff, on the float4 x y z s the
//   engine loaded, which is all of a source row that lambda, dp or N
//   reads. Omega's pair loads its row's second float4 (vy vz m/rho_j)
//   there too, and only there; its one (C, 8) matrix is built through
//   planes (solvers/pbf_cuda.py::omega_operands).
// - One (C [+ Mb], 4) matrix per step (solvers/pbf_cuda.py): fluid rows
//   x y z lambda, wall rows x y z psi_b. Its fluid rows are both kernels'
//   queries; the whole matrix is both kernels' source. Each iteration
//   writes the iterate into the fluid rows' x y z, then lambda into their
//   slot 3, which the lambda kernel does not read (its fluid psi is m,
//   from the parameters). Reading lambda_j from a (N,) column beside the
//   matrix instead cost the dp kernel 11 % at 1,092,727 queries (a second
//   gather per candidate; PERF.md section 6), more than the write.
// - The lambda kernel's epilogue forms rho and lambda (solvers/
//   pbf_pallas.py's order, exact division) and writes them as two (N,)
//   planes: its five sums never leave the kernel.
// G per kernel: ops/cuda_sweep.py; only those instances are built.
// Every sweep of a step walks the ranges built from the advected
// positions x*, while the queries and sources carry the current iterate
// (the frozen-neighborhood contract; the TPU kernel's geom_offset = 4).
// The self pair stays in the ranges: it gives rho its m W(0), and every
// gradient term is exactly 0 there (r^2 is clamped before the rsqrt; the
// Muller gradient is a function of r^2 alone). Nothing divides in a pair,
// and the pairs keep the operation order of ops/sph_pairs.py.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   lambda: q (N, 4) x y z ., src (M, 4) fluid x y z . (the queries are
//           its first N rows; psi = m), wall x y z psi_b; out (2, N)
//           planes rho, lambda
//   N:      q = src (N, 4) x y z psi (m / rho_j |omega_j|), fluid rows only
//           (9 range rows); out (N, 5) sum psi W, sum psi grad W (3),
//           sum |psi grad W|^2
//   dp:     q (N, 4) x y z lambda_i, src (M, 4) fluid x y z lambda_j (the
//           queries), wall x y z psi_b; out (N, 3) sum m (lambda_i +
//           lambda_j + scorr) grad W + sum psi_b lambda_i grad W (the
//           caller scales by 1/rho0)
//   omega:  q = src (C, 8) x y z vx vy vz m/rho_j 0, fluid rows only (9
//           range rows); out (N, 3)

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// (dx, dy, dz, r^2, W, s) of a pair inside the cutoff, grad W = s * r the
// default gradient; the rsqrt only for Monaghan
struct WsGeom {
  float dx, dy, dz, r2, w, s;
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
  return g;
}

// sum psi W, sum psi grad W and sum |psi grad W|^2 over the fluid rows
// (the walls, when walked, add to the first two, not to the square sum),
// psi = a.w of row j, or with FLUID_M the particle mass on the fluid rows
template <bool FLUID_M>
struct PbfSums {
  static constexpr int QW = 4, SW = 4, OW = 5;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    const WsGeom g = ws_geom<KS>(q, a, p);
    const float psi = (FLUID_M && !B) ? p.pm : a.w;
    acc[0] += psi * g.w;
    const float c = psi * g.s;
    acc[1] += c * g.dx;
    acc[2] += c * g.dy;
    acc[3] += c * g.dz;
    if constexpr (!B) acc[4] += c * c * g.r2;
  }
};

// vorticity confinement's N: the sums over the fluid rows, psi = m/rho_j
// |omega_j| in slot 3, written as they are
struct PbfGrad : PbfSums<false> {
  static constexpr bool BOUNDARY_ROWS = false;
};

// the iterations' sums over the fluid rows (psi = m) and the wall rows
// (psi_b), turned into rho and lambda = -max(rho/rho0 - 1, 0) /
// ((|sum psi grad W|^2 + sum |psi grad W|^2)/rho0^2 + eps) by lane 0
struct PbfLambda : PbfSums<true> {
  static constexpr bool BOUNDARY_ROWS = true;
  static constexpr int OUTW = 2;
  __device__ static void epilogue(const float (&)[QW],
                                  const float (&acc)[OW], const Params& p,
                                  float (&o)[OUTW]) {
    const float comp = fmaxf(acc[0] / p.rd - 1.0f, 0.0f);
    const float denom =
        (acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3] + acc[4]) /
        (p.rd * p.rd);
    o[0] = acc[0];
    o[1] = -comp / (denom + p.pbf_eps);
  }
};

// the position correction: m (lambda_i + lambda_j - (W s_corr)^4) grad W
// over the fluid rows, psi_b lambda_i grad W over the wall rows, on
// a = x y z lambda_j (fluid) or x y z psi_b (wall)
struct PbfDp {
  static constexpr int QW = 4, SW = 4, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
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
    acc[0] += coef * g.dx;
    acc[1] += coef * g.dy;
    acc[2] += coef * g.dz;
  }
};

// omega = sum (m / rho_j) (v_j - v_i) x grad W over the fluid rows, on one
// (C, 8) matrix x y z vx | vy vz m/rho_j 0, the queries and the source; the
// engine calls it inside the cutoff with a = x y z vx of row j, and
// vy vz m/rho_j load only there
struct PbfOmega {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz m/rho_j 0
    const Geom g = default_geom<KS>(q, a, p);
    const float c = b.z * g.s;
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

// the G of ops/cuda_sweep.py (PBF_LAMBDA_G, pbf_dp_group, PBF_GRAD_G,
// PBF_OMEGA_G)
NEREUS_GROUP_SWEEP(pbf_lambda, PbfLambda, 2)
NEREUS_GROUP_SWEEP(pbf_dp, PbfDp, 2, 4)
NEREUS_GROUP_SWEEP(pbf_grad, PbfGrad, 2)
NEREUS_GROUP_SWEEP(pbf_omega, PbfOmega, 2)

}  // extern "C"
