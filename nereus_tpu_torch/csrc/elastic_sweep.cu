// Pair functions of the elastic solid and of the fluid-elastic coupling,
// for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/solvers/elastic_pallas.py::_sweep launches it over a body's
// static reference plan with elastic_f_pair, elastic_force_pair and
// elastic_hourglass_pair (nereus_tpu/ops/pallas_sph.py), and as
// generic_sweep launches it with fluid_reaction_pair (the reverse sweep of
// solvers/elastic_coupled.py::_estep_pallas; include_pressure=False, the
// friction alone, in solvers/dfsph_elastic.py::_destep_pallas).
//
// Design. FluidReaction is a functor of the range-walk template
// pair_sweep_kernel<Pair, KS> of sweep_common.cuh (one thread per query,
// exact neighbor ranges, rows 0-8 only: BOUNDARY_ROWS = false), in the
// operation order of nereus_tpu_torch/ops/sph_pairs.py, float32 without
// fast-math. A candidate outside the cutoff adds an exact 0 in the plain
// version, so it returns before loading the rest of its row.
//
// ElasticF (the deformation gradient's sum) and ElasticForceHourglass
// (the force and the hourglass sweeps of the TPU step fused: both read
// the same reference pairs after the F sweep; the two forces returned
// apart) run on the list form of the lane-group engine,
// group_list_sweep_kernel<P, KS, G> of group_sweep.cuh, over the body's
// static pair list (ElasticStatics.nbr_start, nbr: the pairs of its
// reference ranges with |X_ij|^2 < h^2, self pair included, built once
// when the body is made, before its first F sweep). The elastic functors
// read the REFERENCE positions X for the geometry and the spiky gradient
// scale; the current positions are payload. What held them back as range
// walks: one thread per query walking ~216 candidates of a lattice at
// spacing h/2 in series, of which ~29 lie within h, the same ~85 % tested
// and thrown away on every step, and at 4,096 queries (a 16^3 cube) 32
// blocks on 132 SMs. What the design does: G lanes per query share the
// query's ~29 list entries (one 4-byte index and one 32- or 96-byte row
// each), no range rows, no row table and no cutoff test (the self pair
// adds exactly 0: its X_ij is 0); G lanes per query put G times as many
// warps on a small body. G by query count: ops/cuda_sweep.py::
// elastic_group (only those instances are built). Measured on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md section 6): the force + hourglass
// over the list took 0.195 ms at 512,000 queries (its best range walk
// 0.489) and 0.0040 ms at 4,096 (0.0078); ElasticF 0.076 ms at 512,000
// (the range walk 0.177) and 0.0032 at 4,096 (0.0345).
//
// Bound: ElasticF by the bytes of its one matrix and its (N, 9) output
// over the list (40 operations per pair), ElasticForceHourglass by
// operations (~120 per pair); with the list's indices read, both by
// bytes. The reaction sweep by the query and range rows (a body's
// samples, most with few fluid neighbors).
//
// Layouts (row-major float32, 16-byte aligned rows):
//   ElasticF: q = src (N, 8) X0 X1 X2 x0 x1 x2 0 0 (the same matrix);
//       nbr_start (N + 1,) and nbr (P,) int32, the static pair list;
//       out (N, 9) sum_j (x_j - x_i)_a (s (X_i - X_j))_b at [3a + b]
//   ElasticForceHourglass: q = src (N, 24) X(3) x(3) PC(9) F(9), PC = P C^T
//       and F row-major; nbr_start (N + 1,) and nbr (P,) int32, the static
//       pair list; out (N, 6) f_el xyz, f_hg xyz, unscaled (the caller
//       applies V^2 and alpha V^2)
//   FluidReaction: q (Mb, 8) x y z vb_x vb_y vb_z psi 0 of a body sample;
//       src the fluid rows (C, 8) x y z vx vy vz rho 0; out (Mb, 3) force

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

constexpr int PC = 6;   // PC_i in the 24-wide row
constexpr int FM = 15;  // F_i in the 24-wide row

// (x_j - x_i) (x) grad W(X_ij) of one pair of the list, a = X0 X1 X2 x0
// of row j (the list admits the pair; the self pair adds exactly 0)
struct ElasticF {
  static constexpr int QW = 8, SW = 8, OW = 9;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float dx = q[0] - a.x;
    const float dy = q[1] - a.y;
    const float dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float4 b = src_f4(src, SW, j, 1);  // x1 x2 0 0
    float rl, invrl;
    rl_invrl(r2, rl, invrl);
    const float s = grad_scale_press<KS>(rl, invrl, p);
    const float g[3] = {s * dx, s * dy, s * dz};
    const float dc[3] = {a.w - q[3], b.x - q[4], b.y - q[5]};
#pragma unroll
    for (int u = 0; u < 3; ++u) {
#pragma unroll
      for (int v = 0; v < 3; ++v) acc[3 * u + v] += dc[u] * g[v];
    }
  }
};

// (PC_i + PC_j) . grad W(X_ij) and the hourglass term of one pair inside
// the cutoff, a = X0 X1 X2 x0 of row j (the engine or the list admits the
// pair; the self pair adds exactly 0 to both)
struct ElasticForceHourglass {
  static constexpr int QW = 24, SW = 24, OW = 6;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float dx = q[0] - a.x;
    const float dy = q[1] - a.y;
    const float dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    float s[SW];
    s[0] = a.x;
    s[1] = a.y;
    s[2] = a.z;
    s[3] = a.w;
#pragma unroll
    for (int k = 1; k < SW / 4; ++k) {
      const float4 t = src_f4(src, 24, j, k);
      s[4 * k + 0] = t.x;
      s[4 * k + 1] = t.y;
      s[4 * k + 2] = t.z;
      s[4 * k + 3] = t.w;
    }
    float rl, invrl;
    rl_invrl(r2, rl, invrl);
    // (PC_i + PC_j) . grad W(X_ij)
    const float sc = grad_scale_press<KS>(rl, invrl, p);
    const float g[3] = {sc * dx, sc * dy, sc * dz};
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      float t = (q[PC + 3 * u] + s[PC + 3 * u]) * g[0];
      t = t + (q[PC + 3 * u + 1] + s[PC + 3 * u + 1]) * g[1];
      t = t + (q[PC + 3 * u + 2] + s[PC + 3 * u + 2]) * g[2];
      acc[u] += t;
    }
    // hourglass: +1/2 W/|X|^2 (delta_i + delta_j) x_ij/|x_ij|^2 . x_ij;
    // the self pair (r^2 = 0) is masked before the 1/|X|^2
    if (!(r2 > 0.0f)) return;
    const float w = w_value<KS>(r2, rl, p);
    const float inv_x2 = w * (1.0f / fmaxf(r2, 1e-24f));
    const float dc[3] = {q[3] - s[3], q[4] - s[4], q[5] - s[5]};
    const float rc2 = dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2];
    const float invrc = rsqrtf(fmaxf(rc2, 1e-24f));
    const float dX[3] = {dx, dy, dz};
    float raw = 0.0f;
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int k = FM + 3 * u;
      const float fi = q[k] * dX[0] + q[k + 1] * dX[1] + q[k + 2] * dX[2];
      const float fj = s[k] * dX[0] + s[k + 1] * dX[1] + s[k + 2] * dX[2];
      const float t = (fi + fj - 2.0f * dc[u]) * dc[u];
      raw = u == 0 ? t : raw + t;
    }
    const float coef = 0.5f * inv_x2 * raw * (invrc * invrc);
    acc[3] += coef * dc[0];
    acc[4] += coef * dc[1];
    acc[5] += coef * dc[2];
  }
};

// force on a body sample from a fluid particle: friction
// nu max((v_b - v_i) . d, 0) psi grad W with nu = 2 m^2 mu^2 h c_s /
// (1 + 0.01 h^2) / rho_i^2, and (PRESSURE) -m psi max(p_i, 0)/rho_i^2 grad W
// with p_i from the Tait EOS of the source density; d = x_b - x_i
template <bool PRESSURE>
struct FluidReaction {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, 8, j, 0);  // x y z vx
    const float dx = q[0] - a.x;
    const float dy = q[1] - a.y;
    const float dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 < p.h2)) return;
    const float4 b = src_f4(src, 8, j, 1);  // vy vz rho 0
    float rl = 0.0f, invrl = 0.0f;
    if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
    const float psi = q[6];
    const float dens = fmaxf(b.z, 1e-12f);
    const float inv_dens = 1.0f / dens;
    const float sd = grad_scale_default<KS>(r2, rl, invrl, p);
    const float nu = ((2.0f * p.pm * p.pm * p.visc * p.visc * p.h * p.cs) /
                      (1.0f + 0.01f * p.h2)) *
                     (inv_dens * inv_dens);
    const float vdotr =
        (q[3] - a.w) * dx + (q[4] - b.x) * dy + (q[5] - b.y) * dz;
    const float cfric = nu * fmaxf(vdotr, 0.0f) * psi * sd;
    float c = cfric;
    if constexpr (PRESSURE) {
      const float ratio = dens * (1.0f / p.rd);
      const float ratio2 = ratio * ratio;
      const float p_i =
          fmaxf(p.k * (ratio2 * ratio2 * ratio2 * ratio - 1.0f), 0.0f);
      const float pd2 = p_i * inv_dens * inv_dens;
      c = cfric - p.pm * psi * pd2 * sd;
    }
    acc[0] += c * dx;
    acc[1] += c * dy;
    acc[2] += c * dz;
  }
};

}  // namespace

extern "C" {

// the G of ops/cuda_sweep.py::elastic_group
NEREUS_LIST_SWEEP(elastic_f, ElasticF, 4, 16)
NEREUS_LIST_SWEEP(elastic_force_hourglass, ElasticForceHourglass, 4, 16)

// pair_sweep_kernel<FluidReaction<include_pressure>> on `stream`; returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set or a
// switch other than 0 and 1.
int nereus_fluid_reaction_sweep(const float* q, const float* src,
                                const int* seg_start, const int* seg_end,
                                int n, int n_rows, const float* pvec,
                                int kernel_set, int include_pressure,
                                float* out, void* stream) {
  if (include_pressure == 1) {
    return nereus_sweep::launch_pair_sweep<FluidReaction<true>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, out, stream);
  }
  if (include_pressure == 0) {
    return nereus_sweep::launch_pair_sweep<FluidReaction<false>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, out, stream);
  }
  return -1;
}

}  // extern "C"
