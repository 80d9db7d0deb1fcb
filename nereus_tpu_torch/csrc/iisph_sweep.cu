// Neighbor-sweep kernels of the IISPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the five
// IISPH pair functions of pallas_sph.py: dii_rhoadv_pair, aii_pair,
// sum_dij_pair, jacobi_fluid_pair + jacobi_boundary_pair, and
// grad_pressure_force_pair (solvers/iisph_pallas.py::iisph_step_pallas).
//
// Design: the range walk of sph_sweep.cu. One thread per hash-sorted query
// walks its exact neighbor ranges, rows 0-8 over the fluid region and rows
// 9-17 (when present) over the boundary region of one source matrix. One
// kernel template, iisph_sweep_kernel<Pair, KS>, takes the pair math from a
// functor with the query, source and output widths and a fluid and a
// boundary formula; every formula keeps the operation order of
// ops/sph_pairs.py. All five use the default (poly6 / Monaghan) gradient,
// which is exactly 0 at the self pair, so self-pairs stay in the ranges.
//
// Bound: memory traffic, as in sph_sweep.cu: each candidate reads one
// source row (32 or 48 bytes) at a data-dependent address and does ~20-40
// flops on it; sorted neighbors share rows, so most reads hit L1/L2.
// Shared-memory tiling of a cell block's sources is later work.
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

#include "sweep_common.cuh"

namespace {

using namespace nereus_sweep;

template <int W>
__device__ __forceinline__ void load_row(const float* __restrict__ base,
                                         int i, float (&v)[W]) {
  const float4* p =
      reinterpret_cast<const float4*>(base) + static_cast<size_t>(i) * (W / 4);
#pragma unroll
  for (int k = 0; k < W / 4; ++k) {
    const float4 t = __ldg(p + k);
    v[4 * k + 0] = t.x;
    v[4 * k + 1] = t.y;
    v[4 * k + 2] = t.z;
    v[4 * k + 3] = t.w;
  }
}

// Pair geometry with the default gradient: grad W = s * (dx, dy, dz)
struct Geom {
  float dx, dy, dz, r2, s, okf;
};

template <int KS>
__device__ __forceinline__ Geom default_geom(const float* q, float4 a,
                                             const Params& p) {
  Geom g;
  g.dx = q[0] - a.x;
  g.dy = q[1] - a.y;
  g.dz = q[2] - a.z;
  g.r2 = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(g.r2, rl, invrl);
  g.s = grad_scale_default<KS>(g.r2, rl, invrl, p);
  g.okf = g.r2 < p.h2 ? 1.0f : 0.0f;
  return g;
}

__device__ __forceinline__ float4 src_f4(const float* src, int width, int j,
                                         int k) {
  return __ldg(reinterpret_cast<const float4*>(src) +
               static_cast<size_t>(j) * (width / 4) + k);
}

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

template <class P, int KS>
__global__ void __launch_bounds__(THREADS)
iisph_sweep_kernel(const float* __restrict__ q, const float* __restrict__ src,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ seg_end, int n, int n_rows,
                   const float* __restrict__ pv, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(pv);
  float qv[P::QW];
  load_row<P::QW>(q, i, qv);
  float acc[P::OW];
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = 0.0f;
  for_each_source(i, n, 0, min(n_rows, N_ROWS), seg_start, seg_end,
                  [&](int j) {
    P::template pair<KS, false>(qv, src, j, p, acc);
  });
  if constexpr (P::BOUNDARY_ROWS) {
    for_each_source(i, n, N_ROWS, n_rows, seg_start, seg_end, [&](int j) {
      P::template pair<KS, true>(qv, src, j, p, acc);
    });
  }
#pragma unroll
  for (int k = 0; k < P::OW; ++k) out[static_cast<size_t>(i) * P::OW + k] = acc[k];
}

template <class P>
int launch(const float* q, const float* src, const int* seg_start,
           const int* seg_end, int n, int n_rows, const float* pvec,
           int kernel_set, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel_set == MULLER) {
    iisph_sweep_kernel<P, MULLER><<<blocks_for(n), THREADS, 0, st>>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, out);
  } else if (kernel_set == MONAGHAN) {
    iisph_sweep_kernel<P, MONAGHAN><<<blocks_for(n), THREADS, 0, st>>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); an unknown kernel set returns -1.

int nereus_dii_rhoadv_sweep(const float* q, const float* src,
                            const int* seg_start, const int* seg_end, int n,
                            int n_rows, const float* pvec, int kernel_set,
                            float* out, void* stream) {
  return launch<DiiRhoAdv>(q, src, seg_start, seg_end, n, n_rows, pvec,
                           kernel_set, out, stream);
}

int nereus_aii_sweep(const float* q, const float* src, const int* seg_start,
                     const int* seg_end, int n, int n_rows, const float* pvec,
                     int kernel_set, float* out, void* stream) {
  return launch<Aii>(q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set,
                     out, stream);
}

int nereus_sum_dij_sweep(const float* q, const float* src,
                         const int* seg_start, const int* seg_end, int n,
                         int n_rows, const float* pvec, int kernel_set,
                         float* out, void* stream) {
  return launch<SumDij>(q, src, seg_start, seg_end, n, n_rows, pvec,
                        kernel_set, out, stream);
}

int nereus_jacobi_sweep(const float* q, const float* src,
                        const int* seg_start, const int* seg_end, int n,
                        int n_rows, const float* pvec, int kernel_set,
                        float* out, void* stream) {
  return launch<Jacobi>(q, src, seg_start, seg_end, n, n_rows, pvec,
                        kernel_set, out, stream);
}

int nereus_pressure_force_sweep(const float* q, const float* src,
                                const int* seg_start, const int* seg_end,
                                int n, int n_rows, const float* pvec,
                                int kernel_set, float* out, void* stream) {
  return launch<PressureForce>(q, src, seg_start, seg_end, n, n_rows, pvec,
                               kernel_set, out, stream);
}

}  // extern "C"
