// Shared pieces of the neighbor-sweep kernels (sph_sweep.cu and the
// functors of the other csrc/*.cu): the packed parameter vector, the
// exact-range walk, the smoothing-kernel formulas in the operation order of
// nereus_tpu_torch/ops/sph_pairs.py, and the pair-sweep kernel template.
//
// Numerics: float32, no fast-math. r^2 is clamped to 1e-24 before the
// rsqrt, so every term except the density self term is exactly 0 at the
// self pair; see sph_sweep.cu for the viscosity bracket's order.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace nereus_sweep {

enum {
  PV_H2 = 0, PV_PM = 1, PV_KPOLY = 2, PV_KPRESS = 3, PV_KVISC = 4,
  PV_KVISC_DEN = 5, PV_H = 6, PV_KAPPA = 7, PV_WDIAM = 8, PV_BETA = 10,
  PV_VISC = 11, PV_CS = 12, PV_RD = 13, PV_K = 14, PV_KSURF1 = 15,
  PV_KSURF2 = 16, PV_KPOLY_GRAD = 17, PV_DT = 22, PV_SCORR_S = 23,
  PV_STX = 24, PV_PBF_EPS = 25
};

// KernelSet and SurfaceTensionModel enum values of params.py
constexpr int MONAGHAN = 0;
constexpr int MULLER = 1;
constexpr int ST_NONE = 0;
constexpr int ST_BECKER = 1;
constexpr int ST_AKINCI = 2;

constexpr int THREADS = 128;
constexpr int N_ROWS = 9;

struct Params {
  float h2, pm, kpoly, kpress, kvisc, kvisc_den, h, kappa, wdiam, beta,
      visc, cs, rd, k, ksurf1, ksurf2, kpoly_grad, dt;
  float scorr_s;  // PBF k^(1/4) / W(dq h): scorr = -(W scorr_s)^4
  float stx;    // cross-phase Becker cohesion factor (SimConfig.st_cross)
  float pbf_eps;  // PBF constraint relaxation (SimConfig.pbf_eps)
  float sigma;  // Monaghan 1/(4 pi h^3)
};

__device__ __forceinline__ Params load_params(const float* __restrict__ pv) {
  Params p;
  p.h2 = __ldg(pv + PV_H2);
  p.pm = __ldg(pv + PV_PM);
  p.kpoly = __ldg(pv + PV_KPOLY);
  p.kpress = __ldg(pv + PV_KPRESS);
  p.kvisc = __ldg(pv + PV_KVISC);
  p.kvisc_den = __ldg(pv + PV_KVISC_DEN);
  p.h = __ldg(pv + PV_H);
  p.kappa = __ldg(pv + PV_KAPPA);
  p.wdiam = __ldg(pv + PV_WDIAM);
  p.beta = __ldg(pv + PV_BETA);
  p.visc = __ldg(pv + PV_VISC);
  p.cs = __ldg(pv + PV_CS);
  p.rd = __ldg(pv + PV_RD);
  p.k = __ldg(pv + PV_K);
  p.ksurf1 = __ldg(pv + PV_KSURF1);
  p.ksurf2 = __ldg(pv + PV_KSURF2);
  p.kpoly_grad = __ldg(pv + PV_KPOLY_GRAD);
  p.dt = __ldg(pv + PV_DT);
  p.scorr_s = __ldg(pv + PV_SCORR_S);
  p.stx = __ldg(pv + PV_STX);
  p.pbf_eps = __ldg(pv + PV_PBF_EPS);
  p.sigma = 1.0f / (12.566370614359172f * p.h * p.h * p.h);
  return p;
}

// Calls f(j) for every source index j of rows [row0, row1) of query i.
template <typename F>
__device__ __forceinline__ void for_each_source(
    int i, int n, int row0, int row1, const int* __restrict__ seg_start,
    const int* __restrict__ seg_end, F&& f) {
  for (int r = row0; r < row1; ++r) {
    const int s = __ldg(seg_start + static_cast<size_t>(r) * n + i);
    const int e = __ldg(seg_end + static_cast<size_t>(r) * n + i);
    for (int j = s; j < e; ++j) f(j);
  }
}

__device__ __forceinline__ void rl_invrl(float r2, float& rl, float& invrl) {
  invrl = rsqrtf(fmaxf(r2, 1e-24f));
  rl = r2 * invrl;
}

template <int KS>
__device__ __forceinline__ float w_value(float r2, float rl, const Params& p) {
  if constexpr (KS == MULLER) {
    const float d = fmaxf(p.h2 - r2, 0.0f);
    return p.kpoly * d * d * d;
  } else {
    const float q = rl / p.h;
    const float a = fmaxf(2.0f - q, 0.0f);
    const float b = fmaxf(1.0f - q, 0.0f);
    return p.sigma * (a * a * a - 4.0f * b * b * b);
  }
}

__device__ __forceinline__ float grad_scale_monaghan(float rl, float invrl,
                                                     const Params& p) {
  const float q = rl / p.h;
  const float a = fmaxf(2.0f - q, 0.0f);
  const float b = fmaxf(1.0f - q, 0.0f);
  return (p.sigma / p.h) * (-3.0f * a * a + 12.0f * b * b) * invrl;
}

// s with grad W = s * r for the poly6/default gradient
template <int KS>
__device__ __forceinline__ float grad_scale_default(float r2, float rl,
                                                    float invrl,
                                                    const Params& p) {
  if constexpr (KS == MULLER) {
    const float d = fmaxf(p.h2 - r2, 0.0f);
    return p.kpoly_grad * d * d;
  } else {
    return grad_scale_monaghan(rl, invrl, p);
  }
}

// s for the spiky pressure gradient
template <int KS>
__device__ __forceinline__ float grad_scale_press(float rl, float invrl,
                                                  const Params& p) {
  if constexpr (KS == MULLER) {
    const float hr = fmaxf(p.h - rl, 0.0f);
    return p.kpress * hr * hr * invrl;
  } else {
    return grad_scale_monaghan(rl, invrl, p);
  }
}

// r . grad W_visc; r^2 multiplies the bracket before the KVISC constant
template <int KS>
__device__ __forceinline__ float visc_rdotgrad(float r2, float rl,
                                               float invrl, const Params& p) {
  if constexpr (KS == MULLER) {
    const float inv3 = invrl * invrl * invrl;
    const float c = (2.0f / p.h2) - rl * (3.0f / p.kvisc_den) -
                    inv3 * (p.h * 0.5f);
    return (c * r2) * p.kvisc;
  } else {
    return grad_scale_monaghan(rl, invrl, p) * r2;
  }
}

inline int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

// ---------------------------------------------------------------------------
// The pair-sweep kernel: the range walk of a generic_sweep pair function
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it. One thread per
// hash-sorted query walks its exact neighbor ranges, rows 0-8 over the
// fluid region and rows 9-17 (when present) over the boundary region of one
// source matrix. The pair math comes from a functor P with the query,
// source and output widths (QW, SW, OW; QW and SW multiples of 4, one float4
// load each), BOUNDARY_ROWS (whether rows 9-17 are walked), and
// template <int KS, bool B> pair(q, src, j, params, acc) with B true on the
// boundary rows. Every formula keeps the operation order of ops/sph_pairs.py.
//
// Bound: memory traffic. Each candidate reads one source row (32 or 48
// bytes) at a data-dependent address and does ~20-40 flops on it; sorted
// neighbors share rows, so most reads hit L1/L2. tiled_sweep.cuh's
// tiled_pair_sweep_kernel takes the same functors over tiles of queries
// that share a cell row.

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

// Pair geometry with the default gradient: grad W = s * (dx, dy, dz). The
// Muller gradient is a function of r^2 alone, so it skips the rsqrt.
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

// The multiphase density's pair geometry and W = wa * wb (Muller:
// kpoly d^2 and d with d = max(h^2 - r^2, 0); Monaghan: sigma and
// a^3 - 4 b^3), in w_value's operation order, each product that feeds a
// sum an explicit intrinsic (__fmaf_rn, __fmul_rn), which nvcc neither
// contracts nor splits: nvcc contracts a plain expression by its context,
// so two functors that add the same plain W may round it differently.
// Every functor that adds W through mp_density_add gets the same bits.
// rl and invrl (Monaghan; 0 for Muller) serve the same pair's gradient.
struct MpGeom {
  float dx, dy, dz, r2, rl, invrl, wa, wb;
};

template <int KS>
__device__ __forceinline__ MpGeom mp_geom(const float* q, float4 a,
                                          const Params& p) {
  MpGeom g;
  g.dx = q[0] - a.x;
  g.dy = q[1] - a.y;
  g.dz = q[2] - a.z;
  g.r2 = __fmaf_rn(g.dz, g.dz, __fmaf_rn(g.dy, g.dy, __fmul_rn(g.dx, g.dx)));
  g.rl = 0.0f;
  g.invrl = 0.0f;
  if constexpr (KS == MULLER) {
    const float d = fmaxf(p.h2 - g.r2, 0.0f);
    g.wa = __fmul_rn(__fmul_rn(p.kpoly, d), d);
    g.wb = d;
  } else {
    rl_invrl(g.r2, g.rl, g.invrl);
    const float qh = g.rl / p.h;
    const float ta = fmaxf(2.0f - qh, 0.0f);
    const float tb = fmaxf(1.0f - qh, 0.0f);
    g.wa = p.sigma;
    g.wb = __fmaf_rn(__fmul_rn(ta, ta), ta,
                     -__fmul_rn(__fmul_rn(4.0f * tb, tb), tb));
  }
  return g;
}

// the multiphase density's sums of one pair inside the cutoff: W into
// acc0 (fluid rows) or psi_b W into acc1 (wall rows, psi_b = a.w), each
// an explicit fused multiply-add (mp_geom)
template <bool B>
__device__ __forceinline__ void mp_density_add(const MpGeom& g, float4 a,
                                               float& acc0, float& acc1) {
  if constexpr (B) {
    acc1 = __fmaf_rn(a.w, __fmul_rn(g.wa, g.wb), acc1);
  } else {
    acc0 = __fmaf_rn(g.wa, g.wb, acc0);
  }
}

// the k-th float4 of source row j of a (M, width) matrix
__device__ __forceinline__ float4 src_f4(const float* src, int width, int j,
                                         int k) {
  return __ldg(reinterpret_cast<const float4*>(src) +
               static_cast<size_t>(j) * (width / 4) + k);
}

// A pair functor may define `static void prologue(float (&q)[QW], const
// Params&)`: pair_sweep_kernel calls it once per query, after loading the
// query row, to turn per-query inputs into the constants pair() reads.
template <class P, class = void>
struct HasPrologue : std::false_type {};
template <class P>
struct HasPrologue<P, std::void_t<decltype(&P::prologue)>>
    : std::true_type {};

template <class P, int KS>
__global__ void __launch_bounds__(THREADS)
pair_sweep_kernel(const float* __restrict__ q, const float* __restrict__ src,
                  const int* __restrict__ seg_start,
                  const int* __restrict__ seg_end, int n, int n_rows,
                  const float* __restrict__ pv, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(pv);
  float qv[P::QW];
  load_row<P::QW>(q, i, qv);
  if constexpr (HasPrologue<P>::value) P::prologue(qv, p);
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

// The boundary form of a pair functor P over a source of boundary samples
// alone (a body shell), or over the fluid rows with a body's samples as the
// queries: P's widths and its B = true formula, on rows 0-8 only (the
// ranges are (9, N)). A body sweep thus reads 9 range rows, not 18 rows of
// which 9 are empty.
template <class P>
struct BoundaryForm {
  static constexpr int QW = P::QW, SW = P::SW, OW = P::OW;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    P::template pair<KS, true>(q, src, j, p, acc);
  }
};

// Launches pair_sweep_kernel<P, kernel_set> on `stream`; returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set.
template <class P>
int launch_pair_sweep(const float* q, const float* src, const int* seg_start,
                      const int* seg_end, int n, int n_rows,
                      const float* pvec, int kernel_set, float* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kernel_set == MULLER) {
    pair_sweep_kernel<P, MULLER><<<blocks_for(n), THREADS, 0, st>>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, out);
  } else if (kernel_set == MONAGHAN) {
    pair_sweep_kernel<P, MONAGHAN><<<blocks_for(n), THREADS, 0, st>>>(
        q, src, seg_start, seg_end, n, n_rows, pvec, out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nereus_sweep

// The C entry point nereus_<NAME>_sweep of pair_sweep_kernel<PAIR>, for use
// inside an extern "C" block: launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set.
#define NEREUS_PAIR_SWEEP(NAME, PAIR)                                        \
  int nereus_##NAME##_sweep(const float* q, const float* src,               \
                            const int* seg_start, const int* seg_end, int n, \
                            int n_rows, const float* pvec, int kernel_set,   \
                            float* out, void* stream) {                      \
    return nereus_sweep::launch_pair_sweep<PAIR>(                          \
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, out,        \
        stream);                                                             \
  }
