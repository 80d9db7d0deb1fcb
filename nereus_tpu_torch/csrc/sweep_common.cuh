// Shared pieces of the neighbor-sweep kernels (sph_sweep.cu, iisph_sweep.cu):
// the packed parameter vector, the exact-range walk and the smoothing-kernel
// formulas, in the operation order of nereus_tpu_torch/ops/sph_pairs.py.
//
// Numerics: float32, no fast-math. r^2 is clamped to 1e-24 before the
// rsqrt, so every term except the density self term is exactly 0 at the
// self pair; see sph_sweep.cu for the viscosity bracket's order.

#pragma once

#include <cuda_runtime.h>

namespace nereus_sweep {

enum {
  PV_H2 = 0, PV_PM = 1, PV_KPOLY = 2, PV_KPRESS = 3, PV_KVISC = 4,
  PV_KVISC_DEN = 5, PV_H = 6, PV_KAPPA = 7, PV_WDIAM = 8, PV_BETA = 10,
  PV_VISC = 11, PV_CS = 12, PV_RD = 13, PV_K = 14, PV_KSURF1 = 15,
  PV_KSURF2 = 16, PV_KPOLY_GRAD = 17, PV_DT = 22
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

}  // namespace nereus_sweep
