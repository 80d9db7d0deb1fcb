// The source-layout probe, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/probe_transposed.py::kernel (launched by
// pl.pallas_call at :135, built by `build` at :101): a synthetic
// force-weight sweep that times one source layout at a realistic size.
// Per 128-query block, 9 rows x 2 passes of windows of `ws` source rows;
// a window's start is (anchor - 1) * 8 rows and anchor 0 is a sentinel
// (no window). Each slot evaluates the same ~70-operation force-weight
// formula (probe_transposed.py:57-98) with stand-in bounds lo = 0.5 qx + r,
// hi = lo + 30 tested on source column 7, and adds its force to the query.
// The TPU probe asked whether a transposed (particles along sublanes)
// source beat its (8, M) one; here the question is the port's: do the
// (M, 8) float rows the sweeps read now, two float4 per source (AoS), beat
// (8, M) columns, eight scalar loads (SoA)? One template, two instances.
//
// Design: one thread per query, one 128-thread block per query block (the
// TPU's 128 lanes). Every thread of a block walks the same windows, so each
// source load is a broadcast of one address across the warp, served by L1
// after the first warp; every slot is evaluated (no early exit), as on the
// TPU, so the work per slot is fixed and the layout is what differs. A
// window that would run past the source is started at m_src - ws, as
// lax.dynamic_slice (interpret mode) clamps it; only pass-1 windows of the
// last blocks can.
//
// Bound: operations, ~70 per slot (1.3 non-sentinel windows x ws x 128
// slots per block row) against 16-32 bytes per slot, nearly all from L1.
//
// Layouts: anchors (m/128 * 18,) int32 indexed (block * 9 + row) * 2 +
// pass; q (8, m) float32 x y z vx vy vz pad pd2; src (m_src, 8) rows (AoS)
// or (8, m_src) columns (SoA) x y z vx vy vz dens hash; out (4, m), row 3
// zero.

#include <cuda_runtime.h>

namespace {

constexpr int B = 128, N_ROWS = 9, N_PASS = 2;

template <bool SOA>
__device__ __forceinline__ void load_src(const float* __restrict__ src,
                                         int m_src, int j, float (&s)[8]) {
  if constexpr (SOA) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      s[k] = __ldg(src + static_cast<size_t>(k) * m_src + j);
    }
  } else {
    const float4* row = reinterpret_cast<const float4*>(src) +
                        2 * static_cast<size_t>(j);
    const float4 a = __ldg(row), b = __ldg(row + 1);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
  }
}

template <bool SOA>
__global__ void __launch_bounds__(B)
layout_probe_kernel(const int* __restrict__ anchors,
                    const float* __restrict__ q,
                    const float* __restrict__ src, int m, int m_src, int ws,
                    float* __restrict__ out) {
  const int b = blockIdx.x;
  const int i = b * B + threadIdx.x;
  const float qx = __ldg(q + i), qy = __ldg(q + m + i),
              qz = __ldg(q + 2 * m + i);
  const float qvx = __ldg(q + 3 * m + i), qvy = __ldg(q + 4 * m + i),
              qvz = __ldg(q + 5 * m + i), qpd = __ldg(q + 7 * m + i);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int r = 0; r < N_ROWS; ++r) {
    const float lo = qx * 0.5f + static_cast<float>(r);
    const float hi = lo + 30.0f;
    for (int p = 0; p < N_PASS; ++p) {
      const int a = __ldg(anchors + (b * N_ROWS + r) * N_PASS + p);
      if (a <= 0) continue;
      const int start = min((a - 1) * 8, m_src - ws);
      float wx = 0.0f, wy = 0.0f, wz = 0.0f;
      for (int t = 0; t < ws; ++t) {
        float s[8];
        load_src<SOA>(src, m_src, start + t, s);
        const float dens_j = fmaxf(s[6], 1e-12f);
        const bool valid = (s[7] >= lo) & (s[7] <= hi);
        const float dx = qx - s[0], dy = qy - s[1], dz = qz - s[2];
        const float r2 = dx * dx + dy * dy + dz * dz;
        const float inv = rsqrtf(fmaxf(r2, 1e-24f));
        const float rl = r2 * inv;
        const float okf = (valid & (r2 < 0.0021f)) ? 1.0f : 0.0f;
        const float inv_dens = 1.0f / dens_j;
        const float inv3 = inv * inv * inv;
        const float c = 950.0f - rl * 3.1e5f - inv3 * 0.023f;
        const float bden = r2 + 2.1e-5f;
        const float cvisc = (inv_dens * 1e-7f) * ((c * r2) / bden) * okf;
        const float ratio = dens_j * 1e-3f;
        const float r2a = ratio * ratio;
        const float p_j = 800.0f * (r2a * r2a * r2a * ratio - 1.0f);
        const float pd2_j = p_j * inv_dens * inv_dens;
        const float hr = fmaxf(0.0457f - rl, 0.0f);
        const float sp = (hr * hr) * inv * -24.0f;
        float cpd = (qpd + pd2_j) * sp;
        const float dpo = fmaxf(0.0021f - r2, 0.0f);
        const float w = dpo * dpo * dpo * 6.8e9f;
        const float w_eff = r2 > 1.6e-3f ? w : 0.11f;
        cpd = (cpd - 0.08f * w_eff) * okf;
        wx += cvisc * (qvx - s[3]) + cpd * dx;
        wy += cvisc * (qvy - s[4]) + cpd * dy;
        wz += cvisc * (qvz - s[5]) + cpd * dz;
      }
      ax += wx;
      ay += wy;
      az += wz;
    }
  }
  out[i] = ax;
  out[m + i] = ay;
  out[2 * m + i] = az;
  out[3 * m + i] = 0.0f;
}

}  // namespace

extern "C" {

// Launches layout_probe_kernel<soa> on `stream` (m a multiple of 128,
// m_src >= ws > 0); returns cudaGetLastError() (0 on success), or -1 for
// a switch other than 0 and 1.
int nereus_layout_probe(const int* anchors, const float* q, const float* src,
                        int m, int m_src, int ws, int soa, float* out,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (soa == 1) {
    layout_probe_kernel<true><<<m / B, B, 0, st>>>(anchors, q, src, m, m_src,
                                                   ws, out);
  } else if (soa == 0) {
    layout_probe_kernel<false><<<m / B, B, 0, st>>>(anchors, q, src, m,
                                                    m_src, ws, out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
