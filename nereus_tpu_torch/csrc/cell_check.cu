// In-kernel cell coordinates of the sweep queries, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/wideprobe.py::cellcheck (its kernel `kern`,
// launched by pl.pallas_call at :80): each query's cell recomputed inside a
// kernel from the parameter vector, floor((v - o) * inv_cell) clamped to
// [0, g - 1] per axis, for comparison with the host's
// grid.cell_coords_cols. On the TPU it isolated the wide-hash defect of
// the window plan; the port's sweeps walk int32 ranges built from
// grid.cell_coords, and the check (nereus_tpu_torch/probes/cells.py) holds
// those cells against a kernel's own after a grid refit and past 2^24
// cells.
//
// Design: one thread per query reads the first float4 of its row (x y z of
// the (N, 4) or (N, 8) queries) and writes one int4. The subtraction and
// the multiplication are __fsub_rn / __fmul_rn, so nvcc cannot contract
// them into an FMA: the coordinates round as torch rounds (v - o) * inv,
// with inv the float32 1/cell of the parameter vector (never 1.0f / cell
// here, whose last bit can differ). The clamp is on the float, before the
// int cast, so parked slots at 1e9 saturate instead of overflowing.
//
// Bound: memory traffic, 16 bytes read and 16 written per query.
//
// Layouts: q (N, QW) float32, QW 4 or 8, rows 16-byte aligned; pvec the
// PV_* vector of ops/sph_pairs.py (origin at PV_OX..PV_OZ, 1/cell at
// PV_INVCELL); out (N, 4) int32, column 3 zero.

#include <cuda_runtime.h>

namespace {

constexpr int PV_OX = 18, PV_OY = 19, PV_OZ = 20, PV_INVCELL = 21;
constexpr int THREADS = 256;

__device__ __forceinline__ int cell_of(float v, float o, float inv, int g) {
  const float c = floorf(__fmul_rn(__fsub_rn(v, o), inv));
  return static_cast<int>(fminf(fmaxf(c, 0.0f), static_cast<float>(g - 1)));
}

__global__ void __launch_bounds__(THREADS)
cell_check_kernel(const float* __restrict__ q, int n, int qw,
                  const float* __restrict__ pv, int gx, int gy, int gz,
                  int4* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 a = __ldg(reinterpret_cast<const float4*>(
      q + static_cast<size_t>(i) * qw));
  const float inv = __ldg(pv + PV_INVCELL);
  out[i] = make_int4(cell_of(a.x, __ldg(pv + PV_OX), inv, gx),
                     cell_of(a.y, __ldg(pv + PV_OY), inv, gy),
                     cell_of(a.z, __ldg(pv + PV_OZ), inv, gz), 0);
}

}  // namespace

extern "C" {

// Launches cell_check_kernel on `stream`; returns cudaGetLastError() (0 on
// success), or -1 for a query width other than 4 and 8.
int nereus_cell_check(const float* q, int n, int qw, const float* pvec,
                      int gx, int gy, int gz, int* out, void* stream) {
  if (qw != 4 && qw != 8) return -1;
  cell_check_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      q, n, qw, pvec, gx, gy, gz, reinterpret_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
