// The row-tiled pair-sweep engine tiled_pair_sweep_kernel<P, KS>, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it, for the pair
// functors moved onto this engine: ViscLaplacian (viscosity_sweep.cu, the
// implicit viscosity CG's matvec) and PressureForce (iisph_sweep.cu, the
// pressure force of IISPH and PCISPH's corrective loop, DFSPH's kappa
// correction). The other functors run on pair_sweep_kernel
// (sweep_common.cuh). The functor contract is the same: QW, SW, OW,
// BOUNDARY_ROWS, pair<KS, B>(q, src, j, params, acc) and the optional
// prologue. Moving a functor onto this engine is its launch macro,
// NEREUS_TILED_SWEEP instead of NEREUS_PAIR_SWEEP.
//
// What bounds pair_sweep_kernel on this card is latency, then the range
// bytes. One thread per query walks 9 (18) short ranges in series: a row's
// bounds are loaded only after the previous row's walk ends, each walk is
// 0-6 candidates of data-dependent 16-byte loads, and the lanes of a warp
// diverge on their trip counts. The (18, N) int32 range rows are 144 bytes
// per query against ~76 for the query row, source row and output, and the
// 9 wall rows are empty for nearly every query. Every source row is read
// again by each of the ~38-53 queries that see it, served by L1 alone.
//
// Design:
// - Tiles aligned with cell rows. A tile is a run of at most T hash-sorted
//   queries inside one (y, z) cell row (ops/cuda_sweep.py::tile_plan: a
//   few torch operations once per step on the device, no host read, the
//   plan reused by every launch over the same ranges). Within a (y, z) row
//   the hash order is x order, so for each stencil row r the queries'
//   ranges are non-decreasing and their union lies in the one span [s of
//   the first query, e of the last) of the sorted source, which the CTA
//   reads from the range rows. One CTA of T threads takes one tile; the
//   grid is the plan's upper bound of tiles, and CTAs past the tile count
//   (read from device memory) exit.
// - Empty spans skipped. A span of length 0 is skipped by the whole CTA
//   without reading its range rows: the wall phase of a tile in the
//   fluid's interior costs a few shared-memory reads.
// - Ranges loaded a slab ahead. The bounds of a dz slab's three rows load
//   while the previous slab is walked, the first slab's before the walk
//   starts: six loads in flight per thread instead of two in series, with
//   few enough registers for a full SM (the bounds of all nine rows at
//   once measured slower: fewer warps fit).
// - No staging. Copying each tile's spans into shared memory (coalesced
//   16-byte cp.async) and walking them there measured about twice as slow
//   on every main path (PERF.md section 6): the sorted source is already
//   served by L1 to the CTAs of neighbouring rows, and staging reads each
//   span once more per tile. Every span is walked from device memory.
// - The order of summation is pair_sweep_kernel's: rows 0-8, then 9-17, j
//   ascending within a row, through the same functor on the same values,
//   so the output equals pair_sweep_kernel's bit for bit, whatever the
//   tile size.
// Parked slots (INT32_MAX hashes) form tiles of their own that read no
// range and write 0, as pair_sweep_kernel's walk of the corner cell gives
// (no source lies within h of a slot parked at 1e9).
//
// Plan layout (int32): bounds (n_ctas + 1,), tile t holding the queries
// bounds[t] .. bounds[t + 1] - 1; n_tiles (1,).

#pragma once

#include "sweep_common.cuh"

namespace nereus_sweep {

constexpr int TILE_MAX = 256;  // the largest tile: threads per CTA
constexpr int INT32_MAX_HASH = 0x7fffffff;  // a parked slot's hash

constexpr int SLAB = 3;  // the dy rows of one dz slab of the stencil

// One phase of a tile: rows R0..R0+8 (B: the wall rows 9-17), three dz
// slabs of three dy rows each. Walks the query's ranges into acc, the
// bounds of the next slab's rows loading while a slab is walked; the first
// slab's come in `next_s`, `next_e` (the fluid phase's, loaded by the
// caller before the spans are known) or are loaded here before the walk
// (the wall phase's). The CTA skips a phase whose spans are all empty.
template <class P, int KS, bool B>
__device__ __forceinline__ void tiled_phase(
    const int2* sp, const float* __restrict__ src,
    const int* __restrict__ seg_start, const int* __restrict__ seg_end,
    int n, int n_rows, int i, bool live, int (&next_s)[SLAB],
    int (&next_e)[SLAB], const float (&qv)[P::QW], const Params& p,
    float (&acc)[P::OW]) {
  constexpr int R0 = B ? N_ROWS : 0;
  bool any = false;  // the same in every thread
#pragma unroll
  for (int k = 0; k < N_ROWS; ++k) {
    any = any || (R0 + k < n_rows && sp[R0 + k].y > 0);
  }
  if (!any || !live) return;
  // [s, e) of row R0 + k, empty where the tile's span is
  auto bounds = [&](int k, int& s, int& e) {
    const int r = R0 + k;
    s = 0;
    e = 0;
    if (r < n_rows && sp[r].y > 0) {
      s = __ldg(seg_start + static_cast<size_t>(r) * n + i);
      e = __ldg(seg_end + static_cast<size_t>(r) * n + i);
    }
  };
  if constexpr (B) {
#pragma unroll
    for (int k = 0; k < SLAB; ++k) bounds(k, next_s[k], next_e[k]);
  }
#pragma unroll
  for (int g = 0; g < N_ROWS / SLAB; ++g) {
    int s[SLAB], e[SLAB];
#pragma unroll
    for (int k = 0; k < SLAB; ++k) {
      s[k] = next_s[k];
      e[k] = next_e[k];
    }
    if (g + 1 < N_ROWS / SLAB) {
#pragma unroll
      for (int k = 0; k < SLAB; ++k) {
        bounds(SLAB * (g + 1) + k, next_s[k], next_e[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < SLAB; ++k) {
      for (int j = s[k]; j < e[k]; ++j) {
        P::template pair<KS, B>(qv, src, j, p, acc);
      }
    }
  }
}

// One CTA per tile of the plan: tile t holds the queries bounds[t] ..
// bounds[t + 1] - 1, t below the tile count (read from device memory).
// The first threads read the tile's span of each range row, [s of its
// first query, e of its last), into shared memory.
template <class P, int KS>
__global__ void __launch_bounds__(TILE_MAX)
tiled_pair_sweep_kernel(const float* __restrict__ q,
                        const float* __restrict__ src,
                        const int* __restrict__ seg_start,
                        const int* __restrict__ seg_end, int n, int n_rows,
                        const int* __restrict__ bounds,
                        const int* __restrict__ n_tiles,
                        const int* __restrict__ sorted_hash,
                        const float* __restrict__ pv,
                        float* __restrict__ out) {
  __shared__ int2 sp[2 * N_ROWS];  // per row: the span's lo, its length
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  // bounds has n_ctas + 1 entries: read t's with the tile count, in one
  // round of loads, then the spans in a second (a CTA walks ~50 queries,
  // so its start-up latency counts)
  const int n_t = __ldg(n_tiles);
  const int first = __ldg(bounds + t);
  const int count = __ldg(bounds + t + 1) - first;
  if (t >= n_t) return;  // past the plan's tile count
  const bool live = tid < count;
  const int i = first + tid;
  // the first fluid slab's bounds, loaded with the spans (a row whose span
  // turns out empty has empty ranges; a parked tile walks nothing)
  int next_s[SLAB], next_e[SLAB];
#pragma unroll
  for (int k = 0; k < SLAB; ++k) {
    next_s[k] = live ? __ldg(seg_start + static_cast<size_t>(k) * n + i) : 0;
    next_e[k] = live ? __ldg(seg_end + static_cast<size_t>(k) * n + i) : 0;
  }
  if (tid < n_rows) {
    const int lo = __ldg(seg_start + static_cast<size_t>(tid) * n + first);
    const int hi =
        __ldg(seg_end + static_cast<size_t>(tid) * n + first + count - 1);
    // parked slots sort last, in tiles of their own that reach no source
    const bool parked = __ldg(sorted_hash + first) == INT32_MAX_HASH;
    const int len = parked ? 0 : max(hi - lo, 0);
    sp[tid] = make_int2(len > 0 ? lo : 0, len);
  }
  __syncthreads();
  const Params p = load_params(pv);
  float qv[P::QW];
#pragma unroll
  for (int k = 0; k < P::QW; ++k) qv[k] = 0.0f;
  if (live) {
    load_row<P::QW>(q, i, qv);
    if constexpr (HasPrologue<P>::value) P::prologue(qv, p);
  }
  float acc[P::OW];
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = 0.0f;
  tiled_phase<P, KS, false>(sp, src, seg_start, seg_end, n, n_rows, i, live,
                            next_s, next_e, qv, p, acc);
  if constexpr (P::BOUNDARY_ROWS) {
    tiled_phase<P, KS, true>(sp, src, seg_start, seg_end, n, n_rows, i,
                             live, next_s, next_e, qv, p, acc);
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < P::OW; ++k) {
      out[static_cast<size_t>(i) * P::OW + k] = acc[k];
    }
  }
}

// Launches tiled_pair_sweep_kernel<P, kernel_set> on `stream`: n_ctas CTAs
// (the plan's upper bound of tiles) of `tile` threads; returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set or a
// tile that is not a multiple of 32 in [32, TILE_MAX].
template <class P>
int launch_tiled_sweep(const float* q, const float* src, const int* seg_start,
                       const int* seg_end, int n, int n_rows,
                       const int* bounds, const int* n_tiles,
                       const int* sorted_hash, int n_ctas, int tile,
                       const float* pvec, int kernel_set, float* out,
                       void* stream) {
  if (tile < 32 || tile > TILE_MAX || tile % 32) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEREUS_TILED(KS)                                                     \
  if (kernel_set == KS) {                                                    \
    tiled_pair_sweep_kernel<P, KS><<<n_ctas, tile, 0, st>>>(                 \
        q, src, seg_start, seg_end, n, n_rows, bounds, n_tiles, sorted_hash, \
        pvec, out);                                                          \
    return static_cast<int>(cudaGetLastError());                             \
  }
  NEREUS_TILED(MULLER)
  NEREUS_TILED(MONAGHAN)
#undef NEREUS_TILED
  return -1;
}

}  // namespace nereus_sweep

// The C entry point nereus_<NAME>_tiled_sweep of
// tiled_pair_sweep_kernel<PAIR>, for use inside an extern "C" block:
// launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success), or -1 for an unknown kernel set or tile size.
#define NEREUS_TILED_SWEEP(NAME, PAIR)                                       \
  int nereus_##NAME##_tiled_sweep(                                           \
      const float* q, const float* src, const int* seg_start,                \
      const int* seg_end, int n, int n_rows, const int* bounds,              \
      const int* n_tiles, const int* sorted_hash, int n_ctas, int tile,      \
      const float* pvec, int kernel_set, float* out, void* stream) {         \
    return nereus_sweep::launch_tiled_sweep<PAIR>(                          \
        q, src, seg_start, seg_end, n, n_rows, bounds, n_tiles, sorted_hash, \
        n_ctas, tile, pvec, kernel_set, out, stream);                        \
  }
