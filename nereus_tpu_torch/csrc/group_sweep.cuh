// The lane-group walk of the neighbor sweeps, for Hopper (sm_90a): its
// pieces (the row table of a query's flattened runs, the shuffle scan that
// builds it, the walk, the group's fixed-order sum), used by the density
// and force kernels of sph_sweep.cu, and the engine they make for pair
// functors, group_pair_sweep_kernel<P, KS, G>, with its list form.
//
// The engine replaces the TPU kernel
// nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel as
// nereus_tpu/ops/pallas_sph.py::generic_sweep launches it, for the pair
// functions whose functors it runs (iisph_sweep.cu: sum_dij_pair,
// jacobi_fluid_pair + jacobi_boundary_pair; pbf_sweep.cu: pbf_lambda_pair,
// pbf_dp_pair, pbf_omega_pair; dfsph_sweep.cu: drho_pair;
// multiphase_sweep.cu: multiphase_force_pair + multiphase_boundary_pair,
// xsph_pair;
// dfsph_multiphase_sweep.cu: multiphase_drho_pair + _bpair, and
// multiphase_kappa_bpair over a body shell; iisph_sweep.cu's
// BodyPressureForce: grad_pressure_force_pair(boundary=True,
// boundary_sign=-1) over a body shell, forward and reverse;
// dfsph_sweep.cu's DrhoShell: drho_pair over a body shell, and
// ShellDensityAlpha: density_pair and alpha_pair over a body shell). Its
// list form, group_list_sweep_kernel<P, KS, G>, walks a static pair list
// instead of the ranges: the elastic solid's reference
// pairs (elastic_sweep.cu, elastic_f_pair and elastic_force_pair +
// elastic_hourglass_pair as nereus_tpu/solvers/elastic_pallas.py::_sweep
// launches them).
//
// What bounds a range-walk sweep on this card. Each query walks 9 (18 with
// walls) short runs of 0-6 hash-sorted candidates; about 15 % of a 27-cell
// stencil's candidates lie inside the cutoff. One thread per query walking
// the runs in series (sweep_common.cuh's pair_sweep_kernel) waits on
// latency: a run's bounds load only after the previous run ends, a warp's
// lanes diverge on each run's trip count, and every candidate loads its
// whole source row and runs the pair math, multiplied by 0 outside the
// cutoff.
//
// Design: a group of G lanes per query (ops/cuda_sweep.py picks G per
// launch; only the G it can pick are built).
// - Lane r of the group loads the bounds of rows r, r + G, ..., so all
//   rows' bounds are in flight at once. A prefix sum over the group by
//   shuffles flattens the runs into one candidate list, kept as a row table
//   in shared memory (first flat index and source offset of each row);
//   empty runs add nothing. The group walks the list G candidates at a
//   time, lane l taking flat indices l, l + G, ...: neighbouring lanes read
//   neighbouring source rows, and no lane waits on another's run lengths.
//   A lone lane (G 1) loads the next candidate's row ahead.
// - A candidate first loads the first float4 of its source row (x y z and
//   one value) and tests r^2 < h^2. The pair runs only inside the cutoff,
//   and loads any further float4 of the row only there.
// - The engine walks the fluid rows (0-8) and the wall rows (9-17) as one
//   list, the pair's formula chosen by the candidate's row: one scan, all
//   18 rows' bounds in flight at once. Measured on Jacobi at 1,092,727
//   queries (PERF.md section 6): one list at G 4 took 6 % less time than
//   two lists, one per formula, at G 2 (the best G of two lists); one
//   list at G 2 and G 8, and any G with the next candidate's row loaded
//   ahead, took more.
// - Partial sums reduce over the group with __shfl_xor_sync in a fixed
//   tree: no atomics, the same order on every run (not the plain
//   version's order).
//
// Functors: pair_sweep_kernel's interface (QW, SW, OW, BOUNDARY_ROWS,
// template <int KS, bool B> pair, an optional prologue), for a pair that
// adds nothing outside the cutoff, with the pair handed the first float4
// of the candidate's row that the engine loaded: pair(q, a, src, j,
// params, acc). A pair_sweep_kernel functor moves here with one
// NEREUS_GROUP_SWEEP line and its first load replaced by `a`. A functor
// may define OUTW and epilogue(q, acc, params, o): lane 0 turns the
// group's sums and the query row into OUTW values, written as (OUTW, N)
// planes (PbfLambda's rho and lambda; MultiphaseDrho's one (N,) rate, its
// wall sum scaled by the query's s_i / m_i), where a functor without one
// writes its sums as (N, OW) rows.
// MaskedForm<P> runs such a functor on pair_sweep_kernel (one thread per
// query; the pair on every candidate, masked): a body shell's multiphase
// Drho, whose queries are nearly all without candidates.
// GroupBoundaryForm<P> runs its wall formula over a body shell's 9 rows on
// the engine (the lane-group counterpart of sweep_common.cuh's
// BoundaryForm): a body shell's multiphase kappa.
//
// Over a body shell (the DFSPH couplings' kappa impulse, Drho, the
// shell's psi-density with alpha's sums and the multiphase kappa, the
// fluid rows as queries) nearly every query's runs are empty, and the
// row scan of an empty query is most of the work: a small shell takes G 2
// and a large one G 8 (ops/cuda_sweep.py::shell_group; measured against
// one thread per query with its 9 bounds loaded at once, PERF.md section
// 6).
//
// The list form. A sweep whose pairs never change (an elastic body's
// neighbors in its reference positions X) walks a list built once, when
// the body is made: query i's sources nbr[nbr_start[i]] ..
// nbr[nbr_start[i + 1] - 1], each a pair inside the cutoff (self pair
// included). The group's lanes take neighbouring list entries (one 4-byte
// index load each, coalesced over the group), so there are no range rows,
// no row table and no cutoff test: on the 80^3 body at spacing h/2 a
// query's 9 runs hold ~216 candidates of which ~29 lie inside h, and the
// range walk tests the other ~85 % on every step. The list is built in
// torch (ops/neighbors.py::cutoff_list) and the range walk tests r^2 in
// the kernel, whose contracted multiply-adds may round a pair at the very
// edge of h the other way; the spiky gradient is ~0 there.
//
// Numerics: float32, no fast-math; the functors keep the r^2 clamp before
// rsqrtf (sweep_common.cuh).

#pragma once

#include "sweep_common.cuh"

namespace nereus_sweep {

constexpr unsigned FULL = 0xffffffffu;

// A group's candidate list in shared memory: row r's candidates are the flat
// indices pre[r] .. pre[r + 1] - 1 (pre[nr] the total), candidate k of row r
// the source row k + delta[r].
template <int NR>
struct RowTable {
  int pre[NR + 1];
  int delta[NR];
};

// Loads the bounds of rows [row0, row0 + nr) of query i (none when !live),
// lane `lane` of the G taking rows lane, lane + G, ..., scans their lengths
// over the group by shuffles and writes the group's table; returns the
// number of candidates. Every lane of the warp calls it.
template <int G, int NR>
__device__ __forceinline__ int build_rows(RowTable<NR>& t, int i, bool live,
                                          int n, int row0, int nr,
                                          const int* __restrict__ seg_start,
                                          const int* __restrict__ seg_end,
                                          int lane) {
  int s[(NR + G - 1) / G], len[(NR + G - 1) / G];
#pragma unroll
  for (int k = 0; k < (NR + G - 1) / G; ++k) {
    const int r = k * G + lane;
    s[k] = 0;
    len[k] = 0;
    if (live && r < nr) {
      const size_t at = static_cast<size_t>(row0 + r) * n + i;
      s[k] = __ldg(seg_start + at);
      len[k] = max(__ldg(seg_end + at) - s[k], 0);
    }
  }
  int off = 0;
#pragma unroll
  for (int k = 0; k < (NR + G - 1) / G; ++k) {
    int inc = len[k];
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int up = __shfl_up_sync(FULL, inc, d, G);
      if (lane >= d) inc += up;
    }
    const int r = k * G + lane;
    if (r < nr) {
      const int first = off + inc - len[k];
      t.pre[r] = first;
      t.delta[r] = s[k] - first;
    }
    off += __shfl_sync(FULL, inc, G - 1, G);
  }
  if (lane == 0) t.pre[nr] = off;
  __syncwarp();
  return off;
}

// The source row of flat candidate k, for a lane whose k only grows: `r`
// and `next` (pre[r + 1]) carry the lane's row from one call to the next.
template <int NR>
__device__ __forceinline__ int source_of(const RowTable<NR>& t, int k, int& r,
                                         int& next) {
  while (k >= next) next = t.pre[++r + 1];
  return k + t.delta[r];
}

// The sum of v over the G lanes of each group, in a fixed tree; every lane
// of the group gets it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int d = G / 2; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d, G);
  return v;
}

// Calls body(j, a, r) for each candidate of the group's list that falls to
// lane `lane` (flat indices lane, lane + G, ...), a = src[stride * j] the
// first float4 of its source row and r its range row; with PF the next
// candidate's row is loaded before body runs on this one.
template <int G, bool PF, int NR, typename Body>
__device__ __forceinline__ void walk(const RowTable<NR>& t, int total,
                                     int lane,
                                     const float4* __restrict__ src,
                                     int stride, Body&& body) {
  int r = 0, next = t.pre[1];
  if constexpr (PF) {
    int k = lane;
    if (k >= total) return;
    int j = source_of(t, k, r, next);
    float4 a = __ldg(src + stride * j);
    for (;;) {
      const int kn = k + G, rk = r;
      const bool more = kn < total;
      int jn = j;
      float4 an = a;
      if (more) {
        jn = source_of(t, kn, r, next);
        an = __ldg(src + stride * jn);
      }
      body(j, a, rk);
      if (!more) break;
      k = kn;
      j = jn;
      a = an;
    }
  } else {
    for (int k = lane; k < total; k += G) {
      const int j = source_of(t, k, r, next);
      body(j, __ldg(src + stride * j), r);
    }
  }
}

// blocks of THREADS lanes, THREADS / G queries each
template <int G>
inline int group_blocks(int n) {
  constexpr int per = THREADS / G;
  return (n + per - 1) / per;
}

// ---------------------------------------------------------------------------
// The engine for pair functors
// ---------------------------------------------------------------------------

template <class P, class = void>
struct HasEpilogue : std::false_type {};
template <class P>
struct HasEpilogue<P, std::void_t<decltype(&P::epilogue)>>
    : std::true_type {};

// The range walk of a pair functor P by groups of G lanes per query: rows
// 0-8 and (BOUNDARY_ROWS, 18 range rows) rows 9-17 as one list, each
// candidate inside the cutoff taking the fluid formula on rows 0-8 and the
// wall formula on rows 9-17; out (N, OW), or (OUTW, N) planes from P's
// epilogue.
template <class P, int KS, int G>
__global__ void __launch_bounds__(THREADS)
group_pair_sweep_kernel(const float* __restrict__ q,
                        const float* __restrict__ src,
                        const int* __restrict__ seg_start,
                        const int* __restrict__ seg_end, int n, int n_rows,
                        const float* __restrict__ pv,
                        float* __restrict__ out) {
  constexpr int GROUPS = THREADS / G;
  constexpr int NR = P::BOUNDARY_ROWS ? 2 * N_ROWS : N_ROWS;
  __shared__ RowTable<NR> rows[GROUPS];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int i = blockIdx.x * GROUPS + grp;
  const bool live = i < n;
  const Params p = load_params(pv);
  float qv[P::QW];
  if (live) {
    load_row<P::QW>(q, i, qv);
  } else {
#pragma unroll
    for (int k = 0; k < P::QW; ++k) qv[k] = 0.0f;
  }
  if constexpr (HasPrologue<P>::value) P::prologue(qv, p);
  float acc[P::OW];
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = 0.0f;
  RowTable<NR>& t = rows[grp];
  const int total = build_rows<G, NR>(t, i, live, n, 0, min(n_rows, NR),
                                      seg_start, seg_end, lane);
  walk<G, G == 1>(t, total, lane, reinterpret_cast<const float4*>(src),
                  P::SW / 4, [&](int j, float4 a, int r) {
    const float dx = qv[0] - a.x, dy = qv[1] - a.y, dz = qv[2] - a.z;
    if (dx * dx + dy * dy + dz * dz < p.h2) {
      if (!P::BOUNDARY_ROWS || r < N_ROWS) {
        P::template pair<KS, false>(qv, a, src, j, p, acc);
      } else {
        P::template pair<KS, true>(qv, a, src, j, p, acc);
      }
    }
  });
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = group_sum<G>(acc[k]);
  if (live && lane == 0) {
    if constexpr (HasEpilogue<P>::value) {
      float o[P::OUTW];
      P::epilogue(qv, acc, p, o);
#pragma unroll
      for (int k = 0; k < P::OUTW; ++k) {
        out[static_cast<size_t>(k) * n + i] = o[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < P::OW; ++k) {
        out[static_cast<size_t>(i) * P::OW + k] = acc[k];
      }
    }
  }
}

// The pair_sweep_kernel form of a lane-group functor P (without a
// prologue; its OW sums, any epilogue left out) that adds nothing outside
// the cutoff: P's pair on every candidate, each of its sums multiplied by
// the cutoff mask, with no branch. A shell's few busy queries then run in
// step: measured on the DFSPH couplings' shell Drho, the cutoff test as a
// branch took 4-7 % more time (PERF.md section 6).
template <class P>
struct MaskedForm {
  static constexpr int QW = P::QW, SW = P::SW, OW = P::OW;
  static constexpr bool BOUNDARY_ROWS = P::BOUNDARY_ROWS;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const float dx = q[0] - a.x, dy = q[1] - a.y, dz = q[2] - a.z;
    const float okf = dx * dx + dy * dy + dz * dz < p.h2 ? 1.0f : 0.0f;
    float t[OW] = {};
    P::template pair<KS, B>(q, a, src, j, p, t);
#pragma unroll
    for (int k = 0; k < OW; ++k) acc[k] += t[k] * okf;
  }
};

// The boundary form of a lane-group functor P over a body shell's 9 range
// rows (the fluid rows as queries): P's widths and its B = true formula,
// run inside the cutoff with the engine's `a`, on rows 0-8 alone. The
// lane-group counterpart of sweep_common.cuh's BoundaryForm; P's epilogue,
// if any, is left out (the sums are written as (N, OW) rows).
template <class P>
struct GroupBoundaryForm {
  static constexpr int QW = P::QW, SW = P::SW, OW = P::OW;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    P::template pair<KS, true>(q, a, src, j, p, acc);
  }
};

// Launches group_pair_sweep_kernel<P, kernel_set, G> on `st`; returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set.
template <class P, int G>
int launch_group_at(const float* q, const float* src, const int* seg_start,
                    const int* seg_end, int n, int n_rows, const float* pvec,
                    int kernel_set, float* out, cudaStream_t st) {
#define NEREUS_GROUP(KS)                                                     \
  if (kernel_set == KS) {                                                    \
    group_pair_sweep_kernel<P, KS, G>                                        \
        <<<group_blocks<G>(n), THREADS, 0, st>>>(q, src, seg_start, seg_end, \
                                                 n, n_rows, pvec, out);      \
    return static_cast<int>(cudaGetLastError());                             \
  }
  NEREUS_GROUP(MULLER)
  NEREUS_GROUP(MONAGHAN)
#undef NEREUS_GROUP
  return -1;
}

// Launches group_pair_sweep_kernel<P, kernel_set, group> on `stream`, the
// group one of the lane counts Gs that ops/cuda_sweep.py can pick for P;
// returns cudaGetLastError() (0 on success), or -1 for an unknown kernel
// set or another group.
template <class P, int... Gs>
int launch_group_sweep(const float* q, const float* src, const int* seg_start,
                       const int* seg_end, int n, int n_rows,
                       const float* pvec, int kernel_set, int group,
                       float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  ((group == Gs ? (rc = launch_group_at<P, Gs>(q, src, seg_start, seg_end, n,
                                               n_rows, pvec, kernel_set, out,
                                               st),
                   true)
                : false) ||
   ...);
  return rc;
}

// ---------------------------------------------------------------------------
// The list form: a static pair list
// ---------------------------------------------------------------------------

// The walk of a static pair list by groups of G lanes per query: query i's
// sources are nbr[nbr_start[i]] .. nbr[nbr_start[i + 1] - 1], every one a
// pair P takes (the list holds the pairs inside the cutoff and no other,
// so there is no test), lane l taking list entries l, l + G, ...; P's
// fluid formula (B = false), sums reduced over the group in a fixed tree,
// out (N, OW).
template <class P, int KS, int G>
__global__ void __launch_bounds__(THREADS)
group_list_sweep_kernel(const float* __restrict__ q,
                        const float* __restrict__ src,
                        const int* __restrict__ nbr_start,
                        const int* __restrict__ nbr, int n,
                        const float* __restrict__ pv,
                        float* __restrict__ out) {
  constexpr int GROUPS = THREADS / G;
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int i = blockIdx.x * GROUPS + grp;
  const bool live = i < n;
  const Params p = load_params(pv);
  float qv[P::QW];
  float acc[P::OW];
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = 0.0f;
  if (live) {
    load_row<P::QW>(q, i, qv);
    const int e = __ldg(nbr_start + i + 1);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int k = __ldg(nbr_start + i) + lane; k < e; k += G) {
      const int j = __ldg(nbr + k);
      P::template pair<KS, false>(
          qv, __ldg(s4 + static_cast<size_t>(j) * (P::SW / 4)), src, j, p,
          acc);
    }
  }
#pragma unroll
  for (int k = 0; k < P::OW; ++k) acc[k] = group_sum<G>(acc[k]);
  if (live && lane == 0) {
#pragma unroll
    for (int k = 0; k < P::OW; ++k) {
      out[static_cast<size_t>(i) * P::OW + k] = acc[k];
    }
  }
}

// Launches group_list_sweep_kernel<P, kernel_set, G> on `st`; returns
// cudaGetLastError() (0 on success), or -1 for an unknown kernel set.
template <class P, int G>
int launch_list_at(const float* q, const float* src, const int* nbr_start,
                   const int* nbr, int n, const float* pvec, int kernel_set,
                   float* out, cudaStream_t st) {
#define NEREUS_LIST(KS)                                                      \
  if (kernel_set == KS) {                                                    \
    group_list_sweep_kernel<P, KS, G>                                        \
        <<<group_blocks<G>(n), THREADS, 0, st>>>(q, src, nbr_start, nbr, n,  \
                                                 pvec, out);                 \
    return static_cast<int>(cudaGetLastError());                             \
  }
  NEREUS_LIST(MULLER)
  NEREUS_LIST(MONAGHAN)
#undef NEREUS_LIST
  return -1;
}

// Launches group_list_sweep_kernel<P, kernel_set, group> on `stream`, the
// group one of the lane counts Gs that ops/cuda_sweep.py can pick for P;
// returns cudaGetLastError() (0 on success), or -1 for an unknown kernel
// set or another group.
template <class P, int... Gs>
int launch_list_sweep(const float* q, const float* src, const int* nbr_start,
                      const int* nbr, int n, const float* pvec,
                      int kernel_set, int group, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = -1;
  ((group == Gs ? (rc = launch_list_at<P, Gs>(q, src, nbr_start, nbr, n,
                                              pvec, kernel_set, out, st),
                   true)
                : false) ||
   ...);
  return rc;
}

}  // namespace nereus_sweep

// The C entry point nereus_<NAME>_list_sweep of
// group_list_sweep_kernel<PAIR>, for use inside an extern "C" block, built
// for the lane counts given after PAIR (those its wrapper can pick):
// launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success), or -1 for an unknown kernel set or another group.
#define NEREUS_LIST_SWEEP(NAME, PAIR, ...)                                   \
  int nereus_##NAME##_list_sweep(const float* q, const float* src,          \
                                 const int* nbr_start, const int* nbr,      \
                                 int n, const float* pvec, int kernel_set,  \
                                 int group, float* out, void* stream) {     \
    return nereus_sweep::launch_list_sweep<PAIR, __VA_ARGS__>(              \
        q, src, nbr_start, nbr, n, pvec, kernel_set, group, out, stream);   \
  }

// The C entry point nereus_<NAME>_sweep of group_pair_sweep_kernel<PAIR>,
// for use inside an extern "C" block, built for the lane counts given
// after PAIR (those its wrapper can pick): launches one kernel on `stream`
// and returns cudaGetLastError() (0 on success), or -1 for an unknown
// kernel set or another group.
#define NEREUS_GROUP_SWEEP(NAME, PAIR, ...)                                  \
  int nereus_##NAME##_sweep(const float* q, const float* src,               \
                            const int* seg_start, const int* seg_end, int n, \
                            int n_rows, const float* pvec, int kernel_set,   \
                            int group, float* out, void* stream) {           \
    return nereus_sweep::launch_group_sweep<PAIR, __VA_ARGS__>(             \
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, group, out, \
        stream);                                                             \
  }
