// Neighbor-sweep kernels of the WCSPH step, for Hopper (sm_90a).
//
// Replaces the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// (launched by neighbor_sweep) together with the three pair functions the
// WCSPH step runs through it, nereus_tpu/ops/pallas_sph.py::density_pair,
// fluid_force_pair and boundary_force_pair (reached through
// pallas_sph.py:1193 density_sweep and pallas_sph.py:1207
// fluid_force_sweep), and pallas_sph.py::boundary_force_sweep, the
// wall-only force (the functor WallForce<PRESSURE> of pair_sweep_kernel
// over the wall rows alone, the same wall formula as the fused force
// kernel's rows 9-17; the JAX package has no caller of it, the port's is
// ops/sph_pairs.py::boundary_force_sweep).
//
// What bounds the sweeps on this card. Each query walks 9 (18 with walls)
// short runs of 0-6 hash-sorted candidates; about 15 % of a 27-cell
// stencil's candidates lie inside the cutoff. One thread per query walking
// the runs in series (this file's earlier design) waits on latency: a
// run's bounds load only after the previous run ends, and a warp's lanes
// diverge on each run's trip count. The density pair is a few operations
// on one 16-byte row, so its sweep is latency-bound throughout; the force
// pair is ~60 operations with exact divisions, which a warp runs whenever
// any of its lanes has a candidate inside the cutoff, so its sweep is
// bound by instruction throughput as much as by latency (one division in
// the viscosity, not the plain version's two, measured 3-7 % faster at the
// chosen G).
//
// Design: the lane-group walk of group_sweep.cuh, G lanes per query
// (ops/cuda_sweep.py picks G per launch).
// - The group's lanes load all range rows' bounds at once, a shuffle scan
//   flattens the runs into one candidate list (a row table in shared
//   memory), and lane l walks flat indices l, l + G, ...
// - A candidate first loads its position and tests r^2 < h^2; the pair
//   math (the force's second float4 with it) runs only inside the cutoff.
// - Partial sums reduce over the group with __shfl_xor_sync in a fixed
//   tree (not the plain version's order). The density walks all rows as
//   one list; the force walks the fluid rows and the wall rows as two, so
//   a lane runs one pair formula per list.
// - G, measured (PERF.md section 6): at 2^18 queries 4 lanes per query fill
//   the card best for both sweeps; at 2^20 and more the density takes 2,
//   and the force 1 when the pair carries the viscosity (a lone lane per
//   query, its next candidate's row loaded before the current pair runs,
//   keeps 32 queries' divisions in a warp), else 2; a body shell's
//   psi-density, whose queries' ranges are nearly all empty, takes 2 over
//   a small shell and 4 over a large one. Only these instances are built.
//   Larger groups spend
//   more on the table and the shuffles than they hide; queueing the
//   inside-cutoff candidates of a warp into full batches of 32 (one lane
//   per pair) was 1.5-1.8x slower than the parent's kernel and is gone.
//
// Numerics: float32, no fast-math. r^2 is clamped to 1e-24 before the
// rsqrt, so every term except the density self term is exactly 0 at the
// self pair, and the Müller viscosity bracket (~1e36 at the clamp)
// multiplies r^2 before its ~1e4 constant (the other order is inf*0 =
// NaN). Divisions are exact. A pair outside the cutoff adds nothing (the
// earlier design added its terms times 0). FMA contraction, rsqrtf, the
// merged viscosity division and the order of summation change the last
// bits against the plain PyTorch version. The shared formulas live in
// sweep_common.cuh.
//
// The force kernel's PRESSURE switch (0 for the implicit solvers' advection
// forces, fluid_force_sweep(include_pressure=False)) drops the Tait term
// pd2_i + pd2_j of the fluid rows and the pressure term of the boundary
// rows; pd2_j is read from slot 7 of the source row, the same p/rho^2 the
// step computes for its queries. Its VISC switch (0 when the implicit
// viscosity solve owns viscosity, fluid_force_sweep(include_viscosity=
// False)) drops the Muller viscosity of the fluid rows and the friction of
// the boundary rows. Its MOVING switch (1 for a moving boundary,
// fluid_force_sweep(moving_boundary=True); the moving=True of
// pallas_sph.py::boundary_force_pair) makes the wall friction read the
// relative velocity (v_i - v_b) . r, the wall velocity taken from slots 3-5
// of the boundary source row; it is instantiated only with VISC = 1, since
// without friction no wall term reads a velocity.
//
// Layouts (all row-major float32, 16-byte aligned):
//   density query  (N, 4): x y z (slot 3 unread)
//   density source (M, 4): x y z psi (m for fluid, rho0*V_b for boundary
//                          rows); the fluid rows may be the query itself
//   force query    (N, 8): x y z vx vy vz rho pd2
//   force source   (M, 8): fluid rows as the query rows (rho_j, pd2_j);
//                          boundary rows x y z vbx vby vbz psi_b pad (the
//                          wall velocity, 0 for a static wall)
//   seg_start, seg_end (n_rows, N) int32
//   pvec: the PV_* vector of ops/sph_pairs.py

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// ---------------------------------------------------------------------------
// Density: rho_i = sum_j psi_j W(r_ij) over all rows, self term included
// ---------------------------------------------------------------------------

template <int KS, int G>
__global__ void __launch_bounds__(THREADS)
density_sweep_kernel(const float4* __restrict__ q,
                     const float4* __restrict__ src,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ seg_end, int n, int n_rows,
                     const float* __restrict__ pv, float* __restrict__ out) {
  constexpr int GROUPS = THREADS / G;
  __shared__ RowTable<2 * N_ROWS> rows[GROUPS];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int i = blockIdx.x * GROUPS + grp;
  const bool live = i < n;
  Params p;
  p.h2 = __ldg(pv + PV_H2);
  p.kpoly = __ldg(pv + PV_KPOLY);
  p.h = __ldg(pv + PV_H);
  p.sigma = 1.0f / (12.566370614359172f * p.h * p.h * p.h);
  const float4 qi = live ? __ldg(q + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  RowTable<2 * N_ROWS>& t = rows[grp];
  const int total = build_rows<G, 2 * N_ROWS>(t, i, live, n, 0, n_rows,
                                              seg_start, seg_end, lane);
  float acc = 0.0f;
  // a: x y z psi
  walk<G, false>(t, total, lane, src, 1, [&](int, float4 a, int) {
    const float dx = qi.x - a.x, dy = qi.y - a.y, dz = qi.z - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (r2 < p.h2) {
      if constexpr (KS == MULLER) {
        const float d = p.h2 - r2;
        acc += (d * d * d) * (a.w * p.kpoly);
      } else {
        float rl, invrl;
        rl_invrl(r2, rl, invrl);
        acc += a.w * w_value<KS>(r2, rl, p);
      }
    }
  });
  acc = group_sum<G>(acc);
  if (live && lane == 0) out[i] = acc;
}

// ---------------------------------------------------------------------------
// The wall pair of boundary_force_pair: Akinci adhesion beta psi W r, the
// friction nu max(v . r, 0) psi grad W (VISC; MOVING: (v_i - v_b) . r with
// the wall velocity in slots 3-5 of the source row) and the reference-scale
// pressure +m^2 psi pd2_i grad W (PRESSURE). One formula for the fused
// force kernel's wall rows and the wall-only WallForce functor.
// ---------------------------------------------------------------------------

// nu = 2 m^2 mu^2 h c_s / (1 + 0.01 h^2) / max(rho_i, 1e-12)^2
__device__ __forceinline__ float wall_nu(float dens_i, const Params& p) {
  const float di = fmaxf(dens_i, 1e-12f);
  return ((2.0f * p.pm * p.pm * p.visc * p.visc * p.h * p.cs) /
          (1.0f + 0.01f * p.h2)) /
         (di * di);
}

// c with the wall pair's force c * r, before the cutoff: a = x y z vbx and
// b = vby vbz psi pad of the wall row
template <int KS, int PRESSURE, int VISC, int MOVING>
__device__ __forceinline__ float wall_coef(float qvx, float qvy, float qvz,
                                          float pd2_i, float nu, float4 a,
                                          float4 b, float dx, float dy,
                                          float dz, float r2,
                                          const Params& p) {
  const float psi = b.z;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
  const float w = w_value<KS>(r2, rl, p);
  const float sd = grad_scale_default<KS>(r2, rl, invrl, p);
  float cfric = 0.0f;
  if constexpr (VISC != 0) {
    float vdotr;
    if constexpr (MOVING != 0) {
      vdotr = (qvx - a.w) * dx + (qvy - b.x) * dy + (qvz - b.y) * dz;
    } else {
      vdotr = qvx * dx + qvy * dy + qvz * dz;
    }
    cfric = nu * fmaxf(vdotr, 0.0f) * psi * sd;
  }
  const float cpb = p.pm * p.pm;
  return PRESSURE != 0 ? (p.beta * psi) * w + (cfric + cpb * psi * pd2_i * sd)
                       : (p.beta * psi) * w + cfric;
}

template <int KS, int PRESSURE, int VISC, int MOVING>
__device__ __forceinline__ void wall_pair(float qx, float qy, float qz,
                                          float qvx, float qvy, float qvz,
                                          float pd2_i, float nu,
                                          const float4* __restrict__ src,
                                          int j, const Params& p, float& fx,
                                          float& fy, float& fz) {
  const float4 a = __ldg(src + 2 * j);  // x y z vbx
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // vby vbz psi pad
  if constexpr (MOVING != 0) {
    b = __ldg(src + 2 * j + 1);
  } else {
    b.z = __ldg(reinterpret_cast<const float*>(src) + 8 * j + 6);
  }
  const float dx = qx - a.x, dy = qy - a.y, dz = qz - a.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float okf = r2 < p.h2 ? 1.0f : 0.0f;
  const float c = wall_coef<KS, PRESSURE, VISC, MOVING>(
                      qvx, qvy, qvz, pd2_i, nu, a, b, dx, dy, dz, r2, p) *
                  okf;
  fx += c * dx;
  fy += c * dy;
  fz += c * dz;
}

// ---------------------------------------------------------------------------
// The fluid pair, inside the cutoff: viscosity, surface tension, Tait
// pressure with pd2_j from slot 7 of the source row
// ---------------------------------------------------------------------------

template <int KS, int ST, int PRESSURE, int VISC>
__device__ __forceinline__ void fluid_pair(const float4& qa, const float4& qb,
                                           const float4& a, const float4& b,
                                           float dx, float dy, float dz,
                                           float r2, const Params& p,
                                           float& fx, float& fy, float& fz) {
  float rl, invrl;
  rl_invrl(r2, rl, invrl);
  float cpd = 0.0f;
  if constexpr (PRESSURE != 0) {
    cpd = (qb.w + b.w) * (-p.pm * p.pm) * grad_scale_press<KS>(rl, invrl, p);
  }
  if constexpr (ST == ST_BECKER) {
    cpd += fminf(w_value<KS>(r2, rl, p), p.wdiam) * (-p.kappa);
  } else if constexpr (ST == ST_AKINCI) {
    const float hr = fmaxf(p.h - rl, 0.0f);
    const float cube = hr * hr * hr * rl * rl * rl;
    float c = 0.0f;
    if (2.0f * rl > p.h && rl <= p.h) {
      c = p.ksurf1 * cube;
    } else if (rl > 1e-12f && 2.0f * rl <= p.h) {
      c = p.ksurf1 * (2.0f * cube - p.ksurf2);
    }
    const float kij = 2.0f * p.rd / (qb.z + fmaxf(b.z, 1e-12f));
    cpd += (-p.kappa * p.pm * p.pm) * kij * c * invrl;
  }
  if constexpr (VISC != 0) {
    // 2 m mu m (r . grad W_v) / (rho_j (r^2 + 0.01 h^2)): the plain
    // version's two divisions in one
    const float av = visc_rdotgrad<KS>(r2, rl, invrl, p);
    const float cvisc = ((2.0f * p.pm * p.visc * p.pm) * av) /
                        (fmaxf(b.z, 1e-12f) * (r2 + 0.01f * p.h2));
    fx += cvisc * (qa.w - a.w) + cpd * dx;
    fy += cvisc * (qb.x - b.x) + cpd * dy;
    fz += cvisc * (qb.y - b.y) + cpd * dz;
  } else {
    fx += cpd * dx;
    fy += cpd * dy;
    fz += cpd * dz;
  }
}

// ---------------------------------------------------------------------------
// Forces: fluid pairs on rows 0-8, wall pairs on rows 9-17, each walked as
// one list by the query's group
// ---------------------------------------------------------------------------

// The pair of each candidate inside the cutoff, evaluated by the lane that
// tested it; the G lanes' sums reduce over the group
template <int KS, int ST, int PRESSURE, int VISC, int MOVING, int G, bool PF>
__global__ void __launch_bounds__(THREADS)
force_sweep_kernel(const float4* __restrict__ q,
                   const float4* __restrict__ src,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ seg_end, int n, int n_rows,
                   const float* __restrict__ pv, float* __restrict__ out) {
  constexpr int GROUPS = THREADS / G;
  __shared__ RowTable<N_ROWS> rows[GROUPS];
  const int lane = threadIdx.x % G, grp = threadIdx.x / G;
  const int i = blockIdx.x * GROUPS + grp;
  const bool live = i < n;
  const Params p = load_params(pv);
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 qa = live ? __ldg(q + 2 * i) : zero4;      // x y z vx
  const float4 qb = live ? __ldg(q + 2 * i + 1) : zero4;  // vy vz rho pd2
  RowTable<N_ROWS>& t = rows[grp];
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;

  int total = build_rows<G, N_ROWS>(t, i, live, n, 0, min(n_rows, N_ROWS),
                                    seg_start, seg_end, lane);
  // a: x y z vx
  walk<G, PF>(t, total, lane, src, 2, [&](int j, float4 a, int) {
    const float dx = qa.x - a.x, dy = qa.y - a.y, dz = qa.z - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (r2 < p.h2) {
      const float4 b = __ldg(src + 2 * j + 1);  // vy vz rho pd2
      fluid_pair<KS, ST, PRESSURE, VISC>(qa, qb, a, b, dx, dy, dz, r2, p, fx,
                                         fy, fz);
    }
  });
  if (n_rows > N_ROWS) {
    __syncwarp();
    total = build_rows<G, N_ROWS>(t, i, live, n, N_ROWS, n_rows - N_ROWS,
                                  seg_start, seg_end, lane);
    const float nu = VISC != 0 ? wall_nu(qb.z, p) : 0.0f;
    // a: x y z vbx
    walk<G, PF>(t, total, lane, src, 2, [&](int j, float4 a, int) {
      const float dx = qa.x - a.x, dy = qa.y - a.y, dz = qa.z - a.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 < p.h2) {
        const float4 b = __ldg(src + 2 * j + 1);  // vby vbz psi pad
        const float c = wall_coef<KS, PRESSURE, VISC, MOVING>(
            qa.w, qb.x, qb.y, qb.w, nu, a, b, dx, dy, dz, r2, p);
        fx += c * dx;
        fy += c * dy;
        fz += c * dz;
      }
    });
  }
  fx = group_sum<G>(fx);
  fy = group_sum<G>(fy);
  fz = group_sum<G>(fz);
  if (live && lane == 0) {
    out[3 * i + 0] = fx;
    out[3 * i + 1] = fy;
    out[3 * i + 2] = fz;
  }
}

template <int KS, int G>
void launch_density(const float* q, const float* src, const int* s,
                    const int* e, int n, int n_rows, const float* pv,
                    float* out, cudaStream_t stream) {
  density_sweep_kernel<KS, G><<<group_blocks<G>(n), THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(src),
      s, e, n, n_rows, pv, out);
}

// a lone lane per query (G = 1) loads its next candidate's row ahead
template <int KS, int ST, int PRESSURE, int VISC, int MOVING, int G>
void launch_force(const float* q, const float* src, const int* s,
                  const int* e, int n, int n_rows, const float* pv,
                  float* out, cudaStream_t stream) {
  force_sweep_kernel<KS, ST, PRESSURE, VISC, MOVING, G, G == 1>
      <<<group_blocks<G>(n), THREADS, 0, stream>>>(
      reinterpret_cast<const float4*>(q), reinterpret_cast<const float4*>(src),
      s, e, n, n_rows, pv, out);
}

// ---------------------------------------------------------------------------
// The wall-only force (pallas_sph.py::boundary_force_sweep): the wall pair
// at the JAX defaults (static wall, adhesion, friction, reference-scale
// pressure when PRESSURE) over a (9, N) wall-range table and the wall
// source (M, 8) alone, as a functor of pair_sweep_kernel; nu once per
// query, in its prologue, as the fused kernel computes it
// ---------------------------------------------------------------------------

template <int PRESSURE>
struct WallForce {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  // rho_i (slot 6) is read only for nu: replace it by nu
  __device__ static void prologue(float (&q)[QW], const Params& p) {
    q[6] = wall_nu(q[6], p);
  }
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    wall_pair<KS, PRESSURE, 1, 0>(q[0], q[1], q[2], q[3], q[4], q[5], q[7],
                                  q[6], reinterpret_cast<const float4*>(src),
                                  j, p, acc[0], acc[1], acc[2]);
  }
};

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); an unknown switch value returns -1.
// `group` is the lanes per query G that ops/cuda_sweep.py picks, and only
// those instances are built: 2 or 4 for the density kernel; 1 or 4 for a
// force instance with viscosity, 2 or 4 for one without.

int nereus_density_sweep(const float* q, const float* src,
                         const int* seg_start, const int* seg_end, int n,
                         int n_rows, const float* pvec, int kernel_set,
                         int group, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEREUS_DENSITY(KS, G)                                               \
  if (kernel_set == KS && group == G) {                                     \
    launch_density<KS, G>(q, src, seg_start, seg_end, n, n_rows, pvec, out, \
                          st);                                              \
    return static_cast<int>(cudaGetLastError());                            \
  }
  NEREUS_DENSITY(MULLER, 2)
  NEREUS_DENSITY(MULLER, 4)
  NEREUS_DENSITY(MONAGHAN, 2)
  NEREUS_DENSITY(MONAGHAN, 4)
#undef NEREUS_DENSITY
  return -1;
}

int nereus_force_sweep(const float* q, const float* src, const int* seg_start,
                       const int* seg_end, int n, int n_rows,
                       const float* pvec, int kernel_set, int st_model,
                       int pressure, int visc, int moving, int group,
                       float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEREUS_FORCE(KS, ST, P, V, M, G)                                     \
  if (kernel_set == KS && st_model == ST && pressure == P && visc == V &&    \
      moving == M && group == G) {                                           \
    launch_force<KS, ST, P, V, M, G>(q, src, seg_start, seg_end, n, n_rows,  \
                                     pvec, out, st);                         \
    return static_cast<int>(cudaGetLastError());                             \
  }
#define NEREUS_FORCE_G(KS, ST, P, V, M)       \
  NEREUS_FORCE(KS, ST, P, V, M, (V ? 1 : 2)) \
  NEREUS_FORCE(KS, ST, P, V, M, 4)
#define NEREUS_FORCE_ST(KS, P, V, M)   \
  NEREUS_FORCE_G(KS, ST_NONE, P, V, M) \
  NEREUS_FORCE_G(KS, ST_BECKER, P, V, M) \
  NEREUS_FORCE_G(KS, ST_AKINCI, P, V, M)
  NEREUS_FORCE_ST(MULLER, 1, 1, 0)
  NEREUS_FORCE_ST(MONAGHAN, 1, 1, 0)
  NEREUS_FORCE_ST(MULLER, 0, 1, 0)
  NEREUS_FORCE_ST(MONAGHAN, 0, 1, 0)
  NEREUS_FORCE_ST(MULLER, 1, 0, 0)
  NEREUS_FORCE_ST(MONAGHAN, 1, 0, 0)
  NEREUS_FORCE_ST(MULLER, 0, 0, 0)
  NEREUS_FORCE_ST(MONAGHAN, 0, 0, 0)
  NEREUS_FORCE_ST(MULLER, 1, 1, 1)
  NEREUS_FORCE_ST(MONAGHAN, 1, 1, 1)
  NEREUS_FORCE_ST(MULLER, 0, 1, 1)
  NEREUS_FORCE_ST(MONAGHAN, 0, 1, 1)
#undef NEREUS_FORCE_ST
#undef NEREUS_FORCE_G
#undef NEREUS_FORCE
  return -1;
}

// pair_sweep_kernel<WallForce<include_pressure>> on `stream`: q (N, 8)
// x y z vx vy vz rho pd2, src (M, 8) the wall rows x y z 0 0 0 psi_b pad,
// ranges (9, N) into src, out (N, 3); returns cudaGetLastError() (0 on
// success), or -1 for an unknown kernel set or a switch other than 0, 1.
int nereus_wall_force_sweep(const float* q, const float* src,
                            const int* seg_start, const int* seg_end, int n,
                            int n_rows, const float* pvec, int kernel_set,
                            int include_pressure, float* out, void* stream) {
  if (include_pressure == 1) {
    return launch_pair_sweep<WallForce<1>>(q, src, seg_start, seg_end, n,
                                           n_rows, pvec, kernel_set, out,
                                           stream);
  }
  if (include_pressure == 0) {
    return launch_pair_sweep<WallForce<0>>(q, src, seg_start, seg_end, n,
                                           n_rows, pvec, kernel_set, out,
                                           stream);
  }
  return -1;
}

// An empty kernel on `stream`: the floor under a launch, timed beside the
// sweeps. Returns cudaGetLastError().
int nereus_empty_kernel(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* nereus_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
