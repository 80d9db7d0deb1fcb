// Pair functions of the multiphase WCSPH step and of XSPH, for Hopper
// (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the pair
// functions of pallas_sph.py that solvers/wcsph_pallas.py runs:
// multiphase_density_pair / multiphase_density_bpair and
// multiphase_force_pair / multiphase_boundary_pair
// (_wcsph_pallas_multiphase; multiphase_boundary_pair's moving=True is the
// MOVING instance, whose wall friction reads (v_i - v_b) . r with the wall
// velocity in slots 3-5 of the boundary source row), and xsph_pair
// (wcsph_step_pallas with xsph_eps).
//
// Design. Every functor runs on the lane-group engine
// group_pair_sweep_kernel<Pair, KS, G> of group_sweep.cuh (G lanes per
// hash-sorted query walk its exact neighbor ranges as one flattened list),
// in the operation order of nereus_tpu_torch/ops/sph_pairs.py. The self
// pair stays in the ranges: it gives the number density its W(0), and every
// force and XSPH term is exactly 0 there (r^2 is clamped before the rsqrt,
// so the gradients are finite and multiply r = 0; dv = 0; Becker's r is
// 0). The viscosity bracket multiplies r^2 before its kernel constant
// (visc_rdotgrad) and the viscosity denominator divides exactly. The
// same-phase test of Becker cohesion is an exact float compare of the
// query's and the source's copy of one rho0 column (slot 8 of the same
// matrix).
//
// The number density (once per step on every multiphase path) is
// group_pair_sweep_kernel<MultiphaseDensity, KS, G>. What held it back on
// pair_sweep_kernel: one thread per query walking 18 runs in series, and
// every candidate loading its 16-byte row and evaluating W, multiplied by 0
// outside the cutoff (~85 % of the candidates). What the design does: G
// lanes per query walk the flattened fluid and wall runs as one list; a
// candidate's one float4 (x y z psi_b) is the engine's own load, and W runs
// only inside the cutoff. Its operands are one (C [+ Mb], 4) matrix whose
// first C rows are the queries: on the multiphase WCSPH paths the fluid rows
// x y z 0 stacked in place, then the walls
// (solvers/wcsph_cuda.py::multiphase_density_operands); on the multiphase
// DFSPH paths the multiphase alpha's own x y z 1/m matrix
// (solvers/dfsph_cuda.py::multiphase_alpha_operands), whose fluid rows' slot
// 3 this pair never reads. G: the density kernel's,
// ops/cuda_sweep.py::density_group (only those instances are built).
// Measured (PERF.md section 6): at the 262,144-query multiphase DFSPH block
// 9 % under the one-thread walk; at multiphase_1M's 1,092,727 queries level
// with it, and 10 % under it with the operands built (one matrix stacked in
// place, where the walk's query was stacked and then copied again behind the
// walls).
//
// The force (once per step on every multiphase path) is
// group_pair_sweep_kernel<MultiphaseForce, KS, G>. What held it back on
// pair_sweep_kernel: one thread per query walking 18 runs in series, and
// every candidate loading two or three float4s of its 48-byte row and
// running the heaviest pair of the port (72 operations on a fluid row with
// an exact division, 48-51 on a wall row), multiplied by 0 outside the
// cutoff (~85 % of the candidates). What the design does: G lanes per query
// walk the flattened fluid and wall runs as one list; a candidate loads x y
// z vx, tests the cutoff, and only inside it loads vy vz V pV^2 (wall: vb_y
// vb_z psi_b) and, for a fluid pair under Becker cohesion, rho0_j. Its
// operands are one (C + Mb, 12) matrix whose first C rows are the queries
// (solvers/wcsph_cuda.py::multiphase_force_args), so a step writes the
// positions and velocities once. G: ops/cuda_sweep.py::mp_force_group (only
// those instances are built).
//
// XSPH (once per step with xsph_eps, on the WCSPH and PBF paths) is
// group_pair_sweep_kernel<Xsph, KS, G>, over the 9 fluid rows. As one thread
// per query it walked the runs in series and loaded both float4s of every
// candidate's 32-byte row, evaluating W on all of them (~85 % outside the
// cutoff, multiplied by 0) and skipping only the exact division there. Now a
// candidate loads x y z vx and tests the cutoff; vy vz rho_j, W and the
// exact division run only inside it. Its operands are one (C, 8) matrix
// built through planes (solvers/wcsph_cuda.py::xsph_operands), the queries
// and the source. G: ops/cuda_sweep.py::XSPH_G (the one instance built).
//
// Bound: memory traffic (sweep_common.cuh). The multiphase density sweep
// reads 16-byte rows (position and psi_b only), the XSPH sweep 32-byte
// rows.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   multiphase density: src (C + Mb, 4) fluid rows x y z s (s not read:
//       0, or 1/m on the DFSPH paths), then the boundary rows x y z psi_b;
//       q its first C rows; out (N, 2) sum W (fluid rows), sum psi_b W
//       (boundary rows)
//   multiphase force: src (C + Mb, 12), fluid rows x y z vx | vy vz V p V^2
//       | rho0 1/m m 1/rho~ (V = 1/delta, p V^2 0 for DFSPH's non-pressure
//       forces, rho0 read only under Becker cohesion), then the boundary
//       rows x y z vb_x | vb_y vb_z psi_b 0 | 0 0 0 0 (the wall velocity 0
//       for a static wall); q its first C rows (every slot read but 6);
//       out (N, 3) acceleration
//   xsph: q = src (C, 8) x y z vx vy vz rho 0, fluid rows only (9 range
//       rows); out (N, 3), scaled by eps outside

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// (dx, dy, dz, r^2, W, okf) of a pair; the rsqrt only for Monaghan
struct WGeom {
  float dx, dy, dz, r2, w, okf;
};

template <int KS>
__device__ __forceinline__ WGeom w_geom(const float* q, float4 a,
                                        const Params& p) {
  WGeom g;
  g.dx = q[0] - a.x;
  g.dy = q[1] - a.y;
  g.dz = q[2] - a.z;
  g.r2 = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(g.r2, rl, invrl);
  g.w = w_value<KS>(g.r2, rl, p);
  g.okf = g.r2 < p.h2 ? 1.0f : 0.0f;
  return g;
}

// number density sum W (fluid rows, column 0) and sum psi_b W (boundary
// rows, column 1, rescaled per query phase by the caller); the engine calls
// it inside the cutoff with a = x y z psi_b of row j (a fluid row's slot 3
// is not read). W keeps w_value's operation order, so delta is the plain
// version's function, its products that feed a sum explicit intrinsics
// (mp_geom and mp_density_add of sweep_common.cuh), so that multiphase
// DFSPH's density and alpha-hat kernel adds the same bits.
struct MultiphaseDensity {
  static constexpr int QW = 4, SW = 4, OW = 2;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a, const float*,
                              int, const Params& p, float (&acc)[OW]) {
    mp_density_add<B>(mp_geom<KS>(q, a, p), a, acc[0], acc[1]);
  }
};

// acceleration in the adapted-density volume form; BECKER adds phase-pair
// cohesion. Boundary rows: wall penalty and friction, no pressure term;
// MOVING makes the friction read the wall velocity. The engine calls it
// inside the cutoff (okf = 1), with a = x y z vx of row j.
template <bool BECKER, bool MOVING>
struct MultiphaseForce {
  static constexpr int QW = 12, SW = 12, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  // query slots: 1/m_i, m_i, 1/rho~_i, p_i V_i^2, rho0_i
  static constexpr int INV_M = 9, MASS = 10, INV_RHO = 11, PV2 = 7, RHO0 = 8;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz V_j pV2_j (psi_b 0)
    const float dx = q[0] - a.x, dy = q[1] - a.y, dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if constexpr (B) {
      float rl = 0.0f, invrl = 0.0f;
      if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
      const float psi = b.z;
      const float inv_rho = q[INV_RHO];
      const float w = w_value<KS>(r2, rl, p);
      const float sd = grad_scale_default<KS>(r2, rl, invrl, p);
      const float cadh = (p.beta * psi) * q[INV_M] * w;
      const float nu = ((2.0f * p.visc * p.visc * p.h * p.cs) /
                        (1.0f + 0.01f * p.h2)) *
                       q[MASS] * (inv_rho * inv_rho);
      float vdotr;
      if constexpr (MOVING) {
        vdotr = (q[3] - a.w) * dx + (q[4] - b.x) * dy + (q[5] - b.y) * dz;
      } else {
        vdotr = q[3] * dx + q[4] * dy + q[5] * dz;
      }
      const float cfric = nu * fmaxf(vdotr, 0.0f) * psi * sd;
      const float c = cadh + cfric;
      acc[0] += c * dx;
      acc[1] += c * dy;
      acc[2] += c * dz;
    } else {
      float rl, invrl;
      rl_invrl(r2, rl, invrl);
      const float av = visc_rdotgrad<KS>(r2, rl, invrl, p);
      const float bden = r2 + 0.01f * p.h2;
      const float cvisc = (2.0f * p.visc) * b.z * (av * (1.0f / bden));
      const float sp = grad_scale_press<KS>(rl, invrl, p);
      float cp = -q[INV_M] * (q[PV2] + b.w) * sp;
      if constexpr (BECKER) {
        const float w_eff = fminf(w_value<KS>(r2, rl, p), p.wdiam);
        const float rho0_j = src_f4(src, SW, j, 2).x;
        const float same = q[RHO0] == rho0_j ? 1.0f : 0.0f;
        const float keff = p.kappa * (same + (1.0f - same) * p.stx);
        cp = cp - (keff * q[INV_M]) * w_eff;
      }
      acc[0] += cvisc * (q[3] - a.w) + cp * dx;
      acc[1] += cvisc * (q[4] - b.x) + cp * dy;
      acc[2] += cvisc * (q[5] - b.y) + cp * dz;
    }
  }
};

// sum 2m / max(rho_i + rho_j, eps) (v_j - v_i) W over the fluid rows, on
// one (C, 8) matrix x y z vx | vy vz rho 0, the queries and the source. The
// engine calls it inside the cutoff with a = x y z vx of row j; vy vz rho_j
// load only there, and the division is exact (no okf select: every pair it
// sees is inside)
struct Xsph {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz rho_j 0
    const WGeom g = w_geom<KS>(q, a, p);
    const float c = (2.0f * p.pm) * g.w / fmaxf(q[6] + b.z, 1e-12f);
    acc[0] += c * (a.w - q[3]);
    acc[1] += c * (b.x - q[4]);
    acc[2] += c * (b.y - q[5]);
  }
};

}  // namespace

extern "C" {

// the G of ops/cuda_sweep.py::density_group
NEREUS_GROUP_SWEEP(multiphase_density, MultiphaseDensity, 2, 4)
// the G of ops/cuda_sweep.py (XSPH_G)
NEREUS_GROUP_SWEEP(xsph, Xsph, 2)

// group_pair_sweep_kernel<MultiphaseForce<st_model == BECKER, moving>> at
// lane-group size `group` (the G of ops/cuda_sweep.py::mp_force_group) on
// `stream`; returns cudaGetLastError() (0 on success), or -1 for an unknown
// kernel set, a surface-tension model other than NONE and BECKER, a moving
// switch other than 0 and 1, or another group.
int nereus_multiphase_force_sweep(const float* q, const float* src,
                                  const int* seg_start, const int* seg_end,
                                  int n, int n_rows, const float* pvec,
                                  int kernel_set, int st_model, int moving,
                                  int group, float* out, void* stream) {
// static walls take G 2 or 4, moving walls G 4 only
#define NEREUS_MP_FORCE(ST, BECKER, M, MOVING, ...)                          \
  if (st_model == ST && moving == M) {                                       \
    return nereus_sweep::launch_group_sweep<MultiphaseForce<BECKER, MOVING>, \
                                            __VA_ARGS__>(                    \
        q, src, seg_start, seg_end, n, n_rows, pvec, kernel_set, group, out, \
        stream);                                                             \
  }
  NEREUS_MP_FORCE(ST_BECKER, true, 0, false, 2, 4)
  NEREUS_MP_FORCE(ST_NONE, false, 0, false, 2, 4)
  NEREUS_MP_FORCE(ST_BECKER, true, 1, true, 4)
  NEREUS_MP_FORCE(ST_NONE, false, 1, true, 4)
#undef NEREUS_MP_FORCE
  return -1;
}

}  // extern "C"
