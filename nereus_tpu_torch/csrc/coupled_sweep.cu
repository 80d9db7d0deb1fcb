// Pair functions of the rigid-body coupled WCSPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the two
// body-contact pair functions of solvers/coupled.py:
// boundary_force_pair in its body form (moving=True, include_adhesion=False,
// pressure_sign=-1, consistent_pressure=True; _coupled_step_pallas), its
// friction alone (include_pressure=False: the DFSPH couplings'
// non-pressure stage, solvers/dfsph_coupled.py and dfsph_elastic.py) and
// multiphase_body_pair (_coupled_mp_pallas, and with bp = 0 the friction
// of the multiphase DFSPH coupling). A body shell's psi-density is
// the density kernel of sph_sweep.cu over the body source.
//
// Design. The source is one body shell alone, so only rows 0-8 are walked
// (BOUNDARY_ROWS = false): the ranges come from the query cells and the
// shell's own sorted hashes. Both forces are central, along r, so the
// caller sums the reaction on the body from the fluid side
// (F = -sum f_i, tau = -sum (x_i - c) x f_i) and no second,
// body-as-query sweep is needed. Each pair keeps the operation order of
// nereus_tpu_torch/ops/sph_pairs.py.
//
// The body force, both forms (once per step on the coupled WCSPH paths,
// once per step as the friction alone on the DFSPH couplings), runs on
// the lane-group engine group_pair_sweep_kernel<BodyForce<PRESSURE>, KS,
// G> of group_sweep.cuh. What held it back on pair_sweep_kernel: one
// thread per fluid query walked the shell's 9 runs in series, and every
// candidate loaded both float4s of its 32-byte row and ran the whole pair,
// multiplied by 0 outside the cutoff. Over a small shell (a rigid box's
// 56 samples) nearly every query's runs are empty and the range rows are
// the cost; over a large one in mid-fluid (an elastic cube's 4,096
// samples) the busy queries hold many candidates each and diverge from
// their warp's empty lanes. What the design does: G lanes per query walk
// the flattened runs as one list; a candidate loads x y z vb_x, tests the
// cutoff, and only inside it loads vb_y vb_z psi_b and runs the pair. G:
// ops/cuda_sweep.py::shell_group, by the shell's size, as the DFSPH
// couplings' shell sweeps (only those instances are built; measured at the
// four paths that run it, PERF.md section 6).
//
// The multiphase body contact stays on the range-walk template
// pair_sweep_kernel<Pair, KS> of sweep_common.cuh (one thread per query,
// the pair on every candidate, masked by the cutoff).
//
// Bound: memory traffic (sweep_common.cuh). A shell has tens to thousands
// of samples, so most queries find empty ranges and the sweep costs about
// one read of the 32-byte query rows and the range rows.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   body force: q (N, 8) x y z vx vy vz rho pd2 (the force sweep's query);
//       src (Mb, 8) x y z vb_x vb_y vb_z psi_b pad; out (N, 3) force
//   multiphase body: q (N, 8) x y z vx vy vz bp fr with
//       bp = (rho0_i/rho0) max(p_i, 0)/rho~_i^2 and fr = m_i/rho~_i^2;
//       src as the body force's; out (N, 3) acceleration

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// (dx, dy, dz, r^2, grad scale, okf, psi) of a query and a body row, and
// the relative velocity (v_i - v_b) . r
struct BodyGeom {
  float dx, dy, dz, s, okf, psi, vdotr;
};

template <int KS>
__device__ __forceinline__ BodyGeom body_geom(const float (&q)[8],
                                              const float* src, int j,
                                              const Params& p) {
  const float4 a = src_f4(src, 8, j, 0);  // x y z vb_x
  const float4 b = src_f4(src, 8, j, 1);  // vb_y vb_z psi pad
  BodyGeom g;
  g.dx = q[0] - a.x;
  g.dy = q[1] - a.y;
  g.dz = q[2] - a.z;
  const float r2 = g.dx * g.dx + g.dy * g.dy + g.dz * g.dz;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
  g.s = grad_scale_default<KS>(r2, rl, invrl, p);
  g.okf = r2 < p.h2 ? 1.0f : 0.0f;
  g.psi = b.z;
  g.vdotr = (q[3] - a.w) * g.dx + (q[4] - b.x) * g.dy + (q[5] - b.y) * g.dz;
  return g;
}

// force on the fluid: friction nu max((v_i - v_b) . r, 0) psi grad W with
// nu = 2 m^2 mu^2 h c_s / (1 + 0.01 h^2) / rho_i^2, and (PRESSURE) the
// repulsive Akinci pressure -m psi max(pd2_i, 0) grad W; the engine calls
// it inside the cutoff with a = x y z vb_x of row j, and vb_y vb_z psi_b
// load only there
template <bool PRESSURE>
struct BodyForce {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vb_y vb_z psi pad
    const float dx = q[0] - a.x, dy = q[1] - a.y, dz = q[2] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    float rl = 0.0f, invrl = 0.0f;
    if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
    const float s = grad_scale_default<KS>(r2, rl, invrl, p);
    const float vdotr = (q[3] - a.w) * dx + (q[4] - b.x) * dy +
                        (q[5] - b.y) * dz;
    const float di = fmaxf(q[6], 1e-12f);
    const float nu = ((2.0f * p.pm * p.pm * p.visc * p.visc * p.h * p.cs) /
                      (1.0f + 0.01f * p.h2)) /
                     (di * di);
    const float cfric = nu * fmaxf(vdotr, 0.0f) * b.z * s;
    float c = cfric;
    if constexpr (PRESSURE) {
      c = cfric + (-p.pm) * b.z * fmaxf(q[7], 0.0f) * s;
    }
    acc[0] += c * dx;
    acc[1] += c * dy;
    acc[2] += c * dz;
  }
};

// acceleration on multiphase fluid: -bp_i psi grad W
// + K fr_i max((v_i - v_b) . r, 0) psi grad W, K = 2 mu^2 h c_s/(1+0.01h^2)
struct MultiphaseBody {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = false;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const BodyGeom g = body_geom<KS>(q, src, j, p);
    const float cpress = -q[6] * g.psi * g.s;
    const float kf = (2.0f * p.visc * p.visc * p.h * p.cs) /
                     (1.0f + 0.01f * p.h2);
    const float cfric = (kf * q[7]) * fmaxf(g.vdotr, 0.0f) * g.psi * g.s;
    const float c = (cpress + cfric) * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

}  // namespace

extern "C" {

NEREUS_PAIR_SWEEP(multiphase_body, MultiphaseBody)
// both forms at the G of ops/cuda_sweep.py::shell_group
NEREUS_GROUP_SWEEP(body_force, BodyForce<true>, 2, 8)
NEREUS_GROUP_SWEEP(body_force_p0, BodyForce<false>, 2, 8)

}  // extern "C"
