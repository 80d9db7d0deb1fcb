// Pair functions of the single-phase DFSPH step, for Hopper (sm_90a).
//
// Replace the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with the two
// DFSPH pair functions of pallas_sph.py, alpha_pair and drho_pair
// (solvers/dfsph_pallas.py::dfsph_step_pallas). Its kappa correction is the
// PressureForce functor of iisph_sweep.cu with kappa/rho in the pd2 slot.
// The DFSPH couplings (solvers/dfsph_coupled.py, dfsph_elastic.py) run
// alpha_pair(include_sq=False) over a body shell alone (BoundaryForm<Alpha>,
// rows 0-8), and Alpha and Drho as they are over a shell's 9 rows (the
// elastic body's sum |psi grad W|^2 under strong coupling; the shell's
// sample velocities in Drho's velocity slots).
//
// Design. Alpha (once per step) is a functor of the range-walk template
// pair_sweep_kernel<Pair, KS> of sweep_common.cuh, in the operation order
// of ops/sph_pairs.py; it uses the default (poly6 / Monaghan) gradient,
// which is exactly 0 at the self pair only because r^2 is clamped before
// the rsqrt, so self-pairs stay in the ranges; the Muller gradient skips
// the rsqrt. Bound: memory traffic (sweep_common.cuh): one 32-byte source
// row per candidate against ~20 flops.
//
// Drho runs once per iteration of both solver loops (~4 times per step)
// on the lane-group engine group_pair_sweep_kernel<Drho, KS, G> of
// group_sweep.cuh. What held it back on pair_sweep_kernel: one thread per
// query walking 18 runs in series, and every candidate loading both
// float4s of its 32-byte row and running the whole pair, multiplied by 0
// outside the cutoff (~85 % of the candidates). What the design does: G
// lanes per query walk the flattened fluid and wall runs as one list; a
// candidate loads x y z vx, tests the cutoff, and only inside it loads
// vy vz psi and runs the pair. Its operands are one (C + Mb, 8) matrix
// x y z vx | vy vz psi pad whose first C rows are the queries
// (solvers/dfsph_cuda.py::KappaSweeps), so each iteration writes the
// velocities once. G: ops/cuda_sweep.py::DRHO_G (the one instance
// built).
//
// Drho over a rigid or elastic shell (the DFSPH couplings, as often as
// Drho) is DrhoShell, the same pair over the shell's 9 rows, on the same
// engine, group_pair_sweep_kernel<DrhoShell, KS, G>, at a G picked by the
// shell's size (ops/cuda_sweep.py::shell_group, as the kappa impulse's).
// Over a small shell (a rigid box's 56 samples) nearly every fluid
// query's runs are empty and G 2 lanes scan them; over a large one (an
// elastic cube's 4,096 samples in mid-fluid) the busy queries fill whole
// warps, which G 8 lanes per query split. vy vz psi_b load only inside
// the cutoff, where MaskedForm<Drho> on pair_sweep_kernel, the walk it
// replaces, loaded every candidate's whole row and ran the pair masked.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   alpha: q (N, 4) x y z pad; src (M, 8) x y z 0 0 0 psi pad;
//          out (N, 4) sum psi grad W (3), sum |psi grad W|^2 (fluid rows)
//   drho:  src (C + Mb, 8) x y z vx vy vz psi pad (fluid rows psi = m,
//          wall rows their velocities, 0 for a static wall, and psi_b);
//          q its first C rows (slots 0-5 read); out (N,)
//   drho_shell: q (N, 8) x y z vx vy vz (slots 0-5 read); src a shell's
//          (Mb, 8) rows x y z v_b psi_b 0; ranges (9, N); out (N,)

#include "group_sweep.cuh"

namespace {

using namespace nereus_sweep;

// sum psi grad W, and sum |psi grad W|^2 over the fluid rows only (static
// boundaries add to the gradient sum alone)
struct Alpha {
  static constexpr int QW = 4, SW = 8, OW = 4;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);
    const float psi = src_f4(src, SW, j, 1).z;
    const Geom g = default_geom<KS>(q, a, p);
    const float c = psi * g.s * g.okf;
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
    if constexpr (!B) acc[3] += c * c * g.r2;
  }
};

// D rho / Dt = sum psi_j (v_q - v_j) . grad W, one formula for both
// regions; the engine calls it inside the cutoff, with a = x y z vx of
// row j
struct Drho {
  static constexpr int QW = 8, SW = 8, OW = 1;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], float4 a,
                              const float* src, int j, const Params& p,
                              float (&acc)[OW]) {
    const float4 b = src_f4(src, SW, j, 1);  // vy vz psi pad
    const Geom g = default_geom<KS>(q, a, p);
    const float dvx = q[3] - a.w;
    const float dvy = q[4] - b.x;
    const float dvz = q[5] - b.y;
    acc[0] += b.z * g.s * (dvx * g.dx + dvy * g.dy + dvz * g.dz);
  }
};

// Drho over a body shell's 9 range rows: the same pair, with the shell's
// sample velocities and psi_b in the source row's slots 3-6
struct DrhoShell : Drho {
  static constexpr bool BOUNDARY_ROWS = false;
};

}  // namespace

extern "C" {

NEREUS_PAIR_SWEEP(alpha, Alpha)
// sum psi grad W of a body shell alone, without the square sum
NEREUS_PAIR_SWEEP(alpha_body, BoundaryForm<Alpha>)
// the G of ops/cuda_sweep.py::DRHO_G
NEREUS_GROUP_SWEEP(drho, Drho, 4)
// over a body shell's 9 rows, at the G of ops/cuda_sweep.py::shell_group
NEREUS_GROUP_SWEEP(drho_shell, DrhoShell, 2, 8)

}  // extern "C"
