// The viscous Laplacian of the implicit viscosity solve, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// as nereus_tpu/ops/pallas_sph.py::generic_sweep launches it with
// visc_laplacian_pair (solvers/viscosity.py::implicit_viscosity_pallas, one
// sweep per conjugate-gradient matvec):
//
//   L(v)_i = 10 sum_j coef_j (v_ij . x_ij) / (|x_ij|^2 + 0.01 h^2) grad W_ij
//
// (Weiler et al. 2018, 2(d + 2) = 10 for d = 3), coef = m / rho_j for fluid
// sources (source slot 6) and psi_b / rho_i for wall sources (psi_b in
// slot 6, rho_i in query column 6; the walls' velocities ride slots 3-5,
// zero for static walls).
//
// Design: one functor for the row-tiled engine tiled_pair_sweep_kernel<
// Pair, KS> of tiled_sweep.cuh (tiles of queries that share a cell row;
// the CG launches it 20-30 times per step over one tile plan), fluid and
// wall rows the B = false / true branches, in the operation order of
// ops/sph_pairs.py::visc_laplacian_pair: (10 coef s) first, then the
// velocity dot, then the reciprocal. The default gradient is exactly 0 at
// the self pair (r^2 is clamped before the rsqrt), so the self pair stays
// in the ranges. The TPU kernel takes an approximate reciprocal; this one
// divides exactly, and only where the cutoff mask is 1 (the same +0
// elsewhere): an exact division on every candidate costs more than the
// rest of the pair.
//
// Bound: the bytes of the query, source and output rows and of the range
// rows (tiled_sweep.cuh); ~30 operations per candidate.
//
// Layouts (row-major float32, 16-byte aligned rows):
//   q (N, 8) x y z vx vy vz rho pad; src (M, 8) x y z vx vy vz coef pad
//   (fluid coef = m / rho_j, wall rows psi_b); out (N, 3)

#include "tiled_sweep.cuh"

namespace {

using namespace nereus_sweep;

struct ViscLaplacian {
  static constexpr int QW = 8, SW = 8, OW = 3;
  static constexpr bool BOUNDARY_ROWS = true;
  template <int KS, bool B>
  __device__ static void pair(const float (&q)[QW], const float* src, int j,
                              const Params& p, float (&acc)[OW]) {
    const float4 a = src_f4(src, SW, j, 0);  // x y z vx
    const float4 b = src_f4(src, SW, j, 1);  // vy vz coef pad
    const Geom g = default_geom<KS>(q, a, p);
    if (g.okf == 0.0f) return;
    // psi_b / rho_i on the wall rows (1 / rho_i is loop-invariant)
    const float coef = B ? b.z * (1.0f / fmaxf(q[6], 1e-12f)) : b.z;
    const float dvdotx =
        (q[3] - a.w) * g.dx + (q[4] - b.x) * g.dy + (q[5] - b.y) * g.dz;
    const float c = (10.0f * coef * g.s) * dvdotx *
                    (1.0f / (g.r2 + 0.01f * p.h2));
    acc[0] += c * g.dx;
    acc[1] += c * g.dy;
    acc[2] += c * g.dz;
  }
};

}  // namespace

extern "C" {

NEREUS_TILED_SWEEP(visc_laplacian, ViscLaplacian)

}  // extern "C"
