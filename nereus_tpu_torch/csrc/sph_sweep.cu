// Neighbor-sweep kernels of the WCSPH step, for Hopper (sm_90a).
//
// Replaces the TPU kernel nereus_tpu/ops/pallas_neighbors.py::_sweep_kernel
// (launched by neighbor_sweep) together with the three pair functions the
// WCSPH step runs through it, nereus_tpu/ops/pallas_sph.py::density_pair,
// fluid_force_pair and boundary_force_pair (reached through
// pallas_sph.density_sweep and pallas_sph.fluid_force_sweep), and
// pallas_sph.py::boundary_force_sweep, the wall-only force (the functor
// WallForce<PRESSURE> of pair_sweep_kernel over the wall rows alone, the
// same wall formula as the fused force kernel's rows 9-17; the JAX package
// has no caller of it, the port's is ops/sph_pairs.py::
// boundary_force_sweep).
//
// Design: one thread per query, in hash-sorted order. Each thread walks its
// exact neighbor ranges over the hash-sorted source matrix: rows 0-8 are
// the 9 (dy, dz) runs of the fluid region, rows 9-17 (when present) those
// of the boundary region. This is the reference's own cell-range design;
// the TPU's window plan (128-lane windows, SMEM anchors, float hash
// payloads) exists only for Mosaic and is not carried over. Ranges are
// computed by the caller (torch.searchsorted), so the kernels never
// recompute cell coordinates.
//
// Bound: memory traffic. Every candidate costs one or two 16-byte reads of
// a source row at a data-dependent address, and roughly a sixth of the
// candidates of a 27-cell neighborhood lie inside the cutoff. Neighboring
// queries share most of their sources, so the reads mostly hit L1/L2. A
// later change tiles the sources of a cell block through shared memory.
//
// Numerics: float32, no fast-math. r^2 is clamped to 1e-24 before the
// rsqrt, so every term except the density self term is exactly 0 at the
// self pair, and the Müller viscosity bracket (~1e36 at the clamp)
// multiplies r^2 before its ~1e4 constant (the other order is inf*0 =
// NaN). The viscosity denominator uses exact division. FMA contraction and
// rsqrtf change the last bits against the plain PyTorch version. The
// shared formulas live in sweep_common.cuh.
//
// The force kernel's PRESSURE switch (0 for the IISPH advection forces,
// fluid_force_sweep(include_pressure=False)) drops the Tait term pd2_i +
// pd2_j of the fluid rows and the pressure term of the boundary rows. Its
// VISC switch (0 when the implicit viscosity solve owns viscosity,
// fluid_force_sweep(include_viscosity=False)) drops the Muller viscosity of
// the fluid rows and the friction of the boundary rows. Its MOVING switch
// (1 for a moving boundary, fluid_force_sweep(moving_boundary=True); the
// moving=True of pallas_sph.py::boundary_force_pair) makes the wall
// friction read the relative velocity (v_i - v_b) . r, the wall velocity
// taken from slots 3-5 of the boundary source row; it is instantiated only
// with VISC = 1, since without friction no wall term reads a velocity.
//
// Layouts (all row-major float32, 16-byte aligned):
//   density query (N, 4): x y z pad
//   force query   (N, 8): x y z vx vy vz rho pd2
//   source        (M, 8): x y z vx vy vz s6 pad (boundary rows: the wall
//                         velocity, 0 for a static wall, in vx vy vz)
//     s6 = psi (density: m for fluid, rho0*V_b for boundary rows) or
//          rho_j (force sweep, fluid rows) / psi_b (boundary rows)
//   seg_start, seg_end (n_rows, N) int32
//   pvec: the PV_* vector of ops/sph_pairs.py

#include "sweep_common.cuh"

namespace {

using namespace nereus_sweep;

// ---------------------------------------------------------------------------
// Density: rho_i = sum_j s6_j W(r_ij) over all rows, self term included
// ---------------------------------------------------------------------------

template <int KS>
__global__ void __launch_bounds__(THREADS)
density_sweep_kernel(const float4* __restrict__ q,
                     const float4* __restrict__ src,
                     const int* __restrict__ seg_start,
                     const int* __restrict__ seg_end, int n, int n_rows,
                     const float* __restrict__ pv, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(pv);
  const float4 qi = __ldg(q + i);
  float acc = 0.0f;
  for_each_source(i, n, 0, n_rows, seg_start, seg_end, [&](int j) {
    const float4 a = __ldg(src + 2 * j);
    const float psi = __ldg(reinterpret_cast<const float*>(src) + 8 * j + 6);
    const float dx = qi.x - a.x, dy = qi.y - a.y, dz = qi.z - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    if constexpr (KS == MULLER) {
      const float d = fmaxf(p.h2 - r2, 0.0f);
      acc += (d * d * d) * (psi * p.kpoly);
    } else {
      float rl, invrl;
      rl_invrl(r2, rl, invrl);
      if (r2 < p.h2) acc += psi * w_value<KS>(r2, rl, p);
    }
  });
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// The wall pair of boundary_force_pair: Akinci adhesion beta psi W r, the
// friction nu max(v . r, 0) psi grad W (VISC; MOVING: (v_i - v_b) . r with
// the wall velocity in slots 3-5 of the source row) and the reference-scale
// pressure +m^2 psi pd2_i grad W (PRESSURE), summed into f. One formula for
// the fused force kernel's wall rows and the wall-only WallForce functor.
// ---------------------------------------------------------------------------

// nu = 2 m^2 mu^2 h c_s / (1 + 0.01 h^2) / max(rho_i, 1e-12)^2
__device__ __forceinline__ float wall_nu(float dens_i, const Params& p) {
  const float di = fmaxf(dens_i, 1e-12f);
  return ((2.0f * p.pm * p.pm * p.visc * p.visc * p.h * p.cs) /
          (1.0f + 0.01f * p.h2)) /
         (di * di);
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
  const float psi = b.z;
  const float dx = qx - a.x, dy = qy - a.y, dz = qz - a.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  float rl = 0.0f, invrl = 0.0f;
  if constexpr (KS != MULLER) rl_invrl(r2, rl, invrl);
  const float okf = r2 < p.h2 ? 1.0f : 0.0f;
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
  const float c = PRESSURE != 0 ? ((p.beta * psi) * w +
                                   (cfric + cpb * psi * pd2_i * sd)) * okf
                                : ((p.beta * psi) * w + cfric) * okf;
  fx += c * dx;
  fy += c * dy;
  fz += c * dz;
}

// ---------------------------------------------------------------------------
// Forces: fluid pairs (viscosity, surface tension, Tait pressure with pd2_j
// from rho_j) on rows 0-8, wall pairs (adhesion, friction, reference-scale
// boundary pressure) on rows 9-17; PRESSURE = 0 drops both pressure terms,
// VISC = 0 the viscosity and the friction, MOVING = 1 makes the friction
// read the wall velocity
// ---------------------------------------------------------------------------

template <int KS, int ST, int PRESSURE, int VISC, int MOVING>
__global__ void __launch_bounds__(THREADS)
force_sweep_kernel(const float4* __restrict__ q,
                   const float4* __restrict__ src,
                   const int* __restrict__ seg_start,
                   const int* __restrict__ seg_end, int n, int n_rows,
                   const float* __restrict__ pv, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Params p = load_params(pv);
  const float4 qa = __ldg(q + 2 * i);      // x y z vx
  const float4 qb = __ldg(q + 2 * i + 1);  // vy vz rho pd2
  const float dens_i = qb.z, pd2_i = qb.w;
  const float kv0 = 2.0f * p.pm * p.visc * p.pm;
  const float inv_rd = 1.0f / p.rd;
  const float cp = -p.pm * p.pm;
  const float bden0 = 0.01f * p.h2;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;

  for_each_source(i, n, 0, min(n_rows, N_ROWS), seg_start, seg_end,
                  [&](int j) {
    const float4 a = __ldg(src + 2 * j);      // x y z vx
    const float4 b = __ldg(src + 2 * j + 1);  // vy vz rho pad
    const float dx = qa.x - a.x, dy = qa.y - a.y, dz = qa.z - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    float rl, invrl;
    rl_invrl(r2, rl, invrl);
    const float okf = r2 < p.h2 ? 1.0f : 0.0f;
    const float dens_j = fmaxf(b.z, 1e-12f);
    const float inv_dens = 1.0f / dens_j;

    float cpd = 0.0f;
    if constexpr (PRESSURE != 0) {
      const float ratio = dens_j * inv_rd;
      const float ratio2 = ratio * ratio;
      const float p_j = p.k * (ratio2 * ratio2 * ratio2 * ratio - 1.0f);
      const float pd2_j = p_j * inv_dens * inv_dens;
      cpd = (pd2_i + pd2_j) * cp * grad_scale_press<KS>(rl, invrl, p);
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
      const float kij = 2.0f * p.rd / (dens_i + dens_j);
      cpd += (-p.kappa * p.pm * p.pm) * kij * c * invrl;
    }
    cpd *= okf;
    if constexpr (VISC != 0) {
      const float av = visc_rdotgrad<KS>(r2, rl, invrl, p);
      const float cvisc =
          (kv0 * inv_dens) * (av * (1.0f / (r2 + bden0))) * okf;
      fx += cvisc * (qa.w - a.w) + cpd * dx;
      fy += cvisc * (qb.x - b.x) + cpd * dy;
      fz += cvisc * (qb.y - b.y) + cpd * dz;
    } else {
      fx += cpd * dx;
      fy += cpd * dy;
      fz += cpd * dz;
    }
  });

  if (n_rows > N_ROWS) {
    const float nu = VISC != 0 ? wall_nu(dens_i, p) : 0.0f;
    for_each_source(i, n, N_ROWS, n_rows, seg_start, seg_end, [&](int j) {
      wall_pair<KS, PRESSURE, VISC, MOVING>(qa.x, qa.y, qa.z, qa.w, qb.x,
                                            qb.y, pd2_i, nu, src, j, p, fx,
                                            fy, fz);
    });
  }
  out[3 * i + 0] = fx;
  out[3 * i + 1] = fy;
  out[3 * i + 2] = fz;
}

template <int KS, int ST, int PRESSURE, int VISC, int MOVING>
void launch_force(const float* q, const float* src, const int* s,
                  const int* e, int n, int n_rows, const float* pv,
                  float* out, cudaStream_t stream) {
  force_sweep_kernel<KS, ST, PRESSURE, VISC, MOVING>
      <<<blocks_for(n), THREADS, 0, stream>>>(
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

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); an unknown switch value returns -1.

int nereus_density_sweep(const float* q, const float* src,
                         const int* seg_start, const int* seg_end, int n,
                         int n_rows, const float* pvec, int kernel_set,
                         float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  if (kernel_set == MULLER) {
    density_sweep_kernel<MULLER><<<blocks_for(n), THREADS, 0, st>>>(
        q4, s4, seg_start, seg_end, n, n_rows, pvec, out);
  } else if (kernel_set == MONAGHAN) {
    density_sweep_kernel<MONAGHAN><<<blocks_for(n), THREADS, 0, st>>>(
        q4, s4, seg_start, seg_end, n, n_rows, pvec, out);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

int nereus_force_sweep(const float* q, const float* src, const int* seg_start,
                       const int* seg_end, int n, int n_rows,
                       const float* pvec, int kernel_set, int st_model,
                       int pressure, int visc, int moving, float* out,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NEREUS_FORCE(KS, ST, P, V, M)                                        \
  if (kernel_set == KS && st_model == ST && pressure == P && visc == V &&    \
      moving == M) {                                                         \
    launch_force<KS, ST, P, V, M>(q, src, seg_start, seg_end, n, n_rows,     \
                                  pvec, out, st);                            \
    return static_cast<int>(cudaGetLastError());                             \
  }
#define NEREUS_FORCE_ST(KS, P, V, M) \
  NEREUS_FORCE(KS, ST_NONE, P, V, M) \
  NEREUS_FORCE(KS, ST_BECKER, P, V, M) \
  NEREUS_FORCE(KS, ST_AKINCI, P, V, M)
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

const char* nereus_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
