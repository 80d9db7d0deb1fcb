"""Two-way rigid-body ↔ fluid coupling (PyTorch port of
``nereus_tpu.rigid``).

A rigid body is an Akinci-sampled particle shell with rigid dynamics:

* body → fluid: each step the shell becomes a hash-sorted boundary set
  whose samples carry the rigid velocities ``v + ω×r``
  (:func:`body_boundary`);
* fluid → body: every fluid ↔ shell pair force is central (along r̂), so
  the reaction force and torque summed from the fluid side,
  ``F = −Σ_i f_i`` and ``τ = −Σ_i (x_i − c)×f_i``, are exact; the coupled
  step (:mod:`.solvers.coupled`) sums them from its contact sweep.

Body ↔ wall and body ↔ body contacts are dense passes over (samples ×
samples): shells have tens to thousands of samples, as in the JAX
package, which runs them outside any kernel too. The rigid state
integrates on the state's device with no host synchronisation
(semi-implicit Euler, world inertia ``R I₀ Rᵀ``, rotation re-orthonormalised
each step).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import grid as gridlib
from . import kernels as K
from .params import KernelSet, SimParams, resolve_device
from .state import BoundaryData


@dataclasses.dataclass(frozen=True)
class RigidBody:
    """Rigid-body state and its sample shell, tensors on one device."""

    offsets: torch.Tensor       # (M, 3) body-frame samples, com at origin
    psi: torch.Tensor           # (M,)   Akinci ψ = ρ₀·V_bi (fluid ρ₀)
    mass: torch.Tensor          # ()     body mass
    inertia_body: torch.Tensor  # (3, 3) body-frame inertia about the com
    com: torch.Tensor           # (3,)
    R: torch.Tensor             # (3, 3) body → world rotation
    vel: torch.Tensor           # (3,)   linear velocity
    omega: torch.Tensor         # (3,)   angular velocity (world frame)

    @property
    def num_samples(self) -> int:
        return self.offsets.shape[0]


def make_rigid_box(center, size, radius, body_density, params: SimParams,
                   kernel_set: KernelSet = KernelSet.MULLER,
                   dtype=torch.float32, device=None) -> RigidBody:
    """A box shell sampled as the static boundary sampler samples one, as a
    :class:`RigidBody` of density ``body_density`` at rest, on ``device``
    (default: the CUDA device). ψ uses the fluid's rest density (Akinci
    boundaries measure displaced fluid); the inertia is the solid box's
    ``m/12·diag(s_y²+s_z², s_x²+s_z², s_x²+s_y²)``."""
    from .boundary import compute_vbi, sample_box

    device = resolve_device(device)
    center = np.asarray(center, np.float64)
    size = np.asarray(size, np.float64)
    pts = sample_box(center - size / 2.0, center + size / 2.0, radius)
    vbi = compute_vbi(pts, float(params.interaction_radius), kernel_set)
    psi = float(params.rest_density) * vbi
    mass = float(body_density) * float(np.prod(size))
    sx, sy, sz = (float(s) for s in size)
    inertia = (mass / 12.0) * np.diag(
        [sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            dtype=dtype, device=device)

    return RigidBody(
        offsets=t(pts - center), psi=t(psi), mass=t(mass),
        inertia_body=t(inertia), com=t(center),
        R=torch.eye(3, dtype=dtype, device=device),
        vel=torch.zeros(3, dtype=dtype, device=device),
        omega=torch.zeros(3, dtype=dtype, device=device))


def _cross(a, b):
    return torch.linalg.cross(torch.broadcast_to(a, b.shape), b)


def body_world(body: RigidBody):
    """World-frame sample positions and rigid velocities ``v + ω×r``,
    each (M, 3)."""
    pos = body.com[None, :] + body.offsets @ body.R.T
    r = pos - body.com[None, :]
    return pos, body.vel[None, :] + _cross(body.omega, r)


def body_boundary(body: RigidBody, grid) -> BoundaryData:
    """The hash-sorted :class:`BoundaryData` of the body's current pose,
    with its sample velocities: rebuilt on the device every step."""
    pos, vel = body_world(body)
    h = gridlib.hash_positions(grid, pos)
    sorted_hash, _, (pos_s, psi_s, vel_s) = gridlib.sort_by_hash(
        h, pos, body.psi, vel)
    return BoundaryData(pos=pos_s, psi=psi_s, sorted_hash=sorted_hash,
                        vel=vel_s)


def concat_boundaries(grid, a: BoundaryData | None,
                      b: BoundaryData) -> BoundaryData:
    """One hash-sorted set of a (possibly static) boundary set and a
    per-step one, velocities 0 where a set has none."""
    if a is None or a.num_boundaries == 0:
        return b
    za = torch.zeros_like(a.pos) if a.vel is None else a.vel
    zb = torch.zeros_like(b.pos) if b.vel is None else b.vel
    sorted_hash, _, (pos, psi, vel) = gridlib.sort_by_hash(
        torch.cat([a.sorted_hash, b.sorted_hash]),
        torch.cat([a.pos, b.pos]), torch.cat([a.psi, b.psi]),
        torch.cat([za, zb]))
    return BoundaryData(pos=pos, psi=psi, sorted_hash=sorted_hash, vel=vel)


def _penalty(pa, va, pb, vb, psi_b, params, kernel_set, stiffness,
             damping):
    """Per-sample penalty force (Ma, 3) on the samples ``pa`` (velocities
    ``va``) from the samples ``pb`` (``vb``, ψ ``psi_b``):
    β·ψ·W(r)·max(stiffness − damping·(v_ab·r), 0)·r over pairs within h —
    contact only pushes."""
    rij = pa[:, None, :] - pb[None, :, :]
    d2 = torch.sum(rij * rij, dim=-1)
    ir = params.interaction_radius
    ok = d2 < ir * ir
    w = K.w_value(kernel_set, rij, params)
    dv = va[:, None, :] if vb is None else va[:, None, :] - vb[None, :, :]
    vdotr = torch.sum(dv * rij, dim=-1)
    coef = torch.where(ok, (params.beta * psi_b[None, :]) * w
                       * torch.clamp(stiffness - damping * vdotr, min=0.0),
                       torch.zeros_like(d2))
    return torch.sum(coef[..., None] * rij, dim=1)


def wall_contact_force(body: RigidBody, walls: BoundaryData,
                       params: SimParams,
                       kernel_set: KernelSet = KernelSet.MULLER,
                       stiffness: float = 1.0, damping: float = 20.0):
    """Body ↔ static-wall contact over (body sample × wall sample) pairs:
    the β·ψ·W(r)·r⃗ penalty the fluid feels from walls, scaled by
    ``stiffness``, with normal damping against the sample velocity
    (coefficient clamped ≥ 0). Returns ``(force, torque)`` about the com."""
    pos, vel = body_world(body)
    f_sample = _penalty(pos, vel, walls.pos, None, walls.psi, params,
                        kernel_set, stiffness, damping)
    force = torch.sum(f_sample, dim=0)
    torque = torch.sum(torch.linalg.cross(pos - body.com[None, :], f_sample),
                       dim=0)
    return force, torque


def body_body_contact(a: RigidBody, b: RigidBody, params: SimParams,
                      kernel_set: KernelSet = KernelSet.MULLER,
                      stiffness: float = 1.0, damping: float = 20.0):
    """Rigid ↔ rigid contact between two shells: the penalty and damping of
    :func:`wall_contact_force` with the relative sample velocities. The
    pair forces are central, so both torques come exact from the a-side
    points. Returns ``(F_a, τ_a, F_b, τ_b)`` with ``F_b = −F_a``."""
    pa, va = body_world(a)
    pb, vb = body_world(b)
    f_sa = _penalty(pa, va, pb, vb, b.psi, params, kernel_set, stiffness,
                    damping)
    f_a = torch.sum(f_sa, dim=0)
    tau_a = torch.sum(torch.linalg.cross(pa - a.com[None, :], f_sa), dim=0)
    tau_b = -torch.sum(torch.linalg.cross(pa - b.com[None, :], f_sa), dim=0)
    return f_a, tau_a, -f_a, tau_b


def _orthonormalize(R):
    """Gram-Schmidt on the columns: keeps the integrated rotation a
    rotation."""
    c0 = R[:, 0] / torch.linalg.norm(R[:, 0])
    c1 = R[:, 1] - torch.dot(c0, R[:, 1]) * c0
    c1 = c1 / torch.linalg.norm(c1)
    c2 = torch.linalg.cross(c0, c1)
    return torch.stack([c0, c1, c2], dim=1)


def _skew(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def integrate_rigid(body: RigidBody, force, torque, dt,
                    gravity) -> RigidBody:
    """Semi-implicit Euler for the rigid state, as the fluid integrates:
    world inertia ``R I₀ Rᵀ``, Euler's equation with the gyroscopic term,
    ``R ← orth((I + dt·[ω]×) R)``. The 3×3 solve runs without a host
    synchronisation (``solve_ex`` does not check the factorisation)."""
    g = torch.as_tensor(gravity, dtype=body.vel.dtype,
                        device=body.vel.device)
    v = body.vel + dt * (force / body.mass + g)
    com = body.com + dt * v
    iw = body.R @ body.inertia_body @ body.R.T
    rhs = torque - torch.linalg.cross(body.omega, iw @ body.omega)
    wdot = torch.linalg.solve_ex(iw, rhs[:, None])[0][:, 0]
    w = body.omega + dt * wdot
    eye = torch.eye(3, dtype=body.R.dtype, device=body.R.device)
    R = _orthonormalize((eye + dt * _skew(w)) @ body.R)
    return dataclasses.replace(body, com=com, R=R, vel=v, omega=w)
