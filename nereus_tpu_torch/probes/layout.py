"""The source-layout probe (PyTorch port of ``tools/probe_transposed.py``).

A synthetic force-weight sweep at a realistic size, the same function as
the TPU probe's kernel on the same inputs (:func:`build_inputs` draws them
as ``build`` does, numpy seeds 0, 1 and 2): per 128-query block, 9 rows ×
2 passes of windows of ``ws`` source rows starting at (anchor − 1)·8
(anchor 0: no window), every slot through the ~70-operation formula with
the stand-in bounds lo = 0.5·qx + r, hi = lo + 30 on source column 7. It
times the port's question: the (M, 8) float rows its sweeps read now (two
float4 per source, ``AoS``) against (8, M) columns (``SoA``), the two
instances of ``csrc/layout_probe.cu``.

    python -m nereus_tpu_torch.probes.layout [--m 1048576] [--ws 192]

prints, on the card, ms per sweep, G slots/s (slots counted as the TPU
probe counts them: blocks × 9 × 1.3 × ws × 128) and M queries/s for both
layouts.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ..ops.sph_pairs import dispatch

N_ROWS = 9
N_PASS = 2
B = 128       # queries per block
F = 8         # source fields: x y z vx vy vz dens hash
FQ = 8        # query fields: x y z vx vy vz pad pd2
# operations per slot of the formula, counted in csrc/layout_probe.cu with
# every add, multiply, compare, logical and, select, min/max, division and
# rsqrt as one
OPS_PER_SLOT = 72
# the output held element by element (:func:`mismatched_queries`): a slot's
# formula cancels (950 − 3.1e5·r − 0.023/r³, the differences to the
# cutoff), so a float32 sum sits up to ~1e-4·|f| from a float64 one on
# build_inputs' data (m = 2¹⁴ and 2¹⁸, ws = 192, with atol 1e-4); the
# median non-zero |f| is ~3 and 99 % exceed 3e-4
RTOL, ATOL = 1e-3, 1e-4


def build_inputs(m: int, ws: int):
    """``(anchors (m/128·18,) int32, q (8, m) float32, src (m+ws+8, 8)
    float32)`` as numpy arrays, drawn as ``probe_transposed.build`` draws
    them: uniform sources (seed 0) and queries (seed 1), and per block and
    row a pass-0 anchor near the block's own position (seed 2), a pass-1
    anchor ws/8 rows further on in 30 % of them."""
    if m % B:
        raise ValueError(f"m ({m}) must be a multiple of {B}")
    nb = m // B
    src = np.random.default_rng(0).uniform(0, 1, (m + ws + 8, F)).astype(
        np.float32)
    q = np.random.default_rng(1).uniform(0, 1, (FQ, m)).astype(np.float32)
    rng = np.random.default_rng(2)
    base = (np.arange(nb) * B) // 8
    anchors = np.zeros((nb, N_ROWS, N_PASS), np.int32)
    for r in range(N_ROWS):
        off = rng.integers(-4, 4, nb)
        anchors[:, r, 0] = np.clip(base + off, 0, m // 8) + 1
        anchors[:, r, 1] = np.where(rng.random(nb) < 0.3,
                                    anchors[:, r, 0] + ws // 8, 0)
    return anchors.reshape(-1), q, src


def window_slots(anchors, ws: int) -> int:
    """The slots the sweep evaluates: non-sentinel windows × ws × 128."""
    return int((anchors > 0).sum()) * ws * B


def probe_plain(anchors, q, src, ws: int, soa: bool = False,
                chunk: int = 256):
    """The probe's plain version (4, m): ``src`` (M, 8) rows or, ``soa``,
    (8, M) columns; a window that would run past the source starts at
    M − ws, as ``lax.dynamic_slice`` clamps it. ``chunk`` blocks at a time
    bound the pair tensors' memory."""
    s_rows = src.t() if soa else src
    m_src = s_rows.shape[0]
    m = q.shape[1]
    nb = m // B
    anc = anchors.view(nb, N_ROWS, N_PASS).long()
    qb = q.view(FQ, nb, B)
    out = torch.zeros((4, nb, B), dtype=q.dtype, device=q.device)
    t = torch.arange(ws, device=q.device)
    for b0 in range(0, nb, chunk):
        sl = slice(b0, min(b0 + chunk, nb))
        qx, qy, qz = (qb[k, sl][:, None, :] for k in range(3))
        qvx, qvy, qvz = (qb[k, sl][:, None, :] for k in range(3, 6))
        qpd = qb[7, sl][:, None, :]
        for r in range(N_ROWS):
            lo = qx * 0.5 + float(r)
            hi = lo + 30.0
            for p in range(N_PASS):
                a = anc[sl, r, p]
                start = torch.clamp((a - 1) * 8, 0, m_src - ws)
                s = s_rows[(start[:, None] + t)]          # (nb, ws, 8)
                f = _slot_forces(s, lo, hi, qx, qy, qz, qvx, qvy, qvz, qpd)
                live = (a > 0).to(q.dtype)[:, None]
                for k in range(3):
                    out[k, sl] += f[k].sum(dim=1) * live
    return out.view(4, m)


def _slot_forces(s, lo, hi, qx, qy, qz, qvx, qvy, qvz, qpd):
    """(fx, fy, fz) of every (source, query) slot, (nb, ws, 128) each: the
    TPU probe's formula in its operation order."""
    col = [s[:, :, k:k + 1] for k in range(F)]
    sx, sy, sz, svx, svy, svz = col[:6]
    dens_j = torch.clamp(col[6], min=1e-12)
    shash = col[7]
    valid = (shash >= lo) & (shash <= hi)
    dx = qx - sx
    dy = qy - sy
    dz = qz - sz
    r2 = dx * dx + dy * dy + dz * dz
    inv = torch.rsqrt(torch.clamp(r2, min=1e-24))
    rl = r2 * inv
    okf = (valid & (r2 < 0.0021)).to(r2.dtype)
    inv_dens = 1.0 / dens_j
    inv3 = inv * inv * inv
    c = (950.0 - rl * 3.1e5 - inv3 * 0.023)
    bden = r2 + 2.1e-5
    cvisc = (inv_dens * 1e-7) * ((c * r2) / bden) * okf
    ratio = dens_j * 1e-3
    r2a = ratio * ratio
    p_j = 800.0 * (r2a * r2a * r2a * ratio - 1.0)
    pd2_j = p_j * inv_dens * inv_dens
    hr = torch.clamp(0.0457 - rl, min=0.0)
    sp = (hr * hr) * inv * -2.4e1
    cpd = (qpd + pd2_j) * sp
    dpo = torch.clamp(0.0021 - r2, min=0.0)
    w = dpo * dpo * dpo * 6.8e9
    w_eff = torch.where(r2 > 1.6e-3, w, torch.full_like(w, 0.11))
    cpd = (cpd - 0.08 * w_eff) * okf
    return (cvisc * (qvx - svx) + cpd * dx, cvisc * (qvy - svy) + cpd * dy,
            cvisc * (qvz - svz) + cpd * dz)


def layout_probe(anchors, q, src, ws: int, soa: bool = False):
    """The probe (4, m): the CUDA kernel (``layout_probe<AoS>`` or
    ``<SoA>``) on CUDA tensors, :func:`probe_plain` on CPU ones."""
    return dispatch((q, src, anchors), probe_plain, "layout_probe", anchors,
                    q, src, ws, soa)


def mismatched_queries(got, ref, rtol: float = RTOL, atol: float = ATOL):
    """The queries (bool (m,)) whose output in ``got`` (4, m) disagrees
    with ``ref``: each force element held on its own scale,
    |got − ref| ≤ rtol·|ref| + atol, exactly 0 where ``ref`` is 0 (no slot
    inside the cutoff), finite; row 3 zero."""
    f, r = got[:3], ref[:3]
    ok = (((f - r).abs() <= rtol * r.abs() + atol) & ((r != 0) | (f == 0))
          & torch.isfinite(f))
    return ~ok.all(dim=0) | (got[3] != 0)


def planted_faults(anchors, q, src, ws: int, ref, soa: bool = False):
    """Outputs of two wrong probes that :func:`mismatched_queries` must
    flag against ``ref``: every pass-1 window skipped, and the force of the
    query of median non-zero force 1 % off (that query alone)."""
    a = anchors.view(-1, N_ROWS, N_PASS).clone()
    a[:, :, 1] = 0
    skipped = probe_plain(a.view(-1), q, src, ws, soa)
    mag = ref[:3].abs().amax(dim=0)
    live = torch.nonzero(mag > 0)[:, 0]
    median = live[mag[live].argsort()[len(live) // 2]]
    off = ref.clone()
    off[:3, median] *= 1.01
    return {"pass-1 windows skipped": skipped, "median query 1 % off": off}


def device_inputs(m: int, ws: int, device):
    """:func:`build_inputs` on ``device``: ``(anchors, q, src_aos,
    src_soa)``."""
    anchors, q, src = build_inputs(m, ws)
    src_t = torch.from_numpy(src).to(device)
    return (torch.from_numpy(anchors).to(device),
            torch.from_numpy(q).to(device), src_t, src_t.t().contiguous())


def time_layouts(m: int, ws: int, reps: int = 10):
    """``{"AoS" | "SoA": ms per sweep}`` on the card, each the better of
    two runs of ``reps`` sweeps timed with CUDA events, in the order AoS,
    SoA, SoA, AoS."""
    anchors, q, aos, soa = device_inputs(m, ws, torch.device("cuda"))
    srcs = {"AoS": (aos, False), "SoA": (soa, True)}

    def run(name):
        src, is_soa = srcs[name]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            layout_probe(anchors, q, src, ws, is_soa)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for name in srcs:
        run(name)
    ms = {"AoS": [], "SoA": []}
    for name in ("AoS", "SoA", "SoA", "AoS"):
        ms[name].append(run(name))
    return {k: min(v) for k, v in ms.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=2 ** 20)
    ap.add_argument("--ws", type=int, default=192)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the layout probe times the CUDA kernels: no CUDA "
                         "device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    nb = args.m // B
    slots = nb * N_ROWS * 1.3 * args.ws * B
    for name, ms in time_layouts(args.m, args.ws).items():
        per = ms * 1e-3
        print(f"{name} m={args.m} ws={args.ws}: {ms:.4f} ms/sweep, "
              f"{slots / per / 1e9:.1f} G slots/s, "
              f"{args.m / per / 1e6:.2f} M q/s")


if __name__ == "__main__":
    main()
