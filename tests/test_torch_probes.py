"""The port's probes (``nereus_tpu_torch.probes``) vs the JAX package's
TPU probes on the CPU.

- The cell check: the port's in-kernel cell coordinates (their plain
  version, ``grid.cell_coords_cols``, on the CPU) equal JAX's
  ``grid.cell_coords_cols`` on the same hash-sorted queries of a small
  dam-break, on its compact grid, on ``bench.py``'s stretch past 2²⁴
  cells and on ``wideprobe --pad-below``; both checks report 0.
- The stretch A/B: three WCSPH steps on the compact and on the stretched
  grid give bit-identical positions (gx, gy and the origin are kept, so
  every hash and range is the same); the padded grid agrees within 1e-6 m.
- The layout probe's plain version against ``tools/probe_transposed.py``'s
  kernel in interpret mode (``pl.pallas_call`` patched to
  ``interpret=True``; the call's inputs and output recorded under
  ``jax.disable_jit``), on its own inputs, for the AoS and the SoA source.
  Windows that run past the source read NaN there; the port starts such a
  window at M − ws, so those blocks are compared only for being finite.
  Every other query is held element by element
  (``layout.mismatched_queries``: |Δ| ≤ 1e-3·|ref| + 1e-4, exactly 0
  where JAX's is 0), and the same check flags two planted faults.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import nereus_tpu as jt
from nereus_tpu import grid as jgrid
from nereus_tpu.grid import Grid as JGrid
from nereus_tpu.solvers.pallas_common import build_pallas_ctx

import nereus_tpu_torch as pt
from nereus_tpu_torch.boundary import rehash_boundary
from nereus_tpu_torch.probes import cells, layout
from nereus_tpu_torch.solvers.sweep_common import build_sweep_ctx

from torch_bridge import jax_scene, to_port

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import probe_transposed  # noqa: E402
import wideprobe  # noqa: E402

torch.set_num_threads(1)


def _jax_grid(grid, kind):
    """The JAX grid of ``kind``: compact, ``bench.py``'s stretch, or
    ``wideprobe --pad-below`` by enough planes to lift every hash past
    2²⁴."""
    gx, gy, gz = grid.size
    if kind == "compact":
        return grid
    if kind == "stretched":
        gz_wide = max(int(np.ceil(2 ** 24 * 1.05 / (gx * gy))), gz)
        return jt.make_grid(np.asarray(grid.origin), (gx, gy, gz_wide),
                            float(grid.cell[0]))
    k = 2 ** 24 // (gx * gy) + 1
    origin = np.asarray(grid.origin, np.float64)
    origin[2] -= k * float(np.asarray(grid.cell)[0])
    return JGrid(origin=jax.numpy.asarray(origin, grid.origin.dtype),
                 size=(gx, gy, gz + k), cell=grid.cell)


def _port_grid(pgrid, kind):
    if kind == "compact":
        return pgrid
    if kind == "stretched":
        return cells.stretch_grid(pgrid)
    gx, gy, _ = pgrid.size
    return cells.pad_below(pgrid, 2 ** 24 // (gx * gy) + 1)


@pytest.mark.parametrize("kind", ["compact", "stretched", "padded"])
def test_cellcheck_matches_jax(kind):
    cfg, params, state, grid, _ = jax_scene(False)
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    jg, pgk = _jax_grid(grid, kind), _port_grid(pg, kind)
    assert pgk.size == tuple(jg.size)
    np.testing.assert_array_equal(pgk.origin.numpy(), np.asarray(jg.origin))
    if kind != "compact":
        assert np.prod(pgk.size) > 2 ** 24
    assert wideprobe.cellcheck(state, params, jg, cfg) == 0
    assert cells.cellcheck(pstate, pparams, pgk, pcfg) == 0
    jctx = build_pallas_ctx(state, params, jg, cfg, None)
    want = np.stack([np.asarray(a) for a in jgrid.cell_coords_cols(
        jg, jctx.px, jctx.py, jctx.pz)], axis=1)[:jctx.c]
    ctx = build_sweep_ctx(pstate, pparams, pgk, pcfg, None)
    got = cells.cell_coords_in_kernel(ctx.queries(width=4), ctx.pvec, pgk)
    assert got.dtype == torch.int32 and got.shape == (ctx.c, 4)
    np.testing.assert_array_equal(got[:, :3].numpy(), want)
    assert not got[:, 3].any()
    if kind == "padded":
        assert int(ctx.sorted_hash[:int(pstate.num_active)].min()) >= 2 ** 24


def test_cellcheck_counts_mismatches(monkeypatch, capsys):
    """A kernel cell off by one is counted on its axis, and ranges built
    from cells two rows off leave every query outside its centre row."""
    cfg, params, state, grid, _ = jax_scene(False)
    pcfg, pparams, pstate, pg, _ = to_port(cfg, params, state, grid, None)
    real = cells.cell_coords_in_kernel

    def off_by_one(q, pvec, grid):
        c = real(q, pvec, grid).clone()
        c[:5, 0] += 1
        return c
    monkeypatch.setattr(cells, "cell_coords_in_kernel", off_by_one)
    assert cells.cellcheck(pstate, pparams, pg, pcfg) == 5
    assert "per-axis [5, 0, 0], outside their centre row 0" in (
        capsys.readouterr().out)
    monkeypatch.undo()
    from nereus_tpu_torch.solvers import sweep_common
    real_ranges = sweep_common.query_ranges

    def two_rows_up(grid, coords, *hashes):
        c = coords.clone()
        c[:, 1] += 2
        return real_ranges(grid, c, *hashes)
    monkeypatch.setattr(sweep_common, "query_ranges", two_rows_up)
    n = int(pstate.num_active)
    assert cells.cellcheck(pstate, pparams, pg, pcfg) == n
    assert f"outside their centre row {n}" in capsys.readouterr().out


def test_steps_ab_stretch_is_bit_identical():
    """Three WCSPH steps of a 343-particle dam-break with its walls:
    compact against stretched bit for bit, compact against padded (the
    walls re-sorted for it) within 1e-6 m."""
    cfg, params, state, grid, walls = jax_scene(True, floor=-0.115)
    pcfg, pparams, pstate, pg, pwalls = to_port(cfg, params, state, grid,
                                                walls)
    wide = cells.stretch_grid(pg)
    max_d, identical = cells.steps_ab(pstate, pparams, pg, wide, pcfg, 3,
                                      pwalls, rehash_boundary(pwalls, wide))
    assert identical and max_d == 0.0
    gx, gy, _ = pg.size
    padded = cells.pad_below(pg, 2 ** 24 // (gx * gy) + 1)
    max_d, _ = cells.steps_ab(pstate, pparams, pg, padded, pcfg, 3, pwalls,
                              rehash_boundary(pwalls, padded))
    assert max_d <= 1e-6


M, WS = 2048, 256   # 16 blocks; > 100 queries with a force


@pytest.fixture(scope="module")
def jax_probe():
    """``probe_transposed.build(M, WS)``'s Pallas call in interpret mode:
    its first call's (anchors, q, src) and (4, M) output."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call
    rec = {}

    def recording(*a, **kw):
        f = orig(*a, interpret=True, **kw)

        def call(*args):
            if "out" not in rec:
                rec["args"] = [np.asarray(x) for x in args[:3]]
                rec["out"] = np.array(f(*args))
            return rec["out"]
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording)
        sweep10, q, src, _ = probe_transposed.build(M, WS)
        with jax.disable_jit():
            sweep10(q, src)
    return rec


@pytest.mark.parametrize("soa", [False, True], ids=["AoS", "SoA"])
def test_layout_probe_matches_jax(jax_probe, soa):
    anchors, q, src = layout.build_inputs(M, WS)
    for got, want in zip((anchors, q, src), jax_probe["args"]):
        np.testing.assert_array_equal(got, want)
    s = torch.from_numpy(src)
    out = layout.layout_probe(torch.from_numpy(anchors), torch.from_numpy(q),
                              s.t().contiguous() if soa else s, WS,
                              soa=soa).numpy()
    ref = jax_probe["out"]
    # blocks with a window past the source's end: NaN rows on the JAX side
    a = anchors.reshape(-1, layout.N_ROWS, layout.N_PASS)
    over = ((a > 0) & ((a - 1) * 8 + WS > src.shape[0])).any(axis=(1, 2))
    over = np.repeat(over, layout.B)
    assert over.any() and not over.all()
    assert np.isnan(ref[:3, over]).all() and not np.isnan(ref[:, ~over]).any()
    assert np.isfinite(out).all() and not out[3].any()
    live = (ref[:3, ~over] != 0).any(axis=0)
    assert live.sum() > 100
    keep = torch.from_numpy(~over)
    want = torch.from_numpy(ref)[:, keep]
    bad = layout.mismatched_queries(torch.from_numpy(out)[:, keep], want)
    assert not bad.any(), int(bad.sum())
    # the same check flags a wrong probe
    for fault, wrong in layout.planted_faults(
            torch.from_numpy(anchors), torch.from_numpy(q), s,
            WS, torch.from_numpy(ref)).items():
        assert layout.mismatched_queries(wrong[:, keep], want).any(), fault
    assert layout.window_slots(anchors, WS) == (a > 0).sum() * WS * 128
