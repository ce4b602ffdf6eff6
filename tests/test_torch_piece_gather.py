"""Kernel K3's plain version (ops/piece_gather.py) and the giant-tier route
on the CPU.

- piece_descriptors against the experiment's (experiments/pallas_piece_dma.py,
  imported by path), entry for entry.
- piece_gather_plain against the experiment's Pallas kernel in interpret
  mode: in-ball masks, channels and source rows equal; d2 held to a numpy
  witness of each side's association (the experiment's dx = c - x;
  dx - p*round(dx/p), with the sum fused as XLA:CPU fuses it; the port's
  K1 form, every op rounded).
- piece_gather_plain equal to K1's plain version bit for bit.
- solves and the pipeline with gather.PIECE_K_MIN lowered, so K3 serves
  the dispatches: so_tpu's code, Mvir, Rvir and j bit for bit, and every
  port output equal to its K1-only run.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

from test_torch_pipeline import _box  # noqa: E402
from test_torch_solver import BOXES, fma32  # noqa: E402

from so_tpu.engine.solver import solve_rvir as jax_solve_rvir  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine.derived import compute_derived  # noqa: E402
from so_tpu_torch.engine.multi import solve_rvir_multi  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402
from so_tpu_torch.engine.recenter import recenter_most_bound  # noqa: E402
from so_tpu_torch.engine.solver import solve_rvir  # noqa: E402
from so_tpu_torch.io.tipsy import DARK, GAS, MARK, STAR  # noqa: E402
from so_tpu_torch.ops import gather, piece_gather, slab_gather  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402

FULL = ("mass", "mvx", "mvy", "mvz", "meta")


def _experiment():
    spec = importlib.util.spec_from_file_location(
        "pallas_piece_dma", os.path.join(ROOT, "experiments",
                                         "pallas_piece_dma.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _grid(n, m, seed=3):
    """A clumpy box: the clump's cells hold runs of many chunks, the
    background's runs of one."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[: n // 3] = ((rng.normal(scale=0.03, size=(n // 3, 3)) + 0.5) % 1.0
                     - 0.5).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], n).astype(np.int32)
    mark = rng.uniform(size=n) < 0.3
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=m,
                      device="cpu")
    return grid, rng


def _balls(rng, B, rmax=0.45):
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[0] = 0.0                       # on the clump
    centers[1] = (0.49, 0.49, 0.49)        # the last Morton cells
    centers[2] = (0.49, -0.5, 0.5)         # across the periodic faces
    radii = rng.uniform(0.1, rmax, B).astype(np.float32)
    return torch.as_tensor(centers), torch.as_tensor(radii)


def _runs(grid, centers, radii, chunk, level=0, S=4):
    return gather.cell_ranges(grid, level, centers, radii, radii * radii, S,
                              align=chunk)


def _bits(x):
    return x.numpy().view(np.int32) if x.dtype == torch.float32 else x.numpy()


@pytest.mark.parametrize("K", [512, 8192])
def test_piece_descriptors_match_experiment(K):
    """Entry for entry, spill included: K=512 drops pieces past NP."""
    exp = _experiment()
    grid, rng = _grid(3000, 2)
    centers, radii = _balls(rng, 6)
    st, cnt, q, _ = _runs(grid, centers, radii, exp.CHUNK)
    got = piece_gather.piece_descriptors(st, cnt, q, K, exp.CHUNK)
    want = exp.piece_descriptors(*(jnp.asarray(x.numpy().astype(np.int32))
                                   for x in (st, cnt, q)), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    nch = -(-(st % 256 + cnt) // 256) * (cnt > 0)
    pieces = ((nch + 1) // 2).sum(dim=1)
    assert (pieces > (K + 256) // 256).any() == (K == 512)
    assert torch.equal(got[-1], torch.clamp(nch.sum(dim=1),
                                            max=(K + 256) // 256))


def test_piece_gather_plain_matches_experiment():
    """The experiment's kernel in interpret mode, B=4, K=8192, chunk 256."""
    exp = _experiment()
    grid, rng = _grid(3000, 2)
    B, K, n = 4, 8192, grid.n
    centers, radii = _balls(rng, B)
    st, cnt, q, _ = _runs(grid, centers, radii, exp.CHUNK)
    soa = grid.soa8t.numpy()
    meta = soa[7, :n].astype(np.int32)
    esoa = exp.pack_soa8t(jnp.asarray(soa[0:3, :n].T), jnp.asarray(soa[3, :n]),
                          jnp.asarray(soa[4:7, :n].T), jnp.asarray(meta & 0xF),
                          jnp.asarray(meta >> 4))
    out = np.asarray(exp.pallas_slab_gather(
        esoa, *(jnp.asarray(x.numpy().astype(np.int32)) for x in (st, cnt, q)),
        jnp.asarray(centers.numpy()), jnp.asarray(grid.period.numpy()),
        jnp.asarray((radii * radii).numpy()), K))
    d2, ch, idx = piece_gather.piece_gather_plain(
        grid.soa8t, *piece_gather.piece_descriptors(st, cnt, q, K, exp.CHUNK),
        centers, grid.period, radii * radii, K, exp.CHUNK, FULL, True)
    d2, ch, idx = d2.numpy(), ch.numpy(), idx.numpy()
    ib = np.isfinite(d2)
    np.testing.assert_array_equal(np.isfinite(out[:, 0]), ib)
    assert ib.sum(axis=1).min() > 0
    np.testing.assert_array_equal(out[:, 1:6].view(np.int32), ch.view(np.int32))
    eidx = np.asarray(exp.decode_idx(jnp.asarray(out[:, 6]),
                                     jnp.asarray(out[:, 7])))
    np.testing.assert_array_equal(np.where(ib, eidx, -1), idx)
    x = soa[0:3].T
    p = grid.period.numpy()
    differ = 0
    for b in range(B):
        rows, c = idx[b][ib[b]], centers.numpy()[b]
        k1 = (c - p * np.round((c - x[rows]) / p)) - x[rows]
        per_op = k1[:, 0] * k1[:, 0] + k1[:, 1] * k1[:, 1] + k1[:, 2] * k1[:, 2]
        d = c - x[rows]
        d = d - p * np.round(d / p)
        fused = fma32(d[:, 2], d[:, 2], fma32(d[:, 0], d[:, 0], d[:, 1] * d[:, 1]))
        np.testing.assert_array_equal(d2[b][ib[b]].view(np.int32),
                                      per_op.view(np.int32))
        np.testing.assert_array_equal(out[b, 0][ib[b]].view(np.int32),
                                      fused.view(np.int32))
        differ += int((per_op != fused).sum())
    assert differ > 0        # the two associations are not the same function


@pytest.mark.parametrize("chans,want_idx", [((), False), (("mass",), False),
                                            (("mass", "meta"), True),
                                            (FULL, True)],
                         ids=["d2", "mass", "mass_meta_idx", "full_idx"])
@pytest.mark.parametrize("n,m,chunk", [(3000, 3, 128), (3000, 2, 256)],
                         ids=["chunk128", "chunk256"])
def test_piece_gather_plain_equals_k1_plain(n, m, chunk, chans, want_idx):
    """Bit for bit over the same cell_ranges: runs shorter and longer than
    a piece, pieces past NP (K=256), the payload's last rows, and K's
    that cut a piece (K not a multiple of PIECE_W * chunk)."""
    grid, rng = _grid(n, m, seed=5)
    centers, radii = _balls(rng, 8)
    st, cnt, q, total = _runs(grid, centers, radii, chunk, level=0, S=4)
    nch = -(-(st % chunk + cnt) // chunk) * (cnt > 0)
    assert ((nch == 1).any(dim=1) & (nch >= 3).any(dim=1)).any()
    assert ((st + cnt) == grid.n).any()                  # the last rows
    for K in (256, 1536, 2 * n):
        NC = (K + chunk) // chunk
        a = slab_gather.slab_gather_plain(
            grid.soa8t, *slab_gather.chunk_descriptors(st, cnt, q, K, chunk),
            centers, grid.period, radii * radii, K, chunk, chans, want_idx)
        desc = piece_gather.piece_descriptors(st, cnt, q, K, chunk)
        b = piece_gather.piece_gather_rows(
            grid.soa8t, *desc, centers, grid.period, radii * radii, K, chunk,
            chans, want_idx)
        assert ((nch + 1) // 2).sum(dim=1).max() > NC or K > 256
        assert (total > K).any() == (K < 2 * n)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(_bits(x), _bits(y))


def _counting(monkeypatch):
    """Lower PIECE_K_MIN so every dispatch above 512 slots takes K3, and
    count those dispatches (on the CPU the kernels' launch counters stay
    at 0: only the plain versions run)."""
    calls = []
    real = gather.piece_gather_rows

    def counted(*a):
        calls.append(a[11])          # K (gather.unsorted_gather's call)
        return real(*a)

    monkeypatch.setattr(gather, "PIECE_K_MIN", 512)
    monkeypatch.setattr(gather, "piece_gather_rows", counted)
    return calls


@pytest.mark.parametrize("name", ["general", "uniform"])
def test_giant_tier_solve_matches_so_tpu(name, monkeypatch):
    """so_tpu's solve (slab payload, Pallas interpret mode) against the
    port's with K3 serving every dispatch of more than 512 slots."""
    make, seed, uniform, codes = BOXES[name]
    data, centers, rgtp, thr = make(seed, uniform)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3,
                                         pallas=True),
                          centers, rgtp, thr)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    calls = _counting(monkeypatch)
    got = solve_rvir(grid, centers, rgtp, thr)
    assert len(calls) > 0 and min(calls) > 512
    assert set(codes) <= set(got.code.tolist())
    for f in ("code", "mvir", "rvir", "j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


def test_giant_route_serves_every_path(monkeypatch):
    """The pipeline (solve, fused members + derived), -pot, the multi
    solve with the survey classify, and the resume path's derived pass,
    through K3: the same bits as through K1 alone."""
    ps, catalog = _box(False)
    species = (DARK, GAS, STAR, MARK)

    def everything():
        runs = [run_so(ps, catalog(), SOParams(threshold=178.0,
                                               species=species, b_pot=pot,
                                               device="cpu"))
                for pot in (False, True)]
        grid = build_grid(ps.pos, ps.mass, vel=ps.vel, phi=ps.phi,
                          ptype=ps.ptype_all(), mark=ps.mark, device="cpu")
        cat = catalog()
        multi = solve_rvir_multi(grid, cat.pos, cat.rgtp, (178.0, 500.0),
                                 survey=True)
        centers = recenter_most_bound(grid, cat.pos, cat.rgtp, k0_cap=1024)
        ok = runs[0].solve.code == 0
        der = compute_derived(grid, cat.pos, runs[0].solve.rvir,
                              runs[0].solve.mvir, ok, species=species)
        return runs, multi, centers, der

    k1 = everything()
    calls = _counting(monkeypatch)
    k3 = everything()
    assert len(calls) >= 6
    for a, b in zip(k1[0], k3[0]):
        assert (a.solve.code == 0).sum() >= 3
        for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
            np.testing.assert_array_equal(getattr(a.solve, f),
                                          getattr(b.solve, f))
        for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir"):
            np.testing.assert_array_equal(getattr(a.conflicts, f),
                                          getattr(b.conflicts, f))
        for f in ("vcirc", "rmass", "rmax", "vmax"):
            np.testing.assert_array_equal(getattr(a.derived, f),
                                          getattr(b.derived, f))
        for sp in species:
            np.testing.assert_array_equal(a.derived.profiles[sp],
                                          b.derived.profiles[sp])
        np.testing.assert_array_equal(a.catalog.pos, b.catalog.pos)
        for ma, mb in zip(a.members, b.members):
            assert (ma is None) == (mb is None)
            if ma is not None:
                np.testing.assert_array_equal(ma, mb)
    for f in ("code", "mvir", "rvir", "j", "d2cut"):
        np.testing.assert_array_equal(getattr(k1[1], f), getattr(k3[1], f))
    np.testing.assert_array_equal(k1[2], k3[2])
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        np.testing.assert_array_equal(getattr(k1[3], f), getattr(k3[3], f))
