"""Kernels K1 (csrc/slab_gather.cu) and K2 (csrc/seqsum.cu) on the card.

Every test needs a CUDA device and skips without one. Each kernel is
held against its plain torch version on the same CUDA tensors, and
against the CPU run of that plain version: all must agree bit for bit
(the kernels are built with -fmad=false and use rintf/__fdiv_rn, the
plain versions run one elementwise torch op at a time).

This file imports no jax, so it also runs where jax is not installed:
    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_kernels.py
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from so_tpu_torch.ops import seqsum, slab_gather  # noqa: E402
from so_tpu_torch.ops.gather import cell_ranges  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402

pytestmark = pytest.mark.cuda

FULL = ("mass", "mvx", "mvy", "mvz", "meta")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _box(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # a dense clump so some cells hold several chunks
    k = n // 3
    pos[:k] = ((rng.normal(scale=0.04, size=(k, 3)) + 0.5) % 1.0
               - 0.5).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], n).astype(np.int32)
    mark = rng.uniform(size=n) < 0.3
    return rng, pos, mass, vel, ptype, mark


def _descriptors(grid, centers, radii, K, S, level):
    st, cnt, q, total = cell_ranges(grid, level, centers, radii,
                                    radii * radii, S, align=grid.chunk)
    return slab_gather.chunk_descriptors(st, cnt, q, K, grid.chunk), total


@pytest.mark.parametrize("chans", [("mass",), ("mass", "meta"), FULL])
@pytest.mark.parametrize("n", [20000, 40000])   # chunk 128, then 256
def test_k1_matches_plain(dev, n, chans):
    rng, pos, mass, vel, ptype, mark = _box(1, n)
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                      device=dev)
    assert grid.chunk == (128 if n == 20000 else 256)
    B, K, S, level = 64, 8192, 5, 1
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3))
                              .astype(np.float32), device=dev)
    centers[:8] = 0.0                       # inside the clump
    radii = torch.as_tensor(rng.uniform(0.03, 0.12, B).astype(np.float32),
                            device=dev)
    (a0, lo, hi, nt), total = _descriptors(grid, centers, radii, K, S, level)
    args = (grid.soa8t, a0, lo, hi, nt, centers, grid.period, radii * radii,
            K, grid.chunk, chans, True)
    n0 = slab_gather.launches
    d2, ch, idx = slab_gather.slab_gather_rows(*args)
    torch.cuda.synchronize()
    assert slab_gather.launches == n0 + 1
    pd2, pch, pidx = slab_gather.slab_gather_plain(*args)
    assert slab_gather.launches == n0 + 1   # the plain version never counts
    # overflowing rows too: both versions fill the same first K slots
    assert (total <= K).any()
    for got, want in ((d2, pd2), (ch, pch), (idx, pidx)):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.cpu().numpy().view(np.int32))
    # the same plain version on the CPU gives the same bits
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
    cd2, cch, cidx = slab_gather.slab_gather_plain(*cpu)
    np.testing.assert_array_equal(d2.cpu().numpy().view(np.int32),
                                  cd2.numpy().view(np.int32))
    np.testing.assert_array_equal(ch.cpu().numpy().view(np.int32),
                                  cch.numpy().view(np.int32))
    np.testing.assert_array_equal(idx.cpu().numpy(), cidx.numpy())


def test_k1_rejects_bad_payload(dev):
    soa = torch.zeros((8, 300), device=dev)[:, ::2]     # not contiguous
    z = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        slab_gather.slab_gather_rows(
            soa, z, z, z, torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros((1, 3), device=dev), torch.ones(3, device=dev),
            torch.ones(1, device=dev), 128, 128)


@pytest.mark.parametrize("shape", [(1, 1), (300, 4096), (4096, 257)])
def test_k2_matches_plain(dev, shape):
    rng = np.random.default_rng(7)
    x_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    n0 = seqsum.launches
    y = seqsum.seq_cumsum(x)
    torch.cuda.synchronize()
    assert seqsum.launches == n0 + 1
    want = np.cumsum(x_np, axis=1, dtype=np.float32)
    np.testing.assert_array_equal(y.cpu().numpy().view(np.int32),
                                  want.view(np.int32))
    if shape[1] <= 512:     # the plain torch loop on the card, column by column
        p = seqsum.seq_cumsum_plain(x)
        np.testing.assert_array_equal(p.cpu().numpy().view(np.int32),
                                      want.view(np.int32))


def test_pipeline_cuda_matches_cpu(dev):
    """The whole single-threshold pipeline gives the same bits on the card
    and on the CPU (the stable row sort fixes the tie order on both)."""
    sys.path.insert(0, HERE)
    from fixtures import make_clumpy_box
    from so_tpu.io.catalogs import GroupCatalog
    from so_tpu.io.tipsy import DARK, GAS, STAR, ParticleSet, TipsyHeader
    from so_tpu_torch.engine.pipeline import SOParams, run_so

    rng = np.random.default_rng(12)
    clumps = [dict(center=(0.1, 0.1, 0.1), n=2000, rmax=0.07,
                   mass_total=0.2),
              dict(center=(0.12, 0.1, 0.1), n=600, rmax=0.03,
                   mass_total=0.04),
              dict(center=(-0.3, 0.2, 0.4), n=900, rmax=0.05,
                   mass_total=0.08)]
    data = make_clumpy_box(rng, n_background=8000, clumps=clumps)
    n = data["pos"].shape[0]
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=n // 5,
                      ndark=n - n // 5 - n // 7, nstar=n // 7)
    ps = ParticleSet(hdr, data["pos"], data["vel"], data["mass"],
                     data["phi"], np.zeros(n, np.float32))
    G = 3

    def cat():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=np.array([c["center"] for c in clumps],
                                         np.float32),
                            rgtp=np.asarray([0.05, 0.02, 0.04], np.float32),
                            gtp_mass=np.asarray([0.2, 0.01, 0.08],
                                                np.float32),
                            n_in_gtp=G, gtp_time=1.0)

    sp = (DARK, GAS, STAR)
    k0, s0 = slab_gather.launches, seqsum.launches
    g = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
    assert slab_gather.launches > k0 and seqsum.launches > s0
    c = run_so(ps, cat(), SOParams(species=sp, device="cpu"))
    assert (g.solve.code == 0).all()
    for a, b in ((g.solve.mvir, c.solve.mvir), (g.solve.d2cut, c.solve.d2cut),
                 (g.solve.j, c.solve.j), (g.solve.vcm, c.solve.vcm),
                 (g.conflicts.igrp, c.conflicts.igrp),
                 (g.conflicts.n_ignored, c.conflicts.n_ignored),
                 (g.derived.vcirc, c.derived.vcirc),
                 (g.derived.rmass, c.derived.rmass),
                 (g.derived.vmax, c.derived.vmax)):
        assert a.tobytes() == b.tobytes()
    for s in sp:
        assert g.derived.profiles[s].tobytes() == c.derived.profiles[s].tobytes()


def test_cuda_sqrt_and_div_are_correctly_rounded(dev):
    """The port leaves +, -, *, / and sqrt on the card to torch: they must
    round like numpy (IEEE), as the CPU path does (ops/ieee.py)."""
    from so_tpu_torch.ops.ieee import sqrt_rn

    rng = np.random.default_rng(3)
    a = rng.uniform(0.0, 1.0, 1 << 22).astype(np.float32)
    b = rng.uniform(0.01, 1.0, 1 << 22).astype(np.float32)
    ta, tb = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    for got, want in ((sqrt_rn(ta), np.sqrt(a)), (ta / tb, a / b),
                      (ta * tb, a * b), (ta - tb, a - b)):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.view(np.int32))
