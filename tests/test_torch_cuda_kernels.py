"""Kernels K1 (csrc/slab_gather.cu, its slotted and its sorted form), K2
(csrc/seqsum.cu), K3 (csrc/piece_gather.cu) and the cell enumeration
(csrc/cell_ranges.cu) on the card.

Every test needs a CUDA device and skips without one. Each kernel is
held against its plain torch version on the same CUDA tensors, and
against the CPU run of that plain version: all must agree bit for bit
(the kernels are built with -fmad=false and use rintf/__fdiv_rn, the
plain versions run one elementwise torch op at a time); K3 equals K1.
The paths that call them (the pipeline, -pot recentring, the
multi-threshold solve and the survey pre-pass, and the giant tiers
through K3) must give the same bits on the card and the CPU.

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

from so_tpu_torch.ops import gather, ranges, seqsum, slab_gather  # noqa: E402
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


@pytest.mark.parametrize("chans,want_idx", [((), False), (("mass",), False),
                                            (FULL, True)])
@pytest.mark.parametrize("n", [20000, 40000])   # chunk 128, then 256
def test_k3_matches_plain_and_k1(dev, n, chans, want_idx):
    """K3 against its plain version (card and CPU) and against K1, bit for
    bit, at giant capacities: K cut mid-piece, and K small enough that
    the large balls' pieces run past NP."""
    _k3_check(dev, n, chans, want_idx)


@pytest.mark.parametrize("chans,want_idx", [(("mass",), False),
                                            (FULL, True)])
@pytest.mark.parametrize("n", [20001, 40003])   # chunk 128, then 256
def test_k3_payload_stride_padded(dev, n, chans, want_idx):
    """N + chunk odd: the payload's rows are padded to a multiple of 32
    floats, and K3 still equals its plain version and K1."""
    from so_tpu_torch.ops.grid import payload_width

    grid = _k3_check(dev, n, chans, want_idx)
    assert (n + grid.chunk) % 4 != 0
    assert grid.soa8t.shape[1] == payload_width(n + grid.chunk)


@pytest.mark.parametrize("pieces", [4, 8, 16, 32])
def test_k3_every_pieces_a_block(dev, pieces, monkeypatch):
    """Each pieces a block the wrapper picks from, forced: the same bits."""
    from so_tpu_torch.ops import piece_gather

    monkeypatch.setattr(piece_gather, "pieces_per_block",
                        lambda B, NP, n_sm: pieces)
    _k3_check(dev, 40003, FULL, True)


def test_k3_rejects_unaligned_payload(dev):
    """A row stride that is not a multiple of 4 floats, or a base off 16
    bytes, is refused on the card, never read another way."""
    from so_tpu_torch.ops import piece_gather

    rng, pos, mass, vel, ptype, mark = _box(2, 20001)
    grid = build_grid(pos, mass, m=4, device=dev)
    B, S, level, K = 2, 4, 2, 3000
    centers = torch.zeros((B, 3), device=dev)
    radii = torch.full((B,), 0.3, device=dev)
    st, cnt, q, _ = cell_ranges(grid, level, centers, radii, radii * radii,
                                S, align=grid.chunk)
    desc = piece_gather.piece_descriptors(st, cnt, q, K, grid.chunk)
    tail = (centers, grid.period, radii * radii, K, grid.chunk)
    W = grid.soa8t.shape[1]
    narrow = grid.soa8t[:, :W - 1].contiguous()           # stride W - 1
    off = torch.empty(8 * W + 1, device=dev)[1:].view(8, W)
    off.copy_(grid.soa8t)                                  # base + 4 bytes
    n0 = piece_gather.launches
    for soa in (narrow, off):
        with pytest.raises(ValueError):
            piece_gather.piece_gather_rows(soa, *desc, *tail)
    with pytest.raises(ValueError):                        # int64
        piece_gather.piece_gather_rows(grid.soa8t,
                                       *(d.long() for d in desc), *tail)
    assert piece_gather.launches == n0


def _k3_check(dev, n, chans, want_idx):
    """K3 on the card against its plain version there and on the CPU and
    against K1, at K = 3000, n + 77 and 3n; returns the grid."""
    from so_tpu_torch.ops import piece_gather

    rng, pos, mass, vel, ptype, mark = _box(2, n)
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                      device=dev)
    B, S, level = 8, 4, 2                   # 4^3 cells: the whole box
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3))
                              .astype(np.float32), device=dev)
    centers[:2] = 0.0
    radii = torch.as_tensor(rng.uniform(0.1, 0.45, B).astype(np.float32),
                            device=dev)
    st, cnt, q, total = cell_ranges(grid, level, centers, radii,
                                    radii * radii, S, align=grid.chunk)
    for K in (3000, n + 77, 3 * n):
        desc = piece_gather.piece_descriptors(st, cnt, q, K, grid.chunk)
        args = (grid.soa8t, *desc, centers, grid.period, radii * radii, K,
                grid.chunk, chans, want_idx)
        n0 = piece_gather.launches
        got = piece_gather.piece_gather_rows(*args)
        torch.cuda.synchronize()
        assert piece_gather.launches == n0 + 1
        plain = piece_gather.piece_gather_plain(*args)
        cpu = piece_gather.piece_gather_plain(
            *[x.cpu() if torch.is_tensor(x) else x for x in args])
        k1 = slab_gather.slab_gather_rows(
            grid.soa8t, *slab_gather.chunk_descriptors(st, cnt, q, K,
                                                       grid.chunk),
            centers, grid.period, radii * radii, K, grid.chunk, chans,
            want_idx)
        assert piece_gather.launches == n0 + 1
        assert (total > K).any() or K > 3000
        assert (total <= K).all() or K < 3 * n
        for want in (plain, cpu, k1):
            for a, b in zip(got, want):
                if a is None:
                    assert b is None
                    continue
                a, b = a.cpu(), b.cpu()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                assert torch.equal(a, b)
    return grid


def test_k1_rejects_bad_payload(dev):
    soa = torch.zeros((8, 300), device=dev)[:, ::2]     # not contiguous
    z = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    tail = (torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros((1, 3), device=dev), torch.ones(3, device=dev),
            torch.ones(1, device=dev), 128, 128)
    for fn in (slab_gather.slab_gather_rows,
               slab_gather.slab_gather_sorted_rows):
        with pytest.raises(ValueError):
            fn(soa, z, z, z, *tail)
        with pytest.raises(ValueError):                 # int64 descriptors
            fn(soa.contiguous(), z.long(), z.long(), z.long(), *tail)


def _assert_sorted_equal(got, want, tag):
    """(d2, channels, idx, n_in) of the sorted form, bit for bit."""
    assert len(got[1]) == len(want[1]), tag
    pairs = [(got[0], want[0]), (got[3], want[3])] + list(zip(got[1], want[1]))
    if want[2] is None:
        assert got[2] is None, tag
    else:
        pairs.append((got[2], want[2]))
    for a, b in pairs:
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, tag
        assert a.is_contiguous(), tag
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), tag


def _sorted_check(args, tag):
    """The sorted kernel against its plain version on the card and on the
    CPU; one launch, counted under both counters."""
    n0, s0 = slab_gather.launches, slab_gather.sorted_launches
    got = slab_gather.slab_gather_sorted_rows(*args)
    torch.cuda.synchronize()
    assert (slab_gather.launches, slab_gather.sorted_launches) \
        == (n0 + 1, s0 + 1)
    _assert_sorted_equal(got, slab_gather.slab_gather_sorted_plain(*args),
                         tag + " (card plain)")
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in args]
    _assert_sorted_equal(got, slab_gather.slab_gather_sorted_plain(*cpu),
                         tag + " (CPU plain)")
    assert (slab_gather.launches, slab_gather.sorted_launches) \
        == (n0 + 1, s0 + 1)
    return got


@pytest.mark.parametrize("chans,want_idx", [((), False), ((), True),
                                            (("mass",), False),
                                            (("mass", "meta"), True),
                                            (FULL, True)])
@pytest.mark.parametrize("n", [20000, 40000])   # chunk 128, then 256
def test_k1_sorted_matches_plain(dev, n, chans, want_idx):
    """The sorted form at K from 512 to SORTED_K_MAX and at odd K, with
    duplicate particles (equal d2 must come out in slot order), an empty
    ball, and balls whose chunks overflow K."""
    from so_tpu_torch.ops.gather import SORTED_K_MAX

    rng, pos, mass, vel, ptype, mark = _box(3, n)
    pos[n // 2: n // 2 + 40] = pos[0]          # 41 particles at one point
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                      device=dev)
    B, S, level = 64, 5, 1
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3))
                              .astype(np.float32), device=dev)
    centers[:8] = torch.as_tensor(pos[0], device=dev)   # on the duplicates
    radii = torch.as_tensor(rng.uniform(0.03, 0.12, B).astype(np.float32),
                            device=dev)
    radii[:4] = 0.01            # small enough to keep the duplicates
    radii[9] = 1e-6                                     # an empty ball
    for K in (512, 1023, 2050, 4096, SORTED_K_MAX):
        desc, total = _descriptors(grid, centers, radii, K, S, level)
        args = (grid.soa8t, *desc, centers, grid.period, radii * radii, K,
                grid.chunk, chans, want_idx)
        d2, _, _, n_in = _sorted_check(args, f"K={K}")
        n_in = n_in.cpu().numpy()
        assert n_in[9] == 0 and n_in.max() > 100
        assert (total > K).any() or K > 4096
        if int(total[0]) <= K:                          # the ties, if kept
            row = d2[0, :n_in[0]].cpu().numpy()
            assert (np.diff(row) == 0).sum() >= 40
        else:
            assert K < 2050


@pytest.mark.parametrize("K", [512, 777, 4096, 1 << 14])
@pytest.mark.parametrize("chunk", [128, 256])
def test_k1_sorted_full_rows(dev, K, chunk):
    """Descriptors made by hand so that every slot is a hit (n_in = K,
    shared memory full) or none is, over a payload of few distinct
    positions (long runs of equal d2)."""
    rng = np.random.default_rng(K + chunk)
    npay = 3 * K + chunk
    soa = torch.as_tensor(rng.uniform(-0.5, 0.5, (8, npay))
                          .astype(np.float32), device=dev)
    soa[:3] = torch.round(soa[:3] * 4) / 4              # 5^3 positions
    B, NC = 6, (K + chunk) // chunk
    a0 = torch.as_tensor(rng.integers(0, 2 * K // chunk, (B, 1)) * chunk,
                         dtype=torch.int32, device=dev).expand(B, NC) \
        .contiguous()
    lo = torch.zeros((B, NC), dtype=torch.int32, device=dev)
    hi = torch.full((B, NC), npay, dtype=torch.int32, device=dev)
    n_total = torch.full((B,), NC, dtype=torch.int32, device=dev)
    n_total[4] = 0                                      # no live chunk
    centers = torch.zeros((B, 3), device=dev)
    r2 = torch.full((B,), 10.0, device=dev)
    r2[5] = -1.0                                        # live, no hit
    for chans, want_idx in (((), False), (FULL, True)):
        args = (soa, a0, lo, hi, n_total, centers,
                torch.ones(3, device=dev), r2, K, chunk, chans, want_idx)
        got = _sorted_check(args, f"full K={K} chunk={chunk}")
        assert got[3].tolist() == [K, K, K, K, 0, 0]


@pytest.mark.parametrize("B", [1, 16384])
def test_k1_sorted_batch_sizes(dev, B):
    rng, pos, mass, vel, ptype, mark = _box(4, 40000)
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                      device=dev)
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 3))
                              .astype(np.float32), device=dev)
    radii = torch.as_tensor(rng.uniform(0.01, 0.05, B).astype(np.float32),
                            device=dev)
    desc, _ = _descriptors(grid, centers, radii, 512, 5, 2)
    args = (grid.soa8t, *desc, centers, grid.period, radii * radii, 512,
            grid.chunk, ("mass",), True)
    got = _sorted_check(args, f"B={B}")
    assert got[3].sum() > 0


def test_k1_sorted_refuses_rows_past_shared_memory(dev):
    """A row whose keys do not fit one block's shared memory is refused by
    the launch itself; nothing gives way to the plain version."""
    from so_tpu_torch.ops.gather import SORTED_K_MAX

    rng, pos, mass, vel, ptype, mark = _box(5, 20000)
    grid = build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                      device=dev)
    centers = torch.as_tensor(rng.uniform(-0.5, 0.5, (2, 3))
                              .astype(np.float32), device=dev)
    radii = torch.full((2,), 0.05, device=dev)
    K = SORTED_K_MAX + grid.chunk
    desc, _ = _descriptors(grid, centers, radii, K, 5, 2)
    n0 = slab_gather.launches
    with pytest.raises(RuntimeError):
        slab_gather.slab_gather_sorted_rows(
            grid.soa8t, *desc, centers, grid.period, radii * radii, K,
            grid.chunk)
    assert slab_gather.launches == n0


# both sides of rows_per_block's switch, K % 4 != 0, odd K, B not a
# multiple of the 32-row group, a giant row, the survey prefix's K = 16
K2_SHAPES = [(1, 1), (300, 4096), (4096, 257), (1000, 4097), (16384, 16),
             (600, 1022), (33, 4096), (8, 1 << 18), (3, 5)]


def _k2_cases(rng, B, K):
    """n_valid cases: none, 0, K, random (some past K)."""
    return {"none": None, "zero": np.zeros(B, np.int64),
            "K": np.full(B, K, np.int64),
            "random": rng.integers(0, K + K // 4 + 2, B)}


def _k2_check(x, x_np, cases, tag):
    """The picked form, then the single-chain walk and 32-row tiles forced
    through rows_per_block, against the plain version on the CPU."""
    pick = seqsum.rows_per_block
    for name, nv in cases.items():
        want = seqsum.seq_cumsum_plain(
            torch.as_tensor(x_np), None if nv is None
            else torch.as_tensor(nv)).numpy()
        tnv = None if nv is None else torch.as_tensor(nv, device=x.device)
        for rows in (None, 1, 32):
            with pytest.MonkeyPatch.context() as mp:
                if rows is not None:
                    mp.setattr(seqsum, "rows_per_block",
                               lambda B, K, n_sm, rows=rows: rows)
                n0 = seqsum.launches
                y = seqsum.seq_cumsum(x, n_valid=tnv)
                torch.cuda.synchronize()
            assert seqsum.launches == n0 + 1
            assert seqsum.rows_per_block is pick
            np.testing.assert_array_equal(
                y.cpu().numpy().view(np.int32), want.view(np.int32),
                err_msg=f"{tag} n_valid={name} rows={rows}")


@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_matches_plain(dev, shape):
    rng = np.random.default_rng(7)
    x_np = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    cases = _k2_cases(rng, *shape)
    _k2_check(x, x_np, cases, str(shape))
    if shape[1] <= 512:     # the plain torch loop on the card, column by column
        for nv in (None, cases["random"]):
            tnv = None if nv is None else torch.as_tensor(nv, device=dev)
            p = seqsum.seq_cumsum_plain(x, tnv)
            want = seqsum.seq_cumsum_plain(x.cpu(), None if nv is None
                                           else torch.as_tensor(nv))
            np.testing.assert_array_equal(p.cpu().numpy().view(np.int32),
                                          want.numpy().view(np.int32))


@pytest.mark.parametrize("K", [4096, 1023, 16])
def test_k2_unaligned_base(dev, K):
    """A row-offset view: the base is 4 bytes past a 16-byte boundary, so
    the kernel takes its 4-byte copies even where K % 4 == 0."""
    rng = np.random.default_rng(K)
    B = 70
    x_np = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    buf = torch.empty(B * K + 1, device=dev)
    x = buf[1:].view(B, K)
    x.copy_(torch.as_tensor(x_np))
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    _k2_check(x, x_np, _k2_cases(rng, B, K), f"offset view K={K}")


def test_k2_adversarial_rows(dev):
    """Rows whose bits change under any reassociation (alternating 1e8 and
    1.0, cancelling signs, many binades, subnormals, -0.0 first)."""
    rng = np.random.default_rng(77)
    K = 8192
    rows = [np.where(np.arange(K) % 2 == 0, 1e8, 1.0),
            np.where(np.arange(K) % 3 == 0, -1e8, 1.0)
            * rng.uniform(0.5, 1.5, K),
            np.exp2(rng.integers(-40, 40, K)) * rng.uniform(1, 2, K),
            rng.normal(size=K) * 1e7,
            rng.uniform(1e-45, 1e-38, K)]
    x_np = np.stack(rows * 8).astype(np.float32)     # 40 rows
    x_np[::5, 0] = -0.0
    x = torch.as_tensor(x_np, device=dev)
    _k2_check(x, x_np, _k2_cases(rng, *x_np.shape), "adversarial")
    assert not torch.equal(torch.cumsum(x, dim=1), seqsum.seq_cumsum(x))


# The cell enumeration: no kernel (None, ranges only), K1's sorted form
# (2^12), the K1/K3 boundary (2^15) and K3 (2^17, 2^21)
RANGE_KS = [None, 1 << 12, 1 << 15, 1 << 17, 1 << 21]


def _range_kernel(K):
    return None if K is None else gather._slotted_kernel(K)


def _range_grids(seed, chunk):
    """The same grid on the card and the CPU: 2^15 particles in the half
    x < 0 of the box, a clump among them, so balls on the other side are
    empty. Level 0 has 32 cells an axis, level 2 has 8."""
    rng = np.random.default_rng(seed)
    n = 1 << 15
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[:, 0] = rng.uniform(-0.5, 0.0, n).astype(np.float32)
    pos[: n // 3] = (rng.normal(scale=0.03, size=(n // 3, 3))
                     + (-0.25, 0.3, -0.45)).astype(np.float32)
    pos = ((pos + 0.5) % 1.0 - 0.5).astype(np.float32)
    grids = {d: build_grid(pos, np.ones(n, np.float32), m=5, chunk=chunk,
                           device=d) for d in ("cuda", "cpu")}
    return rng, grids


def _range_balls(rng, B, cs, S):
    """(centers, radii, r2_mask) f32: random balls; centers on the box's
    faces and just inside them (the periodic wrap); centers on cell
    corners with radii of whole cells (every edge of the cube exact);
    zero radii; and r2_mask -1 (nothing passes the pruning)."""
    half = max((S - 1) / 2, 0.5)
    c = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    r = rng.uniform(0.0, half * cs, B).astype(np.float32)
    k = B // 4
    c[:k] = rng.choice(np.array([-0.5, 0.5, np.nextafter(0.5, 0),
                                 np.nextafter(-0.5, 0), 0.0], np.float32),
                       (k, 3))
    corners = (rng.integers(0, int(round(1 / cs)), (k, 3)) * cs - 0.5)
    c[k:2 * k] = corners.astype(np.float32)
    r[k:2 * k] = (rng.integers(0, int(half) + 1, k) * cs).astype(np.float32)
    r[2 * k:2 * k + 2] = 0.0
    r2 = r * r
    r2[2 * k + 2:2 * k + 4] = -1.0
    return c, r, r2


def _ranges_equal(got, want, kernel):
    """The kernel's ranges and descriptors equal the plain version's where
    the plain version defines them: cnt, q, total everywhere, st where
    cnt > 0, the descriptor counts, and each descriptor below its halo's
    count."""
    (st, cnt, q, tot), desc = ((t.cpu().numpy() for t in got[0]), got[1])
    (pst, pcnt, pq, ptot), pdesc = ((t.cpu().numpy() for t in want[0]),
                                    want[1])
    for a, b in ((cnt, pcnt), (q, pq), (tot, ptot)):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    live = pcnt > 0
    np.testing.assert_array_equal(st[live], pst[live])
    if kernel is None:
        assert desc is None and pdesc is None
        return 0
    F = 5 if kernel == "K3" else 3
    assert len(desc) == len(pdesc) == F + (2 if kernel == "K3" else 1)
    for a, b in zip(desc, pdesc):
        assert a.dtype == b.dtype == torch.int32 and a.is_contiguous()
        assert a.shape == b.shape
    for a, b in zip(desc[F:], pdesc[F:]):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    n = pdesc[F].cpu().numpy()
    below = np.arange(desc[0].shape[1])[None, :] < n[:, None]
    for a, b in zip(desc[:F], pdesc[:F]):
        np.testing.assert_array_equal(a.cpu().numpy()[below],
                                      b.cpu().numpy()[below])
    return int(n.sum())


def _ranges_check(grids, level, c, r, r2, S, K):
    """slab_ranges on the card (the kernel, one launch) against its plain
    version on the card's tensors and on the CPU grid; returns the
    descriptors compared."""
    kernel = _range_kernel(K)
    g = grids["cuda"]
    args = [torch.as_tensor(a, device="cuda") for a in (c, r, r2)]
    n0, k0 = ranges.launches, ranges.counts[("ranges.kernel",)]
    got = ranges.slab_ranges(g, level, *args, S, g.chunk, K, kernel)
    torch.cuda.synchronize()
    assert ranges.launches == n0 + 1
    assert ranges.counts[("ranges.kernel",)] == k0 + 1
    plain = ranges.slab_ranges_plain(g, level, *args, S, g.chunk, K, kernel)
    assert ranges.launches == n0 + 1    # the plain version never counts
    _ranges_equal(got, plain, kernel)
    cpu = ranges.slab_ranges_plain(grids["cpu"], level,
                                   *(torch.as_tensor(a) for a in (c, r, r2)),
                                   S, g.chunk, K, kernel)
    return _ranges_equal(got, cpu, kernel)


@pytest.mark.parametrize("K", RANGE_KS, ids=lambda k: f"K{k}")
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6, 7])
def test_cell_ranges_kernel_matches_plain(dev, S, K):
    """At every cube side 1-7, on a fine level (32 cells an axis) and a
    coarse one (8, where the cube wraps the whole box), and every kind of
    launch: the kernel equals the plain version, on the card and on the
    CPU. Balls on the box's faces, on cell edges, empty and pruned."""
    rng, grids = _range_grids(100 + S, 128 if S % 2 else 256)
    n_desc = 0
    for level in (0, 2):
        cs = 1.0 / grids["cpu"].ncell(level)
        c, r, r2 = _range_balls(rng, 64, cs, S)
        n_desc += _ranges_check(grids, level, c, r, r2, S, K)
    assert K is None or n_desc > 0


@pytest.mark.parametrize("K", [1 << 12, 1 << 17], ids=["K1", "K3"])
@pytest.mark.parametrize("B", [1, 16384])
def test_cell_ranges_kernel_batch_sizes(dev, B, K):
    rng, grids = _range_grids(7, 128)
    c, r, r2 = _range_balls(rng, B, 1.0 / 32, 3)
    if B == 1:
        c[0], r[0], r2[0] = (-0.25, 0.3, -0.45), 0.05, 0.0025  # the clump
    assert _ranges_check(grids, 0, c, r, r2, 3, K) > 0


def test_cell_ranges_kernel_giant_rows(dev):
    """K3's longest rows: 8 balls of a third of the box over 2^21
    particles at K = 2^21 and 2^24, so each halo's pieces spread over
    several blocks (more than 2,048 a halo), where the balls overflow K
    and where they do not."""
    rng = np.random.default_rng(8)
    pos = rng.uniform(-0.5, 0.5, (1 << 21, 3)).astype(np.float32)
    grids = {d: build_grid(pos, np.ones(1 << 21, np.float32), m=5,
                           chunk=128, device=d) for d in ("cuda", "cpu")}
    c = rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32)
    r = rng.uniform(0.3, 0.4, 8).astype(np.float32)
    for K in (1 << 21, 1 << 24):
        assert _ranges_check(grids, 2, c, r, r * r, 7, K) > 8 * 2048


def test_cell_ranges_kernel_refuses_what_it_does_not_take(dev):
    rng, grids = _range_grids(9, 128)
    g = grids["cuda"]
    c, r, r2 = (torch.as_tensor(a, device="cuda")
                for a in _range_balls(rng, 8, 1.0 / 32, 3))
    with pytest.raises(ValueError):
        ranges.slab_ranges(g, 0, c.double(), r, r2, 3, g.chunk)
    with pytest.raises(ValueError):
        ranges.slab_ranges(g, 0, c.cpu(), r, r2, 3, g.chunk)
    with pytest.raises(ValueError):
        ranges.slab_ranges(g, 0, c, r, r2, 11, g.chunk)
    with pytest.raises(ValueError):
        ranges.slab_ranges(g, 0, c, r, r2, 3, g.chunk * 2, 4096, "K1")


def _pipeline_box():
    """A three-species clumpy box (11,500 particles) and a catalog factory
    of its 3 clump centers."""
    sys.path.insert(0, HERE)
    from fixtures import make_clumpy_box
    from so_tpu_torch.io.catalogs import GroupCatalog
    from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader

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
    return ps, cat


def test_pipeline_cuda_matches_cpu(dev):
    """The whole single-threshold pipeline gives the same bits on the card
    and on the CPU (the stable row sort fixes the tie order on both)."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so

    ps, cat = _pipeline_box()
    sp = (DARK, GAS, STAR)
    k0, s0 = slab_gather.launches, seqsum.launches
    f0 = slab_gather.sorted_launches
    g = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
    assert slab_gather.launches > k0 and seqsum.launches > s0
    assert slab_gather.sorted_launches > f0
    c = run_so(ps, cat(), SOParams(species=sp, device="cpu"))
    assert (g.solve.code == 0).all()
    # the same run with the sorted form off (the slotted kernel, then
    # torch.sort and the gathers) gives identical fields
    from so_tpu_torch.ops import gather
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather, "SORTED_K_MAX", 0)
        f0 = slab_gather.sorted_launches
        u = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
        assert slab_gather.sorted_launches == f0
    for a, b in ((g.solve.code, u.solve.code), (g.solve.mvir, u.solve.mvir),
                 (g.solve.rvir, u.solve.rvir), (g.solve.j, u.solve.j),
                 (g.solve.d2cut, u.solve.d2cut), (g.solve.vcm, u.solve.vcm),
                 (g.conflicts.igrp, u.conflicts.igrp),
                 (g.derived.vcirc, u.derived.vcirc),
                 (g.derived.rmass, u.derived.rmass),
                 (g.derived.rmax, u.derived.rmax),
                 (g.derived.vmax, u.derived.vmax)):
        assert a.tobytes() == b.tobytes()
    for ma, mb in zip(g.members, u.members):
        assert (ma is None) == (mb is None)
        assert ma is None or np.array_equal(ma, mb)
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


def _fields(run, sp):
    """Every output field of an SORun as bytes, and its member lists."""
    out = {f"solve.{f}": getattr(run.solve, f).tobytes()
           for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm")}
    out.update({f"conflicts.{f}": getattr(run.conflicts, f).tobytes()
                for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir")})
    out.update({f"derived.{f}": getattr(run.derived, f).tobytes()
                for f in ("vcirc", "rmass", "rmax", "vmax")})
    out.update({f"profile {s}": run.derived.profiles[s].tobytes()
                for s in sp})
    out["members"] = [None if m is None else m.tobytes()
                      for m in run.members]
    return out


@pytest.mark.parametrize("K", [1 << 15, 1 << 17], ids=["K1", "K3"])
def test_sort_in_ball_cuda_matches_cpu(dev, K):
    """gather.slab_gather above SORTED_K_MAX, at a capacity of the slotted
    K1 (2^15 slots) and of K3 (2^17): the card's rows equal the CPU's bit
    for bit, widths, duplicate particles' equal d2 and pads included; and
    the card's sort_in_ball of its own slotted rows equals the CPU's
    sort_in_ball of the same rows."""
    from so_tpu_torch.engine.solver import _pick_level_span
    from so_tpu_torch.ops import gather, piece_gather

    rng, pos, mass, vel, ptype, mark = _box(13, 40000)
    pos[100:140] = pos[100]                 # duplicates: equal d2
    grids = {d: build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark, m=4,
                           device=d) for d in ("cuda", "cpu")}
    B = 8
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[:3] = pos[100] + rng.normal(scale=0.01, size=(3, 3))
    radii = rng.uniform(0.05, 0.15, B).astype(np.float32)
    level, S = _pick_level_span(grids["cpu"], float(radii.max()))
    channels = ("mass", "mv", "meta", "idx")
    out = {}
    for d, g in grids.items():
        c, r = (torch.as_tensor(a, device=d) for a in (centers, radii))
        k1, k3 = slab_gather.launches, piece_gather.launches
        out[d] = gather.slab_gather(g, level, c, r, r * r, K, S, channels)
        if d == "cuda":
            assert (slab_gather.launches > k1) == (K <= gather.PIECE_K_MIN)
            assert (piece_gather.launches > k3) == (K > gather.PIECE_K_MIN)
            kernel = gather._slotted_kernel(K)
            ranges, desc = gather.slab_ranges(g, level, c, r, r * r, S,
                                              g.chunk, K, kernel)
            rows = gather._slotted(g, ranges, kernel, desc, c, r * r, K,
                                   ("mass", "meta"), True)
    got, want = out["cuda"], out["cpu"]
    n_in = want.n_in.numpy()
    assert n_in.max() > 1000 and got.d2.shape[1] < K
    np.testing.assert_array_equal(got.n_in.cpu().numpy(), n_in)
    assert got.d2.shape == want.d2.shape
    assert got.d2.cpu().numpy().tobytes() == want.d2.numpy().tobytes()
    for a, b in zip(got.channels, want.channels):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()
    d2w = want.d2.numpy()
    assert sum(int((np.diff(d2w[b, :n]) == 0).sum())
               for b, n in enumerate(n_in)) >= 39
    on_card = slab_gather.sort_in_ball(*rows)
    on_cpu = slab_gather.sort_in_ball(*(t.cpu() for t in rows))
    for a, b in zip((on_card[0], *on_card[1], *on_card[2:]),
                    (on_cpu[0], *on_cpu[1], *on_cpu[2:])):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_run_so_slotted_route_cuda_matches_default(dev, uniform):
    """run_so on the card with every sorted gather on the slotted route
    (SORTED_K_MAX = 0: the slotted kernels, then sort_in_ball's narrower
    rows) equals the default run in every field and member list, on
    general masses (K2) and on one mass (the capacity's ladder)."""
    import dataclasses

    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.ops import gather

    ps, cat = _pipeline_box()
    if uniform:
        ps = dataclasses.replace(ps, mass=np.full(ps.n, np.float32(1.0 / ps.n),
                                                  np.float32))
    sp = (DARK, GAS, STAR)
    g = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather, "SORTED_K_MAX", 0)
        f0 = slab_gather.sorted_launches
        u = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
        assert slab_gather.sorted_launches == f0
    assert (g.solve.code == 0).any()
    assert _fields(g, sp) == _fields(u, sp)


def _plain_ranges_on_the_card(grid, level, centers, radii, r2_mask, S,
                              align, K=None, kernel=None):
    """ranges.slab_ranges with the plain version in place of the kernel,
    on the card's tensors (and counted as it counts)."""
    ranges.counts[("ranges.calls",)] += 1
    return ranges.slab_ranges_plain(grid, level, centers, radii, r2_mask, S,
                                    align, K, kernel)


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_run_so_cell_ranges_kernel_matches_plain_and_cpu(dev, uniform):
    """run_so (with the survey's classify) on the card, every enumeration
    through the kernel, equals the same run with the plain enumeration on
    the card in every field and member list, and the CPU run in the
    fields the card and the CPU share (test_pipeline_cuda_matches_cpu)."""
    import dataclasses

    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so

    ps, cat = _pipeline_box()
    if uniform:
        ps = dataclasses.replace(ps, mass=np.full(ps.n, np.float32(1.0 / ps.n),
                                                  np.float32))
    sp = (DARK, GAS, STAR)
    params = dict(species=sp, survey=True)
    calls, kern = (ranges.counts[("ranges.calls",)],
                   ranges.counts[("ranges.kernel",)])
    n0 = ranges.launches
    g = run_so(ps, cat(), SOParams(device="cuda", **params))
    n_calls = ranges.counts[("ranges.calls",)] - calls
    assert n_calls > 0
    assert ranges.counts[("ranges.kernel",)] - kern == n_calls
    assert ranges.launches - n0 == n_calls
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather, "slab_ranges", _plain_ranges_on_the_card)
        n0 = ranges.launches
        p = run_so(ps, cat(), SOParams(device="cuda", **params))
        assert ranges.launches == n0
    assert (g.solve.code == 0).any()
    assert _fields(g, sp) == _fields(p, sp)
    c = run_so(ps, cat(), SOParams(device="cpu", **params))
    for a, b in ((g.solve.mvir, c.solve.mvir), (g.solve.d2cut, c.solve.d2cut),
                 (g.solve.j, c.solve.j), (g.solve.vcm, c.solve.vcm),
                 (g.conflicts.igrp, c.conflicts.igrp),
                 (g.conflicts.n_ignored, c.conflicts.n_ignored),
                 (g.derived.vcirc, c.derived.vcirc),
                 (g.derived.rmass, c.derived.rmass),
                 (g.derived.vmax, c.derived.vmax)):
        assert a.tobytes() == b.tobytes()
    for ma, mb in zip(g.members, c.members):
        assert (ma is None) == (mb is None)
        assert ma is None or np.array_equal(ma, mb)


def test_cuda_grid_never_takes_the_plain_enumeration(dev, monkeypatch):
    """With the plain enumeration and the torch descriptors made to fail,
    run_so on the card (survey, -pot recentring, the giant route through
    K3) still runs: a CUDA grid only ever launches the kernel."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.ops import piece_gather

    def refuse(*args, **kw):
        raise AssertionError("the plain enumeration ran on a CUDA grid")

    for mod, name in ((ranges, "cell_ranges_plain"),
                      (ranges, "slab_ranges_plain"),
                      (ranges, "chunk_descriptors"),
                      (ranges, "piece_descriptors"),
                      (gather, "cell_ranges_plain"),
                      (slab_gather, "chunk_descriptors"),
                      (piece_gather, "piece_descriptors")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(gather, "PIECE_K_MIN", 1024)
    ps, cat = _pipeline_box()
    k3, calls = piece_gather.launches, ranges.counts[("ranges.calls",)]
    kern = ranges.counts[("ranges.kernel",)]
    run = run_so(ps, cat(), SOParams(species=(DARK, GAS, STAR), survey=True,
                                     b_pot=True, device="cuda"))
    assert (run.solve.code == 0).any() and piece_gather.launches > k3
    n_calls = ranges.counts[("ranges.calls",)] - calls
    assert n_calls > 0
    assert ranges.counts[("ranges.kernel",)] - kern == n_calls


def test_grid_species_counts_cuda_matches_ptype_array(dev):
    """build_grid on the card given the header's counts (the species
    formed on the card) equals the card's and the CPU's builds given
    ParticleSet.ptype's array bit for bit, as does a 1x2 mesh of the card
    with a padded shard; the card's uniform-mass test is
    detect_uniform_mass's."""
    from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader
    from so_tpu_torch.ops.grid import (detect_uniform_mass,
                                       uniform_mass_on_device)
    from so_tpu_torch.parallel import make_mesh
    from so_tpu_torch.parallel.mesh import build_sharded_grid

    n = 40001
    _, pos, mass, vel, _, mark = _box(31, n)
    counts = (n // 5, n - n // 5 - n // 7, n // 7)
    ps = ParticleSet(TipsyHeader(1.0, n, 3, *counts), pos, vel, mass,
                     np.zeros(n, np.float32), np.zeros(n, np.float32), mark)
    kw = dict(vel=vel, mark=mark)

    def same(a, b):
        assert a.m == b.m and a.chunk == b.chunk
        assert a.uniform_mass == b.uniform_mass
        assert torch.equal(a.soa8t.cpu().view(torch.int32),
                           b.soa8t.cpu().view(torch.int32))
        assert torch.equal(a.orig_idx.cpu(), b.orig_idx.cpu())
        assert all(torch.equal(x.cpu(), y.cpu())
                   for x, y in zip(a.starts, b.starts))

    got = build_grid(pos, mass, species_counts=counts, device=dev, **kw)
    same(got, build_grid(pos, mass, ptype=ps.ptype_all(), device=dev, **kw))
    same(got, build_grid(pos, mass, ptype=ps.ptype_all(), device="cpu",
                         **kw))
    mesh = make_mesh(1, 2, devices=[dev] * 2)
    sg = build_sharded_grid(pos, mass, species_counts=counts, mesh=mesh,
                            **kw)
    sw = build_sharded_grid(pos, mass, ptype=ps.ptype_all(),
                            mesh=make_mesh(1, 2, devices=["cpu"] * 2), **kw)
    assert (sg.cells[0][1].orig_idx < 0).any()
    for a, b in zip(sg.cells[0], sw.cells[0]):
        same(a, b)
    for m in ([0.25] * 9, [0.25] * 8 + [0.2500001], [-0.0, 0.0],
              [0.5, float("nan")], [0.125], []):
        m = np.asarray(m, np.float32)
        want = detect_uniform_mass(m)
        v = uniform_mass_on_device(torch.as_tensor(m, device=dev))
        assert (v is None) == (want is None)
        assert v is None or np.float32(v).tobytes() == (
            np.float32(want).tobytes())


def test_mesh_cuda_matches_run_so_and_cpu(dev):
    """run_so_sharded on a 1x4 mesh of one card (the particles in 4
    shards, every gather merged over them) runs K1's sorted form and K2,
    and equals the card's run_so and the CPU's 1x4 run in every field."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.parallel import make_mesh, run_so_sharded

    ps, cat = _pipeline_box()
    sp = (DARK, GAS, STAR)
    f0, s0 = slab_gather.sorted_launches, seqsum.launches
    g = run_so_sharded(ps, cat(), SOParams(species=sp),
                       make_mesh(1, 4, devices=[dev] * 4))
    assert slab_gather.sorted_launches > f0 and seqsum.launches > s0
    assert (g.solve.code == 0).all()
    s = run_so(ps, cat(), SOParams(species=sp, device="cuda"))
    c = run_so_sharded(ps, cat(), SOParams(species=sp),
                       make_mesh(1, 4, devices=["cpu"] * 4))
    assert _fields(g, sp) == _fields(s, sp)
    assert _fields(g, sp) == _fields(c, sp)


def test_mesh_across_cards_matches_run_so(dev):
    """A mesh over several cards, as --mesh HxP takes them (the first H*P
    devices): 2x2 on four cards, else 1x2; every field equals run_so's on
    the first card. Skips with fewer than two cards."""
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.parallel import make_mesh, run_so_sharded

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh(*((2, 2) if n >= 4 else (1, 2)))
    ps, cat = _pipeline_box()
    sp = (DARK, GAS, STAR)
    f0, s0 = slab_gather.sorted_launches, seqsum.launches
    g = run_so_sharded(ps, cat(), SOParams(species=sp, b_pot=True), mesh)
    assert slab_gather.sorted_launches > f0 and seqsum.launches > s0
    s = run_so(ps, cat(), SOParams(species=sp, b_pot=True, device="cuda:0"))
    assert (g.solve.code == 0).all()
    assert _fields(g, sp) == _fields(s, sp)
    assert g.catalog.pos.tobytes() == s.catalog.pos.tobytes()


def test_distributed_across_cards_matches_run_so(dev, tmp_path):
    """--distributed over W ranks, one card a rank (W = 4 with four or
    more cards, else 2), NCCL for the card's tensors and gloo for host
    arrays (the CLI's default backend on a card), each rank reading its
    snapshot segment and running K1, K2 (and K3 where a tier needs it):
    every output file equals the one-process CLI's on cuda:0, the card's
    run_so, but for the run time. Skips with fewer than two cards."""
    import socket
    import subprocess

    from fixtures import write_gtp, write_snapshot
    from so_tpu_torch.cli import main

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    W = 4 if n >= 4 else 2
    ps, cat = _pipeline_box()
    d = str(tmp_path)
    h = ps.header
    write_snapshot(f"{d}/snap.bin", dict(pos=ps.pos, vel=ps.vel,
                                         mass=ps.mass, phi=ps.phi),
                   split=(h.nsph, h.ndark, h.nstar))
    c = cat()
    write_gtp(f"{d}/cat.gtp", c.pos, c.rgtp, c.gtp_mass)
    args = ["-i", f"{d}/cat.gtp", "--tipsy", f"{d}/snap.bin", "-grp",
            "-gtp", "-subsumed", "-ignored", "-all", "-pot"]
    # the one-process run builds the kernels before the ranks start
    assert main(args + ["-o", f"{d}/single", "--device", "cuda:0"]) == 0
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "so_tpu_torch", *args, "-o", f"{d}/dist",
         "--distributed", "--device", "cuda"], cwd=os.path.dirname(HERE),
        env=dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 WORLD_SIZE=str(W), RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(W)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
        assert f"rank {r} of {W} on cuda:{r}, backend cpu:gloo,cuda:nccl" \
            in out
    for ext in ("sovcirc", "sogrp", "sosub", "soign", "sogtp", "sodark",
                "sogas", "sostar"):
        got, want = ([ln for ln in open(f"{d}/{b}.{ext}", "rb")
                      if not (ln.startswith(b"# Run on")
                              or b"written to" in ln)]
                     for b in ("dist", "single"))
        assert got and got == want, ext


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


def test_recenter_cuda_matches_cpu(dev):
    """-pot recentring (K1 on the phi payload, unsorted argmin) picks the
    same particles on the card and on the CPU, escalation included."""
    from so_tpu_torch.engine.recenter import recenter_most_bound

    rng, pos, mass, vel, ptype, mark = _box(21, 30000)
    phi = rng.permutation(pos.shape[0]).astype(np.float32) * -1e-4  # distinct
    grid, cgrid = (build_grid(pos, mass, vel=vel, phi=phi, ptype=ptype,
                              mark=mark, device=d) for d in (dev, "cpu"))
    centers = rng.uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    centers[:8] = 0.0
    rgtp = rng.uniform(0.005, 0.08, 64).astype(np.float32)
    n0 = slab_gather.launches
    got = recenter_most_bound(grid, centers, rgtp, k0_cap=256)
    assert slab_gather.launches > n0 + 1          # escalated at least once
    want = recenter_most_bound(cgrid, centers, rgtp, k0_cap=256)
    assert got.tobytes() == want.tobytes()
    assert (got != centers).any(axis=1).sum() > 32


def test_multi_and_survey_cuda_match_cpu(dev):
    """The multi-threshold solve, and the single solve with the survey
    pre-pass forced, give the same bits on the card and on the CPU and
    equal the plain single solve per threshold."""
    from so_tpu_torch.engine import solver
    from so_tpu_torch.engine.multi import solve_rvir_multi

    thresholds = (178.0, 500.0)
    for uniform in (True, False):
        rng, pos, mass, _, _, _ = _box(5 + uniform, 30000)
        mass = (np.full_like(mass, np.float32(1.0 / mass.size)) if uniform
                else (mass / mass.size).astype(np.float32))
        grid = build_grid(pos, mass, device=dev)
        cgrid = build_grid(pos, mass, device="cpu")
        centers = rng.uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
        centers[:16] = rng.normal(scale=0.02, size=(16, 3))
        rgtp = rng.uniform(0.002, 0.06, 96).astype(np.float32)
        k0, s0 = slab_gather.launches, seqsum.launches
        got = solve_rvir_multi(grid, centers, rgtp, thresholds, survey=True)
        assert slab_gather.launches > k0
        assert uniform or seqsum.launches > s0
        want = solve_rvir_multi(cgrid, centers, rgtp, thresholds,
                                survey=True)
        assert {0, -1, -2} <= set(got.code.ravel().tolist())
        for f in ("code", "mvir", "rvir", "j", "d2cut"):
            assert getattr(got, f).tobytes() == getattr(want, f).tobytes()
        for t, thr in enumerate(thresholds):
            single = solver.solve_rvir(grid, centers, rgtp, thr,
                                       survey=False)
            for f in ("code", "mvir", "rvir", "j", "d2cut"):
                assert getattr(got, f)[t].tobytes() == \
                    getattr(single, f).tobytes(), f
        packed = solver._classify_stage(
            grid, 1, 4096, 5, 8, torch.as_tensor(centers, device=dev),
            torch.as_tensor(rgtp, device=dev), np.float32(thresholds))
        cpacked = solver._classify_stage(
            cgrid, 1, 4096, 5, 8, torch.as_tensor(centers),
            torch.as_tensor(rgtp), np.float32(thresholds))
        np.testing.assert_array_equal(packed, cpacked)


def test_giant_route_cuda_matches_cpu(dev, monkeypatch):
    """With gather.PIECE_K_MIN lowered, K3 serves the solve and the fused
    pass: the card and the CPU give the same bits, K3 launches and the
    results equal the K1 route's."""
    from so_tpu_torch.engine.pipeline import SOParams, run_so
    from so_tpu_torch.io.catalogs import GroupCatalog
    from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader
    from so_tpu_torch.ops import gather, piece_gather

    rng, pos, mass, vel, _, _ = _box(9, 30000)
    n = pos.shape[0]
    mass = (mass / n).astype(np.float32)
    ps = ParticleSet(TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=0,
                                 ndark=n, nstar=0), pos, vel, mass,
                     np.zeros(n, np.float32), np.zeros(n, np.float32))
    G = 24
    centers = rng.uniform(-0.5, 0.5, (G, 3)).astype(np.float32)
    centers[:6] = rng.normal(scale=0.01, size=(6, 3))
    gtp_mass = rng.uniform(0.1, 1.0, G).astype(np.float32)

    def cat():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=centers.copy(),
                            rgtp=np.full(G, 0.06, np.float32),
                            gtp_mass=gtp_mass, n_in_gtp=G, gtp_time=1.0)

    k1 = run_so(ps, cat(), SOParams(device="cuda"))
    monkeypatch.setattr(gather, "PIECE_K_MIN", 1024)
    n0 = piece_gather.launches
    g = run_so(ps, cat(), SOParams(device="cuda"))
    assert piece_gather.launches > n0
    c = run_so(ps, cat(), SOParams(device="cpu"))
    assert (g.solve.code == 0).sum() >= 4
    for run in (c, k1):
        for a, b in ((g.solve.mvir, run.solve.mvir),
                     (g.solve.j, run.solve.j),
                     (g.solve.d2cut, run.solve.d2cut),
                     (g.conflicts.igrp, run.conflicts.igrp),
                     (g.derived.vcirc, run.derived.vcirc),
                     (g.derived.rmass, run.derived.rmass)):
            assert a.tobytes() == b.tobytes()


def test_extract_members_cuda_matches_cpu(dev, monkeypatch):
    """engine.extract_members with gather.PIECE_K_MIN at 512, so K3 and
    sort_in_ball serve its balls: the card's member lists and vcm equal the
    CPU's, with and without cap_hint."""
    from so_tpu_torch.engine import extract_members, solve_rvir
    from so_tpu_torch.ops import gather, piece_gather

    ps, cat = _pipeline_box()
    c = cat()
    grids = {d: build_grid(ps.pos, ps.mass, vel=ps.vel, device=d)
             for d in ("cuda", "cpu")}
    s = solve_rvir(grids["cpu"], c.pos, c.rgtp, 178.0)
    ok = s.code == 0
    assert ok.all()
    args = (c.pos[ok], s.d2cut[ok], s.j[ok], s.mvir[ok])
    monkeypatch.setattr(gather, "PIECE_K_MIN", 512)
    for hint in (None, s.kcap[ok]):
        n0 = piece_gather.launches
        got, gv = extract_members(grids["cuda"], *args, cap_hint=hint)
        assert piece_gather.launches > n0
        want, wv = extract_members(grids["cpu"], *args, cap_hint=hint)
        assert gv.tobytes() == wv.tobytes()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [g.size for g in got] == s.j[ok].tolist()


def test_extract_members_sharded_cuda_matches_cpu(dev, monkeypatch):
    """parallel.extract_members_sharded on a 1x2 mesh of the card (K1's
    sorted form per shard), then with gather.PIECE_K_MIN at 512 (K3 and
    sort_in_ball): member lists and vcm equal the same call on a 1x2 CPU mesh
    and the CellGrid's extract_members on the card; host_mv is rebuilt
    from the shards."""
    from so_tpu_torch.engine import extract_members, solve_rvir
    from so_tpu_torch.ops import gather, piece_gather
    from so_tpu_torch.parallel import (build_sharded_grid,
                                       extract_members_sharded, make_mesh)

    ps, cat = _pipeline_box()
    c = cat()
    s = solve_rvir(build_grid(ps.pos, ps.mass, vel=ps.vel, device="cpu"),
                   c.pos, c.rgtp, 178.0)
    ok = s.code == 0
    args = (c.pos[ok], s.d2cut[ok], s.j[ok], s.mvir[ok])
    meshes = {d: make_mesh(1, 2, devices=[torch.device(d)] * 2)
              for d in ("cuda", "cpu")}
    sgrids = {d: build_sharded_grid(ps.pos, ps.mass, vel=ps.vel, mesh=m)
              for d, m in meshes.items()}
    single = build_grid(ps.pos, ps.mass, vel=ps.vel, device=dev)
    for piece_k_min in (gather.PIECE_K_MIN, 512):
        monkeypatch.setattr(gather, "PIECE_K_MIN", piece_k_min)
        k1, k3 = slab_gather.sorted_launches, piece_gather.launches
        got, gv = extract_members_sharded(meshes["cuda"], sgrids["cuda"],
                                          *args)
        if piece_k_min == 512:
            assert piece_gather.launches > k3
        else:
            assert slab_gather.sorted_launches > k1
        for want, wv in (extract_members_sharded(meshes["cpu"],
                                                 sgrids["cpu"], *args),
                         extract_members(single, *args)):
            assert gv.tobytes() == wv.tobytes()
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        assert [g.size for g in got] == s.j[ok].tolist()


@pytest.mark.parametrize("sort", [False, True], ids=["unsorted", "sorted"])
def test_ragged_ball_gather_cuda_matches_cpu(dev, sort):
    """ops.gather.ragged_ball_gather (plain torch, no kernel) on the card
    equals the CPU bit for bit: d2, idx, n_in and overflow, with some
    halos overflowing their 2048 slots."""
    from so_tpu_torch.ops.gather import ragged_ball_gather

    rng, pos, mass, vel, ptype, mark = _box(3, 40000)
    B, K, S, level = 256, 2048, 5, 1
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[:8] = 0.0
    radii = rng.uniform(0.03, 0.12, B).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        grid = build_grid(pos, mass, m=4, device=d)
        c, r = (torch.as_tensor(a, device=d) for a in (centers, radii))
        out[d.type] = ragged_ball_gather(grid, level, c, r, r * r, K, S,
                                         sort=sort)
    g, w = out["cuda"], out["cpu"]
    assert w.overflow.any() and not w.overflow.all()
    for a, b in zip(g, w):
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_scan_sorted_cuda_matches_cpu(dev, uniform):
    """engine.solver.scan_sorted on the card (K2 on general masses) equals
    the CPU's plain version bit for bit in found, jstar, mvir, rvir and
    d2cut; vcm within the f32 bound of two sums of its n = jstar terms in
    other orders, (n + 2) 2^-23 sum|m v| / Mvir (the card sums in another
    order)."""
    from so_tpu_torch.engine.solver import scan_sorted
    from so_tpu_torch.ops.gather import slab_gather as gather_sorted

    rng, pos, mass, vel, ptype, mark = _box(5, 40000)
    mass = (np.full_like(mass, 1.0) if uniform else mass) / np.float32(
        mass.size)                          # mean density 1
    B, K, S, level = 512, 4096, 5, 1
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[:16] = 0.0
    radii = rng.uniform(0.03, 0.08, B).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        grid = build_grid(pos, mass, vel=vel, m=4, device=d)
        c, r = (torch.as_tensor(a, device=d) for a in (centers, radii))
        sg = gather_sorted(grid, level, c, r, r * r, K, S, ("mass", "idx"))
        idx = sg.channels[1]
        vel_s = torch.where((idx >= 0)[..., None],
                            grid.vel_a()[idx.clamp(min=0).long()], 0.0)
        n0 = seqsum.launches
        out[d.type] = scan_sorted(sg.d2, sg.channels[0], vel_s, sg.n_in,
                                  178.0, 8, uniform_m=grid.uniform_mass)
        mass_s = sg.channels[0]
        if d.type == "cuda":
            assert (seqsum.launches > n0) == (not uniform)
    g, w = out["cuda"], out["cpu"]
    found = w["found"].numpy()
    assert found.any()
    for f in ("found", "jstar", "mvir", "rvir", "d2cut"):
        assert g[f].cpu().numpy().tobytes() == w[f].numpy().tobytes(), f
    n = w["jstar"][:, None].double()
    slot = torch.arange(mass_s.shape[1])[None, :]
    absum = (torch.where(slot < n, mass_s.double(), 0.0)[:, :, None]
             * vel_s.double().abs()).sum(dim=1)
    bound = ((n + 2) * 2.0 ** -23 * absum / w["mvir"][:, None]).numpy()
    diff = np.abs(g["vcm"].cpu().numpy() - w["vcm"].numpy())
    assert (diff[found] <= bound[found]).all()
