"""Kernel K3's plain version (ops/piece_gather.py) and the giant-tier route
on the CPU.

- piece_descriptors against the experiment's (experiments/pallas_piece_dma.py,
  imported by path), entry for entry, and its int32 form against the int64
  one it replaced.
- a numpy replay of the kernel's index arithmetic (block -> pieces ->
  4-column groups -> slots, its constants read from csrc/piece_gather.cu):
  every slot of every halo written once, by the (piece, column) that
  piece_gather_plain uses, each group's source column and slot a multiple
  of 4 and inside the payload; also index-only at B x K = 2^26.
- piece_gather_plain against the experiment's Pallas kernel in interpret
  mode: in-ball masks, channels and source rows equal; d2 held to a numpy
  witness of each side's association (the experiment's dx = c - x;
  dx - p*round(dx/p), with the sum fused as XLA:CPU fuses it; the port's
  K1 form, every op rounded).
- piece_gather_plain equal to K1's plain version bit for bit.
- solves and the pipeline with gather.PIECE_K_MIN lowered, so K3 serves
  the dispatches: so_tpu's code, Mvir, Rvir and j bit for bit, and every
  port output equal to its K1-only run; and a box whose largest ball needs
  more than 2^14 slots (K3's descriptors and slab_gather.sort_in_ball on the
  path) against so_tpu.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

from fixtures import make_clumpy_box  # noqa: E402
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
from so_tpu_torch.ops.grid import build_grid, payload_width  # noqa: E402

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


def _descriptors_int64(st, cnt, q, K: int, chunk: int):
    """piece_descriptors as it was before its int32 form: five int64
    piecewise-constant expansions, one prefix sum each."""
    PW = piece_gather.PIECE_W
    B, C = st.shape
    NP = (K + chunk) // chunk
    nch = torch.where(cnt > 0, ((st % chunk) + cnt + (chunk - 1)) // chunk,
                      torch.zeros_like(cnt))
    npc = (nch + (PW - 1)) // PW
    qp = torch.cumsum(npc, dim=1) - npc
    qs = torch.clamp(qp, max=NP)

    def seg_const(vals):
        diffs = torch.cat([vals[:, :1], vals[:, 1:] - vals[:, :-1]], dim=1)
        arr = torch.zeros((B, NP + 1), dtype=vals.dtype)
        arr.scatter_add_(1, qs, diffs)
        return torch.cumsum(arr[:, :NP], dim=1)

    j = torch.arange(NP)[None, :] - seg_const(qp)
    src = seg_const((st // chunk) * chunk) + j * (PW * chunk)
    t0 = seg_const(q // chunk) + j * PW
    v = torch.clamp(seg_const(nch) - j * PW, 0, PW)
    return (src, t0, v, seg_const(st), seg_const(st + cnt),
            torch.clamp(npc.sum(dim=1), max=NP),
            torch.clamp(nch.sum(dim=1), max=NP))


def _assert_descriptors_match_int64(st, cnt, q, K, chunk):
    """The int32 descriptors equal the int64 ones on live pieces, and the
    counts; returns the int32 ones."""
    got = piece_gather.piece_descriptors(st, cnt, q, K, chunk)
    want = _descriptors_int64(st, cnt, q, K, chunk)
    assert all(g.dtype == torch.int32 and g.is_contiguous() for g in got)
    live = (torch.arange(want[0].shape[1])[None, :] < want[5][:, None])
    assert live.any()
    for g, w in zip(got[:5], want[:5]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[live].numpy(), w[live].numpy())
    for g, w in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    return got


@pytest.mark.parametrize("K", [256, 1536, 6000, 1 << 16])
@pytest.mark.parametrize("m,chunk", [(3, 128), (2, 256)],
                         ids=["chunk128", "chunk256"])
def test_piece_descriptors_int32_match_int64(m, chunk, K):
    """Rows past K (K=256, 1536: pieces past NP dropped), and none
    (2^16)."""
    grid, rng = _grid(3000, m, seed=5)
    centers, radii = _balls(rng, 8)
    st, cnt, q, total = _runs(grid, centers, radii, chunk)
    _assert_descriptors_match_int64(st, cnt, q, K, chunk)
    assert (total > K).any() or K > 1536
    assert (total <= K).all() or K < 1 << 16


def _k3_constants():
    """The walk's constants as csrc/piece_gather.cu spells them."""
    text = open(os.path.join(ROOT, "so_tpu_torch", "csrc",
                             "piece_gather.cu")).read()
    names = ("kPieceW", "kThreads", "kGroups")
    return [int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
            for n in names]


def _replay(desc, b, K: int, chunk: int, width: int, P: int):
    """Halo b's output as csrc/piece_gather.cu writes it at P pieces a
    block: the pad of each block's chunk range past n_chunks, then block ->
    its pieces -> 4-column groups (trips of kThreads x kGroups) -> 4
    lanes. The kernel's int
    variables are int32 here too, so an overflow would show. Asserts that
    every slot in [0, K) is written exactly once (counted by group where
    K % 4 == 0: the kernel's 16-byte stores), that a group's source column
    and slot are multiples of 4, and that a loaded group lies in the
    payload. Returns each live group's slot, source row, and its run's
    [lo, min(hi, width))."""
    PW, T, G = _k3_constants()
    i32 = np.int32
    src, t0, v, lo, hi = (x[b].numpy() for x in desc[:5])
    n_pieces, n_chunks = int(desc[5][b]), int(desc[6][b])
    NP = src.shape[0]
    pw, gpp = PW * chunk, PW * chunk // 4
    assert width % 4 == 0 and chunk % 4 == 0
    u0 = np.arange(-(-NP // P), dtype=i32) * i32(P)      # a block's first
    # 1. the pad
    c0 = np.maximum(u0.astype(np.int64) * PW, n_chunks) * chunk
    s_end = np.minimum((u0.astype(np.int64) + P) * pw, K)
    pad = c0 < s_end
    g4 = 4 if K % 4 == 0 else 1           # slots a counted unit
    edge = np.zeros(K // g4 + 1, np.int64)
    np.add.at(edge, c0[pad] // g4, 1)
    np.add.at(edge, -(-s_end[pad] // g4), -1)
    count = np.cumsum(edge[:-1])
    # 2. the live pieces: in each block, its trips of kThreads x kGroups
    # groups (trip, group k, thread: gi = trip*T*G + k*T + thread), those
    # below its n * gpp groups
    n = np.minimum(i32(P), i32(n_pieces) - u0)
    trips = -(-P * gpp // (T * G))
    it, k, tid = np.meshgrid(np.arange(trips, dtype=i32),
                             np.arange(G, dtype=i32),
                             np.arange(T, dtype=i32), indexing="ij")
    gi = (it * i32(T * G) + k * i32(T) + tid).ravel()
    blk, g = np.nonzero(gi[None, :] < (n * i32(gpp))[:, None])
    gi = gi[g]
    u = gi // i32(gpp)
    col = (gi - u * i32(gpp)) * i32(4)
    U = u0[blk] + u
    keep = col < v[U] * i32(chunk)
    U, col = U[keep], col[keep]
    row = src[U] + col
    slot = t0[U].astype(np.int64) * chunk + col
    keep = slot < K
    U, row, slot = U[keep], row[keep], slot[keep]
    assert (row % 4 == 0).all() and (slot % 4 == 0).all()
    rlo, rhi = lo[U], np.minimum(hi[U], i32(width))
    loaded = (row < rhi) & (row + 4 > rlo)
    assert (row[loaded] + 3 < width).all()
    if g4 == 4:                           # 16-byte stores: all 4 lanes
        assert (slot + 4 <= K).all()
        count += np.bincount(slot // 4, minlength=K // 4)
    else:
        for j in range(4):
            count += np.bincount(slot[slot + j < K] + j, minlength=K)
    assert (count == 1).all(), "a slot written other than once"
    return slot, row, rlo, rhi


def _slot_rows(slot, row, rlo, rhi, K: int):
    """(K,) the source row each slot reads: -1 for pad, or for a lane
    outside its run."""
    got = np.full(K, -1, np.int32)
    for j in range(4):
        ok = slot + j < K
        r = row[ok] + np.int32(j)
        got[slot[ok] + j] = np.where((r >= rlo[ok]) & (r < rhi[ok]), r, -1)
    return got


@pytest.mark.parametrize("K", [256, 1539, 6000, 1 << 16])
@pytest.mark.parametrize("m,chunk", [(3, 128), (2, 256)],
                         ids=["chunk128", "chunk256"])
def test_kernel_walk_replay_matches_plain(m, chunk, K):
    """The replay's source row at every slot, at each pieces a block the
    wrapper picks from, is the one piece_gather_plain reads there (its idx
    with r2 = +inf: the row where it lies in its run, else -1). K=1539
    takes the 4-byte stores; 256 and 1536 drop pieces."""
    grid, rng = _grid(3000, m, seed=5)
    centers, radii = _balls(rng, 8)
    st, cnt, q, _ = _runs(grid, centers, radii, chunk)
    desc = piece_gather.piece_descriptors(st, cnt, q, K, chunk)
    width = grid.soa8t.shape[1]
    assert width == payload_width(grid.n + grid.chunk) != grid.n + grid.chunk
    inf = torch.full((8,), torch.inf)
    _, _, idx = piece_gather.piece_gather_plain(
        grid.soa8t, *desc, centers, grid.period, inf, K, chunk, (), True)
    assert (idx >= 0).sum() > 0
    for P in piece_gather.PIECE_GROUPS:
        for b in range(8):
            np.testing.assert_array_equal(
                _slot_rows(*_replay(desc, b, K, chunk, width, P), K),
                idx[b].numpy())


def test_pieces_per_block():
    """On 132 SMs: at the dispatches k3_study.py timed (chunk 128), the
    pick the rule was fit to; everywhere, a power of two in [4, 32] whose
    grid is within a factor of sqrt(2) of 16 blocks an SM unless clamped."""
    pick = piece_gather.pieces_per_block
    NP = {16: 513, 18: 2049, 20: 8193, 21: 16385, 23: 65537}
    for B, k, want in ((5, 16, 4), (5, 18, 4), (5, 20, 16), (4, 21, 32),
                       (4, 23, 32), (269, 16, 32), (1, 18, 4), (8, 18, 8),
                       (64, 18, 32), (8, 21, 32), (64, 21, 32)):
        assert pick(B, NP[k], 132) == want, (B, k)
    target = piece_gather.BLOCKS_PER_SM * 132
    for B in (1, 2, 4, 16, 64, 256, 1024, 4096):
        for np_ in (2, 257, 2049, 16385, 65537):
            p = pick(B, np_, 132)
            assert p in (4, 8, 16, 32)
            ratio = B * np_ / p / target
            assert (2 ** -0.5 <= ratio <= 2 ** 0.5 or (p == 4 and ratio < 1)
                    or (p == 32 and ratio > 1))


def _synthetic_runs(rng, B, C, n_rows, chunk, scale):
    """cell_ranges-shaped merged runs (st, cnt, q), int64 (B, C): starts
    ascending and disjoint, each count within the gap to the next start
    (times scale[b]), the last eighth of the columns empty, q the
    exclusive offsets of the chunk-aligned footprints."""
    st = np.sort(rng.integers(0, n_rows, (B, C)), axis=1)
    gap = np.diff(st, axis=1, append=n_rows)
    cnt = (gap * rng.uniform(0.5, 1.0, (B, C)) * scale[:, None]).astype(
        np.int64)
    cnt[:, C - C // 8:] = 0
    foot = np.where(cnt > 0, (st % chunk + cnt + chunk - 1) // chunk * chunk,
                    0)
    q = np.cumsum(foot, axis=1) - foot
    return (torch.as_tensor(st), torch.as_tensor(cnt), torch.as_tensor(q),
            foot.sum(axis=1))


def test_kernel_walk_at_2_26_slots():
    """Index only, B x K = 2^26 (B = 8, K = 2^23, chunk 128, the giant
    box's) over a payload of 2^24+ rows: the int32 descriptors equal the
    int64 ones, and the replay writes every slot once, each live one from
    the row the piece layout gives (src + column, in its run)."""
    B, K, C, chunk = 8, 1 << 23, 512, 128
    P = piece_gather.pieces_per_block(B, (K + chunk) // chunk, 132)
    assert P == max(piece_gather.PIECE_GROUPS)
    n_rows = (1 << 24) + 12345
    width = payload_width(n_rows + chunk)
    rng = np.random.default_rng(11)
    scale = np.array([1.0, 0.9, 0.5, 0.25, 0.1, 0.6, 1.0, 0.02])
    st, cnt, q, total = _synthetic_runs(rng, B, C, n_rows, chunk, scale)
    assert (total > K).any() and (total < K).any()
    desc = _assert_descriptors_match_int64(st, cnt, q, K, chunk)
    for b in range(B):
        src, t0, v = (x[b].numpy() for x in desc[:3])
        n_p = int(desc[5][b])
        # the piece layout's groups: slots [t0*chunk, +v*chunk) below K
        # read src + column
        ln = np.clip(np.minimum(v[:n_p] * chunk, K - t0[:n_p] * chunk), 0,
                     None) // 4
        piece = np.repeat(np.arange(n_p), ln)
        col = 4 * (np.arange(ln.sum()) - np.repeat(np.cumsum(ln) - ln, ln))
        want = np.full(K // 4, -1, np.int64)
        want[(t0[piece].astype(np.int64) * chunk + col) // 4] = (src[piece]
                                                                 + col)
        slot, row, _, _ = _replay(desc, b, K, chunk, width, P)
        got = np.full(K // 4, -1, np.int64)
        got[slot // 4] = row
        np.testing.assert_array_equal(got, want)


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


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """On either device, before any work: a payload row stride that is not
    a multiple of 4 floats or a base off 16 bytes, int64 or strided
    descriptors, f64 centers, descriptors of another shape."""
    grid, rng = _grid(3001, 3)
    centers, radii = _balls(rng, 4)
    st, cnt, q, _ = _runs(grid, centers, radii, grid.chunk)
    K = 1536
    desc = piece_gather.piece_descriptors(st, cnt, q, K, grid.chunk)
    tail = (centers, grid.period, radii * radii, K, grid.chunk)
    piece_gather.piece_gather_rows(grid.soa8t, *desc, *tail)
    W = grid.soa8t.shape[1]
    off = torch.empty(8 * W + 1)[1:].view(8, W)
    off.copy_(grid.soa8t)
    bad = [((grid.soa8t[:, :W - 2].contiguous(), *desc), tail),
           ((off, *desc), tail),
           ((grid.soa8t, *(d.long() for d in desc)), tail),
           ((grid.soa8t, desc[0][:, ::2], *desc[1:]), tail),
           ((grid.soa8t, desc[0][:, 1:].contiguous(), *desc[1:]), tail),
           ((grid.soa8t, *desc), (centers.double(), *tail[1:]))]
    for head, t in bad:
        with pytest.raises(ValueError):
            piece_gather.piece_gather_rows(*head, *t)


def _counting(monkeypatch, kmin=512):
    """Set PIECE_K_MIN (lowered: every dispatch above 512 slots takes K3),
    and count the K3 dispatches (on the CPU the kernels' launch counters
    stay at 0: only the plain versions run)."""
    calls = []
    real = gather.piece_gather_rows

    def counted(*a):
        calls.append(a[11])          # K (gather.unsorted_gather's call)
        return real(*a)

    monkeypatch.setattr(gather, "PIECE_K_MIN", kmin)
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


BIG_K0 = 1 << 15     # both solves' first capacity: above 2^14, and few
#                      so_tpu tiers to compile


@pytest.fixture(scope="module")
def big_ball_box():
    """A clump of 17,500 particles on 1,500 uniform ones with two centers
    on it, whose balls need more than 2^14 slots; so_tpu's solve (Pallas
    interpret mode) once for the module."""
    rng = np.random.default_rng(7)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=17500, rmax=0.08,
                   mass_total=0.5)]
    data = make_clumpy_box(rng, n_background=1500, clumps=clumps)
    centers = np.asarray([(0.1, 0.0, -0.1), (0.11, 0.005, -0.1)],
                         np.float32)
    rgtp = np.asarray([0.03, 0.02], np.float32)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3,
                                         pallas=True),
                          centers, rgtp, 178.0, k0_cap=BIG_K0)
    return data, centers, rgtp, want


@pytest.mark.parametrize("kmin", [512, gather.PIECE_K_MIN],
                         ids=["lowered", "default"])
def test_giant_route_above_2_14_matches_so_tpu(big_ball_box, kmin,
                                               monkeypatch):
    """K3's descriptors and slab_gather.sort_in_ball at capacities the
    default routes reach (2^15 and 2^17 slots): so_tpu's code, Mvir, Rvir
    and j bit for bit, with PIECE_K_MIN lowered and at its default."""
    data, centers, rgtp, want = big_ball_box
    sorted_k = []
    real_sort = gather.sort_in_ball

    def sort_in_ball(*a):
        sorted_k.append(a[0].shape[1])
        return real_sort(*a)

    calls = _counting(monkeypatch, kmin)
    monkeypatch.setattr(gather, "sort_in_ball", sort_in_ball)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    got = solve_rvir(grid, centers, rgtp, 178.0, k0_cap=BIG_K0)
    assert len(calls) > 0 and min(calls) > max(kmin, 1 << 14)
    assert max(sorted_k) > 1 << 15 and (got.code == 0).all()
    assert got.j.min() > 1 << 14
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
                              runs[0].solve.mvir, runs[0].solve.j, ok,
                              species=species)
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
