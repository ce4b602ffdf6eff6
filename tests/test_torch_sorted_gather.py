"""K1's sorted form on the CPU: its plain version, the ordering its kernel
relies on, the int32 descriptors and the route by capacity.

The CUDA kernel (csrc/slab_gather.cu, slab_gather_sorted_kernel) sorts each
halo's in-ball hits by the 64-bit key (d2 bits << 32) | source row in
shared memory. These tests hold, with numpy and torch on the CPU, every
fact that design rests on: the key's order is torch.sort(stable=True)'s
order over the slot layout; rows grow with slots inside every halo; the
bitonic network's index arithmetic sorts; and the plain version equals the
slotted gather followed by a stable sort, and so_tpu's sorted gather (its
Pallas kernel in interpret mode). Above the sorted form's capacity,
sort_in_ball gives the same order over the in-ball slots, in narrower rows.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu.ops import gather as jg  # noqa: E402
from so_tpu_torch.ops import gather as tg  # noqa: E402
from so_tpu_torch.ops import slab_gather as sg  # noqa: E402
from so_tpu_torch.ops.grid import grid_from_arrays  # noqa: E402
from test_torch_grid import jax_grid_arrays  # noqa: E402
from test_torch_solver import fma32  # noqa: E402

FULL = ("mass", "mvx", "mvy", "mvz", "meta")


def _make_grids(n):
    """(so_tpu grid, port grid) of a periodic box with a clump across the
    wrap: 600 particles at m=2 pick chunk 256, 3000 at m=3 chunk 128."""
    rng = np.random.default_rng(31)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[: n // 3] = ((rng.normal(scale=0.05, size=(n // 3, 3)) + 0.5) % 1.0
                     - 0.5).astype(np.float32)
    pos[n // 2: n // 2 + 12] = (0.48, -0.49, 0.49)   # duplicates: equal d2
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], n).astype(np.int32)
    mark = rng.uniform(size=n) < 0.3
    jgrid = jax_build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark,
                           m=2 if n == 600 else 3, pallas=True)
    pgrid = grid_from_arrays(**jax_grid_arrays(jgrid), device="cpu")
    assert pgrid.chunk == (256 if n == 600 else 128)
    return jgrid, pgrid


@pytest.fixture(scope="module", params=[600, 3000],
                ids=["chunk256", "chunk128"])
def grids(request):
    return _make_grids(request.param)


def _balls(B, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[0] = 0.5                 # on the clump, across every face
    centers[1] = (0.49, -0.5, 0.5)
    radii = rng.uniform(0.05, 0.3, B).astype(np.float32)
    radii[2] = 1e-4                  # an empty ball
    return centers, radii


def _descriptors(pgrid, centers, radii, K, level=1, S=5):
    tc, tr = torch.as_tensor(centers), torch.as_tensor(radii)
    st, cnt, q, total = tg.cell_ranges(pgrid, level, tc, tr, tr * tr, S,
                                       align=pgrid.chunk)
    return (st, cnt, q, total), sg.chunk_descriptors(st, cnt, q, K,
                                                     pgrid.chunk)


def _key_order(d2, low):
    """argsort of the kernel's key, (d2 bits << 32) | low, per row."""
    key = (d2.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | low.astype(np.uint64)
    return np.argsort(key, axis=1, kind="stable")


# (a) the key's order is the stable sort's order ---------------------------

@pytest.mark.parametrize("case", ["ties", "zeros", "empty", "full", "mixed"])
def test_key_order_is_stable_sort_order(case):
    rng = np.random.default_rng(17)
    B, K = 24, 512
    pool = rng.uniform(0.0, 2.0, 40).astype(np.float32)   # few values: ties
    d2 = rng.choice(pool, (B, K)).astype(np.float32)
    n_in = rng.integers(0, K + 1, B)
    if case == "zeros":
        d2[rng.uniform(size=(B, K)) < 0.3] = 0.0           # +0.0
    elif case == "empty":
        n_in[:] = 0
    elif case == "full":
        n_in[:] = K
    elif case == "mixed":
        d2 = rng.uniform(0.0, 1e-3, (B, K)).astype(np.float32)
        d2[:, ::7] = np.float32(1e-45)                     # subnormal ties
        n_in[0], n_in[1] = 0, K
    # pads anywhere in the row, as the slotted layout leaves them
    for b in range(B):
        pad = rng.permutation(K)[: K - n_in[b]]
        d2[b, pad] = np.inf
    assert not np.signbit(d2).any()
    want = torch.sort(torch.as_tensor(d2), dim=1, stable=True)[1].numpy()
    slot = np.broadcast_to(np.arange(K), (B, K))
    np.testing.assert_array_equal(_key_order(d2, slot), want)
    # any low word that grows with the slot gives the same order
    rows = np.cumsum(rng.integers(1, 9, (B, K)), axis=1) + 1000
    np.testing.assert_array_equal(_key_order(d2, rows), want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 31, 32, 33, 100, 512, 777, 1024])
def test_bitonic_network_indices_sort(n):
    """The kernel's network, step for step: n unique keys padded to a power
    of two with all-ones, pairs (p, p + j) with p = 2i - (i & (j - 1)),
    ascending where (p & k) == 0."""
    rng = np.random.default_rng(n)
    keys = rng.permutation(1 << 20)[:n].astype(np.uint64)
    n2 = 1
    while n2 < n:
        n2 <<= 1
    a = np.concatenate([keys, np.full(n2 - n, ~np.uint64(0))])
    i = np.arange(n2 >> 1)
    k = 2
    while k <= n2:
        j = k >> 1
        while j > 0:
            p = 2 * i - (i & (j - 1))
            ka, kb = a[p].copy(), a[p + j].copy()
            swap = (ka > kb) == ((p & k) == 0)
            a[p] = np.where(swap, kb, ka)
            a[p + j] = np.where(swap, ka, kb)
            j >>= 1
        k <<= 1
    np.testing.assert_array_equal(a[:n], np.sort(keys))
    assert (a[n:] == ~np.uint64(0)).all()


# (b) rows grow with slots inside every halo --------------------------------

@pytest.mark.parametrize("K", [2048, 700])
def test_rows_grow_with_slots(grids, K):
    """Every in-run row of a halo, in slot order (the slotted plain version
    with an unbounded ball keeps them all), strictly increases: runs are
    sorted by start, also across the periodic wrap and when K cuts the
    halo's chunks short."""
    _, pgrid = grids
    centers, radii = _balls(12)
    for level, S in ((1, 5), (0, 4)):
        (_, _, _, total), desc = _descriptors(pgrid, centers, radii, K,
                                              level, S)
        inf = torch.full((12,), torch.inf)
        _, _, idx = sg.slab_gather_plain(
            pgrid.soa8t, *desc, torch.as_tensor(centers), pgrid.period, inf,
            K, pgrid.chunk, (), True)
        idx = idx.numpy()
        assert (total.numpy() > K).any() or K > 700
        seen = 0
        for b in range(12):
            rows = idx[b][idx[b] >= 0]
            seen += rows.size
            assert (np.diff(rows) > 0).all()
        assert seen > 0


# (c) the plain version ------------------------------------------------------

def _numpy_sorted(d2, ch, idx):
    """A stable sort of the slotted output with numpy."""
    order = np.argsort(d2, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    return (take(d2), [take(ch[:, i]) for i in range(ch.shape[1])],
            None if idx is None else take(idx),
            np.isfinite(d2).sum(axis=1))


def _kernel_emulation(d2, ch, idx, rng):
    """The sorted kernel's steps with numpy: the in-ball hits in any
    order, sorted by (d2 bits << 32) | row, the channels read at the sorted
    row's slot, pads behind."""
    B, K = d2.shape
    out_d2 = np.full((B, K), np.inf, np.float32)
    out_ch = np.zeros((ch.shape[1], B, K), np.float32)
    out_idx = np.full((B, K), -1, np.int32)
    n_in = np.zeros(B, np.int64)
    for b in range(B):
        hits = rng.permutation(np.nonzero(np.isfinite(d2[b]))[0])
        key = (d2[b, hits].view(np.uint32).astype(np.uint64)
               << np.uint64(32)) | idx[b, hits].astype(np.uint64)
        assert np.unique(key).size == key.size
        srt = hits[np.argsort(key)]
        n = n_in[b] = srt.size
        out_d2[b, :n] = d2[b, srt]
        out_ch[:, b, :n] = ch[b][:, srt]
        out_idx[b, :n] = idx[b, srt]
    return out_d2, list(out_ch), out_idx, n_in


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.int32) if a.dtype == np.float32
                                  else a, b.view(np.int32)
                                  if b.dtype == np.float32 else b)


@pytest.mark.parametrize("chans,want_idx", [((), False), (("mass",), False),
                                            (("mass", "meta"), True),
                                            (FULL, True)],
                         ids=["nch0", "nch1", "nch2idx", "nch5idx"])
@pytest.mark.parametrize("K", [2048, 700, 1023])
def test_sorted_plain_is_slotted_then_stable_sort(grids, K, chans, want_idx):
    """slab_gather_sorted_plain against the slotted plain version sorted
    stably by numpy: d2, channels, idx and n_in bit for bit, at K a
    multiple of the chunk, K cutting halos short (overflow) and odd K;
    an empty ball and duplicate particles (equal d2) among them. The
    wrapper on CPU tensors is the plain version."""
    _, pgrid = grids
    B = 10
    centers, radii = _balls(B)
    (_, _, _, total), desc = _descriptors(pgrid, centers, radii, K)
    args = (pgrid.soa8t, *desc, torch.as_tensor(centers), pgrid.period,
            torch.as_tensor(radii * radii), K, pgrid.chunk, chans, want_idx)
    d2, ch, idx = sg.slab_gather_plain(*args)
    want = _numpy_sorted(d2.numpy(), ch.numpy(),
                         None if idx is None else idx.numpy())
    n0 = sg.launches
    for got in (sg.slab_gather_sorted_plain(*args),
                sg.slab_gather_sorted_rows(*args)):
        _same_bits(got[0].numpy(), want[0])
        assert len(got[1]) == len(chans)
        for g, w in zip(got[1], want[1]):
            _same_bits(g.numpy(), w)
        assert (got[2] is None) == (not want_idx)
        if want_idx:
            _same_bits(got[2].numpy(), want[2])
        assert got[3].dtype == torch.int64
        np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert sg.launches == n0             # the plain versions never count
    n_in = want[3]
    assert n_in[2] == 0 and n_in.max() > 8
    assert (total.numpy() > K).any() or K > 700
    for b in range(B):
        assert np.isinf(want[0][b, n_in[b]:]).all()
    if want_idx:
        ties = sum(int((np.diff(want[0][b, :n_in[b]]) == 0).sum())
                   for b in range(B))
        assert ties >= 11 or K == 700     # the duplicates' equal d2
        emu = _kernel_emulation(d2.numpy(), ch.numpy(), idx.numpy(),
                                np.random.default_rng(K))
        _same_bits(emu[0], want[0])
        for g, w in zip(emu[1], want[1]):
            _same_bits(g, w)
        _same_bits(emu[2], want[2])
        np.testing.assert_array_equal(emu[3], want[3])


def test_sorted_gather_matches_so_tpu(grids):
    """gather.slab_gather (the sorted form's route) against so_tpu's
    sorted slab gather, its Pallas kernel in interpret mode: n_in, the
    source rows in order, mass and meta bit for bit; d2 bit for bit under
    each side's own form (per-op here, fused under XLA:CPU)."""
    jgrid, pgrid = grids
    B, K, S, level = 6, 4096, 5, 1
    centers, radii = _balls(B, seed=9)
    radii[2] = 0.2
    channels = ("mass", "meta", "idx")
    jc, jr = jnp.asarray(centers), jnp.asarray(radii)
    ref = jg.slab_gather(jgrid, level, jc, jr, jr * jr, K, S,
                         channels=channels)
    tc, tr = torch.as_tensor(centers), torch.as_tensor(radii)
    got = tg.slab_gather(pgrid, level, tc, tr, tr * tr, K, S,
                         channels=channels)
    assert K <= tg.SORTED_K_MAX and not got.overflow.any()
    np.testing.assert_array_equal(got.n_in.numpy(), np.asarray(ref.n_in))
    pos = pgrid.pos_a().numpy()
    n_clear = n_all = 0
    for b in range(B):
        n = int(ref.n_in[b])
        gi = got.channels[2][b, :n].numpy()
        si = np.asarray(ref.channels[2][b, :n])
        d2 = got.d2[b, :n].numpy()
        rd2 = np.asarray(ref.d2[b, :n])
        # the two forms of d2 differ by an ulp or two, so near-equal
        # distances may swap; away from those the order is the same
        clear = np.ones(n, bool)
        clear[1:] &= np.diff(d2) > 4e-7 * d2[1:]
        clear[:-1] &= clear[1:].copy()
        n_clear += int(clear.sum())
        n_all += n
        np.testing.assert_array_equal(gi[clear], si[clear])
        np.testing.assert_array_equal(np.sort(gi), np.sort(si))
        for c in (0, 1):
            np.testing.assert_array_equal(
                got.channels[c][b, :n].numpy()[clear],
                np.asarray(ref.channels[c][b, :n])[clear])
        dd = (centers[b] - np.round(centers[b] - pos[gi])) - pos[gi]
        x, y, z = dd[:, 0], dd[:, 1], dd[:, 2]
        _same_bits(d2, x * x + y * y + z * z)
        dd = (centers[b] - np.round(centers[b] - pos[si])) - pos[si]
        x, y, z = dd[:, 0], dd[:, 1], dd[:, 2]
        _same_bits(rd2, fma32(z, z, fma32(x, x, y * y)))
        assert np.isinf(got.d2[b, n:].numpy()).all()
        assert (got.channels[2][b, n:].numpy() == -1).all()
        assert (got.channels[0][b, n:].numpy() == 0).all()
    assert n_clear > 0.5 * n_all > 0


# (d) the int32 descriptors ---------------------------------------------------

def _chunk_descriptors_i64(st, cnt, q, K, chunk):
    """The int64 descriptors this module built before it built int32 ones
    (one scatter and prefix sum per value)."""
    B, C = st.shape
    NC = (K + chunk) // chunk
    astart = (st // chunk) * chunk
    foot = torch.where(cnt > 0, ((st % chunk) + cnt + (chunk - 1))
                       // chunk * chunk, torch.zeros_like(cnt))
    qc = torch.clamp(q // chunk, max=NC)
    n_total = torch.clamp((foot // chunk).sum(dim=1), max=NC)

    def seg_const(vals):
        diffs = torch.cat([vals[:, :1], vals[:, 1:] - vals[:, :-1]], dim=1)
        arr = torch.zeros((B, NC + 1), dtype=vals.dtype)
        arr.scatter_add_(1, qc, diffs)
        return torch.cumsum(arr[:, :NC], dim=1)

    return seg_const(astart - qc * chunk), seg_const(st), \
        seg_const(st + cnt), n_total


@pytest.mark.parametrize("K", [256, 700, 2048, 8192])
def test_chunk_descriptors_int32_equal_int64(grids, K):
    _, pgrid = grids
    centers, radii = _balls(16)
    for level, S in ((1, 5), (0, 4)):
        (st, cnt, q, _), desc = _descriptors(pgrid, centers, radii, K,
                                             level, S)
        want = _chunk_descriptors_i64(st, cnt, q, K, pgrid.chunk)
        for g, w in zip(desc, want):
            assert g.dtype == torch.int32 and g.is_contiguous()
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_k1_wrappers_refuse_other_descriptors(grids):
    """The wrappers convert nothing: int64 descriptors, or a strided
    center, are refused, whatever the device."""
    _, pgrid = grids
    centers, radii = _balls(4)
    _, desc = _descriptors(pgrid, centers, radii, 1024)
    tail = (torch.as_tensor(centers), pgrid.period,
            torch.as_tensor(radii * radii), 1024, pgrid.chunk)
    for fn in (sg.slab_gather_rows, sg.slab_gather_sorted_rows):
        fn(pgrid.soa8t, *desc, *tail)
        with pytest.raises(ValueError):
            fn(pgrid.soa8t, *(d.long() for d in desc), *tail)
        with pytest.raises(ValueError):
            fn(pgrid.soa8t, *desc, torch.zeros((4, 6))[:, ::2], *tail[1:])


# (e) the in-ball sort ---------------------------------------------------------

def _pow2_width(n_max, K):
    """sort_in_ball's row width: the least power of two >= n_max, at least
    1 and at most K."""
    w = 1
    while w < n_max:
        w *= 2
    return min(w, K)


def _check_prefix_and_pads(got, want, pads, want_pads=True):
    """Rows of any width against the K-wide stable sort ``want`` (d2, list
    of channels, n_in): each row's first n_in slots bit for bit, every
    slot past them a pad (``pads``: one a channel), in ``want`` too unless
    ``want_pads`` is False."""
    d2, chans, n_in = got
    wd2, wchans, wn_in = want
    np.testing.assert_array_equal(np.asarray(n_in), np.asarray(wn_in))
    assert len(chans) == len(wchans) == len(pads)
    for b, n in enumerate(np.asarray(wn_in)):
        _same_bits(d2[b, :n], wd2[b, :n])
        assert np.isinf(d2[b, n:]).all() and np.isinf(wd2[b, n:]).all()
        for g, w, pad in zip(chans, wchans, pads):
            _same_bits(g[b, :n], w[b, :n])
            assert (g[b, n:] == pad).all()
            assert (w[b, n:] == pad).all() or not want_pads


def _rows_case(case, B, K, rng):
    """(d2, n_in) of a slotted output: in-ball d2 >= +0 anywhere in the
    row, +inf elsewhere."""
    pool = rng.uniform(0.0, 2.0, 40).astype(np.float32)      # few: ties
    d2 = rng.choice(pool, (B, K)).astype(np.float32)
    n_in = rng.integers(0, K // 3, B)
    if case == "zeros":
        d2[rng.uniform(size=(B, K)) < 0.3] = 0.0             # +0.0 ties
    elif case == "subnormal":
        d2 = rng.uniform(0.0, 1e-3, (B, K)).astype(np.float32)
        d2[:, ::7] = np.float32(1e-45)
        d2[:, 1::7] = np.float32(3e-39)
    elif case == "no hit":
        n_in[:] = 0
    elif case == "full":
        n_in[:] = K
    elif case == "empty and full":
        n_in[0], n_in[-1] = 0, K
    elif case == "pow2 plus one":
        n_in[:] = rng.integers(0, 65, B)
        n_in[1] = 65                              # W = 128 < K
    for b in range(B):
        d2[b, rng.permutation(K)[: K - n_in[b]]] = np.inf
    return d2, n_in


@pytest.mark.parametrize("want_idx", [False, True], ids=["noidx", "idx"])
@pytest.mark.parametrize("nch", [0, 1, 2, 5])
@pytest.mark.parametrize("case", ["ties", "zeros", "subnormal", "no hit",
                                  "full", "empty and full", "pow2 plus one",
                                  "one row"])
def test_sort_in_ball_is_the_stable_sort_of_full_rows(case, nch, want_idx):
    """sort_in_ball against numpy's stable argsort of the full rows: d2,
    each channel, idx and n_in over each row's first n_in slots, +inf / 0
    / -1 past them, rows as wide as the least power of two that holds the
    widest ball; sort.slots and sort.keys count B * K and the hits. The
    off-ball slots hold garbage: only in-ball slots may be read."""
    from so_tpu_torch import profiling

    rng = np.random.default_rng(sum(map(ord, case)) + 7 * nch)
    B, K = (1, 300) if case == "one row" else (9, 300)
    d2, n_in = _rows_case(case, B, K, rng)
    assert not np.signbit(d2).any()
    ch = rng.normal(size=(B, nch, K)).astype(np.float32)
    idx = rng.integers(-5, 10**6, (B, K)).astype(np.int32)
    order = np.argsort(d2, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, order, axis=1)  # noqa: E731
    want = (take(d2), [take(ch[:, i]) for i in range(nch)]
            + ([take(idx)] if want_idx else []), n_in)
    base = dict(profiling.counts)
    got = sg.sort_in_ball(torch.as_tensor(d2), torch.as_tensor(ch),
                          torch.as_tensor(idx) if want_idx else None)
    assert profiling.counts[("sort.slots",)] - base.get(("sort.slots",), 0) \
        == B * K
    assert profiling.counts[("sort.keys",)] - base.get(("sort.keys",), 0) \
        == n_in.sum()
    W = _pow2_width(n_in.max(), K)
    assert got[0].shape == (B, W) and got[0].dtype == torch.float32
    assert all(c.shape == (B, W) for c in got[1])
    assert (got[2] is None) == (not want_idx)
    assert got[3].dtype == torch.int64
    if case == "no hit":
        assert W == 1
    elif case == "pow2 plus one":
        assert W == 128
    elif case in ("full", "empty and full"):
        assert W == K
    chans = [c.numpy() for c in got[1]]
    if want_idx:
        assert got[2].dtype == torch.int32
        chans.append(got[2].numpy())
    _check_prefix_and_pads((got[0].numpy(), chans, got[3].numpy()), want,
                           [0] * nch + ([-1] if want_idx else []),
                           want_pads=False)
    if case in ("ties", "zeros", "subnormal"):
        assert any((np.diff(want[0][b, :n]) == 0).any()
                   for b, n in enumerate(n_in))


@pytest.mark.parametrize("chans,want_idx", [((), False), (FULL, True)],
                         ids=["nch0", "nch5idx"])
@pytest.mark.parametrize("K", [2048, 700, 1023])
def test_sort_in_ball_on_the_slotted_gather(grids, K, chans, want_idx):
    """sort_in_ball over the slotted plain version's rows (the pads and
    off-ball slots as the kernels leave them, duplicate particles, an
    empty ball, halos cut short at K) against sort_rows' K-wide rows."""
    _, pgrid = grids
    centers, radii = _balls(10)
    _, desc = _descriptors(pgrid, centers, radii, K)
    rows = sg.slab_gather_plain(pgrid.soa8t, *desc, torch.as_tensor(centers),
                                pgrid.period, torch.as_tensor(radii * radii),
                                K, pgrid.chunk, chans, want_idx)
    want = sg.sort_rows(*rows)
    got = sg.sort_in_ball(*rows)
    n_in = want[3].numpy()
    assert got[0].shape[1] == _pow2_width(n_in.max(), K) and n_in[2] == 0

    def as_np(r):
        return (r[0].numpy(), [c.numpy() for c in r[1]]
                + ([r[2].numpy()] if want_idx else []), r[3].numpy())

    _check_prefix_and_pads(as_np(got), as_np(want),
                           [0] * len(chans) + ([-1] if want_idx else []))


# (f) the route by capacity ----------------------------------------------------

@pytest.mark.parametrize("side", ["at", "above", "forced off"])
def test_route_by_capacity(grids, side, monkeypatch):
    """slab_gather takes the sorted form up to SORTED_K_MAX slots and the
    slotted gather plus sort_in_ball above it; the results are the same:
    each row's in-ball prefix bit for bit, and every slot past it of
    either width a pad (+inf, 0, -1), the sorted form's rows K wide and
    sort_in_ball's as wide as the least power of two that holds the
    widest ball."""
    _, pgrid = grids
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        monkeypatch.setattr(tg, name, wrapped)

    spy("slab_gather_sorted_rows", tg.slab_gather_sorted_rows)
    spy("sort_in_ball", tg.sort_in_ball)
    K = tg.SORTED_K_MAX
    if side == "above":
        K += pgrid.chunk
    elif side == "forced off":
        monkeypatch.setattr(tg, "SORTED_K_MAX", 0)
    centers, radii = _balls(3)
    tc, tr = torch.as_tensor(centers), torch.as_tensor(radii)
    channels = ("mass", "mv", "idx")
    got = tg.slab_gather(pgrid, 1, tc, tr, tr * tr, K, 5, channels=channels)
    assert calls == (["slab_gather_sorted_rows"] if side == "at"
                     else ["sort_in_ball"])
    monkeypatch.undo()
    want = tg.slab_gather(pgrid, 1, tc, tr, tr * tr, tg.SORTED_K_MAX, 5,
                          channels=channels)
    n_in = want.n_in.numpy()
    W = K if side == "at" else _pow2_width(n_in.max(), K)
    assert got.d2.shape == (3, W) and (W < K or side == "at")
    assert got.channels[1].shape == (3, W, 3)

    def split(r):
        mv = r.channels[1].numpy()
        return (r.d2.numpy(), [r.channels[0].numpy(), mv[..., 0], mv[..., 1],
                               mv[..., 2], r.channels[2].numpy()],
                r.n_in.numpy())

    _check_prefix_and_pads(split(got), split(want), [0, 0, 0, 0, -1])


def test_kernel_library_is_keyed_by_headers(tmp_path, monkeypatch):
    """An edited header is another library: the kernels rebuild. The sorted entry point is bound with the slotted
    one's arguments plus n_in and the block size."""
    from so_tpu_torch.ops import _cuda

    src = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, src)
    monkeypatch.setattr(_cuda, "CSRC", src)
    base = _cuda.library_path()
    assert base == _cuda.library_path() and base.parent == _cuda.BUILD_DIR
    header = src / "gather_body.cuh"
    assert header.name in (src / "slab_gather.cu").read_text()
    assert header.name in (src / "piece_gather.cu").read_text()
    header.write_text(header.read_text() + "\n// edited\n")
    assert _cuda.library_path() != base
    sig = _cuda._SIGNATURES
    assert len(sig["so_slab_gather_sorted"]) == len(sig["so_slab_gather"]) + 2
