"""The fused pass's f64 m*v member sums (ops/member_sums.py,
csrc/member_sums.cu) against members.member_mv_sums.

On the CPU: the op's plain form over a grid's payload equals
member_mv_sums over the file-order arrays at the same rows, bit for bit;
a numpy replay of the kernel's decomposition (its cut nodes, the thread
that owns each, the scratch slot it writes and the walk above the cut,
constants read from the source) gives member_mv_sums' bits; and
members_and_derived gives the same members, vcm and derived quantities
from the sorted stack as from ``host_mv``. On the card (skipped without
one): the kernel equals member_mv_sums bit for bit on many short lists and
on long ones, and the fused pass counts every member row as summed there.

This file imports no jax:
    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_member_sums.py
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from so_tpu_torch import profiling  # noqa: E402
from so_tpu_torch.engine import solver  # noqa: E402
from so_tpu_torch.engine.fused import members_and_derived  # noqa: E402
from so_tpu_torch.engine.members import member_mv_sums  # noqa: E402
from so_tpu_torch.ops import member_sums as ms  # noqa: E402
from so_tpu_torch.ops.grid import build_grid, pack_soa8t  # noqa: E402
from torch_scenarios import make_clumpy_box  # noqa: E402

SOURCE = os.path.join(os.path.dirname(HERE), "so_tpu_torch", "csrc",
                      "member_sums.cu")


def _particles(seed, n, uniform, neg_zero=False):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    # velocities over decades, so the f64 sums' order shows in their bits
    vel = (rng.normal(size=(n, 3))
           * 10.0 ** rng.uniform(-3, 3, (n, 3))).astype(np.float32)
    if neg_zero:
        vel[:, 1] = -0.0
    mass = (np.full(n, 1.0 / n, np.float32) if uniform
            else rng.uniform(0.5, 1.5, n).astype(np.float32) / n)
    return rng, pos, vel, mass


def _stack(rng, n_rows, lists, pad=5):
    """A (B, W) int32 stack of random rows, each row's list first and -1
    after, and its (B,) int64 counts."""
    W = max(lists) + pad
    idx = np.full((len(lists), W), -1, np.int32)
    for b, k in enumerate(lists):
        idx[b, :k] = rng.choice(n_rows, k, replace=False)
    return idx, np.asarray(lists, np.int64)


def _bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


# --- the op's plain form -------------------------------------------------

@pytest.mark.parametrize("mass_kind", ["general", "uniform"])
@pytest.mark.parametrize("case", ["0", "1", "2", "31", "4097", "neg_zero"])
def test_plain_matches_member_mv_sums(case, mass_kind):
    """member_sums on a CPU grid's payload and sorted rows equals
    member_mv_sums over the file-order (vel, mass) at the same particles'
    file rows: three lists of each length (0, 1, 2, 31, 4,097 rows), and
    lists of 0-300 rows with every y velocity -0.0."""
    neg_zero = case == "neg_zero"
    n = 6000
    rng, pos, vel, mass = _particles(3, n, mass_kind == "uniform", neg_zero)
    grid = build_grid(pos, mass, vel=vel, device="cpu")
    assert grid.holds_vel
    assert (grid.uniform_mass is not None) == (mass_kind == "uniform")
    lists = ([0, 1, 2, 3, 7, 8, 9, 31, 129, 300] if neg_zero
             else [int(case)] * 3)
    idx, counts = _stack(rng, n, lists)
    got = ms.member_sums(grid.soa8t, torch.from_numpy(idx),
                         torch.from_numpy(counts), grid.uniform_mass)
    file_rows = grid.orig_idx.numpy()[
        np.concatenate([idx[b, :k] for b, k in enumerate(counts)])]
    want = member_mv_sums((vel, mass), file_rows, counts)
    assert got.dtype == torch.float64 and got.shape == (len(lists), 3)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if neg_zero:    # a sum of -0.0 terms stays -0.0; no term, +0.0
        assert np.signbit(want[1:, 1]).all() and not np.signbit(want[0, 1])


def test_refuses_what_the_kernel_does_not_take():
    """A payload that is not (8, W) f32, a stack that is not int32 or
    counts that are not (B,) int64 are refused, on the CPU too."""
    soa = torch.zeros((8, 64))
    idx = torch.zeros((2, 4), dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int64)
    for args in ((soa[:7], idx, counts), (soa.double(), idx, counts),
                 (soa, idx.long(), counts), (soa, idx, counts.int()),
                 (soa, idx, counts[:1])):
        with pytest.raises(ValueError):
            ms.member_sums(*args)


# --- the kernel's decomposition, replayed --------------------------------

def _kernel_constants():
    text = open(SOURCE).read()
    return [int(re.search(rf"constexpr long long {n} = (\d+);", text)
                .group(1)) for n in ("kLeaf", "kCut")]


def _left(m):
    m2 = m // 2
    return m2 - m2 % 8


def _pairwise(off, m, leaf_max, leaf):
    """The kernel's pairwise(): numpy's tree walked on an explicit stack."""
    stack = []              # [off, m, left sum or None]
    while True:
        while m > leaf_max:
            stack.append([off, m, None])
            m = _left(m)
        acc = leaf(off, m)
        while stack and stack[-1][2] is not None:
            acc = _add(stack.pop()[2], acc)
        if not stack:
            return acc
        f = stack[-1]
        f[2] = acc
        off, m = f[0] + _left(f[1]), f[1] - _left(f[1])


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))   # IEEE f64, as __dadd_rn


def _term_leaf(t):
    """The kernel's TermLeaf over the terms t (a list of 3-tuples)."""
    def leaf(off, m):
        if m < 8:
            res = (-0.0, -0.0, -0.0)
            for i in range(m):
                res = _add(res, t[off + i])
            return res
        r = [t[off + j] for j in range(8)]
        i = 8
        while i < m - m % 8:
            r = [_add(r[j], t[off + i + j]) for j in range(8)]
            i += 8
        res = _add(_add(_add(r[0], r[1]), _add(r[2], r[3])),
                   _add(_add(r[4], r[5]), _add(r[6], r[7])))
        for i in range(i, m):
            res = _add(res, t[off + i])
        return res
    return leaf


def _replay(terms, W, cut, leaf_max):
    """One halo through cut_sums_kernel's threads and finish_kernel."""
    grain = cut // 2
    n = len(terms)
    P = n - 1
    NI = -(-(W - 1) // grain)
    scratch, covered = {}, []
    for i in range(NI):
        pos = i * grain
        if P <= 0 or pos >= P:
            continue
        off, m = 0, P
        while m > cut:
            m2 = _left(m)
            if pos < off + m2:
                m = m2
            else:
                off, m = off + m2, m - m2
        if off <= (i - 1) * grain:
            continue
        assert off > 0 or m <= cut      # a cut node below the root is big
        assert off == 0 or m >= grain
        scratch[i] = _pairwise(off, m, leaf_max, _term_leaf(terms[1:]))
        covered.append((off, m))
    if n == 0:
        return (0.0, 0.0, 0.0)
    if n == 1:
        return terms[0]
    # the cut nodes partition the pairwise part, one thread each
    assert sorted(covered)[0][0] == 0
    assert sum(m for _, m in covered) == P
    top = _pairwise(0, P, cut, lambda off, m: scratch[-(-off // grain)])
    return _add(terms[0], top)


@pytest.mark.parametrize("n,cut", [(2, None), (130, None), (4097, None),
                                   (4098, None), (3 * 4096 + 77, None),
                                   (2 ** 15 + 3, None), (5000, 256),
                                   (70001, 256)])
def test_kernel_decomposition_matches_member_mv_sums(n, cut):
    """The kernel's cut nodes, their owning threads and scratch slots and
    the walk above them give member_mv_sums' bits, at the source's kCut
    and at a smaller cut that makes the tree above it deep; the wrapper's
    CUT_GRAIN is the source's kCut / 2."""
    leaf_max, k_cut = _kernel_constants()
    assert ms.CUT_GRAIN == k_cut // 2
    rng = np.random.default_rng(n)
    mv = (rng.normal(size=(n, 3)) * 10.0 ** rng.uniform(-3, 3, (n, 3))
          ).astype(np.float32)
    mv[:, 1] = -0.0                     # a sum of -0.0 terms stays -0.0
    want = member_mv_sums(mv, np.arange(n), np.array([n]))[0]
    terms = [tuple(float(x) for x in row) for row in mv.astype(np.float64)]
    got = _replay(terms, n + 3, cut or k_cut, leaf_max)
    np.testing.assert_array_equal(_bits(np.array(got)), _bits(want))


# --- the fused pass -------------------------------------------------------

def _solved_box(uniform):
    rng = np.random.default_rng(21)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=1400, rmax=0.06,
                   mass_total=0.2),
              dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04,
                   mass_total=0.08)]
    d = make_clumpy_box(rng, n_background=3500, clumps=clumps)
    n = d["pos"].shape[0]
    mass = np.full(n, 1.0 / n, np.float32) if uniform else d["mass"]
    centers = np.array([c["center"] for c in clumps]
                       + [(0.12, 0.01, -0.1)], np.float32)
    rgtp = np.full(3, 0.05, np.float32)
    grid = build_grid(d["pos"], mass, vel=d["vel"], m=3, device="cpu")
    s = solver.solve_rvir(grid, centers, rgtp, 178.0)
    ok = s.code == 0
    assert ok.sum() >= 2
    return d["pos"], grid, (d["vel"], mass), (
        centers[ok], s.rvir[ok], s.d2cut[ok], s.j[ok], s.mvir[ok])


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_members_and_derived_from_the_stack_matches_host_mv(uniform):
    """members_and_derived on a grid that holds the velocities forms the
    sums from the sorted stack (host_mv is not read: None here) and gives
    the members, vcm and derived quantities of the host_mv route, taken by
    the same grid marked as holding none; no kernel is launched on the
    CPU."""
    _, grid, host_mv, args = _solved_box(uniform)
    assert (grid.uniform_mass is not None) == uniform
    before = ms.launches
    mem, vcm, der = members_and_derived(grid, *args, host_mv=None,
                                        species=(1,))
    assert ms.launches == before
    host_grid = dataclasses.replace(grid, holds_vel=False)
    mem_h, vcm_h, der_h = members_and_derived(host_grid, *args,
                                              host_mv=host_mv, species=(1,))
    assert vcm.tobytes() == vcm_h.tobytes()
    assert np.abs(vcm).max() > 0
    for a, b in zip(mem, mem_h):
        np.testing.assert_array_equal(a, b)
    assert [m.size for m in mem] == args[3].tolist()
    for f in dataclasses.fields(der):
        a, b = getattr(der, f.name), getattr(der_h, f.name)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()
        else:
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_holds_vel_marks_a_grid_given_velocities():
    """build_grid marks a grid given ``vel``; one built without holds
    zeros in the velocity rows and is not marked, so the fused pass keeps
    host_mv for it."""
    _, pos, vel, mass = _particles(5, 500, False)
    assert build_grid(pos, mass, vel=vel, device="cpu").holds_vel
    assert not build_grid(pos, mass, device="cpu").holds_vel


# --- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _payload(seed, n, uniform, dev, neg_zero=False):
    rng, pos, vel, mass = _particles(seed, n, uniform, neg_zero)
    soa = pack_soa8t(torch.from_numpy(pos), torch.from_numpy(mass),
                     torch.from_numpy(vel), torch.zeros(n, dtype=torch.int32),
                     torch.zeros(n, dtype=torch.bool), chunk=256)
    return rng, soa.to(dev), (vel, mass)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["short", "4097", "long", "uniform",
                                  "neg_zero"])
def test_kernel_matches_member_mv_sums_cuda(dev, case):
    """The kernel's (B, 3) sums equal member_mv_sums over the same rows bit
    for bit: 65,536 short lists (0-300 rows, W 512), lists of 4,097 rows,
    one list of 2^22 + 3 rows beside short ones, a uniform mass, and short
    lists with every y velocity -0.0."""
    n = (1 << 22) + 64 if case == "long" else 1 << 20
    rng, soa, host = _payload(7, n, case == "uniform", dev,
                              case == "neg_zero")
    if case in ("short", "uniform", "neg_zero"):
        lists = rng.integers(0, 301, 65536)
        lists[:5] = [0, 1, 2, 7, 8]
        W = 512
        idx = rng.integers(0, n, (lists.size, W)).astype(np.int32)
        idx[np.arange(W)[None, :] >= lists[:, None]] = -1
    else:
        lists = ([(1 << 22) + 3, 0, 1, 129, 4097] if case == "long"
                 else [4097] * 8)
        idx, lists = _stack(rng, n, lists, pad=13)
    counts = np.asarray(lists, np.int64)
    n0 = ms.launches
    got = ms.member_sums(soa, torch.from_numpy(idx).to(dev),
                         torch.from_numpy(counts).to(dev),
                         (float(host[1][0]) if case == "uniform" else None))
    torch.cuda.synchronize()
    assert ms.launches == n0 + 1
    rows = np.concatenate([idx[b, :k] for b, k in enumerate(counts)])
    want = member_mv_sums(host, rows, counts)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_fused_pass_sums_on_the_card(dev, uniform):
    """On a CUDA grid the fused pass launches the kernel once a dispatch
    and gives the CPU's members and vcm bits."""
    pos, grid, host_mv, args = _solved_box(uniform)
    g_cuda = build_grid(pos, host_mv[1], vel=host_mv[0], m=3, device=dev)
    disp = ("fused.dispatches",)
    d0, n0 = profiling.counts[disp], ms.launches
    mem, vcm, _ = members_and_derived(g_cuda, *args, host_mv=None)
    assert ms.launches - n0 == profiling.counts[disp] - d0 > 0
    mem_c, vcm_c, _ = members_and_derived(grid, *args, host_mv=host_mv)
    assert vcm.tobytes() == vcm_c.tobytes()
    for a, b in zip(mem, mem_c):
        np.testing.assert_array_equal(a, b)
