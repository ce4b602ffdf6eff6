"""so_tpu_torch's --distributed path (so_tpu_torch/parallel/distributed.py
and driver.py) on the CPU.

Ranks run in threads over an in-process transport (FakeTransport: the
TorchTransport surface over a barrier hub), so every rank's share of a
sharded grid, a solve, a conflict walk or a whole run_so_distributed can be
held to its one-process counterpart: run_so_sharded on a 1 x (W * P_local)
mesh of the CPU, bit for bit (ties fall in global shard order in both),
and the port's single-device run. The conflict pieces, segments and
checkpoint forms are also held to so_tpu's. Real gloo processes run the
port's CLI --distributed --device cpu (tests/torch_distributed_worker.py)
and must write the bytes of the one-process CLIs. Each test whose result
reads a ball's distance order first checks that no ball holds equal d2.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box, write_gtp, write_snapshot  # noqa: E402
from test_native import _random_case  # noqa: E402
from test_torch_pipeline import _box  # noqa: E402
from test_torch_sharding import (SOLVE_FIELDS, THR, _runs_equal,  # noqa: E402
                                 assert_same, assert_tie_free, cpu_mesh,
                                 read_reach)

import so_tpu.checkpoint as jax_checkpoint  # noqa: E402
import so_tpu.engine.conflicts as jax_conflicts  # noqa: E402
import so_tpu.parallel.distributed as jax_distributed  # noqa: E402
import so_tpu.parallel.driver as jax_driver  # noqa: E402
from so_tpu_torch import checkpoint  # noqa: E402
from so_tpu_torch.cli import main  # noqa: E402
from so_tpu_torch.engine import multi, solver  # noqa: E402
from so_tpu_torch.engine.conflicts import (conflict_walk_sparse,  # noqa: E402
                                           resolve_conflicts,
                                           resolve_conflicts_components)
from so_tpu_torch.engine.fused import members_and_derived  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402
from so_tpu_torch.engine.recenter import recenter_most_bound  # noqa: E402
from so_tpu_torch.engine.solver import SolveResult  # noqa: E402
from so_tpu_torch.io.tipsy import DARK, GAS, MARK, STAR  # noqa: E402
from so_tpu_torch.ops import gather  # noqa: E402
from so_tpu_torch.ops.grid import build_grid, detect_uniform_mass  # noqa: E402
from so_tpu_torch.parallel import (build_sharded_grid,  # noqa: E402
                                   build_sharded_grid_segment,
                                   dist_conflict_fn, grid_segment,
                                   host_segment, make_multihost_mesh,
                                   recenter_most_bound_distributed,
                                   run_so_distributed,
                                   run_so_multi_distributed,
                                   run_so_multi_sharded, run_so_sharded,
                                   seg_member_filter)

LAYOUTS = [(2, 1), (2, 2), (3, 1), (3, 2)]      # (ranks W, shards a rank)
LAYOUT_IDS = [f"W{w}xP{p}" for w, p in LAYOUTS]
SPECIES = (DARK, GAS, STAR, MARK)


class Hub:
    """Barrier-synchronised exchange between W threads, one a rank."""

    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.b1 = threading.Barrier(n)
        self.b2 = threading.Barrier(n)

    def exchange(self, pid, value):
        self.slots[pid] = value
        self.b1.wait(timeout=120)
        out = list(self.slots)
        self.b2.wait(timeout=120)
        return out

    def abort(self):
        self.b1.abort()
        self.b2.abort()


class FakeTransport:
    """distributed.TorchTransport's surface over a Hub: the same rank
    order, copies of every rank's values."""

    def __init__(self, hub, pid):
        self.hub = hub
        self.nproc = hub.n
        self.pid = pid

    def allgather_varlen(self, a):
        return [np.array(x) for x in
                self.hub.exchange(self.pid, np.ascontiguousarray(a).ravel())]

    def process_allgather(self, tree):
        vals = self.hub.exchange(self.pid, tuple(np.asarray(x) for x in tree))
        return tuple(np.stack([v[i] for v in vals]) for i in range(len(tree)))

    def allgather_tensors(self, tensors):
        got = self.hub.exchange(self.pid, [None if t is None else t.clone()
                                           for t in tensors])
        return [[None if t is None else t.clone() for t in row]
                for row in got]

    def barrier(self):
        self.hub.exchange(self.pid, None)


def on_ranks(W: int, fn) -> list:
    """fn(transport) on W threads, one a rank; their results in rank
    order. A rank's error breaks the hub and is raised here."""
    hub = Hub(W)
    results, errors = [None] * W, [None] * W

    def run(pid):
        try:
            results[pid] = fn(FakeTransport(hub, pid))
        except BaseException as e:   # noqa: BLE001 (re-raised below)
            errors[pid] = e
            hub.abort()

    threads = [threading.Thread(target=run, args=(p,)) for p in range(W)]
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)       # W ranks share the cores, as W processes
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        torch.set_num_threads(n_threads)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    first = [e for e in errors if e is not None
             and not isinstance(e, threading.BrokenBarrierError)]
    if first or any(e is not None for e in errors):
        raise (first or [e for e in errors if e is not None])[0]
    return results


@pytest.fixture(scope="module")
def data():
    """tests/test_sharding.py's box (test_torch_sharding's): three clumps
    on a background, 8 centers near them, seed 17; tie-free in every ball
    a result reads."""
    rng = np.random.default_rng(17)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1400, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04, mass_total=0.08),
        dict(center=(0.45, 0.45, 0.45), n=700, rmax=0.05, mass_total=0.06),
    ]
    d = make_clumpy_box(rng, n_background=3500, clumps=clumps)
    base = np.array([[0.1, 0.0, -0.1], [-0.25, 0.3, 0.2],
                     [0.45, 0.45, 0.45]], np.float32)
    extra = (np.concatenate([base, base[:2]])
             + rng.normal(size=(5, 3)).astype(np.float32) * 0.01)
    centers = np.concatenate([base, extra])
    rgtp = rng.uniform(0.03, 0.06, centers.shape[0]).astype(np.float32)
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], phi=d["phi"], m=3,
                      device="cpu")
    solved = solver.solve_rvir(grid, centers, rgtp, THR)
    assert_tie_free(d["pos"], centers, read_reach(solved, rgtp))
    return d, centers, rgtp, grid, solved


def reference(d, W, P):
    """The one-process grid of a W-rank, P-shards-a-rank run."""
    return build_sharded_grid(d["pos"], d["mass"], vel=d["vel"],
                              phi=d["phi"], m=3, mesh=cpu_mesh(1, W * P))


def segment_grid(d, P, tr):
    """The rank's grid of the distributed run over ``tr``'s ranks."""
    n = d["pos"].shape[0]
    start, count = grid_segment(n, P, tr.nproc, tr.pid)
    sl = slice(start, start + count)
    return build_sharded_grid_segment(
        make_multihost_mesh(P, "cpu"), start, n, d["pos"][sl], d["mass"][sl],
        vel=d["vel"][sl], phi=d["phi"][sl], m=3,
        uniform_mass=detect_uniform_mass(d["mass"]), comm=tr)


def tensors_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("W,P", LAYOUTS, ids=LAYOUT_IDS)
def test_segment_grid_gathers(data, W, P):
    """A rank's grid holds its own shards of the one-process grid, and its
    slab_gather, unsorted_gather (with the position channels) and
    footprint, merged over every rank's shards, equal that grid's on every
    rank."""
    d, centers, rgtp, _, _ = data
    ref = reference(d, W, P)
    c, r = torch.as_tensor(centers), torch.as_tensor(rgtp * 1.5)
    level, S = solver._pick_level_span(ref, float(r.max()))
    K = 2048
    chans = ("mass", "meta", "idx", "orig")
    want = (gather.slab_gather(ref, level, c, r, r * r, K, S, chans),
            gather.unsorted_gather(ref, level, c, r, r * r, K, S,
                                   ("mass", "x", "y", "z"), True),
            gather.footprint(ref, level, c, r, S))
    # "orig" and the positions are the rows' own, as each shard reads them
    idx = want[0].channels[2]
    orig = torch.cat([g.orig_idx for g in ref.cells[0]])
    assert torch.equal(want[0].channels[3],
                       torch.where(idx >= 0, orig[idx.long()], -1))
    ok = want[1][2] >= 0
    pos = torch.cat([g.pos_a() for g in ref.cells[0]])
    assert torch.equal(want[1][1][:, 1:].permute(0, 2, 1)[ok],
                       pos[want[1][2][ok].long()])

    def rank(tr):
        sg = segment_grid(d, P, tr)
        for p, g in enumerate(sg.cells[0]):
            assert torch.equal(g.soa8t, ref.cells[0][tr.pid * P + p].soa8t)
        return ((sg.n, sg.m, sg.chunk, sg.parts, sg.shard0),
                gather.slab_gather(sg, level, c, r, r * r, K, S, chans),
                gather.unsorted_gather(sg, level, c, r, r * r, K, S,
                                       ("mass", "x", "y", "z"), True),
                gather.footprint(sg, level, c, r, S))

    for pid, (shape, sgr, us, fp) in enumerate(on_ranks(W, rank)):
        assert shape == (ref.n, ref.m, ref.chunk, W * P, pid * P)
        for a, b in zip(sgr, want[0]):
            if isinstance(a, tuple):
                assert all(tensors_equal(x, y) for x, y in zip(a, b))
            else:
                assert tensors_equal(a, b)
        assert all(tensors_equal(a, b) for a, b in zip(us, want[1]))
        assert tensors_equal(fp, want[2])


@pytest.mark.parametrize("W,P", LAYOUTS, ids=LAYOUT_IDS)
def test_distributed_engine(data, W, P, monkeypatch):
    """On every rank's grid: the solve with the survey pre-pass from a
    first capacity of 256 slots (escalations) with PIECE_K_MIN at 1024
    (K3 above it), the multi-threshold solve with the survey, the fused
    members+derived pass and -pot equal the one-process 1 x (W * P) grid's
    bit for bit, and the solve the single-device one's."""
    d, centers, rgtp, single, solved = data
    monkeypatch.setattr(gather, "PIECE_K_MIN", 1024)
    k3 = []
    real = gather.piece_gather_rows

    def spy(*a):
        k3.append(1)
        return real(*a)

    monkeypatch.setattr(gather, "piece_gather_rows", spy)
    thresholds = [THR, 500.0, 2000.0]
    species = (DARK, MARK)
    ok = solved.code == 0

    def engine(grid, recenter=recenter_most_bound):
        s = solver.solve_rvir(grid, centers, rgtp, THR, k0_cap=256,
                              survey=True)
        m = multi.solve_rvir_multi(grid, centers, rgtp, thresholds,
                                   survey=True)
        f = members_and_derived(grid, centers[ok], solved.rvir[ok],
                                solved.d2cut[ok], solved.j[ok],
                                solved.mvir[ok],
                                host_mv=(d["vel"], d["mass"]),
                                species=species)
        return s, m, f, recenter(grid, centers, rgtp)

    want = engine(reference(d, W, P))
    assert_same(want[0], solved, SOLVE_FIELDS)
    assert want[0].kcap.max() > 256 and want[1].n_survey > 0 and k3
    got = on_ranks(W, lambda tr: engine(
        segment_grid(d, P, tr),
        lambda g, c, r: recenter_most_bound_distributed(g.mesh, g, c, r)))
    for s, m, f, rc in got:
        assert_same(s, want[0], SOLVE_FIELDS + ("kcap", "n_survey"))
        assert_same(m, want[1], SOLVE_FIELDS + ("kcap", "n_survey"))
        for a, b in zip(f[0], want[2][0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(f[1], want[2][1])
        assert_same(f[2], want[2][2], ("vcirc", "rmass", "rmax", "vmax"))
        for sp in species:
            np.testing.assert_array_equal(f[2].profiles[sp],
                                          want[2][2].profiles[sp])
        assert rc.tobytes() == want[3].tobytes()


def write_box(path, ps):
    """_box's ParticleSet as a tipsy snapshot (its species split)."""
    h = ps.header
    write_snapshot(path, dict(pos=ps.pos, vel=ps.vel, mass=ps.mass,
                              phi=ps.phi), split=(h.nsph, h.ndark, h.nstar))


def assemble(runs):
    """One SORun's worth of per-particle outputs and member lists from the
    ranks' segment runs."""
    igrp = np.concatenate([r.conflicts.igrp for r in runs])
    nsub = np.concatenate([r.conflicts.n_subsumed for r in runs])
    nign = np.concatenate([r.conflicts.n_ignored for r in runs])
    members = []
    for h in range(len(runs[0].members)):
        segs = [r.members[h] for r in runs]
        if segs[0] is None:
            assert all(s is None for s in segs)
            members.append(None)
            continue
        full = np.full(segs[0].n, -1, np.int64)
        for s in segs:
            assert s.n == segs[0].n
            full[s.ranks] = s.rows
        assert (full >= 0).all()
        members.append(full)
    return igrp, nsub, nign, members


def assert_dist_run(runs, want, species):
    """The ranks' runs against a one-process SORun: every field, member
    list and stat. Catalog-sized results are the same on every rank."""
    igrp, nsub, nign, members = assemble(runs)
    c = want.conflicts
    for name, a, b in (("igrp", igrp, c.igrp), ("n_subsumed", nsub,
                                                  c.n_subsumed),
                       ("n_ignored", nign, c.n_ignored)):
        assert a.tobytes() == b.tobytes(), name
    for run in runs:
        assert_same(run.solve, want.solve, SOLVE_FIELDS + ("vcm",))
        assert_same(run.conflicts, c, ("mvir", "rvir", "slurped_own",
                                       "groups_removed", "groups_slurped"))
        assert_same(run.derived, want.derived,
                    ("vcirc", "rmass", "rmax", "vmax"))
        for sp in species:
            np.testing.assert_array_equal(run.derived.profiles[sp],
                                          want.derived.profiles[sp])
        assert run.catalog.pos.tobytes() == want.catalog.pos.tobytes()
        assert vars(run.stats) == vars(want.stats)
    for a, b in zip(members, want.members):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("uniform,W,P,pot", [(True, 2, 2, False),
                                             (False, 3, 1, True)],
                         ids=["uniform-W2xP2", "species-pot-W3xP1"])
def test_run_so_distributed_threads(tmp_path, uniform, W, P, pot):
    """run_so_distributed on test_torch_pipeline's box (four species with
    marks), each rank reading its segment of the snapshot file, against
    run_so_sharded on 1 x (W * P) and (without -pot) the port's run_so."""
    ps, catalog = _box(uniform)
    snap = str(tmp_path / "snap.bin")
    write_box(snap, ps)
    params = dict(threshold=THR, species=SPECIES, b_pot=pot, device="cpu")
    want = run_so_sharded(ps, catalog(), SOParams(**params),
                          cpu_mesh(1, W * P))
    if not pot:
        single = run_so(ps, catalog(), SOParams(**params))
        cat = catalog()
        assert_tie_free(ps.pos, cat.pos, read_reach(single.solve, cat.rgtp))
        _runs_equal(want, single, SPECIES)
    runs = on_ranks(W, lambda tr: run_so_distributed(
        snap, catalog(), SOParams(**params), parts_per_host=P,
        mark_mask=ps.mark, transport=tr))
    assert (runs[0].solve.code == 0).sum() >= 3
    assert_dist_run(runs, want, SPECIES)


def test_run_so_multi_distributed_threads(tmp_path):
    """run_so_multi_distributed (--deltas) over 2 ranks against
    run_so_multi_sharded on 1 x 2, threshold by threshold."""
    ps, catalog = _box(False)
    snap = str(tmp_path / "snap.bin")
    write_box(snap, ps)
    thresholds = [THR, 200.0, 500.0]
    params = SOParams(threshold=THR, species=(DARK, GAS), device="cpu",
                      survey=True)
    want = run_so_multi_sharded(ps, catalog(), params, thresholds,
                                cpu_mesh(1, 2))
    runs = on_ranks(2, lambda tr: run_so_multi_distributed(
        snap, catalog(), params, thresholds, mark_mask=ps.mark,
        transport=tr))
    for t in range(len(thresholds)):
        assert_dist_run([r[t] for r in runs], want[t], (DARK, GAS))


def segment_bounds(n, nproc, layout, rng):
    if layout == "even":
        return np.linspace(0, n, nproc + 1).astype(np.int64)
    cuts = np.sort(rng.integers(0, n + 1, nproc - 1))   # may be empty
    return np.concatenate([[0], cuts, [n]]).astype(np.int64)


@pytest.mark.parametrize("nproc", [1, 2, 3, 4])
def test_dist_conflict_fn(nproc):
    """The component-sharded conflict walk over SegRows member lists, on
    even and random (possibly empty) segments: the port's serial
    resolve_conflicts, and so_tpu's dist_conflict_fn under the same
    transport."""
    for seed in (5, 12, 77):
        rng = np.random.default_rng(seed)
        args = _random_case(rng, n_groups=60)
        index, pos, mvir, rvir, code, order, members, n = args
        want = resolve_conflicts(*args)
        for layout in ("even", "random"):
            bounds = segment_bounds(n, nproc, layout, rng)

            def rank(tr, fn):
                start = int(bounds[tr.pid])
                count = int(bounds[tr.pid + 1]) - start
                filt = seg_member_filter(start, count)
                ms = [None if m is None else filt(m) for m in members]
                return fn(start, count, transport=tr)(
                    index, pos, mvir, rvir, code, order, ms, n)

            got = on_ranks(nproc, lambda tr: rank(tr, dist_conflict_fn))
            theirs = on_ranks(nproc, lambda tr: rank(
                tr, jax_driver.dist_conflict_fn))
            for f in ("igrp", "n_subsumed", "n_ignored"):
                a = np.concatenate([getattr(r, f) for r in got])
                assert a.tobytes() == getattr(want, f).tobytes(), f
                b = np.concatenate([getattr(r, f) for r in theirs])
                assert a.tobytes() == b.tobytes(), f
            for r, t in zip(got, theirs):
                assert (r.seg_start, r.seg_count, r.n_global) == \
                    (t.seg_start, t.seg_count, t.n_global)
                for f in ("mvir", "rvir", "slurped_own", "groups_removed",
                          "groups_slurped"):
                    assert np.asarray(getattr(r, f)).tobytes() == \
                        np.asarray(getattr(want, f)).tobytes(), f
                    assert np.asarray(getattr(r, f)).tobytes() == \
                        np.asarray(getattr(t, f)).tobytes(), f


@pytest.mark.parametrize("seed", [3, 8, 21])
def test_conflict_components_match_so_tpu(seed):
    """conflict_components, conflict_walk_sparse (whole and on a share of
    the components) and resolve_conflicts_components equal so_tpu's and
    the serial pass."""
    rng = np.random.default_rng(seed)
    args = _random_case(rng, n_groups=50)
    index, pos, mvir, rvir, code, order, members, n = args
    from so_tpu_torch.engine.conflicts import conflict_components

    comp = conflict_components(code, members)
    np.testing.assert_array_equal(
        comp, jax_conflicts.conflict_components(code, members))
    assert (np.unique(comp[comp >= 0], return_counts=True)[1] >= 2).any()
    for sel in (None, lambda r: r % 2 == 0):
        a = conflict_walk_sparse(*args[:7], comp_sel=sel)
        b = jax_conflicts.conflict_walk_sparse(*args[:7], comp_sel=sel)
        for f in ("rows", "igrp", "n_subsumed", "n_ignored", "own", "mvir",
                  "rvir", "slurped_own", "groups_removed", "groups_slurped"):
            x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    dense = resolve_conflicts_components(*args)
    want = resolve_conflicts(*args)
    theirs = jax_conflicts.resolve_conflicts_components(*args)
    for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir",
              "slurped_own", "groups_removed", "groups_slurped"):
        x = np.asarray(getattr(dense, f))
        assert x.tobytes() == np.asarray(getattr(want, f)).tobytes(), f
        assert x.tobytes() == np.asarray(getattr(theirs, f)).tobytes(), f


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_segments_match_so_tpu(W, monkeypatch):
    """host_segment and grid_segment equal so_tpu's (whose process count
    comes from jax) for every (n, W, P_local, rank), and tile the file."""
    import jax

    monkeypatch.setattr(jax, "process_count", lambda: W)

    class Parts:                       # so_tpu reads mesh.shape["part"]
        def __init__(self, p):
            self.shape = {"part": p}

    for n in (0, 1, 5, 7, 100, 1001, 4096, 6401):
        for P in (1, 2, 3):
            segs = [grid_segment(n, P, W, r) for r in range(W)]
            assert segs == [jax_distributed.grid_segment(
                n, Parts(W * P), process_id=r) for r in range(W)]
            assert sum(c for _, c in segs) == n
            assert all(s + c == segs[i + 1][0]
                       for i, (s, c) in enumerate(segs[:-1]))
        hs = [host_segment(n, W, r) for r in range(W)]
        assert hs == [jax_distributed.host_segment(n, W, r)
                      for r in range(W)]
    with pytest.raises(ValueError):
        host_segment(10, W, W)


def test_no_group_no_card_no_fallback(monkeypatch):
    """init_distributed joins nothing without torchrun's variables and
    raises when only some are set; a rank asked for a card that torch does
    not see raises instead of moving to the CPU."""
    from so_tpu_torch.parallel.distributed import (init_distributed,
                                                   rank_device)

    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert init_distributed("gloo") is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_PORT, RANK not set"):
        init_distributed("gloo")
    assert rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        rank_device(f"cuda:{torch.cuda.device_count()}")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_device("cuda")


def random_state(seed, G=13, segment=None):
    """A SolveResult, member lists (SegRows of [start, start + count) when
    ``segment`` is given) and centers."""
    rng = np.random.default_rng(seed)
    solve = SolveResult(
        code=rng.integers(-3, 1, G).astype(np.int32),
        mvir=rng.random(G).astype(np.float32),
        rvir=rng.random(G).astype(np.float32),
        j=rng.integers(0, 50, G).astype(np.int32),
        d2cut=rng.random(G).astype(np.float32),
        vcm=rng.random((G, 3)).astype(np.float32))
    members = [rng.permutation(1000)[:rng.integers(1, 30)].astype(np.int64)
               if c == 0 else None for c in solve.code]
    if segment is not None:
        filt = seg_member_filter(*segment)
        members = [None if m is None else filt(m) for m in members]
    return solve, members, rng.random((G, 3)).astype(np.float32)


def assert_state_equal(got, want):
    for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
        a, b = getattr(got[0], f), getattr(want[0], f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got[2].tobytes() == want[2].tobytes()
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert int(a.n) == int(b.n)
            np.testing.assert_array_equal(a.ranks, b.ranks)
            np.testing.assert_array_equal(a.rows, b.rows)


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "so_tpu"),
                                           ("so_tpu", "port")])
def test_segment_checkpoint_round_trip(tmp_path, writer, reader):
    """A segment checkpoint written by either package loads in either with
    every field, SegRows included; a wrong digest or a single-file
    checkpoint is refused."""
    state = random_state(1, segment=(300, 400))
    path = str(tmp_path / "ck.rank0-of-2.npz")
    save = (checkpoint if writer == "port" else jax_checkpoint
            ).save_solve_segment
    load = (checkpoint if reader == "port" else jax_checkpoint
            ).load_solve_segment
    save(path, *state, digest="abc:seg300+400")
    assert_state_equal(load(path, "abc:seg300+400"), state)
    with pytest.raises(ValueError, match="segment layout"):
        load(path, "abc:seg0+400")
    single = str(tmp_path / "single.npz")
    checkpoint.save_solve(single, state[0], [None] * len(state[1]),
                          state[2])
    with pytest.raises(ValueError, match="not a distributed segment"):
        load(single)


def test_sharded_checkpoint_matches_so_tpu(tmp_path):
    """tests/test_aux.py's sharded case: three per-rank shards merge back
    to the global state; each shard's file holds so_tpu's arrays, and the
    port loads so_tpu's shards."""
    solve, members, centers = random_state(5, G=11)
    ours, theirs = str(tmp_path / "ck"), str(tmp_path / "jk")
    for h in range(3):
        p = checkpoint.save_solve_sharded(ours, solve, members, centers,
                                          host_id=h, num_hosts=3)
        assert p == f"{ours}.{h}-of-3.npz"
        jax_checkpoint.save_solve_sharded(theirs, solve, members, centers,
                                          host_id=h, num_hosts=3)
        a, b = np.load(p), np.load(f"{theirs}.{h}-of-3.npz")
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].tobytes() == b[f].tobytes(), f
    for base in (ours, theirs):
        got, got_members, got_centers = checkpoint.load_solve_sharded(base,
                                                                      3)
        for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
            assert getattr(got, f).tobytes() == getattr(solve, f).tobytes()
        assert got_centers.tobytes() == centers.tobytes()
        for a, b in zip(got_members, members):
            if b is not None:
                np.testing.assert_array_equal(a, b)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def clean_env():
    """The environment of a spawned rank: no JAX_*/XLA_* variables."""
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("XLA_", "JAX_"))}


def launch(W, args, check_collectives=False, timeout=240):
    """W gloo ranks of the port's CLI --distributed --device cpu; returns
    their outputs after checking every rank exited 0."""
    port, check = free_port(), free_port() if check_collectives else 0
    procs = []
    for r in range(W):
        env = dict(clean_env(), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), WORLD_SIZE=str(W), RANK=str(r),
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_distributed_worker.py"),
             str(check)] + args
            + ["--device", "cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
        assert f"TORCH_DISTRIBUTED_OK rank={r}" in out
        assert not check_collectives or f"COLLECTIVES_OK rank={r}" in out
    return outs


def lines(path):
    """A file's lines but the run time and the file names the catalog
    lists."""
    return [ln for ln in open(path, "rb").read().splitlines()
            if not (ln.startswith(b"# Run on") or b"written to" in ln)]


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    """tests/test_distributed.py's "plain" scenario (seed 61: three
    clumps, one overlapping another, and a background center), with the
    port's one-process CLI's outputs and so_tpu's."""
    from so_tpu.cli import main as jax_main

    work = str(tmp_path_factory.mktemp("plain"))
    rng = np.random.default_rng(61)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1100, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04, mass_total=0.08),
        dict(center=(0.12, 0.02, -0.08), n=400, rmax=0.03, mass_total=0.03),
    ]
    d = make_clumpy_box(rng, n_background=2500, clumps=clumps)
    write_snapshot(f"{work}/snap.bin", d)
    write_gtp(f"{work}/cat.gtp",
              [c["center"] for c in clumps] + [(0.45, -0.4, 0.3)],
              [0.05, 0.04, 0.03, 0.02], [0.2, 0.08, 0.03, 0.01])
    extra = ["-dark", "-grp", "-gtp", "-subsumed", "-ignored", "--survey"]
    base = ["-i", f"{work}/cat.gtp", "--tipsy", f"{work}/snap.bin"]
    for deltas in ([], ["--deltas", "178,200,500"]):
        assert jax_main(base + ["-o", f"{work}/so_tpu"] + extra
                        + deltas) == 0
        assert main(base + ["-o", f"{work}/single", "--device", "cpu"]
                    + extra + deltas) == 0
    return work, base, extra


EXTS = ("sovcirc", "sogrp", "sosub", "soign", "sodark", "sogtp")


def assert_same_files(work, got, *wants):
    for ext in EXTS:
        a = lines(f"{work}/{got}.{ext}")
        assert a and any(ln for ln in a)
        for want in wants:
            assert a == lines(f"{work}/{want}.{ext}"), (got, want, ext)


def test_cli_distributed_gloo(plain):
    """Two gloo ranks of the port's CLI (after holding the collectives to
    their contract) write the bytes of the port's one-process CLI and of
    so_tpu's."""
    work, base, extra = plain
    launch(2, base + ["-o", f"{work}/dist"] + extra, check_collectives=True)
    assert_same_files(work, "dist", "single", "so_tpu")


def test_cli_distributed_deltas(plain):
    """--distributed --deltas 178,200,500 over two gloo ranks: every
    threshold's files equal both one-process CLIs'."""
    work, base, extra = plain
    launch(2, base + ["-o", f"{work}/dd"] + extra
           + ["--deltas", "178,200,500"])
    for d in ("178", "200", "500"):
        assert_same_files(work, f"dd.d{d}", f"single.d{d}", f"so_tpu.d{d}")


def test_cli_distributed_checkpoint(plain):
    """--checkpoint over two gloo ranks: the first run saves one segment
    shard a rank, the second resumes from them (no solve) and writes the
    same bytes, which are the one-process CLI's."""
    work, base, extra = plain
    ck = f"{work}/ck.npz"
    args = base + extra + ["--checkpoint", ck, "--verbose"]
    first = launch(2, args + ["-o", f"{work}/ckA"])
    assert all(os.path.exists(f"{ck}.rank{r}-of-2.npz") for r in (0, 1))
    assert any("checkpoint save (segment)" in o for o in first)
    second = launch(2, args + ["-o", f"{work}/ckB"])
    assert any("checkpoint resume (segment)" in o for o in second)
    assert not any("R_Delta solve" in o for o in second)
    assert_same_files(work, "ckA", "single")
    assert_same_files(work, "ckB", "ckA")


@pytest.mark.parametrize("args,env,message", [
    ([], {"MASTER_ADDR": "localhost"},
     "--distributed requires --tipsy <file> (snapshot segments are "
     "seek-read per rank)"),
    (["--tipsy"], {}, "--distributed: no coordinator configured (set "
     "MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK, or start "
     "the ranks with torchrun)"),
    (["--tipsy", "--mesh", "1x2"], {"MASTER_ADDR": "localhost"},
     "--distributed cannot be combined with --mesh")],
    ids=["no-tipsy", "no-coordinator", "mesh"])
def test_cli_distributed_refusals(tmp_path, capsys, monkeypatch, args, env,
                                  message):
    """--distributed exits 1 with a message and writes nothing without
    --tipsy, without a coordinator, and with --mesh (checked before any
    group is joined)."""
    from scenarios import generate_inputs

    d = str(tmp_path)
    inputs = generate_inputs("basic", d)
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["-i", d + "/cat.gtp", "-o", d + "/got", "--device", "cpu",
            "--distributed"] + inputs
    if args:
        argv += [args[0], d + "/snap.bin"] + args[1:]
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == message
    assert not os.path.exists(d + "/got.sovcirc")
