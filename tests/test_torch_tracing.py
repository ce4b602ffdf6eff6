"""The port's span and counter recorder (so_tpu_torch.profiling): nesting,
totals and self time; the spans and counts a CPU run_so makes, with
recording on and off; run_so_multi's verdict counts and post-solve spans
(and run_so's counts without them), the post-solve spans of
run_so_multi_distributed at one gloo rank; the shared clock with
torch.profiler;
K1's and K3's byte counts against the reckoning written out here from
cell_ranges' output; PhaseTimer's report of the spans inside each phase."""

import io
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_scenarios import make_clumpy_box, write_snapshot  # noqa: E402

from so_tpu_torch import profiling  # noqa: E402
from so_tpu_torch.engine import solver  # noqa: E402
from so_tpu_torch.engine.pipeline import (SOParams, run_so,  # noqa: E402
                                          run_so_multi)
from so_tpu_torch.io.catalogs import GroupCatalog  # noqa: E402
from so_tpu_torch.io.tipsy import (DARK, GAS, STAR, ParticleSet,  # noqa: E402
                                   TipsyHeader)
from so_tpu_torch.ops import gather, ranges  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402
from so_tpu_torch.parallel import run_so_multi_distributed  # noqa: E402
from so_tpu_torch.profiling import PhaseTimer, span  # noqa: E402

PHASES = {"grid build", "R_Delta solve", "members + derived (fused)",
          "conflict protocol", "derived quantities", "stats"}
# every span a single-device run_so opens on the CPU while recording
# (gather.bytes only then; phase.sync only syncs a card)
SPANS = PHASES | {
    "run_so", "grid.ptype", "grid.upload", "grid.sort", "grid.payload",
    "solve.plan", "solve.survey", "solve.dispatch", "solve.ranges",
    "solve.gather", "solve.sort", "solve.scan", "solve.fetch",
    "solve.apply", "fused.probe", "fused.dispatch", "fused.gather",
    "fused.fetch", "fused.fill", "fused.split", "fused.vcm",
    "fused.members_list", "conflicts.order", "conflicts.prep",
    "conflicts.walk", "stats.native", "gather.bytes"}
DISPATCH_CHILDREN = {"solve.ranges", "solve.gather", "solve.scan",
                     "solve.fetch", "solve.apply"}
# the counts a run makes (solve.overflow_regathers and solve.ball_regrows
# only when a halo goes to another round; ranges.kernel only on the card;
# K2.calls at general masses; solve.giant_* only at giant capacities)
COUNTS = {"solve.rounds", "solve.dispatches", "solve.halo_gathers",
          "fused.dispatches", "fused.halo_gathers", "fused.member_rows",
          "sort.slots", "sort.keys", "ranges.calls", "K2.calls"}
# the device counts a run makes with them on (K3.bytes above PIECE_K_MIN)
DEVICE_COUNTS = {"K1.bytes", "K2.chain_adds", "K2.bytes"}


def _box(uniform):
    """A clump whose ball needs more than 2^14 slots (the row sort after
    a slotted gather), a smaller one, and four field centers."""
    rng = np.random.default_rng(1606)
    clumps = [dict(center=(0.1, 0.1, 0.1), n=1800, rmax=0.07,
                   mass_total=0.2),
              dict(center=(-0.2, 0.25, -0.3), n=900, rmax=0.05,
                   mass_total=0.08)]
    d = make_clumpy_box(rng, n_background=5000, clumps=clumps)
    n = d["pos"].shape[0]
    split = (0, n, 0) if uniform else (n // 5, n - n // 5 - n // 7, n // 7)
    if uniform:
        d["mass"] = np.full(n, np.float32(1.0 / n))
    hdr = TipsyHeader(time=1.0, nbodies=n, ndim=3, nsph=split[0],
                      ndark=split[1], nstar=split[2])
    ps = ParticleSet(hdr, d["pos"], d["vel"], d["mass"], d["phi"],
                     np.zeros(n, np.float32))
    centers = np.concatenate([
        np.array([c["center"] for c in clumps], np.float32),
        rng.uniform(-0.5, 0.5, (4, 3)).astype(np.float32)])
    rgtp = np.array([0.05, 0.04, 0.01, 0.02, 0.01, 0.02], np.float32)
    G = centers.shape[0]

    def catalog():
        return GroupCatalog(index=np.arange(1, G + 1, dtype=np.int32),
                            pos=centers.copy(), rgtp=rgtp,
                            gtp_mass=np.linspace(0.1, 0.01, G).astype(
                                np.float32),
                            n_in_gtp=G, gtp_time=1.0)
    return ps, catalog


def _params(uniform=False):
    return SOParams(threshold=178.0, device="cpu", survey=True,
                    species=() if uniform else (DARK, GAS, STAR))


@pytest.fixture(scope="module")
def recorded():
    """The general box's run_so with recording and device counts on: (run,
    spans, what the run added to profiling's totals and counts, G)."""
    ps, catalog = _box(False)
    totals, counts = dict(profiling.totals), dict(profiling.counts)
    profiling.start_recording(device_counts=True)
    try:
        run = run_so(ps, catalog(), _params())
    finally:
        spans = profiling.stop_recording()
    added = dict(totals=_added(profiling.totals, totals),
                 counts=_added(profiling.counts, counts))
    return run, spans, added, catalog().n


def _added(now, base):
    return {k: v - base.get(k, 0) for k, v in now.items()
            if v != base.get(k, 0)}


def _diff(base):
    return _added(profiling.totals, base)


def test_nesting_totals_and_self_time():
    base = dict(profiling.totals)
    profiling.start_recording()
    with span("t.outer") as outer:
        time.sleep(0.002)
        with span("t.inner"):
            time.sleep(0.003)
        profiling.start_recording()
        with span("t.inner"):
            pass
        inner_only = profiling.stop_recording()
    recs = profiling.stop_recording()
    d = _diff(base)
    assert d[("t.outer", "n")] == 1 and d[("t.inner", "n")] == 2
    assert d[("t.inner", "self_ns")] == d[("t.inner", "ns")]
    assert d[("t.outer", "self_ns")] == (d[("t.outer", "ns")]
                                         - d[("t.inner", "ns")])
    assert d[("t.outer", "ns")] == outer.t1 - outer.t0 >= 5_000_000
    assert [r[0] for r in inner_only] == ["t.inner"]
    assert [r[0] for r in recs] == ["t.inner", "t.inner", "t.outer"]
    sid = {r[0]: r[3] for r in recs}
    assert all(r[4] == sid["t.outer"] and r[5] == sid["t.outer"]
               for r in recs[:2])
    assert recs[2][4] is None and recs[2][5] == sid["t.outer"]
    assert all(s <= e for _, s, e, *_ in recs)
    assert recs[2][1] <= recs[0][1] and recs[1][2] <= recs[2][2]


def test_run_so_spans(recorded):
    run, spans, _, _ = recorded
    names = {r[0] for r in spans}
    assert names == SPANS
    roots = [r for r in spans if r[4] is None]
    assert [r[0] for r in roots] == ["run_so"]
    assert {r[5] for r in spans} == {roots[0][3]}       # one job id
    by_parent: dict = {}
    for r in spans:
        by_parent.setdefault(r[4], []).append(r[0])
    dispatches = [r for r in spans if r[0] == "solve.dispatch"]
    assert dispatches
    for d in dispatches:
        kids = set(by_parent.get(d[3], []))
        assert DISPATCH_CHILDREN <= kids <= DISPATCH_CHILDREN | {
            "solve.sort"}, kids
    name_of = {r[3]: r[0] for r in spans}
    assert {name_of[r[4]] for r in spans if r[0] == "gather.bytes"} == {
        "solve.gather", "fused.gather"}
    for name, seconds in run.phases.items():
        got = sum(e - s for n, s, e, *_ in spans if n == name) / 1e9
        assert got == pytest.approx(seconds, rel=1e-12, abs=0)


def test_run_so_counts(recorded):
    _, spans, added, G = recorded
    counts = {k[0]: v for k, v in added["counts"].items()}
    assert COUNTS | DEVICE_COUNTS <= set(counts) <= COUNTS | DEVICE_COUNTS | {
        "solve.overflow_regathers", "solve.ball_regrows", "K3.bytes"}
    assert counts["solve.halo_gathers"] >= G
    assert counts["solve.rounds"] >= 1
    assert 0 < counts["sort.keys"] < counts["sort.slots"]
    assert counts["solve.dispatches"] == sum(
        1 for r in spans if r[0] == "solve.dispatch")
    assert counts["fused.dispatches"] == sum(
        1 for r in spans if r[0] == "fused.dispatch")
    # every gather dispatch enumerates its cells once, the probes besides
    assert counts["ranges.calls"] >= (counts["solve.dispatches"]
                                      + counts["fused.dispatches"])
    assert added["totals"][("run_so", "n")] == 1


@pytest.mark.parametrize("uniform", [False, True], ids=["general",
                                                        "uniform"])
def test_ranges_counts_on_the_cpu(uniform, monkeypatch):
    """ranges.calls counts each enumeration at align > 1 of a CPU run_so,
    every one of them served by the plain version; ranges.kernel stays 0
    and the kernel never launches."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[6] if len(args) > 6 else kw.get("align", 1))
        return plain(*args, **kw)

    plain = ranges.cell_ranges_plain
    monkeypatch.setattr(ranges, "cell_ranges_plain", spy)
    monkeypatch.setattr(gather, "cell_ranges_plain", spy)
    ps, catalog = _box(uniform)
    base, launches = dict(profiling.counts), ranges.launches
    run_so(ps, catalog(), _params(uniform))
    added = {k[0]: v for k, v in _added(profiling.counts, base).items()}
    wide = sum(1 for a in calls if a > 1)
    assert wide > 0 and added["ranges.calls"] == wide
    assert "ranges.kernel" not in added
    assert ranges.launches == launches


# box512.deltas' thresholds: M200m, Mvir (so.c's Delta_vir at Omega0 0.3,
# -L, z 0, in f32) and M200c (200 / 0.3 in f32)
DELTAS = (200.0, 334.22216796875, 666.6666870117188)


def _deltas_box():
    """The benchmark generator's uniform-mass box (sobench/gen/make_box.py,
    the standard box's file cut to 2^13 particles and 32 centers), where
    some halos resolve at 666.67 a round before they do at 200."""
    import json
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    from sobench import harness

    config = json.loads((repo / "sobench/configs/standard.json").read_text())
    config.update(n_particles=1 << 13, n_halos=32)
    mix = json.loads((repo / "sobench/traffic/deltas.json").read_text())
    gen = harness.load_module(repo / "sobench/gen/make_box.py")
    inputs = harness.Inputs(gen.snapshot(config, mix, 180018, "cpu"))
    return inputs.particles(), inputs.catalog


def _multi_added(thresholds, box=_deltas_box, uniform=True):
    """run_so_multi on ``box()`` at ``thresholds`` with recording on:
    (what it added to totals and to counts, its spans)."""
    ps, catalog = box()
    totals, counts = dict(profiling.totals), dict(profiling.counts)
    profiling.start_recording()
    try:
        run_so_multi(ps, catalog(), _params(uniform), list(thresholds))
    finally:
        spans = profiling.stop_recording()
    return (_added(profiling.totals, totals),
            {k[0]: v for k, v in _added(profiling.counts, counts).items()},
            spans)


@pytest.mark.parametrize("thresholds", [DELTAS[:1], DELTAS],
                         ids=["one", "deltas"])
def test_run_so_multi_verdict_counts(thresholds):
    """multi.verdicts is T x the halos of every solve dispatch (the
    survey's classify included: solve.halo_gathers is the hand count);
    multi.verdicts_settled, the pairs rescanned after they resolved, is
    positive at the cell's three thresholds. At one threshold nothing is
    shared, and neither is counted."""
    _, counts, _ = _multi_added(thresholds)
    T = len(thresholds)
    if T == 1:
        assert counts["solve.halo_gathers"] > 0
        assert "multi.verdicts" not in counts
        assert counts.get("multi.verdicts_settled", 0) == 0
    else:
        assert counts["multi.verdicts"] == T * counts["solve.halo_gathers"]
        assert 0 < counts["multi.verdicts_settled"] < counts["multi.verdicts"]


def assert_post_spans(totals, spans, root):
    """One multi.post span a threshold of DELTAS, children of ``root``,
    each holding that threshold's post-solve phases."""
    assert totals[("multi.post", "n")] == len(DELTAS)
    sid = {r[3]: r for r in spans}
    posts = [r for r in spans if r[0] == "multi.post"]
    assert {sid[r[4]][0] for r in posts} == {root}
    for phase in ("members + derived (fused)", "conflict protocol",
                  "stats"):
        parents = [sid[r[4]] for r in spans if r[0] == phase]
        assert len(parents) == len(DELTAS)
        assert all(p[0] == "multi.post" for p in parents)


def test_run_so_multi_post_spans():
    """One multi.post span a threshold, children of run_so_multi, each
    holding that threshold's post-solve phases."""
    totals, _, spans = _multi_added(DELTAS)
    assert_post_spans(totals, spans, "run_so_multi")


def test_run_so_multi_distributed_post_spans(tmp_path):
    """run_so_multi_distributed as the one rank of a gloo process group
    opens the same multi.post spans, children of its root span, and its
    catalogs equal run_so_multi's."""
    import torch.distributed as dist

    ps, catalog = _box(False)
    h = ps.header
    snap = str(tmp_path / "snap.bin")
    write_snapshot(snap, dict(pos=ps.pos, vel=ps.vel, mass=ps.mass,
                              phi=ps.phi), split=(h.nsph, h.ndark, h.nstar))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        base = dict(profiling.totals)
        profiling.start_recording()
        try:
            runs = run_so_multi_distributed(snap, catalog(), _params(),
                                            list(DELTAS))
        finally:
            spans = profiling.stop_recording()
    finally:
        dist.destroy_process_group()
    assert_post_spans(_diff(base), spans, "run_so_multi_distributed")
    want = run_so_multi(ps, catalog(), _params(), list(DELTAS))
    for got, ref in zip(runs, want):
        for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
            np.testing.assert_array_equal(getattr(got.solve, f),
                                          getattr(ref.solve, f), err_msg=f)


def test_run_so_counts_unchanged_by_the_multi_counts():
    """run_so counts no multi.* count, and what it counts equals the same
    solve's counts under run_so_multi at its one threshold."""
    ps, catalog = _box(False)
    base = dict(profiling.counts)
    run_so(ps, catalog(), _params())
    single = {k[0]: v for k, v in _added(profiling.counts, base).items()}
    assert not any(k.startswith("multi.") for k in single)
    _, multi, _ = _multi_added((_params().threshold,),
                               lambda: (ps, catalog), False)
    assert multi == single


@pytest.mark.parametrize("uniform", [False, True], ids=["general",
                                                        "uniform"])
def test_recording_changes_no_output(recorded, uniform):
    """The catalogs bit for bit with recording on and off; with it off, no
    span is kept. The uniform box's spans are SPANS' too."""
    ps, catalog = _box(uniform)
    if uniform:
        profiling.start_recording()
        try:
            on = run_so(ps, catalog(), _params(True))
        finally:
            spans = profiling.stop_recording()
        names = {r[0] for r in spans}
        assert names <= SPANS
        assert "gather.bytes" not in names   # no device counts asked
    else:
        on = recorded[0]
    assert not profiling.recording()
    off = run_so(ps, catalog(), _params(uniform))
    assert profiling._records is None
    for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
        np.testing.assert_array_equal(getattr(on.solve, f),
                                      getattr(off.solve, f), err_msg=f)
    for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir"):
        np.testing.assert_array_equal(getattr(on.conflicts, f),
                                      getattr(off.conflicts, f), err_msg=f)
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        np.testing.assert_array_equal(getattr(on.derived, f),
                                      getattr(off.derived, f), err_msg=f)
    for a, b in zip(on.members, off.members):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_spans_on_the_profilers_clock():
    """Spans recorded inside a record_function lie within its kineto
    start and end (0.5 ms of slack)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("clock.outer"):
                with span("clock.a"):
                    time.sleep(0.001)
                with span("clock.b"):
                    pass
    recs = profiling.stop_recording()
    outer = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "clock.outer")
    assert len(outer) == 3 and len(recs) == 6
    slack = 500_000
    for i, (lo, hi) in enumerate(outer):
        for _, s, e, *_ in recs[2 * i:2 * i + 2]:
            assert lo - slack <= s <= e <= hi + slack


def _reckoning(grid, st, cnt, q, K, kernel, nchan, want_idx, sorted_form):
    """A launch's bytes by the docstring of gather.count_gather_bytes,
    written out per halo and run from cell_ranges' output."""
    chunk = grid.chunk
    NC = (K + chunk) // chunk
    seen = np.zeros(grid.soa8t.shape[1], bool)
    n_desc = 0
    for b in range(st.shape[0]):
        chunks = pieces = 0
        for s, c, o in zip(st[b], cnt[b], q[b]):
            if c <= 0:
                continue
            reach = min(c, K - o - s % chunk)
            if reach > 0:
                seen[s:s + reach] = True
            nch = -(-(s % chunk + c) // chunk)
            chunks += nch
            pieces += -(-nch // 2)
        n_desc += min(pieces if kernel == "K3" else chunks, NC)
    B = st.shape[0]
    per_desc = 5 if kernel == "K3" else 3
    return (12 * int(seen.sum()) + 4 * per_desc * n_desc + 4 * B
            + 4 * B * K * (1 + nchan + int(want_idx))
            + (8 * B if sorted_form else 0))


@pytest.mark.parametrize("case", [
    ("K1", "slotted", 512, ("mass",), False),
    ("K1", "sorted", 1024, ("mass", "meta"), True),
    ("K3", "slotted", 2048, (), True),
    ("K3", "sorted", 2048, ("mass",), False)],
    ids=["k1_slotted", "k1_sorted", "k3_slotted", "k3_row_sort"])
def test_gather_bytes(case, monkeypatch):
    kernel, form, K, chans, want_idx = case
    ps, _ = _box(False)
    grid = build_grid(ps.pos, ps.mass, device="cpu")
    if kernel == "K3":
        monkeypatch.setattr(gather, "PIECE_K_MIN", 512)
    centers = torch.as_tensor([[0.1, 0.1, 0.1], [0.11, 0.1, 0.09],
                               [-0.2, 0.25, -0.3], [0.3, -0.3, 0.0]])
    radii = torch.as_tensor([0.03, 0.02, 0.03, 0.05])
    level, S = solver._pick_level_span(grid, float(radii.max()))
    st, cnt, q, _ = (t.numpy() for t in gather.cell_ranges(
        grid, level, centers, radii, radii * radii, S, align=grid.chunk))
    base = {k: profiling.counts.get((k,), 0) for k in ("K1.bytes",
                                                       "K3.bytes")}
    profiling.start_recording(device_counts=True)
    if form == "slotted":
        gather.unsorted_gather(grid, level, centers, radii, radii * radii,
                               K, S, chans, want_idx)
    else:
        gather.slab_gather(grid, level, centers, radii, radii * radii, K,
                           S, chans + (("idx",) if want_idx else ()))
    profiling.stop_recording()
    got = {k: profiling.counts.get((k,), 0) - v for k, v in base.items()}
    other = "K1" if kernel == "K3" else "K3"
    want = _reckoning(grid, st, cnt, q, K, kernel, len(chans), want_idx,
                      form == "sorted" and kernel == "K1")
    assert got[f"{kernel}.bytes"] == want
    assert got[f"{other}.bytes"] == 0


def test_bytes_counted_only_when_asked():
    """No bytes are counted, and nothing is kept for them, outside a
    recording with device counts, plain recording included."""
    ps, _ = _box(False)
    grid = build_grid(ps.pos, ps.mass, device="cpu")
    c = torch.as_tensor([[0.1, 0.1, 0.1]])
    r = torch.as_tensor([0.03])
    base = dict(profiling.counts)
    gather.slab_gather(grid, 1, c, r, r * r, 1024, 3)
    profiling.start_recording()
    gather.slab_gather(grid, 1, c, r, r * r, 1024, 3)
    assert not profiling._device_counts
    profiling.start_recording(device_counts=True)
    gather.slab_gather(grid, 1, c, r, r * r, 1024, 3)
    assert profiling.counting() and profiling._device_counts
    profiling.stop_recording()
    assert not profiling.counting() and not profiling._device_counts
    profiling.stop_recording()
    d = {k: v - base.get(k, 0) for k, v in profiling.counts.items()
         if v != base.get(k, 0)}
    assert set(d) == {("K1.bytes",), ("ranges.calls",)}
    assert d[("ranges.calls",)] == 3    # the enumeration is always counted


def test_phase_timer_reports_its_own_spans():
    """Each timer prints the spans inside each of its phases, counted for
    its own phases alone."""
    for _ in range(2):
        t = PhaseTimer()
        with t.phase("solve-like"):
            with span("kid.a"):
                with span("kid.b"):
                    pass
        with t.phase("other"):
            pass
        buf = io.StringIO()
        t.report(out=buf)
        lines = buf.getvalue().splitlines()
        i = lines.index(next(ln for ln in lines if "solve-like" in ln))
        kid = [ln.split() for ln in lines[i + 1:i + 3]]
        assert {k[0] for k in kid} == {"kid.a", "kid.b"}
        assert all(k[2] == "self" and k[-1] == "1" for k in kid)
        assert "other" in lines[i + 3]


def test_profile_trace_shows_the_spans(tmp_path):
    """Under --profile (profile_trace) every span is also a
    record_function, so the Chrome trace names the program's own
    structure."""
    import json

    ps, catalog = _box(False)
    params = _params()
    params.profile_dir = str(tmp_path)
    run_so(ps, catalog(), params)
    events = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"run_so", "R_Delta solve", "solve.dispatch", "solve.fetch",
            "fused.split", "conflicts.walk"} <= names
    assert profiling._traced == 0
