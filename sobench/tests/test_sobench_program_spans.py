"""The readers of the program's own spans and counters
(sobench/program_spans.py and the metrics built on it) on hand-built
records, None where the program left nothing to read, and a traced CPU run
of a small cell that reports the host ones."""

import json

import pytest

from conftest import REPO, TINY_MIX, add_cell, quiet

from sobench import harness
from sobench import trace as tr

MS = 1_000_000
HOST = ("solve_fetch_s", "solve_host_s", "solve_regathers", "fused_host_s",
        "conflicts_prep_s", "derived_s")
TRACED = ("solve_idle_host_ms", "solve_idle_enqueue_ms", "k1_roofline",
          "k3_roofline")


def metric(name):
    return harness.load_module(REPO / "sobench" / "metrics" / f"{name}.py")


def hand_built():
    """Two reruns of the traced window's jobs (what they added to the
    program's totals and counts), its counted rerun (the bytes), and one
    traced job of 100 ms whose program spans leave the card idle in
    places."""
    rerun = dict(jobs=2, halos=200, totals={
        ("solve.fetch", "n"): 4, ("solve.fetch", "ns"): 40 * MS,
        ("solve.plan", "n"): 6, ("solve.plan", "self_ns"): 12 * MS,
        ("solve.apply", "n"): 4, ("solve.apply", "self_ns"): 8 * MS,
        ("fused.split", "n"): 2, ("fused.split", "self_ns"): 6 * MS,
        ("fused.vcm", "n"): 2, ("fused.vcm", "self_ns"): 2 * MS,
        ("conflicts.order", "n"): 2, ("conflicts.order", "ns"): 4 * MS,
        ("conflicts.prep", "n"): 2, ("conflicts.prep", "ns"): 10 * MS,
        ("derived quantities", "n"): 2,
        ("derived quantities", "ns"): 16 * MS},
        counts={("solve.halo_gathers",): 300})
    counted = dict(jobs=1, halos=100, totals={},
                   counts={("K1.bytes",): 3.35e9 * 2,
                           ("K3.bytes",): 3.35e9 * 4})
    spans = [("run_so", 1 * MS, 99 * MS, 1, None, 1),
             ("solve.plan", 10 * MS, 20 * MS, 2, 1, 1),
             ("solve.dispatch", 20 * MS, 60 * MS, 3, 1, 1),
             ("solve.ranges", 20 * MS, 30 * MS, 4, 3, 1),
             ("solve.gather", 30 * MS, 35 * MS, 5, 3, 1),
             ("solve.fetch", 35 * MS, 50 * MS, 6, 3, 1),
             ("solve.apply", 50 * MS, 60 * MS, 7, 3, 1)]
    ops = [("void slab_gather_kernel<1>(float const*)", 30 * MS, 40 * MS),
           ("void piece_gather_kernel(float const*)", 40 * MS, 45 * MS),
           ("void at::native::elementwise_kernel()", 55 * MS, 58 * MS)]
    trace = tr.Trace(ops=ops, spans=[(tr.JOB_SPAN, 0, 100 * MS)],
                     notes=dict(program_spans=spans, program_rerun=rerun,
                                program_counted=counted))
    jobs = [dict(wall=0.1, halos=100, phases={}) for _ in range(2)]
    return dict(jobs=jobs, trace=trace, setup_s=1.0)


def test_host_metrics_read_the_reruns():
    rec = hand_built()
    assert metric("solve_fetch_s").read(rec) == pytest.approx(0.020)
    assert metric("solve_host_s").read(rec) == pytest.approx(0.010)
    assert metric("solve_regathers").read(rec) == pytest.approx(1.5)
    assert metric("fused_host_s").read(rec) == pytest.approx(0.004)
    assert metric("conflicts_prep_s").read(rec) == pytest.approx(0.007)
    assert metric("derived_s").read(rec) == pytest.approx(0.008)


def test_idle_by_innermost_program_span():
    rec = hand_built()
    # idle 0-30 (run_so 1-10, solve.plan 10-20, solve.ranges 20-30),
    # 45-55 (fetch 45-50, apply 50-55), 58-100 (apply 58-60, run_so 60-99)
    assert metric("solve_idle_host_ms").read(rec) == pytest.approx(
        10 + 5 + 2)
    assert metric("solve_idle_enqueue_ms").read(rec) == pytest.approx(10.0)
    from sobench import program_spans as ps
    idle = ps.idle_by_span(rec)
    assert idle["solve.fetch"] == 5 * MS
    assert idle["run_so"] == 48 * MS
    assert idle["between jobs"] == 2 * MS
    assert ps.alignment(rec) == [(1 * MS, 1 * MS)]


def test_rooflines_from_the_programs_bytes():
    rec = hand_built()
    # 2 ms of bytes at 3.35 TB/s over 10 ms of K1; 4 ms over 5 ms of K3
    assert metric("k1_roofline").read(rec) == pytest.approx(20.0)
    assert metric("k3_roofline").read(rec) == pytest.approx(80.0)


@pytest.mark.parametrize("name", HOST + TRACED)
def test_nothing_to_read_is_none(name):
    """Without the recorder's notes (a program that lacks it), without a
    trace, or without the spans, counts and kernels a metric reads."""
    m = metric(name)
    rec = hand_built()
    assert m.read(dict(rec, trace=None)) is None
    rec["trace"].notes.clear()
    assert m.read(rec) is None
    empty = hand_built()
    notes = empty["trace"].notes
    notes["program_rerun"].update(totals={}, counts={})
    notes["program_counted"].update(counts={})
    notes["program_spans"] = []
    assert m.read(empty) is None


@pytest.fixture
def fake_entry(monkeypatch):
    """The pipeline's run_so replaced by a stand-in that opens two spans,
    counts, and counts bytes on the device when asked; it logs whether it
    was counting each time."""
    import torch
    from types import SimpleNamespace

    from so_tpu_torch import profiling
    from so_tpu_torch.engine import pipeline

    seen = []

    def run_so(particles, catalog, params):
        seen.append(profiling.counting())
        with profiling.span("run_so"):
            with profiling.span("solve.fetch"):
                profiling.counts[("solve.halo_gathers",)] += 3
                if profiling.counting():
                    profiling.count_on_device("K3.bytes", torch.tensor(7))
        catalog.pos = None             # a run may rebind its catalog's pos
        return SimpleNamespace(catalog=SimpleNamespace(n=2))

    monkeypatch.setattr(pipeline, "run_so", run_so)
    return pipeline, run_so, seen


def test_install_records_once_a_window(fake_entry):
    from types import SimpleNamespace

    from so_tpu_torch import profiling

    from sobench import program_spans as ps

    pipeline, run_so, seen = fake_entry
    notes: dict = {}
    undo = ps.install(notes)
    assert ps.install(notes)() is None          # the second is a no-op
    assert profiling.recording() and not profiling.counting()
    catalog = SimpleNamespace(pos="centers")
    pipeline.run_so("particles", catalog, "params")
    undo()
    assert not profiling.recording()
    assert pipeline.run_so is run_so
    assert [s[0] for s in notes["program_spans"]] == ["solve.fetch",
                                                      "run_so"]
    (fn, args, kw), = notes["program_calls"]
    assert fn is run_so and kw == {} and args[1].pos == "centers"


def test_rerun_counts_the_bytes_out_of_the_traced_window(fake_entry):
    """The traced window's call ran with no device counts; its plain rerun
    adds its spans and counts, its counted rerun the bytes, each once a
    record."""
    from types import SimpleNamespace

    from sobench import program_spans as ps

    pipeline, _, seen = fake_entry
    notes: dict = {}
    undo = ps.install(notes)
    pipeline.run_so("particles", SimpleNamespace(pos=0), "params")
    undo()
    rec = dict(jobs=[], setup_s=0.0,
               trace=tr.Trace(ops=[], spans=[], notes=notes))
    r = ps.rerun(rec)
    assert ps.rerun(rec) is r and seen == [False, False]
    assert (r["jobs"], r["halos"]) == (1, 2)
    assert r["counts"] == {("solve.halo_gathers",): 3}
    assert r["totals"][("run_so", "n")] == 1
    assert r["totals"][("solve.fetch", "n")] == 1
    assert metric("solve_regathers").read(rec) == pytest.approx(1.5)
    c = ps.counted(rec)
    assert ps.counted(rec) is c and seen == [False, False, True]
    assert c["counts"] == {("solve.halo_gathers",): 3, ("K3.bytes",): 7}


def test_traced_cpu_run_reports_the_host_metrics(bench_root):
    """A small cell with the new metrics listed for it: the traced CPU run
    reports each host metric; the trace metrics read nothing on the CPU
    (no device ops, no kernel time) and are left out."""
    name = add_cell(bench_root, "tiny3", "species3", 1 << 13, 64,
                    TINY_MIX, base_mix="species")
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in HOST + TRACED:
            m["workloads"].append(name)
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(name, bench_root)
    out = harness.run_cell(cell, 91, 0.0, True, device="cpu", log=quiet)
    assert out["correct"], out["checks"]
    assert set(HOST) <= set(out["metrics"])
    assert not set(TRACED) & set(out["metrics"])
    assert out["metrics"]["solve_regathers"]["value"] >= 1.0
