#!/usr/bin/env python3
"""What the program's own spans and counters (so_tpu_torch.profiling) cost
and what they show, on the benchmark's cells, on one CUDA card. Not part
of the benchmark.

    python3 span_study.py [--cells box512.uniform,standard.species]
                          [--pairs N] [--seed S] [--device cuda]
                          [--sides off,on,counting,bare]

1. The cost of a span on this host: nanoseconds a span (nested in a root
   span, as the engine opens them), recording off and on, against an
   empty context manager; and what torch.profiler adds to a small torch
   op on the host (an add on a 1,024-float tensor of the device, the
   kind of op cell_ranges enqueues), microseconds an op with and without
   the profiler.
2. For each cell of BENCHMARK.json (set up as sobench/run.py does: its
   snapshots from the seed, its warm-up): N rounds of jobs with recording
   off, on (spans only, as in a traced window), on with device counts
   (as in the traced window's counted rerun) and with the spans cut to
   their clock reads ("bare": what the always-on spans cost), in turns:
   job wall seconds of each side (median and range) and the spans a
   job.
3. The cell's untraced window of jobs (at least 2), then its traced window
   under torch.profiler as sobench/run.py runs it, every per-layer metric
   of the cell read as the result line reads it, and from the same trace:
   the offsets of the program's root span inside each sobench.job span;
   the self time of the "R_Delta solve" span outside its child spans;
   the card's idle time inside the solve and inside the fused pass, by
   the innermost program span; the span totals a traced job, against
   those of its untraced rerun (the profiler's cost by span); the
   reruns' job seconds (after the profiler, against the on/off rounds
   before it); K1's and K3's bytes and device time.

Before the cells: the offsets of a span recorded inside a
torch.profiler record_function from the event's own start and end.

The last line of its output holds the readings as one JSON object; with
``--out FILE`` they are also written to FILE.
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SOLVE_BUCKETS = {
    "host (solve.plan, solve.apply)": ("solve.plan", "solve.apply"),
    "enqueue (solve.ranges, .gather, .sort, .scan)": (
        "solve.ranges", "solve.gather", "solve.sort", "solve.scan"),
    "fetch (solve.fetch)": ("solve.fetch",),
}
FUSED_BUCKETS = {
    "host (fused.split, .vcm, .fill, .members_list)": (
        "fused.split", "fused.vcm", "fused.fill", "fused.members_list"),
    "enqueue (fused.gather)": ("fused.gather",),
    "fetch (fused.fetch)": ("fused.fetch",),
    "probe (fused.probe)": ("fused.probe",),
}


def log(msg):
    print(msg, flush=True)


def span_cost(n=200_000):
    """ns a loop turn: bare, with an empty context manager, then with a
    span nested in a root span, recording off and on; each the median of
    5 rounds."""
    from so_tpu_torch import profiling

    def rounds(make):
        out = []
        for _ in range(5):
            with profiling.span("study.root"):
                t0 = time.perf_counter_ns()
                if make is None:
                    for _ in range(n):
                        pass
                else:
                    for _ in range(n):
                        with make():
                            pass
                out.append((time.perf_counter_ns() - t0) / n)
        return statistics.median(out)

    bare = rounds(None)
    empty = rounds(contextlib.nullcontext)
    off = rounds(lambda: profiling.span("study.span"))
    profiling.start_recording()
    on = rounds(lambda: profiling.span("study.span"))
    profiling.stop_recording()
    return dict(bare_ns=bare, empty_ns=empty, off_ns=off, on_ns=on,
                off_over_bare_ns=off - bare, on_over_bare_ns=on - bare)


def profiler_op_cost(device, n=20_000):
    """us a small torch op takes on the host (an add on a 1,024-float
    tensor of ``device``, synced at the end), without and under
    torch.profiler (CPU and, on a card, CUDA activities); each the
    median of 3 rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1024, device=device)

    def rounds():
        out = []
        for _ in range(3):
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(n):
                x.add_(1.0)
            _sync(device)
            out.append((time.perf_counter() - t0) / n * 1e6)
        return statistics.median(out)

    plain = rounds()
    acts = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        traced = rounds()
    return dict(plain_us=plain, profiled_us=traced,
                added_us=traced - plain)


def clock_probe(n=200):
    """Offsets (ns) of a span recorded inside a record_function from the
    event's kineto start and end: (min, median, max) of each."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from so_tpu_torch import profiling

    profiling.start_recording()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            with record_function("study.clock"):
                with profiling.span("study.clock"):
                    pass
    recs = profiling.stop_recording()
    ev = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                for e in prof.profiler.kineto_results.events()
                if e.name() == "study.clock")
    start = [r[1] - a for r, (a, _) in zip(recs, ev)]
    end = [b - r[2] for r, (_, b) in zip(recs, ev)]

    def three(v):
        return dict(min=min(v), median=statistics.median(v), max=max(v))
    return dict(n=len(ev), start_after_ns=three(start),
                end_before_ns=three(end))


def rerun_totals(record):
    """Per-job mean of the span totals by name over the reruns of the
    traced window's jobs (program_spans.rerun): (ns, self ns, n)."""
    from sobench import program_spans as ps

    r = ps.rerun(record)
    out: dict = {}
    if r is not None:
        for (name, field), v in r["totals"].items():
            out.setdefault(name, {})[field] = v / r["jobs"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1].get("ns", 0)))


def _sync(device):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


SIDES = ("off", "on", "counting", "bare")


@contextlib.contextmanager
def bare_spans():
    """The span class cut to its two clock reads (PhaseTimer reads them):
    no totals, nesting or records, so a job runs as with no spans."""
    from so_tpu_torch import profiling

    cls = profiling.Span
    saved = {k: cls.__dict__[k] for k in ("__init__", "__enter__",
                                          "__exit__")}

    def init(self, name):
        self.name = name

    def enter(self):
        self.t0 = time.perf_counter_ns()
        return self

    def leave(self, *exc):
        self.t1 = time.perf_counter_ns()
        return False

    for k, f in zip(saved, (init, enter, leave)):
        setattr(cls, k, f)
    try:
        yield
    finally:
        for k, f in saved.items():
            setattr(cls, k, f)


def on_off(cell, inputs, device, pairs, first, sides=SIDES):
    """Job walls with recording off, on (spans only, as in a traced
    window), on with device counts (as in its counted rerun), and with
    the spans cut to their clock reads ("bare"), in turns; spans a
    job."""
    from so_tpu_torch import profiling

    from sobench import harness

    walls = {side: [] for side in sides}
    n_spans = {side: [] for side in ("on", "counting") if side in sides}
    k = first
    for p in range(pairs):
        order = sides[p % len(sides):] + sides[:p % len(sides)]
        for side in order:
            inp = inputs[k % len(inputs)]
            k += 1
            if side in n_spans:
                profiling.start_recording(device_counts=side == "counting")
            t0 = time.perf_counter()
            try:
                with (bare_spans() if side == "bare"
                      else contextlib.nullcontext()):
                    harness.run_job(inp, cell, device)
                    _sync(device)
            finally:
                if side in n_spans:
                    n_spans[side].append(len(profiling.stop_recording()))
            walls[side].append(time.perf_counter() - t0)
    out = {}
    for side, v in walls.items():
        out[side] = dict(median_s=statistics.median(v), min_s=min(v),
                         max_s=max(v), walls=v)
        if side != "off":
            out[side + "_over_off"] = (out[side]["median_s"]
                                       / out["off"]["median_s"])
    for side, v in n_spans.items():
        out["spans_a_job_" + side] = dict(median=statistics.median(v),
                                          min=min(v), max=max(v))
    return out, k


def _root_s(r):
    """Seconds a job of a rerun's root spans (run_so, run_so_multi)."""
    if r is None:
        return None
    return sum(v for (n, f), v in r["totals"].items() if f == "ns"
               and n in ("run_so", "run_so_multi")) / 1e9 / r["jobs"]


def traced_totals(spans, n_jobs):
    """Per traced job, the recorded spans' ns by name."""
    out: dict = {}
    for name, s, e, *_ in spans:
        out[name] = out.get(name, 0) + (e - s) / max(n_jobs, 1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def solve_coverage(spans):
    """(self ns of "R_Delta solve" outside its direct children, its ns)
    summed over its spans."""
    kids: dict = {}
    for name, s, e, sid, parent, job in spans:
        kids.setdefault(parent, []).append(e - s)
    total = self_ns = 0
    for name, s, e, sid, parent, job in spans:
        if name.startswith("R_Delta solve"):
            total += e - s
            self_ns += (e - s) - sum(kids.get(sid, []))
    return self_ns, total


def buckets(idle, table, prefix):
    """Idle ns a job grouped by ``table``; the rest of the names with
    ``prefix`` (and the phase's own span) as "other"."""
    out = {k: sum(idle.get(n, 0) for n in names) for k, names in
           table.items()}
    named = {n for names in table.values() for n in names}
    out["other (" + prefix + "* self, the phase's own and its syncs)"] = sum(
        v for n, v in idle.items()
        if n not in named and (n.startswith(prefix) or n == "phase.sync"))
    return out


def trace_readings(cell, record, trace):
    from sobench import harness
    from sobench import program_spans as ps
    from sobench import trace as tr

    spans = trace.notes.get("program_spans") or []
    metrics = {}
    for m in cell.per_layer:
        v = harness.metric_module(cell, m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = v
    align = ps.alignment(record) or []
    self_ns, solve_ns = solve_coverage(spans)
    idle = ps.idle_by_span(record) or {}
    n_jobs = len(trace.jobs())
    solve_idle = buckets(idle, SOLVE_BUCKETS, "solve.")
    fused_idle = buckets(idle, FUSED_BUCKETS, "fused.")
    k_ns = {k: tr.device_ns(trace, lambda n, k=k: k in n)
            for k in ("slab_gather_kernel", "slab_gather_sorted_kernel",
                      "piece_gather_kernel")}
    win = trace.window()
    busy = tr.union_ns([(s, e) for _, s, e in trace.ops], *win)
    return dict(
        metrics=metrics, traced_jobs=n_jobs,
        rerun_span_totals_a_job=rerun_totals(record),
        traced_span_ns_a_job=traced_totals(spans, n_jobs),
        spans_a_traced_job=len(spans) / max(n_jobs, 1),
        root_offsets_ns=align,
        worst_root_offset_ns=(min(min(a, b) for a, b in align)
                              if align else None),
        solve_self_ns=self_ns, solve_ns=solve_ns,
        solve_self_share=self_ns / solve_ns if solve_ns else None,
        idle_by_span_ns_a_job=dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1])),
        solve_idle_ns_a_job=solve_idle,
        solve_idle_total_ns_a_job=sum(solve_idle.values()),
        fused_idle_ns_a_job=fused_idle,
        program_bytes={k[0]: v for k, v in
                       (ps.counted(record) or {}).get("counts", {}).items()
                       if k[0].endswith(".bytes")},
        rerun_root_s=_root_s(ps.rerun(record)),
        counted_root_s=_root_s(ps.counted(record)),
        kernel_device_ns=k_ns,
        window_s=(win[1] - win[0]) / 1e9, busy_s=busy / 1e9)


def study_cell(name, seed, pairs, device, root, sides=SIDES):
    from sobench import harness

    cell = harness.load_cell(name, root)
    t0 = time.perf_counter()
    gen = harness.load_module(cell.root / "sobench" / "gen"
                              / f"{cell.config['generator']}.py")
    snaps = [gen.snapshot(cell.config, cell.mix, (int(seed) << 4) + i,
                          device)
             for i in range(int(cell.mix["snapshots"]))]
    inputs = [harness.Inputs(s) for s in snaps]
    harness.warm_up(inputs, cell, device, seed)
    _sync(device)
    log(f"[study] {name}: set-up {time.perf_counter() - t0:.3f} s")
    onoff, k = on_off(cell, inputs, device, pairs, 0, sides)
    log(f"[study] {name}: on/off {json.dumps(onoff)}")
    n_win = max(2, int(cell.mix["trace"]["jobs"]))
    jobs, _, _ = harness.window(inputs, cell, device, 0.0, False, seed,
                                log, n_win, k)
    _, _, trace = harness.window(inputs, cell, device, 0.0, True, seed, log,
                                 int(cell.mix["trace"]["jobs"]), k + n_win)
    record = dict(setup_s=0.0, jobs=jobs, trace=trace)
    out = dict(cell=name, on_off=onoff, **trace_readings(cell, record,
                                                         trace))
    log(f"[study] {name}: {json.dumps(out)}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", default="standard.species,box512.uniform")
    ap.add_argument("--pairs", type=int, default=0,
                    help="on/off pairs a cell (default: 10, box512 2)")
    ap.add_argument("--seed", type=int, default=2_900_001_607)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose BENCHMARK.json names the cells")
    ap.add_argument("--sides", default=",".join(SIDES),
                    help="the on/off rounds' sides, in turn (\"off\" first)")
    ap.add_argument("--out", help="also write the readings to this file")
    a = ap.parse_args()
    import subprocess

    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        log("[study] no CUDA device")
        return 2
    cache = os.path.join(HERE, ".sobench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    card = None
    if a.device.startswith("cuda"):
        from so_tpu_torch.ops import _cuda

        _cuda.library()
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True)
        card = r.stdout.strip()
    from so_tpu_torch import native

    native.get_lib()
    res = dict(card=card, torch=torch.__version__, span_cost=span_cost(),
               op_cost=profiler_op_cost(a.device), clock=clock_probe())
    log(f"[study] span cost {json.dumps(res['span_cost'])}")
    log(f"[study] op cost {json.dumps(res['op_cost'])}")
    log(f"[study] clock {json.dumps(res['clock'])}")
    res["cells"] = []
    for name in a.cells.split(","):
        pairs = a.pairs or (2 if name.startswith("box512") else 10)
        res["cells"].append(study_cell(name, a.seed, pairs, a.device,
                                       Path(a.root),
                                       tuple(a.sides.split(","))))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
