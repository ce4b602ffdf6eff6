"""The program's own spans and counters (so_tpu_torch.profiling), as the
metrics read them.

Every metric here reads what ``install(notes)`` leaves in a traced run's
notes. It runs once a window, for whichever metric asks first, at the
start of the traced window, and its undo at the end:

- "program_spans": every span of the traced window, (name, start_ns,
  end_ns, span id, parent id, job id) on the profiler's clock, as the
  device ops are. They are recorded without the program's device counts,
  so the traced window runs on the card what an untraced one runs;
- "program_calls": the traced window's calls of the pipeline's entries
  (run_so, run_so_multi) with their arguments.

The span and count metrics come from ``rerun(record)``: once the traced
window is over, each of its calls runs again as an untraced job, and the
metrics read what those runs add to the program's ``totals`` and
``counts``. The rooflines' bytes come from ``counted(record)``, the same
calls run once more with the program's device counts on (the K1 and K3
bytes); a job's launches follow from its inputs, so they are the traced
jobs' bytes. Each runs once a record, when a metric first asks, and is
kept in the notes ("program_rerun", "program_counted"), so a traced run
takes two more jobs for each traced one.

A program without the recorder leaves none of them and reruns nothing,
and every reader then returns None.
"""

from __future__ import annotations

import copy
import importlib

from sobench import trace as tr

MODULE = "so_tpu_torch.profiling"
PIPELINE = "so_tpu_torch.engine.pipeline"
ENTRIES = ("run_so", "run_so_multi")
HBM_BYTES_PER_S = 3.35e12     # one H100 SXM's device memory, data sheet


def install(notes):
    """Record the program's spans over the traced window (no device
    counts) and keep its calls of the pipeline's entries; the undo stops
    both. A program without the recorder is left as it is."""
    if "program_spans" in notes:
        return lambda: None
    try:
        prof = importlib.import_module(MODULE)
        pipe = importlib.import_module(PIPELINE)
    except ImportError:
        return lambda: None
    if getattr(prof, "counting", None) is None:
        return lambda: None
    calls = notes["program_calls"] = []
    entries = {name: getattr(pipe, name) for name in ENTRIES}

    def keep(fn):
        def entry(*args, **kw):
            # shallow copies: a run may rebind its catalog's pos
            calls.append((fn, [copy.copy(a) for a in args], dict(kw)))
            return fn(*args, **kw)
        return entry

    for name, fn in entries.items():
        setattr(pipe, name, keep(fn))
    notes["program_spans"] = None
    prof.start_recording()

    def undo():
        notes["program_spans"] = prof.stop_recording()
        for name, fn in entries.items():
            setattr(pipe, name, fn)
    return undo


def _added(now, base: dict) -> dict:
    return {k: v - base.get(k, 0) for k, v in dict(now).items()
            if v != base.get(k, 0)}


def _run_calls(prof, calls, device_counts: bool) -> dict:
    """Run ``calls`` again: dict(jobs, halos, totals, counts), the last two
    what they added to the program's ``totals`` and ``counts``."""
    totals, counts = dict(prof.totals), dict(prof.counts)
    halos = 0
    if device_counts:
        prof.start_recording(device_counts=True)
    try:
        for fn, args, kw in calls:
            runs = fn(*args, **kw)
            runs = runs if isinstance(runs, list) else [runs]
            halos += sum(r.catalog.n for r in runs)
    finally:
        if device_counts:
            prof.stop_recording()
    return dict(jobs=len(calls), halos=halos,
                totals=_added(prof.totals, totals),
                counts=_added(prof.counts, counts))


def _rerun(record, key: str, device_counts: bool):
    trace = record.get("trace")
    if trace is None:
        return None
    notes = trace.notes
    if key not in notes:
        if not notes.get("program_calls"):
            return None
        notes[key] = _run_calls(importlib.import_module(MODULE),
                                notes["program_calls"], device_counts)
    return notes[key]


def rerun(record):
    """The traced window's calls run again as untraced jobs, once a
    record, for the span and count metrics: dict(jobs, halos, totals,
    counts); None without a recording."""
    return _rerun(record, "program_rerun", False)


def counted(record):
    """The traced window's calls run again with the device counts on, once
    a record, for the K1/K3 bytes (their counting's own host time would
    shorten the solve.fetch waits, so no host metric reads this run); as
    rerun(), None without a recording."""
    return _rerun(record, "program_counted", True)


def span_s(record, names, field: str = "ns"):
    """Seconds per rerun job of the spans ``names`` (their ``field``:
    "ns" the whole, "self_ns" less their children); None without reruns,
    or when none of the names ran."""
    r = rerun(record)
    if r is None or not any((n, "n") in r["totals"] for n in names):
        return None
    ns = sum(r["totals"].get((n, field), 0) for n in names)
    return ns / 1e9 / r["jobs"]


def per_halo(record, name: str):
    """The program's count ``name`` over the reruns, per halo; None
    without reruns or when it never counted it."""
    r = rerun(record)
    if r is None or (name,) not in r["counts"] or not r["halos"]:
        return None
    return r["counts"][(name,)] / r["halos"]


def spans_of(record):
    """(name, start_ns, end_ns) of the recorded program spans, or None."""
    trace = record.get("trace")
    if trace is None or not trace.notes.get("program_spans"):
        return None
    return [(n, s, e) for n, s, e, *_ in trace.notes["program_spans"]]


def idle_by_span(record):
    """Nanoseconds per traced job in which no device op ran, by the
    innermost program span open on the host ("between jobs" where none
    is), over the traced window; None without program spans or device
    ops."""
    trace = record.get("trace")
    spans = spans_of(record)
    win = trace.window() if trace is not None else None
    if spans is None or win is None or not trace.ops:
        return None
    segs = tr.labelled(tr.Trace(ops=[], spans=spans))
    first = segs[0][0] if segs else win[1]
    last = segs[-1][1] if segs else win[1]
    segs = ([(win[0], first, "between jobs")] + segs
            + [(last, win[1], "between jobs")])
    idle: dict = {}
    k = 0
    for s, e in tr.gaps([(a, b) for _, a, b in trace.ops], *win):
        while k < len(segs) and segs[k][1] <= s:
            k += 1
        i = k
        while i < len(segs) and segs[i][0] < e:
            a, b, name = segs[i]
            if b > a:
                idle[name] = idle.get(name, 0) + min(b, e) - max(a, s)
            i += 1
    n_jobs = len(trace.jobs())
    return {name: v / n_jobs for name, v in idle.items()}


def idle_ms(record, names):
    """Device idle milliseconds per traced job under the innermost program
    spans ``names``; None without a recording or device ops."""
    idle = idle_by_span(record)
    if idle is None:
        return None
    return sum(idle.get(n, 0) for n in names) / 1e6


def roofline_pct(record, count: str, kernels):
    """100 x (the program's ``count`` bytes over the counted reruns of the
    traced window's jobs / HBM bandwidth) / the traced device time of the
    ``kernels`` (substrings of device op names); None without bytes or
    kernel time."""
    trace = record.get("trace")
    if trace is None:
        return None
    r = counted(record)
    nbytes = r["counts"].get((count,)) if r is not None else None
    if not nbytes:
        return None
    ns = tr.device_ns(trace, lambda n: any(k in n for k in kernels))
    if not ns:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / (ns / 1e9)


def alignment(record):
    """Per traced job (the harness's sobench.job span), how far the
    program's root spans inside it start after it and end before it, in
    ns: [(start_gap, end_gap), ...]; a negative gap is a root span poking
    out of the job. None without a recording."""
    trace = record.get("trace")
    if trace is None or not trace.notes.get("program_spans"):
        return None
    roots = sorted((s, e) for _, s, e, _, parent, _ in
                   trace.notes["program_spans"] if parent is None)
    out = []
    for js, je in trace.jobs():
        inside = [(s, e) for s, e in roots if s < je and e > js]
        if inside:
            out.append((inside[0][0] - js, je - inside[-1][1]))
    return out
