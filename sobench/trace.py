"""The traced run: spans around the program's layer entries, a
torch.profiler trace of the window, and the arithmetic that reduces it.

The spans are ``torch.profiler.record_function`` ranges put around the
entries (module, attribute) that ``sobench/spans.json`` names, from this
file: the program is not edited. An
entry that a later version of the program no longer has is skipped, and
the metrics that read its span then find nothing. Each job of the traced
window is one "sobench.job" span, so the trace's own clock gives the
window.

Times are nanoseconds on the profiler's clock. A device op is any event
that ran on the card (kernel, copy, set) and is not a span mirrored there.
"""

from __future__ import annotations

import bisect
import functools
import importlib
from dataclasses import dataclass, field

JOB_SPAN = "sobench.job"


@dataclass
class Trace:
    ops: list            # (name, start_ns, end_ns) of device ops
    spans: list          # (name, start_ns, end_ns) of host spans
    notes: dict = field(default_factory=dict)   # what metric hooks kept

    def jobs(self) -> list:
        return sorted((s, e) for n, s, e in self.spans if n == JOB_SPAN)

    def window(self):
        jobs = self.jobs()
        return (jobs[0][0], jobs[-1][1]) if jobs else None


def _span(name, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return wrapped


def install_spans(spans: list) -> list:
    """Wrap each entry (name, module, attr) in a span; return the undo
    list."""
    undo = []
    for s in spans:
        try:
            mod = importlib.import_module(s["module"])
        except ImportError:
            continue
        fn = getattr(mod, s["attr"], None)
        if fn is None:
            continue
        setattr(mod, s["attr"], _span(s["name"], fn))
        undo.append((mod, s["attr"], fn))
    return undo


def uninstall(undo: list) -> None:
    for mod, attr, fn in reversed(undo):
        setattr(mod, attr, fn)


def is_device_op(activity: str, name: str) -> bool:
    """A kernel, copy or set on the card: not a span mirrored there, not a
    synchronisation record."""
    return ("annotation" not in activity.lower()
            and "sync" not in activity.lower()
            and not name.endswith("Sync") and "Synchroniz" not in name)


def events_of(prof, span_names) -> tuple:
    """(device ops, host spans named in ``span_names``) from a finished
    torch.profiler.profile, read from its raw results (no per-event Python
    tree is built)."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        dev = str(e.device_type())
        act = getattr(e, "activity_type", None)
        act = str(act()) if act is not None else ""
        note = getattr(e, "is_user_annotation", None)
        note = bool(note()) if note is not None else False
        if "cuda" in dev.lower():
            if not note and is_device_op(act, name):
                ops.append((name, start, end))
        elif name in span_names:
            spans.append((name, start, end))
    return ops, spans


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: int, hi: int) -> list:
    """(start, end) of the stretches of [lo, hi] no interval covers."""
    out, t = [], lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def device_ns(trace: Trace, match, within: str | None = None) -> int:
    """Summed duration of the device ops whose name ``match`` accepts,
    those that started inside a ``within`` span when it is given (the
    program syncs at its phase edges, so a phase's ops run inside it)."""
    ops = [(s, e) for n, s, e in trace.ops if match(n)]
    if within is not None:
        spans = sorted((s, e) for n, s, e in trace.spans if n == within)
        starts = [s for s, _ in spans]
        ops = [(s, e) for s, e in ops
               if (i := bisect.bisect_right(starts, s) - 1) >= 0
               and s <= spans[i][1]]
    return sum(e - s for s, e in ops)


def labelled(trace: Trace) -> list:
    """The window cut into (start, end, name of the innermost open span);
    spans of one thread nest, so a stack follows them."""
    pts = []
    for n, s, e in trace.spans:
        pts.append((s, 1, s - e, n))
        pts.append((e, 0, 0, n))
    pts.sort()
    stack, segs, prev = [], [], None
    for t, opening, _, n in pts:
        if prev is not None and t > prev:
            segs.append((prev, t, stack[-1] if stack else "between jobs"))
        if opening:
            stack.append(n)
        elif n in stack:
            del stack[len(stack) - 1 - stack[::-1].index(n)]
        prev = t
    return segs


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device ops that took most time, by name, and the device's idle
    time within the window, by the innermost span open on the host."""
    by_op: dict = {}
    for n, s, e in trace.ops:
        by_op[n] = by_op.get(n, 0) + (e - s)
    win = trace.window()
    idle: dict = {}
    if win is not None:
        segs = labelled(trace)
        k = 0
        for s, e in gaps([(s, e) for _, s, e in trace.ops], *win):
            while k < len(segs) and segs[k][1] <= s:
                k += 1
            i = k
            while i < len(segs) and segs[i][0] < e:
                a, b, name = segs[i]
                idle[name] = idle.get(name, 0) + min(b, e) - max(a, s)
                i += 1

    def top_of(d):
        return [[k[:200], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": top_of(by_op), "idle_gaps": top_of(idle)}
