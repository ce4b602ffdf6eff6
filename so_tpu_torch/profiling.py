"""Named wall-clock phases, the program's spans and counters, and the
--profile trace (port of so_tpu/profiling.py, plus the span recorder).

PyTorch returns before the card finishes, so on a CUDA device every phase
edge synchronizes: a phase's time then holds the device work it issued,
not only the host's enqueue. profile_trace takes the place of
jax.profiler.trace.

Spans. ``span(name)`` times a stretch of the host's work, nested in the
spans open around it on the same thread. It never synchronizes the card,
reads a device value or allocates on the device, and the engine opens
spans at dispatch granularity or coarser, never per halo or particle.
Always kept, at module level:

- ``totals``: per span name, ``(name, "n")`` the spans closed,
  ``(name, "ns")`` their summed duration and ``(name, "self_ns")`` the
  same less what their child spans cover (int nanoseconds). A span adds
  to running sums of its name, which fold() moves into ``totals``; it
  runs when a root span (a run_so or run_so_multi call is one) closes
  and at each phase edge, so ``totals`` is whole between jobs;
- ``counts``: the program's counts, keyed ``(name,)`` (ints).

Between start_recording() and stop_recording() every span is also kept
whole, as (name, start_ns, end_ns, span id, parent id, job id): the job
id is its root span's id, so all spans of one run_so share it. The times
are written on the profiler's clock (unix-epoch ns, where kineto puts the
host's and the card's events), by one offset from the monotonic clock
the spans are timed on, taken when recording starts. Device counts
(count_on_device, the K1 and K3 bytes) are kept only inside a
start_recording(device_counts=True): they add work on the device, so a
recording that times the card leaves them off. They are summed on the
device and added to ``counts`` once, when that recording stops. Under
profile_trace every span is also a torch.profiler.record_function, so
the Chrome trace shows the program's own structure.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from time import perf_counter_ns as _clock

import torch

totals: Counter = Counter()     # (name, "n" | "ns" | "self_ns") -> int
counts: Counter = Counter()     # (name,) -> int

_ids = itertools.count(1)
_pending: dict = {}             # name -> [n, ns, self_ns] not yet in totals
_records: list | None = None    # the spans kept while recording
_rec_marks: list = []           # (len(_records), device_counts) a start
_counting = 0                   # open start_recording(device_counts=True)
_offset_ns = 0                  # profiler clock - perf_counter_ns
_device_counts: dict = {}       # name -> device scalar, while counting
_traced = 0                     # open profile_trace contexts


class _Stack(threading.local):
    def __init__(self):
        self.open: list = []


_stack = _Stack()


class Span:
    """One open or closed span; ``t0``/``t1`` are perf_counter_ns reads.
    Ids are drawn only for spans kept while recording."""

    __slots__ = ("name", "acc", "parent", "root", "child_ns", "t0", "t1",
                 "sid", "_open", "_rf")

    def __init__(self, name: str):
        self.name = name
        acc = _pending.get(name)
        if acc is None:
            acc = _pending[name] = [0, 0, 0]
        self.acc = acc
        self.sid = None
        self._rf = None

    def __enter__(self):
        opened = self._open = _stack.open
        if opened:
            parent = self.parent = opened[-1]
            self.root = parent.root
        else:
            self.parent = None
            self.root = self
        self.child_ns = 0
        if _traced:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        opened.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = self.t1 = _clock()
        dt = t1 - self.t0
        self._open.pop()
        acc = self.acc
        acc[0] += 1
        acc[1] += dt
        acc[2] += dt - self.child_ns
        parent = self.parent
        if parent is not None:
            parent.child_ns += dt
        if _records is not None:
            _records.append((self.name, self.t0 + _offset_ns, t1 + _offset_ns,
                             _sid(self), None if parent is None
                             else _sid(parent), _sid(self.root)))
        if parent is None:
            fold()
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
        return False


def fold() -> None:
    """Bring ``totals`` up to date: a span adds to its name's running sums,
    which move into ``totals`` here, when a root span closes and at each
    phase edge."""
    for name, acc in list(_pending.items()):
        if acc[0]:
            n, ns, self_ns = acc
            acc[0] = acc[1] = acc[2] = 0
            totals[(name, "n")] += n
            totals[(name, "ns")] += ns
            totals[(name, "self_ns")] += self_ns


def _sid(s: Span) -> int:
    if s.sid is None:
        s.sid = next(_ids)
    return s.sid


# ``with span("solve.plan"): ...`` opens a span over the enclosed block
span = Span


def recording() -> bool:
    return _records is not None


def counting() -> bool:
    """Whether device counts are kept: inside a
    start_recording(device_counts=True)."""
    return _counting > 0


def start_recording(device_counts: bool = False) -> None:
    """Keep every span whole until the matching stop_recording; nests.
    With ``device_counts`` the program's device counts are kept too."""
    global _records, _offset_ns, _counting
    if _records is None:
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        _offset_ns = wall - (a + b) // 2
        _records = []
    _rec_marks.append((len(_records), device_counts))
    _counting += bool(device_counts)


def stop_recording() -> list:
    """The spans kept since the matching start_recording, as (name,
    start_ns, end_ns, span id, parent id, job id) on the profiler's clock.
    The last stop of a recording with device counts reads them once and
    adds them to ``counts``."""
    global _records, _counting
    if not _rec_marks:
        raise RuntimeError("stop_recording without start_recording")
    mark, device_counts = _rec_marks.pop()
    out = _records[mark:]
    if not _rec_marks:
        _records = None
    if device_counts:
        _counting -= 1
        if not _counting:
            for name, v in _device_counts.items():
                counts[(name,)] += int(v)
            _device_counts.clear()
    return out


def count_on_device(name: str, value) -> None:
    """Add the device scalar ``value`` to the count ``name`` with no sync;
    the sum reaches ``counts`` when the counting recording stops. Call it
    only while counting()."""
    prev = _device_counts.get(name)
    _device_counts[name] = value if prev is None else prev + value


def _diff(now: Counter, base: dict) -> dict:
    """What ``now`` added since ``base`` (a dict copy of it); ``now`` is
    copied first, in one step, so spans of other threads cannot change it
    under the loop."""
    return {k: v - base.get(k, 0) for k, v in dict(now).items()
            if v != base.get(k, 0)}


@dataclass
class PhaseTimer:
    device: torch.device | None = None
    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)
    _inside: dict = field(default_factory=dict)   # phase -> its spans' totals

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            with span("phase.sync"):
                torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        """A span of the phase's name from after the leading sync to after
        the closing one; its seconds add to ``phases[name]``."""
        self._sync()
        fold()
        base = dict(totals)
        sp = span(name)
        try:
            with sp:
                try:
                    yield
                finally:
                    self._sync()
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + (sp.t1 - sp.t0) / 1e9)
            if name not in self._order:
                self._order.append(name)
            fold()
            inside = self._inside.setdefault(name, Counter())
            inside.update(_diff(totals, base))

    def report(self, out=None, items: dict | None = None) -> None:
        """The phases, each with the spans opened inside it (count, total
        and self seconds), to ``out`` (default stderr)."""
        out = sys.stderr if out is None else out   # the stderr of the call
        total = sum(self.phases.values())
        out.write("so_tpu_torch phase timings:\n")
        for name in self._order:
            dt = self.phases[name]
            rate = ""
            if items and name in items and dt > 0:
                rate = f"  ({items[name] / dt:,.0f}/s)"
            out.write(f"  {name:<24s} {dt:8.3f}s{rate}\n")
            inside = self._inside.get(name, {})
            kids = sorted({k[0] for k in inside} - {name},
                          key=lambda n: -inside.get((n, "ns"), 0))
            for kid in kids:
                ns, self_ns, n = (inside.get((kid, f), 0)
                                  for f in ("ns", "self_ns", "n"))
                out.write(f"    {kid:<22s} {ns / 1e9:8.3f}s self "
                          f"{self_ns / 1e9:8.3f}s  n {n}\n")
        out.write(f"  {'total':<24s} {total:8.3f}s\n")


TRACE_FILE = "so_tpu_torch_trace.json"


def trace_file(rank: int, nproc: int) -> str:
    """The trace file of one rank of a --distributed run."""
    return f"so_tpu_torch_trace.rank{rank}-of-{nproc}.json"


@contextlib.contextmanager
def profile_trace(logdir: str | None, device: torch.device | None = None,
                  name: str = TRACE_FILE):
    """A torch.profiler trace of the enclosed run (host ops, the program's
    spans, plus the card's kernels on a CUDA device), written to
    ``logdir``/``name`` as a Chrome trace (chrome://tracing, Perfetto).
    No-op when logdir is None."""
    global _traced
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        _traced += 1
        try:
            yield
        finally:
            _traced -= 1
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, name))
