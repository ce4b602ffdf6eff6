"""Named wall-clock phases and the --profile trace (port of
so_tpu/profiling.py).

PyTorch returns before the card finishes, so on a CUDA device every phase
edge synchronizes: a phase's time then holds the device work it issued,
not only the host's enqueue. profile_trace takes the place of
jax.profiler.trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimer:
    device: torch.device | None = None
    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if name not in self._order:
                self._order.append(name)

    def report(self, out=None, items: dict | None = None) -> None:
        out = sys.stderr if out is None else out   # the stderr of the call
        total = sum(self.phases.values())
        out.write("so_tpu_torch phase timings:\n")
        for name in self._order:
            dt = self.phases[name]
            rate = ""
            if items and name in items and dt > 0:
                rate = f"  ({items[name] / dt:,.0f}/s)"
            out.write(f"  {name:<24s} {dt:8.3f}s{rate}\n")
        out.write(f"  {'total':<24s} {total:8.3f}s\n")


TRACE_FILE = "so_tpu_torch_trace.json"


def trace_file(rank: int, nproc: int) -> str:
    """The trace file of one rank of a --distributed run."""
    return f"so_tpu_torch_trace.rank{rank}-of-{nproc}.json"


@contextlib.contextmanager
def profile_trace(logdir: str | None, device: torch.device | None = None,
                  name: str = TRACE_FILE):
    """A torch.profiler trace of the enclosed run (host ops, plus the
    card's kernels on a CUDA device), written to ``logdir``/``name`` as a
    Chrome trace (chrome://tracing, Perfetto). No-op when logdir is
    None."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, name))
