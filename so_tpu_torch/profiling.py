"""Named wall-clock phases (port of so_tpu/profiling.py PhaseTimer).

PyTorch returns before the card finishes, so on a CUDA device every phase
edge synchronizes: a phase's time then holds the device work it issued,
not only the host's enqueue.
"""

from __future__ import annotations

import contextlib
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

    def report(self, out=sys.stderr, items: dict | None = None) -> None:
        total = sum(self.phases.values())
        out.write("so_tpu_torch phase timings:\n")
        for name in self._order:
            dt = self.phases[name]
            rate = ""
            if items and name in items and dt > 0:
                rate = f"  ({items[name] / dt:,.0f}/s)"
            out.write(f"  {name:<24s} {dt:8.3f}s{rate}\n")
        out.write(f"  {'total':<24s} {total:8.3f}s\n")
