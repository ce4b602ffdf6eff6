"""A whole run through the harness on the CPU (run_cell skips the look
for a card), once as the program is and once with the timed path broken
underneath in each way a cell of this benchmark can be: ``correct`` has
to come out true, then false."""

import json

import numpy as np
import pytest

from conftest import TINY_MIX, add_cell, quiet

from so_tpu_torch.engine import pipeline
from sobench import harness


def _run(root, name, seconds=4.0):
    cell = harness.load_cell(name, root)
    return harness.run_cell(cell, 2 ** 31 + 11, seconds, False,
                            device="cpu", log=quiet)


def _largest(catalog):
    return int(np.argmax(catalog.rgtp))


def altered_j(monkeypatch):
    """An answer altered where it is produced: one j off by one."""
    real = pipeline.solve_rvir

    def solve(grid, centers, rgtp, *a, **kw):
        out = real(grid, centers, rgtp, *a, **kw)
        h = int(np.argmax(rgtp))
        out.j[h] += 1
        return out
    monkeypatch.setattr(pipeline, "solve_rvir", solve)


def altered_igrp(monkeypatch):
    """An answer altered where it is produced: one particle's group."""
    real = pipeline.resolve_conflicts

    def conflicts(*a, **kw):
        out = real(*a, **kw)
        p = int(np.nonzero(out.igrp)[0][-1])
        out.igrp[p] = 0
        return out
    monkeypatch.setattr(pipeline, "resolve_conflicts", conflicts)


def vcm_in_float32(monkeypatch):
    """An answer altered where it is produced: the group mean velocity
    summed in float32 instead of float64."""
    real = pipeline.members_and_derived

    def fused(*a, host_mv=None, **kw):
        members, vcm, derived = real(*a, host_mv=host_mv, **kw)
        vel, mass = host_mv
        mvir = a[5]
        for i, m in enumerate(members):
            mv = vel[m] * mass[m, None]
            vcm[i] = np.cumsum(mv, axis=0, dtype=np.float32)[-1] / mvir[i]
        return members, vcm, derived
    monkeypatch.setattr(pipeline, "members_and_derived", fused)


def half_left_out(monkeypatch):
    """Half of the batch left out: the second half of the halos is never
    solved and comes back as failed."""
    real = pipeline.solve_rvir

    def solve(grid, centers, rgtp, *a, **kw):
        out = real(grid, centers, rgtp, *a, **kw)
        half = centers.shape[0] // 2
        out.code[half:] = -1
        out.mvir[half:] = -1.0
        out.rvir[half:] = -1.0
        out.j[half:] = 0
        return out
    monkeypatch.setattr(pipeline, "solve_rvir", solve)


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: each call hands back the
    result of the call before it."""
    real = pipeline.run_so
    last = []

    def run_so(*a, **kw):
        last.append(real(*a, **kw))
        return last[-2] if len(last) > 1 else last[-1]
    monkeypatch.setattr(pipeline, "run_so", run_so)


def test_sound_run_is_correct(bench_root):
    name = add_cell(bench_root, "tiny", "tiny", 1 << 13, 64, TINY_MIX)
    out = _run(bench_root, name, seconds=20.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2
    assert list(out)[-1] == "checks"
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    unlisted = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m}     # what a cell added as files gets
    assert set(out["metrics"]) == unlisted - {"peak_device_gib"}   # no card


@pytest.mark.parametrize("fault", [altered_j, altered_igrp, vcm_in_float32,
                                   half_left_out, state_unchanged])
def test_broken_path_is_not_correct(bench_root, monkeypatch, fault):
    name = add_cell(bench_root, "tiny", "tiny", 1 << 13, 64, TINY_MIX)
    fault(monkeypatch)
    out = _run(bench_root, name)
    assert not out["correct"], out["checks"]
