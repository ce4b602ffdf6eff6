"""ranges_kernel_pct, the share of the cell enumerations the kernel
served, on hand-built records: the program's counts give the share, and a
record without them (a program that counts no enumeration, no reruns, no
trace) gives None."""

import pytest

from conftest import REPO

from sobench import harness
from sobench import trace as tr


def read(record):
    return harness.load_module(
        REPO / "sobench" / "metrics" / "ranges_kernel_pct.py").read(record)


def record(counts):
    rerun = dict(jobs=2, halos=200, totals={}, counts=counts)
    trace = tr.Trace(ops=[], spans=[(tr.JOB_SPAN, 0, 1)],
                     notes=dict(program_spans=[], program_rerun=rerun))
    return dict(jobs=[], trace=trace, setup_s=1.0)


def test_counts_give_the_share():
    assert read(record({("ranges.calls",): 2536, ("ranges.kernel",): 2536,
                        ("solve.halo_gathers",): 300})) == 100.0
    assert read(record({("ranges.calls",): 400, ("ranges.kernel",): 100})
                ) == pytest.approx(25.0)
    # every enumeration in torch ops: the kernel's count never moved
    assert read(record({("ranges.calls",): 400})) == 0.0


def test_without_the_counts_is_none():
    assert read(record({("solve.halo_gathers",): 300})) is None
    assert read(record({})) is None
    rec = record({("ranges.calls",): 400, ("ranges.kernel",): 400})
    assert read(dict(rec, trace=None)) is None
    rec["trace"].notes.clear()
    assert read(rec) is None
