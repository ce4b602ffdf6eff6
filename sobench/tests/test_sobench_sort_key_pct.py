"""sort_key_pct, the share of the row sort's slots it keys and sorts, on
hand-built records: the program's counts give the share, and a record
without them (a program that sorts whole rows, no reruns, no trace) gives
None."""

import pytest

from conftest import REPO

from sobench import harness
from sobench import trace as tr


def read(record):
    return harness.load_module(
        REPO / "sobench" / "metrics" / "sort_key_pct.py").read(record)


def record(counts):
    rerun = dict(jobs=2, halos=200, totals={}, counts=counts)
    trace = tr.Trace(ops=[], spans=[(tr.JOB_SPAN, 0, 1)],
                     notes=dict(program_spans=[], program_rerun=rerun))
    return dict(jobs=[], trace=trace, setup_s=1.0)


def test_counts_give_the_share():
    assert read(record({("sort.slots",): 4000, ("sort.keys",): 150,
                        ("solve.halo_gathers",): 300})) == pytest.approx(3.75)
    # no key sorted: the counter never moved, so the reruns lack it
    assert read(record({("sort.slots",): 4000})) == 0.0


def test_without_the_counts_is_none():
    assert read(record({("solve.halo_gathers",): 300})) is None
    assert read(record({})) is None
    rec = record({("sort.slots",): 4000, ("sort.keys",): 150})
    assert read(dict(rec, trace=None)) is None
    rec["trace"].notes.clear()
    assert read(rec) is None
