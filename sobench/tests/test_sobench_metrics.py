"""The readers' arithmetic on synthetic records: the device's idle union,
the breakdown's labels, device time by kernel and span, K2's bytes and
least time, and the end-to-end reductions."""

import pytest

from conftest import REPO

from sobench import harness
from sobench import trace as tr

MS = 1_000_000


def metric(name):
    return harness.load_module(REPO / "sobench" / "metrics" / f"{name}.py")


def synthetic():
    """Two jobs of 100 ms; device ops overlap inside the first, leave gaps
    in the solve and the conflict pass."""
    spans = [(tr.JOB_SPAN, 0, 100 * MS), ("solve_rvir", 10 * MS, 60 * MS),
             ("resolve_conflicts", 60 * MS, 90 * MS),
             (tr.JOB_SPAN, 100 * MS, 200 * MS),
             ("solve_rvir", 110 * MS, 160 * MS)]
    ops = [("void slab_gather_kernel<1>(float const*)", 10 * MS, 30 * MS),
           ("void at::native::radixSortKVInPlace<float>()", 20 * MS,
            40 * MS),
           ("seqsum_rows_kernel", 70 * MS, 75 * MS),
           ("void piece_gather_kernel(float const*)", 110 * MS, 150 * MS),
           ("void at::native::radixSortKVInPlace<float>()", 170 * MS,
            180 * MS)]
    return tr.Trace(ops=ops, spans=spans)


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40)]
    assert tr.union_ns(iv, 0, 50) == 30
    assert tr.union_ns(iv, 8, 35) == 17
    assert tr.gaps(iv, 0, 50) == [(20, 30), (40, 50)]


def test_idle_share_and_breakdown():
    t = synthetic()
    rec = dict(trace=t, jobs=[{}, {}])
    # busy 10-40, 70-75, 110-150, 170-180: 85 ms of 200
    assert metric("device_idle_pct").read(rec) == pytest.approx(57.5)
    b = tr.breakdown(t)
    assert b["device_ops"][0] == ["void piece_gather_kernel(float const*)",
                                  0.04]
    idle = dict(b["idle_gaps"])
    assert idle["solve_rvir"] == pytest.approx(0.030)   # 40-60, 150-160
    assert idle["resolve_conflicts"] == pytest.approx(0.025)
    assert idle[tr.JOB_SPAN] == pytest.approx(0.060)


def test_device_ms_by_kernel_and_span():
    rec = dict(trace=synthetic(), jobs=[{}, {}])
    assert metric("gather_device_ms").read(rec) == pytest.approx(30.0)
    # the sort at 170 ms is outside every solve span
    assert metric("sort_device_ms").read(rec) == pytest.approx(10.0)
    assert metric("sort_device_ms").read(dict(trace=None, jobs=[])) is None


def test_k2_bytes_and_least_time():
    m = metric("k2_roofline")
    # (B, K) = (4, 1024) with counts summing to 1000: 4000 B read, 16384
    # written, 32 B of counts
    assert m.least_seconds(4, 1024, 1000, True) == pytest.approx(
        (4000 + 16384 + 32) / 3.35e12)
    assert m.least_seconds(1, 2 ** 30, 2 ** 30, False) == pytest.approx(
        2 ** 33 / 3.35e12)
    t = synthetic()
    t.notes["k2_calls"] = [(4, 1024, 1000), (2, 512, None)]
    least = (m.least_seconds(4, 1024, 1000, True)
             + m.least_seconds(2, 512, 1024, False))
    got = m.read(dict(trace=t, jobs=[{}, {}]))
    assert got == pytest.approx(100 * least / 5e-3)
    t.notes.clear()
    assert m.read(dict(trace=t, jobs=[])) is None


def test_end_to_end_reductions():
    jobs = [dict(start=0.0, end=1.0, wall=1.0, halos=10, peak_bytes=2 ** 30,
                 phases={"R_Delta solve": 0.5}),
            dict(start=1.0, end=3.0, wall=2.0, halos=10, peak_bytes=2 ** 31,
                 phases={})]
    rec = dict(jobs=jobs, setup_s=4.0, trace=None)
    assert metric("halos_per_s").read(rec) == pytest.approx(20 / 3)
    assert metric("peak_device_gib").read(rec) == 2.0
    assert metric("setup_s").read(rec) == 4.0
    assert metric("solve_s").read(rec) == 0.25
    assert metric("grid_s").read(rec) is None
    assert metric("job_s_p90").read(rec) is None        # under ten jobs
    many = [dict(wall=float(w)) for w in range(1, 11)]
    assert metric("job_s_p90").read(dict(jobs=many)) == pytest.approx(9.1)


def test_split_metric_reads_as_its_base(bench_root):
    """``<base>.<part>`` reads with ``metrics/<base>.py`` unless it has a
    file of its own."""
    cell = harness.load_cell("standard.species", bench_root)
    rec = dict(jobs=[dict(start=0.0, end=2.0, halos=8)])
    assert harness.metric_module(cell, "halos_per_s.species").read(rec) == 4.0
    (bench_root / "sobench/metrics/halos_per_s.species.py").write_text(
        "def read(record):\n    return -1.0\n")
    assert harness.metric_module(cell, "halos_per_s.species").read(rec) == -1.0
    assert harness.metric_module(cell, "halos_per_s").read(rec) == 4.0
