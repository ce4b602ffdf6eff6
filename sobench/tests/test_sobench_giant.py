"""The giant.general cell's pieces: the configuration's sizes are what the
generator makes at its size_seed, a host center has the catalog's
largest Rgtp, and the cell's three new readers (k2_chain_pct,
member_host_ns, giant_slots_per_halo) on hand-built records, None where a
count is missing."""

import json

import numpy as np
import pytest

from conftest import REPO

from sobench import harness
from sobench import trace as tr
from sobench.gen import make_box

MS = 1_000_000


def config():
    return json.loads((REPO / "sobench/configs/giant.json").read_text())


def metric(name):
    return harness.load_module(REPO / "sobench" / "metrics" / f"{name}.py")


def test_the_configuration_counts_match_the_generator():
    cfg = config()
    gen = harness.load_module(REPO / "sobench/gen/giant.py")
    sizes = gen.field_sizes(cfg)
    field = make_box.clump_sizes(2 * cfg["n_field"], cfg["n_field_halos"],
                                 cfg["size_seed"])
    assert np.array_equal(sizes, field) and sizes.size == 4092
    # the field snapshot holds n_field background particles besides
    n_bg = cfg["n_particles"] - cfg["n_field"] - int(sizes.sum()) \
        - cfg["n_host"]
    assert n_bg == 51_002_029
    assert cfg["n_particles"] == 150_000_000 and cfg["n_host"] == 51_000_000
    assert len(cfg["host_offsets"]) + sizes.size == 4096
    assert cfg["reduced"] == []
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["giant"]
    assert entry["source"] == cfg["source"] and entry["reduced"] == []
    assert "Aq-A-3" in cfg["source"] and "giant_config" in cfg["source"]


def test_a_host_center_has_the_largest_rgtp():
    cfg = config()
    rmax = (0.0012 * make_box.clump_sizes(
        2 * cfg["n_field"], cfg["n_field_halos"],
        cfg["size_seed"]).astype(np.float64) ** (1 / 3)).astype(np.float32)
    field = np.minimum(np.maximum(rmax, np.float32(0.001)),
                       np.float32(cfg["field_rgtp_max"]))
    assert field.max() < np.float32(cfg["host_rgtp"])
    # the cap is what keeps it so: make_box's own radii reach past it
    assert rmax.max() > cfg["host_rgtp"]


def test_a_small_box_has_the_stated_counts():
    cfg = dict(config(), n_particles=60_000, n_host=20_000, n_field=9_000,
               n_field_halos=30)
    mix = json.loads((REPO / "sobench/traffic/general.json").read_text())
    gen = harness.load_module(REPO / "sobench/gen/giant.py")
    s = gen.snapshot(cfg, mix, 2 ** 31 + 5, "cpu")
    assert s.n == 60_000 and s.n_halos == 34
    assert int(np.argmax(s.rgtp)) == 0
    assert s.mass.min() >= 0.5 / s.n * (1 - 1e-6)
    assert s.mass.max() <= 1.5 / s.n * (1 + 1e-6)


def record(counted=None, rerun=None, ops=()):
    notes = dict(program_spans=[])
    if counted is not None:
        notes["program_counted"] = dict(jobs=1, halos=100, totals={},
                                        counts=counted)
    if rerun is not None:
        notes["program_rerun"] = rerun
    trace = tr.Trace(ops=list(ops), spans=[(tr.JOB_SPAN, 0, 100 * MS)],
                     notes=notes)
    return dict(jobs=[], trace=trace, setup_s=1.0)


K2_OPS = [("void seqsum_rows_kernel<1>(float const*)", 10 * MS, 30 * MS),
          ("seqsum_short_kernel", 40 * MS, 50 * MS),
          ("void piece_gather_kernel(float const*)", 50 * MS, 90 * MS)]


def test_k2_chain_pct():
    read = metric("k2_chain_pct").read
    # 30 ms of K2; a chain of 2.97e6 adds at 4 cycles, 1,980 MHz: 6 ms
    got = read(record({("K2.bytes",): 3350, ("K2.chain_adds",): 2_970_000},
                      ops=K2_OPS))
    assert got == pytest.approx(20.0)
    # the bytes bound where it is the larger: 33.5e9 B at 3.35 TB/s, 10 ms
    got = read(record({("K2.bytes",): 33_500_000_000,
                       ("K2.chain_adds",): 100}, ops=K2_OPS))
    assert got == pytest.approx(100.0 / 3)
    assert read(record({("K2.bytes",): 3350}, ops=K2_OPS)) is None
    assert read(record({("K2.chain_adds",): 10}, ops=K2_OPS)) is None
    assert read(record({("K2.bytes",): 1, ("K2.chain_adds",): 1},
                       ops=K2_OPS[2:])) is None
    rec = record(None, ops=K2_OPS)
    assert read(rec) is None
    assert read(dict(rec, trace=None)) is None


def test_member_host_ns():
    read = metric("member_host_ns").read
    totals = {("fused.split", "self_ns"): 300, ("fused.vcm", "self_ns"): 500,
              ("fused.fill", "self_ns"): 100,
              ("fused.members_list", "self_ns"): 100,
              ("fused.dispatch", "self_ns"): 10_000}
    rerun = dict(jobs=2, halos=10, totals=totals,
                 counts={("fused.member_rows",): 4})
    assert read(record(rerun=rerun)) == pytest.approx(250.0)
    rerun = dict(rerun, counts={("fused.dispatches",): 3})
    assert read(record(rerun=rerun)) is None
    assert read(record()) is None
    assert read(dict(record(rerun=rerun), trace=None)) is None


def test_giant_slots_per_halo():
    read = metric("giant_slots_per_halo").read
    rerun = dict(jobs=2, halos=8192, totals={},
                 counts={("solve.giant_slots",): 4 << 28,
                         ("solve.giant_dispatches",): 4})
    assert read(record(rerun=rerun)) == pytest.approx((4 << 28) / 8192)
    rerun = dict(rerun, counts={("solve.dispatches",): 40})
    assert read(record(rerun=rerun)) is None
    assert read(record()) is None
