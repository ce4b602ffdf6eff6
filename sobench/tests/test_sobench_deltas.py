"""The cells box512.deltas and standard.uniform, added as files and
entries (box512.deltas under a configuration of its own, box512_deltas):
both load through the harness, no file of the benchmark that was there
before them changed, and their new readers (multi_settled_pct,
multi_post_s, sort_device_ms.deltas) on hand-built records and in a traced
CPU run of a small multi-threshold cell."""

import hashlib
import json

import pytest

from conftest import REPO, TINY_MIX, add_cell, quiet

from sobench import harness
from sobench import trace as tr

MS = 1_000_000
NEW = ("box512.deltas", "standard.uniform")
NEW_METRICS = ("multi_settled_pct", "multi_post_s", "sort_device_ms.deltas")

# git's blob ids of the benchmark's files before the two cells were added
BEFORE = {
    "sobench/README.md": "fcbe7abbf5376114aa562b538642afe9790aaab7",
    "sobench/__init__.py": "fedea3c17d003faced5cd8635530f1e2734362ba",
    "sobench/check.py": "ad279fa4847150eb25df6281f475925593777e62",
    "sobench/configs/box512.json": "585fa8dea8d9ab6938c10d6a28cf9f85f0f07139",
    "sobench/configs/standard.json": "fbc820400ef23c95419f7bd4e1b73cf32d658ddb",
    "sobench/control.py": "71a9db76e98472462158651aa57f5a9bd1fa435c",
    "sobench/counters.json": "2c382aed76a5cd9276cbd5e435c3bff531850b6a",
    "sobench/gen/make_box.py": "6d642b817814f6ca6e501bc0cc27cc743e98a5f3",
    "sobench/harness.py": "934ccafbc76d8b95bc4c841a712b0ff75edae99a",
    "sobench/limits/box512.uniform.json": "14bf1947c071f69e53c4bc29a8070c035f35f23f",
    "sobench/limits/standard.species.json": "ab1088906c6e641c5d42c244e1f7d4b7600800c9",
    "sobench/metrics/conflicts_prep_s.py": "a0edf44221093579d1a69a25a2d7e3b3e5c704a0",
    "sobench/metrics/conflicts_s.py": "a0b5c30a63796679d0bb696d66a95f491f89e010",
    "sobench/metrics/derived_s.py": "a61055ad60bd17abf05b71e1d0f5c1935381007a",
    "sobench/metrics/device_idle_pct.py": "31e964acf8a80f9be9a44e3335a27f1c64133c5a",
    "sobench/metrics/fused_host_s.py": "dd656f470d12aa57f93aea9fa901dfa029cc740e",
    "sobench/metrics/fused_s.py": "913bb9657230d227c85f9032b668b396c2f10064",
    "sobench/metrics/gather_device_ms.py": "ff3fff638bf286d31a75b09bd1bf44711e9a4302",
    "sobench/metrics/gather_launches.py": "fcd95e4a646226e469f574fe2ebe76933797cae9",
    "sobench/metrics/grid_s.py": "266f7afb5576644fb3476cb039e9b2d796cc5b95",
    "sobench/metrics/halos_per_s.py": "5d86ac02424914ab9d6e16cdf2fd200fc3f21971",
    "sobench/metrics/job_s_p90.py": "8fcb580d4f90c1d34837a80fe4a23cea29aada46",
    "sobench/metrics/k1_roofline.py": "d72bce0d5e0d212efdabf6b1e240b7781a0f0fd6",
    "sobench/metrics/k2_roofline.py": "aa64878d4a5a13c3619cca4fd9b9e64b42cdc077",
    "sobench/metrics/k3_roofline.py": "fe194b3aae31cf4decea52f3f8f7f02ca7e1f961",
    "sobench/metrics/peak_device_gib.py": "cbca248afd8306c05314005ff34ed21e9c3f7052",
    "sobench/metrics/setup_s.py": "3e1378b29c793adcc4ea4f66aa4d9bb3cb5c0736",
    "sobench/metrics/solve_fetch_s.py": "3602f640b1d6e3595ac5d5cca5f436745876cc12",
    "sobench/metrics/solve_host_s.py": "8e2fce7f7a8062251717d947060c217163484ba2",
    "sobench/metrics/solve_idle_enqueue_ms.py": "472c1a69de3da594ed2a1920e290a057676c33a8",
    "sobench/metrics/solve_idle_host_ms.py": "0ee753546005b2946e1d83da0b5fc2f5a4f81cfb",
    "sobench/metrics/solve_regathers.py": "0d6ab1cb462f775a2feea06bbf3589e0791d0e8b",
    "sobench/metrics/solve_s.py": "f4f11e06095909eecc354796896c55bcb00b83fe",
    "sobench/metrics/sort_device_ms.py": "629bd586130e60658a55936595fe17e1d643083d",
    "sobench/metrics/sort_key_pct.py": "e36d4152f7aa1865c0270d3862e7138989774739",
    "sobench/metrics/stats_s.py": "648aba2051f9da4f1de90a12d76e0b37309bbda1",
    "sobench/program_spans.py": "6e75afe061819b4cfcf15b36c95e320a37e7c446",
    "sobench/readers.py": "3ad7276d74c8235e2e56fa89da74b51db54e54eb",
    "sobench/reference/__init__.py": "815c4a10e19bd0ae0bf2fd846d1b094ac485c53a",
    "sobench/reference/so_reference.py": "d06164e7534fd97c8da393e515cc4679595078ec",
    "sobench/run.py": "43aeab41952a0f27ff7b4e257dae6d6bddd4a692",
    "sobench/spans.json": "98853b12382fd8f733a47e36a569f286fb65b9b7",
    "sobench/tests/conftest.py": "d295658d007c7d6f97f2eae630c12b656e8ff94b",
    "sobench/tests/test_sobench_control.py": "de432742ff97d5230ce37dea423f0dac9909ab62",
    "sobench/tests/test_sobench_faults.py": "aed5548fe435355c241a41cb9286dd0000532356",
    "sobench/tests/test_sobench_gen.py": "687d62a74856fdd322e0a24a109ea79270d6f820",
    "sobench/tests/test_sobench_layout.py": "2ef4b8fd21defbd6e03892eaf3a2a19004c47c86",
    "sobench/tests/test_sobench_metrics.py": "f1c978db299a5aa63fae40879fca96a77e3fd7ce",
    "sobench/tests/test_sobench_program_spans.py": "688d7797b51230e32fcf8f6acae1a5e2308dbc59",
    "sobench/tests/test_sobench_reference.py": "02733f9dfe647cec8f9603ebb61187115676c90b",
    "sobench/tests/test_sobench_sort_key_pct.py": "09e2bea4a584b4462964f0f6fcfe1dc44f3c410f",
    "sobench/trace.py": "1cb82c93d263e47f70bf15b4a0d3d49e66b23073",
    "sobench/traffic/species.json": "edb3cb715145b36988f9041076490b6b255da30c",
    "sobench/traffic/uniform.json": "869a726baee1b8b093772d1eeaf5f0f49cbfc437"
}


def blob_id(data: bytes) -> str:
    return hashlib.sha1(b"blob %d\0" % len(data) + data).hexdigest()


def metric(name):
    return harness.load_module(REPO / "sobench" / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", NEW)
def test_new_cells_load(name):
    cell = harness.load_cell(name)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    w = {w["name"]: w for w in spec["workloads"]}[name]
    assert cell.chips == w["chips"] == 1
    assert cell.config["name"] == w["config"]
    assert {m["name"] for m in cell.end_to_end} == {"peak_device_gib",
                                                    "setup_s"}
    assert cell.per_layer and all(m["workloads"] == [name]
                                  for m in cell.per_layer)
    assert cell.limits == json.loads((REPO / "sobench/limits/box512.uniform"
                                      ".json").read_text())["limits"]
    for m in cell.per_layer:       # each reads through a file that is there
        assert harness.metric_module(cell, m["name"]).read


def test_deltas_mix_is_uniform_at_three_thresholds():
    deltas = json.loads((REPO / "sobench/traffic/deltas.json").read_text())
    uniform = json.loads((REPO / "sobench/traffic/uniform.json").read_text())
    assert deltas.pop("entry") == "run_so_multi"
    assert deltas.pop("thresholds") == [200.0, 334.22216796875,
                                        666.6666870117188]
    assert "so.c:68-86" in deltas.pop("source")
    for k in ("entry", "thresholds"):
        uniform.pop(k)
    assert deltas == uniform


def test_files_that_were_there_keep_their_digest():
    for path, blob in BEFORE.items():
        assert blob_id((REPO / path).read_bytes()) == blob, path


def test_benchmark_entries_only_added():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [w["name"] for w in spec["workloads"]]
    assert names[-2:] == list(NEW)
    assert [c["name"] for c in spec["configs"]] == ["box512", "standard",
                                                    "box512_deltas"]


def test_deltas_config_is_box512s_box_at_the_catalog_deltas():
    """box512_deltas is the deployment box512.deltas runs: box512's box,
    every number of it unchanged and nothing cut, catalogued at the three
    thresholds its traffic runs."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cfgs = {c["name"]: c for c in spec["configs"]}
    new, box = cfgs["box512_deltas"], cfgs["box512"]
    assert {w["name"]: w["config"] for w in spec["workloads"]}[
        "box512.deltas"] == "box512_deltas"
    assert new["reduced"] == [] and new["source"] != box["source"]
    got = json.loads((REPO / new["file"]).read_text())
    base = json.loads((REPO / box["file"]).read_text())
    assert got.pop("name") == "box512_deltas" and base.pop("name")
    assert got.pop("source") != base.pop("source")
    deltas = got.pop("deltas")
    assert got.pop("assumed").items() >= base.pop("assumed").items()
    assert got == base
    mix = json.loads((REPO / "sobench/traffic/deltas.json").read_text())
    assert list(deltas.values()) == mix["thresholds"]
    assert list(deltas) == ["M200m", "Mvir", "M200c"]


def record(counts=None, totals=None, ops=(), spans=()):
    """One rerun of two traced jobs (what they added to the program's
    counts and totals) and a traced window with device ops and harness
    spans."""
    rerun = dict(jobs=2, halos=600, totals=totals or {},
                 counts=counts or {})
    trace = tr.Trace(ops=list(ops), spans=[(tr.JOB_SPAN, 0, 100 * MS),
                                           *spans],
                     notes=dict(program_spans=[], program_rerun=rerun))
    return dict(jobs=[], trace=trace, setup_s=1.0)


def test_multi_settled_pct():
    m = metric("multi_settled_pct")
    rec = record({("multi.verdicts",): 3000,
                  ("multi.verdicts_settled",): 150})
    assert m.read(rec) == pytest.approx(5.0)
    # nothing rescanned: the counter never moved, so the reruns lack it
    assert m.read(record({("multi.verdicts",): 3000})) == 0.0


def test_multi_post_s():
    rec = record(totals={("multi.post", "n"): 6,
                         ("multi.post", "ns"): 3000 * MS,
                         ("stats", "n"): 6, ("stats", "ns"): 900 * MS})
    assert metric("multi_post_s").read(rec) == pytest.approx(1.5)


def test_sort_device_ms_deltas_reads_the_multi_solve():
    ops = [("DeviceRadixSortOnesweepKernel", 10 * MS, 13 * MS),
           ("DeviceSegmentedSortKernel", 20 * MS, 21 * MS),
           ("slab_gather_sorted_kernel", 22 * MS, 30 * MS),
           ("DeviceRadixSortOnesweepKernel", 70 * MS, 75 * MS)]
    spans = [("solve_rvir_multi", 5 * MS, 40 * MS),
             ("members_and_derived", 60 * MS, 80 * MS)]
    rec = record(ops=ops, spans=spans)
    assert metric("sort_device_ms.deltas").read(rec) == pytest.approx(4.0)
    # the single solve's span is not the multi solve's
    single = record(ops=ops, spans=[("solve_rvir", 5 * MS, 40 * MS)])
    assert metric("sort_device_ms.deltas").read(single) is None
    assert metric("sort_device_ms").read(single) == pytest.approx(4.0)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_nothing_to_read_is_none(name):
    """Without a trace, without the recorder's notes (a program that lacks
    the counts and spans), or without what the metric reads."""
    m = metric(name)
    rec = record({("multi.verdicts",): 3000},
                 {("multi.post", "n"): 3, ("multi.post", "ns"): MS},
                 [("DeviceRadixSortOnesweepKernel", 10 * MS, 13 * MS)],
                 [("solve_rvir_multi", 5 * MS, 40 * MS)])
    assert m.read(rec) is not None
    assert m.read(dict(rec, trace=None)) is None
    bare = record()
    bare["trace"].notes.clear()
    assert m.read(bare) is None
    assert m.read(record()) is None


def test_traced_cpu_run_of_a_multi_cell(bench_root):
    """A small cell on the deltas mix with the new metrics listed for it:
    correct at every threshold; the traced CPU run reports the host ones,
    and sort_device_ms.deltas reads no device op on the CPU."""
    name = add_cell(bench_root, "tinyd", "deltas", 1 << 13, 64, TINY_MIX,
                    base_mix="deltas")
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS + ("halos_per_s.deltas",
                                       "fused_s.deltas"):
            m["workloads"].append(name)
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(name, bench_root)
    out = harness.run_cell(cell, 2 ** 31 + 18, 0.0, True, device="cpu",
                           log=quiet)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert set(got) == {"multi_settled_pct", "multi_post_s",
                        "halos_per_s.deltas", "fused_s.deltas"}
    assert 0.0 <= got["multi_settled_pct"]["value"] < 100.0
    assert got["multi_post_s"]["value"] > 0
