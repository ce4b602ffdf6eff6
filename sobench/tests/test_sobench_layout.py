"""The harness finds a cell's pieces by name: a configuration, a traffic
mix, a per-layer metric and a cell added as new files and entries, with no
file that was there edited. Also the guard against JAX and the JAX
package, and the command's refusal without a card."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import REPO, TINY_MIX, add_cell, quiet

from sobench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "sobench").rglob("*") if p.is_file()}


def test_cell_added_as_files(bench_root):
    before = _digests(bench_root)
    name = add_cell(bench_root, "tiny2", "multi", 1 << 13, 64,
                    dict(TINY_MIX, entry="run_so_multi",
                         thresholds=[178.0, 340.0]))
    (bench_root / "sobench/metrics/jobs_run.py").write_text(
        "def read(record):\n    return float(len(record['jobs']))\n")
    (bench_root / "sobench/metrics/traced_jobs.py").write_text(
        "def read(record):\n"
        "    return float(len(record['trace'].jobs()))\n")
    bench = json.loads((bench_root / "BENCHMARK.json").read_text())
    for m in ("jobs_run", "traced_jobs"):
        bench["per_layer"].append(dict(name=m, unit="jobs",
                                       better="higher", source="host_clock",
                                       layer="harness", moves="halos_per_s",
                                       workloads=[name]))
    (bench_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(bench_root)
    assert all(after[p] == d for p, d in before.items())   # nothing edited

    cell = harness.load_cell(name, bench_root)
    assert cell.config["n_halos"] == 64
    assert [m["name"] for m in cell.per_layer][-2:] == ["jobs_run",
                                                       "traced_jobs"]
    out = harness.run_cell(cell, 77, 0.0, True, device="cpu", log=quiet)
    assert out["correct"], out["checks"]
    # host metrics read the untraced window; the trace has its own jobs
    assert out["metrics"]["jobs_run"]["value"] == 1.0
    assert out["metrics"]["traced_jobs"]["value"] == 2.0
    # every metric of BENCHMARK.json names its cells, so none reaches this one
    assert set(out["metrics"]) == {"jobs_run", "traced_jobs"}
    assert out["attempted"] == 1


@pytest.mark.parametrize("names, bad", [
    (["so_tpu_torch", "so_tpu_torch.engine", "numpy", "torch"], []),
    (["so_tpu", "numpy"], ["so_tpu"]),
    (["so_tpu.engine.solver"], ["so_tpu"]),
    (["jax"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["so_tpux", "jaxtyping"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert harness.forbidden_modules(names) == bad


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "sobench/run.py", "--workload", "standard.species",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_command_without_a_card_prints_no_result():
    r = _command(REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_command_without_the_program_prints_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_bytes(
        (REPO / "BENCHMARK.json").read_bytes())
    import shutil
    shutil.copytree(REPO / "sobench", tmp_path / "sobench")
    r = _command(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.mark.cuda
def test_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run(
        [sys.executable, "sobench/run.py", "--workload", "standard.species",
         "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {"setup_s", "peak_device_gib"}
