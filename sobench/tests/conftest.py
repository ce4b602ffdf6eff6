"""Helpers of the benchmark's CPU tests: a copy of the benchmark's files
with small cells added as files and entries, run on the CPU through the
harness's own path (run_cell, which skips the look for a card)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def add_cell(root: Path, config: str, traffic: str, n: int, G: int,
             mix_changes=None, base_mix="uniform") -> str:
    """Add configuration ``config`` (the standard box's file at n
    particles and G halos), mix ``traffic`` (``base_mix``'s file with
    ``mix_changes``), their cell and its limits, as new files and
    entries; return the cell's name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "sobench/configs/standard.json").read_text())
    cfg.update(name=config, n_particles=n, n_halos=G)
    cfile = f"sobench/configs/{config}.json"
    if not (root / cfile).exists():
        (root / cfile).write_text(json.dumps(cfg))
        bench["configs"].append(dict(name=config, source="test",
                                     file=cfile, reduced=[], why="test"))
    mfile = root / f"sobench/traffic/{traffic}.json"
    if not mfile.exists():
        mix = json.loads((root / f"sobench/traffic/{base_mix}.json")
                         .read_text())
        mix.update(mix_changes or {})
        mfile.write_text(json.dumps(mix))
    name = f"{config}.{traffic}"
    bench["workloads"].append(dict(name=name, config=config,
                                   traffic=traffic, chips=1, why="test"))
    lim = json.loads((root / "sobench/limits/standard.species.json")
                     .read_text())
    (root / f"sobench/limits/{name}.json").write_text(json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


@pytest.fixture
def bench_root(tmp_path):
    """A checkout of the benchmark (BENCHMARK.json and sobench/) beside the
    program."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "sobench", root / "sobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "so_tpu_torch").symlink_to(REPO / "so_tpu_torch")
    return root


TINY_MIX = {"snapshots": 2, "warmup": {"largest": 4, "random": 4},
            "check": {"halos": 16, "strata": 4, "whole_jobs": 1},
            "trace": {"jobs": 2}}


def quiet(msg):
    pass
