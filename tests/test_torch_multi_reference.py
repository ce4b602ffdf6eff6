"""run_so_multi at box512.deltas' three thresholds (M200m, Mvir, M200c)
held to the benchmark's plain reference (sobench/reference/so_reference.py)
on the CPU: a small box from the benchmark's own generator
(sobench/gen/make_box.py), one job through the harness's entry, and every
threshold's run held whole by the benchmark's own comparisons
(sobench/check.check_whole_job) at the cell's limits. Nothing of so_tpu
is imported: the reference works everything out again from the inputs."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from sobench import check as ck  # noqa: E402
from sobench import harness  # noqa: E402

N_PARTICLES, N_HALOS = 1 << 14, 64
SEED = 180018


@pytest.fixture(scope="module")
def job():
    """The deltas mix on the standard box's file cut to 2^14 particles and
    64 centers: (snapshot, runs, mix, config)."""
    config = json.loads((REPO / "sobench/configs/standard.json").read_text())
    config.update(n_particles=N_PARTICLES, n_halos=N_HALOS)
    mix = json.loads((REPO / "sobench/traffic/deltas.json").read_text())
    gen = harness.load_module(REPO / "sobench/gen/make_box.py")
    snap = gen.snapshot(config, mix, SEED, "cpu")
    cell = harness.Cell("tiny.deltas", 1, config, mix, {}, [], [], REPO)
    runs = harness.run_job(harness.Inputs(snap), cell, "cpu")
    return snap, runs, mix, config


def test_thresholds_are_the_catalog_definitions(job):
    from so_tpu_torch.cosmology import rhovir_over_rhobar

    _, runs, mix, _ = job
    thr = mix["thresholds"]
    assert mix["entry"] == "run_so_multi" and len(runs) == len(thr) == 3
    assert thr[0] == 200.0
    assert thr[1] == float(np.float32(rhovir_over_rhobar(0.3, True, 0.0)))
    assert thr[2] == float(np.float32(200.0 / 0.3))


def test_every_threshold_equals_the_reference(job):
    snap, runs, mix, config = job
    limits = json.loads((REPO / "sobench/limits/box512.deltas.json")
                        .read_text())["limits"]
    ps = ck.reference_particles(snap, config["period"], "cpu")
    for run, thr in zip(runs, mix["thresholds"]):
        got = ck.check_whole_job([run], snap, [float(thr)], ps, (),
                                 int(mix["n_members"]))
        assert got["solve_diff"] == got["member_diff"] == 0, (thr, got)
        assert got["vcm_diff"] == got["conflict_diff"] == 0, (thr, got)
        assert got["derived_err"] <= 1e-3, (thr, got)
        assert got["stats_err"] <= 1e-10, (thr, got)
        ok, table = ck.verdict(got, limits)
        assert ok, (thr, table)


def test_the_box_is_not_trivial(job):
    """The thresholds part: some halo ends otherwise at 200 and at 666.67,
    and some halo is solved at all three."""
    _, runs, _, _ = job
    lo, hi = runs[0].solve, runs[-1].solve
    assert (np.any(lo.code != hi.code)
            or np.any(lo.mvir.view(np.int32) != hi.mvir.view(np.int32)))
    solved = np.all([r.solve.code == 0 for r in runs], axis=0)
    assert solved.any()
