"""The plain reference against the port's CPU run_so, and ``correct``
turning false when one output of the job changes."""

import copy
import shutil

import numpy as np
import pytest

from conftest import REPO, add_cell

from sobench import check as ck
from sobench import harness


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One species-mix job on a 2^15-particle, 256-halo box on the CPU."""
    root = tmp_path_factory.mktemp("ref") / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "sobench", root / "sobench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    name = add_cell(root, "b15", "species1", 1 << 15, 256,
                    {"snapshots": 1}, base_mix="species")
    cell = harness.load_cell(name, root)
    gen = harness.load_module(root / "sobench/gen/make_box.py")
    snap = gen.snapshot(cell.config, cell.mix, 2 ** 33 + 17, "cpu")
    runs = harness.run_job(harness.Inputs(snap), cell, "cpu")
    return cell, snap, runs


WHOLE = {"halos": 0, "whole_jobs": 1}
SAMPLED = {"halos": 48, "strata": 6}


def readings(cell, snap, runs, check=WHOLE):
    """The job held to the reference: every halo, or a sample."""
    return ck.check_window([(0, runs)], [snap], [178.0],
                           harness.species_of(cell.mix), 8,
                           cell.config["period"], check, 5, "cpu")


@pytest.mark.parametrize("check", [WHOLE, SAMPLED])
def test_reference_equals_the_port(job, check):
    cell, snap, runs = job
    run = runs[0]
    assert (run.solve.code == 0).sum() > 100        # most halos solve
    assert run.conflicts.n_ignored.any() or run.conflicts.n_subsumed.any()
    assert np.abs(run.solve.vcm).max() > 0.1        # vcm is a real sum
    got = readings(cell, snap, runs, check)
    assert got == ck.empty()
    assert ck.verdict(got, cell.limits)[0]


def test_batched_reference_equals_one_halo_at_a_time(job):
    """solve_halos, the batched brute force, against solve_halo bit for
    bit, its ladder past the first rung included."""
    cell, snap, _ = job
    ps = ck.reference_particles(snap, cell.config["period"], "cpu")
    species = harness.species_of(cell.mix)
    rows = ck.sample_halos(snap, 64, 8, np.random.default_rng(3))
    rgtp = snap.rgtp[rows].copy()
    rgtp[:4] *= np.float32(0.05)        # tiny first rungs: later rungs
    many = ck.ref.solve_halos(ps, snap.centers[rows], rgtp, 178.0, 8,
                              species)
    for c, r, h in zip(snap.centers[rows], rgtp, many):
        one = ck.ref.solve_halo(ps, c, r, 178.0, 8, species)
        assert (h.code, h.j) == (one.code, one.j)
        for f in ("mvir", "rvir", "vcm", "vcirc", "rmass", "rmax", "vmax",
                  "members"):
            assert np.array_equal(np.asarray(getattr(h, f)),
                                  np.asarray(getattr(one, f))), f
        for sp in species:
            assert np.array_equal(h.profiles[sp], one.profiles[sp])
    assert {h.code for h in many} >= {0}


def test_sample_covers_every_stratum(job):
    _, snap, _ = job
    rows = ck.sample_halos(snap, 40, 5, np.random.default_rng(1))
    lr = np.log(snap.rgtp.astype(np.float64))
    edges = np.linspace(lr.min(), lr.max(), 6)
    got = np.unique(np.clip(np.searchsorted(edges, lr[rows], "right") - 1,
                            0, 4))
    have = np.unique(np.clip(np.searchsorted(edges, lr, "right") - 1, 0, 4))
    assert np.array_equal(got, have)
    assert int(np.argmax(snap.rgtp)) in rows


def _largest_solved(run, snap):
    ok = np.nonzero(run.solve.code == 0)[0]
    return int(ok[np.argmax(snap.rgtp[ok])])


@pytest.mark.parametrize("what", ["j", "igrp", "member", "vcm"])
def test_one_changed_output_is_not_correct(job, what):
    cell, snap, runs = job
    bad = copy.deepcopy(runs)
    run = bad[0]
    h = _largest_solved(run, snap)
    if what == "j":
        run.solve.j[h] += 1
    elif what == "igrp":
        p = int(np.nonzero(run.conflicts.igrp)[0][0])
        run.conflicts.igrp[p] += 1
    elif what == "vcm":
        v = run.solve.vcm[h].view(np.int32)
        v[0] += 1                       # one bit of one component
    else:
        m = run.members[h]
        outside = np.setdiff1d(np.arange(snap.n), m)[0]
        m[len(m) // 2] = outside
    got = readings(cell, snap, bad)
    correct, table = ck.verdict(got, cell.limits)
    assert not correct, table
