"""so_tpu_torch's --survey pre-pass (the sort-free -1/-2 classifier)
against so_tpu's _classify_stage on the CPU (so_tpu's slab kernel in
interpret mode), and the solves it feeds: forced, auto-gated and off must
give identical results, single- and multi-threshold.

Both packages read one grid (so_tpu's build, carried into the port by
grid_from_arrays). The boxes are tests/test_solver.py's survey problem
with extra centers; on them the ulp by which the port's d2 may differ
from XLA:CPU's fused form (ROADMAP.md section 3) decides no verdict.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402
from test_torch_grid import jax_grid_arrays  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from so_tpu.engine import solver as jsolver  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine import solver  # noqa: E402
from so_tpu_torch.engine.multi import solve_rvir_multi  # noqa: E402
from so_tpu_torch.ops.grid import grid_from_arrays  # noqa: E402

THRESHOLDS = (178.0, 500.0, 1e-4)


def _problem(uniform):
    rng = np.random.default_rng(55)
    d = make_clumpy_box(rng, n_background=6000, clumps=[
        dict(center=(0.2, 0.2, 0.2), n=2000, rmax=0.06, mass_total=0.25)])
    if not uniform:     # the fixture's background and clump masses agree
        d["mass"] = (d["mass"] * rng.uniform(0.5, 1.5, d["mass"].size)
                     ).astype(np.float32)
    jgrid = jax_build_grid(d["pos"], d["mass"], m=3, pallas=True)
    grid = grid_from_arrays(**jax_grid_arrays(jgrid), device="cpu")
    assert (grid.uniform_mass is not None) == uniform
    centers = np.concatenate([
        np.array([(0.2, 0.2, 0.2), (-0.4, -0.4, -0.4), (-0.35, 0.4, -0.4),
                  (0.21, 0.19, 0.2), (0.4, -0.4, 0.4)], np.float32),
        rng.uniform(-0.5, 0.5, (11, 3)).astype(np.float32)])
    rgtp = np.concatenate([[0.05, 0.004, 0.2, 0.04, 0.15],
                           rng.uniform(0.003, 0.08, 11)]).astype(np.float32)
    return jgrid, grid, centers, rgtp


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "general"])
def test_classify_stage_matches_so_tpu(uniform):
    jgrid, grid, centers, rgtp = _problem(uniform)
    radii = solver.ladder_radius(rgtp, np.ones(rgtp.size, np.int32))
    level, S = solver._pick_level_span(grid, float(radii.max()))
    K = 4096
    thr = np.asarray(THRESHOLDS, np.float32)
    want = np.asarray(jsolver._classify_stage(
        jgrid, level, K, S, 8, jnp.asarray(centers), jnp.asarray(radii),
        jnp.asarray(thr), T=thr.size))
    got = solver._classify_stage(grid, level, K, S, 8,
                                 solver.torch.as_tensor(centers),
                                 solver.torch.as_tensor(radii), thr)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    n_in = got[:, 0] & 0x7FFFFFFF
    assert (n_in < 8).any() and (n_in >= 8).any()       # -1 and not
    assert (got[:, 1] & 1).any() and (got[:, 1] != 7).any()   # some -2
    assert not ((got[:, 0] >> 31) & 1).any()             # nothing overflowed


def _same(a, b, fields=("code", "mvir", "rvir", "j", "d2cut")):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "general"])
def test_solve_same_with_survey_forced_auto_off(uniform, monkeypatch):
    _, grid, centers, rgtp = _problem(uniform)
    calls = []
    real = solver._classify_stage
    monkeypatch.setattr(solver, "_classify_stage",
                        lambda *a: calls.append(1) or real(*a))
    off = solver.solve_rvir(grid, centers, rgtp, 178.0, survey=False)
    assert not calls and {0, -1, -2} <= set(off.code.tolist())
    auto_small = solver.solve_rvir(grid, centers, rgtp, 178.0, survey=None)
    assert not calls                 # under SURVEY_MIN_G: the gate stays shut
    forced = solver.solve_rvir(grid, centers, rgtp, 178.0, survey=True)
    assert calls
    monkeypatch.setattr(solver, "SURVEY_MIN_G", 4)
    monkeypatch.setattr(solver, "SURVEY_SAMPLE", 2)
    # sample = the first 2 halos: one success + one -1 -> 50%: opens
    n = len(calls)
    auto_open = solver.solve_rvir(grid, centers, rgtp, 178.0, survey=None)
    assert len(calls) >= n + 2
    monkeypatch.setattr(solver, "SURVEY_FRAC", 2.0)     # closes after it
    n = len(calls)
    auto_closed = solver.solve_rvir(grid, centers, rgtp, 178.0, survey=None)
    assert len(calls) == n + 1
    for got in (auto_small, forced, auto_open, auto_closed):
        _same(got, off)


def test_multi_same_with_survey_forced_auto_off(monkeypatch):
    _, grid, centers, rgtp = _problem(False)
    off = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS, survey=False)
    forced = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS, survey=True)
    monkeypatch.setattr(solver, "SURVEY_MIN_G", 4)
    monkeypatch.setattr(solver, "SURVEY_SAMPLE", 2)
    auto = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS, survey=None)
    assert {0, -1, -2} <= set(off.code.ravel().tolist())
    for got in (forced, auto):
        _same(got, off)
    for t, thr in enumerate(THRESHOLDS):
        single = solver.solve_rvir(grid, centers, rgtp, thr, survey=True)
        for f in ("code", "mvir", "rvir", "j", "d2cut"):
            np.testing.assert_array_equal(getattr(forced, f)[t],
                                          getattr(single, f), err_msg=f)
