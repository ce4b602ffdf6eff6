"""so_tpu_torch's gather-only escalation on a uniform-mass clump at a tiny
first capacity (engine/multi.solve_rvir_multi: overflow -> x4 regathers
up to solver._k_limit, grown balls) against so_tpu, on the CPU.

so_tpu runs this box with its slab ceiling at 256 slots, so its clump
halos go to its whole-box terminal tier: the port reaches the same
verdicts by gathers alone. so_tpu's results are computed once per
module. code, Mvir, Rvir and j must agree bit for bit with so_tpu; d2cut
is held to the per-op d2 witness in the port and to the fused one in
so_tpu, as in test_torch_solver.py (XLA:CPU contracts dx*dx + dy*dy +
dz*dz into fmas). Between the port's own runs every field agrees bit for
bit.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402
from test_torch_solver import d2_forms  # noqa: E402

from so_tpu.engine import multi as jax_multi  # noqa: E402
from so_tpu.engine import solver as jax_solver  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch import profiling  # noqa: E402
from so_tpu_torch.engine import multi, solver  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402
from so_tpu_torch.parallel import build_sharded_grid, make_mesh  # noqa: E402

FIELDS = ("code", "mvir", "rvir", "j", "d2cut")
THRESHOLDS = (100.0, 178.0)
CLUMP = np.asarray([0.05, -0.1, 0.2], np.float32)
K0_CAP = 64


def _scenario():
    """tests/test_solver.py's whole-box scenario (seed 93: one clump of
    4,000 on 4,000 uniform, masses 1/N; 40 centers about the clump and 8
    anywhere, k0_cap 64), plus two centers at the clump's center: one with
    rgtp 1e-5 (its first ball holds < nMembers: -1) and one with 0.002."""
    rng = np.random.default_rng(93)
    d = make_clumpy_box(rng, n_background=4000, clumps=[
        dict(center=tuple(CLUMP), n=4000, rmax=0.08, mass_total=0.5)])
    n = d["pos"].shape[0]
    mass = np.full(n, np.float32(1.0 / n), np.float32)
    G = 48
    centers = np.concatenate([
        CLUMP[None, :] + rng.normal(scale=0.01, size=(G - 8, 3)).astype(
            np.float32),
        rng.uniform(-0.5, 0.5, (8, 3)).astype(np.float32)]).astype(np.float32)
    rgtp = rng.uniform(0.004, 0.02, G).astype(np.float32)
    centers = np.concatenate([centers, CLUMP[None, :], CLUMP[None, :]])
    rgtp = np.concatenate([rgtp, np.float32([1e-5, 0.002])])
    return d["pos"], mass, centers, rgtp


def _bits(a):
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same(got, want, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(_bits(getattr(got, f)),
                                      _bits(getattr(want, f)), err_msg=f)


def assert_like_so_tpu(got, want, pos, centers):
    """code, mvir, rvir, j bit for bit; each solved halo's d2cut the
    per-op (port) and fused (so_tpu) d2 at sorted rank j-1."""
    assert_same(got, want, ("code", "mvir", "rvir", "j"))
    for h in np.nonzero(got.code == 0)[0]:
        per_op, fused = (np.sort(d) for d in
                         d2_forms(pos, centers[h], (1.0, 1.0, 1.0)))
        k = got.j[h] - 1
        assert got.d2cut[h].view(np.int32) == per_op[k].view(np.int32), h
        assert want.d2cut[h].view(np.int32) == fused[k].view(np.int32), h


@pytest.fixture(scope="module")
def box():
    pos, mass, centers, rgtp = _scenario()
    grid = build_grid(pos, mass, m=3, device="cpu")
    assert grid.uniform_mass is not None
    return pos, mass, centers, rgtp, grid


@pytest.fixture(scope="module")
def so_tpu_runs(box):
    """so_tpu's solve at THRESHOLDS[1] and its multi solve, with its slab
    ceiling at 256 so that the clump halos reach its whole-box tier, whose
    stages build the grid's (N,) mass ladder (cached as ``_wbox_lad``)."""
    pos, mass, centers, rgtp, _ = box
    jgrid = jax_build_grid(pos, mass, m=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_solver, "k_slab_max", lambda nch: 256)
        single = jax_solver.solve_rvir(jgrid, centers, rgtp, THRESHOLDS[1],
                                       k0_cap=K0_CAP, fused=False,
                                       survey=False)
        assert hasattr(jgrid, "_wbox_lad")
        del jgrid._wbox_lad
        mult = jax_multi.solve_rvir_multi(jgrid, centers, rgtp, THRESHOLDS,
                                          k0_cap=K0_CAP, survey=False)
        assert hasattr(jgrid, "_wbox_lad")
    return single, mult


@pytest.fixture(scope="module")
def port_run(box):
    """The port's solve at THRESHOLDS[1], k0_cap 64, survey off."""
    _, _, centers, rgtp, grid = box
    return solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1],
                             k0_cap=K0_CAP, survey=False)


@pytest.mark.parametrize("k0_cap", [64, 256, 4096])
def test_uniform_escalation_matches_so_tpu(box, so_tpu_runs, k0_cap):
    """The port's solve from any first capacity equals so_tpu's whole-box
    run (results are path-independent); from 64 it must regather."""
    pos, _, centers, rgtp, grid = box
    got = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1],
                            k0_cap=k0_cap, survey=False)
    assert (got.code == 0).any() and (got.code < 0).any()
    if k0_cap == K0_CAP:
        assert (got.kcap > K0_CAP).any()
    assert_like_so_tpu(got, so_tpu_runs[0], pos, centers)


@pytest.mark.parametrize("t", range(len(THRESHOLDS)),
                         ids=[f"{thr:g}" for thr in THRESHOLDS])
def test_multi_escalation_matches_so_tpu(box, so_tpu_runs, t):
    """solve_rvir_multi at 100 and 178: each threshold equals the port's
    solve_rvir at it and so_tpu's multi solve."""
    pos, _, centers, rgtp, grid = box
    got = multi.solve_rvir_multi(grid, centers, rgtp, THRESHOLDS,
                                 k0_cap=K0_CAP, survey=False).at(t)
    single = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[t],
                               k0_cap=K0_CAP, survey=False)
    assert_same(got, single)
    want = so_tpu_runs[1]
    one = SimpleNamespace(**{f: getattr(want, f)[t] for f in FIELDS})
    assert_like_so_tpu(got, one, pos, centers)


def test_open_minus1_halo_under_overflow(box):
    """The clump's center at rgtp 1e-5 overflows its first gather at 64
    slots and keeps its -1 verdict open through the regathers: it reads
    -1, its twin at rgtp 0.002 reads 0."""
    _, _, centers, rgtp, grid = box
    base = dict(profiling.counts)
    got = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1],
                            k0_cap=K0_CAP, survey=False)
    regathers = (profiling.counts[("solve.overflow_regathers",)]
                 - base.get(("solve.overflow_regathers",), 0))
    assert regathers > 0
    tiny, small = centers.shape[0] - 2, centers.shape[0] - 1
    assert got.kcap[tiny] > K0_CAP          # not settled by its first gather
    assert got.code[tiny] == -1 and got.code[small] == 0


def test_escalation_sharded_equals_cell_grid(box, port_run):
    """A ShardedGrid on a 1x2 CPU mesh (--mesh) gives the CellGrid's
    fields bit for bit."""
    pos, mass, centers, rgtp, _ = box
    grid = build_sharded_grid(pos, mass, mesh=make_mesh(
        1, 2, devices=[torch.device("cpu")] * 2))
    assert grid.uniform_mass is not None and grid.parts == 2
    got = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1],
                            k0_cap=K0_CAP, survey=False)
    assert_same(got, port_run)


def _halo_gathers(grid, centers, rgtp, survey):
    """(solve_rvir at k0_cap 64 with ``survey``, the halo gathers it
    counted)."""
    key = ("solve.halo_gathers",)
    n0 = profiling.counts.get(key, 0)
    got = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1],
                            k0_cap=K0_CAP, survey=survey)
    return got, profiling.counts.get(key, 0) - n0


@pytest.mark.parametrize("survey", [True, None])
def test_escalation_survey_setting(box, port_run, survey):
    """The survey pre-pass forced (its classify gathers are counted on
    top of the rounds') or auto-gated (it skips a catalog below
    SURVEY_MIN_G) gives the fields of the run without it."""
    _, _, centers, rgtp, grid = box
    _, n_off = _halo_gathers(grid, centers, rgtp, False)
    got, n = _halo_gathers(grid, centers, rgtp, survey)
    assert n > n_off if survey else n == n_off
    assert_same(got, port_run)


def test_row_ladder_is_the_capacity_prefix(box):
    """_row_ladder(grid, K) is _mass_ladder_on's one entry for parts * K
    slots, np.cumsum's serial sums and so_tpu's ladder bit for bit; None
    on general masses."""
    pos, mass, _, _, grid = box
    sharded = build_sharded_grid(pos, mass, mesh=make_mesh(
        1, 2, devices=[torch.device("cpu")] * 2))
    um = grid.uniform_mass
    for g in (grid, sharded):
        for K in (64, 4096):
            n = g.parts * K
            lad = solver._row_ladder(g, K)
            assert lad is solver._mass_ladder_on(um, n, g.device)
            assert solver._row_ladder(g, K) is lad
            want = np.cumsum(np.full(n, np.float32(um), np.float32))
            np.testing.assert_array_equal(lad.numpy().view(np.int32),
                                          want.view(np.int32))
            np.testing.assert_array_equal(
                lad.numpy().view(np.int32),
                jax_solver._mass_ladder(um, n).view(np.int32))
    general = build_grid(pos, mass * np.float32(1.5) ** (
        np.arange(mass.size) % 2), m=3, device="cpu")
    assert general.uniform_mass is None
    assert solver._row_ladder(general, 64) is None
