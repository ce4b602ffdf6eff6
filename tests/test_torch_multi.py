"""so_tpu_torch's multi-threshold solve (--deltas) against so_tpu's
solve_rvir_multi and against the port's own single-threshold solves, on
the CPU. so_tpu runs its Pallas slab kernel in interpret mode.

code, Mvir, Rvir and j must agree bit for bit with both; d2cut is held
to the per-op d2 witness as in test_torch_solver.py. run_so_multi must
give, per threshold, run_so's members, igrp, vcm and derived values, and
the CLI's --deltas output sets must equal -delta runs.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from scenarios import generate_inputs  # noqa: E402
from test_torch_pipeline import _box  # noqa: E402
from test_torch_solver import BOXES, d2_forms  # noqa: E402
from util_compare import (compare_exact_file, compare_file,  # noqa: E402
                          compare_sogtp)

from so_tpu.engine.multi import solve_rvir_multi as jax_solve_multi  # noqa: E402
from so_tpu.io.tipsy import DARK, GAS, MARK, STAR  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine.multi import solve_rvir_multi  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so, run_so_multi  # noqa: E402
from so_tpu_torch.engine.solver import solve_rvir  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402

THRESHOLDS = (178.0, 500.0)


@pytest.mark.parametrize("name", ["general", "uniform", "errors"])
def test_multi_matches_so_tpu_and_single(name):
    make, seed, uniform, codes = BOXES[name]
    data, centers, rgtp, _ = make(seed, uniform)
    want = jax_solve_multi(jax_build_grid(data["pos"], data["mass"], m=3,
                                          pallas=True),
                           centers, rgtp, THRESHOLDS, survey=False)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    got = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS)
    assert set(codes) <= set(got.code[0].tolist())
    for t, thr in enumerate(THRESHOLDS):
        single = solve_rvir(grid, centers, rgtp, thr)
        for f in ("code", "mvir", "rvir", "j"):
            np.testing.assert_array_equal(getattr(got, f)[t],
                                          getattr(want, f)[t],
                                          err_msg=f"{f} thr={thr}")
            np.testing.assert_array_equal(getattr(got, f)[t],
                                          getattr(single, f),
                                          err_msg=f"{f} thr={thr}")
        np.testing.assert_array_equal(got.d2cut[t].view(np.int32),
                                      single.d2cut.view(np.int32))
        for h in np.nonzero(got.code[t] == 0)[0]:
            per_op, fused = (np.sort(d) for d in
                             d2_forms(data["pos"], centers[h],
                                      (1.0, 1.0, 1.0)))
            k = got.j[t, h] - 1
            assert got.d2cut[t, h].view(np.int32) == per_op[k].view(np.int32)
            assert want.d2cut[t, h].view(np.int32) == fused[k].view(np.int32)


def test_multi_capacity_escalation():
    """A tiny first capacity: the x4 overflow rounds give the same results
    as the default."""
    make, seed, uniform, _ = BOXES["general"]
    data, centers, rgtp, _ = make(seed, uniform)
    grid = build_grid(data["pos"], data["mass"], m=3, device="cpu")
    a = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS)
    b = solve_rvir_multi(grid, centers, rgtp, THRESHOLDS, k0_cap=64)
    assert (b.kcap > 64).any()
    for f in ("code", "mvir", "rvir", "j", "d2cut"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_run_so_multi_equals_run_so():
    ps, catalog = _box(False)
    species = (DARK, GAS, STAR, MARK)
    params = SOParams(species=species, device="cpu")
    grid = build_grid(ps.pos, ps.mass, vel=ps.vel, ptype=ps.ptype_all(),
                      mark=ps.mark, device="cpu")
    thresholds = (178.0, 400.0)
    runs = run_so_multi(ps, catalog(), params, thresholds, grid=grid)
    assert len(runs) == 2 and "R_Delta solve (multi)" in runs[0].phases
    for thr, got in zip(thresholds, runs):
        want = run_so(ps, catalog(), SOParams(threshold=thr, species=species,
                                              device="cpu"), grid=grid)
        assert "grid build" not in want.phases
        assert (got.solve.code == 0).sum() >= 3
        for f in ("code", "mvir", "rvir", "j", "d2cut", "vcm"):
            np.testing.assert_array_equal(getattr(got.solve, f),
                                          getattr(want.solve, f), err_msg=f)
        for f in ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir"):
            np.testing.assert_array_equal(getattr(got.conflicts, f),
                                          getattr(want.conflicts, f))
        for a, b in zip(got.members, want.members):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        for f in ("vcirc", "rmass", "rmax", "vmax"):
            np.testing.assert_array_equal(getattr(got.derived, f),
                                          getattr(want.derived, f))
        for sp in species:
            np.testing.assert_array_equal(got.derived.profiles[sp],
                                          want.derived.profiles[sp])
        assert got.stats == want.stats


def test_deltas_checkpoint_rejected(tmp_path):
    """--deltas with --checkpoint exits 1 and writes no state file (so_tpu:
    run_so_multi never reads the checkpoint)."""
    from so_tpu_torch.cli import main

    workdir = str(tmp_path)
    generate_inputs("basic", workdir)
    with pytest.raises(SystemExit) as ei:
        main(["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
              "-o", f"{workdir}/out", "--deltas", "120,400",
              "--checkpoint", f"{workdir}/state.npz", "--device", "cpu"])
    assert ei.value.code == 1
    assert not os.path.exists(f"{workdir}/state.npz")


def test_deltas_matches_single_runs(tmp_path):
    from so_tpu_torch.cli import main

    workdir = str(tmp_path)
    generate_inputs("basic", workdir)
    base_args = ["-i", f"{workdir}/cat.gtp", "--tipsy", f"{workdir}/snap.bin",
                 "-grp", "-gtp", "--device", "cpu"]
    assert main(base_args + ["-o", f"{workdir}/multi",
                             "--deltas", "120,400"]) == 0
    for d in ("120", "400"):
        assert main(base_args + ["-o", f"{workdir}/single{d}",
                                 "-delta", d]) == 0
        errs = compare_file(f"{workdir}/single{d}.sovcirc",
                            f"{workdir}/multi.d{d}.sovcirc")
        errs += compare_exact_file(f"{workdir}/single{d}.sogrp",
                                   f"{workdir}/multi.d{d}.sogrp")
        # the .sogtp vel columns are vcm, which the member pass refills
        errs += compare_sogtp(f"{workdir}/single{d}.sogtp",
                              f"{workdir}/multi.d{d}.sogtp", False)
        assert not errs, "\n".join(errs[:5])
