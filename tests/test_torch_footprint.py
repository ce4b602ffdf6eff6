"""The footprint probe of engine/derived.ball_rounds run in chunks of halos
(derived.FOOTPRINT_PAIRS (halo, cell) pairs a call) gives the same first
capacities, and compute_derived the same outputs, as one call over every
halo, on the CPU."""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box  # noqa: E402

from so_tpu_torch.engine import derived  # noqa: E402
from so_tpu_torch.engine.solver import _pick_level_span, solve_rvir  # noqa: E402
from so_tpu_torch.io.tipsy import DARK, GAS  # noqa: E402
from so_tpu_torch.ops import gather  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402


@pytest.fixture(scope="module")
def solved():
    rng = np.random.default_rng(41)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=1500, rmax=0.06,
                   mass_total=0.2),
              dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04,
                   mass_total=0.08)]
    d = make_clumpy_box(rng, n_background=4000, clumps=clumps)
    G = 40
    centers = np.concatenate([
        np.asarray(clumps[i % 2]["center"], np.float32)[None, :]
        + rng.normal(scale=0.01, size=(1, 3)).astype(np.float32)
        for i in range(G)]).astype(np.float32)
    rgtp = rng.uniform(0.01, 0.05, G).astype(np.float32)
    ptype = np.where(np.arange(d["pos"].shape[0]) % 3 == 0, GAS, DARK)
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], ptype=ptype, m=3,
                      device="cpu")
    s = solve_rvir(grid, centers, rgtp, 178.0)
    assert (s.code == 0).sum() >= 20
    return grid, centers, s


def test_chunked_probe_matches_one_call(solved, monkeypatch):
    grid, centers, s = solved
    ok = s.code == 0
    fball = (np.float32(2.0) * s.rvir).astype(np.float32)
    todo = np.nonzero(ok)[0]
    one = derived.probe_capacities(grid, centers, fball, todo)
    _, S0 = _pick_level_span(grid, float(fball[todo].max()))
    calls = []
    orig = gather.footprint

    def spy(*a):
        calls.append(a[2].shape[0])
        return orig(*a)

    monkeypatch.setattr(derived, "footprint", spy)
    monkeypatch.setattr(derived, "FOOTPRINT_PAIRS", 7 * S0 ** 3)
    chunked = derived.probe_capacities(grid, centers, fball, todo)
    assert len(calls) >= 3 and max(calls) <= 7 and sum(calls) == todo.size
    np.testing.assert_array_equal(chunked, one)
    assert (one[todo] >= 256).all() and not one[~ok].any()


def test_chunked_probe_derived_outputs(solved, monkeypatch):
    grid, centers, s = solved
    ok = s.code == 0
    species = (DARK, GAS)

    def run():
        return derived.compute_derived(grid, centers, s.rvir, s.mvir, s.j,
                                       ok, species=species)

    want = run()
    monkeypatch.setattr(derived, "FOOTPRINT_PAIRS", 5)    # one halo a call
    got = run()
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        np.testing.assert_array_equal(getattr(got, f).view(np.int32),
                                      getattr(want, f).view(np.int32),
                                      err_msg=f)
    for sp in species:
        np.testing.assert_array_equal(got.profiles[sp].view(np.int32),
                                      want.profiles[sp].view(np.int32))
    assert np.isfinite(got.vmax).all() and (got.vmax[ok] > 0).all()
