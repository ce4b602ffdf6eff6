"""so_tpu_torch's whole-box terminal tier (engine/solver._whole_box_stage,
routed by engine/multi.solve_rvir_multi above solver.WBOX_K_MIN) against
so_tpu's _whole_box_stage / _whole_box_multi_stage and against the port's
own gather-only escalation, on the CPU.

so_tpu's results are computed once per module. n_in, found, jstar, code,
Mvir, Rvir and j must agree bit for bit with so_tpu; d2cut is held to the
per-op d2 witness in the port and to the fused one in so_tpu, as in
test_torch_solver.py (XLA:CPU contracts dx*dx + dy*dy + dz*dz into fmas).
Against the port's gather-only run every field agrees bit for bit.
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

import jax.numpy as jnp  # noqa: E402
from so_tpu.engine import multi as jax_multi  # noqa: E402
from so_tpu.engine import solver as jax_solver  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine import multi, solver  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402
from so_tpu_torch.parallel import build_sharded_grid, make_mesh  # noqa: E402

FIELDS = ("code", "mvir", "rvir", "j", "d2cut")
THRESHOLDS = (100.0, 178.0)
CLUMP = np.asarray([0.05, -0.1, 0.2], np.float32)


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


def assert_same(got, want, fields=FIELDS, t=None):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if t is not None:
            a = a[t]
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)


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
    ceiling at 256 so that the clump halos reach the whole-box tier."""
    pos, mass, centers, rgtp, _ = box
    jgrid = jax_build_grid(pos, mass, m=3)
    hits = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_solver, "k_slab_max", lambda nch: 256)
        for name in ("_whole_box_stage", "_whole_box_multi_stage"):
            orig = getattr(jax_solver, name)
            mp.setattr(jax_solver, name,
                       lambda *a, _o=orig, **k: (hits.append(1),
                                                 _o(*a, **k))[1])
        single = jax_solver.solve_rvir(jgrid, centers, rgtp, THRESHOLDS[1],
                                       k0_cap=64, fused=False, survey=False)
        mult = jax_multi.solve_rvir_multi(jgrid, centers, rgtp, THRESHOLDS,
                                          k0_cap=64, survey=False)
    assert hits
    return single, mult


def _port(grid, centers, rgtp, wk, monkeypatch, thresholds=None):
    """The port's solve (or multi solve at ``thresholds``) with WBOX_K_MIN
    at ``wk``; returns (result, whole-box dispatches)."""
    monkeypatch.setattr(solver, "WBOX_K_MIN", wk)
    n0 = solver.wbox_dispatches
    if thresholds is None:
        r = solver.solve_rvir(grid, centers, rgtp, THRESHOLDS[1], k0_cap=64,
                              survey=False)
    else:
        r = multi.solve_rvir_multi(grid, centers, rgtp, thresholds,
                                   k0_cap=64, survey=False)
    return r, solver.wbox_dispatches - n0


# --- the stage -------------------------------------------------------------

def _stage_box():
    """A uniform make_clumpy_box box in which 40 clump particles share one
    position (their d2 are equal from any center), with centers on the
    clump, on the shared position, in the background and one empty ball."""
    rng = np.random.default_rng(5)
    d = make_clumpy_box(rng, n_background=3000, clumps=[
        dict(center=(-0.2, 0.1, 0.3), n=2500, rmax=0.07, mass_total=0.4)])
    pos = d["pos"]
    pos[3000:3040] = pos[3100]
    n = pos.shape[0]
    mass = np.full(n, np.float32(1.0 / n), np.float32)
    centers = np.asarray([(-0.2, 0.1, 0.3), (-0.19, 0.11, 0.3), pos[3100],
                          (0.4, -0.4, 0.0), (0.0, 0.0, 0.0),
                          (0.45, 0.45, -0.45)], np.float32)
    radii = np.asarray([0.05, 0.12, 0.01, 0.3, 0.08, 1e-6], np.float32)
    return pos, mass, centers, radii


@pytest.fixture(scope="module")
def stage_case():
    pos, mass, centers, radii = _stage_box()
    jgrid = jax_build_grid(pos, mass, m=3)
    lad = jax_solver._wbox_ladder_dev(jgrid)
    want = {1: jax_solver.unpack_stage_out(np.asarray(
        jax_solver._whole_box_stage(jgrid, lad, 8, jnp.asarray(centers),
                                    jnp.asarray(radii),
                                    jnp.float32(THRESHOLDS[1]))))}
    arr = np.asarray(jax_solver._whole_box_multi_stage(
        jgrid, lad, 8, 2, jnp.asarray(centers), jnp.asarray(radii),
        jnp.asarray(THRESHOLDS, jnp.float32)))
    want[2] = arr
    return pos, mass, centers, radii, want


@pytest.mark.parametrize("T", [1, 2])
def test_whole_box_stage_matches_so_tpu(stage_case, T):
    """The port's stage against so_tpu's _whole_box_stage (T = 1) and
    _whole_box_multi_stage (T = 2): n_in, found, jstar and Mvir bit for
    bit, d2cut each side's own d2 form at rank jstar-1; equal d2 in the
    balls about the shared position, and an empty ball."""
    pos, mass, centers, radii, want = stage_case
    grid = build_grid(pos, mass, m=3, device="cpu")
    thr = THRESHOLDS[2 - T:]
    ints, per_t, flts = solver._whole_box_stage(
        grid, torch.as_tensor(centers), torch.as_tensor(radii),
        np.asarray(thr, np.float32), 8)
    assert not ints[:, 1].any()
    assert ints[5, 0] == 0 and ints[2, 0] >= 40     # empty; 40 equal d2
    assert per_t[:, :, 0].any()
    if T == 1:
        wi, wf = want[1]
        w_nin, w_found, w_jstar = wi[:, 0], wi[None, :, 2], wi[None, :, 1]
        w_mvir, w_d2cut = wf[None, :, 0], wf[None, :, 2]
    else:
        arr = want[2]
        w_nin = arr[T, :, 0]
        w_found, w_jstar = arr[:T, :, 0], arr[:T, :, 1]
        fl = np.ascontiguousarray(arr[:T, :, 2:5]).view(np.float32)
        w_mvir, w_d2cut = fl[:, :, 0], fl[:, :, 2]
    np.testing.assert_array_equal(ints[:, 0], w_nin)
    np.testing.assert_array_equal(per_t[:, :, 0], w_found)
    np.testing.assert_array_equal(per_t[:, :, 1], w_jstar)
    np.testing.assert_array_equal(flts[:, :, 0].view(np.int32),
                                  w_mvir.view(np.int32))
    r2 = radii * radii
    for t in range(T):
        for h in range(centers.shape[0]):
            per_op, fused = d2_forms(pos, centers[h], (1.0, 1.0, 1.0))
            per_op = np.sort(per_op[per_op <= r2[h]])
            fused = np.sort(fused[fused <= r2[h]])
            k = max(int(per_t[t, h, 1]) - 1, 0)
            got_w = per_op[k] if per_op.size else np.float32(np.inf)
            want_w = fused[k] if fused.size else np.float32(np.inf)
            assert flts[t, h, 1].view(np.int32) == got_w.view(np.int32)
            assert w_d2cut[t, h].view(np.int32) == want_w.view(np.int32)


def test_whole_box_d2_per_op_form(stage_case):
    """whole_box_d2 is the per-op min-image d2 of every payload row."""
    pos, mass, centers, _, _ = stage_case
    grid = build_grid(pos, mass, m=3, device="cpu")
    got = solver.whole_box_d2(grid, torch.as_tensor(centers)).numpy()
    rows = grid.orig_idx.numpy()
    for h in range(centers.shape[0]):
        want = d2_forms(pos[rows], centers[h], (1.0, 1.0, 1.0))[0]
        np.testing.assert_array_equal(got[h].view(np.int32),
                                      want.view(np.int32))


# --- the route -------------------------------------------------------------

def test_solve_with_route_forced(box, so_tpu_runs, monkeypatch):
    """WBOX_K_MIN lowered to 256: the whole-box stage runs, and every field
    equals the gather-only run's and so_tpu's."""
    pos, _, centers, rgtp, grid = box
    base, n_base = _port(grid, centers, rgtp, None, monkeypatch)
    got, n_got = _port(grid, centers, rgtp, 256, monkeypatch)
    assert n_base == 0 and n_got > 0
    assert (base.code == 0).any() and (base.code < 0).any()
    assert_same(got, base)
    assert_like_so_tpu(got, so_tpu_runs[0], pos, centers)


def test_multi_solve_with_route_forced(box, so_tpu_runs, monkeypatch):
    """solve_rvir_multi at 100 and 178 with the route forced: each
    threshold equals the gather-only multi run, the single solve and
    so_tpu's multi solve."""
    pos, _, centers, rgtp, grid = box
    base, _ = _port(grid, centers, rgtp, None, monkeypatch, THRESHOLDS)
    got, n_got = _port(grid, centers, rgtp, 256, monkeypatch, THRESHOLDS)
    assert n_got > 0
    want = so_tpu_runs[1]
    for t, thr in enumerate(THRESHOLDS):
        for f in FIELDS:
            np.testing.assert_array_equal(_bits(getattr(got, f)[t]),
                                          _bits(getattr(base, f)[t]),
                                          err_msg=f"{f} thr={thr}")
        single = solver.solve_rvir(grid, centers, rgtp, thr, k0_cap=64,
                                   survey=False)
        assert_same(got, single, t=t)
        one = SimpleNamespace(**{f: getattr(want, f)[t] for f in FIELDS})
        assert_like_so_tpu(single, one, pos, centers)


def test_open_minus1_halo_dispatched_at_its_rung(box, monkeypatch):
    """A halo whose every earlier round overflowed reaches the whole-box
    tier with its -1 verdict open: it is dispatched at its current rung
    (rung 1), not its last; a halo whose -1 verdict closed is dispatched
    at its last rung."""
    _, _, centers, rgtp, grid = box
    seen = []
    orig = multi._whole_box_stage

    def spy(g, c, r, *a):
        seen.append((c.numpy().copy(), r.numpy().copy()))
        return orig(g, c, r, *a)

    monkeypatch.setattr(multi, "_whole_box_stage", spy)
    got, _ = _port(grid, centers, rgtp, 256, monkeypatch)
    kmax, _ = solver.rvir_ladder(rgtp, grid.period_np())
    tiny, small = centers.shape[0] - 2, centers.shape[0] - 1
    assert got.code[tiny] == -1 and got.code[small] == 0
    rung1 = solver.ladder_radius(rgtp, np.ones_like(kmax))
    last = solver.ladder_radius(rgtp, kmax)
    radii = np.concatenate([r for _, r in seen])
    # the two share their center, so each is told apart by its radius
    assert rung1[tiny] in radii and last[tiny] not in radii
    assert last[small] in radii


@pytest.mark.parametrize("kind", ["general mass", "sharded"])
def test_route_not_taken(box, monkeypatch, kind):
    """No whole-box dispatch on a general-mass grid or on a ShardedGrid
    (--mesh / --distributed), and results unchanged, with WBOX_K_MIN
    lowered to 256 (every 4th halo)."""
    pos, mass, centers, rgtp, grid = box
    centers, rgtp = centers[::4], rgtp[::4]     # 10 of the 40 clump halos
    assert _port(grid, centers, rgtp, 256, monkeypatch)[1] > 0
    if kind == "general mass":
        mass = (np.random.default_rng(1).uniform(0.5, 1.5, mass.size)
                / mass.size).astype(np.float32)
        grid = build_grid(pos, mass, m=3, device="cpu")
        assert grid.uniform_mass is None
        ref = grid
    else:
        grid = build_sharded_grid(pos, mass, mesh=make_mesh(
            1, 2, devices=[torch.device("cpu")] * 2))
        assert grid.uniform_mass is not None
        ref = box[4]
    base, _ = _port(ref, centers, rgtp, None, monkeypatch)
    got, n_got = _port(grid, centers, rgtp, 256, monkeypatch)
    assert n_got == 0
    assert_same(got, base)


def test_wbox_chunk_matches_so_tpu():
    for n in [1, 2, 3, 1000, 5_000_000, 46_100_000, 2 ** 21, 2 ** 21 + 1,
              2 ** 27, 512 ** 3 + 12_345, 2 ** 30]:
        assert solver._wbox_chunk(n) == jax_solver._wbox_chunk(n), n
    assert [solver._wbox_chunk(n) for n in (512 ** 3 + 1, 46_100_000,
                                            5_000_000)] == [1, 2, 16]


def test_wbox_ladder_cached_on_the_grid(box):
    """One (N,) ladder a grid, equal to so_tpu's, kept on the grid object
    and outside _mass_ladder_on's cache."""
    pos, mass, _, _, _ = box
    grid = build_grid(pos, mass, m=3, device="cpu")
    before = solver._mass_ladder_on.cache_info().currsize
    lad = solver._wbox_ladder(grid)
    assert solver._wbox_ladder(grid) is lad
    assert solver._mass_ladder_on.cache_info().currsize == before
    want = np.asarray(jax_solver._wbox_ladder_dev(jax_build_grid(pos, mass,
                                                                 m=3)))
    np.testing.assert_array_equal(lad.numpy().view(np.int32),
                                  want.view(np.int32))
