"""so_tpu_torch's --mesh path (so_tpu_torch/parallel/mesh.py) on CPU meshes.

A mesh of explicit torch devices (here the CPU, repeated) shards the
particles into P grids and slices each dispatch's halos H ways; every
gather merges the shards' rows, P * K slots a halo. Without equal d2 in a
ball the merged rows are the single-device rows, so every result of the
sharded solve, multi-threshold solve, survey, fused members+derived pass,
-pot recentring and CLI must equal the port's single-device result bit
for bit; each test first checks that its balls hold no equal d2. The
sharded solve and members are also held to so_tpu's sharded path on its
8-virtual-CPU mesh (tests/test_sharding.py's data and tolerance: codes and
j exact, Mvir, Rvir and d2cut to rtol 2e-6).
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from fixtures import make_clumpy_box, write_gtp, write_snapshot  # noqa: E402
from test_torch_pipeline import _box  # noqa: E402
from test_torch_solver import d2_forms  # noqa: E402

import so_tpu.parallel as jax_parallel  # noqa: E402
from so_tpu.ops.grid import choose_chunk as jax_choose_chunk  # noqa: E402
from so_tpu.ops.grid import choose_m as jax_choose_m  # noqa: E402
from so_tpu.parallel.mesh import (  # noqa: E402
    extract_members_sharded as jax_extract_members_sharded)
from so_tpu_torch.cli import main  # noqa: E402
from so_tpu_torch.engine import extract_members, multi, solver  # noqa: E402
from so_tpu_torch.engine.fused import members_and_derived  # noqa: E402
from so_tpu_torch.engine.pipeline import SOParams, run_so  # noqa: E402
from so_tpu_torch.engine.recenter import recenter_most_bound  # noqa: E402
from so_tpu_torch.io.tipsy import DARK, GAS, MARK, STAR  # noqa: E402
from so_tpu_torch.ops import gather  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402
from so_tpu_torch.parallel import (build_sharded_grid,  # noqa: E402
                                   extract_members_sharded, make_mesh,
                                   recenter_most_bound_sharded,
                                   run_so_sharded, solve_rvir_multi_sharded,
                                   solve_rvir_sharded)
from so_tpu_torch.parallel.mesh import host_mv_from_sharded  # noqa: E402

THR = 178.0
MESHES = [(1, 2), (2, 4), (4, 2), (1, 8)]
IDS = [f"{h}x{p}" for h, p in MESHES]


def cpu_mesh(h, p):
    return make_mesh(h, p, devices=[torch.device("cpu")] * (h * p))


@pytest.fixture(scope="module")
def data():
    """tests/test_sharding.py's box: three clumps on a background, 8
    centers near them, seed 17."""
    rng = np.random.default_rng(17)
    clumps = [
        dict(center=(0.1, 0.0, -0.1), n=1400, rmax=0.06, mass_total=0.2),
        dict(center=(-0.25, 0.3, 0.2), n=800, rmax=0.04, mass_total=0.08),
        dict(center=(0.45, 0.45, 0.45), n=700, rmax=0.05, mass_total=0.06),
    ]
    d = make_clumpy_box(rng, n_background=3500, clumps=clumps)
    base = np.array([[0.1, 0.0, -0.1], [-0.25, 0.3, 0.2],
                     [0.45, 0.45, 0.45]], np.float32)
    extra = (np.concatenate([base, base[:2]])
             + rng.normal(size=(5, 3)).astype(np.float32) * 0.01)
    centers = np.concatenate([base, extra])
    rgtp = rng.uniform(0.03, 0.06, centers.shape[0]).astype(np.float32)
    return d, centers, rgtp


def assert_tie_free(pos, centers, radii):
    """No two particles inside a ball lie at equal d2 (the port's d2)."""
    for c, r in zip(centers, radii):
        d2 = d2_forms(pos, c, (1.0, 1.0, 1.0))[0]
        inside = d2[d2 <= np.float32(r) * np.float32(r)]
        assert np.unique(inside).size == inside.size, "equal d2 in a ball"


@pytest.fixture(scope="module")
def single(data):
    """The port's single-device grid and solve; the box is tie-free in
    every ball whose order a result reads (read_reach)."""
    d, centers, rgtp = data
    grid = build_grid(d["pos"], d["mass"], vel=d["vel"], phi=d["phi"], m=3,
                      device="cpu")
    solved = solver.solve_rvir(grid, centers, rgtp, THR)
    assert_tie_free(d["pos"], centers, read_reach(solved, rgtp))
    assert (solved.code == 0).sum() >= 5 and (solved.code == -2).any()
    return grid, solved


def read_reach(solved, rgtp):
    """Per halo, the widest ball whose distance order a result reads: the
    2 Rvir ball of the derived quantities (which holds the solve's scan to
    j* + 1) for a solved halo, the first ladder ball for a -2 (codes -1
    and -3 read counts and radii only)."""
    first = solver.ladder_radius(rgtp, np.ones(rgtp.shape, np.int32))
    return np.where(solved.code == 0, np.float32(2) * solved.rvir, first)


@pytest.fixture(scope="module")
def so_tpu_sharded(data):
    """so_tpu's sharded grid and solve on its 2x4 virtual CPU mesh."""
    d, centers, rgtp = data
    mesh = jax_parallel.make_mesh(2, 4)
    sgrid = jax_parallel.build_sharded_grid(d["pos"], d["mass"],
                                            vel=d["vel"], m=3, mesh=mesh)
    return mesh, sgrid, jax_parallel.solve_rvir_sharded(mesh, sgrid, centers,
                                                        rgtp, THR)


def sharded(data, shape, m=3):
    d, _, _ = data
    mesh = cpu_mesh(*shape)
    return mesh, build_sharded_grid(d["pos"], d["mass"], vel=d["vel"],
                                    phi=d["phi"], m=m, mesh=mesh)


def assert_same(got, want, fields):
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


SOLVE_FIELDS = ("code", "mvir", "rvir", "j", "d2cut")


def test_make_mesh_layout():
    devs = [torch.device("cpu")] * 6
    mesh = make_mesh(2, 3, devices=devs)
    assert mesh.shape == {"halo": 2, "part": 3}
    assert len(mesh.devices) == 2 and all(len(r) == 3 for r in mesh.devices)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError):
        make_mesh(2, 2, devices=devs)
    with pytest.raises(ValueError):
        make_mesh(0, 2, devices=[])


def test_make_mesh_needs_cuda_devices():
    """Without devices the mesh takes CUDA devices and raises when too few
    are visible; nothing moves it to the CPU."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"needs {n} CUDA devices"):
        make_mesh(n, 1)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_grid_covers_every_particle(data, shape):
    d, _, _ = data
    n = d["pos"].shape[0]
    mesh, sg = sharded(data, shape)
    P = shape[1]
    nl = -(-n // P)
    orig = torch.cat([g.orig_idx for g in sg.cells[0]]).numpy()
    assert sg.n == nl and sg.parts == P and orig.shape == (P * nl,)
    real = orig >= 0
    np.testing.assert_array_equal(np.sort(orig[real]), np.arange(n))
    assert (~real).sum() == P * nl - n
    mass = torch.cat([g.mass_a() for g in sg.cells[0]]).numpy()
    assert (mass[~real] == 0).all()
    np.testing.assert_array_equal(mass[real], d["mass"][orig[real]])
    pos = torch.cat([g.pos_a() for g in sg.cells[0]]).numpy()
    np.testing.assert_array_equal(pos[real], d["pos"][orig[real]])
    # one build per distinct device: every row of the mesh shares shard p
    for row in sg.cells:
        assert all(a is b for a, b in zip(row, sg.cells[0]))
    # the padding rows lie past every cell
    for g in sg.cells[0]:
        assert int(g.starts[0][-1]) == int((g.orig_idx >= 0).sum())


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
def test_sharded_grid_parameters_match_so_tpu(data, so_tpu_sharded, uniform):
    """m, chunk and uniform_mass as so_tpu picks them (m given, as
    tests/test_sharding.py gives it, and by so_tpu's rule when not)."""
    d, _, _ = data
    jmesh, jgrid, _ = so_tpu_sharded
    if uniform:
        d = dict(d, mass=np.full_like(d["mass"], d["mass"][0]))
        jgrid = jax_parallel.build_sharded_grid(d["pos"], d["mass"], m=3,
                                                mesh=jmesh)
    _, sg = sharded((d, None, None), (2, 4))
    assert (sg.m, sg.chunk, sg.uniform_mass) == (jgrid.m, jgrid.chunk,
                                                 jgrid.uniform_mass)
    assert (sg.uniform_mass is None) != uniform
    _, auto = sharded((d, None, None), (1, 8), m=None)
    n8 = d["pos"].shape[0] // 8
    assert auto.m == min(jax_choose_m(n8), 9)
    assert auto.chunk == jax_choose_chunk(n8, auto.m)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_solve_bit_identical(data, single, shape):
    _, centers, rgtp = data
    mesh, sg = sharded(data, shape)
    got = solve_rvir_sharded(mesh, sg, centers, rgtp, THR)
    assert_same(got, single[1], SOLVE_FIELDS)


def test_sharded_solve_matches_so_tpu(data, so_tpu_sharded):
    _, centers, rgtp = data
    want = so_tpu_sharded[2]
    mesh, sg = sharded(data, (2, 4))
    got = solve_rvir_sharded(mesh, sg, centers, rgtp, THR)
    np.testing.assert_array_equal(got.code, want.code)
    np.testing.assert_array_equal(got.j, want.j)
    for f in ("mvir", "rvir", "d2cut"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=2e-6, err_msg=f)


@pytest.mark.parametrize("shape,survey", [((2, 4), False), ((2, 4), True),
                                          ((1, 8), True)],
                         ids=["2x4", "2x4-survey", "1x8-survey"])
def test_sharded_multi_bit_identical(data, single, shape, survey):
    """The multi-threshold solve (and with survey=True its classify
    pre-pass, which must resolve a halo: -2 at every threshold) equals the
    single-device one. Each threshold's balls lie inside Delta = 178's."""
    _, centers, rgtp = data
    thresholds = [THR, 500.0, 2000.0]
    want = multi.solve_rvir_multi(single[0], centers, rgtp, thresholds,
                                  survey=survey)
    mesh, sg = sharded(data, shape)
    got = solve_rvir_multi_sharded(mesh, sg, centers, rgtp, thresholds,
                                   survey=survey)
    assert_same(got, want, SOLVE_FIELDS + ("n_survey",))
    assert got.n_survey > 0 or not survey


def _fused(grid, data, solved, species):
    d, centers, _ = data
    ok = solved.code == 0
    return members_and_derived(grid, centers[ok], solved.rvir[ok],
                               solved.d2cut[ok], solved.j[ok],
                               solved.mvir[ok],
                               host_mv=(d["vel"], d["mass"]),
                               species=species)


@pytest.fixture(scope="module")
def so_tpu_members(data, so_tpu_sharded):
    """so_tpu's sharded member lists for its own solve."""
    d, centers, _ = data
    mesh, sgrid, solved = so_tpu_sharded
    ok = solved.code == 0
    return jax_extract_members_sharded(
        mesh, sgrid, centers[ok], solved.d2cut[ok], solved.j[ok],
        solved.mvir[ok], host_mv=(d["vel"], d["mass"]))[0]


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_sharded_fused_members_derived(data, single, so_tpu_members, shape):
    """The fused members+derived pass: member lists, vcm and every derived
    field equal the single-device pass; the members equal so_tpu's sharded
    members."""
    species = (DARK, MARK)
    want = _fused(single[0], data, single[1], species)
    _, sg = sharded(data, shape)
    got = _fused(sg, data, single[1], species)
    assert len(got[0]) == len(want[0]) == len(so_tpu_members)
    for a, b, c in zip(got[0], want[0], so_tpu_members):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[1], want[1])
    assert_same(got[2], want[2], ("vcirc", "rmass", "rmax", "vmax"))
    for sp in species:
        np.testing.assert_array_equal(got[2].profiles[sp],
                                      want[2].profiles[sp])


@pytest.fixture(scope="module")
def cellgrid_members(data, single):
    """The port's extract_members on the single-device CellGrid."""
    _, centers, _ = data
    grid, solved = single
    ok = solved.code == 0
    return extract_members(grid, centers[ok], solved.d2cut[ok],
                           solved.j[ok], solved.mvir[ok])


@pytest.mark.parametrize("shape", [(1, 2), (2, 4), (4, 2)],
                         ids=["1x2", "2x4", "4x2"])
def test_sharded_extract_members(data, single, so_tpu_members,
                                 cellgrid_members, shape):
    """extract_members_sharded, and extract_members on a ShardedGrid
    without host_mv (rebuilt from the shards by host_mv_from_sharded):
    every list equals the CellGrid run's and so_tpu's sharded members,
    vcm bit for bit the CellGrid run's; host_mv_from_sharded gives back
    the file-order (vel, mass)."""
    d, centers, _ = data
    _, solved = single
    ok = solved.code == 0
    args = (centers[ok], solved.d2cut[ok], solved.j[ok], solved.mvir[ok])
    mesh, sg = sharded(data, shape)
    vel, mass = host_mv_from_sharded(sg)
    assert vel.tobytes() == d["vel"].astype(np.float32).tobytes()
    assert mass.tobytes() == d["mass"].astype(np.float32).tobytes()
    want, want_vcm = cellgrid_members
    assert len(want) == len(so_tpu_members) == int(ok.sum()) >= 5
    runs = [extract_members_sharded(mesh, sg, *args),
            extract_members(sg, *args)]
    if shape == (1, 2):
        runs.append(extract_members_sharded(mesh, sg, *args,
                                            cap_hint=solved.kcap[ok]))
    for got, got_vcm in runs:
        assert len(got) == len(want)
        for a, b, c in zip(got, want, so_tpu_members):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        assert got_vcm.tobytes() == want_vcm.tobytes()
    with pytest.raises(ValueError, match="another mesh"):
        extract_members_sharded(cpu_mesh(1, 2), sharded(data, (2, 1))[1],
                                *args)


def test_rank_grid_members_need_host_mv(data, single):
    """One rank's part of a --distributed grid holds only its own rows:
    extract_members without host_mv refuses it and names host_mv."""
    import dataclasses

    _, centers, _ = data
    _, solved = single
    ok = solved.code == 0
    _, sg = sharded(data, (1, 2))
    rank = dataclasses.replace(sg, comm=object())
    with pytest.raises(ValueError, match="host_mv"):
        extract_members(rank, centers[ok], solved.d2cut[ok], solved.j[ok],
                        solved.mvir[ok])


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)], ids=["1x2", "2x4"])
def test_sharded_recenter_bit_identical(data, single, shape):
    """-pot: each shard's payload takes phi in its mass row, the argmin
    runs over the merged rows; the centers equal the single-device ones."""
    d, centers, rgtp = data
    phi_in = [d["phi"][d2_forms(d["pos"], c, (1.0, 1.0, 1.0))[0]
                       <= r * r] for c, r in zip(centers, rgtp)]
    assert all(np.unique(p).size == p.size for p in phi_in)   # no equal phi
    want = recenter_most_bound(single[0], centers, rgtp)
    mesh, sg = sharded(data, shape)
    got = recenter_most_bound_sharded(mesh, sg, centers, rgtp)
    assert got.tobytes() == want.tobytes()
    assert (got != centers).any(axis=1).all()


def _runs_equal(got, want, species):
    assert_same(got.solve, want.solve, SOLVE_FIELDS + ("vcm",))
    assert_same(got.conflicts, want.conflicts,
                ("igrp", "n_subsumed", "n_ignored", "mvir", "rvir",
                 "slurped_own"))
    assert_same(got.derived, want.derived, ("vcirc", "rmass", "rmax", "vmax"))
    for sp in species:
        np.testing.assert_array_equal(got.derived.profiles[sp],
                                      want.derived.profiles[sp])
    for a, b in zip(got.members, want.members):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert vars(got.stats) == vars(want.stats)


@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "species"])
def test_run_so_sharded_bit_identical(uniform):
    """run_so_sharded on test_torch_pipeline's box (four species with
    marks; uniform masses, then general ones): every field, member list
    and stat of the port's run_so."""
    ps, catalog = _box(uniform)
    species = (DARK, GAS, STAR, MARK)
    want = run_so(ps, catalog(), SOParams(threshold=THR, species=species,
                                          device="cpu"))
    cat = catalog()
    assert_tie_free(ps.pos, cat.pos, read_reach(want.solve, cat.rgtp))
    got = run_so_sharded(ps, catalog(), SOParams(threshold=THR,
                                                 species=species),
                         cpu_mesh(2, 2))
    assert (got.solve.code == 0).sum() >= 3
    _runs_equal(got, want, species)


def test_run_so_sharded_refuses_checkpoint(tmp_path):
    ps, catalog = _box(True)
    with pytest.raises(ValueError, match="no checkpoint"):
        run_so_sharded(ps, catalog(), SOParams(
            checkpoint=str(tmp_path / "s.npz")), cpu_mesh(1, 2))


def test_capacity_escalation(data, single, monkeypatch):
    """A first capacity of 256 slots overflows shards of the clumps' balls:
    the escalation (x4 per overflow, any shard's overflow counts) gives the
    single-device results."""
    _, centers, rgtp = data
    want = solver.solve_rvir(single[0], centers, rgtp, THR, k0_cap=256)
    assert_same(want, single[1], SOLVE_FIELDS)
    mesh, sg = sharded(data, (2, 4))
    seen = []
    real = sg.slab_gather

    def spy(level, centers, radii, r2, K, S, channels):
        out = real(level, centers, radii, r2, K, S, channels)
        seen.append((K, bool(out.overflow.any())))
        return out

    monkeypatch.setattr(sg, "slab_gather", spy)
    got = solve_rvir_sharded(mesh, sg, centers, rgtp, THR, k0_cap=256)
    assert_same(got, want, SOLVE_FIELDS)
    assert (256, True) in seen and max(k for k, _ in seen) > 256


def test_piece_route(data, single, monkeypatch):
    """With PIECE_K_MIN lowered, the shards' dispatches above it go through
    K3 (its plain version here) and a row sort before the merge."""
    _, centers, rgtp = data
    monkeypatch.setattr(gather, "PIECE_K_MIN", 1024)
    calls = []
    real = gather.piece_gather_rows

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(gather, "piece_gather_rows", spy)
    want = solver.solve_rvir(single[0], centers, rgtp, THR)
    n_single = len(calls)
    mesh, sg = sharded(data, (1, 2))
    got = solve_rvir_sharded(mesh, sg, centers, rgtp, THR)
    assert_same(got, want, SOLVE_FIELDS)
    assert_same(got, single[1], SOLVE_FIELDS)
    assert n_single > 0 and len(calls) > n_single


def test_merged_width_and_slot_budget(data, single, monkeypatch):
    """A merged row holds P * K slots (each shard gathers at K), a ball's
    footprint is its largest shard's, and the dispatch slot budget counts
    the merged slots."""
    d, centers, rgtp = data
    mesh, sg = sharded(data, (2, 4))
    c = torch.as_tensor(centers)
    r = torch.as_tensor(rgtp)
    level, S = solver._pick_level_span(sg, float(rgtp.max()))
    K = 2048
    g = gather.slab_gather(sg, level, c, r, r * r, K, S, ("mass", "idx"))
    assert g.d2.shape == (8, 4 * K) and g.channels[1].shape == (8, 4 * K)
    d2, ch, idx, ovf = gather.unsorted_gather(sg, level, c, r, r * r, K, S,
                                              ("mass",), True)
    assert d2.shape == idx.shape == (8, 4 * K) and ch.shape == (8, 1, 4 * K)
    assert torch.equal(torch.isfinite(d2).sum(1), g.n_in)
    foot = gather.footprint(sg, level, c, r, S)
    shard_feet = torch.stack([gather.cell_ranges(
        s, level, c, r, r * r, S, align=s.chunk)[3] for s in sg.cells[0]])
    assert torch.equal(foot, shard_feet.amax(0))
    # the merged row's source rows map to the particles it holds
    rows = g.channels[1][g.channels[1] >= 0].long()
    assert (torch.cat([g.orig_idx for g in sg.cells[0]])[rows] >= 0).all()

    budget = 1 << 14         # 4 halos of 4 * 1024 merged slots, not 16
    monkeypatch.setattr(multi, "SOLVE_SLOT_BUDGET", budget)
    monkeypatch.setattr(solver, "SOLVE_SLOT_BUDGET", budget)
    shapes = []
    real = multi._multi_stage

    def spy(grid, level, K, S, nm, centers, radii, thr):
        shapes.append((grid.parts, centers.shape[0], K))
        return real(grid, level, K, S, nm, centers, radii, thr)

    monkeypatch.setattr(multi, "_multi_stage", spy)
    got = solve_rvir_sharded(mesh, sg, centers, rgtp, THR, k0_cap=1024)
    assert_same(got, single[1], SOLVE_FIELDS)
    assert shapes and all(p == 4 for p, _, _ in shapes)
    assert all(b * p * k <= budget or b == 1 for p, b, k in shapes)
    assert (4, 4, 1024) in shapes


def _cli_scenario(tmp_path):
    """tests/test_sharding.py's CLI scenario (seed 29, two clumps)."""
    rng = np.random.default_rng(29)
    clumps = [dict(center=(0.1, 0.0, -0.1), n=900, rmax=0.05,
                   mass_total=0.18),
              dict(center=(-0.25, 0.3, 0.2), n=700, rmax=0.04,
                   mass_total=0.09)]
    d = make_clumpy_box(rng, n_background=1500, clumps=clumps)
    w = str(tmp_path)
    write_snapshot(f"{w}/snap.bin", d)
    write_gtp(f"{w}/cat.gtp", [c["center"] for c in clumps],
              [0.045, 0.04], [0.18, 0.09])
    return w, ["-i", f"{w}/cat.gtp", "--tipsy", f"{w}/snap.bin", "-grp",
               "-gtp", "-subsumed", "-ignored"]


def _body(path):
    """A file's bytes but for the header's run-time line."""
    return [ln for ln in open(path, "rb").read().splitlines()
            if not ln.startswith(b"# Run on")]


EXTS = ("sovcirc", "sogrp", "sosub", "soign", "sogtp")


@pytest.mark.parametrize("mesh", ["2x4", "1x1"])
def test_cli_mesh_matches_plain(tmp_path, mesh):
    w, base = _cli_scenario(tmp_path)
    base += ["--device", "cpu"]
    assert main(base + ["-o", f"{w}/plain"]) == 0
    assert main(base + ["-o", f"{w}/mesh", "--mesh", mesh]) == 0
    for ext in EXTS:
        assert _body(f"{w}/plain.{ext}") == _body(f"{w}/mesh.{ext}"), ext


def test_cli_mesh_deltas_matches_plain(tmp_path):
    w, base = _cli_scenario(tmp_path)
    base += ["--device", "cpu", "--deltas", "178,500"]
    assert main(base + ["-o", f"{w}/plain"]) == 0
    assert main(base + ["-o", f"{w}/mesh", "--mesh", "2x4"]) == 0
    for dl in ("178", "500"):
        for ext in EXTS:
            assert _body(f"{w}/plain.d{dl}.{ext}") == \
                _body(f"{w}/mesh.d{dl}.{ext}"), (dl, ext)


@pytest.mark.parametrize("extra,message", [
    (["--mesh", "2x2", "--checkpoint", "s.npz"],
     "--mesh with --checkpoint is not supported yet"),
    (["--mesh", "2"], "--mesh expects HxP, e.g. --mesh 2x4"),
    (["--mesh", "0x2"], "--mesh expects HxP, e.g. --mesh 2x4"),
], ids=["checkpoint", "one-axis", "zero"])
def test_cli_mesh_refusals(tmp_path, capsys, extra, message):
    w, base = _cli_scenario(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(base + ["-o", f"{w}/got", "--device", "cpu"] + extra)
    assert e.value.code == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == message
    assert not os.path.exists(f"{w}/got.sovcirc")


def test_cli_mesh_needs_cuda_devices(tmp_path, capsys):
    """--mesh HxP on cuda asks for H * P cards and exits 1 when fewer are
    visible (none here; one on a one-card machine)."""
    w, base = _cli_scenario(tmp_path)
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit) as e:
        main(base + ["-o", f"{w}/got", "--device", "cuda", "--mesh",
                     f"{n}x1"])
    assert e.value.code == 1
    assert capsys.readouterr().err.strip().splitlines()[-1] == (
        f"--mesh {n}x1: a {n}x1 mesh needs {n} CUDA devices, found {n - 1}")
    assert not os.path.exists(f"{w}/got.sovcirc")
