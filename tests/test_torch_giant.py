"""The giant.general cell's box at a small size on the CPU: the
benchmark's zoom generator (sobench/gen/giant.py) with the configuration's
shape (a third of the particles in one host with four centers, field
clumps, a background), through run_so at general masses with the DARK
profile, held on every halo to the benchmark's plain reference
(sobench/reference/so_reference.py) by its own comparisons
(sobench/check.check_whole_job) at the cell's limits; and the counters
that the cell's metrics read (K2.*, fused.member_rows, solve.giant_*).
gather.PIECE_K_MIN is lowered so that K3's plain twin serves the host's
tiers and K2 runs over long rows, as on the card."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from sobench import check as ck  # noqa: E402
from sobench import harness  # noqa: E402
from so_tpu_torch import profiling  # noqa: E402
from so_tpu_torch.engine import solver  # noqa: E402
from so_tpu_torch.ops import gather, seqsum  # noqa: E402

N_PARTICLES, N_HOST, N_FIELD, N_FIELD_HALOS = 200_000, 66_667, 32_000, 60
SEED = 2 ** 31 + 2222
PIECE_K_MIN = 1 << 12
GIANT_K = 1 << 16          # below the small host's capacities


def small_config() -> dict:
    config = json.loads((REPO / "sobench/configs/giant.json").read_text())
    config.update(n_particles=N_PARTICLES, n_host=N_HOST, n_field=N_FIELD,
                  n_field_halos=N_FIELD_HALOS)
    return config


def gen():
    return harness.load_module(REPO / "sobench/gen/giant.py")


def _added(base: dict) -> dict:
    return {k[0]: v - base.get(k, 0) for k, v in profiling.counts.items()
            if v != base.get(k, 0)}


@pytest.fixture(scope="module")
def job():
    """One job of the general mix on the small zoom box, with device counts
    on and the giant threshold lowered: (snapshot, run, mix, config, the
    counts the job added)."""
    config = small_config()
    mix = json.loads((REPO / "sobench/traffic/general.json").read_text())
    snap = gen().snapshot(config, mix, SEED, "cpu")
    cell = harness.Cell("small.general", 1, config, mix, {}, [], [], REPO)
    mp = pytest.MonkeyPatch()
    mp.setattr(gather, "PIECE_K_MIN", PIECE_K_MIN)
    mp.setattr(solver, "GIANT_K", GIANT_K)
    base = dict(profiling.counts)
    profiling.start_recording(device_counts=True)
    try:
        runs = harness.run_job(harness.Inputs(snap), cell, "cpu")
    finally:
        profiling.stop_recording()
        mp.undo()
    return snap, runs[0], mix, config, _added(base)


def test_the_box_has_the_configurations_shape(job):
    snap, _, _, config, _ = job
    assert snap.n == N_PARTICLES
    assert snap.n_halos == 4 + N_FIELD_HALOS
    assert snap.split == (0, N_PARTICLES, 0)
    # the four host centers at chip_smoke.giant_config's offsets
    off = np.asarray(config["host_offsets"], np.float32)
    d = (snap.centers[:4] - snap.centers[0] - off + 0.5) % 1.0 - 0.5
    assert np.abs(d).max() < 1e-6
    assert np.all(snap.rgtp[:4] == np.float32(0.02))
    assert snap.rgtp[4:].max() <= np.float32(config["field_rgtp_max"])
    assert int(np.argmax(snap.rgtp)) == 0
    # about a third of the particles within host_rmax of the host center
    r = np.linalg.norm((snap.pos - snap.centers[0] + 0.5) % 1.0 - 0.5,
                       axis=1)
    assert N_HOST <= np.count_nonzero(r <= 0.08) < N_HOST * 1.02
    # the catalog masses follow the clump counts: the hosts' largest
    assert snap.gtp_mass[:4].min() > 10 * snap.gtp_mass[4:].max()


def test_same_seed_same_box_other_seed_other(job):
    snap, _, mix, config, _ = job
    again = gen().snapshot(config, mix, SEED, "cpu")
    other = gen().snapshot(config, mix, SEED + 1, "cpu")
    for f in ("pos", "vel", "mass", "centers", "rgtp", "gtp_mass"):
        assert np.array_equal(getattr(snap, f), getattr(again, f)), f
    assert not np.array_equal(snap.pos, other.pos)
    assert not np.array_equal(snap.centers[:4], other.centers[:4])
    assert other.n == snap.n and np.array_equal(other.rgtp, snap.rgtp)


def test_the_host_is_solved_and_subsumes_what_lies_in_it(job):
    snap, run, _, _, added = job
    s = run.solve
    assert np.all(s.code[:4] == 0)
    # R_178 of the r^-2 clump, about 0.075 (assumed in giant.json)
    assert np.all((s.rvir[:4] > 0.06) & (s.rvir[:4] < 0.09))
    assert s.j[:4].min() > N_HOST // 2
    # the host's tiers went through K3 and the in-ball row sort
    assert added["K3.bytes"] > 0 and added["sort.keys"] > s.j[:4].sum()
    # the walk takes the host centers last: each subsumes the one before,
    # and every field group centered inside the host is subsumed
    d = np.linalg.norm((snap.centers - snap.centers[0] + 0.5) % 1.0 - 0.5,
                       axis=1)
    inside = np.nonzero((d < 0.9 * s.rvir[0]) & (s.code == 0))[0]
    inside = inside[inside >= 4]
    assert inside.size > 0
    c = run.conflicts
    assert np.all(c.rvir[inside] < 0)
    assert c.groups_removed >= 3 + inside.size


def test_every_halo_equals_the_reference(job):
    snap, run, mix, config, _ = job
    limits = json.loads((REPO / "sobench/limits/giant.general.json")
                        .read_text())["limits"]
    ps = ck.reference_particles(snap, config["period"], "cpu")
    got = ck.check_whole_job([run], snap, [float(mix["thresholds"][0])], ps,
                             harness.species_of(mix), int(mix["n_members"]))
    assert got["solve_diff"] == got["member_diff"] == 0, got
    assert got["vcm_diff"] == got["conflict_diff"] == 0, got
    ok, table = ck.verdict(got, limits)
    assert ok, table


def test_the_cells_counters_count(job):
    _, run, _, _, added = job
    assert added["K2.calls"] > 0
    assert added["K2.chain_adds"] >= run.solve.j[:4].max()
    assert added["K2.bytes"] > 4 * added["K2.chain_adds"]
    fetched = sum(m.size for m in run.members if m is not None)
    assert added["fused.member_rows"] == fetched
    assert added["solve.giant_dispatches"] > 0
    assert added["solve.giant_slots"] >= GIANT_K * added[
        "solve.giant_dispatches"]


@pytest.mark.parametrize("n_valid", [None, [0, 5, 300, 7]],
                         ids=["no_counts", "counts"])
def test_k2_counts(n_valid):
    """K2.calls always; the chain and the bytes only under device counts,
    as k2_roofline's docstring reckons the bytes."""
    x = torch.rand((4, 256), dtype=torch.float32)
    nv = None if n_valid is None else torch.as_tensor(n_valid)
    base = dict(profiling.counts)
    seqsum.seq_cumsum(x, n_valid=nv)
    assert _added(base) == {"K2.calls": 1}
    profiling.start_recording(device_counts=True)
    seqsum.seq_cumsum(x, n_valid=nv)
    seqsum.seq_cumsum(x.T, axis=0, n_valid=nv)
    profiling.stop_recording()
    added = _added(base)
    read = 4 * 256 if nv is None else sum(min(v, 256) for v in n_valid)
    chain = 256 if nv is None else min(max(n_valid), 256)
    assert added["K2.calls"] == 3
    assert added["K2.chain_adds"] == 2 * chain
    assert added["K2.bytes"] == 2 * (4 * read + 4 * 4 * 256
                                    + (0 if nv is None else 8 * 4))


def test_giant_counts_only_at_giant_capacities():
    base = dict(profiling.counts)
    solver.count_dispatch(np.arange(3), solver.GIANT_K // 2)
    assert _added(base) == {"solve.dispatches": 1, "solve.halo_gathers": 3}
    solver.count_dispatch(np.arange(2), solver.GIANT_K)
    assert _added(base) == {"solve.dispatches": 2, "solve.halo_gathers": 5,
                            "solve.giant_dispatches": 1,
                            "solve.giant_slots": 2 * solver.GIANT_K}
