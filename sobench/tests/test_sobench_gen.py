"""The device generator: the same seed gives the same snapshot, another
seed another one of the same sizes, and its statistics are so_tpu's
``bench.make_box``'s."""

import json

import numpy as np
import pytest

from conftest import REPO

from sobench import harness

N, G = 1 << 16, 512


def gen():
    return harness.load_module(REPO / "sobench/gen/make_box.py")


def config():
    cfg = json.loads((REPO / "sobench/configs/standard.json").read_text())
    return dict(cfg, n_particles=N, n_halos=G)


def mix(name):
    return json.loads((REPO / f"sobench/traffic/{name}.json").read_text())


def test_same_seed_same_snapshot_other_seed_other():
    g = gen()
    big = 2 ** 31 + 12345
    a = g.snapshot(config(), mix("species"), big, "cpu")
    b = g.snapshot(config(), mix("species"), big, "cpu")
    c = g.snapshot(config(), mix("species"), big + 1, "cpu")
    for f in ("pos", "vel", "mass", "centers", "rgtp", "gtp_mass"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert not np.array_equal(a.pos, c.pos)
    assert not np.array_equal(a.gtp_mass, c.gtp_mass)
    assert not np.array_equal(a.vel, c.vel)
    assert a.n == c.n and np.array_equal(a.rgtp, c.rgtp)
    assert a.split == (a.n // 5, a.n - a.n // 5 - a.n // 7, a.n // 7)
    assert a.pos.dtype == np.float32 and a.mass.dtype == np.float32


def bench_box():
    import sys
    sys.path.insert(0, str(REPO))
    import bench

    return bench.make_box(np.random.default_rng(12345), N, G)


def test_statistics_match_bench_make_box():
    pos0, mass0, _, centers0, rgtp0 = bench_box()
    s = gen().snapshot(config(), mix("uniform"), 99, "cpu")
    # the same clump sizes: the same particle count, radii and masses
    assert s.n == pos0.shape[0]
    assert np.array_equal(s.rgtp, rgtp0)
    assert np.array_equal(s.mass, mass0)
    assert s.centers.shape == centers0.shape
    # the uniform background: the first N - N // 2 particles
    bg = s.pos[:N - N // 2]
    assert bg.min() >= -0.5 and bg.max() <= 0.5
    assert np.abs(bg.mean(axis=0)).max() < 0.01
    assert np.allclose(bg.std(axis=0), 1 / np.sqrt(12), rtol=0.02)
    # clump radii over each clump's rmax: U(0.001, 1) in both boxes
    r1 = _radii(s.pos, s.centers)
    r0 = _radii(pos0, centers0)
    assert r1.max() <= 1.0 + 1e-5 and r0.max() <= 1.0 + 1e-5
    for q in (0.1, 0.5, 0.9):
        assert np.quantile(r1, q) == pytest.approx(np.quantile(r0, q),
                                                   abs=0.01)


def _radii(pos, centers):
    """Each clump particle's distance to its center over its clump's
    rmax."""
    counts = gen().clump_sizes(N, G, 12345)
    h = np.repeat(np.arange(G), counts)
    d = pos[N - N // 2:] - centers[h]
    d -= np.round(d)
    rmax = 0.0012 * counts.astype(np.float64) ** (1 / 3)
    return np.linalg.norm(d, axis=1) / rmax[h]


def test_velocities_and_catalog_masses_follow_the_clumps():
    s = gen().snapshot(config(), mix("uniform"), 2 ** 32 + 5, "cpu")
    sizes = gen().clump_sizes(N, G, 12345)
    h = np.repeat(np.arange(G), sizes)
    v = s.vel[N - N // 2:]
    assert s.vel.dtype == np.float32 and np.isfinite(s.vel).all()
    # the background moves at N(0, 1); a clump at its bulk velocity with
    # a dispersion of 0.3 about it
    assert np.allclose(s.vel[:N - N // 2].std(axis=0), 1.0, rtol=0.03)
    mean = np.zeros((G, 3))
    np.add.at(mean, h, v)
    mean /= sizes[:, None]
    assert np.allclose((v - mean[h]).std(axis=0), 0.3, rtol=0.03)
    assert np.allclose(mean.std(axis=0), 1.0, rtol=0.15)
    # catalog masses: the clump's mass within the jitter of 5%
    ratio = s.gtp_mass / (sizes * s.mass[0])
    assert ratio.min() >= 0.95 - 1e-6 and ratio.max() <= 1.05 + 1e-6
    assert np.corrcoef(s.gtp_mass, sizes)[0, 1] > 0.99
