"""so_tpu_torch -pot recentring against so_tpu's recenter_most_bound on the
CPU (so_tpu's slab kernel in interpret mode) and a numpy oracle.

The box is tests/test_pallas.py's recenter box: distinct phi, so the
most-bound particle is unique and both packages must pick it, bit for bit.
"""

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_solver import d2_forms  # noqa: E402

from so_tpu.engine.recenter import recenter_most_bound as jax_recenter  # noqa: E402
from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu_torch.engine.recenter import recenter_most_bound  # noqa: E402
from so_tpu_torch.ops import slab_gather  # noqa: E402
from so_tpu_torch.ops.grid import build_grid  # noqa: E402


def _box():
    rng = np.random.default_rng(11)
    N = 900
    pos = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    pos[:300] = pos[:300] * 0.08 + np.array([0.1, 0.1, 0.1], np.float32)
    mass = rng.uniform(0.5, 1.5, N).astype(np.float32)
    phi = rng.uniform(-3.0, -0.1, N).astype(np.float32)  # distinct: no ties
    assert np.unique(phi).size == N
    centers = np.array([[0.1, 0.1, 0.1], [0.12, 0.09, 0.1],
                        [-0.4, -0.4, -0.4],    # empty ball
                        [0.3, -0.2, 0.0]], np.float32)
    rgtp = np.array([0.05, 0.04, 0.01, 0.2], np.float32)
    return pos, mass, phi, centers, rgtp


def _oracle(pos, phi, centers, rgtp):
    """The first minimum-phi particle within Rgtp (per-op d2), or the
    center itself for an empty ball."""
    out = centers.copy()
    for h, (c, r) in enumerate(zip(centers, rgtp)):
        inside = np.nonzero(d2_forms(pos, c, (1.0, 1.0, 1.0))[0] <= r * r)[0]
        if inside.size:
            out[h] = pos[inside[np.argmin(phi[inside])]]
    return out


@pytest.mark.parametrize("k0_cap", [4096, 256], ids=["one_round",
                                                     "escalates"])
def test_recenter_matches_so_tpu(k0_cap):
    pos, mass, phi, centers, rgtp = _box()
    want = jax_recenter(jax_build_grid(pos, mass, phi=phi, m=2, pallas=True),
                        centers, rgtp)
    grid = build_grid(pos, mass, phi=phi, m=2, device="cpu")
    np.testing.assert_array_equal(grid.phi.numpy(),
                                  phi[grid.orig_idx.numpy()])
    got = recenter_most_bound(grid, centers, rgtp, k0_cap=k0_cap)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(got, _oracle(pos, phi, centers, rgtp))
    # the empty ball keeps its center; the others moved onto a particle
    np.testing.assert_array_equal(got[2], centers[2])
    assert not (got[[0, 1, 3]] == centers[[0, 1, 3]]).all(axis=1).any()


def test_recenter_escalation_regathers(monkeypatch):
    """A first capacity below the big ball's footprint overflows, and the
    halo is regathered at x4 until it fits; the plain version of K1 runs
    (CPU tensors) in every round."""
    pos, mass, phi, centers, rgtp = _box()
    grid = build_grid(pos, mass, phi=phi, m=2, device="cpu")
    calls = []
    real = slab_gather.slab_gather_plain
    monkeypatch.setattr(slab_gather, "slab_gather_plain",
                        lambda *a, **k: calls.append(a[8]) or real(*a, **k))
    got = recenter_most_bound(grid, centers, rgtp, k0_cap=64)
    assert calls[0] == 64 and max(calls) >= 256
    np.testing.assert_array_equal(got, _oracle(pos, phi, centers, rgtp))


def test_recenter_needs_phi():
    pos, mass, _, centers, rgtp = _box()
    grid = build_grid(pos, mass, m=2, device="cpu")
    assert grid.phi is None
    with pytest.raises(ValueError, match="potentials"):
        recenter_most_bound(grid, centers, rgtp)
