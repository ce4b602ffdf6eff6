"""so_tpu_torch.ops.grid against so_tpu.ops.grid on the CPU.

The same particles, made from a seed with numpy, go through both builds;
the Morton permutation, every level's CSR starts, the slab payload, the
chunk and the uniform-mass value must agree exactly (payload bit for bit).
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu.ops.grid import morton_encode as jax_morton  # noqa: E402
from so_tpu_torch.ops.grid import (build_grid, choose_chunk,  # noqa: E402
                                   grid_from_arrays, morton_encode)


def jax_grid_arrays(g):
    """so_tpu's CellGrid fields as host arrays (grid_from_arrays order)."""
    return dict(m=g.m, lo=np.asarray(g.lo), period=np.asarray(g.period),
                soa8t=np.asarray(g.soa8t), orig_idx=np.asarray(g.orig_idx),
                starts=[np.asarray(s) for s in g.starts], chunk=g.chunk,
                uniform_mass=g.uniform_mass)


def assert_grids_equal(port, ref: dict):
    assert port.m == ref["m"]
    assert port.chunk == ref["chunk"]
    assert port.uniform_mass == ref["uniform_mass"]
    np.testing.assert_array_equal(port.lo.numpy(), ref["lo"])
    np.testing.assert_array_equal(port.period.numpy(), ref["period"])
    np.testing.assert_array_equal(port.orig_idx.numpy(), ref["orig_idx"])
    assert len(port.starts) == len(ref["starts"])
    for got, want in zip(port.starts, ref["starts"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.soa8t.numpy().view(np.int32),
                                  ref["soa8t"].view(np.int32))


def _particles(seed, n, box, center, uniform):
    rng = np.random.default_rng(seed)
    c = np.asarray(center, np.float32)
    pos = (c + rng.uniform(-box / 2, box / 2, (n, 3))).astype(np.float32)
    # a clump across the box edge and particles exactly on cell faces
    k = n // 4
    pos[:k] = (c + box / 2 + rng.normal(scale=0.03 * box, size=(k, 3))
               ).astype(np.float32)
    pos[k:k + 8] = (c - box / 2 + box / 8 * np.arange(8)[:, None]
                    ).astype(np.float32)
    mass = (np.full(n, np.float32(1.0 / n)) if uniform
            else rng.uniform(0.5, 1.5, n).astype(np.float32) / n)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], n).astype(np.int32)
    mark = rng.uniform(size=n) < 0.25
    return pos, mass, vel, ptype, mark


@pytest.mark.parametrize("uniform", [False, True], ids=["general", "uniform"])
@pytest.mark.parametrize("box,center", [(1.0, 0.0), (2.0, 1.0)],
                         ids=["default", "p2c1"])
def test_grid_matches_so_tpu(box, center, uniform):
    pos, mass, vel, ptype, mark = _particles(17, 4000, box, center, uniform)
    kw = dict(vel=vel, ptype=ptype, mark=mark, period=(box,) * 3,
              center=(center,) * 3)
    ref = jax_grid_arrays(jax_build_grid(pos, mass, pallas=True, **kw))
    port = build_grid(pos, mass, device="cpu", **kw)
    assert_grids_equal(port, ref)
    assert (port.uniform_mass is not None) == uniform
    # the accessors serve the inputs back in sorted order, bit for bit
    perm = port.orig_idx.numpy()
    np.testing.assert_array_equal(port.pos_a().numpy(), pos[perm])
    np.testing.assert_array_equal(port.vel_a().numpy(), vel[perm])
    np.testing.assert_array_equal(port.ptype_a().numpy(), ptype[perm])
    np.testing.assert_array_equal(port.mark_a().numpy(), mark[perm])
    # state carried across: so_tpu's grid loaded into the port is the same
    # grid as the port's own build
    assert_grids_equal(grid_from_arrays(**ref, device="cpu"), ref)


def test_morton_and_chunk_rules():
    rng = np.random.default_rng(2)
    ijk = rng.integers(0, 1024, (3, 5000)).astype(np.int32)
    want = np.asarray(jax_morton(*ijk))
    got = morton_encode(*(torch.as_tensor(a) for a in ijk)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    from so_tpu.ops.grid import choose_chunk as jax_choose_chunk
    for n in (1000, 20000, 40000, 2 ** 21, 2 ** 23):
        for m in range(0, 10):
            assert choose_chunk(n, m) == jax_choose_chunk(n, m), (n, m)
