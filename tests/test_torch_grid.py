"""so_tpu_torch.ops.grid against so_tpu.ops.grid on the CPU.

The same particles, made from a seed with numpy, go through both builds;
the Morton permutation, every level's CSR starts, the slab payload, the
chunk and the uniform-mass value must agree exactly (payload bit for bit
over so_tpu's N + chunk columns; the port's row stride is that rounded up
to 32 floats, its extra columns holding the pad values).
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
from so_tpu_torch.io.tipsy import ParticleSet, TipsyHeader  # noqa: E402
from so_tpu_torch.ops.grid import (build_grid, choose_chunk,  # noqa: E402
                                   detect_uniform_mass, grid_from_arrays,
                                   morton_encode, payload_width,
                                   reads_in_16_bytes, uniform_mass_on_device)
from so_tpu_torch.parallel import make_mesh  # noqa: E402
from so_tpu_torch.parallel.distributed import grid_segment  # noqa: E402
from so_tpu_torch.parallel.mesh import (build_shards,  # noqa: E402
                                        build_sharded_grid)


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
    soa, want = port.soa8t.numpy(), ref["soa8t"]
    w = want.shape[1]
    assert w == port.n + port.chunk
    assert soa.shape == (8, payload_width(w)) and soa.shape[1] % 32 == 0
    assert soa.shape[1] - w < 32 and port.soa8t.is_contiguous()
    assert reads_in_16_bytes(port.soa8t)
    # a row stride off 4 floats, or a base off 16 bytes, is refused
    assert not reads_in_16_bytes(port.soa8t[:, 1:].contiguous())
    flat = torch.empty(port.soa8t.numel() + 1)[1:]
    assert not reads_in_16_bytes(flat.view(port.soa8t.shape))
    np.testing.assert_array_equal(soa[:, :w].view(np.int32),
                                  want.view(np.int32))
    # the extra columns hold the pad values: x=y=z=1e30, the rest 0
    extra = soa[:, w:]
    assert (extra[0:3] == np.float32(1e30)).all()
    assert (extra[3:].view(np.int32) == 0).all()


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
    carried = grid_from_arrays(**ref, device="cpu")
    assert_grids_equal(carried, ref)
    assert torch.equal(carried.soa8t, port.soa8t)


@pytest.mark.parametrize("n", [4001, 4030, 4031])
def test_payload_stride_matches_so_tpu(n):
    """N + chunk not a multiple of 32: the port's payload is so_tpu's with
    pad columns up to the stride, built or carried across."""
    pos, mass, vel, ptype, mark = _particles(19, n, 1.0, 0.0, False)
    kw = dict(vel=vel, ptype=ptype, mark=mark)
    ref = jax_grid_arrays(jax_build_grid(pos, mass, pallas=True, **kw))
    port = build_grid(pos, mass, device="cpu", **kw)
    assert port.soa8t.shape[1] > n + port.chunk
    assert_grids_equal(port, ref)
    carried = grid_from_arrays(**ref, device="cpu")
    assert_grids_equal(carried, ref)
    assert torch.equal(carried.soa8t, port.soa8t)


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


def _same_grid(a, b):
    """Two port grids equal in every field, payload bit for bit."""
    assert a.m == b.m and a.chunk == b.chunk
    assert (None if a.uniform_mass is None else
            np.float32(a.uniform_mass).tobytes()) == (
        None if b.uniform_mass is None else
        np.float32(b.uniform_mass).tobytes())
    assert torch.equal(a.soa8t.view(torch.int32), b.soa8t.view(torch.int32))
    assert torch.equal(a.orig_idx, b.orig_idx)
    assert len(a.starts) == len(b.starts)
    assert all(torch.equal(x, y) for x, y in zip(a.starts, b.starts))


# (counts as fractions of n: nsph, ndark, nstar; uniform mass; mark; first
# file row; how the grid is built)
SPECIES_CASES = {
    "interleaved": ((0.2, 0.65, 0.15), False, False, 0, "grid"),
    "counts_below_n": ((0.3, 0.3, 0.1), True, False, 0, "grid"),
    "mark": ((0.2, 0.65, 0.15), False, True, 0, "grid"),
    "row_offset": ((0.4, 0.2, 0.4), False, True, 1500, "grid"),
    "two_shards": ((0.2, 0.65, 0.15), False, True, 0, "sharded"),
    "second_rank": ((0.6, 0.2, 0.2), True, True, 0, "segment"),
}


@pytest.mark.parametrize("case", list(SPECIES_CASES))
def test_species_counts_match_ptype_array(case):
    """build_grid given the header's counts forms the species column on
    the device from the sorted order, and gives the grid that the same
    build given ParticleSet.ptype's array gives, bit for bit: payload
    (padding rows included), orig_idx, starts and uniform_mass."""
    fr, uniform, with_mark, first_row, how = SPECIES_CASES[case]
    n = 4001                            # odd: the last shard is padded
    pos, mass, vel, _, mark = _particles(23, n, 1.0, 0.0, uniform)
    nsph, ndark, nstar = (int(f * (n + first_row)) for f in fr)
    ps = ParticleSet(TipsyHeader(1.0, nsph + ndark + nstar, 3, nsph, ndark,
                                 nstar), pos, vel, mass,
                     np.zeros(n, np.float32), np.zeros(n, np.float32),
                     mark if with_mark else None)
    counts = (nsph, ndark, nstar)
    kw = dict(vel=vel, mark=ps.mark)
    if how == "grid":
        ptype = ps.ptype(first_row + np.arange(n, dtype=np.int64))
        want = build_grid(pos, mass, ptype=ptype, device="cpu", **kw)
        got = build_grid(pos, mass, species_counts=counts,
                         first_row=first_row, device="cpu", **kw)
        assert set(ptype.tolist()) == {1, 2, 4}     # DARK, GAS, STAR
        assert (got.ptype_a().numpy() == ptype[got.orig_idx.numpy()]).all()
        pairs = [(got, want)]
    else:
        mesh = make_mesh(1, 2, devices=["cpu"] * 2)
        if how == "sharded":
            want = build_sharded_grid(pos, mass, ptype=ps.ptype_all(),
                                      mesh=mesh, **kw)
            got = build_sharded_grid(pos, mass, species_counts=counts,
                                     mesh=mesh, **kw)
        else:       # rank 1 of 2: its file segment, its last shard padded
            start, count = grid_segment(n, 2, 2, 1)
            seg = slice(start, start + count)
            common = dict(n_global=n, nproc=2, start=start,
                          uniform_mass=detect_uniform_mass(mass[seg]),
                          comm=None)
            args = (pos[seg], mass[seg], vel[seg], None)
            rows = start + np.arange(count, dtype=np.int64)
            want = build_shards(mesh, *args, ps.ptype(rows), ps.mark[seg],
                                (1.0,) * 3, (0.0,) * 3, None, **common)
            got = build_shards(mesh, *args, None, ps.mark[seg], (1.0,) * 3,
                               (0.0,) * 3, None, species_counts=counts,
                               **common)
        pairs = list(zip(got.cells[0], want.cells[0]))
        assert (pairs[-1][0].orig_idx < 0).any()      # padding rows
    for g, w in pairs:
        _same_grid(g, w)
    with pytest.raises(ValueError):
        build_grid(pos, mass, ptype=ps.ptype_all(), species_counts=counts,
                   device="cpu")


UNIFORM_CASES = {
    "uniform": [0.25] * 9,
    "last_differs": [0.25] * 8 + [0.2500001],
    "signed_zeros": [-0.0, 0.0, -0.0, 0.0],
    "nan": [0.5, 0.5, float("nan")],
    "single_row": [0.125],
    "empty": [],
}


@pytest.mark.parametrize("case", list(UNIFORM_CASES))
def test_uniform_mass_on_device_matches_host(case):
    """The device test of a uniform mass gives detect_uniform_mass's
    verdict and value, sign of zero included, and build_grid's grid
    carries it."""
    mass = np.asarray(UNIFORM_CASES[case], np.float32)
    want = detect_uniform_mass(mass)
    got = uniform_mass_on_device(torch.as_tensor(mass))

    def bits(v):
        return None if v is None else np.float32(v).tobytes()

    assert bits(got) == bits(want)
    assert (want is None) == (case in ("last_differs", "nan", "empty"))
    if mass.size:
        pos = np.random.default_rng(5).uniform(
            -0.5, 0.5, (mass.size, 3)).astype(np.float32)
        assert bits(build_grid(pos, mass, device="cpu").uniform_mass) == (
            bits(want))
