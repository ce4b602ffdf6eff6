"""so_tpu_torch.ops.gather and K1's plain version against so_tpu on the CPU.

Both packages read the identical grid (so_tpu's build, carried into the
port by grid_from_arrays). so_tpu's slab gather runs its Pallas kernel in
interpret mode, as tests/test_pallas.py does; ragged_ball_gather (XLA) is
the second oracle.
"""

import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

from so_tpu.ops import build_grid as jax_build_grid  # noqa: E402
from so_tpu.ops import gather as jg  # noqa: E402
from so_tpu_torch.ops import gather as tg  # noqa: E402
from so_tpu_torch.ops.grid import grid_from_arrays  # noqa: E402
from test_torch_grid import jax_grid_arrays  # noqa: E402
from test_torch_solver import fma32  # noqa: E402


@pytest.fixture(scope="module", params=[600, 3000], ids=["chunk256", "chunk128"])
def grids(request):
    """(so_tpu grid, port grid, rng). m=2 at 600 particles keeps the
    256-chunk of test_pallas.py; 3000 particles at m=3 pick chunk 128."""
    n = request.param
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    pos[: n // 3] = ((rng.normal(scale=0.05, size=(n // 3, 3)) + 0.5) % 1.0
                     - 0.5).astype(np.float32)
    mass = rng.uniform(0.5, 1.5, n).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ptype = rng.choice([1, 2, 4], n).astype(np.int32)
    mark = rng.uniform(size=n) < 0.3
    jgrid = jax_build_grid(pos, mass, vel=vel, ptype=ptype, mark=mark,
                           m=2 if n == 600 else 3, pallas=True)
    pgrid = grid_from_arrays(**jax_grid_arrays(jgrid), device="cpu")
    assert pgrid.chunk == (256 if n == 600 else 128)
    return jgrid, pgrid, rng


def _balls(rng, B):
    centers = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    centers[0] = 0.0                 # on the clump
    centers[1] = (0.49, -0.5, 0.5)   # across the periodic faces
    radii = rng.uniform(0.05, 0.3, B).astype(np.float32)
    return centers, radii


def test_min_image_bits():
    rng = np.random.default_rng(8)
    c = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32)
    p = rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32)
    period = np.asarray([1.0, 2.0, 0.75], np.float32)
    # exact half-period offsets exercise round-half-to-even
    c[:8] = p[:8] + period * np.float32(0.5)
    want = np.asarray(jg.min_image(jnp.asarray(c), jnp.asarray(p),
                                   jnp.asarray(period)))
    got = tg.min_image(torch.as_tensor(c), torch.as_tensor(p),
                       torch.as_tensor(period)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("align", ["one", "chunk"])
def test_cell_ranges_exact(grids, align):
    jgrid, pgrid, rng = grids
    a = 1 if align == "one" else pgrid.chunk
    centers, radii = _balls(rng, 16)
    for level, S in ((1, 3), (0, 4)):
        want = jg.cell_ranges(jgrid, level, jnp.asarray(centers),
                              jnp.asarray(radii), jnp.asarray(radii * radii),
                              S, align=a)
        got = tg.cell_ranges(pgrid, level, torch.as_tensor(centers),
                             torch.as_tensor(radii),
                             torch.as_tensor(radii * radii), S, align=a)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("channels", [("mass",), ("mass", "meta"),
                                      ("mass", "mv", "meta", "idx")],
                         ids=["nch1", "nch2", "full"])
def test_slab_gather_plain_matches_so_tpu(grids, channels):
    jgrid, pgrid, rng = grids
    B, K, S, level = 4, 8192, 5, 1
    centers, radii = _balls(rng, B)
    jc, jr = jnp.asarray(centers), jnp.asarray(radii)
    ref = jg.ragged_ball_gather(jgrid, level, jc, jr, jr * jr, 4096, S)
    slab = jg.slab_gather(jgrid, level, jc, jr, jr * jr, K, S,
                          channels=channels)
    tc, tr = torch.as_tensor(centers), torch.as_tensor(radii)
    got = tg.slab_gather(pgrid, level, tc, tr, tr * tr, K, S,
                         channels=channels)
    assert not got.overflow.any()
    np.testing.assert_array_equal(got.n_in.numpy(), np.asarray(ref.n_in))
    np.testing.assert_array_equal(got.n_in.numpy(), np.asarray(slab.n_in))
    mass_np = pgrid.mass_a().numpy()
    mv_np = pgrid.vel_a().numpy() * mass_np[:, None]
    meta_np = (pgrid.ptype_a().numpy()
               | (pgrid.mark_a().numpy().astype(np.int32) << 4))
    ch = dict(zip(channels, got.channels))
    sch = dict(zip(channels, slab.channels))
    for b in range(B):
        n = int(ref.n_in[b])
        d2 = got.d2[b, :n].numpy()
        # The d2 bits are NOT all exact against so_tpu on this CPU: XLA:CPU
        # contracts dx*dx + dy*dy + dz*dz into fma(dz, dz, fma(dx, dx,
        # dy*dy)), while the port (like the reference's C loop and the CUDA
        # kernel, built with -fmad=false) rounds every product and sum.
        # They differ by an ulp or two; test_pallas.py's rtol=1e-6 is the
        # bound, and below each side's bits are checked exactly against a
        # numpy evaluation of its own form on its own rows.
        for want in (ref.d2[b, :n], slab.d2[b, :n]):
            np.testing.assert_allclose(d2, np.asarray(want), rtol=1e-6)
        np.testing.assert_array_equal(np.isinf(got.d2[b, n:].numpy()), True)
        np.testing.assert_array_equal(ch["mass"][b, :n].numpy(),
                                      np.asarray(sch["mass"][b, :n]))
        if "idx" not in ch:
            continue
        gi = ch["idx"][b, :n].numpy()
        assert gi.dtype == np.int32
        pos = pgrid.pos_a().numpy()
        # the period is 1, so p*round((c-x)/p) is round(c-x) exactly
        dd = (centers[b] - np.round(centers[b] - pos[gi])) - pos[gi]
        x, y, z = dd[:, 0], dd[:, 1], dd[:, 2]
        np.testing.assert_array_equal(
            d2.view(np.int32), (x * x + y * y + z * z).view(np.int32))
        si = np.asarray(sch["idx"][b, :n])
        dd = (centers[b] - np.round(centers[b] - pos[si])) - pos[si]
        x, y, z = dd[:, 0], dd[:, 1], dd[:, 2]
        np.testing.assert_array_equal(
            np.asarray(slab.d2[b, :n]).view(np.int32),
            fma32(z, z, fma32(x, x, y * y)).view(np.int32))
        np.testing.assert_array_equal(np.sort(gi),
                                      np.sort(np.asarray(ref.idx[b, :n])))
        np.testing.assert_array_equal(ch["mass"][b, :n].numpy(), mass_np[gi])
        np.testing.assert_allclose(ch["mv"][b, :n].numpy(), mv_np[gi],
                                   rtol=1e-6)
        np.testing.assert_array_equal(
            ch["meta"][b, :n].numpy().astype(np.int32), meta_np[gi])


def test_slab_overflow_flag(grids):
    _, pgrid, _ = grids
    z = torch.zeros((1, 3))
    big = torch.as_tensor([0.45])
    got = tg.slab_gather(pgrid, 1, z, big, big * big, 256, 5)
    assert bool(got.overflow[0])
