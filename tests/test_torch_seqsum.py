"""K2's plain version (so_tpu_torch.ops.seqsum) against so_tpu's serial
f32 scan on the CPU: bit for bit, with and without a per-row valid count
(n_valid), on rows whose bits change under any reassociation; and the
K2 callers, which pass their in-ball counts, against so_tpu's solve."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from so_tpu.ops.seqsum import seq_cumsum as jax_seq_cumsum  # noqa: E402
from so_tpu_torch.ops import seqsum  # noqa: E402


def _jax(x):
    return np.asarray(jax_seq_cumsum(jnp.asarray(x), axis=1))


def _bits_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  np.asarray(b).view(np.int32))


@pytest.mark.parametrize("shape", [(16, 4096), (3, 1), (64, 333)])
def test_seq_cumsum_matches_so_tpu(shape):
    rng = np.random.default_rng(19)
    x = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    x[:, ::7] = 0.0                        # the zero pad of invalid slots
    x[0, : shape[1] // 2] = np.float32(1e-3)   # equal masses (ladder-like)
    want = _jax(x)
    n0 = seqsum.launches
    got = seqsum.seq_cumsum(torch.as_tensor(x))
    assert seqsum.launches == n0            # a CPU tensor never launches K2
    _bits_equal(got.numpy(), want)
    # the torch column loop (the plain version off the CPU) agrees too
    _bits_equal(seqsum.column_loop(torch.as_tensor(x)).numpy(), want)


@pytest.mark.parametrize("axis", [0, 1, -1, -2])
def test_seq_cumsum_axis_matches_so_tpu(axis):
    """seq_cumsum(x, axis) is so_tpu's seq_cumsum(x, axis) bit for bit,
    down the columns as along the rows; n_valid then counts per column."""
    rng = np.random.default_rng(23)
    x = rng.uniform(0.0, 2.0, (333, 48)).astype(np.float32)
    x[::5] = np.float32(1e-3)
    want = np.asarray(jax_seq_cumsum(jnp.asarray(x), axis=axis))
    _bits_equal(seqsum.seq_cumsum(torch.as_tensor(x), axis).numpy(), want)
    if axis % 2 == 0:
        nv = rng.integers(0, x.shape[0] + 1, x.shape[1])
        xm = np.where(np.arange(x.shape[0])[:, None] < nv[None, :], x,
                      np.float32(0.0))
        got = seqsum.seq_cumsum(torch.as_tensor(x), axis,
                                n_valid=torch.as_tensor(nv))
        _bits_equal(got.numpy(),
                    np.asarray(jax_seq_cumsum(jnp.asarray(xm), axis=0)))


@pytest.mark.parametrize("nv", ["zero", "K", "random", "past_K"])
def test_n_valid_is_the_cumsum_of_the_masked_rows(nv):
    """seq_cumsum(x, n_valid) = so_tpu's scan of where(slot < n_valid, x,
    +0.0), whatever x holds past the count (here garbage: NaN, inf,
    negatives)."""
    rng = np.random.default_rng(31)
    B, K = 24, 777
    x = rng.uniform(-2.0, 2.0, (B, K)).astype(np.float32)
    n_valid = {"zero": np.zeros(B, np.int64),
               "K": np.full(B, K, np.int64),
               "random": rng.integers(0, K + 1, B),
               "past_K": rng.integers(K, 3 * K, B)}[nv]
    slot = np.arange(K)[None, :]
    tail = slot >= n_valid[:, None]
    x[tail] = rng.choice(np.float32([np.nan, np.inf, -7.0, 1e30]),
                         int(tail.sum()))
    want = _jax(np.where(tail, np.float32(0.0), x))
    got = seqsum.seq_cumsum(torch.as_tensor(x),
                            n_valid=torch.as_tensor(n_valid))
    _bits_equal(got.numpy(), want)
    _bits_equal(seqsum.seq_cumsum_plain(torch.as_tensor(x),
                                        torch.as_tensor(n_valid)).numpy(),
                want)
    if nv == "zero":
        assert (got.numpy().view(np.int32) == 0).all()     # +0.0 everywhere


def _adversarial(K):
    """Rows whose serial f32 sums differ from any other association:
    alternating 1e8 and 1.0 (each 1.0 is absorbed), sign changes with
    cancellation, masses spanning many binades, and (last) subnormals."""
    rng = np.random.default_rng(77)
    rows = [np.where(np.arange(K) % 2 == 0, 1e8, 1.0),
            np.where(np.arange(K) % 3 == 0, -1e8, 1.0) * rng.uniform(
                0.5, 1.5, K),
            np.exp2(rng.integers(-40, 40, K)) * rng.uniform(1, 2, K),
            rng.normal(size=K) * 1e7,
            rng.uniform(1e-45, 1e-38, K)]
    return np.stack(rows).astype(np.float32)


def test_adversarial_rows_are_serial():
    """Bit for bit np.cumsum on every row, and so_tpu's scan on the
    normal ones (XLA:CPU flushes subnormals to zero; np.cumsum and the
    kernel, built without -ftz, keep them)."""
    K = 4096
    x = _adversarial(K)
    rng = np.random.default_rng(3)
    for nv in (None, rng.integers(0, K + 1, x.shape[0])):
        xm = x if nv is None else np.where(
            np.arange(K)[None, :] < nv[:, None], x, np.float32(0.0))
        want = np.cumsum(xm, axis=1, dtype=np.float32)
        _bits_equal(_jax(xm)[:-1], want[:-1])
        got = seqsum.seq_cumsum(
            torch.as_tensor(x),
            n_valid=None if nv is None else torch.as_tensor(nv))
        _bits_equal(got.numpy(), want)
    # the rows are a witness: pairwise (torch) and blocked (32 columns at
    # a time, the blocks' sums then added) associations give other bits
    want = np.cumsum(x, axis=1, dtype=np.float32)
    pairwise = torch.cumsum(torch.as_tensor(x), dim=1).numpy()
    blocks = x.reshape(x.shape[0], -1, 32)
    inner = np.cumsum(blocks, axis=2, dtype=np.float32)
    carry = np.concatenate([np.zeros((x.shape[0], 1), np.float32),
                            np.cumsum(inner[:, :-1, -1], axis=1,
                                      dtype=np.float32)], axis=1)
    blocked = (inner + carry[:, :, None]).reshape(x.shape)
    for r in range(x.shape[0]):
        assert blocked[r].tobytes() != want[r].tobytes(), r
    assert pairwise.tobytes() != want.tobytes()


def test_first_slot_is_copied():
    """y[0] = +0.0 + x[0], as so_tpu's scan from zeros (and kd2.c's
    `mass = 0`): x[0] itself, but a leading -0.0 becomes +0.0, where
    np.cumsum would keep it; the column loop agrees, with and without a
    count."""
    x = torch.tensor([[-0.0, 1.0], [-0.0, -0.0], [2.0, -2.0], [-0.0, 3.0]])
    want = _jax(x.numpy())
    for got in (seqsum.seq_cumsum(x), seqsum.column_loop(x)):
        _bits_equal(got.numpy(), want)
    nv = torch.tensor([2, 2, 1, 1])
    want_nv = _jax(np.where(np.arange(2)[None, :] < nv.numpy()[:, None],
                            x.numpy(), np.float32(0.0)))
    for got in (seqsum.seq_cumsum(x, n_valid=nv),
                seqsum.seq_cumsum_plain(x, nv)):
        _bits_equal(got.numpy(), want_nv)
    assert not np.signbit(want).any() and not np.signbit(want_nv).any()
    assert np.signbit(np.cumsum(x.numpy(), axis=1)[1, 1])   # np.cumsum's


def test_seq_cumsum_is_not_torch_cumsum():
    """Why K2 exists: torch's cumsum associates differently."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (8, 4096)).astype(np.float32))
    assert not torch.equal(torch.cumsum(x, dim=1), seqsum.seq_cumsum(x))


def test_seq_cumsum_rejects_other_shapes():
    with pytest.raises(ValueError):
        seqsum.seq_cumsum(torch.zeros(5))
    with pytest.raises(ValueError):
        seqsum.seq_cumsum(torch.zeros((2, 5)), 2)
    with pytest.raises(ValueError):
        seqsum.seq_cumsum(torch.zeros((2, 5), dtype=torch.float64))
    x = torch.zeros((2, 5))
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(2),
                torch.zeros(2, dtype=torch.bool)):
        with pytest.raises(ValueError):
            seqsum.seq_cumsum(x, n_valid=bad)


@pytest.mark.parametrize("B, K, rows", [
    (16384, 4096, 32), (8192, 4096, 32), (4096, 1 << 14, 16),
    (1024, 1 << 16, 4), (256, 1 << 18, 1), (8, 1 << 23, 1),
    (16384, 16, 0), (4096, 32, 0), (8192, 33, 32), (4193, 4096, 32),
    (4192, 4096, 16), (2097, 1 << 15, 16), (2096, 1 << 15, 4),
    (1000, 4097, 4), (525, 1 << 17, 4), (524, 1 << 17, 1), (1, 1, 0),
    (1, 33, 1)])
def test_rows_per_block(B, K, rows):
    """Many rows share 32-row tiles; giant rows get a block each (an
    H100 has 132 SMs); rows of at most 32 slots take the short-row
    kernel (0). Every form picked is one the kernel builds."""
    got = seqsum.rows_per_block(B, K, 132)
    assert got == rows and (got in seqsum.ROW_GROUPS or got == 0)


def test_callers_pass_counts_and_keep_so_tpu_bits(monkeypatch):
    """Every K2 call of the solve and the derived pass carries the in-ball
    count, some stop short of K, and the results are unchanged: the solve
    equals so_tpu's bit for bit, and the derived quantities equal those
    of the same pass with the counts dropped."""
    from test_torch_solver import _clumpy

    from so_tpu.engine.solver import solve_rvir as jax_solve_rvir
    from so_tpu.ops import build_grid as jax_build_grid
    from so_tpu_torch.engine import derived, solver
    from so_tpu_torch.io.tipsy import DARK
    from so_tpu_torch.ops.grid import build_grid

    data, centers, rgtp, thr = _clumpy(11, False)
    calls = []

    def recording(x, n_valid=None):
        assert n_valid is not None
        calls.append(int((n_valid < x.shape[1]).sum()))
        return seqsum.seq_cumsum(x, n_valid=n_valid)

    monkeypatch.setattr(solver, "seq_cumsum", recording)
    monkeypatch.setattr(derived, "seq_cumsum", recording)
    ptype = np.full(data["pos"].shape[0], DARK, np.int32)
    grid = build_grid(data["pos"], data["mass"], vel=data["vel"], m=3,
                      ptype=ptype, device="cpu")
    got = solver.solve_rvir(grid, centers, rgtp, thr)
    want = jax_solve_rvir(jax_build_grid(data["pos"], data["mass"], m=3),
                          centers, rgtp, thr)
    for f in ("code", "mvir", "rvir", "j"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    ok = got.code == 0
    assert ok.sum() >= 3
    args = (grid, centers, got.rvir, got.mvir, got.j, ok, 8, (DARK,))
    n_solve = len(calls)
    der = derived.compute_derived(*args)
    assert n_solve > 0 and len(calls) > n_solve and sum(calls) > 0
    monkeypatch.setattr(derived, "seq_cumsum",
                        lambda x, n_valid=None: seqsum.seq_cumsum(x))
    ref = derived.compute_derived(*args)
    for f in ("vcirc", "rmass", "rmax", "vmax"):
        _bits_equal(getattr(der, f), getattr(ref, f))
    _bits_equal(der.profiles[DARK], ref.profiles[DARK])
    assert (der.vcirc[ok] > 0).all()
