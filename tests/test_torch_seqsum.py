"""K2's plain version (so_tpu_torch.ops.seqsum) against so_tpu's serial
f32 scan on the CPU: bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from so_tpu.ops.seqsum import seq_cumsum as jax_seq_cumsum
from so_tpu_torch.ops import seqsum


@pytest.mark.parametrize("shape", [(16, 4096), (3, 1), (64, 333)])
def test_seq_cumsum_matches_so_tpu(shape):
    rng = np.random.default_rng(19)
    x = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    x[:, ::7] = 0.0                        # the zero pad of invalid slots
    x[0, : shape[1] // 2] = np.float32(1e-3)   # equal masses (ladder-like)
    want = np.asarray(jax_seq_cumsum(jnp.asarray(x), axis=1))
    n0 = seqsum.launches
    got = seqsum.seq_cumsum(torch.as_tensor(x))
    assert seqsum.launches == n0            # a CPU tensor never launches K2
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # the torch column loop (the plain version off the CPU) agrees too
    loop = seqsum.column_loop(torch.as_tensor(x))
    np.testing.assert_array_equal(loop.numpy().view(np.int32),
                                  want.view(np.int32))


def test_seq_cumsum_is_not_torch_cumsum():
    """Why K2 exists: torch's cumsum associates differently."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(0.0, 1.0, (8, 4096)).astype(np.float32))
    assert not torch.equal(torch.cumsum(x, dim=1), seqsum.seq_cumsum(x))


def test_seq_cumsum_rejects_other_shapes():
    with pytest.raises(ValueError):
        seqsum.seq_cumsum(torch.zeros(5))
    with pytest.raises(ValueError):
        seqsum.seq_cumsum(torch.zeros((2, 5), dtype=torch.float64))
