"""Kernel K2 — sequential (C-order) float32 row cumsum (port of
so_tpu/ops/seqsum.py).

The reference accumulates mass with a serial ``mass += m`` in float32;
a tree- or f64-associated cumsum differs in the last ulp and flips
half-mass-radius indices. ``seq_cumsum`` is the wrapper: a CUDA tensor
launches csrc/seqsum.cu (one thread per row), a CPU tensor runs
``seq_cumsum_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

launches = 0     # kernel launches of seq_cumsum (CUDA only)


def seq_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    """Left-associated f32 cumsum along dim 1 of a (B, K) tensor. On the
    CPU through np.cumsum (ufunc.accumulate: r[i] = r[i-1] + a[i], the
    serial order); elsewhere as a torch loop over columns."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.cumsum(x.numpy(), axis=1,
                                          dtype=np.float32))
    return column_loop(x)


def column_loop(x: torch.Tensor) -> torch.Tensor:
    """The serial sum as one torch add per column (any device)."""
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def _seq_cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    global launches
    x = x.contiguous()
    y = torch.empty_like(x)
    B, K = x.shape
    if B and K:
        rc = _cuda.library().so_seqsum_rows(x.data_ptr(), y.data_ptr(), B, K,
                                            _cuda.stream_ptr(x.device))
        _cuda.check(rc, "so_seqsum_rows")
        launches += 1
    return y


def seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Left-associated f32 cumsum along dim 1 of a (B, K) f32 tensor, on
    the tensor's device (kernel on CUDA, plain version on the CPU)."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("seq_cumsum takes a (B, K) float32 tensor")
    if x.device.type == "cuda":
        return _seq_cumsum_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"no seq_cumsum for device {x.device}")
    return seq_cumsum_plain(x)
