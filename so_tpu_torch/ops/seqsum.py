"""Kernel K2 — sequential (C-order) float32 row cumsum (port of
so_tpu/ops/seqsum.py).

The reference accumulates mass with a serial ``mass += m`` in float32;
a tree- or f64-associated cumsum differs in the last ulp and flips
half-mass-radius indices. ``seq_cumsum`` is the wrapper: a CUDA tensor
launches csrc/seqsum.cu, a CPU tensor runs ``seq_cumsum_plain``.

``n_valid`` (optional, one count per row, passed by keyword) makes the
function the serial cumsum of ``where(slot < n_valid, x, +0.0)``. Every
caller's rows are +0.0 past their in-ball count, and adding +0.0 leaves
a serial sum unchanged, so passing the count changes no bit; the kernel
then stops each chain at the count and reads nothing past it.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from .. import profiling
from . import _cuda

launches = 0                 # kernel launches of seq_cumsum (CUDA only)
shape_launches = Counter()   # the same launches per (B, K)

# Rows per block of the tiled kernel, many-rows end first. A block of
# ROWS rows runs ROWS chains at once; rows_per_block takes the largest
# ROWS that still gives every SM a block, so few rows spread one per block
# (the single-chain walk of the giant tiers) and many rows share coalesced
# 32-row tiles. Rows of at most SHORT_K slots go to the short-row kernel
# instead (0: one thread per row, the row in registers). Each form is the
# fastest, or within 0.3% of it, where it is picked in k2_study.py's
# sweep on an NVIDIA H100 80GB HBM3 (132 SMs, 700 W; readings in
# PERF.md): 32 from 4193 rows up ((16384, 2^12), (8192, 2^12)), 16 at
# (4096, 2^14), 4 at (1024, 2^16) and (1000, 4097), 1 from 524 rows down
# ((256, 2^18) to (8, 2^23)).
ROW_GROUPS = (32, 16, 4, 1)
BLOCKS_PER_SM = 1
SHORT_K = 32


def rows_per_block(B: int, K: int, n_sm: int) -> int:
    """The kernel's rows per block for (B, K) rows on a card with n_sm SMs
    (0: the short-row kernel)."""
    if K <= SHORT_K:
        return 0
    for rows in ROW_GROUPS:
        if -(-B // rows) >= BLOCKS_PER_SM * n_sm:
            return rows
    return 1


def _masked(x: torch.Tensor, n_valid) -> torch.Tensor:
    if n_valid is None:
        return x
    slot = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(slot < n_valid[:, None], x,
                       torch.zeros((), device=x.device))


def seq_cumsum_plain(x: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Left-associated f32 cumsum along dim 1 of a (B, K) tensor from
    +0.0, slots at or past ``n_valid`` read as +0.0. On the CPU through
    np.cumsum (ufunc.accumulate: r[0] = a[0], r[i] = r[i-1] + a[i], the
    serial order) of the rows with +0.0 added to their first slot, as the
    reference's scan from zeros does; elsewhere as a torch loop over
    columns."""
    x = _masked(x, n_valid)
    if x.device.type == "cpu":
        a = x.numpy().copy()
        a[:, :1] += np.float32(0.0)      # a leading -0.0 becomes +0.0
        return torch.from_numpy(np.cumsum(a, axis=1, dtype=np.float32))
    return column_loop(x)


def column_loop(x: torch.Tensor) -> torch.Tensor:
    """The serial sum as one torch add per column (any device)."""
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc = acc + x[:, k]
        out[:, k] = acc
    return out


def count_call(x: torch.Tensor, n_valid) -> None:
    """One call over (B, K) rows with work to do, in profiling's counts:
    K2.calls (a host count, always). While profiling keeps device counts
    (start_recording with device_counts), also K2.chain_adds, the call's
    longest chain of adds (its largest n_valid, or K without counts), and
    K2.bytes, what its inputs need: the n_valid f32 read (B x K without
    counts), the B x K f32 written and the (B,) int64 counts."""
    B, K = x.shape
    if not (B and K):
        return
    profiling.counts[("K2.calls",)] += 1
    if not profiling.counting():
        return
    if n_valid is None:
        chain, read = K, B * K
    else:
        nv = n_valid.clamp(0, K)
        chain, read = nv.max(), nv.sum()
    profiling.count_on_device("K2.chain_adds", chain)
    profiling.count_on_device(
        "K2.bytes", 4 * read + 4 * B * K + (0 if n_valid is None else 8 * B))


def _seq_cumsum_cuda(x: torch.Tensor, n_valid):
    global launches
    x = x.contiguous()
    y = torch.empty_like(x)
    B, K = x.shape
    if B and K:
        nv = None if n_valid is None else n_valid.to(torch.int64).contiguous()
        rows = rows_per_block(B, K, _cuda.sm_count(x.device))
        _cuda.launch(
            x.device, "so_seqsum_rows", x.data_ptr(), y.data_ptr(),
            None if nv is None else nv.data_ptr(), B, K, rows)
        launches += 1
        shape_launches[(B, K)] += 1
    return y


def seq_cumsum(x: torch.Tensor, axis: int = 1, n_valid=None) -> torch.Tensor:
    """Left-associated f32 cumsum along ``axis`` of a 2-D f32 tensor, on
    the tensor's device (kernel on CUDA, plain version on the CPU). The
    kernel is row-wise, so axis 0 runs it on the transpose. ``n_valid``:
    optional integer tensor on the same device, one count per line along
    ``axis``; slots at or past it read as +0.0."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError("seq_cumsum takes a 2-D float32 tensor")
    if axis not in (0, 1, -1, -2):
        raise ValueError(f"no axis {axis} in a 2-D tensor")
    if axis % 2 == 0:
        return seq_cumsum(x.T, 1, n_valid).T
    if n_valid is not None and (
            n_valid.shape != (x.shape[0],) or n_valid.device != x.device
            or n_valid.dtype.is_floating_point or n_valid.dtype == torch.bool):
        raise ValueError("n_valid must be a (B,) integer tensor on x's "
                         "device")
    count_call(x, n_valid)
    if x.device.type == "cuda":
        return _seq_cumsum_cuda(x, n_valid)
    if x.device.type != "cpu":
        raise ValueError(f"no seq_cumsum for device {x.device}")
    return seq_cumsum_plain(x, n_valid)
