"""Kernel K2's share of its roofline: the least time its launches could
take over the device time of its kernels (seqsum_rows_kernel,
seqsum_short_kernel), in percent.

The least time of one launch over a (B, K) f32 block with n_valid counts
is the larger of bytes / 3.35 TB/s and adds / 67 TFLOP/s (one H100 SXM's
device memory bandwidth and f32 rate, NVIDIA's data sheet, at a 700 W
power limit; the result line gives the card's limit). Bytes count what
the inputs need: the sum of n_valid f32 read (slots past n_valid are not
read), the B * K f32 written, and the (B,) int64 counts; adds are the sum
of n_valid. ``install`` wraps the program's K2 launcher in a traced run
to keep each launch's (B, K, sum of n_valid) on the device.
"""

import importlib

from sobench import trace as tr

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNELS = ("seqsum_rows_kernel", "seqsum_short_kernel")
LAUNCHER = ("so_tpu_torch.ops.seqsum", "_seq_cumsum_cuda")


def install(notes):
    try:
        mod = importlib.import_module(LAUNCHER[0])
    except ImportError:
        return lambda: None
    fn = getattr(mod, LAUNCHER[1], None)
    if fn is None:
        return lambda: None
    calls = notes.setdefault("k2_calls", [])

    def launcher(x, n_valid):
        B, K = x.shape
        nv = (None if n_valid is None
              else n_valid.clamp(0, K).sum())
        calls.append((B, K, nv))
        return fn(x, n_valid)

    setattr(mod, LAUNCHER[1], launcher)
    return lambda: setattr(mod, LAUNCHER[1], fn)


def least_seconds(B, K, n_valid_sum, has_counts) -> float:
    nbytes = 4 * n_valid_sum + 4 * B * K + (8 * B if has_counts else 0)
    return max(nbytes / HBM_BYTES_PER_S, n_valid_sum / F32_OPS_PER_S)


def read(record):
    trace = record["trace"]
    if trace is None or not trace.notes.get("k2_calls"):
        return None
    ns = tr.device_ns(trace, lambda n: any(k in n for k in KERNELS))
    if not ns:
        return None
    least = 0.0
    for B, K, nv in trace.notes["k2_calls"]:
        nvs = B * K if nv is None else int(nv)
        least += least_seconds(B, K, nvs, nv is not None)
    return 100.0 * least / (ns / 1e9)
