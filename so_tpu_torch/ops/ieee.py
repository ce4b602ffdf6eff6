"""Correctly rounded f32 arithmetic where a torch kernel is not.

torch's vectorized CPU sqrt (AVX-512 builds) is one ulp off for about
0.6% of f32 inputs, while XLA, numpy, the reference's C code and CUDA's
sqrtf (no fast math) round correctly. Every d2 -> distance and Vc in the
scan and the derived quantities goes through ``sqrt_rn`` so the CPU and
CUDA runs of the port, and so_tpu, see the same bits. +, -, * and / are
correctly rounded in torch on both devices. torch has no cube root;
``cbrt_f32`` forms one in f64 the same way on both devices.
"""

from __future__ import annotations

import numpy as np
import torch


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """IEEE round-to-nearest square root on the tensor's device: numpy's
    (the hardware instruction) for a CPU tensor, torch's for a CUDA one."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def cbrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Cube root of an f32 tensor, rounded once to f32: pow(|x|, 1/3) in
    f64, one Newton step, the sign restored. The f64 root is within about
    one f64 ulp of the exact one, so the f32 result is the correctly
    rounded root unless that root lies within ~2^-52 (relative) of an f32
    rounding boundary."""
    a = x.to(torch.float64).abs()
    r = torch.pow(a, 1.0 / 3.0)
    r = torch.where(r > 0, r - (r * r * r - a) / (3.0 * r * r), r)
    return (torch.sign(x.to(torch.float64)) * r).to(torch.float32)
