"""Correctly rounded f32 arithmetic where a torch kernel is not.

torch's vectorized CPU sqrt (AVX-512 builds) is one ulp off for about
0.6% of f32 inputs, while XLA, numpy, the reference's C code and CUDA's
sqrtf (no fast math) round correctly. Every d2 -> distance and Vc in the
scan and the derived quantities goes through ``sqrt_rn`` so the CPU and
CUDA runs of the port, and so_tpu, see the same bits. +, -, * and / are
correctly rounded in torch on both devices.
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
