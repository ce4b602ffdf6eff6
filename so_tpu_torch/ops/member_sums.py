"""The fused pass's f64 m*v member sums over its sorted stack (no TPU
kernel: the JAX package forms them on the host, so_tpu/engine/members.
member_mv_sums).

``member_sums(soa8t, idx, counts)`` gives, for each row b of the (B, W)
int32 stack of grid rows ``idx``, the (3,) f64 sums of m*v over its first
``counts[b]`` rows: the halo's interior, a prefix of its distance-sorted
row. The terms are f64(fl32(v * m)) from the payload's raw masses and
velocities (ops/grid.pack_soa8t) and the adds are member_mv_sums' own
(engine/members' module docstring), so the bits equal member_mv_sums
over the same rows in file order. A CUDA tensor launches
csrc/member_sums.cu; a CPU tensor runs ``member_sums_plain``,
member_mv_sums itself over the payload's rows.
"""

from __future__ import annotations

import torch

from . import _cuda

# csrc/member_sums.cu's kCut / 2: every node of the pairwise tree that the
# first kernel sums in one thread, but the root, holds at least this many
# terms, so a halo of W slots needs ceil((W - 1) / CUT_GRAIN) scratch slots
CUT_GRAIN = 2048

launches = 0     # kernel launches of member_sums (CUDA only)


def _check(soa8t, idx, counts):
    if soa8t.dtype != torch.float32 or soa8t.dim() != 2 or \
            soa8t.shape[0] != 8 or soa8t.stride(1) != 1:
        raise ValueError("member_sums takes the grid's (8, W) f32 payload")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError("member_sums takes a (B, W) int32 row stack")
    if counts.shape != (idx.shape[0],) or counts.dtype != torch.int64:
        raise ValueError("member_sums takes (B,) int64 counts")
    if not (soa8t.device == idx.device == counts.device):
        raise ValueError("member_sums' payload, stack and counts must share "
                         "a device")


def member_sums_plain(soa8t: torch.Tensor, idx: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """member_sums on the CPU: members.member_mv_sums over the payload's
    ``(vel, mass)`` at the interior rows (the payload holds the raw f32
    values, so the bits are those of the file-order arrays)."""
    from ..engine.members import member_mv_sums

    pay = soa8t.numpy()
    slot = torch.arange(idx.shape[1])[None, :]
    rows = idx[slot < counts[:, None]].numpy()   # halo-major, in order
    return torch.from_numpy(member_mv_sums((pay[4:7].T, pay[3]), rows,
                                           counts.numpy()))


def member_sums(soa8t: torch.Tensor, idx: torch.Tensor, counts: torch.Tensor,
                uniform_mass: float | None = None) -> torch.Tensor:
    """(B, 3) f64 m*v sums over each stack row's first ``counts[b]`` rows,
    on the tensors' device. ``uniform_mass`` (the grid's) lets the kernel
    skip the mass row when it is nonzero: every mass then equals it bit for
    bit (a zero mass may be +0.0 or -0.0, so zero is read row by row)."""
    _check(soa8t, idx, counts)
    if idx.device.type == "cuda":
        return _member_sums_cuda(soa8t, idx, counts, uniform_mass)
    if idx.device.type != "cpu":
        raise ValueError(f"no member_sums for device {idx.device}")
    return member_sums_plain(soa8t, idx, counts)


def _member_sums_cuda(soa8t, idx, counts, uniform_mass):
    global launches
    B, W = idx.shape
    if B == 0 or W == 0:
        return torch.zeros((B, 3), dtype=torch.float64, device=idx.device)
    out = torch.empty((B, 3), dtype=torch.float64, device=idx.device)
    idx = idx.contiguous()
    counts = counts.contiguous()
    NI = -(-(W - 1) // CUT_GRAIN)
    cut = torch.empty((B, NI, 3), dtype=torch.float64, device=idx.device)
    uniform = uniform_mass is not None and uniform_mass != 0.0
    _cuda.launch(idx.device, "so_member_sums", soa8t.data_ptr(),
                 soa8t.stride(0), idx.data_ptr(), counts.data_ptr(), B, W,
                 float(uniform_mass) if uniform else 0.0, int(uniform),
                 cut.data_ptr(), NI, out.data_ptr())
    launches += 1
    return out
