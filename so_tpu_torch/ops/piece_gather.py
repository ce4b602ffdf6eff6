"""Kernel K3 — the run-level piece gather (port of
experiments/pallas_piece_dma.py, the piece-DMA variant of the slab gather).

It computes K1's function (ops/slab_gather.py) with K1's dense
chunk-granular slot layout, so its output equals K1's bit for bit over the
same ``gather.cell_ranges``. The difference is the walk: piece_descriptors
cuts each merged run into pieces of PIECE_W chunks (the TPU kernel's unit
of one DMA), and the kernel walks them in groups of 4 columns, each read
with 16-byte loads straight to registers, where K1 reads slot by slot.
It serves the giant capacity tiers (K > gather.PIECE_K_MIN), whose balls
hold 10^5-10^7 candidates in long runs; ops/gather routes each dispatch
by its capacity.

piece_descriptors is the plain version of the descriptors that
ops/ranges.slab_ranges writes on the card.

``piece_gather_rows`` is the wrapper: a CUDA tensor launches the kernel in
csrc/piece_gather.cu, a CPU tensor runs ``piece_gather_plain``; either way
it first refuses what the kernel does not take (_check_k3), a payload
whose row stride is not a multiple of 4 floats among it. Its arguments
after the descriptors, and its (d2, channels, idx) output, are K1's.

d2 keeps K1's f32 association, (c - p*rint((c - x)/p)) - x per axis. The
experiment still uses an older one, dx = c - x; dx - p*round(dx/p), which
differs by a few ulps (tests/test_torch_piece_gather.py holds each side
to its own form).
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from . import _cuda
from .grid import reads_in_16_bytes
from .slab_gather import channel_codes, check_inputs, row_fields

PIECE_W = 2      # chunks per piece (the experiment's PIECE_W)

launches = 0     # kernel launches of piece_gather_rows (CUDA only)
shape_launches = Counter()   # the same launches per (B, K)

# Pieces a block: pieces_per_block takes the one of PIECE_GROUPS whose
# grid of B * NP / p blocks lies nearest, by ratio, to BLOCKS_PER_SM blocks
# an SM. A longer walk amortises a block's set-up (its counts, its ball,
# its pad range); a small grid fills the SMs and balances its tail better
# in short ones. Fit on k3_study.py's [dispatch] readings, on an NVIDIA
# H100 80GB HBM3 (132 SMs, 700 W; PERF.md): every K3 dispatch of the giant
# box's run_so, the dense box's solve and -pot, timed at 1 to 64 pieces.
# Each of 4, 8, 16 and 32 was the fastest at some served dispatch; the
# rule reads 3.3% over the fastest pick summed over them (32 alone 13.6%,
# 16 alone 8.0%), at most 1.09x at any one. 64 won only where 32 was
# within 5%, and lost 1.2x at the dense box's (269, 2^16); 2 won only at
# dispatches of ~5 us, by under 7%.
PIECE_GROUPS = (4, 8, 16, 32)
BLOCKS_PER_SM = 16


def pieces_per_block(B: int, NP: int, n_sm: int) -> int:
    """The kernel's pieces a block for B halos of NP pieces each on a card
    with n_sm SMs."""
    target = BLOCKS_PER_SM * n_sm
    return min(PIECE_GROUPS, key=lambda p: abs(math.log2(B * NP / p /
                                                          target)))


def piece_descriptors(st, cnt, q, K: int, chunk: int):
    """Cut merged slab runs (B, C) into dense piece descriptors.

    Per (halo, piece u < NP), NP = NC = (K + chunk) // chunk: src (the
    chunk-aligned source row of the piece's first column), t0 (its first
    output chunk slot), v (its valid chunks, <= PIECE_W), lo/hi (its run's
    valid row range); per halo the piece count n_pieces and the chunk count
    n_chunks (chunk slots at or past it are pad). All int32 and
    contiguous, as the kernel reads them (payload rows fit int32,
    check_inputs). Pieces at or past NP are dropped (the experiment's
    mode="drop"): their offsets land in a spill column cut off before the
    prefix sum. Pieces at or past n_pieces hold garbage that is never read.

    Piece u of a run whose first piece is qp has src = astart + (u - qp) *
    PIECE_W * chunk, t0 = qc + (u - qp) * PIECE_W and v = nch - (u - qp) *
    PIECE_W clamped to [0, PIECE_W]: each is a per-run constant plus a
    multiple of u, so the five per-run constants are expanded to piece
    slots together (differences scattered to each run's first piece, then
    one prefix sum) and u's term is added after.
    """
    B, C = st.shape
    NC = (K + chunk) // chunk
    NP = NC
    i32 = torch.int32
    pwc = PIECE_W * chunk
    off = st % chunk
    nch = torch.where(cnt > 0, (off + cnt + (chunk - 1)) // chunk,
                      torch.zeros_like(cnt))
    npc = (nch + (PIECE_W - 1)) // PIECE_W
    qp = torch.cumsum(npc, dim=1) - npc
    n_pieces = torch.clamp(npc.sum(dim=1, dtype=i32), max=NP)
    n_chunks = torch.clamp(nch.sum(dim=1, dtype=i32), max=NC)
    qs = torch.clamp(qp, max=NP)                  # NP = the spill column
    # the int64 run values are narrowed as they are written
    vals = torch.stack([st - off - qp * pwc, q // chunk - qp * PIECE_W,
                        nch + qp * PIECE_W, st, st + cnt])    # (5, B, C)
    diffs = torch.empty((5, B, C), dtype=i32, device=st.device)
    diffs[:, :, :1] = vals[:, :, :1]
    torch.sub(vals[:, :, 1:], vals[:, :, :-1], out=diffs[:, :, 1:])
    arr = torch.zeros((5, B, NP + 1), dtype=i32, device=st.device)
    arr.scatter_add_(2, qs.expand(5, B, C), diffs)
    desc = torch.cumsum(arr[:, :, :NP], dim=2, dtype=i32)
    u = torch.arange(NP, dtype=i32, device=st.device)
    src, t0, v, lo, hi = desc.unbind(0)
    src.add_(u * pwc)
    t0.add_(u * PIECE_W)
    v.sub_(u * PIECE_W).clamp_(0, PIECE_W)
    return src, t0, v, lo, hi, n_pieces, n_chunks


def piece_gather_plain(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks,
                       centers, period, r2, K: int, chunk: int,
                       chans: tuple = (), want_idx: bool = False):
    """The kernel's computation in plain torch: every (halo, piece, column)
    source row at once (K1's row_fields), scattered to its dense slot
    t0*chunk + column; slots no piece writes keep the pad values."""
    codes = channel_codes(chans)
    B, NP = src.shape
    dev = soa8t.device
    col = torch.arange(PIECE_W * chunk, device=dev)
    row = src[:, :, None] + col                            # (B, NP, PW*ch)
    slot = t0[:, :, None] * chunk + col
    live = ((torch.arange(NP, device=dev)[None, :] < n_pieces[:, None])
            [:, :, None] & (col // chunk < v[:, :, None]) & (slot < K))
    in_cell = live & (row >= lo[:, :, None]) & (row < hi[:, :, None])
    d2, vals, idx = row_fields(soa8t, row, in_cell, centers, period, r2,
                               codes, want_idx)
    flat = (torch.arange(B, device=dev)[:, None, None] * K + slot)[live]

    def scatter(x, pad):                 # (B, NP, PW*ch) -> (B, K)
        out = torch.full((B * K,), pad, dtype=x.dtype, device=dev)
        out[flat] = x[live]
        return out.reshape(B, K)

    ch = (torch.stack([scatter(x, 0.0) for x in vals], dim=1) if vals
          else torch.zeros((B, 0, K), dtype=torch.float32, device=dev))
    return (scatter(d2, torch.inf), ch,
            None if idx is None else scatter(idx, -1))


def _check_k3(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks, centers,
              period, r2, K: int, chunk: int) -> None:
    """What K3 takes: piece_descriptors' int32 descriptors, f32 centers,
    period and r2, all contiguous (the kernel reads them as they are;
    nothing is converted), and a payload whose rows the kernel reads in
    16-byte groups (ops/grid.reads_in_16_bytes)."""
    B, NP = src.shape
    ints = (src, t0, v, lo, hi, n_pieces, n_chunks)
    flts = (centers, period, r2)
    check_inputs("K3", soa8t, B, chunk, ints + flts)
    if (any(x.shape != (B, NP) for x in (t0, v, lo, hi))
            or n_pieces.shape != (B,) or n_chunks.shape != (B,)
            or centers.shape != (B, 3) or period.shape != (3,)
            or r2.shape != (B,) or not 0 < K <= NP * chunk):
        raise ValueError("K3 inputs disagree in shape (see "
                         "piece_descriptors)")
    if (any(x.dtype != torch.int32 for x in ints)
            or any(x.dtype != torch.float32 for x in flts)
            or not all(x.is_contiguous() for x in ints + flts)):
        raise ValueError("K3 takes contiguous int32 descriptors (see "
                         "piece_descriptors) and contiguous f32 centers, "
                         "period and r2")
    if not reads_in_16_bytes(soa8t) or chunk % 4:
        raise ValueError("K3 reads the payload in 16-byte groups: its row "
                         "stride and the chunk must be multiples of 4 "
                         "floats and its base 16-byte aligned, got stride "
                         f"{soa8t.shape[1]}, chunk {chunk}")


def piece_gather_rows(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks,
                      centers, period, r2, K: int, chunk: int,
                      chans: tuple = (), want_idx: bool = False):
    """K3 on the payload's device: the CUDA kernel for a CUDA payload, the
    plain torch version for a CPU one. Returns (d2, channels, idx)."""
    global launches
    args = (soa8t, src, t0, v, lo, hi, n_pieces, n_chunks, centers, period,
            r2, K, chunk)
    codes = channel_codes(chans)
    _check_k3(*args)
    if soa8t.device.type == "cpu":
        return piece_gather_plain(*args, chans, want_idx)
    if soa8t.device.type != "cuda":
        raise ValueError(f"no piece gather for device {soa8t.device}")
    B, NP = src.shape
    dev = soa8t.device
    out = torch.empty((B, 1 + len(codes), K), dtype=torch.float32,
                      device=dev)
    idx = (torch.empty((B, K), dtype=torch.int32, device=dev) if want_idx
           else None)
    _cuda.launch(
        dev, "so_piece_gather", soa8t.data_ptr(), soa8t.shape[1],
        *(x.data_ptr() for x in (src, t0, v, lo, hi, n_pieces, n_chunks)),
        NP, centers.data_ptr(), period.data_ptr(), r2.data_ptr(), B, K,
        chunk, len(codes), *codes, *([0] * (5 - len(codes))),
        out.data_ptr(), idx.data_ptr() if idx is not None else None,
        pieces_per_block(B, NP, _cuda.sm_count(dev)))
    launches += 1
    shape_launches[(B, K)] += 1
    return out[:, 0], out[:, 1:], idx
