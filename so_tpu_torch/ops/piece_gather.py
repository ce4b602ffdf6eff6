"""Kernel K3 — the run-level piece gather (port of
experiments/pallas_piece_dma.py, the piece-DMA variant of the slab gather).

It computes K1's function (ops/slab_gather.py) with K1's dense
chunk-granular slot layout, so its output equals K1's bit for bit over the
same ``gather.cell_ranges``. The difference is the walk: piece_descriptors
cuts each merged run into pieces of PIECE_W chunks, and the kernel copies
a piece's columns into shared memory in one batch, where K1 reads every
chunk separately. That pays on the giant capacity tiers
(K > gather.PIECE_K_MIN), whose balls hold 10^5-10^7 candidates in long
runs; ops/gather routes each dispatch by its capacity.

``piece_gather_rows`` is the wrapper: a CUDA tensor launches the kernel in
csrc/piece_gather.cu, a CPU tensor runs ``piece_gather_plain``. Its
arguments after the descriptors, and its (d2, channels, idx) output, are
K1's.

d2 keeps K1's f32 association, (c - p*rint((c - x)/p)) - x per axis. The
experiment still uses an older one, dx = c - x; dx - p*round(dx/p), which
differs by a few ulps (tests/test_torch_piece_gather.py holds each side
to its own form).
"""

from __future__ import annotations

import torch

from . import _cuda
from .slab_gather import channel_codes, check_inputs, row_fields

PIECE_W = 2      # chunks per piece (the experiment's PIECE_W)

launches = 0     # kernel launches of piece_gather_rows (CUDA only)


def piece_descriptors(st, cnt, q, K: int, chunk: int):
    """Cut merged slab runs (B, C) into dense piece descriptors.

    Per (halo, piece u < NP), NP = NC = (K + chunk) // chunk: src (the
    chunk-aligned source row of the piece's first column), t0 (its first
    output chunk slot), v (its valid chunks, <= PIECE_W), lo/hi (its run's
    valid row range); per halo the piece count n_pieces and the chunk count
    n_chunks (chunk slots at or past it are pad). All int64. Pieces at or
    past NP are dropped (the experiment's mode="drop"): their offsets land
    in a spill column cut off before the prefix sum. Pieces at or past
    n_pieces hold garbage that is never read.
    """
    B, C = st.shape
    NC = (K + chunk) // chunk
    NP = NC
    astart = (st // chunk) * chunk
    foot = torch.where(cnt > 0, ((st % chunk) + cnt + (chunk - 1))
                       // chunk * chunk, torch.zeros_like(cnt))
    nch = foot // chunk
    qc = q // chunk
    npc = (nch + (PIECE_W - 1)) // PIECE_W
    qp = torch.cumsum(npc, dim=1) - npc
    n_pieces = torch.clamp(npc.sum(dim=1), max=NP)
    n_chunks = torch.clamp(nch.sum(dim=1), max=NC)
    qs = torch.clamp(qp, max=NP)                  # NP = the spill column

    def seg_const(vals):
        """Piecewise-constant per-run value expanded to piece slots."""
        diffs = torch.cat([vals[:, :1], vals[:, 1:] - vals[:, :-1]], dim=1)
        arr = torch.zeros((B, NP + 1), dtype=vals.dtype, device=vals.device)
        arr.scatter_add_(1, qs, diffs)
        return torch.cumsum(arr[:, :NP], dim=1)

    j = torch.arange(NP, device=st.device)[None, :] - seg_const(qp)
    src = seg_const(astart) + j * (PIECE_W * chunk)
    t0 = seg_const(qc) + j * PIECE_W
    v = torch.clamp(seg_const(nch) - j * PIECE_W, 0, PIECE_W)
    return src, t0, v, seg_const(st), seg_const(st + cnt), n_pieces, n_chunks


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


def _piece_gather_cuda(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks,
                       centers, period, r2, K: int, chunk: int, chans: tuple,
                       want_idx: bool):
    global launches
    codes = channel_codes(chans)
    B, NP = src.shape
    dev = soa8t.device
    check_inputs("K3", soa8t, B, chunk, (src, t0, v, lo, hi, n_pieces,
                                         n_chunks, centers, period, r2))
    if (any(x.shape != (B, NP) for x in (t0, v, lo, hi))
            or n_pieces.shape != (B,) or n_chunks.shape != (B,)
            or centers.shape != (B, 3) or period.shape != (3,)
            or r2.shape != (B,) or not 0 < K <= NP * chunk):
        raise ValueError("K3 inputs disagree in shape (see "
                         "piece_descriptors)")
    # The converted copies die when this returns, before the kernel may
    # have run: safe, because the caching allocator hands their memory
    # only to later work on the same stream.
    i32 = [x.to(torch.int32).contiguous()
           for x in (src, t0, v, lo, hi, n_pieces, n_chunks)]
    f32 = [x.to(torch.float32).contiguous() for x in (centers, period, r2)]
    out = torch.empty((B, 1 + len(codes), K), dtype=torch.float32,
                      device=dev)
    idx = (torch.empty((B, K), dtype=torch.int32, device=dev) if want_idx
           else None)
    c = codes + [0] * (5 - len(codes))
    rc = _cuda.library().so_piece_gather(
        soa8t.data_ptr(), soa8t.shape[1], *(x.data_ptr() for x in i32), NP,
        *(x.data_ptr() for x in f32), B, K, chunk, len(codes), *c,
        out.data_ptr(), idx.data_ptr() if idx is not None else None,
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "so_piece_gather")
    launches += 1
    return out[:, 0], out[:, 1:], idx


def piece_gather_rows(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks,
                      centers, period, r2, K: int, chunk: int,
                      chans: tuple = (), want_idx: bool = False):
    """K3 on the payload's device: the CUDA kernel for a CUDA payload, the
    plain torch version for a CPU one. Returns (d2, channels, idx)."""
    args = (soa8t, src, t0, v, lo, hi, n_pieces, n_chunks, centers, period,
            r2, K, chunk, chans, want_idx)
    if soa8t.device.type == "cuda":
        return _piece_gather_cuda(*args)
    if soa8t.device.type != "cpu":
        raise ValueError(f"no piece gather for device {soa8t.device}")
    return piece_gather_plain(*args)
