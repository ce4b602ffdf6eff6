"""Batched ball gather (port of so_tpu/ops/gather.py).

  1. enumerate the S^3 cube of level-g cells covering each ball (periodic
     wrap on cell indices; offsets beyond the needed span are masked),
  2. prune cells whose min distance to the center exceeds the ball radius
     (the reference's INTERSECT role),
  3. merge Morton-adjacent cell slabs into maximal runs and lay their
     CHUNK-aligned footprints out densely (cell_ranges, align=chunk); on
     the card 1-3 and the descriptors of step 4 are one launch
     (ranges.slab_ranges),
  4. a kernel computes min-image distances and channels per slot
     (unsorted_gather): K1 up to PIECE_K_MIN slots, K3 above (the giant
     tiers; the same function and slot layout, so the same bits). Where
     the rows are wanted sorted by distance (slab_gather), K1's sorted
     form emits them so up to SORTED_K_MAX slots; longer rows are gathered
     slotted, and their in-ball slots sorted by one keyed torch.sort into
     rows as wide as the dispatch's widest ball (slab_gather.sort_in_ball).

Capacity K and cube side S are per-dispatch values; the host escalates K
when a ball overflows, mirroring the reference's nnList regrow.

ragged_ball_gather is so_tpu's payload-free gather, plain torch on the
grid's device: a dense slot index from the unaligned cell ranges, the
positions read at it and d2 in torch ops. No kernel of the port serves it
and no engine path calls it.

The engine gathers only through slab_gather, unsorted_gather and
footprint. A grid that is not a CellGrid (parallel.ShardedGrid) serves
them itself: each particle shard gathers at capacity K and the shards'
rows are merged, P * K slots a halo.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import NamedTuple

import torch

from .. import profiling
from .grid import CellGrid
from .piece_gather import PIECE_W, piece_gather_rows
from .ranges import cell_ranges_plain, slab_ranges
from .slab_gather import (slab_gather_rows, slab_gather_sorted_rows,
                          sort_in_ball)

# Dispatches of more slots than this go through K3, the rest through K1:
# so_tpu's K_SLAB_MAX, the capacity where it leaves its per-chunk kernel.
PIECE_K_MIN = 1 << 15

# Sorted gathers of at most this many slots (and no more than PIECE_K_MIN)
# go through K1's sorted form (one block a halo, the row sorted in shared
# memory); longer rows take a slotted kernel and a torch.sort. 2^14 is also
# the most the kernel takes: 8 B a slot of one block's shared memory.
SORTED_K_MAX = 1 << 14


def min_image(c, p, period):
    """Min-image displacement with the reference's exact f32 association:
    the shifted center c - period*n first, then the particle subtracted."""
    d0 = c - p
    n = torch.round(d0 / period)      # half to even, as jnp.round
    return (c - period * n) - p


def cell_ranges(grid: CellGrid, level: int, centers, radii, r2_mask, S: int,
                align: int = 1):
    """Enumerate each ball's candidate cells at the given level.

    Returns int64 (st, cnt, q, total): per (halo, cell) the CSR slab start,
    count (0 for pruned / out-of-span cells), exclusive output offset, and
    the per-halo candidate total. ``align`` > 1 merges Morton-adjacent
    slabs into maximal runs and rounds each run's footprint out to
    align-sized chunks (the slab kernel's layout); runs then occupy the
    leading slots of each row and the trailing slots have cnt = 0. That
    form goes through ranges.slab_ranges (the kernel on a CUDA grid); with
    ``align`` 1 it is ranges.cell_ranges_plain on either device.
    """
    if align == 1:
        return cell_ranges_plain(grid, level, centers, radii, r2_mask, S)
    return slab_ranges(grid, level, centers, radii, r2_mask, S, align)[0]


class GatherResult(NamedTuple):
    d2: torch.Tensor        # (B, K) f32, ascending if sort=True; +inf pad
    idx: torch.Tensor       # (B, K) i32 rows of the grid's sorted particles
    n_in: torch.Tensor      # (B,) i32 hits with d2 <= r2_mask
    overflow: torch.Tensor  # (B,) bool candidate count exceeded K


def ragged_ball_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                       K: int, S: int, sort: bool = True) -> GatherResult:
    """Every particle with min-image d2 <= r2_mask about each center, in
    K dense slots (so_tpu/ops/gather.py's ragged_ball_gather, op for op).

    The candidates are the cell ranges of cell_ranges with ``align`` 1, laid
    end to end: ``overflow`` is their total > K, and a slot past the total
    reads row n - 1 and is masked. ``radii`` sets the cube's coverage
    (radii^2 >= r2_mask); ``r2_mask`` is the inclusive acceptance bound.
    d2 is dx*dx + dy*dy + dz*dz after min_image, each op rounded once.
    ``sort`` orders each row by d2 with a stable sort over the slots (tie
    order is free, docs/PARITY.md #3); unsorted, idx is so_tpu's at every
    slot."""
    n = grid.n
    B = centers.shape[0]
    dev = centers.device
    st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2_mask, S)
    overflow = total > K

    # ragged -> dense: the piecewise-constant jump st - q of each cell,
    # its differences scattered at the cells' output offsets and summed;
    # offsets at or past K land in a spill column that is cut off (the
    # JAX scatter's mode="drop")
    jumps = st - q
    dif = torch.cat([jumps[:, :1], jumps[:, 1:] - jumps[:, :-1]], dim=1)
    acc = torch.zeros((B, K + 1), dtype=torch.int64, device=dev)
    acc.scatter_add_(1, torch.clamp(q, max=K), dif)
    slot = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    gidx = torch.cumsum(acc[:, :K], dim=1) + slot
    slot_ok = slot < torch.clamp(total, max=K)[:, None]
    gidx = torch.clamp(gidx, 0, n - 1)

    p = grid.pos_a()[gidx]                              # (B, K, 3)
    d = min_image(centers[:, None, :], p, grid.period[None, None, :])
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    valid = slot_ok & (d2 <= r2_mask[:, None])
    n_in = valid.sum(dim=1, dtype=torch.int32)

    key = torch.where(valid, d2, torch.full_like(d2, torch.inf))
    if sort:
        key, order = torch.sort(key, dim=1, stable=True)
        gidx = torch.gather(gidx, 1, order)
    return GatherResult(d2=key, idx=gidx.to(torch.int32), n_in=n_in,
                        overflow=overflow)


def _spans(layer: str | None):
    """``part -> span "<layer>.<part>"``, or no span without a layer."""
    if layer is None:
        return lambda part: nullcontext()
    return lambda part: profiling.span(f"{layer}.{part}")


def count_gather_bytes(kernel: str, grid: CellGrid, ranges, K: int,
                       nchan: int, want_idx: bool, sorted_form: bool = False):
    """While profiling keeps device counts (start_recording with
    device_counts), add one K1 or K3 launch's bytes to the device count
    "<kernel>.bytes" ("K1" or "K3"), from cell_ranges' output (st, cnt,
    q) with no sync. The reckoning is the bytes bound of
    chip_smoke.gather_bound over gather_reads:

    - 12 B (the x, y, z rows) for each distinct payload row that the
      launch's runs put at slots below K (row st + i of a run sits at slot
      q + st % chunk + i), counted once however many of its balls hold it;
    - 4 B for each int32 field of each live descriptor (K1: a0, lo, hi of
      each of a halo's chunks; K3: src, t0, v, lo, hi of each of its
      pieces of PIECE_W chunks) and 4 B for each halo's count;
    - every output slot written once: 4 B x B x K for d2, for each channel
      and for idx if asked;
    - K1's sorted form: the (B,) int64 in-ball counts, 8 B each.

    The channels' payload rows read at in-ball rows are left out: which
    rows lie in a ball shows only in the kernel's output. So the count is
    a floor of what the launch must move, and a share of the roofline
    from it cannot read high. The counting is its own span, gather.bytes,
    so what it costs is not read as the gather's."""
    if not profiling.counting():
        return
    with profiling.span("gather.bytes"):
        _count_bytes(kernel, grid, ranges, K, nchan, want_idx, sorted_form)


def _count_bytes(kernel, grid, ranges, K, nchan, want_idx, sorted_form):
    st, cnt, q, _ = ranges
    B = st.shape[0]
    chunk = grid.chunk
    off = st % chunk
    reach = torch.clamp(torch.minimum(cnt, K - q - off), min=0)
    # distinct rows: the union of the runs [st, st + reach), swept in
    # order of their starts (an empty run sits at 0 and adds nothing)
    lo = torch.where(reach > 0, st, torch.zeros_like(st)).flatten()
    hi = lo + reach.flatten()
    order = torch.argsort(lo)
    lo, hi = lo[order], hi[order]
    seen = torch.cat([hi.new_zeros(1), torch.cummax(hi, 0).values[:-1]])
    rows = torch.clamp(hi - torch.maximum(lo, seen), min=0).sum()
    nch = torch.where(cnt > 0, (off + cnt + (chunk - 1)) // chunk,
                      torch.zeros_like(cnt))
    NC = (K + chunk) // chunk
    if kernel == "K3":
        per_desc = 5
        n_desc = torch.clamp(((nch + (PIECE_W - 1)) // PIECE_W).sum(dim=1),
                             max=NC)
    else:
        per_desc = 3
        n_desc = torch.clamp(nch.sum(dim=1), max=NC)
    fixed = (4 * B + 4 * B * K * (1 + nchan + int(want_idx))
             + (8 * B if sorted_form else 0))
    profiling.count_on_device(f"{kernel}.bytes",
                              12 * rows + 4 * per_desc * n_desc.sum() + fixed)


def _slotted_kernel(K: int) -> str:
    """The slotted launch of capacity K: K1 for K <= PIECE_K_MIN, else
    K3."""
    return "K3" if K > PIECE_K_MIN else "K1"


def _slotted(grid: CellGrid, ranges, kernel: str, desc, centers, r2_mask,
             K: int, chans: tuple, want_idx: bool):
    """(d2, channels, idx) in slot order: the launch of ``kernel`` over its
    descriptors ``desc``."""
    rows = piece_gather_rows if kernel == "K3" else slab_gather_rows
    out = rows(grid.soa8t, *desc, centers, grid.period, r2_mask, K,
               grid.chunk, chans, want_idx)
    count_gather_bytes(kernel, grid, ranges, K, len(chans), want_idx)
    return out


def footprint(grid: CellGrid, level: int, centers, radii, S: int):
    """Each ball's slab-slot footprint at ``level``: the capacity K that
    gathers it whole (slab_ranges' total)."""
    if not isinstance(grid, CellGrid):
        return grid.footprint(level, centers, radii, S)
    return slab_ranges(grid, level, centers, radii, radii * radii, S,
                       grid.chunk)[0][3]


# unsorted_gather's position channels: payload rows 0-2 read at the
# source rows after the kernel (0 off-ball), on the grid that holds them
POSITION = ("x", "y", "z")


def unsorted_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                    K: int, S: int, chans: tuple = (), want_idx: bool = False,
                    layer: str | None = None):
    """(d2, channels, idx, overflow) in the kernels' slot order, no row
    sort: K1 for K <= PIECE_K_MIN, else K3. ``chans`` are kernel channel
    names (slab_gather.CHANNEL_ROWS) or POSITION's, which each shard of a
    sharded grid resolves from its own rows. ``layer`` opens the spans
    "<layer>.ranges" (cell_ranges and the descriptors) and
    "<layer>.gather" (the launch; the whole merged gather on a sharded
    grid)."""
    span = _spans(layer)
    if not isinstance(grid, CellGrid):
        with span("gather"):
            return grid.unsorted_gather(level, centers, radii, r2_mask, K, S,
                                        chans, want_idx)
    kernel = _slotted_kernel(K)
    with span("ranges"):
        ranges, desc = slab_ranges(grid, level, centers, radii, r2_mask, S,
                                   grid.chunk, K, kernel)
    kchans = tuple(c for c in chans if c not in POSITION)
    with span("gather"):
        d2, ch, idx = _slotted(grid, ranges, kernel, desc, centers, r2_mask,
                               K, kchans, want_idx or len(kchans) < len(chans))
        if len(kchans) < len(chans):
            kcols = iter(ch.unbind(1))
            ch = torch.stack([grid.row_values(idx, POSITION.index(c))
                              if c in POSITION else next(kcols)
                              for c in chans], dim=1)
            idx = idx if want_idx else None
    return d2, ch, idx, ranges[3] > K


class SlabGatherResult(NamedTuple):
    d2: torch.Tensor          # (B, W) sorted ascending; +inf beyond n_in
    channels: tuple           # requested channels, sorted alongside d2
    n_in: torch.Tensor        # (B,) i64 hits with d2 <= r2_mask
    overflow: torch.Tensor    # (B,) bool candidate footprint exceeded K


def slab_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                K: int, S: int, channels: tuple = ("mass",),
                layer: str | None = None) -> SlabGatherResult:
    """Sorted (d2, channel...) stacks per halo: K1's sorted form up to
    SORTED_K_MAX slots, in rows of W = K slots; else the slotted gather and
    the sort of its in-ball slots (slab_gather.sort_in_ball), in rows of
    W <= K slots, the least power of two that holds the widest ball.
    Either way the first n_in slots of a row are in the stable sort's
    order over the kernels' slot layout, on the card and on the CPU, and
    the rest are pads; callers read W from the rows.

    ``channels`` is drawn from {"mass", "mv", "meta", "idx", "orig"}: "mv"
    gives a (B, W, 3) m*v stack, "idx" the exact int32 source row (-1
    off-ball), "orig" the source particle's int64 index in file order (-1
    off-ball; each shard of a sharded grid resolves it from its own rows).
    ``layer`` opens the spans "<layer>.ranges" (cell_ranges and the
    descriptors), "<layer>.gather" (the launch; the whole merged gather on
    a sharded grid) and "<layer>.sort" (sort_in_ball, where it runs).
    """
    span = _spans(layer)
    if not isinstance(grid, CellGrid):
        with span("gather"):
            return grid.slab_gather(level, centers, radii, r2_mask, K, S,
                                    channels)
    kernel_chans = []
    for ch in channels:
        if ch == "mv":
            kernel_chans.extend(["mvx", "mvy", "mvz"])
        elif ch in ("mass", "meta"):
            kernel_chans.append(ch)
        elif ch not in ("idx", "orig"):
            raise ValueError(ch)
    kernel_chans = tuple(kernel_chans)
    want_idx = "idx" in channels or "orig" in channels
    in_sorted_form = K <= min(SORTED_K_MAX, PIECE_K_MIN)  # K3's stay K3's
    kernel = "K1" if in_sorted_form else _slotted_kernel(K)
    with span("ranges"):
        ranges, desc = slab_ranges(grid, level, centers, radii, r2_mask, S,
                                   grid.chunk, K, kernel)
    if in_sorted_form:
        with span("gather"):
            d2_s, ch, idx, n_in = slab_gather_sorted_rows(
                grid.soa8t, *desc, centers, grid.period, r2_mask, K,
                grid.chunk, kernel_chans, want_idx)
            count_gather_bytes("K1", grid, ranges, K, len(kernel_chans),
                               want_idx, sorted_form=True)
    else:
        with span("gather"):
            rows = _slotted(grid, ranges, kernel, desc, centers, r2_mask, K,
                            kernel_chans, want_idx)
        with span("sort"):
            d2_s, ch, idx, n_in = sort_in_ball(*rows)
    out = []
    i = 0
    for c in channels:
        if c == "idx":
            out.append(idx)
        elif c == "orig":
            out.append(grid.file_rows(idx))
        elif c == "mv":
            out.append(torch.stack(ch[i:i + 3], dim=-1))
            i += 3
        else:
            out.append(ch[i])
            i += 1
    return SlabGatherResult(d2=d2_s, channels=tuple(out), n_in=n_in,
                            overflow=ranges[3] > K)
