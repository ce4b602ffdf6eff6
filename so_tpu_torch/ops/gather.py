"""Batched ball gather (port of so_tpu/ops/gather.py).

  1. enumerate the S^3 cube of level-g cells covering each ball (periodic
     wrap on cell indices; offsets beyond the needed span are masked),
  2. prune cells whose min distance to the center exceeds the ball radius
     (the reference's INTERSECT role),
  3. merge Morton-adjacent cell slabs into maximal runs and lay their
     CHUNK-aligned footprints out densely (cell_ranges, align=chunk),
  4. a kernel computes min-image distances and channels per slot
     (unsorted_gather): K1 up to PIECE_K_MIN slots, K3 above (the giant
     tiers; the same function and slot layout, so the same bits). Where
     the rows are wanted sorted by distance (slab_gather), K1's sorted
     form emits them so up to SORTED_K_MAX slots; longer rows are gathered
     slotted and sorted by torch.sort.

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

from typing import NamedTuple

import torch

from .grid import CellGrid, morton_encode
from .piece_gather import piece_descriptors, piece_gather_rows
from .slab_gather import (chunk_descriptors, slab_gather_rows,
                          slab_gather_sorted_rows, sort_rows)

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
    leading slots of each row and the trailing slots have cnt = 0.
    """
    ncg = grid.ncell(level)
    cs = grid.cell_size(level)                       # (3,)
    starts = grid.starts[level]
    B = centers.shape[0]
    dev = centers.device

    uc = centers - grid.lo
    uc = uc - torch.floor(uc / grid.period) * grid.period   # wrapped (B,3)

    r = radii[:, None]
    i_lo = torch.floor((uc - r) / cs).to(torch.int64)
    i_hi = torch.floor((uc + r) / cs).to(torch.int64)
    span = torch.clamp(i_hi - i_lo + 1, max=ncg)

    offs = torch.arange(S, dtype=torch.int64, device=dev)
    coords = i_lo[:, :, None] + offs[None, None, :]    # (B,3,S) unwrapped
    axis_ok = offs[None, None, :] < span[:, :, None]

    # per-axis min distance from the wrapped center to the cell slab, in
    # unwrapped ball coordinates (the cube is contiguous there)
    lo_edge = coords.to(torch.float32) * cs[None, :, None]
    hi_edge = lo_edge + cs[None, :, None]
    d_ax = torch.clamp(torch.maximum(lo_edge - uc[:, :, None],
                                     uc[:, :, None] - hi_edge), min=0.0)

    cw = torch.remainder(coords, ncg)                  # wrapped cell coords
    code = morton_encode(cw[:, 0, :, None, None], cw[:, 1, None, :, None],
                         cw[:, 2, None, None, :]).reshape(B, S * S * S)
    dx, dy, dz = d_ax[:, 0], d_ax[:, 1], d_ax[:, 2]
    d2min = (dx[:, :, None, None] * dx[:, :, None, None]
             + dy[:, None, :, None] * dy[:, None, :, None]
             + dz[:, None, None, :] * dz[:, None, None, :]).reshape(B, -1)
    cell_ok = (axis_ok[:, 0, :, None, None] & axis_ok[:, 1, None, :, None]
               & axis_ok[:, 2, None, None, :]).reshape(B, S * S * S)
    cell_ok = cell_ok & (d2min <= r2_mask[:, None])

    st = starts[code]
    cnt = torch.where(cell_ok, starts[code + 1] - st, torch.zeros_like(st))

    if align > 1:
        # Merge adjacent slabs: Morton-neighboring cells are contiguous in
        # the sorted rows, so sorting candidates by slab start and fusing
        # st[i+1] == st[i] + cnt[i] turns the cube into a few long runs.
        C = st.shape[1]
        big = 1 << 40
        key = torch.where(cnt > 0, st, torch.full_like(st, big))
        key_s, o = torch.sort(key, dim=1, stable=True)
        st_s = torch.gather(st, 1, o)
        cnt_s = torch.where(key_s < big, torch.gather(cnt, 1, o),
                            torch.zeros_like(st))
        prev_end = torch.cat([torch.full((B, 1), -1, dtype=torch.int64,
                                         device=dev),
                              (st_s + cnt_s)[:, :-1]], dim=1)
        is_new = (st_s != prev_end) & (key_s < big)
        csum = torch.cumsum(cnt_s, dim=1)
        pref = csum - cnt_s
        total_cnt = csum[:, -1:]
        nrun = is_new.sum(dim=1, keepdim=True)
        slotc = torch.arange(C, dtype=torch.int64, device=dev)[None, :]
        # run j's count is the difference of exclusive prefix counts at
        # consecutive run starts; compact the run starts to the front
        key2 = torch.where(is_new, slotc, torch.full_like(slotc, C))
        _, o2 = torch.sort(key2, dim=1, stable=True)
        st_m = torch.gather(st_s, 1, o2)
        pref_m = torch.gather(pref, 1, o2)
        pref_next = torch.cat([pref_m[:, 1:], total_cnt], dim=1)
        pref_next = torch.where(slotc + 1 < nrun, pref_next, total_cnt)
        cnt = torch.where(slotc < nrun, pref_next - pref_m,
                          torch.zeros_like(pref_m))
        st = st_m
        foot = torch.where(cnt > 0,
                           ((st % align) + cnt + (align - 1)) // align * align,
                           torch.zeros_like(cnt))
    else:
        foot = cnt
    q = torch.cumsum(foot, dim=1) - foot
    total = q[:, -1] + foot[:, -1]
    return st, cnt, q, total


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


def _slotted(grid: CellGrid, ranges, centers, r2_mask, K: int, chans: tuple,
             want_idx: bool):
    """(d2, channels, idx) in slot order from cell_ranges' output: K1 for
    K <= PIECE_K_MIN, else K3."""
    st, cnt, q, _ = ranges
    soa = grid.soa8t
    if K > PIECE_K_MIN:
        desc = piece_descriptors(st, cnt, q, K, grid.chunk)
        rows = piece_gather_rows
    else:
        desc = chunk_descriptors(st, cnt, q, K, grid.chunk)
        rows = slab_gather_rows
    return rows(soa, *desc, centers, grid.period, r2_mask, K, grid.chunk,
                chans, want_idx)


def footprint(grid: CellGrid, level: int, centers, radii, S: int):
    """Each ball's slab-slot footprint at ``level``: the capacity K that
    gathers it whole (cell_ranges' total)."""
    if not isinstance(grid, CellGrid):
        return grid.footprint(level, centers, radii, S)
    return cell_ranges(grid, level, centers, radii, radii * radii, S,
                       align=grid.chunk)[3]


# unsorted_gather's position channels: payload rows 0-2 read at the
# source rows after the kernel (0 off-ball), on the grid that holds them
POSITION = ("x", "y", "z")


def unsorted_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                    K: int, S: int, chans: tuple = (), want_idx: bool = False):
    """(d2, channels, idx, overflow) in the kernels' slot order, no row
    sort: K1 for K <= PIECE_K_MIN, else K3. ``chans`` are kernel channel
    names (slab_gather.CHANNEL_ROWS) or POSITION's, which each shard of a
    sharded grid resolves from its own rows."""
    if not isinstance(grid, CellGrid):
        return grid.unsorted_gather(level, centers, radii, r2_mask, K, S,
                                    chans, want_idx)
    ranges = cell_ranges(grid, level, centers, radii, r2_mask, S,
                         align=grid.chunk)
    kchans = tuple(c for c in chans if c not in POSITION)
    d2, ch, idx = _slotted(grid, ranges, centers, r2_mask, K, kchans,
                           want_idx or len(kchans) < len(chans))
    if len(kchans) < len(chans):
        kcols = iter(ch.unbind(1))
        ch = torch.stack([grid.row_values(idx, POSITION.index(c))
                          if c in POSITION else next(kcols) for c in chans],
                         dim=1)
        idx = idx if want_idx else None
    return d2, ch, idx, ranges[3] > K


class SlabGatherResult(NamedTuple):
    d2: torch.Tensor          # (B, K) sorted ascending; +inf beyond n_in
    channels: tuple           # requested channels, sorted alongside d2
    n_in: torch.Tensor        # (B,) i64 hits with d2 <= r2_mask
    overflow: torch.Tensor    # (B,) bool candidate footprint exceeded K


def slab_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                K: int, S: int, channels: tuple = ("mass",)) -> SlabGatherResult:
    """Sorted (d2, channel...) stacks per halo: K1's sorted form up to
    SORTED_K_MAX slots, else the slotted gather and a stable row sort
    (slab_gather.sort_rows). Either way the order is the stable sort's
    over the kernels' slot layout, on the card and on the CPU.

    ``channels`` is drawn from {"mass", "mv", "meta", "idx", "orig"}: "mv"
    gives a (B, K, 3) m*v stack, "idx" the exact int32 source row (-1
    off-ball), "orig" the source particle's int64 index in file order (-1
    off-ball; each shard of a sharded grid resolves it from its own rows).
    """
    if not isinstance(grid, CellGrid):
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
    ranges = cell_ranges(grid, level, centers, radii, r2_mask, S,
                         align=grid.chunk)
    if K <= min(SORTED_K_MAX, PIECE_K_MIN):    # K3's tiers stay K3's
        st, cnt, q, _ = ranges
        d2_s, ch, idx, n_in = slab_gather_sorted_rows(
            grid.soa8t, *chunk_descriptors(st, cnt, q, K, grid.chunk),
            centers, grid.period, r2_mask, K, grid.chunk, kernel_chans,
            want_idx)
    else:
        d2_s, ch, idx, n_in = sort_rows(*_slotted(
            grid, ranges, centers, r2_mask, K, kernel_chans, want_idx))
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
