"""Batched ball gather (port of so_tpu/ops/gather.py).

  1. enumerate the S^3 cube of level-g cells covering each ball (periodic
     wrap on cell indices; offsets beyond the needed span are masked),
  2. prune cells whose min distance to the center exceeds the ball radius
     (the reference's INTERSECT role),
  3. merge Morton-adjacent cell slabs into maximal runs and lay their
     CHUNK-aligned footprints out densely (cell_ranges, align=chunk),
  4. kernel K1 computes min-image distances and channels per slot, and the
     rows are sorted by distance (slab_gather).

Capacity K and cube side S are per-dispatch values; the host escalates K
when a ball overflows, mirroring the reference's nnList regrow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .grid import CellGrid, morton_encode
from .slab_gather import chunk_descriptors, slab_gather_rows


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


class SlabGatherResult(NamedTuple):
    d2: torch.Tensor          # (B, K) sorted ascending; +inf beyond n_in
    channels: tuple           # requested channels, sorted alongside d2
    n_in: torch.Tensor        # (B,) i64 hits with d2 <= r2_mask
    overflow: torch.Tensor    # (B,) bool candidate footprint exceeded K


def slab_gather(grid: CellGrid, level: int, centers, radii, r2_mask,
                K: int, S: int, channels: tuple = ("mass",)) -> SlabGatherResult:
    """Sorted (d2, channel...) stacks per halo through kernel K1.

    ``channels`` is drawn from {"mass", "mv", "meta", "idx"}: "mv" gives a
    (B, K, 3) m*v stack, "idx" the exact int32 source row (-1 off-ball).
    """
    kernel_chans = []
    for ch in channels:
        if ch == "mv":
            kernel_chans.extend(["mvx", "mvy", "mvz"])
        elif ch in ("mass", "meta"):
            kernel_chans.append(ch)
        elif ch != "idx":
            raise ValueError(ch)
    st, cnt, q, total = cell_ranges(grid, level, centers, radii, r2_mask, S,
                                    align=grid.chunk)
    overflow = total > K
    a0, lo, hi, n_total = chunk_descriptors(st, cnt, q, K, grid.chunk)
    d2, ch, idx = slab_gather_rows(grid.soa8t, a0, lo, hi, n_total, centers,
                                   grid.period, r2_mask, K, grid.chunk,
                                   tuple(kernel_chans),
                                   want_idx="idx" in channels)
    n_in = torch.isfinite(d2).sum(dim=1)
    # Stable sort: tie order at equal d2 is free in the reference (its NR
    # sort is unstable, docs/PARITY.md #3), and a stable sort over the
    # kernel's deterministic slot layout makes the CPU and GPU runs of
    # this port agree at ties as well.
    d2_s, order = torch.sort(d2, dim=1, stable=True)
    out = []
    i = 0
    for c in channels:
        if c == "idx":
            out.append(torch.gather(idx, 1, order))
        elif c == "mv":
            out.append(torch.stack([torch.gather(ch[:, i + k], 1, order)
                                    for k in range(3)], dim=-1))
            i += 3
        else:
            out.append(torch.gather(ch[:, i], 1, order))
            i += 1
    return SlabGatherResult(d2=d2_s, channels=tuple(out), n_in=n_in,
                            overflow=overflow)
