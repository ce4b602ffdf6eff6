"""A gather dispatch's cell enumeration and slab descriptors in one launch
(csrc/cell_ranges.cu), and its plain torch version.

``cell_ranges_plain`` is the enumeration in torch ops (so_tpu's
cell_ranges, op for op): the S^3 cube of level cells about each ball, the
cells the ball reaches, their slabs of the Morton-sorted rows and, with
``align`` > 1, the Morton-adjacent slabs merged into runs with
chunk-rounded footprints. ``slab_ranges`` is what the gathers call: with
``align`` > 1, that enumeration and, for a K1 or K3 launch, its
descriptors (slab_gather.chunk_descriptors, piece_gather.piece_descriptors).
A CUDA grid launches the kernel, a CPU grid runs the plain version; nothing
on a CUDA grid gives way to the plain version. Where the plain version
defines them, the kernel's (cnt, q, total) are equal everywhere, st wherever
cnt > 0, and the descriptors below each halo's n_total or n_pieces (the
kernels never read past them; past them the kernel leaves the buffers
unwritten). Its trailing (st, cnt, q) slots read (0, 0, total).

Every enumeration with ``align`` > 1 counts ``ranges.calls`` in
profiling.counts; those the kernel served count ``ranges.kernel`` too.
"""

from __future__ import annotations

import torch

from ..profiling import counts
from . import _cuda
from .grid import CellGrid, morton_encode
from .piece_gather import PIECE_W, piece_descriptors
from .slab_gather import chunk_descriptors

launches = 0          # kernel launches of slab_ranges (CUDA only)

# what a launch writes beside the ranges: the kernel's mode argument
MODES = {None: 0, "K1": 1, "K3": 2}
# the largest cell-cube side a gather enumerates: the engine picks levels
# whose cube fits it (engine/solver._pick_level_span); the kernel runs a
# thread a cell
S_MAX = 7


def cell_ranges_plain(grid: CellGrid, level: int, centers, radii, r2_mask,
                      S: int, align: int = 1):
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


def slab_ranges_plain(grid: CellGrid, level: int, centers, radii, r2_mask,
                      S: int, align: int, K: int | None = None,
                      kernel: str | None = None):
    """The kernel's computation in plain torch: cell_ranges_plain, then
    the descriptors of ``kernel``'s launch at capacity K (None: none)."""
    ranges = cell_ranges_plain(grid, level, centers, radii, r2_mask, S,
                               align)
    if kernel is None:
        return ranges, None
    cut = piece_descriptors if kernel == "K3" else chunk_descriptors
    return ranges, cut(*ranges[:3], K, grid.chunk)


def _check(grid, centers, radii, r2_mask, align, K, kernel) -> None:
    """What the kernel takes, checked on either device: f32 (B, 3) centers
    and (B,) radii and r2_mask on the grid's device; descriptors only at
    the grid's chunk and a positive capacity."""
    B = centers.shape[0]
    ts = (centers, radii, r2_mask)
    if (centers.shape != (B, 3) or radii.shape != (B,)
            or r2_mask.shape != (B,) or not 0 < B < 2 ** 31):
        raise ValueError("slab_ranges takes (B, 3) centers and (B,) radii "
                         "and r2_mask, B >= 1")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError("slab_ranges takes f32 centers, radii and r2_mask")
    if any(t.device != grid.device for t in ts):
        raise ValueError("slab_ranges inputs must lie on the grid's device")
    if align <= 1 or kernel not in MODES:
        raise ValueError(f"slab_ranges takes align > 1 and kernel None, "
                         f"'K1' or 'K3', got {align}, {kernel}")
    if kernel is not None and (align != grid.chunk or K is None or K < 1):
        raise ValueError("descriptors are cut at the grid's chunk for a "
                         "positive capacity K")


def slab_ranges(grid: CellGrid, level: int, centers, radii, r2_mask, S: int,
                align: int, K: int | None = None, kernel: str | None = None):
    """cell_ranges at ``align`` > 1 and, for ``kernel`` "K1" or "K3", the
    descriptors of that gather at capacity K: ((st, cnt, q, total),
    descriptors or None). The CUDA kernel for a CUDA grid, the plain torch
    version for a CPU one."""
    global launches
    _check(grid, centers, radii, r2_mask, align, K, kernel)
    counts[("ranges.calls",)] += 1
    dev = grid.device
    if dev.type == "cpu":
        return slab_ranges_plain(grid, level, centers, radii, r2_mask, S,
                                 align, K, kernel)
    if dev.type != "cuda":
        raise ValueError(f"no cell enumeration for device {dev}")
    if not 1 <= S <= S_MAX:
        raise ValueError(f"the kernel enumerates cubes of side 1..{S_MAX}, "
                         f"got {S}")
    B, C = centers.shape[0], S ** 3
    i64 = dict(dtype=torch.int64, device=dev)
    st, cnt, q = torch.empty((3, B, C), **i64).unbind(0)
    total = torch.empty((B,), **i64)
    nc, desc, desc_n = 0, None, None
    if kernel is not None:
        nc = (K + grid.chunk) // grid.chunk
        i32 = dict(dtype=torch.int32, device=dev)
        desc = torch.empty((5 if kernel == "K3" else 3, B, nc), **i32)
        desc_n = torch.empty((2 if kernel == "K3" else 1, B), **i32)
    c, r, r2 = (t.contiguous() for t in (centers, radii, r2_mask))
    _cuda.launch(dev, "so_cell_ranges", c.data_ptr(), r.data_ptr(),
                 r2.data_ptr(), grid.lo.data_ptr(), grid.period.data_ptr(),
                 grid.starts[level].data_ptr(), B, grid.ncell(level), S,
                 align, st.data_ptr(), cnt.data_ptr(), q.data_ptr(),
                 total.data_ptr(), MODES[kernel], nc, PIECE_W,
                 None if desc is None else desc.data_ptr(),
                 None if desc_n is None else desc_n.data_ptr())
    launches += 1
    counts[("ranges.kernel",)] += 1
    ranges = (st, cnt, q, total)
    if kernel is None:
        return ranges, None
    return ranges, (*desc.unbind(0), *desc_n.unbind(0))
