"""Kernel K1 — the slab gather (port of so_tpu/ops/pallas_gather.py).

A ball's candidates are contiguous slabs of the Morton-sorted payload (one
per intersecting cell, pre-merged into maximal runs by
gather.cell_ranges). chunk_descriptors (the plain version of what
ops/ranges.slab_ranges writes on the card) cuts each halo's runs into
CHUNK-aligned pieces laid out densely: chunk t reads payload columns
[a0_t + t*CHUNK, +CHUNK) and fills output slots [t*CHUNK, (t+1)*CHUNK),
masking rows outside the run's [lo_t, hi_t).

The kernel has two forms (csrc/slab_gather.cu), each with its wrapper and
its plain torch version here. A CUDA payload launches the kernel, a CPU
payload runs the plain version; nothing on a CUDA payload gives way to the
plain version.

``slab_gather_rows`` (plain: ``slab_gather_plain``, a vectorized torch walk
over (B, NC, CHUNK) source rows) is the slotted form: d2 (B, K) f32 (+inf
on pad / out-of-ball slots), channels (B, nchan, K) f32 in the requested
order (0 off-ball), and the source row idx (B, K) i32 (-1 off-ball) when
asked for.

``slab_gather_sorted_rows`` (plain: ``slab_gather_sorted_plain``, the
slotted plain version, a stable row sort and the gathers) is the sorted
form: each row already sorted by d2, ties in slot order, with the in-ball
count: d2 (B, K) ascending with +inf from n_in on, a list of (B, K)
channels and idx permuted alongside (0 and -1 from n_in on), and n_in (B,)
i64. On the card a row's keys must fit one block's shared memory (K <=
2^14, else the launch fails; ops/gather.SORTED_K_MAX routes by it).

Longer rows are gathered slotted and sorted by ``sort_in_ball``: the
sorted form's order over the in-ball slots only, in rows as wide as the
widest ball of the dispatch.
"""

from __future__ import annotations

import torch

from ..profiling import counts
from . import _cuda

# payload row feeding each kernel channel name; rows 4-6 are raw
# velocities that the kernel multiplies by the mass row (m*v)
CHANNEL_ROWS = {"mass": 3, "mvx": 4, "mvy": 5, "mvz": 6, "meta": 7}

launches = 0          # kernel launches of both forms (CUDA only)
sorted_launches = 0   # of which the sorted form's


def chunk_descriptors(st, cnt, q, K: int, chunk: int):
    """Cut merged slab runs (B, C) into dense chunk descriptors.

    Returns per (halo, chunk t < NC) a0 (source column = a0 + t*chunk),
    lo/hi (valid source-row range) and the per-halo chunk count n_total,
    all int32 and contiguous, as the kernels read them (payload rows fit
    int32, check_inputs). Chunks at or beyond n_total hold garbage that is
    never read. Run offsets q at or past NC chunks are dropped (the JAX
    scatter-add's mode="drop"): they land in a spill column cut off
    before the prefix sum.
    """
    B, C = st.shape
    NC = (K + chunk) // chunk
    i32 = torch.int32
    off = st % chunk
    nchunk = torch.where(cnt > 0, (off + cnt + (chunk - 1)) // chunk,
                         torch.zeros_like(cnt))
    qc = torch.clamp(q // chunk, max=NC)          # NC = the spill column
    n_total = torch.clamp(nchunk.sum(dim=1, dtype=i32), max=NC)
    # the three piecewise-constant per-run values, expanded to chunk slots
    # together: differences scattered to each run's first chunk, then a
    # prefix sum. The int64 run values are narrowed as they are written.
    vals = torch.stack([st - off - qc * chunk, st, st + cnt])   # (3, B, C)
    diffs = torch.empty((3, B, C), dtype=i32, device=st.device)
    diffs[:, :, :1] = vals[:, :, :1]
    torch.sub(vals[:, :, 1:], vals[:, :, :-1], out=diffs[:, :, 1:])
    arr = torch.zeros((3, B, NC + 1), dtype=i32, device=st.device)
    arr.scatter_add_(2, qc.expand(3, B, C), diffs)
    a0, lo, hi = torch.cumsum(arr[:, :, :NC], dim=2, dtype=i32).unbind(0)
    return a0, lo, hi, n_total


def channel_codes(chans: tuple) -> list:
    if len(chans) > 5:
        raise ValueError(f"at most 5 float channels, got {chans}")
    return [CHANNEL_ROWS[c] for c in chans]


def row_fields(soa8t, row, in_cell, centers, period, r2, codes: list,
               want_idx: bool):
    """Per (halo, ...) source row: d2 (+inf off-ball), the channel values
    (0 off-ball) and the row itself (-1 off-ball), with the kernels' f32
    association; torch runs each elementwise op separately, so nothing is
    contracted into FMA. ``row`` and ``in_cell`` are (B, X, Y)."""
    rc = torch.where(in_cell, row, torch.zeros_like(row))

    def d(axis):
        c = centers[:, axis, None, None]
        p = period[axis]
        x = soa8t[axis][rc]
        return (c - p * torch.round((c - x) / p)) - x

    dx, dy, dz = d(0), d(1), d(2)
    d2 = dx * dx + dy * dy + dz * dz
    in_ball = in_cell & (d2 <= r2[:, None, None])
    d2_out = torch.where(in_ball, d2, torch.full_like(d2, torch.inf))
    zero = torch.zeros_like(d2)
    vals = []
    for code in codes:
        v = soa8t[code][rc]
        if 4 <= code <= 6:
            v = soa8t[3][rc] * v
        vals.append(torch.where(in_ball, v, zero))
    idx = (torch.where(in_ball, row, torch.full_like(row, -1)).to(torch.int32)
           if want_idx else None)
    return d2_out, vals, idx


def slab_gather_plain(soa8t, a0, lo, hi, n_total, centers, period, r2,
                      K: int, chunk: int, chans: tuple = (),
                      want_idx: bool = False):
    """The kernel's computation in plain torch: every (halo, chunk, lane)
    source row at once (row_fields), laid out in the dense slots."""
    codes = channel_codes(chans)
    B, NC = a0.shape
    dev = soa8t.device
    lane = torch.arange(chunk, device=dev)
    t = torch.arange(NC, device=dev)
    row = a0[:, :, None] + (t * chunk)[None, :, None] + lane   # (B, NC, ch)
    in_cell = ((t[None, :] < n_total[:, None])[:, :, None]
               & (row >= lo[:, :, None]) & (row < hi[:, :, None]))
    d2, vals, idx = row_fields(soa8t, row, in_cell, centers, period, r2,
                               codes, want_idx)

    def slots(v):                       # (B, NC, chunk) -> (B, K)
        return v.reshape(B, NC * chunk)[:, :K]

    ch = (torch.stack([slots(v) for v in vals], dim=1) if vals
          else torch.zeros((B, 0, K), dtype=torch.float32, device=dev))
    return slots(d2), ch, None if idx is None else slots(idx)


def sort_rows(d2, ch, idx):
    """A stable row sort of the slotted output by d2: (d2 (B, K) ascending,
    the list of (B, K) channels and idx permuted alongside, n_in (B,) i64,
    the count of finite d2).

    Stable: tie order at equal d2 is free in the reference (its NR sort is
    unstable, docs/PARITY.md #3), and a stable sort over the kernel's
    deterministic slot layout makes the CPU and GPU runs of this port
    agree at ties as well."""
    n_in = torch.isfinite(d2).sum(dim=1)
    d2_s, order = torch.sort(d2, dim=1, stable=True)
    chans = [torch.gather(ch[:, i], 1, order) for i in range(ch.shape[1])]
    return (d2_s, chans, None if idx is None else torch.gather(idx, 1, order),
            n_in)


def sort_in_ball(d2, ch, idx):
    """sort_rows' rows over the in-ball slots only, in rows as wide as the
    widest ball: (d2 (B, W) ascending with +inf from n_in on, the list of
    (B, W) channels and idx (0 and -1 from n_in on), n_in (B,) i64), W the
    least power of two >= max n_in, at least 1 and at most K.

    The in-ball slots are compacted in slot order and keyed row << 32 |
    d2 bits (a finite d2 is >= +0, so its int32 bits order as its value);
    one stable sort of the keys keeps equal d2 of a row in slot order, so
    every row's first n_in entries are sort_rows' bit for bit. The total
    and the largest n_in, which size the compaction and the rows, are the
    one host read. Counts sort.slots (B * K) and sort.keys (the in-ball
    slots sorted)."""
    B, K = d2.shape
    dev = d2.device
    # off-ball slots hold +inf, and an int32 mask sums with no cast
    in_ball = torch.lt(d2, torch.inf, out=torch.empty(d2.shape,
                                                      dtype=torch.int32,
                                                      device=dev))
    n_in = in_ball.sum(dim=1, dtype=torch.int32).long()
    total, n_max = torch.stack([n_in.sum(), n_in.max()]).tolist()
    counts[("sort.slots",)] += B * K
    counts[("sort.keys",)] += total
    W = min(K, 1 << max(n_max - 1, 0).bit_length())
    src = torch.nonzero_static(in_ball.view(-1), size=total).view(-1)
    row = torch.div(src, K, rounding_mode="floor")
    slot = src - row * K
    key = (row << 32) | d2[row, slot].view(torch.int32).long()
    key, order = torch.sort(key, stable=True)
    row, slot = key >> 32, slot[order]
    start = torch.cumsum(n_in, 0) - n_in
    col = torch.arange(total, device=dev) - start[row]
    d2_s = torch.full((B, W), torch.inf, device=dev)
    d2_s[row, col] = (key & 0xFFFFFFFF).int().view(torch.float32)
    ch_s = torch.zeros((ch.shape[1], B, W), device=dev)
    ch_s[:, row, col] = ch[row, :, slot].T
    idx_s = None
    if idx is not None:
        idx_s = torch.full((B, W), -1, dtype=idx.dtype, device=dev)
        idx_s[row, col] = idx[row, slot]
    return d2_s, list(ch_s.unbind(0)), idx_s, n_in


def slab_gather_sorted_plain(soa8t, a0, lo, hi, n_total, centers, period, r2,
                             K: int, chunk: int, chans: tuple = (),
                             want_idx: bool = False):
    """The sorted kernel's computation in plain torch: the slotted plain
    version, then sort_rows."""
    return sort_rows(*slab_gather_plain(soa8t, a0, lo, hi, n_total, centers,
                                        period, r2, K, chunk, chans,
                                        want_idx))


def check_inputs(name: str, soa8t, B: int, chunk: int, tensors) -> None:
    """The checks K1 and K3 share: payload layout, halo count, chunk, and
    every input on the payload's device."""
    if soa8t.dtype != torch.float32 or soa8t.dim() != 2 \
            or soa8t.shape[0] != 8 or not soa8t.is_contiguous():
        raise ValueError("soa8t must be a contiguous (8, Np) f32 tensor")
    if soa8t.shape[1] >= 2 ** 31:
        raise ValueError("payload rows must fit int32")
    if not 0 < B <= 65535 or chunk > 1024:
        raise ValueError(f"{name} takes 1..65535 halos and chunk <= 1024, "
                         f"got B={B}, chunk={chunk}")
    if any(x.device != soa8t.device for x in tensors):
        raise ValueError(f"{name} inputs must all lie on the payload's "
                         "device")


def _check_k1(soa8t, a0, lo, hi, n_total, centers, period, r2, K: int,
              chunk: int) -> None:
    """What both forms of K1 take: chunk_descriptors' int32 descriptors and
    f32 centers, period and r2, all contiguous (the kernels read them as
    they are; nothing is converted)."""
    B, NC = a0.shape
    ints, flts = (a0, lo, hi, n_total), (centers, period, r2)
    check_inputs("K1", soa8t, B, chunk, ints + flts)
    if (lo.shape != (B, NC) or hi.shape != (B, NC) or n_total.shape != (B,)
            or centers.shape != (B, 3) or period.shape != (3,)
            or r2.shape != (B,) or not 0 < K <= NC * chunk):
        raise ValueError("K1 inputs disagree in shape (see "
                         "chunk_descriptors)")
    if (any(x.dtype != torch.int32 for x in ints)
            or any(x.dtype != torch.float32 for x in flts)
            or not all(x.is_contiguous() for x in ints + flts)):
        raise ValueError("K1 takes contiguous int32 descriptors (see "
                         "chunk_descriptors) and contiguous f32 centers, "
                         "period and r2")


def _launch_args(soa8t, a0, lo, hi, n_total, centers, period, r2, K: int,
                 chunk: int, codes: list):
    """The C entry points' common leading arguments."""
    return (soa8t.data_ptr(), soa8t.shape[1], a0.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), n_total.data_ptr(), a0.shape[1],
            centers.data_ptr(), period.data_ptr(), r2.data_ptr(),
            a0.shape[0], K, chunk, len(codes), *codes,
            *([0] * (5 - len(codes))))


def slab_gather_rows(soa8t, a0, lo, hi, n_total, centers, period, r2,
                     K: int, chunk: int, chans: tuple = (),
                     want_idx: bool = False):
    """K1's slotted form on the payload's device: the CUDA kernel for a
    CUDA payload, the plain torch version for a CPU one. Returns (d2,
    channels, idx)."""
    global launches
    args = (soa8t, a0, lo, hi, n_total, centers, period, r2, K, chunk)
    codes = channel_codes(chans)
    _check_k1(*args)
    if soa8t.device.type == "cpu":
        return slab_gather_plain(*args, chans, want_idx)
    if soa8t.device.type != "cuda":
        raise ValueError(f"no slab gather for device {soa8t.device}")
    B, dev = a0.shape[0], soa8t.device
    out = torch.empty((B, 1 + len(codes), K), dtype=torch.float32, device=dev)
    idx = (torch.empty((B, K), dtype=torch.int32, device=dev) if want_idx
           else None)
    _cuda.launch(dev, "so_slab_gather", *_launch_args(*args, codes),
                 out.data_ptr(), idx.data_ptr() if want_idx else None)
    launches += 1
    return out[:, 0], out[:, 1:], idx


def sorted_threads(K: int) -> int:
    """Block size of the sorted kernel: a block holds 8 B x K of shared
    memory, so short rows leave room for several small blocks on an SM
    and long rows get a larger block (k1_study.py times the choices)."""
    return (64 if K <= 512 else 128 if K <= 1024 else 256 if K <= 4096
            else 512)


def slab_gather_sorted_rows(soa8t, a0, lo, hi, n_total, centers, period, r2,
                            K: int, chunk: int, chans: tuple = (),
                            want_idx: bool = False):
    """K1's sorted form on the payload's device: the CUDA kernel for a
    CUDA payload, the plain torch version for a CPU one. Returns (d2,
    list of channels, idx, n_in)."""
    global launches, sorted_launches
    args = (soa8t, a0, lo, hi, n_total, centers, period, r2, K, chunk)
    codes = channel_codes(chans)
    _check_k1(*args)
    if soa8t.device.type == "cpu":
        return slab_gather_sorted_plain(*args, chans, want_idx)
    if soa8t.device.type != "cuda":
        raise ValueError(f"no slab gather for device {soa8t.device}")
    B, dev = a0.shape[0], soa8t.device
    out = torch.empty((1 + len(codes), B, K), dtype=torch.float32, device=dev)
    idx = (torch.empty((B, K), dtype=torch.int32, device=dev) if want_idx
           else None)
    n_in = torch.empty((B,), dtype=torch.int64, device=dev)
    _cuda.launch(dev, "so_slab_gather_sorted", *_launch_args(*args, codes),
                 out.data_ptr(), idx.data_ptr() if want_idx else None,
                 n_in.data_ptr(), sorted_threads(K))
    launches += 1
    sorted_launches += 1
    return out[0], list(out[1:].unbind(0)), idx, n_in
