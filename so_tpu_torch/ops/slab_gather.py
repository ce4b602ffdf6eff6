"""Kernel K1 — the slab gather (port of so_tpu/ops/pallas_gather.py).

A ball's candidates are contiguous slabs of the Morton-sorted payload (one
per intersecting cell, pre-merged into maximal runs by
gather.cell_ranges). chunk_descriptors cuts each halo's runs into
CHUNK-aligned pieces laid out densely: chunk t reads payload columns
[a0_t + t*CHUNK, +CHUNK) and fills output slots [t*CHUNK, (t+1)*CHUNK),
masking rows outside the run's [lo_t, hi_t).

``slab_gather_rows`` is the wrapper: a CUDA tensor launches the kernel in
csrc/slab_gather.cu, a CPU tensor runs ``slab_gather_plain`` — the same
computation as a vectorized torch walk over (B, NC, CHUNK) source rows.

Output: d2 (B, K) f32 (+inf on pad / out-of-ball slots), channels
(B, nchan, K) f32 in the requested order (0 off-ball), and the source row
idx (B, K) i32 (-1 off-ball) when asked for.
"""

from __future__ import annotations

import torch

from . import _cuda

# payload row feeding each kernel channel name; rows 4-6 are raw
# velocities that the kernel multiplies by the mass row (m*v)
CHANNEL_ROWS = {"mass": 3, "mvx": 4, "mvy": 5, "mvz": 6, "meta": 7}

launches = 0     # kernel launches of slab_gather_rows (CUDA only)


def chunk_descriptors(st, cnt, q, K: int, chunk: int):
    """Cut merged slab runs (B, C) into dense chunk descriptors.

    Returns per (halo, chunk t < NC) a0 (source column = a0 + t*chunk),
    lo/hi (valid source-row range) and the per-halo chunk count n_total,
    all int64. Chunks at or beyond n_total hold garbage that is never
    read. Run offsets q at or past NC chunks are dropped (the JAX
    scatter-add's mode="drop"): they land in a spill column cut off
    before the prefix sum.
    """
    B, C = st.shape
    NC = (K + chunk) // chunk
    astart = (st // chunk) * chunk
    foot = torch.where(cnt > 0, ((st % chunk) + cnt + (chunk - 1))
                       // chunk * chunk, torch.zeros_like(cnt))
    qc = torch.clamp(q // chunk, max=NC)          # NC = the spill column
    n_total = torch.clamp((foot // chunk).sum(dim=1), max=NC)

    def seg_const(vals):
        """Piecewise-constant per-run value expanded to chunk slots."""
        diffs = torch.cat([vals[:, :1], vals[:, 1:] - vals[:, :-1]], dim=1)
        arr = torch.zeros((B, NC + 1), dtype=vals.dtype, device=vals.device)
        arr.scatter_add_(1, qc, diffs)
        return torch.cumsum(arr[:, :NC], dim=1)

    a0 = seg_const(astart - qc * chunk)
    lo = seg_const(st)
    hi = seg_const(st + cnt)
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


def _slab_gather_cuda(soa8t, a0, lo, hi, n_total, centers, period, r2,
                      K: int, chunk: int, chans: tuple, want_idx: bool):
    global launches
    codes = channel_codes(chans)
    B, NC = a0.shape
    dev = soa8t.device
    check_inputs("K1", soa8t, B, chunk,
                 (a0, lo, hi, n_total, centers, period, r2))
    if (lo.shape != (B, NC) or hi.shape != (B, NC) or n_total.shape != (B,)
            or centers.shape != (B, 3) or period.shape != (3,)
            or r2.shape != (B,) or not 0 < K <= NC * chunk):
        raise ValueError("K1 inputs disagree in shape (see "
                         "chunk_descriptors)")
    # The converted copies die when this returns, before the kernel may
    # have run: safe, because the caching allocator hands their memory
    # only to later work on the same stream.
    i32 = [x.to(torch.int32).contiguous() for x in (a0, lo, hi, n_total)]
    f32 = [x.to(torch.float32).contiguous() for x in (centers, period, r2)]
    nf = 1 + len(codes)
    out = torch.empty((B, nf, K), dtype=torch.float32, device=dev)
    idx = (torch.empty((B, K), dtype=torch.int32, device=dev) if want_idx
           else None)
    c = codes + [0] * (5 - len(codes))
    lib = _cuda.library()
    rc = lib.so_slab_gather(
        soa8t.data_ptr(), soa8t.shape[1], i32[0].data_ptr(),
        i32[1].data_ptr(), i32[2].data_ptr(), i32[3].data_ptr(), NC,
        f32[0].data_ptr(), f32[1].data_ptr(), f32[2].data_ptr(), B, K, chunk,
        len(codes), *c, out.data_ptr(),
        idx.data_ptr() if idx is not None else None,
        _cuda.stream_ptr(dev))
    _cuda.check(rc, "so_slab_gather")
    launches += 1
    return out[:, 0], out[:, 1:], idx


def slab_gather_rows(soa8t, a0, lo, hi, n_total, centers, period, r2,
                     K: int, chunk: int, chans: tuple = (),
                     want_idx: bool = False):
    """K1 on the payload's device: the CUDA kernel for a CUDA payload, the
    plain torch version for a CPU one. Returns (d2, channels, idx)."""
    if soa8t.device.type == "cuda":
        return _slab_gather_cuda(soa8t, a0, lo, hi, n_total, centers,
                                 period, r2, K, chunk, chans, want_idx)
    if soa8t.device.type != "cpu":
        raise ValueError(f"no slab gather for device {soa8t.device}")
    return slab_gather_plain(soa8t, a0, lo, hi, n_total, centers, period, r2,
                             K, chunk, chans, want_idx)
