#!/usr/bin/env python3
"""The measurements behind K1's design (so_tpu_torch/csrc/slab_gather.cu),
on one CUDA card. Not part of the smoke run: it times choices the kernel
has already made, so that their readings can be taken again.

    python3 k1_study.py [--parent DIR]    (from the root of a checkout)

On chip_smoke.py's standard box (2^21 particles; shapes as in its
phase_kernels: (4096, 4096) and (16384, 512) at the first ladder rung,
(1024, 2^14) and (3, 8192) at the sixth), it prints:
  - with --parent DIR: the one-block-per-chunk K1 that this kernel
    replaced, from a checkout of commit 787f48c at DIR (for example
    `git archive 787f48c | tar -x -C DIR`), built alone with the same
    flags and called as its wrapper called it (int64 descriptors narrowed
    to int32 on every call), checked bit for bit against the slotted form
    and timed in turns (old, new, new, old), by CUDA events around the
    calls and by one CUDA graph of the calls replayed;
  - both forms built from patched copies of slab_gather.cu (written to
    so_tpu_torch/_build/) with other choices: the slotted form's slots a
    thread forced (shipped: by K), no 16-byte pad blocks, and other
    register caps (blocks of 256 threads an SM; shipped 6 for either
    form): device ms each;
  - the sorted form against the route it replaces (the slotted kernel, the
    count of finite d2, torch.sort, one gather a channel) at K = 2^9 to
    2^14, B = 2^24 / K halos (at most 16,384), with 0, 1 and 3 channels (+idx):
    the readings behind ops/gather.SORTED_K_MAX; and the sorted kernel at
    other block sizes than ops/slab_gather.sorted_threads picks;
  - the device kernels that one ops/gather.slab_gather call launches
    (torch.profiler), with the sorted form and with SORTED_K_MAX = 0.
"""

import ctypes
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OLD_COMMIT = "787f48c"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# so_slab_gather of commit 787f48c: (soa, np_cols, a0, lo, hi, n_total, nc,
# centers, period, r2, B, K, chunk, nchan, c0..c4, out, out_idx, stream)
OLD_ARGTYPES = [_P, _L, _P, _P, _P, _P, _I, _P, _P, _P, _L, _L, _I,
                _I, _I, _I, _I, _I, _I, _P, _P, _P]
# the choices slab_gather.cu ships, as its source spells them
UNROLL = "return K >= 4 * kThreads ? 4 : K >= 2 * kThreads ? 2 : 1;"
PAD_BLOCKS = "if (base >= live_end) {"
MIN_BLOCKS = ("kSlottedMinBlocks = 6;", "kSortedMinBlocks = 6;")
CHANNEL_SETS = [((), False), (("mass",), False), (("mass", "meta"), True),
                (("mass", "meta", "mvx"), True)]


def old_k1(parent):
    """The replaced kernel of the checkout at ``parent``, called as its
    wrapper called it: (payload, int64 descriptors..., K, chunk, chans,
    want_idx) -> (d2, channels, idx)."""
    import torch

    from k2_study import nvcc_lib
    from so_tpu_torch.ops import _cuda
    from so_tpu_torch.ops.slab_gather import channel_codes

    src = os.path.join(parent, "so_tpu_torch", "csrc", "slab_gather.cu")
    with open(src) as fp:
        if "dim3 grid((unsigned)nc, (unsigned)B);" not in fp.read():
            raise SystemExit(f"{src} is not the one-block-per-chunk K1 of "
                             f"commit {OLD_COMMIT}")
    fn = nvcc_lib("old_slab_gather", src).so_slab_gather
    fn.argtypes = OLD_ARGTYPES
    fn.restype = ctypes.c_int

    def call(soa8t, a0, lo, hi, n_total, centers, period, r2, K, chunk,
             chans, want_idx):
        codes = channel_codes(chans)
        B, NC = a0.shape
        i32 = [x.to(torch.int32).contiguous() for x in (a0, lo, hi, n_total)]
        f32 = [x.to(torch.float32).contiguous()
               for x in (centers, period, r2)]
        out = torch.empty((B, 1 + len(codes), K), dtype=torch.float32,
                          device=soa8t.device)
        idx = (torch.empty((B, K), dtype=torch.int32, device=soa8t.device)
               if want_idx else None)
        c = codes + [0] * (5 - len(codes))
        _cuda.check(fn(
            soa8t.data_ptr(), soa8t.shape[1], i32[0].data_ptr(),
            i32[1].data_ptr(), i32[2].data_ptr(), i32[3].data_ptr(), NC,
            f32[0].data_ptr(), f32[1].data_ptr(), f32[2].data_ptr(), B, K,
            chunk, len(codes), *c, out.data_ptr(),
            idx.data_ptr() if idx is not None else None,
            _cuda.stream_ptr(soa8t.device)), "old so_slab_gather")
        return out[:, 0], out[:, 1:], idx
    return call


def make_shapes(grid, centers, rgtp):
    """{(B, K): (descriptors, tail arguments, cnt)} on the standard box."""
    import numpy as np
    import torch

    from so_tpu_torch.engine.solver import ladder_radius, _pick_level_span
    from so_tpu_torch.ops.gather import cell_ranges
    from so_tpu_torch.ops.slab_gather import chunk_descriptors

    dev = grid.device
    shapes = {}
    for B, K, rung in [(4096, 4096, 1), (16384, 512, 1), (1024, 1 << 14, 6),
                       (3, 8192, 6), (2048, 8192, 6)]:
        radii = ladder_radius(rgtp[:B], np.full(B, rung, np.int32))
        c = torch.as_tensor(centers[:B], device=dev)
        r = torch.as_tensor(radii, device=dev)
        level, S = _pick_level_span(grid, float(radii.max()))
        st, cnt, q, total = cell_ranges(grid, level, c, r, r * r, S,
                                        align=grid.chunk)
        desc = chunk_descriptors(st, cnt, q, K, grid.chunk)
        shapes[(B, K)] = (desc, (c, grid.period, r * r, K, grid.chunk), cnt)
    return shapes


def against_parent(grid, shapes, old):
    import chip_smoke as cs
    from so_tpu_torch.ops import slab_gather

    for (B, K), (desc, tail, _) in shapes.items():
        desc64 = [d.long() for d in desc]
        for chans, want_idx in CHANNEL_SETS:
            new_a = (grid.soa8t, *desc, *tail, chans, want_idx)
            old_a = (grid.soa8t, *desc64, *tail, chans, want_idx)
            for name, a, b in zip(("d2", "channels", "idx"),
                                  slab_gather.slab_gather_rows(*new_a),
                                  old(*old_a)):
                if a is not None:
                    cs.assert_same_bits(f"K1 ({B}, {K}) {name} against the "
                                        "old kernel", a, b)
            turns = []
            for fn in (lambda: old(*old_a),
                       lambda: slab_gather.slab_gather_rows(*new_a),
                       lambda: slab_gather.slab_gather_rows(*new_a),
                       lambda: old(*old_a)):
                turns.append((cs.cuda_ms(fn, 20), cs.graph_ms(fn, 20)))
            o = [(turns[0][i] + turns[3][i]) / 2 for i in (0, 1)]
            n = [(turns[1][i] + turns[2][i]) / 2 for i in (0, 1)]
            cs.log(f"[parent] ({B}, {K}) nch={len(chans)} "
                   f"idx={int(want_idx)}: old kernel {o[0]:.4f} ms (events) "
                   f"{o[1]:.4f} ms (graph), slotted form {n[0]:.4f} ms "
                   f"(events) {n[1]:.4f} ms (graph), {o[0] / n[0]:.2f}x / "
                   f"{o[1] / n[1]:.2f}x; turns (events/graph) "
                   + " ".join(f"{e:.4f}/{g:.4f}" for e, g in turns))


def variant_lib(name, edits):
    """K1 built alone from a copy of slab_gather.cu under the build
    directory with ``edits`` applied ((shipped text, other text) pairs, each
    found exactly once), its two entry points bound as the package's."""
    from k2_study import nvcc_lib
    from so_tpu_torch.ops import _cuda

    text = (_cuda.CSRC / "slab_gather.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"slab_gather.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    shutil.copy(_cuda.CSRC / "gather_body.cuh", _cuda.BUILD_DIR)
    src = _cuda.BUILD_DIR / f"k1_{name}.cu"
    src.write_text(text)
    lib = nvcc_lib(f"k1_{name}", src)
    for entry in ("so_slab_gather", "so_slab_gather_sorted"):
        fn = getattr(lib, entry)
        fn.argtypes = _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return lib


def kernel_variants(grid, shapes):
    """Both kernels rebuilt with other choices, device ms each."""
    import chip_smoke as cs
    from so_tpu_torch.ops import _cuda, slab_gather

    def blocks(n):
        return [(text, text.replace("6", str(n))) for text in MIN_BLOCKS]

    builds = [("shipped", None),
              ("1 slot", [(UNROLL, "return 1;")]),
              ("2 slots", [(UNROLL, "return 2;")]),
              ("4 slots", [(UNROLL, "return 4;")]),
              ("no pad blocks", [(PAD_BLOCKS, "if (false) {")]),
              ("4 blocks an SM", blocks(4)),
              ("8 blocks an SM", blocks(8))]
    forms = {"slotted": slab_gather.slab_gather_rows,
             "sorted": slab_gather.slab_gather_sorted_rows}
    shipped = _cuda.library()
    times = {}
    try:
        for i, (name, edits) in enumerate(builds):
            _cuda._lib = (shipped if edits is None
                          else variant_lib(f"variant{i}", edits))
            for (B, K), (desc, tail, _) in shapes.items():
                for chans, want_idx in CHANNEL_SETS[:3]:
                    a = (grid.soa8t, *desc, *tail, chans, want_idx)
                    for form, fn in forms.items():
                        if form == "sorted" and "slot" in name:
                            continue      # the slotted form's choices
                        times[(form, name, B, K, len(chans))] = cs.graph_ms(
                            lambda: fn(*a), 20)
    finally:
        _cuda._lib = shipped
    for (B, K) in shapes:
        for chans, _ in CHANNEL_SETS[:3]:
            for form in forms:
                cs.log(f"[{form}] ({B}, {K}) nch={len(chans)} device ms: "
                       + "; ".join(
                           f"{name} {times[(form, name, B, K, len(chans))]:.4f}"
                           for name, _ in builds
                           if (form, name, B, K, len(chans)) in times))


def sorted_against_unfused(grid, centers, rgtp):
    """The sorted form and the route it replaces at K = 2^12..2^14."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from so_tpu_torch.engine.solver import ladder_radius, _pick_level_span
    from so_tpu_torch.ops import slab_gather
    from so_tpu_torch.ops.gather import cell_ranges

    dev = grid.device
    pick = slab_gather.sorted_threads
    for K, rung in ((512, 1), (1 << 10, 1), (1 << 11, 1), (1 << 12, 1),
                    (1 << 12, 4), (1 << 13, 4), (1 << 13, 6), (1 << 14, 6),
                    (1 << 14, 8)):
        B = min((1 << 24) // K, centers.shape[0])
        radii = ladder_radius(rgtp[:B], np.full(B, rung, np.int32))
        c = torch.as_tensor(centers[:B], device=dev)
        r = torch.as_tensor(radii, device=dev)
        level, S = _pick_level_span(grid, float(radii.max()))
        st, cnt, q, total = cell_ranges(grid, level, c, r, r * r, S,
                                        align=grid.chunk)
        desc = slab_gather.chunk_descriptors(st, cnt, q, K, grid.chunk)
        for chans, want_idx in CHANNEL_SETS:
            a = (grid.soa8t, *desc, c, grid.period, r * r, K, grid.chunk,
                 chans, want_idx)

            def fused():
                return slab_gather.slab_gather_sorted_rows(*a)

            def unfused():
                return slab_gather.sort_rows(
                    *slab_gather.slab_gather_rows(*a))

            n_in = fused()[3]
            turns = [(cs.cuda_ms(f, 20), cs.graph_ms(f, 20))
                     for f in (unfused, fused, fused, unfused)]
            u = [(turns[0][i] + turns[3][i]) / 2 for i in (0, 1)]
            f = [(turns[1][i] + turns[2][i]) / 2 for i in (0, 1)]
            reads = cs.gather_reads(grid.soa8t.shape[1], grid.chunk, st, cnt,
                                    q, K, slab_gather.slab_gather_rows(
                                        *a[:10], (), True)[2])
            bms, by = cs.gather_bound(reads, desc[3], 3, B, K, chans,
                                      want_idx, n_in)
            threads = {}
            try:
                for t in (64, 128, 256, 512, 1024):
                    slab_gather.sorted_threads = lambda K, t=t: t
                    threads[t] = cs.graph_ms(fused, 20)
            finally:
                slab_gather.sorted_threads = pick
            cs.log(f"[fused] ({B}, {K}) rung {rung} nch={len(chans)} "
                   f"idx={int(want_idx)}: sorted form {f[0]:.4f} ms (events) "
                   f"{f[1]:.4f} ms (graph), unfused route {u[0]:.4f} ms "
                   f"(events) {u[1]:.4f} ms (graph), {u[0] / f[0]:.2f}x / "
                   f"{u[1] / f[1]:.2f}x; bound {bms:.4f} ms ({by}); mean "
                   f"n_in {float(n_in.float().mean()):.0f}, largest "
                   f"{int(n_in.max())}, {int((total > K).sum())} rows past "
                   f"K; device ms by block size (picked {pick(K)}): "
                   + " ".join(f"{t}:{ms:.4f}" for t, ms in threads.items()))


def launches_per_call(grid, centers, rgtp):
    """Device kernels of one gather.slab_gather call, by route."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from so_tpu_torch.engine.solver import ladder_radius, _pick_level_span
    from so_tpu_torch.ops import gather

    B, K = 4096, 4096
    radii = ladder_radius(rgtp[:B], np.ones(B, np.int32))
    c = torch.as_tensor(centers[:B], device=grid.device)
    r = torch.as_tensor(radii, device=grid.device)
    level, S = _pick_level_span(grid, float(radii.max()))
    kmax = gather.SORTED_K_MAX
    for channels in ((), ("mass",), ("mass", "meta", "idx")):
        counts = {}
        for route, limit in (("sorted form", kmax), ("unfused", 0)):
            gather.SORTED_K_MAX = limit
            try:
                gather.slab_gather(grid, level, c, r, r * r, K, S, channels)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    gather.slab_gather(grid, level, c, r, r * r, K, S,
                                       channels)
                    torch.cuda.synchronize()
            finally:
                gather.SORTED_K_MAX = kmax
            ev = [e for e in prof.events()
                  if str(e.device_type).endswith("CUDA")]
            if not any("slab_gather" in e.name for e in ev):
                raise AssertionError("the profile shows no K1 kernel")
            counts[route] = (len(ev), sum(e.device_time for e in ev) / 1e3)
        cs.log(f"[launches] gather.slab_gather ({B}, {K}) channels="
               f"{channels}: " + "; ".join(
                   f"{route} {n} device kernels, {ms:.4f} ms of device time"
                   for route, (n, ms) in counts.items())
               + " (cell_ranges and the descriptors included)")


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.stderr.write("k1_study.py: torch sees no CUDA device\n")
        return 2
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = os.path.abspath(sys.argv[2])
    elif len(sys.argv) > 1:
        sys.stderr.write("usage: python3 k1_study.py [--parent DIR]\n")
        return 2
    from so_tpu_torch.ops.grid import build_grid

    t0 = time.perf_counter()
    cs.phase_env()
    cs.phase_build()
    pos, mass, vel, centers, rgtp = cs.make_standard_box()
    grid = build_grid(pos, mass, vel=vel, device="cuda")
    shapes = make_shapes(grid, centers, rgtp)
    if parent:
        against_parent(grid, shapes, old_k1(parent))
    kernel_variants(grid, shapes)
    sorted_against_unfused(grid, centers, rgtp)
    launches_per_call(grid, centers, rgtp)
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
