#!/usr/bin/env python3
"""The measurements behind the fused pass's member-sum kernel
(so_tpu_torch/csrc/member_sums.cu), on one CUDA card. Not part of the
smoke run.

    python3 member_sums_study.py        (from the root of a checkout)

Prints the card, its power limit and SM clock, and numpy's version (the
kernel adds in member_mv_sums' order, numpy's pairwise sum). Then:
  - the cycles of one dependent __dadd_rn on one thread (clock64 around
    2^22 adds);
  - at each shape, the kernel held bit for bit to members.member_mv_sums
    over the same rows, its ms by CUDA events, and its bound: the larger
    of the bytes it must move (4 B of idx and 16 B of payload a member
    row, 12 B at a uniform mass, 24 B out a list) at 3.35 TB/s and its
    longest chain of dependent adds at the probe's cycles; beside it the
    bytes as the card moves them, a 32-byte sector for each scattered
    payload read; and member_mv_sums' own seconds on the host.
Shapes:
  - giant: six lists of 44,000,000 rows, each a random order of one run
    of 44,000,000 rows of a 150,000,000-row payload (the giant cell's
    host: its four centers and two field centers inside it);
  - box512: 65,536 lists of 20-400 rows (W 512) of a 134,217,728-row
    payload, rows at random.
"""

import ctypes
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PROBE_CU = r"""
// One thread, n dependent __dadd_rn: the chain's cycles per add.
__global__ void dadd_probe_kernel(long long n, double* sink,
                                  long long* cycles) {
  double a = sink[0];
  const double b = sink[1];
  const long long t0 = clock64();
#pragma unroll 32
  for (long long i = 0; i < n; ++i) a = __dadd_rn(a, b);
  const long long t1 = clock64();
  sink[0] = a;
  cycles[0] = t1 - t0;
}

extern "C" int dadd_probe(long long n, double* sink, long long* cycles,
                          void* stream) {
  dadd_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, sink, cycles);
  return (int)cudaGetLastError();
}
"""

# the longest chain of dependent adds the kernel runs: a leaf's 16 serial
# adds of its eight sums, 3 to join them and 7 for the rest; 5 levels of a
# cut node's tree; ~20 levels above the cut; the first term
CHAIN_ADDS = 16 + 3 + 7 + 5 + 20 + 1


def dadd_probe():
    """Cycles per dependent f64 add on one thread."""
    import torch

    import chip_smoke as cs
    from k2_study import nvcc_lib
    from so_tpu_torch.ops import _cuda

    src = _cuda.BUILD_DIR / "dadd_probe.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_CU)
    fn = nvcc_lib("dadd_probe", src).dadd_probe
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    sink = torch.tensor([1.0, 1e-17], dtype=torch.float64, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    n = 1 << 22

    def probe():
        _cuda.check(fn(n, sink.data_ptr(), cycles.data_ptr(),
                       _cuda.stream_ptr(dev)), "dadd_probe")
    ms = cs.cuda_ms(probe, 1)
    per_add = int(cycles.item()) / n
    cs.log(f"[dadd probe] {per_add:.4f} cycles per dependent add, "
           f"{ms * 1e6 / n:.4f} ns each")
    return per_add


def shape(name, n, lists, uniform, per_add, host_lists):
    """One shape: bits against member_mv_sums on ``host_lists`` of the
    lists, the kernel's ms and bound, and the host's seconds on them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from so_tpu_torch.engine.members import member_mv_sums
    from so_tpu_torch.ops import member_sums as ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + n)
    soa = torch.empty((8, n + 256), dtype=torch.float32, device=dev)
    soa.uniform_(-1.0, 1.0, generator=g)
    soa[3] = (soa[3].abs() + 0.5) / n
    if uniform:
        soa[3] = float(np.float32(1.0 / n))
    idx, counts = lists(g)
    B, W = idx.shape
    um = float(np.float32(1.0 / n)) if uniform else None
    out = ms.member_sums(soa, idx, counts, um)
    torch.cuda.synchronize()
    vel = soa[4:7, :n].T.cpu().numpy()
    mass = soa[3, :n].cpu().numpy()
    got = out.cpu().numpy()
    counts_h = counts.cpu().numpy()
    host_s = 0.0
    rows_h = 0
    for b in host_lists:
        rows = idx[b, :counts_h[b]].cpu().numpy()
        t0 = time.perf_counter()
        want = member_mv_sums((vel, mass), rows, counts_h[b:b + 1])
        host_s += time.perf_counter() - t0
        rows_h += rows.size
        if want.tobytes() != got[b:b + 1].tobytes():
            raise AssertionError(f"{name}: list {b} differs from "
                                 "member_mv_sums")
    reps = 3 if counts_h.sum() > 1e8 else 20
    t = cs.cuda_ms(lambda: ms.member_sums(soa, idx, counts, um), reps)
    rows = int(counts_h.sum())
    pay = 12 if uniform else 16
    byts = rows * (4 + pay) + 24 * B
    sectors = rows * (4 + 32 * pay // 4) + 24 * B
    hz = cs.FADD["sm_hz"]
    bound = max(byts / cs.HBM_BYTES_PER_S, CHAIN_ADDS * per_add / hz) * 1e3
    cs.log(f"[member sums] {name}: B {B}, W {W}, {rows:,} member rows, "
           f"{'uniform' if uniform else 'general'} mass: {t:.4f} ms "
           f"(bound {bound:.4f} ms: {byts:,} B; {100 * bound / t:.2f}% of "
           f"it; in sectors {sectors:,} B = "
           f"{sectors / cs.HBM_BYTES_PER_S * 1e3:.4f} ms, "
           f"{100 * sectors / cs.HBM_BYTES_PER_S * 1e3 / t:.2f}%); "
           f"host member_mv_sums {host_s:.3f} s over {rows_h:,} rows "
           f"({1e9 * host_s / max(rows_h, 1):.1f} ns a row); "
           f"bits equal on {len(host_lists)} lists")
    del soa, idx, counts, out
    torch.cuda.empty_cache()


def giant_lists(n, run, k):
    def make(g):
        import torch

        dev = torch.device("cuda")
        W = 1 << (run - 1).bit_length()
        idx = torch.full((k, W), -1, dtype=torch.int32, device=dev)
        lo = (n - run) // 2
        for b in range(k):
            idx[b, :run] = (torch.randperm(run, generator=g, device=dev)
                            + lo).to(torch.int32)
        return idx, torch.full((k,), run, dtype=torch.int64, device=dev)
    return make


def box_lists(n, B, W):
    def make(g):
        import torch

        dev = torch.device("cuda")
        counts = torch.randint(20, 401, (B,), generator=g, device=dev)
        idx = torch.randint(0, n, (B, W), generator=g, device=dev,
                            dtype=torch.int32)
        slot = torch.arange(W, device=dev)[None, :]
        idx[slot >= counts[:, None]] = -1
        return idx, counts
    return make


def main():
    import numpy as np

    import chip_smoke as cs
    from so_tpu_torch.ops import _cuda

    cs.phase_env()
    cs.log(f"[env] numpy {np.__version__}")
    _cuda.library()
    per_add = dadd_probe()
    n_box = 1 << 27
    for uniform in (False, True):
        shape("box512", n_box, box_lists(n_box, 65536, 512), uniform,
              per_add, host_lists=range(0, 65536, 4096))
    shape("giant", 150_000_000, giant_lists(150_000_000, 44_000_000, 6),
          False, per_add, host_lists=(0, 5))


if __name__ == "__main__":
    main()
