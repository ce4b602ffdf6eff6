#!/usr/bin/env python3
"""The measurements behind K2's design (so_tpu_torch/csrc/seqsum.cu), on
one CUDA card. Not part of the smoke run: it times choices the kernel has
already made, so that their readings can be taken again.

    python3 k2_study.py [--parent DIR]    (from the root of a checkout)

Prints, at every shape of chip_smoke.py's K2 ladder:
  - the device ms (the calls replayed from one CUDA graph) of every form
    the kernel builds, each forced through ops/seqsum.rows_per_block and
    checked bit for bit against the picked one: the readings that set
    ROW_GROUPS and the switch between the forms;
  - with --parent DIR: the one-thread-per-row K2 that this kernel
    replaced, from a checkout of commit 4d16918 at DIR (for example
    `git archive 4d16918 | tar -x -C DIR`), built alone with the same
    flags, checked bit for bit against this one and timed in turns
    (old, new, new, old). Its C entry is so_seqsum_rows(x, y, B, K,
    stream); a checkout of any other commit is refused.
Then:
  - the cycles of one dependent __fadd_rn on one thread (clock64 around
    2^22 adds), against the 4 cycles that chip_smoke.py's chain bound
    takes;
  - the giant box of chip_smoke.py (general masses) run through run_so
    with K2's chains stopped at each row's in-ball count (as the callers
    pass it) and over all K slots, in turns after a warm run (counts, K,
    K, counts): solve and e2e seconds; the results must be identical.
"""

import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OLD_COMMIT = "4d16918"

PROBE_CU = r"""
// One thread, n dependent __fadd_rn: the chain's cycles per add.
__global__ void fadd_probe_kernel(long long n, float* sink,
                                  long long* cycles) {
  float a = sink[0];
  const float b = sink[1];
  const long long t0 = clock64();
#pragma unroll 32
  for (long long i = 0; i < n; ++i) a = __fadd_rn(a, b);
  const long long t1 = clock64();
  sink[0] = a;
  cycles[0] = t1 - t0;
}

extern "C" int fadd_probe(long long n, float* sink, long long* cycles,
                          void* stream) {
  fadd_probe_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(n, sink, cycles);
  return (int)cudaGetLastError();
}
"""


def nvcc_lib(name, src):
    """Compile one .cu file alone with the package's flags; the loaded
    library."""
    from so_tpu_torch.ops import _cuda

    out = _cuda.BUILD_DIR / f"{name}.so"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    r = subprocess.run([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                        str(out), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
    return ctypes.CDLL(str(out))


def old_seqsum(parent):
    """The replaced kernel of the checkout at ``parent``: (x, y) -> None."""
    from so_tpu_torch.ops import _cuda

    src = os.path.join(parent, "so_tpu_torch", "csrc", "seqsum.cu")
    with open(src) as fp:
        if "so_seqsum_rows(const float* x, float* y, long long B," \
                not in fp.read():
            raise SystemExit(f"{src} is not the one-thread-per-row K2 of "
                             f"commit {OLD_COMMIT}")
    fn = nvcc_lib("old_seqsum", src).so_seqsum_rows
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, y):
        _cuda.check(fn(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                       _cuda.stream_ptr(x.device)), "old so_seqsum_rows")
    return call


def forms(B, K, old):
    """One ladder shape: every form's device ms, and the old kernel's."""
    import torch

    import chip_smoke as cs
    from so_tpu_torch.ops import seqsum

    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    x = torch.rand((B, K), generator=torch.Generator(device=dev)
                   .manual_seed(cs.SEED + B + K), device=dev)
    want = seqsum.seq_cumsum(x)
    reps = 20 if K <= 1 << 16 else 4
    pick, times = seqsum.rows_per_block, {}
    try:
        for r in seqsum.ROW_GROUPS + ((0,) if K <= seqsum.SHORT_K else ()):
            seqsum.rows_per_block = lambda B, K, n_sm, r=r: r
            cs.assert_same_bits(f"K2 ({B}, {K}) rows {r}",
                                seqsum.seq_cumsum(x), want)
            times[r] = cs.graph_ms(lambda: seqsum.seq_cumsum(x), reps)
    finally:
        seqsum.rows_per_block = pick
    picked = pick(B, K, n_sm)
    line = (f"[forms] ({B}, {K}) device ms by rows/block: "
            + " ".join(f"{r}{'*' if r == picked else ''}:{t:.4f}"
                       for r, t in times.items())
            + f" (* picked; best {min(times, key=times.get)})")
    if old is not None:
        y = torch.empty_like(x)
        old(x, y)
        cs.assert_same_bits(f"K2 ({B}, {K}) against the old kernel", want, y)
        oreps = 2 if K >= 1 << 18 else reps
        turns = [cs.graph_ms(lambda: old(x, y), oreps),
                 cs.graph_ms(lambda: seqsum.seq_cumsum(x), reps),
                 cs.graph_ms(lambda: seqsum.seq_cumsum(x), reps),
                 cs.graph_ms(lambda: old(x, y), oreps)]
        o_ms, n_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        line += (f"; old kernel {o_ms:.4f} ms, this one {n_ms:.4f} ms "
                 f"(turns {' / '.join(f'{t:.4f}' for t in turns)}), "
                 f"{o_ms / n_ms:.2f}x")
    cs.log(line)


def fadd_probe():
    import torch

    import chip_smoke as cs
    from so_tpu_torch.ops import _cuda

    src = _cuda.BUILD_DIR / "fadd_probe.cu"
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(PROBE_CU)
    fn = nvcc_lib("fadd_probe", src).fadd_probe
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    sink = torch.tensor([1.0, 1e-7], device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    n = 1 << 22

    def probe():
        _cuda.check(fn(n, sink.data_ptr(), cycles.data_ptr(),
                       _cuda.stream_ptr(dev)), "fadd_probe")
    ms = cs.cuda_ms(probe, 1)            # the timed call is the reading
    per_add = int(cycles.item()) / n
    cs.log(f"[fadd probe] {per_add:.4f} cycles per dependent add, "
           f"{ms * 1e6 / n:.4f} ns each (SM clock while it ran ~"
           f"{per_add * n / (ms * 1e3):.0f} MHz); chip_smoke.py's chain "
           f"bound takes {cs.FADD['cycles']:g}")


def giant_chains():
    import chip_smoke as cs
    from so_tpu_torch.engine import derived, solver
    from so_tpu_torch.ops import seqsum

    giant = cs.giant_config()
    ps, catalog = cs.giant_inputs(giant, dict(giant["masses"])["general"])

    def full(x, n_valid=None):
        return seqsum.seq_cumsum(x)

    ref, _ = cs.run(ps, catalog, (), "cuda")          # warm-up
    times, turns = {"counts": [], "K": []}, []
    for mode in ("counts", "K", "K", "counts"):
        if mode == "K":
            solver.seq_cumsum = derived.seq_cumsum = full
        try:
            out, e2e = cs.run(ps, catalog, (), "cuda")
        finally:
            solver.seq_cumsum = derived.seq_cumsum = seqsum.seq_cumsum
        cs.assert_runs_equal(f"giant, chains to {mode}", out, ref, ())
        times[mode].append((out.phases["R_Delta solve"], e2e))
        turns.append(f"{mode} {times[mode][-1][0]:.4f}/{e2e:.4f}")
    (s1, e1), (s2, e2) = ([sum(t[i] for t in times[m]) / 2 for i in (0, 1)]
                          for m in ("counts", "K"))
    cs.log(f"[giant general, K2 chains] to the counts: solve {s1:.4f} s e2e "
           f"{e1:.4f} s; to K: solve {s2:.4f} s e2e {e2:.4f} s (turns, "
           f"solve/e2e: {', '.join(turns)}); stopping at the counts saves "
           f"{1 - s1 / s2:.1%} of the solve; results identical")


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.stderr.write("k2_study.py: torch sees no CUDA device\n")
        return 2
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = os.path.abspath(sys.argv[2])
    elif len(sys.argv) > 1:
        sys.stderr.write("usage: python3 k2_study.py [--parent DIR]\n")
        return 2
    t0 = time.perf_counter()
    cs.phase_env()
    cs.phase_build()
    old = old_seqsum(parent) if parent else None
    for B, K in cs.K2_LADDER:
        forms(B, K, old)
    fadd_probe()
    giant_chains()
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
