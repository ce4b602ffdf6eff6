#!/usr/bin/env python3
"""The measurements behind K3's design (so_tpu_torch/csrc/piece_gather.cu),
on one CUDA card. Not part of the smoke run: it times choices the kernel
has already made, so that their readings can be taken again.

    python3 k3_study.py [--parent DIR]    (from the root of a checkout)

On chip_smoke.py's giant box (general masses) at its phase_k3 shapes (B = 8
and 64 halos about the clump, K = 2^18 and 2^21; d2 only, mass, mass +
meta + idx), it prints:
  - with --parent DIR: the K3 that this kernel replaced (a cp.async ring in
    shared memory), from a checkout of commit b709b10 at DIR (for example
    `git archive b709b10 | tar -x -C DIR`), built alone with the same
    flags and called as its wrapper called it (int64 descriptors narrowed
    to int32 on every call), checked bit for bit against this one and timed
    in turns (old, new, new, old), by CUDA events around the calls and by
    one CUDA graph of the calls replayed; K1's slotted form beside them;
  - K3 with other choices, device ms each, each checked bit for bit
    against the shipped kernel: pieces a block forced to 4, 8, 16, 32 and
    64 (shipped: ops/piece_gather.pieces_per_block, by the grid's size);
    and built from patched copies of piece_gather.cu (written to
    so_tpu_torch/_build/) with other 4-column groups a thread, other
    register caps (blocks an SM), and 4-byte loads and stores in place of
    16-byte ones;
  - once, a variant that stages each piece in shared memory with one 1-D
    bulk TMA copy a payload row (cp.async.bulk, completion counted on an
    mbarrier, two stages), the H100's form of the TPU kernel's "one DMA a
    piece": device ms, checked bit for bit;
  - the device ms of slab_gather.sort_rows (the stable row sort and its
    gathers) on K3's output at each shape: what a giant-tier dispatch of
    the solve runs after the gather;
  - every K3 dispatch of the giant box's run_so, the dense box's solve and
    -pot on the 2^18 box, recorded as the pipeline made it, timed at
    1 to 64 pieces a block (the readings behind
    ops/piece_gather.pieces_per_block), with the sums over them;
  - with --parent DIR: the giant box through run_so, both mass kinds, on
    the replaced K3 and on this one in turns, solve and e2e seconds, the
    results identical.
"""

import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OLD_COMMIT = "b709b10"
# the choices piece_gather.cu ships, as its source spells them
GROUPS = "constexpr int kGroups = 2;"
MIN_BLOCKS = "constexpr int kMinBlocks = 4;"
LOAD16 = "return __ldg(reinterpret_cast<const float4*>(p));"
VEC_OUT = "const bool vec = K % 4 == 0 && aligned16(out) && aligned16(out_idx);"
FORCED_PIECES = (4, 8, 16, 32, 64)
SWEPT_PIECES = (1, 2, 4, 8, 16, 32, 64)   # at the recorded dispatches
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# so_piece_gather as commit b709b10 declared it: (soa, np_cols, src, t0, v,
# lo, hi, n_pieces, n_chunks, np_max, centers, period, r2, B, K, chunk,
# nchan, c0..c4, out, out_idx, stream)
PARENT_ARGTYPES = [_P, _L, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _L,
                   _L, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
VARIANTS = [
    ("1 group a thread", [(GROUPS, GROUPS.replace("2", "1"))]),
    ("4 groups a thread", [(GROUPS, GROUPS.replace("2", "4"))]),
    ("2 blocks an SM", [(MIN_BLOCKS, MIN_BLOCKS.replace("4", "2"))]),
    ("6 blocks an SM", [(MIN_BLOCKS, MIN_BLOCKS.replace("4", "6"))]),
    ("8 blocks an SM", [(MIN_BLOCKS, MIN_BLOCKS.replace("4", "8"))]),
    ("4-byte access", [(LOAD16, "return make_float4(__ldg(p), __ldg(p + 1), "
                                "__ldg(p + 2), __ldg(p + 3));"),
                       (VEC_OUT, "const bool vec = false;")]),
]

# The bulk-TMA variant: each block stages its pieces, one at a time, in a
# two-stage ring of shared memory; thread 0 issues one cp.async.bulk a
# payload row a piece (x, y, z and the rows the channels read), and the
# block waits on the stage's mbarrier for the bytes. The arithmetic, the
# 4-column groups and the stores are the shipped kernel's.
TMA_CU = r"""
#include "gather_body.cuh"

using namespace so_gather;

namespace {

constexpr int kPieceW = 2;
constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxRows = 8;

struct Rows {                 // staged payload rows: 0-2 are x, y, z
  int n, payload[kMaxRows], chan[kMaxChan], mass;
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(smem(bar)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void st16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st16(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

template <bool kVec, typename T>
__device__ __forceinline__ void st4(T* p, long long s, long long K,
                                    const T (&v)[4]) {
  if (kVec) {
    st16(p + s, v);
  } else {
    for (int j = 0; j < 4; ++j)
      if (s + j < K) p[s + j] = v[j];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) piece_gather_tma_kernel(
    const float* __restrict__ soa, int np_cols, const int* __restrict__ src,
    const int* __restrict__ t0, const int* __restrict__ v,
    const int* __restrict__ lo, const int* __restrict__ hi,
    const int* __restrict__ n_pieces, const int* __restrict__ n_chunks,
    int np_max, const float* __restrict__ centers,
    const float* __restrict__ period, const float* __restrict__ r2,
    long long K, int chunk, int nchan, ChanCodes codes, Rows rows, int ppb,
    float* __restrict__ out, int* __restrict__ out_idx) {
  extern __shared__ __align__(128) float stage[];  // kStages x rows x pw
  __shared__ __align__(8) unsigned long long bar[kStages];
  const long long b = blockIdx.y;
  const int u0 = blockIdx.x * ppb;
  const int pw = kPieceW * chunk;
  float* o = out + b * (1 + nchan) * K;
  int* oi = out_idx != nullptr ? out_idx + b * K : nullptr;
  const long long c0 = max((long long)u0 * kPieceW, (long long)n_chunks[b]);
  const long long s_end = min((long long)(u0 + ppb) * pw, K);
  if (c0 * chunk < s_end)
    fill_pad(o, K, nchan, oi, c0 * chunk, s_end, kVec, threadIdx.x,
             kThreads);
  const int n = min(ppb, n_pieces[b] - u0);
  if (n <= 0) return;
  const long long d0 = b * np_max + u0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem(&bar[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int i) {         // thread 0: piece i -> stage i % kStages
    const int s = i % kStages;
    const unsigned bytes = (unsigned)(v[d0 + i] * chunk) * 4u;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem(&bar[s])), "r"(bytes * rows.n) : "memory");
    for (int r = 0; r < rows.n && bytes > 0; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem(stage + (s * rows.n + r) * pw)),
             "l"((unsigned long long)(soa + (long long)rows.payload[r] *
                                          np_cols + src[d0 + i])),
             "r"(bytes), "r"(smem(&bar[s])) : "memory");
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < kStages && i < n; ++i) issue(i);
  const Ball h = load_ball(centers, period, r2, b);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const long long t_wait = clock64();  // a lost copy traps, never hangs
    while (!mbar_try_wait(&bar[s], (unsigned)(i / kStages) & 1u))
      if (clock64() - t_wait > (1LL << 32)) __trap();
    const float* st = stage + s * rows.n * pw;
    const int sr = src[d0 + i], rl = lo[d0 + i];
    const int rh = min(hi[d0 + i], np_cols);
    const long long slot0 = (long long)t0[d0 + i] * chunk;
    const int ncol = v[d0 + i] * chunk;
    for (int col = 4 * threadIdx.x; col < ncol; col += 4 * kThreads) {
      const long long sl = slot0 + col;
      if (sl >= K) break;
      float d2v[4];
      int idx[4];
      unsigned m = 0;
      for (int j = 0; j < 4; ++j) {
        const int r = sr + col + j;
        d2v[j] = INFINITY;
        idx[j] = -1;
        if (r >= rl && r < rh) {
          const float d2 = min_image_d2(h, st[col + j], st[pw + col + j],
                                        st[2 * pw + col + j]);
          if (d2 <= h.r2) {
            d2v[j] = d2;
            idx[j] = r;
            m |= 1u << j;
          }
        }
      }
      st4<kVec>(o, sl, K, d2v);
      for (int c = 0; c < nchan; ++c) {
        float val[4] = {0.f, 0.f, 0.f, 0.f};
        for (int j = 0; j < 4; ++j)
          if (m & (1u << j))
            val[j] = channel_value(
                codes.c[c],
                rows.mass >= 0 ? st[rows.mass * pw + col + j] : 0.f,
                st[rows.chan[c] * pw + col + j]);
        st4<kVec>(o + (long long)(c + 1) * K, sl, K, val);
      }
      if (oi != nullptr) st4<kVec>(oi, sl, K, idx);
    }
    __syncthreads();                  // stage s is read: refill it
    if (threadIdx.x == 0 && i + kStages < n) issue(i + kStages);
  }
}

}  // namespace

extern "C" int so_piece_gather(
    const float* soa, long long np_cols, const int* src, const int* t0,
    const int* v, const int* lo, const int* hi, const int* n_pieces,
    const int* n_chunks, int np_max, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, int ppb, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || B > 65535 || K <= 0 ||
      chunk % 4 != 0 || np_cols % 4 != 0 || !aligned16(soa) || ppb <= 0)
    return (int)cudaErrorInvalidValue;
  const ChanCodes codes = {{c0, c1, c2, c3, c4}};
  Rows rows = {};
  int at[kMaxRows];
  for (int r = 0; r < kMaxRows; ++r) at[r] = r < 3 ? r : -1;
  rows.n = 3;
  rows.mass = -1;
  for (int r = 0; r < 3; ++r) rows.payload[r] = r;
  auto staged = [&](int p) {
    if (at[p] < 0) {
      at[p] = rows.n;
      rows.payload[rows.n++] = p;
    }
    return at[p];
  };
  for (int c = 0; c < nchan; ++c) {
    rows.chan[c] = staged(codes.c[c]);
    if (codes.c[c] >= 4 && codes.c[c] <= 6) rows.mass = staged(3);
  }
  const int smem_bytes = kStages * rows.n * kPieceW * chunk * 4;
  const bool vec = K % 4 == 0 && aligned16(out) && aligned16(out_idx);
  auto kernel = vec ? piece_gather_tma_kernel<true>
                    : piece_gather_tma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((np_max + ppb - 1) / ppb), (unsigned)B);
  kernel<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      soa, (int)np_cols, src, t0, v, lo, hi, n_pieces, n_chunks, np_max,
      centers, period, r2, K, chunk, nchan, codes, rows, ppb, out, out_idx);
  return (int)cudaGetLastError();
}
"""


def build_all(named_sources):
    """Compile each (name, .cu path) alone with the package's flags, all
    nvcc processes started together; {name: loaded library, its so_piece_
    gather bound as the package binds it}."""
    import chip_smoke as cs
    from so_tpu_torch.ops import _cuda

    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in named_sources:
        out = _cuda.BUILD_DIR / f"k3_{name}.so"
        procs[name] = (out, src, subprocess.Popen(
            [_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, src, p) in procs.items():
        text = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        info = [ln.strip().split("Used")[-1].strip()
                for ln in text.splitlines()
                if "Used" in ln or ("spill stores" in ln and
                                    "0 bytes spill stores, 0 bytes spill "
                                    "loads" not in ln)]
        cs.log(f"[build] {name}: ptxas " + "; ".join(info))
        lib = ctypes.CDLL(str(out))
        lib.so_piece_gather.argtypes = (
            PARENT_ARGTYPES if name == "parent"
            else _cuda._SIGNATURES["so_piece_gather"])
        lib.so_piece_gather.restype = ctypes.c_int
        libs[name] = lib
    return libs


def sources(parent):
    """(name, path) of every kernel to build: the shipped source, its
    patched copies, the bulk-TMA variant, and the parent's K3."""
    import shutil

    from so_tpu_torch.ops import _cuda

    text = (_cuda.CSRC / "piece_gather.cu").read_text()
    shutil.copy(_cuda.CSRC / "gather_body.cuh", _cuda.BUILD_DIR)
    out = [("shipped", _cuda.CSRC / "piece_gather.cu")]
    for i, (name, edits) in enumerate(VARIANTS):
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise SystemExit(f"piece_gather.cu no longer holds {old!r} "
                                 "once")
            t = t.replace(old, new)
        path = _cuda.BUILD_DIR / f"k3_variant{i}.cu"
        path.write_text(t)
        out.append((name, path))
    path = _cuda.BUILD_DIR / "k3_bulk_tma.cu"
    path.write_text(TMA_CU)
    out.append(("bulk TMA", path))
    if parent:
        src = os.path.join(parent, "so_tpu_torch", "csrc", "piece_gather.cu")
        with open(src) as fp:
            if "__pipeline_memcpy_async" not in fp.read():
                raise SystemExit(f"{src} is not the cp.async-ring K3 of "
                                 f"commit {OLD_COMMIT}")
        out.append(("parent", src))
    return out


def caller(lib=None, pieces=None):
    """piece_gather_rows launching the so_piece_gather of ``lib`` (None: the
    package's library) at ``pieces`` pieces a block (None: its
    pieces_per_block's pick)."""
    from so_tpu_torch.ops import _cuda, piece_gather

    def call(*args):
        saved = _cuda.library, piece_gather.pieces_per_block
        if lib is not None:
            _cuda.library = lambda: lib
        if pieces is not None:
            piece_gather.pieces_per_block = lambda B, NP, n_sm: pieces
        try:
            return piece_gather.piece_gather_rows(*args)
        finally:
            _cuda.library, piece_gather.pieces_per_block = saved
    return call


def parent_caller(lib):
    """The replaced kernel called as its wrapper (commit b709b10) called it:
    int64 descriptors narrowed to int32 on every call, no pieces a block."""
    import torch

    from so_tpu_torch.ops import _cuda
    from so_tpu_torch.ops.slab_gather import channel_codes

    def call(soa8t, src, t0, v, lo, hi, n_pieces, n_chunks, centers, period,
             r2, K, chunk, chans, want_idx):
        codes = channel_codes(chans)
        B, NP = src.shape
        dev = soa8t.device
        i32 = [x.to(torch.int32).contiguous()
               for x in (src, t0, v, lo, hi, n_pieces, n_chunks)]
        f32 = [x.to(torch.float32).contiguous() for x in (centers, period, r2)]
        out = torch.empty((B, 1 + len(codes), K), dtype=torch.float32,
                          device=dev)
        idx = (torch.empty((B, K), dtype=torch.int32, device=dev)
               if want_idx else None)
        _cuda.check(lib.so_piece_gather(
            soa8t.data_ptr(), soa8t.shape[1], *(x.data_ptr() for x in i32),
            NP, *(x.data_ptr() for x in f32), B, K, chunk, len(codes), *codes,
            *([0] * (5 - len(codes))), out.data_ptr(),
            idx.data_ptr() if want_idx else None, _cuda.stream_ptr(dev)),
            "so_piece_gather")
        return out[:, 0], out[:, 1:], idx
    return call


def parent_descriptors(parent):
    """piece_descriptors of the checkout at ``parent`` (int64, five
    expansions), loaded from its source beside this package's modules."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "so_tpu_torch.ops._parent_piece_gather",
        os.path.join(parent, "so_tpu_torch", "ops", "piece_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.piece_descriptors


def record_dispatches(giant):
    """Every K3 dispatch of the traffic the smoke's main path gives K3: the
    giant box through run_so (both mass kinds), the dense box's solve (both
    mass kinds, survey pass off and forced) and -pot on the 2^18 box.
    [(source, piece_gather_rows' arguments)], the tensors but the payload
    cloned."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from so_tpu_torch.engine.solver import solve_rvir
    from so_tpu_torch.io.tipsy import DARK, GAS, STAR
    from so_tpu_torch.ops import gather
    from so_tpu_torch.ops.grid import build_grid

    seen, source, real = [], [""], gather.piece_gather_rows

    def record(soa8t, *rest):
        seen.append((source[0], (soa8t, *(x.clone() if torch.is_tensor(x)
                                          else x for x in rest))))
        return real(soa8t, *rest)

    gather.piece_gather_rows = record
    try:
        for tag, mass in giant["masses"]:
            source[0] = f"giant {tag}"
            cs.run(*cs.giant_inputs(giant, mass), (), "cuda")
        pos, masses, centers, rgtp = cs.make_dense_box()
        for tag, mass in masses:
            grid = build_grid(pos, mass, device="cuda")
            for mode, survey in (("off", False), ("forced", True)):
                source[0] = f"dense {tag}, survey {mode}"
                solve_rvir(grid, centers, rgtp, cs.THR, survey=survey)
        source[0] = "2^18 box -pot"          # as phase_pot's card run
        sp = (DARK, GAS, STAR)
        small = cs.make_box(np.random.default_rng(cs.SEED), 1 << 18, 2048)
        cs.run(*cs.particles_and_catalog(small, sp, cs.SEED + 7), sp, "cuda",
               b_pot=True)
    finally:
        gather.piece_gather_rows = real
    return seen


def dispatch_sweep(lib, dispatches):
    """Each recorded dispatch at every SWEPT_PIECES pieces a block, on the
    kernel of ``lib``: device ms (a CUDA graph of 20 calls, in turns
    ascending then descending, the mean of the two), each output bit for
    bit equal to the shipped pick's; beside each, the grid's blocks and
    those holding a live piece. Then, summed over the dispatches: each
    fixed pick, the shipped rule's and the best per dispatch."""
    import torch

    import chip_smoke as cs
    from so_tpu_torch.ops import piece_gather

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    sums = {p: 0.0 for p in ("shipped", "best", *SWEPT_PIECES)}
    for source, args in dispatches:
        B, NP = args[1].shape
        n_pieces, K, chans, want_idx = args[6], args[11], args[13], args[14]
        calls = {p: caller(lib, p) for p in SWEPT_PIECES}
        want = caller(lib)(*args)
        for p, fn in calls.items():
            for field, a, b in zip(("d2", "channels", "idx"), fn(*args),
                                   want):
                if b is not None:
                    cs.assert_same_bits(f"K3 {source} {p} pieces {field}", a,
                                        b)
        del want
        ms = {p: 0.0 for p in SWEPT_PIECES}
        for p in SWEPT_PIECES + SWEPT_PIECES[::-1]:
            ms[p] += cs.graph_ms(lambda: calls[p](*args), 20) / 2
        pick = piece_gather.pieces_per_block(B, NP, n_sm)
        best = min(ms, key=ms.get)
        for p in SWEPT_PIECES:
            sums[p] += ms[p]
        sums["shipped"] += ms[pick]
        sums["best"] += ms[best]
        cs.log(f"[dispatch] {source}: (B={B}, K={K}) nch={len(chans)} "
               f"idx={int(want_idx)}, live pieces {int(n_pieces.sum())} of "
               f"{B * NP}; device ms at p pieces a block (blocks, live "
               "blocks): " + "; ".join(
                   f"{p} ({B * -(-NP // p)}, "
                   f"{int(((n_pieces + p - 1) // p).sum())}) {ms[p]:.4f}"
                   for p in SWEPT_PIECES)
               + f"; best {best}, shipped picks {pick}")
    cs.log(f"[dispatch] {len(dispatches)} dispatches, device ms summed: "
           + "; ".join(f"{p} {t:.4f}" for p, t in sums.items()))


def giant_in_turns(parent, parent_call):
    """chip_smoke.py's giant box through run_so, both mass kinds, with the
    giant tiers on the replaced K3 as its commit ran them (its int64
    descriptors, narrowed on every call: ``parent_call``) and on this one:
    a warm run of each, then turns (old, new, new, old); solve and e2e
    seconds. Every run's results must equal the first's."""
    import chip_smoke as cs
    from so_tpu_torch.ops import gather, piece_gather

    giant = cs.giant_config()
    routes = {"old": (parent_descriptors(parent), parent_call),
              "new": (piece_gather.piece_descriptors,
                      piece_gather.piece_gather_rows)}
    for tag, mass in giant["masses"]:
        ps, catalog = cs.giant_inputs(giant, mass)
        ref, turns = None, []
        for which in ("old", "new", "old", "new", "new", "old"):
            gather.piece_descriptors, gather.piece_gather_rows = routes[which]
            try:
                out, e2e = cs.run(ps, catalog, (), "cuda")
            finally:
                gather.piece_descriptors, gather.piece_gather_rows = \
                    routes["new"]
            ref = out if ref is None else ref
            cs.assert_runs_equal(f"giant {tag}, {which} K3", out, ref, ())
            turns.append((which, out.phases["R_Delta solve"], e2e))
        timed = turns[2:]                       # after a warm run of each
        mean = {w: [sum(t[i] for t in timed if t[0] == w) / 2 for i in (1, 2)]
                for w in ("old", "new")}
        cs.log(f"[giant {tag}, K3 in turns] old K3: solve "
               f"{mean['old'][0]:.4f} s e2e {mean['old'][1]:.4f} s; this K3: "
               f"solve {mean['new'][0]:.4f} s e2e {mean['new'][1]:.4f} s "
               "(turns, solve/e2e: " + ", ".join(
                   f"{w} {sv:.4f}/{e:.4f}" for w, sv, e in timed)
               + "); results identical")


def main():
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.stderr.write("k3_study.py: torch sees no CUDA device\n")
        return 2
    parent = None
    if sys.argv[1:2] == ["--parent"] and len(sys.argv) == 3:
        parent = os.path.abspath(sys.argv[2])
    elif len(sys.argv) > 1:
        sys.stderr.write("usage: python3 k3_study.py [--parent DIR]\n")
        return 2
    from so_tpu_torch.ops import piece_gather, slab_gather
    from so_tpu_torch.ops.grid import build_grid

    t0 = time.perf_counter()
    cs.phase_env()
    cs.phase_build()
    libs = build_all(sources(parent))
    calls = {name: parent_caller(lib) if name == "parent" else caller(lib)
             for name, lib in libs.items()}
    calls.update({f"{p} pieces a block": caller(libs["shipped"], pieces=p)
                  for p in FORCED_PIECES})
    giant = cs.giant_config()
    grid = build_grid(giant["pos"], giant["masses"][0][1], device="cuda")
    for B, K, c, r, level, S, (st, cnt, q, total) in cs.k3_shapes(grid,
                                                                   giant):
        pdesc = piece_gather.piece_descriptors(st, cnt, q, K, grid.chunk)
        pdesc64 = [d.long() for d in pdesc]
        cdesc = slab_gather.chunk_descriptors(st, cnt, q, K, grid.chunk)
        reads = cs.gather_reads(grid.soa8t.shape[1], grid.chunk, st, cnt, q,
                                K, piece_gather.piece_gather_rows(
                                    grid.soa8t, *pdesc, c, grid.period,
                                    r * r, K, grid.chunk, (), True)[2])
        for chans, want_idx in cs.K3_CHANNELS:
            tail = (c, grid.period, r * r, K, grid.chunk, chans, want_idx)
            args = {name: (grid.soa8t, *(pdesc64 if name == "parent"
                                         else pdesc), *tail)
                    for name in calls}
            want = piece_gather.piece_gather_rows(grid.soa8t, *pdesc, *tail)
            for name, fn in calls.items():
                for field, a, b in zip(("d2", "channels", "idx"),
                                       fn(*args[name]), want):
                    if b is not None:
                        cs.assert_same_bits(f"K3 {name} {field}", a, b)
            bms, by = cs.gather_bound(reads, pdesc[5], 5, B, K, chans,
                                      want_idx)
            tag = (f"({B}, {K}) nch={len(chans)} idx={int(want_idx)} "
                   f"chunk={grid.chunk}")
            dev = {name: cs.graph_ms(lambda: fn(*args[name]), 5)
                   for name, fn in calls.items()}
            a1 = (grid.soa8t, *cdesc, *tail)
            k1 = cs.graph_ms(lambda: slab_gather.slab_gather_rows(*a1), 5)
            picked = piece_gather.pieces_per_block(
                B, pdesc[0].shape[1], torch.cuda.get_device_properties(
                    0).multi_processor_count)
            cs.log(f"[variants] {tag}: device ms, bound {bms:.4f} ({by}), "
                   f"K1 slotted {k1:.4f}; shipped picks {picked} pieces a "
                   "block; " + "; ".join(
                       f"{name} {ms:.4f}" for name, ms in dev.items()))
            if parent:
                new = lambda: calls["shipped"](*args["shipped"])  # noqa: E731
                old = lambda: calls["parent"](*args["parent"])    # noqa: E731
                turns = [(cs.cuda_ms(f, 5), cs.graph_ms(f, 5))
                         for f in (old, new, new, old)]
                o = [(turns[0][i] + turns[3][i]) / 2 for i in (0, 1)]
                n = [(turns[1][i] + turns[2][i]) / 2 for i in (0, 1)]
                cs.log(f"[parent] {tag}: old K3 {o[0]:.4f} ms (events) "
                       f"{o[1]:.4f} ms (graph), this K3 {n[0]:.4f} ms "
                       f"(events) {n[1]:.4f} ms (graph), {o[0] / n[0]:.2f}x "
                       f"/ {o[1] / n[1]:.2f}x; bound {bms:.4f} ms = "
                       f"{bms / n[1]:.3f} of this K3's device time; turns "
                       "(events/graph) " + " ".join(
                           f"{e:.4f}/{g:.4f}" for e, g in turns))
            d2, ch, idx = want
            srt = (cs.cuda_ms(lambda: slab_gather.sort_rows(d2, ch, idx), 5),
                   cs.graph_ms(lambda: slab_gather.sort_rows(d2, ch, idx), 5))
            cs.log(f"[sort_rows] {tag}: {srt[0]:.4f} ms (events) "
                   f"{srt[1]:.4f} ms (graph), against this K3's "
                   f"{dev['shipped']:.4f} ms (graph)")
            del want, d2, ch, idx
            torch.cuda.empty_cache()
    del grid
    torch.cuda.empty_cache()
    dispatch_sweep(libs["shipped"], record_dispatches(giant))
    torch.cuda.empty_cache()
    if parent:
        giant_in_turns(parent, calls["parent"])
    cs.log(f"[done] {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
