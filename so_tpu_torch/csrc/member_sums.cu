// Per-halo f64 member sums of m*v, the numerator of the group mean
// velocity (_VcmParticles, kd2.c:595-609), over the fused pass's sorted
// stack.
//
// Replaces no TPU kernel: the JAX package forms these sums on the host
// (so_tpu/engine/members.member_mv_sums), and so did the port until this
// kernel. Its rows are the interior prefix idx[b, :counts[b]] of each
// halo's distance-sorted (B, W) stack of grid rows; its terms are
// f64(fl32(v_c * m)) read from the grid's payload (ops/grid.pack_soa8t:
// raw masses in row 3, raw velocities in rows 4-6), the f32 product
// rounded once (__fmul_rn; the library is built with -fmad=false).
//
// The order of the adds is member_mv_sums' own, bit for bit: np.add.reduceat
// over a halo's segment copies the first term and adds numpy's pairwise sum
// of the rest (DOUBLE_add's reduce branch), so a sum is
//     s = t[0] + PW(t[1], ..., t[n-1])        (n >= 2; t[0] for n == 1,
//                                               +0.0 for n == 0)
// where PW over m terms is numpy's DOUBLE_pairwise_sum, defined in
// numpy/_core/src/umath/loops_utils.h.src (numpy/core/... before numpy 2).
// The layout below (PW_BLOCKSIZE 128, the 8-way unroll, the split of m / 2
// rounded down to a multiple of 8, the -0.0 start) is copied from that file
// as numpy 2.0.2 and 2.3.5 have it; numpy does not promise it. If a numpy
// release changes it, the card and the host routes (--distributed, --mesh,
// extract_members) differ in vcm's last bits, and the numpy replay of this
// tree in tests/test_torch_member_sums.py fails against member_mv_sums.
//   - m < 8: a serial sum from -0.0 (numpy's start, so a sum of -0.0
//     terms stays -0.0);
//   - m <= 128: eight serial sums r[j] over the terms j, j + 8, ... of the
//     first m - m % 8, then ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)),
//     then the last m % 8 terms added one after the other;
//   - m > 128: PW of the first m2 = m / 2 - (m / 2) % 8 terms plus PW of
//     the rest.
// Every add is one __dadd_rn; a + b and b + a give the same bits, so only
// the tree matters, and the tree is fixed by m alone.
//
// What bounds it on the H100: the bytes. A member row costs its int32 idx
// (read in order) and four f32 payload reads at a random grid row (three
// with a uniform mass), each a 32-byte sector: a list of 4.4e7 rows spans
// ~700 MB of payload, far past the 50 MB L2. The tree's chains are short:
// a leaf's at most 16 + 3 + 7 dependent adds, then one a level of the tree
// (~20 levels for 4.4e7 terms).
//
// Design: two launches.
//   - cut_sums_kernel: PW's nodes of at most kCut terms whose parent has
//     more (the cut nodes) are each summed by one thread, recursion
//     unrolled on a small stack, each leaf's eight serial sums in
//     registers. A node below the root holds at least kGrain = kCut / 2
//     terms (the split of m > kCut leaves m2 >= kGrain and m - m2 >= m2),
//     so thread i of a halo walks down from the root to the cut node that
//     holds term i * kGrain and sums it if that node starts past
//     (i - 1) * kGrain: each cut node has one such thread, and its sum
//     lands in slot ceil(start / kGrain) of the halo's scratch row. A
//     thread's terms are consecutive, so its idx reads share sectors.
//   - finish_kernel: one thread a halo walks the tree above the cut, each
//     cut node read from the scratch, and adds t[0] in front. A giant
//     list of 4.4e7 rows has ~1.4e4 cut nodes; a short list's root is
//     itself a cut node.
// Lists of 10^5-10^7 rows spread over thousands of threads, and many short
// lists (box512's 65,536 halos) take one thread each in the first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kLeaf = 128;        // numpy's PW_BLOCKSIZE
constexpr long long kCut = 4096;        // the most terms a cut node holds
constexpr long long kGrain = kCut / 2;  // the least a non-root one holds
constexpr int kThreads = 128;
// open nodes on a walk's stack: a node of m > kLeaf terms splits into
// parts of at most m / 2 + 8, so a cut node's walk opens at most 5 and the
// root's walk down to the cut nodes at most 20 (counts are < 2^31)
constexpr int kCutDepth = 8;
constexpr int kTopDepth = 32;

struct Sum3 {
  double x, y, z;
};

__device__ __forceinline__ Sum3 add3(const Sum3& a, const Sum3& b) {
  return {__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y), __dadd_rn(a.z, b.z)};
}

// numpy's split of a pairwise node of m > kLeaf terms: the left part
__device__ __forceinline__ long long left_part(long long m) {
  const long long m2 = m / 2;
  return m2 - m2 % 8;
}

// Term p of one halo's pairwise part: member p + 1 of its sorted stack.
struct Terms {
  const float* soa;     // (8, stride) payload
  long long stride;
  const int* rows;      // the halo's stack row, from its second member
  float um;             // the uniform mass, where `uniform`
  bool uniform;

  __device__ __forceinline__ Sum3 operator()(long long p) const {
    const long long r = rows[p];
    const float m = uniform ? um : __ldg(soa + 3 * stride + r);
    return {(double)__fmul_rn(__ldg(soa + 4 * stride + r), m),
            (double)__fmul_rn(__ldg(soa + 5 * stride + r), m),
            (double)__fmul_rn(__ldg(soa + 6 * stride + r), m)};
  }
};

// numpy's pairwise_sum over the terms [off, off + m), m <= kLeaf.
struct TermLeaf {
  Terms t;

  __device__ Sum3 operator()(long long off, long long m) const {
    if (m < 8) {
      Sum3 res = {-0.0, -0.0, -0.0};
      for (long long i = 0; i < m; ++i) res = add3(res, t(off + i));
      return res;
    }
    Sum3 r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = t(off + j);
    long long i = 8;
    for (; i < m - m % 8; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] = add3(r[j], t(off + i + j));
    }
    Sum3 res = add3(add3(add3(r[0], r[1]), add3(r[2], r[3])),
                    add3(add3(r[4], r[5]), add3(r[6], r[7])));
    for (; i < m; ++i) res = add3(res, t(off + i));
    return res;
  }
};

// A cut node's sum from the first kernel's scratch row.
struct CutLeaf {
  const double* cut;    // the halo's scratch row, (NI, 3)

  __device__ Sum3 operator()(long long off, long long) const {
    const double* c = cut + 3 * ((off + kGrain - 1) / kGrain);
    return {c[0], c[1], c[2]};
  }
};

// PW over the terms [off, off + m): nodes of more than leaf_max terms are
// split as numpy splits them, the rest summed by `leaf`. The recursion runs
// on an explicit stack of the open nodes, left child first.
template <int DEPTH, class Leaf>
__device__ Sum3 pairwise(long long off, long long m, long long leaf_max,
                         const Leaf& leaf) {
  long long s_off[DEPTH], s_m[DEPTH];
  Sum3 s_left[DEPTH];
  bool s_has_left[DEPTH];
  int sp = 0;
  for (;;) {
    while (m > leaf_max) {              // down the left edge
      s_off[sp] = off;
      s_m[sp] = m;
      s_has_left[sp] = false;
      ++sp;
      m = left_part(m);
    }
    Sum3 acc = leaf(off, m);
    while (sp > 0 && s_has_left[sp - 1]) {   // right children done: close
      --sp;
      acc = add3(s_left[sp], acc);
    }
    if (sp == 0) return acc;
    const int f = sp - 1;               // a left child done: go right
    s_left[f] = acc;
    s_has_left[f] = true;
    const long long m2 = left_part(s_m[f]);
    off = s_off[f] + m2;
    m = s_m[f] - m2;
  }
}

__device__ __forceinline__ long long members(const long long* counts,
                                             long long b, long long W) {
  return max(0LL, min(counts[b], W));
}

__global__ void __launch_bounds__(kThreads) cut_sums_kernel(
    const float* __restrict__ soa, long long stride,
    const int* __restrict__ idx, const long long* __restrict__ counts,
    long long B, long long W, long long NI, float um, int uniform,
    double* __restrict__ cut) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= B * NI) return;
  const long long b = t / NI, i = t % NI;
  const long long P = members(counts, b, W) - 1;   // the pairwise part
  const long long pos = i * kGrain;
  if (P <= 0 || pos >= P) return;
  long long off = 0, m = P;
  while (m > kCut) {
    const long long m2 = left_part(m);
    if (pos < off + m2) {
      m = m2;
    } else {
      off += m2;
      m -= m2;
    }
  }
  if (off <= (i - 1) * kGrain) return;   // the node of a thread before
  const TermLeaf leaf{{soa, stride, idx + b * W + 1, um, uniform != 0}};
  const Sum3 s = pairwise<kCutDepth>(off, m, kLeaf, leaf);
  double* c = cut + 3 * (b * NI + i);
  c[0] = s.x;
  c[1] = s.y;
  c[2] = s.z;
}

__global__ void __launch_bounds__(kThreads) finish_kernel(
    const float* __restrict__ soa, long long stride,
    const int* __restrict__ idx, const long long* __restrict__ counts,
    long long B, long long W, long long NI, float um, int uniform,
    const double* __restrict__ cut, double* __restrict__ out) {
  const long long b = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const long long n = members(counts, b, W);
  Sum3 s = {0.0, 0.0, 0.0};              // an empty list: np.zeros' +0.0
  if (n >= 1) {
    const Terms first{soa, stride, idx + b * W, um, uniform != 0};
    s = first(0);                        // reduceat copies the first term
    if (n >= 2)
      s = add3(s, pairwise<kTopDepth>(0, n - 1, kCut,
                                        CutLeaf{cut + 3 * b * NI}));
  }
  out[3 * b] = s.x;
  out[3 * b + 1] = s.y;
  out[3 * b + 2] = s.z;
}

}  // namespace

// out (B, 3) f64 = per row b of the (B, W) int32 stack idx, the sums of
// f64(fl32(v * m)) over its first counts[b] (clamped to [0, W]) rows, in
// member_mv_sums' order. soa: the (8, stride) f32 payload; uniform != 0
// reads the mass um in place of payload row 3. cut: (B, NI, 3) f64
// scratch, NI >= ceil((W - 1) / kGrain).
extern "C" int so_member_sums(const float* soa, long long stride,
                              const int* idx, const long long* counts,
                              long long B, long long W, float um,
                              int uniform, double* cut, long long NI,
                              double* out, void* stream) {
  if (B <= 0 || W <= 0 || stride <= 0 || NI < 0 ||
      NI < (W - 1 + kGrain - 1) / kGrain)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (NI > 0) {
    const long long blocks = (B * NI + kThreads - 1) / kThreads;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cut_sums_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        soa, stride, idx, counts, B, W, NI, um, uniform, cut);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (B + kThreads - 1) / kThreads;
  finish_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      soa, stride, idx, counts, B, W, NI, um, uniform, cut, out);
  return (int)cudaGetLastError();
}
