// Kernel K1: slab gather + min-image distance + ball mask, in two forms.
//
// Replaces so_tpu/ops/pallas_gather.py pallas_slab_gather (kernel body
// _make_kernel._gather_kernel). For each halo b and each CHUNK-aligned
// descriptor t of its merged Morton slab runs (a0, lo, hi, all int32;
// written by csrc/cell_ranges.cu, plain version
// ops/slab_gather.chunk_descriptors) the kernel
// reads payload rows [a0 + t*CHUNK, +CHUNK) of the (8, Np) SoA, computes the
// min-image d2 to the halo center (gather_body.cuh: the reference's f32
// association, every operation rounded) and masks to lo <= row < hi and
// d2 <= r2. Slot t*CHUNK + lane reads row a0 + slot.
//
// The slotted form (slab_gather_kernel) writes slot by slot, as the TPU
// kernel does: d2 (+inf when out of ball or pad), the requested channels
// (mass, m*v as ONE rounded f32 multiply, meta; 0 when out of ball) and
// the source row (int32, -1 when out of ball). It serves the callers that
// want no order (-pot, the survey classify) and rows too long for the
// sorted form.
//
// The sorted form (slab_gather_sorted_kernel) emits each halo's row
// already sorted by distance: d2 ascending with +inf from n_in on, the
// channels and rows permuted alongside, and n_in itself. It is what a
// stable sort of the slotted row by d2 gives, bit for bit, and takes the
// place of the slotted kernel, the count of finite d2, the (B, K) sort and
// one gather per channel, none of whose intermediates now pass through
// device memory.
//
// What bounds both on the H100: memory traffic. Per candidate slot they
// read 4 B x 3 position rows (+ mass/velocity/meta rows per channel) and
// per output slot write 4 B x (1 + nchan) (+ 4 B idx); ~3 flops per byte,
// far below the compute roofline. A ball's candidates fill a fraction of
// its K slots, so most of the written bytes are pad.
//
// Neither form reaches that bound: a block's work is a chain of dependent
// trips to memory (chunk count -> descriptors -> positions -> channels),
// so what pays is many resident blocks and several loads in flight a
// thread (k1_study.py holds the readings behind each choice below).
//
// The slotted form: one block per 256 x kU consecutive slots of a halo
// (kU = 4; 2 or 1 for rows shorter than that, whose single block would
// leave threads idle), so a thread has kU independent slots (of several
// chunks) in flight: first their descriptors, then their position rows,
// before the first division. Warps read 32 consecutive payload columns
// and write 32 consecutive slots, so every access is coalesced; the
// descriptor of a warp's chunk is one broadcast load. The halo's center,
// period and r2 are read once a thread, not once a slot. A block that
// lies wholly in the halo's pad range (at or past n_total chunks) writes
// it with 16-byte stores where K % 4 == 0 and the bases are aligned.
// Registers are capped so that an SM holds 6 blocks. The slabs go
// straight from global memory to registers: a streamed slab has no reuse
// for shared memory to serve (K3 stages them and is slower).
//
// The sorted form: one block per halo. Its threads walk only the halo's
// live chunks (kSortedUnroll slots a thread in flight) and append each
// in-ball hit's 64-bit key, (d2 bits << 32) | source row, to dynamic
// shared memory (one shared atomicAdd a warp, ranks by ballot). d2 is a
// sum of squares, so its bits order as the float; rows grow with slots
// inside a halo (cell_ranges sorts the runs by start), so the key's order
// is the stable sort's order over the slot layout, ties included, and the
// order of insertion does not matter. The keys are padded to a power of
// two with all-ones and sorted by a bitonic network in shared memory;
// then position p < n_in writes d2 and the row from its key. The channels
// are read again from the payload at the sorted row rather than stashed
// beside the key: only in-ball rows are read, their sectors were just
// touched by the walk, and shared memory stays at 8 B a slot whatever the
// channel count (a stash would be 4 B x (1 + nchan) more, 512 KB at
// K = 2^14 with five channels). Positions from n_in on get +inf / 0 / -1
// with 16-byte stores. Shared memory is sized for n_in = K: 8 B x K
// rounded up to a power of two, 128 KB at K = 2^14, the form's limit
// (ops/gather.SORTED_K_MAX). The block size grows with K
// (ops/slab_gather.sorted_threads: 64 threads at K <= 512, 512 above
// 4096), so that short rows put many small blocks on an SM; blocks of up
// to 256 threads are compiled under a register cap for the same reason.

#include "gather_body.cuh"

using namespace so_gather;

namespace {

constexpr int kThreads = 256;                  // slotted form's block
constexpr int kSortedUnroll = 4;               // slots a thread, sorted walk
// Blocks of 256 threads an SM must hold (a register cap), either form.
// k1_study.py times patched copies of this file with other values here, in
// slotted_unroll and without the pad blocks.
constexpr int kSlottedMinBlocks = 6;
constexpr int kSortedMinBlocks = 6;
constexpr size_t kMaxDynamicShared = 232448 - 1024;

// The candidate source row of slot `slot` (inside chunk t < nc) of a halo
// whose descriptors start at a0/lo/hi, or -1 when it lies outside its run.
// Chunks at or past the halo's n_total hold garbage: the caller drops them.
__device__ __forceinline__ int candidate_row(const int* __restrict__ a0,
                                             const int* __restrict__ lo,
                                             const int* __restrict__ hi,
                                             unsigned slot, unsigned chunk) {
  const unsigned t = slot / chunk;
  const long long r = (long long)a0[t] + slot;
  return (r >= lo[t] && r < hi[t]) ? (int)r : -1;
}

// kU slots a thread: a block covers kThreads * kU consecutive slots.
template <int kU>
__global__ void __launch_bounds__(kThreads, kSlottedMinBlocks)
slab_gather_kernel(
    const float* __restrict__ soa, long long np_cols,
    const int* __restrict__ a0, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ n_total, int nc,
    const float* __restrict__ centers, const float* __restrict__ period,
    const float* __restrict__ r2, long long K, int chunk, int nchan,
    ChanCodes codes, float* __restrict__ out, int* __restrict__ out_idx,
    int vec) {
  constexpr int kBlockSlots = kThreads * kU;
  const long long b = blockIdx.y;
  const long long base = (long long)blockIdx.x * kBlockSlots;
  const long long end = min(base + kBlockSlots, K);
  float* o = out + b * (1 + nchan) * K;
  int* oi = out_idx != nullptr ? out_idx + b * K : nullptr;
  const long long live_end = min((long long)n_total[b] * chunk, K);
  if (base >= live_end) {   // the whole block is pad
    fill_pad(o, K, nchan, oi, base, end, vec != 0, threadIdx.x, kThreads);
    return;
  }
  const int* a0b = a0 + b * nc;
  const int* lob = lo + b * nc;
  const int* hib = hi + b * nc;
  const Ball h = load_ball(centers, period, r2, b);

  int row[kU];
  float x[kU], y[kU], z[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long slot = base + u * kThreads + threadIdx.x;
    row[u] = slot < live_end
                 ? candidate_row(a0b, lob, hib, (unsigned)slot, chunk) : -1;
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    if (row[u] >= 0) {
      x[u] = soa[row[u]];
      y[u] = soa[np_cols + row[u]];
      z[u] = soa[2 * np_cols + row[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const long long slot = base + u * kThreads + threadIdx.x;
    if (slot >= end) continue;       // every store below is in bounds
    float d2v = INFINITY;
    float vals[kMaxChan] = {0.f, 0.f, 0.f, 0.f, 0.f};
    int row_out = -1;
    if (row[u] >= 0) {
      const float d2 = min_image_d2(h, x[u], y[u], z[u]);
      if (d2 <= h.r2) {
        d2v = d2;
        row_out = row[u];
        // unrolled over the fixed maximum so vals[] stays in registers
#pragma unroll
        for (int c = 0; c < kMaxChan; ++c)
          if (c < nchan)
            vals[c] = load_channel(soa, np_cols, codes.c[c], row[u]);
      }
    }
    o[slot] = d2v;
#pragma unroll
    for (int c = 0; c < kMaxChan; ++c)
      if (c < nchan) o[(long long)(c + 1) * K + slot] = vals[c];
    if (oi != nullptr) oi[slot] = row_out;
  }
}

// out is (1 + nchan, B, K): field f of halo b starts at (f*B + b) * K.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
slab_gather_sorted_kernel(
    const float* __restrict__ soa, long long np_cols,
    const int* __restrict__ a0, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ n_total, int nc,
    const float* __restrict__ centers, const float* __restrict__ period,
    const float* __restrict__ r2, long long B, int K, int chunk, int nchan,
    ChanCodes codes, float* __restrict__ out, int* __restrict__ out_idx,
    long long* __restrict__ n_in, int vec) {
  extern __shared__ unsigned long long keys[];   // K, up to a power of two
  __shared__ int count;

  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  if (tid == 0) count = 0;
  __syncthreads();

  const long long BK = B * (long long)K;
  float* o = out + b * K;
  int* oi = out_idx != nullptr ? out_idx + b * K : nullptr;
  const int* a0b = a0 + b * nc;
  const int* lob = lo + b * nc;
  const int* hib = hi + b * nc;
  const Ball h = load_ball(centers, period, r2, b);
  const int live_end = (int)min((long long)n_total[b] * chunk, (long long)K);

  // 1. walk the live chunks; append each in-ball hit's key. base and
  // live_end are the block's, so every warp arrives whole at each ballot
  for (int base = 0; base < live_end; base += kSortedUnroll * nt) {
    int row[kSortedUnroll];
    float x[kSortedUnroll], y[kSortedUnroll], z[kSortedUnroll];
#pragma unroll
    for (int u = 0; u < kSortedUnroll; ++u) {
      const int slot = base + u * nt + tid;
      row[u] = slot < live_end
                   ? candidate_row(a0b, lob, hib, (unsigned)slot, chunk) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSortedUnroll; ++u) {
      if (row[u] >= 0) {
        x[u] = soa[row[u]];
        y[u] = soa[np_cols + row[u]];
        z[u] = soa[2 * np_cols + row[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kSortedUnroll; ++u) {
      bool hit = false;
      unsigned long long key = 0;
      if (row[u] >= 0) {
        const float d2 = min_image_d2(h, x[u], y[u], z[u]);
        hit = d2 <= h.r2;
        key = ((unsigned long long)__float_as_uint(d2) << 32)
              | (unsigned)row[u];
      }
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (m != 0) {                  // the same for the whole warp
        const int leader = __ffs(m) - 1;
        int pos = 0;
        if (lane == leader) pos = atomicAdd(&count, __popc(m));
        pos = __shfl_sync(0xffffffffu, pos, leader);
        if (hit) keys[pos + __popc(m & ((1u << lane) - 1u))] = key;
      }
    }
  }
  __syncthreads();
  const int n = count;               // hits <= live_end <= K

  // 2. bitonic sort of the keys, padded to a power of two with all-ones
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int i = n + tid; i < n2; i += nt) keys[i] = ~0ULL;
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (n2 >> 1); i += nt) {
        const int p = 2 * i - (i & (j - 1));     // the pair (p, p + j)
        const unsigned long long ka = keys[p], kb = keys[p + j];
        if ((ka > kb) == ((p & k) == 0)) {
          keys[p] = kb;
          keys[p + j] = ka;
        }
      }
      __syncthreads();
    }
  }

  // 3. the sorted row, then its pad
  for (int p = tid; p < n; p += nt) {
    const unsigned long long key = keys[p];
    const int row = (int)(unsigned)(key & 0xffffffffULL);
    o[p] = __uint_as_float((unsigned)(key >> 32));
    for (int c = 0; c < nchan; ++c)
      o[(c + 1) * BK + p] = load_channel(soa, np_cols, codes.c[c], row);
    if (oi != nullptr) oi[p] = row;
  }
  fill_pad(o, BK, nchan, oi, n, K, vec != 0, tid, nt);
  if (tid == 0) n_in[b] = n;
}

// Slots a thread of the slotted form (1, 2 or 4): 4 where a halo's row
// fills the block, fewer for short rows, whose one block a halo would
// leave threads idle.
int slotted_unroll(long long K) {
  return K >= 4 * kThreads ? 4 : K >= 2 * kThreads ? 2 : 1;
}

}  // namespace

// codes: payload row per output channel (3 mass, 4/5/6 -> m*v, 7 meta).
// out is (B, 1 + nchan, K).
extern "C" int so_slab_gather(
    const float* soa, long long np_cols, const int* a0, const int* lo,
    const int* hi, const int* n_total, int nc, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || B > 65535 || K <= 0 ||
      K >= (1LL << 31) || chunk <= 0 || chunk > 1024 || nc <= 0)
    return (int)cudaErrorInvalidValue;
  ChanCodes codes = {{c0, c1, c2, c3, c4}};
  const int vec = K % 4 == 0 && aligned16(out) && aligned16(out_idx);
  const int u = slotted_unroll(K);
  dim3 grid((unsigned)((K + kThreads * u - 1) / (kThreads * u)), (unsigned)B);
  auto kernel = u == 1 ? slab_gather_kernel<1>
                : u == 2 ? slab_gather_kernel<2> : slab_gather_kernel<4>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      soa, np_cols, a0, lo, hi, n_total, nc, centers, period, r2, K, chunk,
      nchan, codes, out, out_idx, vec);
  return (int)cudaGetLastError();
}

// The sorted form. out is (1 + nchan, B, K); n_in is (B,) int64; threads
// is the block size (a multiple of 32, at most 1024).
extern "C" int so_slab_gather_sorted(
    const float* soa, long long np_cols, const int* a0, const int* lo,
    const int* hi, const int* n_total, int nc, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, long long* n_in, int threads, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || K <= 0 ||
      chunk <= 0 || chunk > 1024 || nc <= 0 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  size_t slots = 1;
  while (slots < (size_t)K) slots <<= 1;
  const size_t smem = slots * sizeof(unsigned long long);
  if (smem > kMaxDynamicShared) return (int)cudaErrorInvalidValue;
  // small blocks get a register cap that lets an SM hold many of them
  auto kernel =
      threads <= 128
          ? slab_gather_sorted_kernel<128, 2 * kSortedMinBlocks>
      : threads <= 256
          ? slab_gather_sorted_kernel<256, kSortedMinBlocks>
          : slab_gather_sorted_kernel<1024, 1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ChanCodes codes = {{c0, c1, c2, c3, c4}};
  const int vec = K % 4 == 0 && aligned16(out) && aligned16(out_idx);
  kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
      soa, np_cols, a0, lo, hi, n_total, nc, centers, period, r2, B, (int)K,
      chunk, nchan, codes, out, out_idx, n_in, vec);
  return (int)cudaGetLastError();
}
