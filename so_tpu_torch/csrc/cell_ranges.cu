// The cell enumeration of a gather dispatch and its slab descriptors, in
// one launch.
//
// Replaces no Pallas kernel: so_tpu enumerates a ball's cells with XLA ops
// (so_tpu/ops/gather.py:59 cell_ranges), and the port did the same with
// about 140 eager torch ops a call (ops/ranges.cell_ranges_plain) plus
// about 20 for K1's or K3's descriptors (ops/slab_gather.chunk_descriptors,
// ops/piece_gather.piece_descriptors). Each of those ~160 launches does a
// few microseconds of work on the card and costs ~20 us of host time, so
// the host's enqueue, not the card, set the pace of a dispatch. This kernel
// computes the same int64 (st, cnt, q, total) and the same int32
// descriptors from the centers, radii and r2_mask in one launch.
//
// What bounds it: launch count, not bytes or operations. At (16384 halos,
// S = 3) it reads 16384 x 27 pairs of level starts and writes 16384 x 27 x
// 3 int64 plus the descriptors, a few MB; at (8 halos, S = 7, K = 2^21) it
// writes 8 x 16,385 x 5 int32.
//
// One block a halo (and, for K3's long descriptor rows, several: the grid
// is (B, G), each block of a halo repeats the enumeration and writes its
// G-th share of the descriptors). A block has one thread a cell of the
// S^3 cube (S <= 7, rounded up to whole warps):
//   1. each thread computes its cell as cell_ranges does, op for op in f32
//      (every op rounded once: __fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn;
//      the library is built with -fmad=false): the wrapped center, i_lo,
//      i_hi and the span per axis, the per-axis least distance, d2min
//      <= r2_mask, the Morton code and st / cnt from the level's starts;
//   2. the live cells (cnt > 0) are compacted by a block scan and ranked
//      by start (live slabs are disjoint, so their starts are distinct and
//      the rank is the unique sorted position; at most S^3 comparisons a
//      thread, no barrier a stage);
//   3. Morton-adjacent slabs (st[i+1] == st[i] + cnt[i]) merge into runs
//      by a block scan of the run heads;
//   4. each run's footprint, rounded out to `align`-sized chunks, and
//      their exclusive scan q and total; for K3 also the pieces a run
//      takes and their exclusive scan;
//   5. block 0 of the halo writes (st, cnt, q, total), every block writes
//      its share of the descriptors: descriptor slot t finds its run by a
//      binary search over the runs' first slots and writes its fields, so
//      consecutive threads write consecutive words.
// Only descriptors below the halo's n_total (K1) or n_pieces (K3) are
// written: the gathers never read past them. Trailing (st, cnt, q) slots
// past the runs read (0, 0, total).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSide = 7;            // S: ops/ranges.S_MAX, a thread a cell
constexpr int kDescPerThread = 8;      // descriptor slots a thread, K3
constexpr int kK3Threads = 256;        // least block size of a K3 launch
constexpr unsigned kFull = 0xffffffffu;

// modes: what the launch writes beside the ranges
constexpr int kRangesOnly = 0;
constexpr int kChunks = 1;             // K1: a0, lo, hi; n_total
constexpr int kPieces = 2;             // K3: src, t0, v, lo, hi; n_pieces,
                                       //     n_chunks

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fmaxf(a, b);
}

// Spread the low 10 bits of x over 30 bits (ops/grid._part1by2).
__device__ __forceinline__ unsigned part1by2(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// One axis of one cube offset: the wrapped cell coordinate, whether the
// offset lies inside the ball's span, and the least distance from the
// wrapped center to the cell's slab along the axis (cell_ranges' uc,
// i_lo, i_hi, span, coords, lo_edge, hi_edge, d_ax, cw).
struct Axis {
  int cw;
  bool ok;
  float d;
};

__device__ __forceinline__ Axis axis_cell(float c, float lo, float p, float r,
                                          int ncg, int o) {
  float uc = __fsub_rn(c, lo);
  uc = __fsub_rn(uc, __fmul_rn(floorf(__fdiv_rn(uc, p)), p));
  const float cs = __fdiv_rn(p, (float)ncg);
  const long long i_lo = (long long)floorf(__fdiv_rn(__fsub_rn(uc, r), cs));
  const long long i_hi = (long long)floorf(__fdiv_rn(__fadd_rn(uc, r), cs));
  const long long span = min(i_hi - i_lo + 1, (long long)ncg);
  const long long coord = i_lo + o;
  const float lo_edge = __fmul_rn(__ll2float_rn(coord), cs);
  const float hi_edge = __fadd_rn(lo_edge, cs);
  float d = nan_max(__fsub_rn(lo_edge, uc), __fsub_rn(uc, hi_edge));
  d = d < 0.f ? 0.f : d;               // clamp(min=0), NaN kept
  long long w = coord % ncg;
  if (w < 0) w += ncg;
  return Axis{(int)w, o < span, d};
}

// Exclusive block-wide scan of one value a thread (blockDim a multiple of
// 32, at most 1024); *total gets the sum. Every thread of the block calls
// it.
__device__ long long block_scan(long long v, long long* total) {
  __shared__ long long warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const long long base = warp > 0 ? warp_sum[warp - 1] : 0;
  *total = warp_sum[nwarps - 1];
  __syncthreads();                     // warp_sum is free for the next scan
  return base + x - v;
}

// The last run whose first descriptor slot is <= t (first[] ascending,
// first[0] == 0 <= t).
__device__ __forceinline__ int run_of(const long long* first, int nrun,
                                      long long t) {
  int a = 0, b = nrun - 1;
  while (a < b) {
    const int m = (a + b + 1) >> 1;
    if (first[m] <= t) a = m; else b = m - 1;
  }
  return a;
}

// Dynamic shared memory: four arrays of C int64 (C = S^3), reused:
//   A, Bs: the compacted live slabs (st, cnt), then the runs (st, end);
//   Cs, Ds: the sorted slabs (st, cnt), then the runs' q and first
//   descriptor slot.
__global__ void cell_ranges_kernel(
    const float* __restrict__ centers, const float* __restrict__ radii,
    const float* __restrict__ r2_mask, const float* __restrict__ lo,
    const float* __restrict__ period, const long long* __restrict__ starts,
    int ncg, int S, int align, long long* __restrict__ st_out,
    long long* __restrict__ cnt_out, long long* __restrict__ q_out,
    long long* __restrict__ total_out, int mode, long long nc, int piece_w,
    int* __restrict__ desc, int* __restrict__ desc_n, long long B,
    long long per_block) {
  extern __shared__ long long smem[];
  const int C = S * S * S;
  long long* A = smem;
  long long* Bs = smem + C;
  long long* Cs = smem + 2 * C;
  long long* Ds = smem + 3 * C;

  const long long b = blockIdx.x;
  const int i = threadIdx.x;

  // 1. this thread's cell: x outermost, z innermost (cell_ranges' reshape)
  bool live = false;
  long long st = 0, cnt = 0;
  if (i < C) {
    const int o[3] = {i / (S * S), (i / S) % S, i % S};
    const float r = radii[b];
    Axis ax[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      ax[a] = axis_cell(centers[b * 3 + a], lo[a], period[a], r, ncg, o[a]);
    const float d2min =
        __fadd_rn(__fadd_rn(__fmul_rn(ax[0].d, ax[0].d),
                            __fmul_rn(ax[1].d, ax[1].d)),
                  __fmul_rn(ax[2].d, ax[2].d));
    if (ax[0].ok && ax[1].ok && ax[2].ok && d2min <= r2_mask[b]) {
      const unsigned code = part1by2(ax[0].cw) | (part1by2(ax[1].cw) << 1)
                            | (part1by2(ax[2].cw) << 2);
      st = starts[code];
      cnt = starts[code + 1] - st;
      live = cnt > 0;
    }
  }

  // 2. compact the live slabs, then rank them by start
  long long L;
  const long long pos = block_scan(live ? 1 : 0, &L);
  if (live) {
    A[pos] = st;
    Bs[pos] = cnt;
  }
  __syncthreads();
  if (i < L) {
    const long long s = A[i];
    int rank = 0;
    for (int j = 0; j < L; ++j) rank += A[j] < s;
    Cs[rank] = s;
    Ds[rank] = Bs[i];
  }
  __syncthreads();

  // 3. merge Morton-adjacent slabs into runs (A: run start, Bs: run end)
  const bool head = i < L && (i == 0 || Cs[i] != Cs[i - 1] + Ds[i - 1]);
  long long nrun;
  const long long run = block_scan(head ? 1 : 0, &nrun);  // heads before i
  if (i < L) {
    const bool tail = i == L - 1 || Cs[i + 1] != Cs[i] + Ds[i];
    if (head) A[run] = Cs[i];
    if (tail) Bs[run - (head ? 0 : 1)] = Cs[i] + Ds[i];
  }
  __syncthreads();

  // 4. footprints and their offsets (Cs: q, Ds: the first descriptor slot)
  long long rst = 0, rcnt = 0, foot = 0;
  if (i < nrun) {
    rst = A[i];
    rcnt = Bs[i] - rst;
    foot = (rst % align + rcnt + (align - 1)) / align * align;
  }
  long long total;
  const long long q = block_scan(foot, &total);
  const long long nch = foot / align;          // chunks (align == chunk)
  long long npc = 0, n_pieces = 0, qp = 0;
  if (mode == kPieces) {
    npc = (nch + (piece_w - 1)) / piece_w;
    qp = block_scan(npc, &n_pieces);
  }
  if (i < nrun) {
    Cs[i] = q;
    Ds[i] = mode == kPieces ? qp : q / align;
  }
  __syncthreads();

  // 5. the ranges (block 0 of the halo), then the descriptors
  const long long n_chunks = min(total / align, nc);
  if (blockIdx.y == 0) {
    if (i < C) {
      const long long k = b * C + i;
      st_out[k] = i < nrun ? rst : 0;
      cnt_out[k] = i < nrun ? rcnt : 0;
      q_out[k] = i < nrun ? q : total;
    }
    if (i == 0) {
      total_out[b] = total;
      if (mode == kChunks) {
        desc_n[b] = (int)n_chunks;
      } else if (mode == kPieces) {
        desc_n[b] = (int)min(n_pieces, nc);
        desc_n[B + b] = (int)n_chunks;
      }
    }
  }
  if (mode == kRangesOnly) return;
  const long long n_desc = mode == kChunks ? n_chunks : min(n_pieces, nc);
  const long long t_end = min(n_desc, (blockIdx.y + 1) * per_block);
  const long long field = B * nc;              // one descriptor field
  int* row = desc + b * nc;
  for (long long t = blockIdx.y * per_block + i; t < t_end; t += blockDim.x) {
    const int j = run_of(Ds, (int)nrun, t);
    const long long s = A[j], e = Bs[j];
    const long long off = s % align;
    const long long qc = Cs[j] / align;
    if (mode == kChunks) {
      row[t] = (int)(s - off - qc * align);                 // a0
      row[field + t] = (int)s;                              // lo
      row[2 * field + t] = (int)e;                          // hi
    } else {
      const long long du = t - Ds[j];
      const long long v = (e - s + off + (align - 1)) / align - du * piece_w;
      row[t] = (int)(s - off + du * piece_w * align);       // src
      row[field + t] = (int)(qc + du * piece_w);            // t0
      row[2 * field + t] = (int)min(max(v, 0LL), (long long)piece_w);  // v
      row[3 * field + t] = (int)s;                          // lo
      row[4 * field + t] = (int)e;                          // hi
    }
  }
}

}  // namespace

// centers (B, 3), radii and r2_mask (B,) f32; lo and period (3,) f32;
// starts the level's (ncg^3 + 1,) int64. st, cnt, q are (B, S^3) int64 and
// total (B,). mode 0 writes only those; mode 1 (K1) desc (3, B, nc) and
// desc_n (B,) n_total; mode 2 (K3) desc (5, B, nc) and desc_n (2, B)
// n_pieces, n_chunks. align is the grid's chunk where descriptors are
// written.
extern "C" int so_cell_ranges(
    const float* centers, const float* radii, const float* r2_mask,
    const float* lo, const float* period, const long long* starts,
    long long B, int ncg, int S, int align, long long* st, long long* cnt,
    long long* q, long long* total, int mode, long long nc, int piece_w,
    int* desc, int* desc_n, void* stream) {
  if (B <= 0 || B >= (1LL << 31) || S < 1 || S > kMaxSide || ncg <= 0 ||
      ncg > 1024 || align <= 0 || mode < kRangesOnly || mode > kPieces)
    return (int)cudaErrorInvalidValue;
  if (mode != kRangesOnly &&
      (nc <= 0 || desc == nullptr || desc_n == nullptr || piece_w <= 0))
    return (int)cudaErrorInvalidValue;
  const int C = S * S * S;
  int threads = (C + 31) / 32 * 32;
  long long per_block = nc > 0 ? nc : 1;
  unsigned groups = 1;
  if (mode == kPieces) {
    threads = threads > kK3Threads ? threads : kK3Threads;
    per_block = (long long)threads * kDescPerThread;
    const long long g = (nc + per_block - 1) / per_block;
    if (g > 65535) return (int)cudaErrorInvalidValue;
    groups = (unsigned)g;
  }
  const size_t smem = 4 * (size_t)C * sizeof(long long);
  dim3 grid((unsigned)B, groups);
  cell_ranges_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      centers, radii, r2_mask, lo, period, starts, ncg, S, align, st, cnt, q,
      total, mode, nc, piece_w, desc, desc_n, B, per_block);
  return (int)cudaGetLastError();
}
