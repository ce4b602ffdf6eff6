// Kernel K3: run-level piece gather for the giant capacity tiers.
//
// Replaces experiments/pallas_piece_dma.py pallas_slab_gather (kernel body
// _make_kernel._gather_kernel, descriptors piece_descriptors). It computes
// K1's function (csrc/slab_gather.cu) into K1's dense chunk-granular slots:
// for halo b and piece u < n_pieces[b] (descriptors from torch glue,
// ops/piece_gather.piece_descriptors) it reads payload rows
// [src, src + v*CHUNK) of the (8, Np) SoA, keeps rows in the run's
// [lo, hi), computes the min-image d2 to the halo center with the
// reference's f32 association
//     d = (c - p * rint((c - x) / p)) - x,   d2 = dx*dx + dy*dy + dz*dz
// masks to d2 <= r2, and writes slot t0*CHUNK + column: d2 (+inf when out
// of ball or pad), the requested channels (mass, m*v as ONE rounded f32
// multiply, meta; 0 when out of ball) and the source row (int32, -1 when
// out of ball). Chunk slots at or past n_chunks[b] are pad.
//
// Exactness: d2 is K1's, from the one definition both kernels share
// (gather_body.cuh: rintf, __fdiv_rn and the __fmul_rn/__fadd_rn/__fsub_rn
// intrinsics, so no FMA contraction can occur; the library is also built
// with -fmad=false). The output equals K1's bit for bit.
//
// What bounds it on the H100: memory traffic, as K1 (~3 flops per byte):
// 4 B x 3 position rows (+ the channel rows) read per candidate slot,
// 4 B x (1 + nchan) (+ 4 B idx) written per slot. The TPU kernel's reason
// to exist, one DMA per piece instead of one per chunk, becomes here:
//   - few halos per giant dispatch (B = 2^26 / K, e.g. 8 at K = 2^23), so
//     one block per halo would leave most of the 132 SMs idle. The grid is
//     (groups of kPiecesPerCta pieces, halo): a giant halo's pieces spread
//     over thousands of blocks;
//   - each block walks its pieces through a kStages-deep ring in shared
//     memory, filled with cp.async (cuda_pipeline.h), so the copies of the
//     next pieces are in flight while the current one is computed; only
//     the payload rows the channels need are staged, and only columns
//     inside the run (which also keeps every load inside the payload: a
//     piece's columns can reach (PIECE_W-1)*CHUNK past its last row);
//   - every global access is coalesced: consecutive threads take
//     consecutive columns of a row and write consecutive slots.
// Each block also writes the pad of the chunk slots in its range that lie
// past the halo's chunk count, so every output slot is written once.
//
// Later work (not here): 16-byte copies or TMA (the payload's row stride
// N + CHUNK is not a multiple of 4 floats in general), warp
// specialization, and fusing the row sort onto the output.

#include <cuda_pipeline.h>

#include "gather_body.cuh"

using namespace so_gather;

namespace {

constexpr int kPieceW = 2;          // chunks per piece: PIECE_W in Python
constexpr int kPiecesPerCta = 8;
constexpr int kStages = 3;          // ring depth
constexpr int kThreads = 256;
constexpr int kMaxRows = 8;

// Which payload rows are staged, and where each channel reads them.
struct RowMap {
  int n;                            // staged rows: 0-2 are x, y, z
  int payload_row[kMaxRows];        // staged row -> payload row
  int chan_row[kMaxChan];           // channel -> staged row of its value
  int chan_mv[kMaxChan];            // 1: channel is m*v (rows 4-6)
  int mass_row;                     // staged row of the mass (or -1)
};

__global__ void __launch_bounds__(kThreads) piece_gather_kernel(
    const float* __restrict__ soa, long long np_cols,
    const int* __restrict__ src, const int* __restrict__ t0,
    const int* __restrict__ v, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ n_pieces,
    const int* __restrict__ n_chunks, int np_max,
    const float* __restrict__ centers, const float* __restrict__ period,
    const float* __restrict__ r2, long long K, int chunk, int nchan,
    RowMap map, float* __restrict__ out, int* __restrict__ out_idx) {
  extern __shared__ float ring[];   // kStages x map.n x (kPieceW * chunk)
  __shared__ int desc[kPiecesPerCta][5];

  const long long b = blockIdx.y;
  const int u0 = blockIdx.x * kPiecesPerCta;
  const int pw = kPieceW * chunk;
  const int nf = 1 + nchan;
  float* outb = out + b * nf * K;
  int* idxb = out_idx != nullptr ? out_idx + b * K : nullptr;

  // 1. pad: the chunk slots of this block's range past the chunk count
  {
    const long long c0 = max((long long)u0 * kPieceW, (long long)n_chunks[b]);
    const long long s_end = min((long long)(u0 + kPiecesPerCta) * kPieceW
                                * chunk, K);
    for (long long s = c0 * chunk + threadIdx.x; s < s_end; s += blockDim.x) {
      outb[s] = INFINITY;
      for (int c = 0; c < nchan; ++c) outb[(long long)(c + 1) * K + s] = 0.f;
      if (idxb != nullptr) idxb[s] = -1;
    }
  }

  // 2. this block's live pieces
  const int n = min(kPiecesPerCta, n_pieces[b] - u0);
  if (n <= 0) return;               // uniform across the block
  if (threadIdx.x < n) {
    const long long d = b * np_max + u0 + threadIdx.x;
    desc[threadIdx.x][0] = src[d];
    desc[threadIdx.x][1] = t0[d];
    desc[threadIdx.x][2] = v[d];
    desc[threadIdx.x][3] = lo[d];
    desc[threadIdx.x][4] = hi[d];
  }
  __syncthreads();

  const int stage_floats = map.n * pw;
  auto load = [&](int i) {          // piece i -> ring stage i % kStages
    float* st = ring + (i % kStages) * stage_floats;
    const long long s0 = desc[i][0];
    const int ncol = desc[i][2] * chunk;
    const long long l = desc[i][3], h = min((long long)desc[i][4], np_cols);
    for (int r = 0; r < map.n; ++r) {
      const float* g = soa + (long long)map.payload_row[r] * np_cols;
      for (int col = threadIdx.x; col < ncol; col += blockDim.x) {
        const long long row = s0 + col;
        if (row >= l && row < h)
          __pipeline_memcpy_async(st + r * pw + col, g + row, sizeof(float));
      }
    }
  };

  const Ball ball = load_ball(centers, period, r2, b);

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load(i);
    __pipeline_commit();
  }
  for (int i = 0; i < n; ++i) {
    if (i + kStages - 1 < n) load(i + kStages - 1);
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 1);   // piece i's copies have landed
    __syncthreads();

    const float* st = ring + (i % kStages) * stage_floats;
    const long long s0 = desc[i][0];
    const long long slot0 = (long long)desc[i][1] * chunk;
    const int ncol = desc[i][2] * chunk;
    const long long l = desc[i][3], h = desc[i][4];
    for (int col = threadIdx.x; col < ncol; col += blockDim.x) {
      const long long slot = slot0 + col;
      if (slot >= K) break;             // slots grow with col
      const long long row = s0 + col;
      float d2v = INFINITY;
      float vals[kMaxChan] = {0.f, 0.f, 0.f, 0.f, 0.f};
      int row_out = -1;
      if (row >= l && row < h && row < np_cols) {
        const float d2 = min_image_d2(ball, st[col], st[pw + col],
                                      st[2 * pw + col]);
        if (d2 <= ball.r2) {
          d2v = d2;
          row_out = (int)row;
          // unrolled over the fixed maximum so vals[] stays in registers
#pragma unroll
          for (int c = 0; c < kMaxChan; ++c) {
            if (c < nchan) {
              const float val = st[map.chan_row[c] * pw + col];
              // rows 4-6 are raw velocities: emit m*v (one rounded multiply)
              vals[c] = map.chan_mv[c]
                            ? __fmul_rn(st[map.mass_row * pw + col], val) : val;
            }
          }
        }
      }
      outb[slot] = d2v;
#pragma unroll
      for (int c = 0; c < kMaxChan; ++c)
        if (c < nchan) outb[(long long)(c + 1) * K + slot] = vals[c];
      if (idxb != nullptr) idxb[slot] = row_out;
    }
    __syncthreads();                    // stage i % kStages is refilled next
  }
}

}  // namespace

// codes: payload row per output channel (3 mass, 4/5/6 -> m*v, 7 meta).
extern "C" int so_piece_gather(
    const float* soa, long long np_cols, const int* src, const int* t0,
    const int* v, const int* lo, const int* hi, const int* n_pieces,
    const int* n_chunks, int np_max, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || B > 65535 || K <= 0 ||
      chunk <= 0 || chunk > 1024 || np_max <= 0)
    return (int)cudaErrorInvalidValue;
  const int codes[kMaxChan] = {c0, c1, c2, c3, c4};
  RowMap map = {};
  int staged[kMaxRows];             // payload row -> staged row, or -1
  for (int r = 0; r < kMaxRows; ++r) staged[r] = r < 3 ? r : -1;
  map.n = 3;
  map.mass_row = -1;
  auto stage = [&](int payload_row) {
    if (staged[payload_row] < 0) {
      staged[payload_row] = map.n;
      map.payload_row[map.n++] = payload_row;
    }
    return staged[payload_row];
  };
  for (int r = 0; r < 3; ++r) map.payload_row[r] = r;
  for (int c = 0; c < nchan; ++c) {
    if (codes[c] < 3 || codes[c] >= kMaxRows) return (int)cudaErrorInvalidValue;
    map.chan_row[c] = stage(codes[c]);
    map.chan_mv[c] = codes[c] >= 4 && codes[c] <= 6;
    if (map.chan_mv[c]) map.mass_row = stage(3);
  }
  const size_t smem = (size_t)kStages * map.n * kPieceW * chunk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      piece_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((np_max + kPiecesPerCta - 1) / kPiecesPerCta),
            (unsigned)B);
  piece_gather_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      soa, np_cols, src, t0, v, lo, hi, n_pieces, n_chunks, np_max, centers,
      period, r2, K, chunk, nchan, map, out, out_idx);
  return (int)cudaGetLastError();
}
