// Kernel K3: run-level piece gather for the giant capacity tiers.
//
// Replaces experiments/pallas_piece_dma.py pallas_slab_gather (kernel body
// _make_kernel._gather_kernel, descriptors piece_descriptors). It computes
// K1's function (csrc/slab_gather.cu) into K1's dense chunk-granular slots:
// for halo b and piece u < n_pieces[b] (int32 descriptors written by
// csrc/cell_ranges.cu; plain version ops/piece_gather.piece_descriptors)
// it reads payload rows
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
// 4 B x 3 position rows per candidate, 4 B a channel row per in-ball hit,
// 4 B x (1 + nchan) (+ 4 B idx) written per slot. (The balls of a giant
// dispatch overlap, so a row is read once a ball; the bound counts it
// once.) The TPU kernel's reason to exist, one DMA a piece instead of one
// a chunk, does not carry over: the H100 pays per byte and per trip to
// memory, not per copy, and staging each piece with one bulk copy a row
// reads 1.5-3x slower than this walk. Its first port staged the streamed
// slab through a cp.async ring in shared memory (no reuse to serve, two
// barriers a piece, the ring filled and drained in every block): 1.9-3.8x
// slower. 16-byte access is worth 0-11% of it. This design:
//   - walks each piece in groups of 4 consecutive columns. Pieces are
//     chunk-aligned in the source (src is a multiple of CHUNK) and in the
//     output (t0 * CHUNK), and the payload's row stride is a multiple of 4
//     floats (ops/grid.payload_width; the wrapper and the entry point refuse
//     any other), so a group never straddles a chunk and its x, y, z (and,
//     where a lane is in the ball, its channel rows) are 16-byte loads
//     straight to registers; its d2, channels and idx are 16-byte stores
//     where K % 4 == 0. Lanes outside [lo, hi) are masked after the load.
//     No shared memory, no barrier in the walk;
//   - gives a thread kGroups independent groups in flight: first their
//     descriptors (one broadcast load a warp: a piece is 64 or 128 groups),
//     then all their position rows, and only then the first division;
//   - spreads a halo's pieces over many blocks (the grid is (pieces /
//     pieces_per_block, halo)): a giant dispatch has few halos (B = 2^26 /
//     K), so one block a halo would idle most SMs. The wrapper picks 4 to
//     32 pieces a block, the grid nearest to 16 blocks an SM
//     (ops/piece_gather.pieces_per_block): a longer walk amortises a
//     block's set-up, a small grid balances better in short blocks;
//   - caps registers so that an SM holds kMinBlocks blocks.
// Each block also writes the pad of the chunk slots in its range that lie
// past the halo's chunk count, with 16-byte stores; a block whose pieces
// all lie past the halo's piece count writes only that. So every output
// slot is written once. k3_study.py holds the readings behind each choice.

#include "gather_body.cuh"

using namespace so_gather;

namespace {

constexpr int kPieceW = 2;          // chunks a piece: PIECE_W in Python
constexpr int kThreads = 256;
constexpr int kGroups = 2;          // 4-column groups a thread in flight
constexpr int kMinBlocks = 4;       // blocks an SM must hold (register cap)

// 16-byte accesses; callers pass 16-byte aligned addresses only
__device__ __forceinline__ float4 ld4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float lane(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

__device__ __forceinline__ void st16(float* __restrict__ p,
                                     const float (&val)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(val[0], val[1], val[2], val[3]);
}

__device__ __forceinline__ void st16(int* __restrict__ p,
                                     const int (&val)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(val[0], val[1], val[2], val[3]);
}

// four slots from slot s on: one 16-byte store, or (kVec false: K % 4 != 0
// or an unaligned output) one 4-byte store a slot below K
template <bool kVec, typename T>
__device__ __forceinline__ void st4(T* __restrict__ p, long long s,
                                    long long K, const T (&val)[4]) {
  if (kVec) {
    st16(p + s, val);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (s + j < K) p[s + j] = val[j];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks) piece_gather_kernel(
    const float* __restrict__ soa, int np_cols,
    const int* __restrict__ src, const int* __restrict__ t0,
    const int* __restrict__ v, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ n_pieces,
    const int* __restrict__ n_chunks, int np_max,
    const float* __restrict__ centers, const float* __restrict__ period,
    const float* __restrict__ r2, long long K, int chunk, int nchan,
    ChanCodes codes, int ppb, float* __restrict__ out,
    int* __restrict__ out_idx) {
  const long long b = blockIdx.y;
  const int u0 = blockIdx.x * ppb;
  const int pw = kPieceW * chunk;       // columns a piece
  const int gpp = pw / 4;               // 4-column groups a piece
  float* o = out + b * (1 + nchan) * K;
  int* oi = out_idx != nullptr ? out_idx + b * K : nullptr;

  // 1. the pad: the chunk slots of this block's range past the chunk count
  const long long c0 = max((long long)u0 * kPieceW, (long long)n_chunks[b]);
  const long long s_end = min((long long)(u0 + ppb) * pw, K);
  if (c0 * chunk < s_end)
    fill_pad(o, K, nchan, oi, c0 * chunk, s_end, kVec, threadIdx.x,
             kThreads);

  // 2. this block's live pieces
  const int n = min(ppb, n_pieces[b] - u0);
  if (n <= 0) return;                   // uniform across the block
  const long long d0 = b * np_max + u0;
  const int* srcb = src + d0;
  const int* t0b = t0 + d0;
  const int* vb = v + d0;
  const int* lob = lo + d0;
  const int* hib = hi + d0;
  const Ball h = load_ball(centers, period, r2, b);
  const float* sy = soa + np_cols;
  const float* sz = sy + np_cols;
  bool need_mass = false;
#pragma unroll
  for (int c = 0; c < kMaxChan; ++c)
    need_mass |= c < nchan && is_mv(codes.c[c]);

  const int ngroups = n * gpp;
  for (int g0 = 0; g0 < ngroups; g0 += kThreads * kGroups) {
    int row[kGroups], rlo[kGroups], rhi[kGroups];
    long long slot[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {      // a. descriptors
      const int gi = g0 + k * kThreads + threadIdx.x;
      row[k] = -1;                          // not a live column
      slot[k] = K;
      rlo[k] = rhi[k] = 0;
      if (gi < ngroups) {
        const int u = gi / gpp;
        const int col = (gi - u * gpp) * 4;
        const int s = srcb[u], t = t0b[u], nv = vb[u];
        rlo[k] = lob[u];
        rhi[k] = min(hib[u], np_cols);
        if (col < nv * chunk) {
          row[k] = s + col;
          slot[k] = (long long)t * chunk + col;
        }
      }
    }
    float4 x[kGroups], y[kGroups], z[kGroups];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {      // b. position rows
      x[k] = y[k] = z[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row[k] >= 0 && row[k] < rhi[k] && row[k] + 4 > rlo[k]) {
        x[k] = ld4(soa + row[k]);
        y[k] = ld4(sy + row[k]);
        z[k] = ld4(sz + row[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {      // c. d2, channels, stores
      if (row[k] < 0 || slot[k] >= K) continue;
      const int r0 = row[k];
      const long long s = slot[k];
      float d2v[4];
      int idx[4];
      unsigned m = 0;                        // in-ball lanes
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d2v[j] = INFINITY;
        idx[j] = -1;
        if (r0 + j >= rlo[k] && r0 + j < rhi[k]) {
          const float d2 = min_image_d2(h, lane(x[k], j), lane(y[k], j),
                                        lane(z[k], j));
          if (d2 <= h.r2) {
            d2v[j] = d2;
            idx[j] = r0 + j;
            m |= 1u << j;
          }
        }
      }
      st4<kVec>(o, s, K, d2v);
      float4 mass = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m != 0 && need_mass) mass = ld4(soa + 3LL * np_cols + r0);
#pragma unroll
      for (int c = 0; c < kMaxChan; ++c) {
        if (c >= nchan) continue;
        float val[4] = {0.f, 0.f, 0.f, 0.f};
        if (m != 0) {
          const float4 q = ld4(soa + (long long)codes.c[c] * np_cols + r0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (m & (1u << j))
              val[j] = channel_value(codes.c[c], lane(mass, j), lane(q, j));
        }
        st4<kVec>(o + (long long)(c + 1) * K, s, K, val);
      }
      if (oi != nullptr) st4<kVec>(oi, s, K, idx);
    }
  }
}

}  // namespace

// codes: payload row per output channel (3 mass, 4/5/6 -> m*v, 7 meta).
// out is (B, 1 + nchan, K). The payload's row stride np_cols and the chunk
// must be multiples of 4 floats and its base 16-byte aligned; ppb is the
// pieces a block.
extern "C" int so_piece_gather(
    const float* soa, long long np_cols, const int* src, const int* t0,
    const int* v, const int* lo, const int* hi, const int* n_pieces,
    const int* n_chunks, int np_max, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, int ppb, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || B > 65535 || K <= 0 ||
      K >= (1LL << 31) || chunk <= 0 || chunk > 1024 || chunk % 4 != 0 ||
      np_max <= 0 || np_cols <= 0 || np_cols >= (1LL << 31) ||
      np_cols % 4 != 0 || !aligned16(soa) || ppb <= 0 || ppb > 1024)
    return (int)cudaErrorInvalidValue;
  const ChanCodes codes = {{c0, c1, c2, c3, c4}};
  for (int c = 0; c < nchan; ++c)
    if (codes.c[c] < 3 || codes.c[c] > 7) return (int)cudaErrorInvalidValue;
  const bool vec = K % 4 == 0 && aligned16(out) && aligned16(out_idx);
  const dim3 grid((unsigned)((np_max + ppb - 1) / ppb), (unsigned)B);
  auto kernel = vec ? piece_gather_kernel<true> : piece_gather_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      soa, (int)np_cols, src, t0, v, lo, hi, n_pieces, n_chunks, np_max,
      centers, period, r2, K, chunk, nchan, codes, ppb, out, out_idx);
  return (int)cudaGetLastError();
}
