// Kernel K1: slab gather + min-image distance + ball mask, slotted output.
//
// Replaces so_tpu/ops/pallas_gather.py pallas_slab_gather (kernel body
// _make_kernel._gather_kernel). For each halo b and each CHUNK-aligned
// descriptor t of its merged Morton slab runs (a0, lo, hi; computed in
// torch glue, ops/slab_gather.chunk_descriptors) the kernel reads payload
// rows [a0 + t*CHUNK, +CHUNK) of the (8, Np) SoA, computes the min-image
// d2 to the halo center with the reference's f32 association
//     d = (c - p * rint((c - x) / p)) - x,   d2 = dx*dx + dy*dy + dz*dz
// masks to lo <= row < hi and d2 <= r2, and writes slot t*CHUNK + lane:
// d2 (+inf when out of ball or pad), the requested channels (mass, m*v as
// ONE rounded f32 multiply, meta; 0 when out of ball) and the source row
// (int32, -1 when out of ball).
//
// Exactness: rintf (half to even, as jnp.round), __fdiv_rn, and the
// __fmul_rn/__fadd_rn/__fsub_rn intrinsics so no FMA contraction can
// occur (the library is also built with -fmad=false).
//
// What bounds it on the H100: memory traffic. Per slot it reads 4 B x 3
// position rows (+ mass/velocity/meta rows per channel) and writes
// 4 B x (1 + nchan) (+ 4 B idx); there are ~3 flops per byte, far below
// the card's compute roofline. The design serves that bound simply: one
// block per (chunk t, halo b) with CHUNK threads, one lane per thread, so
// each warp reads 32 consecutive payload columns of a row (the payload is
// row-major (8, Np): channel c of row r is at c*Np + r) and writes 32
// consecutive output slots — every global access is coalesced. Blocks
// past a halo's chunk count write only the pad values.
//
// Later work (not here): stage each slab with cp.async/TMA into shared
// memory and let one CTA walk all chunks of a halo (fewer, fatter blocks;
// descriptor loads amortized), and fuse the row sort onto the output.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxChan = 5;

struct ChanCodes {
  int c[kMaxChan];
};

__global__ void slab_gather_kernel(
    const float* __restrict__ soa, long long np_cols,
    const int* __restrict__ a0, const int* __restrict__ lo,
    const int* __restrict__ hi, const int* __restrict__ n_total, int nc,
    const float* __restrict__ centers, const float* __restrict__ period,
    const float* __restrict__ r2, long long B, long long K, int chunk,
    int nchan, ChanCodes codes, float* __restrict__ out,
    int* __restrict__ out_idx) {
  const long long b = blockIdx.y;
  const int t = blockIdx.x;
  const long long slot = (long long)t * chunk + threadIdx.x;
  if (b >= B || slot >= K) return;   // every store below is in bounds

  const int nf = 1 + nchan;
  float d2v = INFINITY;
  float vals[kMaxChan] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int row_out = -1;

  if (t < n_total[b]) {
    const long long desc = b * nc + t;
    const long long row = (long long)a0[desc] + (long long)t * chunk
                          + threadIdx.x;
    if (row >= lo[desc] && row < hi[desc]) {
      const float cx = centers[b * 3 + 0];
      const float cy = centers[b * 3 + 1];
      const float cz = centers[b * 3 + 2];
      const float px = period[0], py = period[1], pz = period[2];
      const float x = soa[row];
      const float y = soa[np_cols + row];
      const float z = soa[2 * np_cols + row];
      const float dx = __fsub_rn(
          __fsub_rn(cx, __fmul_rn(px, rintf(__fdiv_rn(__fsub_rn(cx, x), px)))), x);
      const float dy = __fsub_rn(
          __fsub_rn(cy, __fmul_rn(py, rintf(__fdiv_rn(__fsub_rn(cy, y), py)))), y);
      const float dz = __fsub_rn(
          __fsub_rn(cz, __fmul_rn(pz, rintf(__fdiv_rn(__fsub_rn(cz, z), pz)))), z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      if (d2 <= r2[b]) {
        d2v = d2;
        row_out = (int)row;
        // unrolled over the fixed maximum so vals[] stays in registers
#pragma unroll
        for (int c = 0; c < kMaxChan; ++c) {
          if (c < nchan) {
            const int code = codes.c[c];
            const float v = soa[(long long)code * np_cols + row];
            // rows 4-6 are raw velocities: emit m*v (one rounded multiply)
            vals[c] = (code >= 4 && code <= 6)
                          ? __fmul_rn(soa[3 * np_cols + row], v) : v;
          }
        }
      }
    }
  }
  float* o = out + b * nf * K + slot;
  o[0] = d2v;
#pragma unroll
  for (int c = 0; c < kMaxChan; ++c)
    if (c < nchan) o[(long long)(c + 1) * K] = vals[c];
  if (out_idx != nullptr) out_idx[b * K + slot] = row_out;
}

}  // namespace

// codes: payload row per output channel (3 mass, 4/5/6 -> m*v, 7 meta).
extern "C" int so_slab_gather(
    const float* soa, long long np_cols, const int* a0, const int* lo,
    const int* hi, const int* n_total, int nc, const float* centers,
    const float* period, const float* r2, long long B, long long K,
    int chunk, int nchan, int c0, int c1, int c2, int c3, int c4,
    float* out, int* out_idx, void* stream) {
  if (nchan < 0 || nchan > kMaxChan || B <= 0 || B > 65535 || K <= 0 ||
      chunk <= 0 || chunk > 1024 || nc <= 0)
    return (int)cudaErrorInvalidValue;
  ChanCodes codes = {{c0, c1, c2, c3, c4}};
  dim3 grid((unsigned)nc, (unsigned)B);
  slab_gather_kernel<<<grid, chunk, 0, (cudaStream_t)stream>>>(
      soa, np_cols, a0, lo, hi, n_total, nc, centers, period, r2, B, K,
      chunk, nchan, codes, out, out_idx);
  return (int)cudaGetLastError();
}
