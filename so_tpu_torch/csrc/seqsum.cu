// Kernel K2: left-associated (serial, C-order) f32 row cumsum.
//
// Replaces so_tpu/ops/seqsum.py seq_cumsum (a lax.scan, not Pallas). The
// reference accumulates mass with a serial `mass += m` in float32
// (kd2.c:807, 521, 543); every half-mass index and Mvir ulp downstream
// depends on that exact association, and no library cumsum gives it
// (CUDA's cumsum is a parallel scan, the CPU's a different order). Each
// row is summed by ONE thread, left to right, with __fadd_rn: y[k] =
// fl(y[k-1] + x[k]), y[-1] = 0 — bit-identical to np.cumsum(dtype=f32)
// and to the JAX scan.
//
// What bounds it on the H100: latency, not bandwidth. The K adds of a row
// form one dependent chain (4 cycles each), so a row costs ~4K cycles no
// matter how the data arrives, and rows-as-threads reads are strided by K
// floats (uncoalesced: each warp load touches 32 different cache lines).
// With B >= 16k rows there are enough independent chains to cover the
// chain latency across the SMs, so this simple form is correct and usable.
//
// Later work (not here): load coalesced (32 rows x 32 columns) tiles into
// shared memory and let each thread walk its row from there, and fuse the
// density scan of engine/solver (enclosed_density's rho, scan_verdict's
// two-consecutive rule and Mvir/j selection) onto the accumulator so the
// cumsum never hits memory.

#include <cuda_runtime.h>

namespace {

__global__ void seqsum_rows_kernel(const float* __restrict__ x,
                                   float* __restrict__ y, long long B,
                                   long long K) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* xr = x + b * K;
  float* yr = y + b * K;
  float acc = 0.f;
  for (long long k = 0; k < K; ++k) {
    acc = __fadd_rn(acc, xr[k]);
    yr[k] = acc;
  }
}

}  // namespace

extern "C" int so_seqsum_rows(const float* x, float* y, long long B,
                              long long K, void* stream) {
  if (B <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (B + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  seqsum_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, y, B, K);
  return (int)cudaGetLastError();
}
