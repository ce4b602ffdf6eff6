// Kernel K2: left-associated (serial, C-order) f32 row cumsum, with an
// optional per-row count of valid slots.
//
// Replaces so_tpu/ops/seqsum.py seq_cumsum (a lax.scan, not Pallas). The
// reference accumulates mass with a serial `mass += m` in float32
// (kd2.c:807, 521, 543); every half-mass index and Mvir ulp downstream
// depends on that exact association, and no library cumsum gives it
// (CUDA's cumsum is a parallel scan, the CPU's a different order). Each
// row is summed by ONE thread, left to right, with __fadd_rn:
//     y[k] = fl(y[k-1] + xm[k]),  xm[k] = k < n_valid ? x[k] : +0.0,
// from an accumulator of +0.0, as the reference's scan from zeros and
// kd2.c's `mass = 0` start (y[0] = x[0], except that a leading -0.0
// becomes +0.0). No tree, no f64, no reassociation: the output equals
// so_tpu's seq_cumsum of xm bit for bit.
//
// What bounds it on the H100: the larger of the bytes (each input read
// once, each output written once, at 3.35 TB/s) and the chain, because the
// adds of a row depend on each other: K dependent FADDs of ~4 cycles each,
// whatever the data path. Many short rows are bytes-bound; few long rows
// (the giant tiers: 8 rows of 2^23 slots) are chain-bound.
//
// Design: one kernel template, ROWS rows per block (32, 16, 4 or 1).
//   - A ring of kStages tiles in shared memory, each ROWS rows x
//     kTile/ROWS columns, filled with cp.async (16-byte copies where the
//     rows are 16-byte aligned, else 4-byte ones): consecutive threads copy
//     consecutive columns of a row, so every load is coalesced. Two tiles
//     are in flight while one is scanned and one is stored.
//   - Lane r of warp 0 walks row r of the tile in place with LDS.128 and
//     STS.128, software-pipelined: two register buffers of kGroup float4s
//     take turns, one refilled while the other is added, so no load
//     latency and no register copy sits on the chain (a single buffer
//     refilled by register copies was slower on an H100; kGroup = 8 beat
//     4, and 16, whose register count cut the blocks an SM holds). Each
//     staged row is padded by 4 floats, so the lanes' 16-byte accesses of
//     one quarter-warp fall in distinct banks.
//   - Warps 1.. store the tile scanned in the previous step with coalesced
//     16-byte (or 4-byte) stores. One __syncthreads per tile.
//   - ROWS = 32 (128 columns a tile) serves many rows: one warp walks 32
//     chains at once and the block is bytes-bound. ROWS = 1 (4096 columns)
//     serves giant rows: one block streams one row through the ring while
//     one thread runs its chain, so B rows occupy B SMs and the time is the
//     chain's. The wrapper (ops/seqsum.py, rows_per_block) picks ROWS from
//     (B, K) and the SM count.
//   - Rows of at most 32 slots (the survey prefix's (B, 16)) take a
//     second kernel, one thread per row with the row in registers, read
//     and written with 16-byte accesses: a 32-row tile would be mostly
//     empty there (k2_study.py, device time on an H100 80GB HBM3 at
//     (16384, 16): the tiled kernel 7.3 us, this one 2.9 us).
//   - n_valid: slots at or past n_valid[b] are never read: their copies
//     zero-fill the staged row (cp.async's src-size), so the chain adds
//     +0.0 there with no test on its path. Tiles past the group's largest
//     count are neither loaded nor walked: their outputs are each row's
//     last value plus +0.0, written by all threads at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;     // floats per ring stage
constexpr int kPad = 4;         // floats of padding per staged row
constexpr int kStages = 4;      // 1 stored, 1 scanned, 2 in flight
constexpr int kThreads = 256;
constexpr int kGroup = 8;       // float4s a register buffer holds
constexpr int kShortK = 32;     // rows this short live in registers
constexpr int kShortThreads = 128;

template <int ROWS>
struct Tile {
  static constexpr int cols = kTile / ROWS;
  static constexpr int stride = cols + kPad;   // floats per staged row
  static constexpr int floats = ROWS * stride;
};

// cp.async of BYTES (16 or 4) into shared memory, of which only the first
// `src` bytes are read from global memory; the rest are zero-filled.
template <int BYTES>
__device__ __forceinline__ void copy_async(float* smem, const float* gmem,
                                           int src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (BYTES == 16)
    asm volatile(
        "{\n .reg .u64 g;\n cvta.to.global.u64 g, %1;\n"
        " cp.async.cg.shared.global [%0], [g], 16, %2;\n}\n"
        ::"r"(s), "l"(gmem), "r"(src) : "memory");
  else
    asm volatile(
        "{\n .reg .u64 g;\n cvta.to.global.u64 g, %1;\n"
        " cp.async.ca.shared.global [%0], [g], 4, %2;\n}\n"
        ::"r"(s), "l"(gmem), "r"(src) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kGroup float4s of one lane's row: the serial adds, written back in place.
__device__ __forceinline__ float add_group(float4* row, const float4* v,
                                           float acc) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    float4 w = v[u];
    acc = __fadd_rn(acc, w.x);
    w.x = acc;
    acc = __fadd_rn(acc, w.y);
    w.y = acc;
    acc = __fadd_rn(acc, w.z);
    w.z = acc;
    acc = __fadd_rn(acc, w.w);
    w.w = acc;
    row[u] = w;
  }
  return acc;
}

// One lane's serial walk over its staged row (N4 float4s, a power of two
// and a multiple of 2 * kGroup), in place. Two register buffers take
// turns: each is refilled right after its adds, two groups ahead, so the
// chain never waits on a shared-memory load. Both refills are carried
// across the loop's back edge, which keeps the compiler from sinking them
// to their use to save registers (an in-iteration refill was sunk, and
// cost ~30 cycles a float4). The last refills wrap to the row's start
// and are not used.
template <int N4>
__device__ __forceinline__ float walk(float4* row, float acc) {
  static_assert(N4 % (2 * kGroup) == 0 && (N4 & (N4 - 1)) == 0, "tile");
  float4 a[kGroup], b[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    a[u] = row[u];
    b[u] = row[kGroup + u];
  }
#pragma unroll 1
  for (int g = 0; g < N4; g += 2 * kGroup) {
    acc = add_group(row + g, a, acc);
    const int ga = (g + 2 * kGroup) & (N4 - 1);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) a[u] = row[ga + u];
    acc = add_group(row + g + kGroup, b, acc);
    const int gb = (g + 3 * kGroup) & (N4 - 1);
#pragma unroll
    for (int u = 0; u < kGroup; ++u) b[u] = row[gb + u];
  }
  return acc;
}

// VEC: K % 4 == 0 and both bases 16-byte aligned (16-byte copies/stores).
template <int ROWS, bool VEC>
__global__ void __launch_bounds__(kThreads) seqsum_rows_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const long long* __restrict__ n_valid, long long B, long long K) {
  using T = Tile<ROWS>;
  constexpr int kW = VEC ? 4 : 1;               // floats per copy
  constexpr int kPerRow = T::cols / kW;         // copies per staged row
  extern __shared__ __align__(16) float ring[]; // kStages x T::floats
  __shared__ long long s_nv[ROWS];
  __shared__ float s_tail[ROWS];

  const long long b0 = (long long)blockIdx.x * ROWS;
  const int nrows = (int)min((long long)ROWS, B - b0);
  if (threadIdx.x < ROWS) {
    long long nv = 0;
    if ((int)threadIdx.x < nrows) {
      nv = n_valid != nullptr ? n_valid[b0 + threadIdx.x] : K;
      nv = max(0LL, min(nv, K));
    }
    s_nv[threadIdx.x] = nv;
  }
  __syncthreads();
  long long max_nv = 0;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) max_nv = max(max_nv, s_nv[r]);
  const long long tiles = (max_nv + T::cols - 1) / T::cols;
  const float* xb = x + b0 * K;
  float* yb = y + b0 * K;

  // tile t -> ring slot t % kStages; the floats at or past a row's count
  // (and every float of a row past B) are zero-filled, not read
  auto load = [&](long long t) {
    float* st = ring + (t % kStages) * T::floats;
    const long long c0 = t * T::cols;
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kW;
      const int n = (int)max(0LL, min((long long)kW, s_nv[r] - c0 - c));
      copy_async<4 * kW>(st + r * T::stride + c,
                         n > 0 ? xb + r * K + c0 + c : x, 4 * n);
    }
  };
  auto store = [&](long long t) {   // warps 1..: ring slot -> y
    const float* st = ring + (t % kStages) * T::floats;
    const long long c0 = t * T::cols;
    for (int i = threadIdx.x - 32; i < ROWS * kPerRow; i += kThreads - 32) {
      const int r = i / kPerRow, c = (i % kPerRow) * kW;
      if (r < nrows && c0 + c < K) {
        if (VEC)
          *reinterpret_cast<float4*>(yb + r * K + c0 + c) =
              *reinterpret_cast<const float4*>(st + r * T::stride + c);
        else
          yb[r * K + c0 + c] = st[r * T::stride + c];
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 2; ++t) {
    if (t < tiles) load(t);
    commit_copies();
  }
  float acc = 0.0f;                 // the reference's `mass = 0`
  for (long long t = 0; t < tiles; ++t) {
    wait_copies<kStages - 3>();   // this thread's copies of tile t landed
    __syncthreads();              // ... and everyone's; t-2 is stored
    if (t + kStages - 2 < tiles) load(t + kStages - 2);
    commit_copies();
    if (threadIdx.x < ROWS) {
      acc = walk<T::cols / 4>(
          reinterpret_cast<float4*>(ring + (t % kStages) * T::floats +
                                    threadIdx.x * T::stride),
          acc);
    } else if (threadIdx.x >= 32 && t > 0) {
      store(t - 1);
    }
  }
  __syncthreads();
  if (tiles > 0 && threadIdx.x >= 32) store(tiles - 1);
  if (threadIdx.x < ROWS) s_tail[threadIdx.x] = __fadd_rn(acc, 0.f);
  __syncthreads();

  // columns past every row's count: the serial sum of +0.0 pads, i.e.
  // each row's last value plus +0.0
  const long long f0 = tiles * T::cols;
  for (int r = 0; r < nrows && f0 < K; ++r) {
    const float v = s_tail[r];
    float* yr = yb + r * K;
    if (VEC) {
      const float4 v4 = make_float4(v, v, v, v);
      for (long long c = f0 + 4 * threadIdx.x; c < K; c += 4 * kThreads)
        *reinterpret_cast<float4*>(yr + c) = v4;
    } else {
      for (long long c = f0 + threadIdx.x; c < K; c += kThreads) yr[c] = v;
    }
  }
}

constexpr int kMaxDevices = 64;

template <int ROWS, bool VEC>
int launch(const float* x, float* y, const long long* n_valid, long long B,
           long long K, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * Tile<ROWS>::floats * sizeof(float);
  static bool opted_in[kMaxDevices];  // the >48 KB opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    err = cudaFuncSetAttribute(seqsum_rows_kernel<ROWS, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  const long long blocks = (B + ROWS - 1) / ROWS;
  seqsum_rows_kernel<ROWS, VEC><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, y, n_valid, B, K);
  return (int)cudaGetLastError();
}

template <int ROWS>
int launch_rows(const float* x, float* y, const long long* n_valid,
                long long B, long long K, cudaStream_t stream) {
  const bool vec = K % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  return vec ? launch<ROWS, true>(x, y, n_valid, B, K, stream)
             : launch<ROWS, false>(x, y, n_valid, B, K, stream);
}

// Short rows (K <= kShortK, e.g. the survey prefix's (B, 16)): one thread
// per row holds the row in registers, read with 16-byte loads where the
// rows are 16-byte aligned (K % 4 == 0 and an aligned base). Its loads do
// not wait on each other, so the chain waits on memory once. Slots at or
// past n_valid are not read.
__global__ void __launch_bounds__(kShortThreads) seqsum_short_kernel(
    const float* __restrict__ x, float* __restrict__ y,
    const long long* __restrict__ n_valid, long long B, int K) {
  const long long b = (long long)blockIdx.x * kShortThreads + threadIdx.x;
  if (b >= B) return;
  const long long nv = n_valid != nullptr
                           ? max(0LL, min(n_valid[b], (long long)K)) : K;
  const float* xr = x + b * K;
  float* yr = y + b * K;
  const bool vec = K % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)y % 16 == 0;
  float v[kShortK];
#pragma unroll
  for (int k = 0; k < kShortK; k += 4) {
    if (vec && k + 4 <= nv) {
      const float4 q = *reinterpret_cast<const float4*>(xr + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[k + i] = k + i < nv ? xr[k + i] : 0.f;
    }
  }
  float acc = 0.0f;                 // the reference's `mass = 0`
#pragma unroll
  for (int k = 0; k < kShortK; ++k) {
    acc = __fadd_rn(acc, v[k]);
    v[k] = acc;
  }
#pragma unroll
  for (int k = 0; k < kShortK; k += 4) {
    if (vec && k < K) {
      *reinterpret_cast<float4*>(yr + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
    } else if (!vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k + i < K) yr[k + i] = v[k + i];
    }
  }
}

}  // namespace

// y = the serial cumsum of x (B, K) row-major, slots at or past n_valid[b]
// read as +0.0 (n_valid may be null: every slot valid). rows: the tiled
// kernel's rows per block, one of 1, 4, 16, 32, or 0 for the short-row
// kernel (K <= 32).
extern "C" int so_seqsum_rows(const float* x, float* y,
                              const long long* n_valid, long long B,
                              long long K, int rows, void* stream) {
  if (B <= 0 || K <= 0 || rows < 0 || rows > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (rows == 0) {
    const long long blocks = (B + kShortThreads - 1) / kShortThreads;
    if (K > kShortK || blocks > 2147483647LL)
      return (int)cudaErrorInvalidValue;
    seqsum_short_kernel<<<(unsigned)blocks, kShortThreads, 0, s>>>(
        x, y, n_valid, B, (int)K);
    return (int)cudaGetLastError();
  }
  if ((B + rows - 1) / rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1: return launch_rows<1>(x, y, n_valid, B, K, s);
    case 4: return launch_rows<4>(x, y, n_valid, B, K, s);
    case 16: return launch_rows<16>(x, y, n_valid, B, K, s);
    case 32: return launch_rows<32>(x, y, n_valid, B, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

