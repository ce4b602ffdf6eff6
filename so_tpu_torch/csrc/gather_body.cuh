// The per-slot arithmetic of the gather kernels, defined once: the
// min-image distance with the reference's f32 association, the channel
// values, and the halo's constants. Both forms of K1 (slab_gather.cu) and
// K3 (piece_gather.cu) call these, so their bits cannot drift apart.
//
// Exactness: rintf (half to even, as jnp.round), __fdiv_rn, and the
// __fmul_rn/__fadd_rn/__fsub_rn intrinsics, so no FMA contraction can
// occur (the library is also built with -fmad=false). The pad stores that
// both gathers write past a halo's live slots are here too.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace so_gather {

constexpr int kMaxChan = 5;

// payload row per output channel (3 mass, 4/5/6 -> m*v, 7 meta)
struct ChanCodes {
  int c[kMaxChan];
};

// one halo's constants: center, box period, squared ball radius
struct Ball {
  float cx, cy, cz, px, py, pz, r2;
};

__device__ __forceinline__ Ball load_ball(const float* __restrict__ centers,
                                          const float* __restrict__ period,
                                          const float* __restrict__ r2,
                                          long long b) {
  Ball h;
  h.cx = centers[b * 3 + 0];
  h.cy = centers[b * 3 + 1];
  h.cz = centers[b * 3 + 2];
  h.px = period[0];
  h.py = period[1];
  h.pz = period[2];
  h.r2 = r2[b];
  return h;
}

// d = (c - p * rint((c - x) / p)) - x
__device__ __forceinline__ float min_image(float c, float p, float x) {
  return __fsub_rn(
      __fsub_rn(c, __fmul_rn(p, rintf(__fdiv_rn(__fsub_rn(c, x), p)))), x);
}

// d2 = (dx*dx + dy*dy) + dz*dz: never negative and never -0.0, so its
// bit pattern orders as the float does
__device__ __forceinline__ float min_image_d2(const Ball& h, float x, float y,
                                              float z) {
  const float dx = min_image(h.cx, h.px, x);
  const float dy = min_image(h.cy, h.py, y);
  const float dz = min_image(h.cz, h.pz, z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// rows 4-6 are raw velocities: their channel is m*v, ONE rounded multiply
__device__ __forceinline__ bool is_mv(int code) {
  return code >= 4 && code <= 6;
}

__device__ __forceinline__ float channel_value(int code, float mass, float v) {
  return is_mv(code) ? __fmul_rn(mass, v) : v;
}

// the channel of payload row `code` at source row `row`, read from the
// (8, Np) payload (the mass row only where the channel is m*v)
__device__ __forceinline__ float load_channel(const float* __restrict__ soa,
                                              long long np_cols, int code,
                                              long long row) {
  const float v = soa[(long long)code * np_cols + row];
  return channel_value(code, is_mv(code) ? soa[3 * np_cols + row] : 0.f, v);
}

// 4-byte pad stores over slots [s0, s1) of one halo.
__device__ __forceinline__ void fill_pad4(float* __restrict__ o,
                                          long long fstride, int nchan,
                                          int* __restrict__ oi, long long s0,
                                          long long s1, int tid, int nt) {
  for (long long s = s0 + tid; s < s1; s += nt) {
    o[s] = INFINITY;
    for (int c = 0; c < nchan; ++c) o[(c + 1) * fstride + s] = 0.f;
    if (oi != nullptr) oi[s] = -1;
  }
}

// Pad values over slots [s0, s1) of one halo: +inf in the d2 row at o, 0
// in the nchan channel rows fstride apart after it, -1 in the idx row.
// vec: every row base is 16-byte aligned (K % 4 == 0, aligned tensors);
// then slots [head, tail) take 16-byte stores.
__device__ __forceinline__ void fill_pad(float* __restrict__ o,
                                         long long fstride, int nchan,
                                         int* __restrict__ oi, long long s0,
                                         long long s1, bool vec, int tid,
                                         int nt) {
  if (!vec) {
    fill_pad4(o, fstride, nchan, oi, s0, s1, tid, nt);
    return;
  }
  const long long head = min(s1, (s0 + 3) & ~3LL);
  const long long tail = head + ((s1 - head) & ~3LL);
  const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int4 neg4 = make_int4(-1, -1, -1, -1);
  fill_pad4(o, fstride, nchan, oi, s0, head, tid, nt);
  for (long long s = head + 4LL * tid; s < tail; s += 4LL * nt) {
    *reinterpret_cast<float4*>(o + s) = inf4;
    for (int c = 0; c < nchan; ++c)
      *reinterpret_cast<float4*>(o + (c + 1) * fstride + s) = zero4;
    if (oi != nullptr) *reinterpret_cast<int4*>(oi + s) = neg4;
  }
  fill_pad4(o, fstride, nchan, oi, tail, s1, tid, nt);
}

// host: may a pointer take 16-byte accesses
inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace so_gather
