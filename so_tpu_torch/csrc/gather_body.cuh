// The per-slot arithmetic of the gather kernels, defined once: the
// min-image distance with the reference's f32 association, the channel
// values, and the halo's constants. Both forms of K1 (slab_gather.cu) and
// K3 (piece_gather.cu) call these, so their bits cannot drift apart.
//
// Exactness: rintf (half to even, as jnp.round), __fdiv_rn, and the
// __fmul_rn/__fadd_rn/__fsub_rn intrinsics, so no FMA contraction can
// occur (the library is also built with -fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace so_gather
