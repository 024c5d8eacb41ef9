// Shared device helpers for the port's kernels: dtype conversion with the
// rounding the JAX package applies (float32 -> bf16 round-to-nearest-even,
// as XLA's astype), warp reductions, and the executor's counter-hash
// dropout mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace stair {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 value to T and back (the JAX package's `.astype(dt)`).
template <typename T>
__device__ __forceinline__ float rd(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Dropout keep factor of element (r, c) at one dropout site: the port of
// stair_tpu/ops/mega_exec.py hash_keep. JAX computes it in wrapping int32
// arithmetic with logical right shifts; uint32 arithmetic gives the same
// bits. Returns 1 / (1 - rate) (``scale``) where the 24-bit hash is at or
// above ``thresh`` = int(rate * 2^24), else 0. (r, c) is the 2-D iota of
// the site's shape; b the example, t the step, site the site number.
__device__ __forceinline__ float hash_keep(int r, int c, int b, int t,
                                           int site, int seed0, int seed1,
                                           unsigned thresh, float scale) {
  unsigned h = (unsigned)r * 0x9E3779B1u + (unsigned)c * 0x85EBCA77u;
  h ^= (unsigned)seed0 + (unsigned)b * 0xC2B2AE3Du +
       (unsigned)t * 0x27D4EB2Fu + (unsigned)site * 0x165667B1u;
  h += (unsigned)seed1;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const unsigned u = (h >> 8) & 0xFFFFFFu;
  return u >= thresh ? scale : 0.f;
}

// Dropout of one executor example: off (identity) unless ``on``.
struct Dropout {
  int on, seed0, seed1;
  unsigned thresh;
  float scale;
  __device__ __forceinline__ float keep(int r, int c, int b, int t,
                                        int site) const {
    return on ? hash_keep(r, c, b, t, site, seed0, seed1, thresh, scale)
              : 1.f;
  }
};

}  // namespace stair
