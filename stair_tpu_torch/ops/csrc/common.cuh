// Shared device helpers for the port's kernels: dtype conversion with the
// rounding the JAX package applies (float32 -> bf16 round-to-nearest-even,
// as XLA's astype), warp reductions, the bf16 tensor-core product and its
// operand loads, asynchronous copies, and the executor's counter-hash
// dropout mask.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// c += a b on the tensor cores: mma.sync m16n8k16, bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// ldmatrix x4 from shared memory (lane l addresses row l % 8 of matrix
// l / 8), plain or transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Asynchronous copies global -> shared of 16 bytes (cp.async.cg, through
// L2 only) or 4 bytes (cp.async.ca); ``in`` false fills the destination
// with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
