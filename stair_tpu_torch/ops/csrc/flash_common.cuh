// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) kernels share: the two-integer mask, the mma.sync
// bf16 product, and the staging of a bf16 tile into padded shared memory.
#pragma once

#include "common.cuh"

#include <stdint.h>

namespace stair {

constexpr float MASK_VALUE = -1e30f;
constexpr int PAD = 8;       // bf16 elements of row padding in shared memory

// Column ``col`` is live for query row ``row``: below ``valid`` and either
// not causal, on or below the diagonal, or inside the visible prefix.
__device__ __forceinline__ bool live(int row, int col, int valid, int prefix,
                                     int causal) {
  return col < valid && (!causal || col <= row || col < prefix);
}

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

// Stage ``rows`` x D bf16 (16-byte chunks) into shared memory with row
// stride D + PAD; rows at or past ``limit`` become zeros. NT threads.
template <int D, int NT>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int first,
                                           int limit, int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit)
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(first + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + PAD) + c * 8) = val;
  }
}

// The 16 x 16 bf16 A fragment (row-major) of mma m16n8k16 whose top-left
// element is ``base`` in a shared tile of row stride ``ld``: g = lane / 4
// is the row, t = lane % 4 the column pair.
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4],
                                            const __nv_bfloat16* base, int ld,
                                            int g, int t) {
  const __nv_bfloat16* p = base + g * ld + t * 2;
  f[0] = *reinterpret_cast<const uint32_t*>(p);
  f[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  f[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  f[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

// ldmatrix x4 .trans of a 16 (rows, the product's depth) x 16 (columns)
// block at ``base``: registers 0,1 are the B fragment of columns 0-7,
// registers 2,3 of columns 8-15.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const __nv_bfloat16* base, int ld,
                                             int lane) {
  const __nv_bfloat16* p =
      base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(addr));
}

}  // namespace stair
