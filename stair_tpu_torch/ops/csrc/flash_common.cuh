// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) kernels share: the two-integer mask, the staging of
// a bf16 tile into padded shared memory (synchronous, or by cp.async for
// the forward's K/V ring) and the fragment loads of the mma.sync product.
#pragma once

#include "common.cuh"

namespace stair {

constexpr float MASK_VALUE = -1e30f;
constexpr int PAD = 8;       // bf16 elements of row padding in shared memory

// Column ``col`` is live for query row ``row``: below ``valid`` and either
// not causal, on or below the diagonal, or inside the visible prefix.
__device__ __forceinline__ bool live(int row, int col, int valid, int prefix,
                                     int causal) {
  return col < valid && (!causal || col <= row || col < prefix);
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

// stage_tile with cp.async: the copies are started, not waited for (the
// caller commits and waits). Rows at or past ``limit`` become zeros.
template <int D, int NT>
__device__ __forceinline__ void stage_tile_async(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 long long stride, int first,
                                                 int limit, int rows) {
  constexpr int CH = D / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = first + r < limit;
    cp_async16(dst + r * (D + PAD) + c * 8,
               src + (long long)(in ? first + r : first) * stride + c * 8,
               in);
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
  ldmatrix_x4_trans(
      b, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

}  // namespace stair
