// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) kernels share: the two-integer mask, the cp.async
// staging of a bf16 tile into padded shared memory for the kernels' tile
// rings, and the fragment loads of the mma.sync product.
#pragma once

#include "common.cuh"

namespace stair {

constexpr float MASK_VALUE = -1e30f;
constexpr int PAD = 8;       // bf16 elements of row padding in shared memory
constexpr int STAGES = 2;    // tiles in flight in a cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

// Column ``col`` is live for query row ``row``: below ``valid`` and either
// not causal, on or below the diagonal, or inside the visible prefix.
__device__ __forceinline__ bool live(int row, int col, int valid, int prefix,
                                     int causal) {
  return col < valid && (!causal || col <= row || col < prefix);
}

// The key range [0, kv_end) a tile of ``rows`` query rows starting at q0
// has to visit.
__device__ __forceinline__ int kv_end_of(int q0, int rows, int valid,
                                         int prefix, int causal) {
  int end = valid;
  if (causal) end = min(end, max(q0 + rows, prefix));
  return end;
}

// Start copying ``rows`` x D bf16 (16-byte chunks) into shared memory with
// row stride D + PAD by cp.async; the caller commits and waits. Rows at or
// past ``limit`` become zeros. NT threads.
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
// element is ``base`` in a shared tile of row stride ``ld``, in one
// ldmatrix x4 (matrices: rows 0-7 / 8-15 x columns 0-7, then rows 0-7 /
// 8-15 x columns 8-15).
__device__ __forceinline__ void load_a_frag(uint32_t (&f)[4],
                                            const __nv_bfloat16* base, int ld,
                                            int lane) {
  ldmatrix_x4(
      f, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8);
}

// The B fragments of two adjacent n-tiles of a product whose B^T is
// row-major in shared memory (B^T rows = the product's columns, B^T
// columns = its depth): ldmatrix x4 of the 16 x 16 block at ``base``;
// registers 0,1 are the fragment of B^T rows 0-7, 2,3 of rows 8-15.
__device__ __forceinline__ void load_b_frags(uint32_t (&b)[4],
                                             const __nv_bfloat16* base,
                                             int ld, int lane) {
  ldmatrix_x4(
      b, base + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
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
