// What the flash-attention forward (flash_attn.cu) and backward
// (flash_attn_bwd.cu) kernels share: the route codes, the two-integer mask,
// the cp.async staging of a bf16 or float32 tile into padded shared memory
// for the kernels' tile rings, the fragment loads of the bf16 mma.sync
// product, and the float32 tile product in split TF32.
#pragma once

#include "common.cuh"

namespace stair {

// The kernels a launch runs, in FlashArgs.route and FlashBwdArgs.route
// (ops/attention.py route picks them, ROUTES in this order).
constexpr int ROUTE_SIMPLE = 0;  // float32 FMA loops: any shape
constexpr int ROUTE_MMA = 1;     // bf16 mma.sync: head_dim 64 / 128
constexpr int ROUTE_MMA32 = 2;   // float32 split-TF32 mma.sync: head_dim
                                 // 64 / 128, 16-byte aligned rows

// Every row of ``n`` float32 tensors starts on 16 bytes: each data pointer
// p[i] and each element stride s[3 i .. 3 i + 2] (batch, head, row) is a
// multiple of 16 bytes, 4 floats (what the float32 tensor-core kernels'
// 16-byte cp.async chunks and 8-byte stores need).
inline bool rows_aligned16(const void* const* p, const long long* s, int n) {
  for (int i = 0; i < n; ++i) {
    if ((uintptr_t)p[i] % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (s[3 * i + j] % 4) return false;
  }
  return true;
}

constexpr float MASK_VALUE = -1e30f;
constexpr int PAD = 8;       // bf16 elements of row padding in shared memory
constexpr int PAD32 = 4;     // float32 elements of row padding: a row of
                             // D + 4 floats puts the 8 rows x 4 columns of a
                             // tf32 fragment load on 32 distinct banks
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

// ---------------------------------------------------------------------------
// float32 tiles on the tensor cores: mma.sync m16n8k8 with TF32 inputs and
// float32 sums, each product taken as three TF32 products. x = hi + lo
// with hi = x with its low 13 mantissa bits cleared (a TF32 value) and lo =
// x - hi, exact; the tensor cores read a TF32 operand's top 19 bits and
// ignore the rest, so lo enters as tf32(lo), and |x - hi - tf32(lo)| <
// 2^-20 |x|. Then a b = ah bh + ah bl + al bh with al bl (< 2^-20 |a b|)
// dropped: about float32's accuracy (3-7e-6 from the float32 plain version
// at the repo's attention shapes), where one TF32 product keeps ~3 digits.
// A split is two operations (an AND, a subtraction); the kernel is bound
// by issue more than by the tensor cores, and cvt.rna.tf32.f32 on both
// halves, or hi rounded to nearest, ran 5-30% slower for an error about
// 1.5x smaller (unkept source variants, H100).
// Fragment coordinates: g = lane / 4, t = lane % 4; A (16 x 8, row-major)
// holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8, k x n)
// holds (t, g), (t + 4, g); C holds (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
// ---------------------------------------------------------------------------

// Start copying ``rows`` x D float32 (16-byte chunks) into shared memory
// with row stride LD by cp.async; the caller commits and waits. Rows at or
// past ``limit`` become zeros. NT threads.
template <int D, int LD, int NT>
__device__ __forceinline__ void stage_tile_f32_async(float* dst,
                                                     const float* src,
                                                     long long stride,
                                                     int first, int limit,
                                                     int rows) {
  constexpr int CH = D / 4;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool in = first + r < limit;
    cp_async16(dst + r * LD + c * 4,
               src + (long long)(in ? first + r : first) * stride + c * 4,
               in);
  }
}

// x as hi + lo (the comment above): hi TF32, lo a float32 whose low bits
// the tensor cores ignore.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b: mma.sync m16n8k8, TF32 in, float32 sums.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b to about float32 accuracy: the split operands' three products,
// the two small ones first.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// The split A fragment of the 16 x 8 block at ``base`` of a float32 tile
// of row stride ``ld`` (rows g, g + 8; columns t, t + 4).
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float* base, int ld,
                                             int g, int t) {
  split_tf32(base[g * ld + t], hi[0], lo[0]);
  split_tf32(base[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(base[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(base[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// The split B fragment of an 8-deep slice of a product whose B^T is
// row-major in shared memory (B^T rows = the product's columns): B(k, n) =
// base[n ld + k], so the fragment reads base[g ld + t] and base[g ld + t +
// 4] (K as stored for S = Q K^T).
__device__ __forceinline__ void load_bt_split(uint32_t (&hi)[2],
                                              uint32_t (&lo)[2],
                                              const float* base, int ld,
                                              int g, int t) {
  split_tf32(base[g * ld + t], hi[0], lo[0]);
  split_tf32(base[g * ld + t + 4], hi[1], lo[1]);
}

// An accumulator tile (16 x 8, C's layout) as the split A fragment of the
// next product, without shared memory: C holds columns 2t, 2t + 1 where A
// wants depth t, t + 4, so depth t is taken as column 2t and t + 4 as
// 2t + 1. The B operand reads its rows in the same permuted order
// (load_b_perm_split); a float32 sum over the depth may run in any order.
__device__ __forceinline__ void acc_as_a_split(uint32_t (&hi)[4],
                                               uint32_t (&lo)[4],
                                               const float (&c)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
}

// The split B fragment of an 8-deep slice whose B is row-major in shared
// memory (rows = the product's depth), in acc_as_a_split's permuted depth
// order: base[2t ld + g] and base[(2t + 1) ld + g]. Rows 2t ld apart put
// the 32 lanes on distinct banks at ld = D + PAD32.
__device__ __forceinline__ void load_b_perm_split(uint32_t (&hi)[2],
                                                  uint32_t (&lo)[2],
                                                  const float* base, int ld,
                                                  int g, int t) {
  split_tf32(base[2 * t * ld + g], hi[0], lo[0]);
  split_tf32(base[(2 * t + 1) * ld + g], hi[1], lo[1]);
}

// S (16 rows x NT * 8 keys) = A K^T in split TF32 for one warp: ``qa(kk,
// hi, lo)`` gives the warp's split A fragment of depth slice kk (from
// registers or shared memory), Kt the key tile, row-major with stride LD.
template <int D, int NT, int LD, typename QA>
__device__ __forceinline__ void scores_tf32x3(float (&s)[NT][4], QA qa,
                                              const float* Kt, int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t ah[4], al[4];
    qa(kk, ah, al);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bh[2], bl[2];
      load_bt_split(bh, bl, Kt + n * 8 * LD + kk * 8, LD, g, t);
      mma_tf32x3(s[n], ah, al, bh, bl);
    }
  }
}

}  // namespace stair
