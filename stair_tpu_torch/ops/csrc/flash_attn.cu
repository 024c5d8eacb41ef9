// Masked flash attention, forward (replaces the TPU kernel
// stair_tpu/ops/attention.py _flash_kernel, TPU kernel #7).
//
// out[b, h, r, :] = softmax_c(scale * q[b, h, r] . k[b, h / G, c] | mask) v
// with the mask given by two integers per example: column c is live for
// row r when c < valid and (not causal, or c <= r, or c < prefix); rows at
// or past valid are padding (out 0, lse +inf). G = H / Hkv: grouped-query
// heads index their kv head directly, k and v are never expanded.
//
// What bounds it on an H100: per head the two products cost 4 D operations
// per live (row, column) pair, about 2 L^2 D under a causal mask, against
// 8 L D bytes of q, k, v and out in bf16: L / 4 operations per byte, below
// the card's ~295 until L ~ 1200. At this repo's lengths (L 128 to 640) the
// bound is therefore the bytes, as long as the [L, L] scores never reach
// device memory. The design keeps them on chip: one block per (example,
// head, 64 query rows) walks the live key tiles once, with scores, the
// running max and sum and the output accumulator in registers, and K/V
// tiles staged in shared memory (K/V are re-read once per query tile, from
// L2 at these sizes). Tiles wholly above the diagonal and past the prefix,
// or past valid, are never visited; a block whose rows are all padding
// writes zeros and leaves. It is a simple kernel: tile loads are
// synchronous (no cp.async or TMA pipeline) and the products are mma.sync,
// not wgmma, so it runs at several times its bound; chip_smoke.py prints
// both numbers.
//
// Two kernels share that shape:
//  - flash_fwd_mma (bf16, head_dim 64 or 128, 16-byte aligned rows): the
//    products run on the tensor cores through mma.sync m16n8k16 with
//    float32 accumulation; each warp owns 16 query rows; the score
//    accumulators are re-packed in registers as the A operand of P V and
//    V's B operand comes through ldmatrix.trans;
//  - flash_fwd_simple (float32 or bf16, any head_dim <= 128, any strides):
//    plain float32 FMA loops, one key column per lane; it is the exact
//    float32 route and takes the shapes the tensor-core kernel refuses.
// Both mask ragged edges themselves (lengths need not divide a tile), use
// MASK_VALUE = -1e30 with the running max starting at -inf (a later live
// column wipes an all-masked tile through alpha = 0, and inf - inf never
// occurs because the new max is finite), round p to v's type before P V,
// sum p before that rounding, and divide once at the end.
#include "flash_common.cuh"

namespace stair {

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Lq] or null
  const int* prefix_len;
  const int* valid_len;
  long long q_sb, q_sh, q_sl;  // element strides: batch, head, row
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  int B, H, Hkv, Lq, Lkv, D;
  int causal, bf16, mma;
  float sm_scale;
};

constexpr int BQ = 64;       // query rows per block (16 per warp)
constexpr int THREADS = 128;

// The key range [0, kv_end) a query tile starting at q0 has to visit.
__device__ __forceinline__ int kv_end_of(int q0, int valid, int prefix,
                                         int causal) {
  int end = valid;
  if (causal) end = min(end, max(q0 + BQ, prefix));
  return end;
}

// A block whose rows are all padding: zeros and +inf.
template <typename T>
__device__ void write_dead_tile(const FlashArgs& a, int b, int h, int q0) {
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;
  const int rows = min(BQ, a.Lq - q0);
  for (int i = threadIdx.x; i < rows * a.D; i += THREADS) {
    const int r = i / a.D, d = i % a.D;
    o[(long long)(q0 + r) * a.o_sl + d] = from_f<T>(0.f);
  }
  if (a.lse)
    for (int r = threadIdx.x; r < rows; r += THREADS)
      a.lse[((long long)b * a.H + h) * a.Lq + q0 + r] = INFINITY;
}

// ---------------------------------------------------------------------------
// float32 FMA kernel (any dtype, any head_dim <= 128)
// ---------------------------------------------------------------------------

constexpr int SKV = 32;      // key columns per tile: one per lane
constexpr int SROWS = 16;    // query rows per warp
constexpr int SDJ = 4;       // head_dim / 32, at most

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simple(const FlashArgs a) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* Qs = smem;                      // [BQ][D]
  float* Ks = Qs + BQ * D;               // [SKV][D + 1]
  float* Vs = Ks + SKV * (D + 1);        // [SKV][D]
  float* Ps = Vs + SKV * D;              // [4][SROWS][SKV]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];         // rows at or past it: padding
  const int valid = min(valid_q, a.Lkv);      // live key columns end here
  const int prefix = a.prefix_len[b];
  if (q0 >= valid_q || valid <= 0) {
    write_dead_tile<T>(a, b, h, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    Qs[i] = q0 + r < a.Lq ? to_f(q[(long long)(q0 + r) * a.q_sl + d]) : 0.f;
  }

  float m[SROWS], l[SROWS], acc[SROWS][SDJ];
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < SDJ; ++j) acc[r][j] = 0.f;
  }
  float* Pw = Ps + warp * SROWS * SKV;
  const float* Qw = Qs + warp * SROWS * D;
  const int row0 = q0 + warp * SROWS;

  const int kv_end = kv_end_of(q0, valid, prefix, a.causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += SKV) {
    __syncthreads();
    for (int i = tid; i < SKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = kv0 + c < a.Lkv;
      Ks[c * (D + 1) + d] =
          in ? to_f(k[(long long)(kv0 + c) * a.k_sl + d]) : 0.f;
      Vs[c * D + d] = in ? to_f(v[(long long)(kv0 + c) * a.v_sl + d]) : 0.f;
    }
    __syncthreads();

    float s[SROWS];
#pragma unroll
    for (int r = 0; r < SROWS; ++r) s[r] = 0.f;
    const float* Kl = Ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = Kl[d];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) s[r] = fmaf(Qw[r * D + d], kd, s[r]);
    }
    const int col = kv0 + lane;
#pragma unroll
    for (int r = 0; r < SROWS; ++r) {
      const float sv = live(row0 + r, col, valid, prefix, a.causal)
                           ? s[r] * a.sm_scale : MASK_VALUE;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < SDJ; ++j) acc[r][j] *= alpha;
      Pw[r * SKV + lane] = rd<T>(p);
    }
    __syncwarp();
    for (int c = 0; c < SKV; ++c) {
      float vj[SDJ];
#pragma unroll
      for (int j = 0; j < SDJ; ++j) {
        const int d = lane + 32 * j;
        vj[j] = d < D ? Vs[c * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        const float p = Pw[r * SKV + c];
#pragma unroll
        for (int j = 0; j < SDJ; ++j) acc[r][j] = fmaf(p, vj[j], acc[r][j]);
      }
    }
    __syncwarp();
  }

  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    const int row = row0 + r;
    if (row >= a.Lq) break;
    const bool pad = row >= valid_q || l[r] == 0.f;
    const float inv = pad ? 0.f : 1.f / l[r];
#pragma unroll
    for (int j = 0; j < SDJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) o[(long long)row * a.o_sl + d] = from_f<T>(acc[r][j] * inv);
    }
    if (a.lse && lane == 0)
      a.lse[((long long)b * a.H + h) * a.Lq + row] =
          pad ? INFINITY : m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, head_dim 64 or 128)
// ---------------------------------------------------------------------------

constexpr int MKV = 64;      // key rows per tile

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const FlashArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NT = MKV / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;    // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Ks = Qs + BQ * LD;                    // [MKV][LD]
  T* Vs = Ks + MKV * LD;                   // [MKV][LD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];         // rows at or past it: padding
  const int valid = min(valid_q, a.Lkv);      // live key columns end here
  const int prefix = a.prefix_len[b];
  if (q0 >= valid_q || valid <= 0) {
    write_dead_tile<T>(a, b, h, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates

  stage_tile<D, THREADS>(Qs, q, a.q_sl, q0, a.Lq, BQ);
  __syncthreads();
  // This warp's 16 query rows as A fragments, kept for the whole walk.
  uint32_t qf[KS][4];
  {
    const T* base = Qs + (warp * 16 + g) * LD + t * 2;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(base + kk * 16);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + kk * 16);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + kk * 16 + 8);
      qf[kk][3] =
          *reinterpret_cast<const uint32_t*>(base + 8 * LD + kk * 16 + 8);
    }
  }

  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // Row state of rows g (index 0) and g + 8 (index 1); l is this lane's
  // partial sum, reduced over the quad at the end.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_lo = q0 + warp * 16 + g;

  const int kv_end = kv_end_of(q0, valid, prefix, a.causal);
  for (int kv0 = 0; kv0 < kv_end; kv0 += MKV) {
    __syncthreads();
    stage_tile<D, THREADS>(Ks, k, a.k_sl, kv0, a.Lkv, MKV);
    stage_tile<D, THREADS>(Vs, v, a.v_sl, kv0, a.Lkv, MKV);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kb = Ks + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    float m_cur[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_lo + (i / 2) * 8;
        const int col = kv0 + n * 8 + t * 2 + (i % 2);
        s[n][i] = live(row, col, valid, prefix, a.causal)
                      ? s[n][i] * a.sm_scale : MASK_VALUE;
        m_cur[i / 2] = fmaxf(m_cur[i / 2], s[n][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m[r], m_cur[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i / 2]);
        l[i / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P V: two adjacent score n-tiles are one 16-deep A fragment.
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // ldmatrix x4 .trans: lanes 0-7 address key rows 0-7 of the step and
      // lanes 8-15 rows 8-15, at output columns n*8..; lanes 16-31 the
      // same rows at columns (n+1)*8... Registers 0,1 are the B fragment
      // of output tile n, registers 2,3 of tile n + 1.
      const T* vrow = Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
                      + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t b0, b1, b2, b3;
        const uint32_t addr =
            (uint32_t)__cvta_generic_to_shared(vrow + n * 8);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(o[n], pa, b0, b1);
        mma_bf16(o[n + 1], pa, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  T* out = (T*)a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    if (row >= a.Lq) continue;
    const bool pad = row >= valid_q || l[r] == 0.f;
    const float inv = pad ? 0.f : 1.f / l[r];
    T* orow = out + (long long)row * a.o_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (a.lse && t == 0)
      a.lse[((long long)b * a.H + h) * a.Lq + row] =
          pad ? INFINITY : m[r] + logf(l[r]);
  }
}

template <typename K>
cudaError_t launch(K kernel, const FlashArgs& a, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stair

extern "C" int stair_flash_attn_fwd(const stair::FlashArgs* args,
                                    void* stream) {
  using namespace stair;
  const FlashArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.D < 1 || a.D > 32 * SDJ) return (int)cudaErrorInvalidValue;
  if (a.mma) {
    if (!a.bf16 || (a.D != 64 && a.D != 128))
      return (int)cudaErrorInvalidValue;
    const size_t smem =
        (size_t)(BQ + 2 * MKV) * (a.D + PAD) * sizeof(__nv_bfloat16);
    return (int)(a.D == 64 ? launch(flash_fwd_mma<64>, a, smem, st)
                           : launch(flash_fwd_mma<128>, a, smem, st));
  }
  const size_t smem = sizeof(float) * ((size_t)BQ * a.D + SKV * (a.D + 1) +
                                       SKV * a.D + 4 * SROWS * SKV);
  return (int)(a.bf16 ? launch(flash_fwd_simple<__nv_bfloat16>, a, smem, st)
                      : launch(flash_fwd_simple<float>, a, smem, st));
}
