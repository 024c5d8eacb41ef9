// Masked flash attention, backward (replaces the TPU kernels
// stair_tpu/ops/attention.py _bwd_dq_kernel and _bwd_dkv_kernel, TPU
// kernels #8 and #9).
//
// Given q, k, v, the forward's row log-sum-exp ``lse`` and the cotangent
// ``dO`` (plus di = rowsum(O * dO), which the wrapper computes), with the
// forward's two-integer mask:
//   S  = scale * Q K^T            P  = exp(S - lse) on live pairs, else 0
//   dP = dO V^T                   dS = P * (dP - di) * scale
//   dQ = dS K      dV = P^T dO      dK = dS^T Q
// Two launches, no float atomics, so every output element is written once
// by one thread and the bits repeat run to run:
//  - the dQ kernel: one block per (example, query head, 64 query rows)
//    walks the live key tiles (the forward's range) with dQ in registers;
//  - the dK/dV kernel: one block per (example, kv head, key tile) walks the
//    query heads of its group in ascending order and, for each, the live
//    query tiles, with dK and dV in registers. Grouped-query heads are
//    summed here, in float32, in that fixed order; k and v are never
//    expanded.
// Key tiles past ``valid`` and query tiles wholly above the diagonal (and
// past the prefix) are never visited. Query rows at or past ``valid`` are
// padding: their dO is read as 0 and their P is 0, so dQ is 0 there and
// they add nothing to dK/dV; dK/dV rows at or past ``valid`` are 0. A
// masked pair never reaches exp, so (-1e30) - (+inf) and inf - inf do not
// occur and valid = 0 gives zeros.
//
// Rounding sites (float32 everywhere else): P is rounded to the input type
// before P^T dO and dS before dS K and dS^T Q (no-ops in float32).
//
// What bounds it on an H100: per live (row, column) pair and head the dQ
// kernel does three products of depth D (6 D operations) and the dK/dV
// kernel four (8 D; Q K^T and dO V^T are computed in both), against q, k,
// v, dO read and dQ (or dK, dV) written once: about 2 L^2 D operations per
// head under a causal mask against 12 L D bytes in bf16, L / 6 operations
// per byte, below the card's ~295 until L ~ 1800. At this repo's lengths
// (L 128 to 640) the bound is the bytes, as for the forward. The design
// keeps S, P, dP and dS on chip and re-reads the other operand's tiles
// from L2. Like the forward it is a simple kernel: synchronous tile loads,
// mma.sync products, no wgmma/TMA pipeline, so it runs at several times
// its bound; chip_smoke.py prints both numbers.
//
// Two variants per kernel behind one C entry point each:
//  - *_mma (bf16, head_dim 64 or 128, 16-byte aligned rows): mma.sync
//    m16n8k16 with float32 accumulation. The dK/dV kernel computes the
//    transposed tiles S^T = K Q^T and dP^T = V dO^T so that each warp owns
//    16 key rows and P^T, dS^T come out of the accumulators in the layout
//    the next product's A operand wants;
//  - *_simple (float32 or bf16, any head_dim <= 128, any strides): float32
//    FMA loops; the exact float32 route and the shapes the other refuses.
#include "flash_common.cuh"

namespace stair {

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // [B, H, Lq]
  const float* di;   // [B, H, Lq]
  void* dq;
  void* dk;
  void* dv;
  const int* prefix_len;
  const int* valid_len;
  long long q_sb, q_sh, q_sl;  // element strides: batch, head, row
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int B, H, Hkv, Lq, Lkv, D;
  int causal, bf16, mma;
  float sm_scale;
};

constexpr int THREADS = 128;
constexpr int BQ = 64;       // query rows per dQ block (16 per warp)
constexpr int SDJ = 4;       // head_dim / 32, at most

template <typename T>
__device__ void zero_rows(T* base, long long stride, int first, int rows,
                          int D) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, d = i % D;
    base[(long long)(first + r) * stride + d] = from_f<T>(0.f);
  }
}

// The first query row a key tile starting at kv0 can be live for, rounded
// down to a multiple of ``step``.
__device__ __forceinline__ int q_begin_of(int kv0, int prefix, int causal,
                                          int step) {
  return (causal && kv0 >= prefix) ? (kv0 / step) * step : 0;
}

// ---------------------------------------------------------------------------
// float32 FMA kernels (any dtype, any head_dim <= 128)
// ---------------------------------------------------------------------------

constexpr int SKV = 32;      // dQ: key columns per tile, one per lane
constexpr int SROWS = 16;    // dQ: query rows per warp
constexpr int SQ = 32;       // dK/dV: query rows per tile, one per lane
constexpr int SBKV = 32;     // dK/dV: key rows per block
constexpr int CW = 8;        // dK/dV: key rows per warp

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_simple(const FlashBwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* Qs = smem;                      // [BQ][D]
  float* Gs = Qs + BQ * D;               // [BQ][D]       dO
  float* Ks = Gs + BQ * D;               // [SKV][D + 1]
  float* Vs = Ks + SKV * (D + 1);        // [SKV][D + 1]
  float* Ps = Vs + SKV * (D + 1);        // [4][SROWS][SKV]  dS

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dq = (T*)a.dq + b * a.dq_sb + h * a.dq_sh;
  if (q0 >= valid_q || valid <= 0) {
    zero_rows<T>(dq, a.dq_sl, q0, min(BQ, a.Lq - q0), D);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* go = (const T*)a.dout + b * a.do_sb + h * a.do_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_end = min(a.Lq, valid_q);   // rows at or past it: padding

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const bool in = q0 + r < q_end;
    Qs[i] = in ? to_f(q[(long long)(q0 + r) * a.q_sl + d]) : 0.f;
    Gs[i] = in ? to_f(go[(long long)(q0 + r) * a.do_sl + d]) : 0.f;
  }

  const int row0 = q0 + warp * SROWS;
  float lse_r[SROWS], di_r[SROWS], acc[SROWS][SDJ];
  const long long stat = ((long long)b * a.H + h) * a.Lq;
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    const bool in = row0 + r < q_end;
    lse_r[r] = in ? a.lse[stat + row0 + r] : INFINITY;
    di_r[r] = in ? a.di[stat + row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < SDJ; ++j) acc[r][j] = 0.f;
  }
  float* Pw = Ps + warp * SROWS * SKV;
  const float* Qw = Qs + warp * SROWS * D;
  const float* Gw = Gs + warp * SROWS * D;

  int kv_end = valid;
  if (a.causal) kv_end = min(kv_end, max(q0 + BQ, prefix));
  for (int kv0 = 0; kv0 < kv_end; kv0 += SKV) {
    __syncthreads();
    for (int i = tid; i < SKV * D; i += THREADS) {
      const int c = i / D, d = i % D;
      const bool in = kv0 + c < a.Lkv;
      Ks[c * (D + 1) + d] =
          in ? to_f(k[(long long)(kv0 + c) * a.k_sl + d]) : 0.f;
      Vs[c * (D + 1) + d] =
          in ? to_f(v[(long long)(kv0 + c) * a.v_sl + d]) : 0.f;
    }
    __syncthreads();

    float s[SROWS], dp[SROWS];
#pragma unroll
    for (int r = 0; r < SROWS; ++r) s[r] = dp[r] = 0.f;
    const float* Kl = Ks + lane * (D + 1);
    const float* Vl = Vs + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = Kl[d], vd = Vl[d];
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        s[r] = fmaf(Qw[r * D + d], kd, s[r]);
        dp[r] = fmaf(Gw[r * D + d], vd, dp[r]);
      }
    }
    const int col = kv0 + lane;
#pragma unroll
    for (int r = 0; r < SROWS; ++r) {
      const int row = row0 + r;
      const bool ok = row < q_end && live(row, col, valid, prefix, a.causal);
      const float p = ok ? expf(s[r] * a.sm_scale - lse_r[r]) : 0.f;
      Pw[r * SKV + lane] = rd<T>(p * (dp[r] - di_r[r]) * a.sm_scale);
    }
    __syncwarp();
    for (int c = 0; c < SKV; ++c) {
      float kj[SDJ];
#pragma unroll
      for (int j = 0; j < SDJ; ++j) {
        const int d = lane + 32 * j;
        kj[j] = d < D ? Ks[c * (D + 1) + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < SROWS; ++r) {
        const float ds = Pw[r * SKV + c];
#pragma unroll
        for (int j = 0; j < SDJ; ++j) acc[r][j] = fmaf(ds, kj[j], acc[r][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    const int row = row0 + r;
    if (row >= a.Lq) break;
#pragma unroll
    for (int j = 0; j < SDJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) dq[(long long)row * a.dq_sl + d] = from_f<T>(acc[r][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_simple(const FlashBwdArgs a) {
  extern __shared__ float smem[];
  const int D = a.D;
  float* Ks = smem;                      // [SBKV][D]
  float* Vs = Ks + SBKV * D;             // [SBKV][D]
  float* Qs = Vs + SBKV * D;             // [SQ][D + 1]
  float* Gs = Qs + SQ * (D + 1);         // [SQ][D + 1]   dO
  float* Ps = Gs + SQ * (D + 1);         // [4][CW][SQ]   P
  float* Ss = Ps + 4 * CW * SQ;          // [4][CW][SQ]   dS

  const int kv0 = blockIdx.x * SBKV, hk = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dk = (T*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  T* dv = (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
  if (kv0 >= valid) {
    const int rows = min(SBKV, a.Lkv - kv0);
    zero_rows<T>(dk, a.dk_sl, kv0, rows, D);
    zero_rows<T>(dv, a.dv_sl, kv0, rows, D);
    return;
  }
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.H / a.Hkv;

  for (int i = tid; i < SBKV * D; i += THREADS) {
    const int c = i / D, d = i % D;
    const bool in = kv0 + c < a.Lkv;
    Ks[i] = in ? to_f(k[(long long)(kv0 + c) * a.k_sl + d]) : 0.f;
    Vs[i] = in ? to_f(v[(long long)(kv0 + c) * a.v_sl + d]) : 0.f;
  }

  float acc_k[CW][SDJ], acc_v[CW][SDJ];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int j = 0; j < SDJ; ++j) acc_k[c][j] = acc_v[c][j] = 0.f;
  const float* Kw = Ks + warp * CW * D;
  const float* Vw = Vs + warp * CW * D;
  float* Pw = Ps + warp * CW * SQ;
  float* Sw = Ss + warp * CW * SQ;
  const int col0 = kv0 + warp * CW;

  const int q_end = min(a.Lq, valid_q);
  const int q_begin = q_begin_of(kv0, prefix, a.causal, SQ);
  for (int hq = hk * G; hq < hk * G + G; ++hq) {
    const T* q = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
    const T* go = (const T*)a.dout + b * a.do_sb + hq * a.do_sh;
    const long long stat = ((long long)b * a.H + hq) * a.Lq;
    for (int r0 = q_begin; r0 < q_end; r0 += SQ) {
      __syncthreads();
      for (int i = tid; i < SQ * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const bool in = r0 + r < q_end;
        Qs[r * (D + 1) + d] =
            in ? to_f(q[(long long)(r0 + r) * a.q_sl + d]) : 0.f;
        Gs[r * (D + 1) + d] =
            in ? to_f(go[(long long)(r0 + r) * a.do_sl + d]) : 0.f;
      }
      __syncthreads();

      const int row = r0 + lane;
      const bool in = row < q_end;
      const float lse_l = in ? a.lse[stat + row] : INFINITY;
      const float di_l = in ? a.di[stat + row] : 0.f;
      float s[CW], dp[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) s[c] = dp[c] = 0.f;
      const float* Ql = Qs + lane * (D + 1);
      const float* Gl = Gs + lane * (D + 1);
      for (int d = 0; d < D; ++d) {
        const float qd = Ql[d], gd = Gl[d];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          s[c] = fmaf(Kw[c * D + d], qd, s[c]);
          dp[c] = fmaf(Vw[c * D + d], gd, dp[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const bool ok =
            in && live(row, col0 + c, valid, prefix, a.causal);
        const float p = ok ? expf(s[c] * a.sm_scale - lse_l) : 0.f;
        Pw[c * SQ + lane] = rd<T>(p);
        Sw[c * SQ + lane] = rd<T>(p * (dp[c] - di_l) * a.sm_scale);
      }
      __syncwarp();
      for (int r = 0; r < SQ; ++r) {
        float gj[SDJ], qj[SDJ];
#pragma unroll
        for (int j = 0; j < SDJ; ++j) {
          const int d = lane + 32 * j;
          gj[j] = d < D ? Gs[r * (D + 1) + d] : 0.f;
          qj[j] = d < D ? Qs[r * (D + 1) + d] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float p = Pw[c * SQ + r], ds = Sw[c * SQ + r];
#pragma unroll
          for (int j = 0; j < SDJ; ++j) {
            acc_v[c][j] = fmaf(p, gj[j], acc_v[c][j]);
            acc_k[c][j] = fmaf(ds, qj[j], acc_k[c][j]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int c = 0; c < CW; ++c) {
    const int col = col0 + c;
    if (col >= a.Lkv) break;
#pragma unroll
    for (int j = 0; j < SDJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        dk[(long long)col * a.dk_sl + d] = from_f<T>(acc_k[c][j]);
        dv[(long long)col * a.dv_sl + d] = from_f<T>(acc_v[c][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernels (bf16, head_dim 64 or 128)
// ---------------------------------------------------------------------------

constexpr int MKV = 64;      // key rows per tile (dQ) and per block (dK/dV)

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma(const FlashBwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of Q K^T and dO V^T
  constexpr int NT = MKV / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;    // dQ n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Gs = Qs + BQ * LD;                    // [BQ][LD]   dO
  T* Ks = Gs + BQ * LD;                    // [MKV][LD]
  T* Vs = Ks + MKV * LD;                   // [MKV][LD]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dq = (T*)a.dq + b * a.dq_sb + h * a.dq_sh;
  if (q0 >= valid_q || valid <= 0) {
    zero_rows<T>(dq, a.dq_sl, q0, min(BQ, a.Lq - q0), D);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* go = (const T*)a.dout + b * a.do_sb + h * a.do_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q_end = min(a.Lq, valid_q);

  stage_tile<D, THREADS>(Qs, q, a.q_sl, q0, q_end, BQ);
  stage_tile<D, THREADS>(Gs, go, a.do_sl, q0, q_end, BQ);

  // Row state of rows g (index 0) and g + 8 (index 1).
  const int row_lo = q0 + warp * 16 + g;
  const long long stat = ((long long)b * a.H + h) * a.Lq;
  float lse_r[2], di_r[2];
  bool in_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    in_r[r] = row_lo + r * 8 < q_end;
    lse_r[r] = in_r[r] ? a.lse[stat + row_lo + r * 8] : INFINITY;
    di_r[r] = in_r[r] ? a.di[stat + row_lo + r * 8] : 0.f;
  }
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const T* Qw = Qs + warp * 16 * LD;
  const T* Gw = Gs + warp * 16 * LD;

  int kv_end = valid;
  if (a.causal) kv_end = min(kv_end, max(q0 + BQ, prefix));
  for (int kv0 = 0; kv0 < kv_end; kv0 += MKV) {
    __syncthreads();
    stage_tile<D, THREADS>(Ks, k, a.k_sl, kv0, a.Lkv, MKV);
    stage_tile<D, THREADS>(Vs, v, a.v_sl, kv0, a.Lkv, MKV);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], ga[4];
      load_a_frag(qa, Qw + kk * 16, LD, g, t);
      load_a_frag(ga, Gw + kk * 16, LD, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kb = Ks + (n * 8 + g) * LD + kk * 16 + t * 2;
        const T* vb = Vs + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], qa, *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
        mma_bf16(dp[n], ga, *reinterpret_cast<const uint32_t*>(vb),
                 *reinterpret_cast<const uint32_t*>(vb + 8));
      }
    }
    // s becomes dS
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row_lo + (i / 2) * 8;
        const int col = kv0 + n * 8 + t * 2 + (i % 2);
        const bool ok =
            in_r[i / 2] && live(row, col, valid, prefix, a.causal);
        const float p =
            ok ? expf(s[n][i] * a.sm_scale - lse_r[i / 2]) : 0.f;
        s[n][i] = p * (dp[n][i] - di_r[i / 2]) * a.sm_scale;
      }
    }
    // dQ += dS K: two adjacent score n-tiles are one 16-deep A fragment.
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t bb[4];
        load_b_trans(bb, Ks + kk * 16 * LD + n * 8, LD, lane);
        mma_bf16(acc[n], pa, bb[0], bb[1]);
        mma_bf16(acc[n + 1], pa, bb[2], bb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    if (row >= a.Lq) continue;
    T* orow = dq + (long long)row * a.dq_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// MQ: query rows per tile (a multiple of 16).
template <int D, int MQ>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma(const FlashBwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of K Q^T and V dO^T
  constexpr int NQ = MQ / 8;   // transposed-score n-tiles per warp
  constexpr int OT = D / 8;    // dK / dV n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [MKV][LD]
  T* Vs = Ks + MKV * LD;                   // [MKV][LD]
  T* Qs = Vs + MKV * LD;                   // [MQ][LD]
  T* Gs = Qs + MQ * LD;                    // [MQ][LD]   dO
  float* lse_s = reinterpret_cast<float*>(Gs + MQ * LD);  // [MQ]
  float* di_s = lse_s + MQ;                                // [MQ]

  const int kv0 = blockIdx.x * MKV, hk = blockIdx.y, b = blockIdx.z;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dk = (T*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  T* dv = (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
  if (kv0 >= valid) {
    const int rows = min(MKV, a.Lkv - kv0);
    zero_rows<T>(dk, a.dk_sl, kv0, rows, D);
    zero_rows<T>(dv, a.dv_sl, kv0, rows, D);
    return;
  }
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.H / a.Hkv;

  stage_tile<D, THREADS>(Ks, k, a.k_sl, kv0, a.Lkv, MKV);
  stage_tile<D, THREADS>(Vs, v, a.v_sl, kv0, a.Lkv, MKV);

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  const int col_lo = kv0 + warp * 16 + g;   // key rows g and g + 8

  const int q_end = min(a.Lq, valid_q);
  const int q_begin = q_begin_of(kv0, prefix, a.causal, MQ);
  for (int hq = hk * G; hq < hk * G + G; ++hq) {
    const T* q = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
    const T* go = (const T*)a.dout + b * a.do_sb + hq * a.do_sh;
    const long long stat = ((long long)b * a.H + hq) * a.Lq;
    for (int r0 = q_begin; r0 < q_end; r0 += MQ) {
      __syncthreads();
      stage_tile<D, THREADS>(Qs, q, a.q_sl, r0, q_end, MQ);
      stage_tile<D, THREADS>(Gs, go, a.do_sl, r0, q_end, MQ);
      for (int i = tid; i < MQ; i += THREADS) {
        const bool in = r0 + i < q_end;
        lse_s[i] = in ? a.lse[stat + r0 + i] : INFINITY;
        di_s[i] = in ? a.di[stat + r0 + i] : 0.f;
      }
      __syncthreads();

      // Transposed tiles: rows are this warp's 16 key rows, columns the
      // tile's query rows.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag(ka, Kw + kk * 16, LD, g, t);
        load_a_frag(va, Vw + kk * 16, LD, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const T* qb = Qs + (n * 8 + g) * LD + kk * 16 + t * 2;
          const T* gb = Gs + (n * 8 + g) * LD + kk * 16 + t * 2;
          mma_bf16(st[n], ka, *reinterpret_cast<const uint32_t*>(qb),
                   *reinterpret_cast<const uint32_t*>(qb + 8));
          mma_bf16(dpt[n], va, *reinterpret_cast<const uint32_t*>(gb),
                   *reinterpret_cast<const uint32_t*>(gb + 8));
        }
      }
      // st becomes P^T, dpt becomes dS^T
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = col_lo + (i / 2) * 8;
          const int rl = n * 8 + t * 2 + (i % 2);
          const int row = r0 + rl;
          const bool ok =
              row < q_end && live(row, col, valid, prefix, a.causal);
          const float p =
              ok ? expf(st[n][i] * a.sm_scale - lse_s[rl]) : 0.f;
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - di_s[rl]) * a.sm_scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 query rows per step.
#pragma unroll
      for (int kk = 0; kk < MQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < OT; n += 2) {
          uint32_t bb[4];
          load_b_trans(bb, Gs + kk * 16 * LD + n * 8, LD, lane);
          mma_bf16(acc_v[n], pa, bb[0], bb[1]);
          mma_bf16(acc_v[n + 1], pa, bb[2], bb[3]);
          load_b_trans(bb, Qs + kk * 16 * LD + n * 8, LD, lane);
          mma_bf16(acc_k[n], sa, bb[0], bb[1]);
          mma_bf16(acc_k[n + 1], sa, bb[2], bb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = col_lo + r * 8;
    if (col >= a.Lkv) continue;
    T* krow = dk + (long long)col * a.dk_sl + t * 2;
    T* vrow = dv + (long long)col * a.dv_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8) =
          __floats2bfloat162_rn(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8) =
          __floats2bfloat162_rn(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, const FlashBwdArgs& a, dim3 grid, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

static bool bad_args(const FlashBwdArgs& a) {
  if (a.D < 1 || a.D > 32 * SDJ) return true;
  if (a.Hkv < 1 || a.H % a.Hkv) return true;
  if (a.mma && (!a.bf16 || (a.D != 64 && a.D != 128))) return true;
  return false;
}

}  // namespace stair

extern "C" int stair_flash_attn_bwd_dq(const stair::FlashBwdArgs* args,
                                       void* stream) {
  using namespace stair;
  const FlashBwdArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  if (a.mma) {
    const size_t smem =
        (size_t)(2 * BQ + 2 * MKV) * (a.D + PAD) * sizeof(__nv_bfloat16);
    return (int)(a.D == 64 ? launch(flash_bwd_dq_mma<64>, a, grid, smem, st)
                           : launch(flash_bwd_dq_mma<128>, a, grid, smem, st));
  }
  const size_t smem = sizeof(float) * ((size_t)2 * BQ * a.D +
                                       2 * SKV * (a.D + 1) + 4 * SROWS * SKV);
  return (int)(a.bf16
                   ? launch(flash_bwd_dq_simple<__nv_bfloat16>, a, grid, smem,
                            st)
                   : launch(flash_bwd_dq_simple<float>, a, grid, smem, st));
}

extern "C" int stair_flash_attn_bwd_dkv(const stair::FlashBwdArgs* args,
                                        void* stream) {
  using namespace stair;
  const FlashBwdArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (a.mma) {
    const dim3 grid((a.Lkv + MKV - 1) / MKV, a.Hkv, a.B);
    // 64 query rows per tile at head_dim 64; 32 at 128, where dK and dV
    // alone fill 128 registers a thread.
    const int mq = a.D == 64 ? 64 : 32;
    const size_t smem =
        (size_t)(2 * MKV + 2 * mq) * (a.D + PAD) * sizeof(__nv_bfloat16) +
        2 * mq * sizeof(float);
    return (int)(a.D == 64
                     ? launch(flash_bwd_dkv_mma<64, 64>, a, grid, smem, st)
                     : launch(flash_bwd_dkv_mma<128, 32>, a, grid, smem, st));
  }
  const dim3 grid((a.Lkv + SBKV - 1) / SBKV, a.Hkv, a.B);
  const size_t smem =
      sizeof(float) * ((size_t)2 * SBKV * a.D + 2 * SQ * (a.D + 1) +
                       2 * 4 * CW * SQ);
  return (int)(a.bf16
                   ? launch(flash_bwd_dkv_simple<__nv_bfloat16>, a, grid, smem,
                            st)
                   : launch(flash_bwd_dkv_simple<float>, a, grid, smem, st));
}
