// Masked flash attention, backward (replaces the TPU kernels
// stair_tpu/ops/attention.py _bwd_dq_kernel and _bwd_dkv_kernel, TPU
// kernels #8 and #9, and the row sums di that the JAX package computes
// outside them).
//
// Given q, k, v, the forward's output O and row log-sum-exp ``lse`` and
// the cotangent ``dO``, with the forward's two-integer mask:
//   di = rowsum(O * dO)           (computed and written by the dQ launch)
//   S  = scale * Q K^T            P  = exp(S - lse) on live pairs, else 0
//   dP = dO V^T                   dS = P * (dP - di) * scale
//   dQ = dS K      dV = P^T dO      dK = dS^T Q
// Two launches on one stream and nothing else, no float atomics, so every
// output element is written once by one thread and the bits repeat run to
// run:
//  - the dQ launch: one block per (example, query head, 64 query rows)
//    computes di of its rows from O and dO, writes it to the [B, H, Lq]
//    buffer, and walks the live key tiles (the forward's range) with dQ in
//    registers;
//  - the dK/dV launch (after it, reading di): one block per (example, kv
//    head, key tile) walks the query heads of its group in ascending order
//    and, for each, the live query tiles, with dK and dV in registers.
//    Grouped-query heads are summed here, in float32, in that fixed order;
//    k and v are never expanded.
// Key tiles past ``valid`` and query tiles wholly above the diagonal (and
// past the prefix) are never visited. Query rows at or past ``valid`` are
// padding: their dO is read as 0, so di is 0 there, their P is 0, dQ is 0
// and they add nothing to dK/dV; dK/dV rows at or past ``valid`` are 0. A
// masked pair's P is 0 whatever exp gave, and valid = 0 gives zeros.
//
// Rounding sites (float32 everywhere else): P is rounded to the input type
// before P^T dO and dS before dS K and dS^T Q (no-ops in float32).
//
// What bounds it on an H100: per live (row, column) pair and head the dQ
// launch does three products of depth D (6 D operations) and the dK/dV
// launch four (8 D; Q K^T and dO V^T are computed in both), against q, k,
// v, O, dO read and dQ (or dK, dV) written once: about 2 L^2 D operations
// per head under a causal mask against 14 L D bytes in bf16, below the
// card's ~295 operations per byte at this repo's lengths (L 128 to 640).
// The bound is the bytes, as for the forward; at the SFT step's shape the
// operation bound alone is about half of it. In practice neither bound is
// near: the first port (synchronous tile loads, a barrier pair around
// each, the lightest causal tiles first, the mask tested on every element
// and di as four eager passes outside) ran its products at about 64 and
// 87 TFLOP/s on an H100 SXM at the SFT step's shape (B 8, 32 heads, L 512,
// D 128). The kernels wait on loads and barriers, not on the tensor
// cores, and the design attacks that; it runs them at about 126 and 139
// TFLOP/s there, and the whole backward in 0.35 ms against about 0.8 ms
// for the first port with its eager di:
//
// Three variants per launch behind one C entry point each, on the route
// ops/attention.py route picks (FlashBwdArgs.route, ROUTE_* of
// flash_common.cuh; a launch with an unknown code, or a tensor-core route
// on inputs it does not take, returns an error):
//  - *_mma (bf16, head_dim 64 or 128, 16-byte aligned rows): mma.sync
//    m16n8k16 with float32 accumulation, every operand fragment through
//    ldmatrix. The streamed tiles come through two-stage cp.async rings
//    in shared memory (16-byte chunks, zero-fill past the limit): tile
//    j + 1 is in flight while tile j's products run, one barrier pair per
//    tile. P = exp2(fma(s, scale log2 e, -lse log2 e)) with the row's lse
//    scaled to base 2 once, and the mask test runs only on tiles that the
//    diagonal, ``valid`` or the prefix cut (the same answer for all 32
//    lanes of a warp otherwise). A warp whose tile is wholly masked skips
//    its products.
//    dQ: 4 warps of 16 query rows, two blocks per SM (the forward's
//    shape); Q and dO staged once, K and V tiles of 64 keys in the ring;
//    di formed before the walk from O (registers) and the staged dO. The
//    grid is (H, B, query tiles) with the tile index slowest and, under a
//    causal mask, reversed: the tiles with the most live keys start first
//    and the short ones fill the tail.
//    dK/dV: each warp owns 16 key rows of K and V in shared memory and
//    their dK, dV in registers (128 a thread at D 128); Q, dO, lse and di
//    tiles of DKV_MQ query rows come through the ring. It computes the
//    transposed tiles S^T = K Q^T and dP^T = V dO^T so that P^T and dS^T
//    come out of the accumulators in the layout the next product's A
//    operand wants. The grid is (Hkv, B, key tiles) with the key-tile index
//    slowest and ascending: under a causal mask key tile 0 walks the most
//    query tiles. The tile (warps, query rows per step, blocks per SM) is
//    set per head_dim below, by measurement (scripts/flash_bwd_tiles.py
//    builds and times the candidates): 4 warps (64 key rows), 64 query
//    rows per step, two blocks per SM at both head_dims. At the SFT step's
//    shape it took 0.200-0.202 ms, against 0.206-0.208 with 32 query rows
//    per step and 0.229-0.242 for blocks of 128 key rows (8 warps, one
//    block per SM); 0.0403 ms at the prefix-LM trainer's D 64 against
//    0.0420-0.0474 (H100 SXM, 700 W). At D 128 it takes 255 registers a
//    thread and no spill;
//  - *_mma32 (float32, head_dim 64 or 128, every row of q, k, v, out, dO,
//    dQ, dK, dV 16-byte aligned): the *_mma kernels' structure in float32
//    (the same grids and walks, heaviest causal query tiles first, a
//    two-stage cp.async ring, di from the dQ launch, the mask test only on
//    tiles that cut a warp's rows, P as exp2 of one FMA with the lse in
//    base 2, wholly masked warp tiles skipped, grouped heads summed in
//    ascending order, no atomics). Every product runs on the tensor cores
//    as mma.sync m16n8k8 in split TF32 (flash_common.cuh: each operand a
//    TF32 high part and a remainder, three TF32 products, about float32's
//    accuracy; one TF32 product keeps ~3 digits and misses float32's 2e-4):
//    dQ's S, dP and dS K, dK/dV's S^T, dP^T, P^T dO and dS^T Q. P and dS
//    (P^T and dS^T) reach the next product's A operand from the
//    accumulators in registers: C holds columns 2t, 2t + 1 where A wants
//    depth t, t + 4, so the B operand (K's rows in dS K, dO's in P^T dO,
//    Q's in dS^T Q) is read in that permuted order, as flash_fwd_mma32
//    reads V; a float32 sum may run in any order. Rows of D + 4 floats put
//    every fragment load on 32 distinct banks. Where to split was measured
//    at the LLM trainer CLIs' D 64 shapes (H100 SXM, 700 W; PERF.md): as
//    each fragment is read, 0.165 / 0.204 / 0.114 ms for the whole
//    backward at the prefix-LM reply / video and SFT shapes; the
//    stationary operands (Q and dO, K and V) split once into hi and lo
//    planes in shared memory, 0.193 / 0.236 / 0.117 (twice the shared
//    loads in the products, and 2x the bytes cost the 64-row tiles); each
//    streamed tile split once after it lands, 0.208 / 0.264 / 0.147 (a
//    second barrier a tile as well). So every operand is split as it is
//    read. The kernels are bound by issue (two shared loads and four split
//    operations for three products) and latency, not by the tensor cores,
//    so the tiles are picked for blocks in flight (DQ32_*, DKV32_*;
//    PERF.md has each candidate's times): at D 64, 32 key rows a dQ tile
//    (164 registers, 69,888 bytes) and 32 query rows a dK/dV step (4 warps
//    of 16 key rows; 168 registers under its launch bounds, 70,144 bytes),
//    three blocks an SM each. 64-key tiles (193 registers, two blocks) ran
//    dQ 11-18% slower at the prefix-LM shapes and 4% faster at the SFT
//    shape; the dK/dV step at two blocks an SM (177 registers) 5-6% slower
//    at the prefix-LM shapes and 2% faster at SFT, at 16 query rows 15-19%
//    slower, and 8 warps (one block an SM) 20-25% slower than 4. At
//    D 128 (dK and dV alone take 128 floats a thread): 16-key tiles and
//    16-query steps, 163 and 236 registers, 101,632 bytes each, two blocks
//    an SM; 32-key tiles and 32-query steps at one block an SM ran 18-20%
//    slower;
//  - *_simple (float32 or bf16, any head_dim <= 128, any strides): float32
//    FMA loops and synchronous tile loads; the shapes the others refuse,
//    and the float32 check that chip_smoke.py holds *_mma32 against. Its
//    dQ kernel computes di as the tensor-core ones do.
#include "flash_common.cuh"

namespace stair {

struct FlashBwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // [B, H, Lq]
  float* di;         // [B, H, Lq]: written by the dQ launch, read by dK/dV
  void* dq;
  void* dk;
  void* dv;
  const int* prefix_len;
  const int* valid_len;
  long long q_sb, q_sh, q_sl;  // element strides: batch, head, row
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  int B, H, Hkv, Lq, Lkv, D;
  int causal, bf16, route;  // route: ROUTE_* of flash_common.cuh
  float sm_scale;
};

constexpr int THREADS = 128;
constexpr int BQ = 64;       // query rows per dQ block (16 per warp)
constexpr int SDJ = 4;       // head_dim / 32, at most
constexpr int MKV = 64;      // key rows per tile of the tensor-core dQ kernel

// The tensor-core dK/dV kernel's tile per head_dim: warps per block (16
// key rows each), query rows per ring step, and the blocks per SM it is
// designed for (its __launch_bounds__ minimum; the launch refuses a card
// that holds fewer). Picked by scripts/flash_bwd_tiles.py.
constexpr int DKV_WARPS_D64 = 4;
constexpr int DKV_MQ_D64 = 64;
constexpr int DKV_MINB_D64 = 2;
constexpr int DKV_WARPS_D128 = 4;
constexpr int DKV_MQ_D128 = 64;
constexpr int DKV_MINB_D128 = 2;

template <typename T>
__device__ void zero_rows(T* base, long long stride, int first, int rows,
                          int D, int nt) {
  for (int i = threadIdx.x; i < rows * D; i += nt) {
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

// A dQ block whose rows are all padding: dQ and di are 0 there.
template <typename T>
__device__ void dead_dq_tile(const FlashBwdArgs& a, T* dq, float* di,
                             int q0) {
  const int rows = min(BQ, a.Lq - q0);
  zero_rows<T>(dq, a.dq_sl, q0, rows, a.D, THREADS);
  for (int r = threadIdx.x; r < rows; r += THREADS) di[q0 + r] = 0.f;
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
  const long long stat = ((long long)b * a.H + h) * a.Lq;
  if (q0 >= valid_q || valid <= 0) {
    dead_dq_tile<T>(a, dq, a.di + stat, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* o = (const T*)a.o + b * a.o_sb + h * a.o_sh;
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
  __syncthreads();

  const int row0 = q0 + warp * SROWS;
  float lse_r[SROWS], di_r[SROWS], acc[SROWS][SDJ];
#pragma unroll
  for (int r = 0; r < SROWS; ++r) {
    const int row = row0 + r;
    const bool in = row < q_end;
    // di = rowsum(O * dO), dO taken as 0 on padding rows
    float part = 0.f;
    if (in)
      for (int d = lane; d < D; d += 32)
        part = fmaf(to_f(o[(long long)row * a.o_sl + d]),
                    Gs[(warp * SROWS + r) * D + d], part);
    di_r[r] = warp_sum(part);
    if (lane == 0 && row < a.Lq) a.di[stat + row] = di_r[r];
    lse_r[r] = in ? a.lse[stat + row] : INFINITY;
#pragma unroll
    for (int j = 0; j < SDJ; ++j) acc[r][j] = 0.f;
  }
  float* Pw = Ps + warp * SROWS * SKV;
  const float* Qw = Qs + warp * SROWS * D;
  const float* Gw = Gs + warp * SROWS * D;

  const int kv_end = kv_end_of(q0, BQ, valid, prefix, a.causal);
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
    zero_rows<T>(dk, a.dk_sl, kv0, rows, D, THREADS);
    zero_rows<T>(dv, a.dv_sl, kv0, rows, D, THREADS);
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

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_mma(const FlashBwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of Q K^T and dO V^T
  constexpr int NT = MKV / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;    // dQ n-tiles per warp
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int OCH = BQ * CH / THREADS;  // chunks of O per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* Gs = Qs + BQ * LD;                    // [BQ][LD]   dO
  T* Ks = Gs + BQ * LD;                    // [STAGES][MKV][LD]
  T* Vs = Ks + STAGES * MKV * LD;          // [STAGES][MKV][LD]
  float* di_s = reinterpret_cast<float*>(Vs + STAGES * MKV * LD);  // [BQ]

  // Grid (H, B, query tiles): the tile index varies slowest and, under a
  // causal mask, runs reversed, so the tiles with the most live keys start
  // first.
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dq = (T*)a.dq + b * a.dq_sb + h * a.dq_sh;
  const long long stat = ((long long)b * a.H + h) * a.Lq;
  if (q0 >= valid_q || valid <= 0) {
    dead_dq_tile<T>(a, dq, a.di + stat, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* o = (const T*)a.o + b * a.o_sb + h * a.o_sh;
  const T* go = (const T*)a.dout + b * a.do_sb + h * a.do_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q_end = min(a.Lq, valid_q);
  const float c2 = a.sm_scale * LOG2E;   // raw score -> base-2 exponent

  const int kv_end = kv_end_of(q0, BQ, valid, prefix, a.causal);
  const int ntiles = (kv_end + MKV - 1) / MKV;
  // Group 0: Q, dO and the first K/V tile.
  stage_tile_async<D, THREADS>(Qs, q, a.q_sl, q0, q_end, BQ);
  stage_tile_async<D, THREADS>(Gs, go, a.do_sl, q0, q_end, BQ);
  stage_tile_async<D, THREADS>(Ks, k, a.k_sl, 0, a.Lkv, MKV);
  stage_tile_async<D, THREADS>(Vs, v, a.v_sl, 0, a.Lkv, MKV);
  cp_async_commit();
  // This thread's chunks of O for di, loaded while the group is in flight
  // (chunk i = tid + j THREADS: row i / CH, the CH lanes of a row are
  // neighbours in one warp). Padding rows read nothing.
  uint4 oc[OCH];
#pragma unroll
  for (int j = 0; j < OCH; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = i % CH;
    oc[j] = q0 + r < q_end
                ? *reinterpret_cast<const uint4*>(
                      o + (long long)(q0 + r) * a.o_sl + c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
  }

  // Row state of rows g (index 0) and g + 8 (index 1); lse in base 2.
  const int row_min = q0 + warp * 16;
  const int row_lo = row_min + g;
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    lse2[r] = row < q_end ? a.lse[stat + row] * LOG2E : INFINITY;
  }

  // di = rowsum(f32(O) f32(dO)) once dO has landed: this thread's chunks,
  // then a sum over the CH lanes of the row; dO is 0 on padding rows, so
  // di is too. Done before the walk, so that the O chunks' registers are
  // free for it.
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OCH; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = i % CH;
    const uint4 gv = *reinterpret_cast<const uint4*>(Gs + r * LD + c * 8);
    const __nv_bfloat162* op =
        reinterpret_cast<const __nv_bfloat162*>(&oc[j]);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(op[e]);
      const float2 gf = __bfloat1622float2(gp[e]);
      part = fmaf(of.x, gf.x, part);
      part = fmaf(of.y, gf.y, part);
    }
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c == 0) di_s[r] = part;
  }
  __syncthreads();
  const float di_r[2] = {di_s[warp * 16 + g], di_s[warp * 16 + g + 8]};
  if (tid < BQ && q0 + tid < a.Lq) a.di[stat + q0 + tid] = di_s[tid];
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const T* Qw = Qs + warp * 16 * LD;
  const T* Gw = Gs + warp * 16 * LD;
  // A warp whose 16 rows are all padding has dQ = 0: it skips the products.
  const bool warp_live = row_min < q_end;

  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * MKV;
    // Tile j + 1 goes into the other stage while tile j is used; the group
    // is committed even when empty, so "all but the newest" is tile j.
    if (j + 1 < ntiles) {
      const int st = (j + 1) % STAGES;
      stage_tile_async<D, THREADS>(Ks + st * MKV * LD, k, a.k_sl, kv0 + MKV,
                                   a.Lkv, MKV);
      stage_tile_async<D, THREADS>(Vs + st * MKV * LD, v, a.v_sl, kv0 + MKV,
                                   a.Lkv, MKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* Kt = Ks + (j % STAGES) * MKV * LD;
    const T* Vt = Vs + (j % STAGES) * MKV * LD;

    if (warp_live) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], ga[4];
        load_a_frag(qa, Qw + kk * 16, LD, lane);
        load_a_frag(ga, Gw + kk * 16, LD, lane);
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t kb[4], vb[4];
          load_b_frags(kb, Kt + n * 8 * LD + kk * 16, LD, lane);
          load_b_frags(vb, Vt + n * 8 * LD + kk * 16, LD, lane);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(s[n + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[n], ga, vb[0], vb[1]);
          mma_bf16(dp[n + 1], ga, vb[2], vb[3]);
        }
      }
      // s becomes dS. The mask test runs only where the tile cuts this
      // warp's rows: past valid or the padding rows, or above the diagonal
      // and past the prefix.
      const bool inside =
          kv0 + MKV <= valid && row_min + 16 <= q_end &&
          (!a.causal || kv0 + MKV - 1 <= row_min || kv0 + MKV <= prefix);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(fmaf(s[n][i], c2, -lse2[i / 2]));
          if (!inside) {
            const int row = row_lo + (i / 2) * 8;
            const int col = kv0 + n * 8 + t * 2 + (i % 2);
            if (!(row < q_end && live(row, col, valid, prefix, a.causal)))
              p = 0.f;
          }
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
          load_b_trans(bb, Kt + kk * 16 * LD + n * 8, LD, lane);
          mma_bf16(acc[n], pa, bb[0], bb[1]);
          mma_bf16(acc[n + 1], pa, bb[2], bb[3]);
        }
      }
    }
    // Every warp is done with this stage before tile j + 2 refills it.
    __syncthreads();
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

// WARPS warps of 16 key rows each; MQ query rows per ring step (a multiple
// of 16); MINB blocks per SM.
template <int D, int WARPS, int MQ, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
flash_bwd_dkv_mma(const FlashBwdArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int NTH = WARPS * 32;
  constexpr int BKV = WARPS * 16;  // key rows per block
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of K Q^T and V dO^T
  constexpr int NQ = MQ / 8;   // transposed-score n-tiles per warp
  constexpr int OT = D / 8;    // dK / dV n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BKV][LD]
  T* Vs = Ks + BKV * LD;                   // [BKV][LD]
  T* Qs = Vs + BKV * LD;                   // [STAGES][MQ][LD]
  T* Gs = Qs + STAGES * MQ * LD;           // [STAGES][MQ][LD]   dO
  // [STAGES][MQ] each
  float* lse_s = reinterpret_cast<float*>(Gs + STAGES * MQ * LD);
  float* di_s = lse_s + STAGES * MQ;

  // Grid (Hkv, B, key tiles): the key-tile index varies slowest, ascending;
  // under a causal mask key tile 0 walks the most query tiles.
  const int kv0 = blockIdx.z * BKV, hk = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  T* dk = (T*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  T* dv = (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
  if (kv0 >= valid) {
    const int rows = min(BKV, a.Lkv - kv0);
    zero_rows<T>(dk, a.dk_sl, kv0, rows, D, NTH);
    zero_rows<T>(dv, a.dv_sl, kv0, rows, D, NTH);
    return;
  }
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.H / a.Hkv;
  const float c2 = a.sm_scale * LOG2E;

  // Steps: the G query heads of the group in ascending order, and in each
  // the query tiles from q_begin to q_end (the same count for every head).
  const int q_end = min(a.Lq, valid_q);
  const int q_begin = q_begin_of(kv0, prefix, a.causal, MQ);
  const int nq = q_end > q_begin ? (q_end - q_begin + MQ - 1) / MQ : 0;
  const int nsteps = G * nq;
  auto stage_step = [&](int i, int st) {
    const int hq = hk * G + i / nq, r0 = q_begin + (i % nq) * MQ;
    const T* q = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
    const T* go = (const T*)a.dout + b * a.do_sb + hq * a.do_sh;
    stage_tile_async<D, NTH>(Qs + st * MQ * LD, q, a.q_sl, r0, q_end, MQ);
    stage_tile_async<D, NTH>(Gs + st * MQ * LD, go, a.do_sl, r0, q_end, MQ);
    const long long stat = ((long long)b * a.H + hq) * a.Lq;
    for (int r = tid; r < MQ; r += NTH) {
      const bool in = r0 + r < q_end;
      const long long at = stat + (in ? r0 + r : 0);
      cp_async4(lse_s + st * MQ + r, a.lse + at, in);
      cp_async4(di_s + st * MQ + r, a.di + at, in);
    }
  };
  // Group 0: this block's K and V rows and the first step's tiles.
  stage_tile_async<D, NTH>(Ks, k, a.k_sl, kv0, a.Lkv, BKV);
  stage_tile_async<D, NTH>(Vs, v, a.v_sl, kv0, a.Lkv, BKV);
  if (nsteps > 0) stage_step(0, 0);
  cp_async_commit();

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;
  const int kw0 = kv0 + warp * 16;       // this warp's first key row
  const int col_lo = kw0 + g;            // key rows g and g + 8
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) stage_step(i + 1, (i + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int r0 = q_begin + (i % nq) * MQ;
    const int stage = i % STAGES;
    const T* Qt = Qs + stage * MQ * LD;
    const T* Gt = Gs + stage * MQ * LD;
    const float* lse_t = lse_s + stage * MQ;
    const float* di_t = di_s + stage * MQ;
    // This warp's keys are all past valid, or all above the tile's last
    // query row and past the prefix: P = 0, nothing to add.
    const bool dead = kw0 >= valid || (a.causal && kw0 >= prefix &&
                                       kw0 > r0 + MQ - 1);
    if (!dead) {
      // Transposed tiles: rows are this warp's 16 key rows, columns the
      // step's query rows.
      float pt[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        load_a_frag(ka, Kw + kk * 16, LD, lane);
        load_a_frag(va, Vw + kk * 16, LD, lane);
#pragma unroll
        for (int n = 0; n < NQ; n += 2) {
          uint32_t qb[4], gb[4];
          load_b_frags(qb, Qt + n * 8 * LD + kk * 16, LD, lane);
          load_b_frags(gb, Gt + n * 8 * LD + kk * 16, LD, lane);
          mma_bf16(pt[n], ka, qb[0], qb[1]);
          mma_bf16(pt[n + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[n], va, gb[0], gb[1]);
          mma_bf16(dpt[n + 1], va, gb[2], gb[3]);
        }
      }
      // pt becomes P^T, dpt becomes dS^T; the mask test only where the
      // step cuts this warp's keys.
      const bool inside =
          kw0 + 16 <= valid && r0 + MQ <= q_end &&
          (!a.causal || kw0 + 15 <= r0 || kw0 + 16 <= prefix);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int rl = n * 8 + t * 2;
        const float l2[2] = {lse_t[rl] * LOG2E, lse_t[rl + 1] * LOG2E};
        const float dd[2] = {di_t[rl], di_t[rl + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(pt[n][e], c2, -l2[e % 2]));
          if (!inside) {
            const int col = col_lo + (e / 2) * 8;
            const int row = r0 + rl + (e % 2);
            if (!(row < q_end && live(row, col, valid, prefix, a.causal)))
              p = 0.f;
          }
          pt[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dd[e % 2]) * a.sm_scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 query rows per k-step.
#pragma unroll
      for (int kk = 0; kk < MQ / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pa[0] = pack_bf16(pt[2 * kk][0], pt[2 * kk][1]);
        pa[1] = pack_bf16(pt[2 * kk][2], pt[2 * kk][3]);
        pa[2] = pack_bf16(pt[2 * kk + 1][0], pt[2 * kk + 1][1]);
        pa[3] = pack_bf16(pt[2 * kk + 1][2], pt[2 * kk + 1][3]);
        sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < OT; n += 2) {
          uint32_t bb[4];
          load_b_trans(bb, Gt + kk * 16 * LD + n * 8, LD, lane);
          mma_bf16(acc_v[n], pa, bb[0], bb[1]);
          mma_bf16(acc_v[n + 1], pa, bb[2], bb[3]);
          load_b_trans(bb, Qt + kk * 16 * LD + n * 8, LD, lane);
          mma_bf16(acc_k[n], sa, bb[0], bb[1]);
          mma_bf16(acc_k[n + 1], sa, bb[2], bb[3]);
        }
      }
    }
    // Every warp is done with this stage before step i + 2 refills it.
    __syncthreads();
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

// ---------------------------------------------------------------------------
// float32 tensor-core kernels (float32, head_dim 64 or 128)
// ---------------------------------------------------------------------------

// The float32 kernels' tiles per head_dim, picked by measurement
// (scripts/flash_bwd_tiles.py --dtype float32 builds and times the
// candidates): the dQ kernel's key rows per tile and the blocks per SM it
// is designed for; the dK/dV kernel's warps (16 key rows each), query rows
// per ring step and blocks per SM.
constexpr int DQ32_KV_D64 = 32;
constexpr int DQ32_MINB_D64 = 3;
constexpr int DQ32_KV_D128 = 16;
constexpr int DQ32_MINB_D128 = 2;
constexpr int DKV32_WARPS_D64 = 4;
constexpr int DKV32_MQ_D64 = 32;
constexpr int DKV32_MINB_D64 = 3;
constexpr int DKV32_WARPS_D128 = 4;
constexpr int DKV32_MQ_D128 = 16;
constexpr int DKV32_MINB_D128 = 2;

// What a head_dim fixes for the dQ kernel: the key tile and the shared
// memory: Q, dO, the K and V rings, di (ops/attention.py
// mma32_bwd_smem_bytes computes the same sum).
template <int D>
struct Dq32 {
  static constexpr int KV = D == 64 ? DQ32_KV_D64 : DQ32_KV_D128;
  static constexpr int MINB = D == 64 ? DQ32_MINB_D64 : DQ32_MINB_D128;
  static constexpr int LD = D + PAD32;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)2 * BQ * LD + (size_t)2 * STAGES * KV * LD +
                       BQ);
};

// The same for the dK/dV kernel: K and V of the block's key rows, the Q
// and dO rings, the lse and di rings.
template <int D>
struct Dkv32 {
  static constexpr int WARPS = D == 64 ? DKV32_WARPS_D64 : DKV32_WARPS_D128;
  static constexpr int MQ = D == 64 ? DKV32_MQ_D64 : DKV32_MQ_D128;
  static constexpr int MINB = D == 64 ? DKV32_MINB_D64 : DKV32_MINB_D128;
  static constexpr int NTH = WARPS * 32;
  static constexpr int BKV = WARPS * 16;
  static constexpr int LD = D + PAD32;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)2 * BKV * LD + (size_t)2 * STAGES * MQ * LD +
                       2 * STAGES * MQ);
};
// each kernel's blocks per SM fit an SM's shared memory (1 KB reserved a
// block)
static_assert(Dq32<64>::MINB * (Dq32<64>::SMEM + 1024) <= 233472 &&
                  Dq32<128>::MINB * (Dq32<128>::SMEM + 1024) <= 233472 &&
                  Dkv32<64>::MINB * (Dkv32<64>::SMEM + 1024) <= 233472 &&
                  Dkv32<128>::MINB * (Dkv32<128>::SMEM + 1024) <= 233472,
              "the float32 backward kernels' blocks fit an SM");

template <int D>
__global__ void __launch_bounds__(THREADS, Dq32<D>::MINB)
flash_bwd_dq_mma32(const FlashBwdArgs a) {
  typedef Dq32<D> C;
  constexpr int KV = C::KV, LD = C::LD;
  constexpr int NT = KV / 8;   // score n-tiles per warp, dS K k-steps
  constexpr int OT = D / 8;    // dQ n-tiles per warp
  constexpr int CH = D / 4;    // 16-byte chunks per row
  constexpr int OCH = BQ * CH / THREADS;  // chunks of O per thread
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;                    // [BQ][LD]
  float* Gs = Qs + BQ * LD;                // [BQ][LD]   dO
  float* Ks = Gs + BQ * LD;                // [STAGES][KV][LD]
  float* Vs = Ks + STAGES * KV * LD;       // [STAGES][KV][LD]
  float* di_s = Vs + STAGES * KV * LD;     // [BQ]

  // Grid (H, B, query tiles), the heaviest causal tiles first (as
  // flash_bwd_dq_mma).
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ, h = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  float* dq = (float*)a.dq + b * a.dq_sb + h * a.dq_sh;
  const long long stat = ((long long)b * a.H + h) * a.Lq;
  if (q0 >= valid_q || valid <= 0) {
    dead_dq_tile<float>(a, dq, a.di + stat, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const float* q = (const float*)a.q + b * a.q_sb + h * a.q_sh;
  const float* o = (const float*)a.o + b * a.o_sb + h * a.o_sh;
  const float* go = (const float*)a.dout + b * a.do_sb + h * a.do_sh;
  const float* k = (const float*)a.k + b * a.k_sb + hk * a.k_sh;
  const float* v = (const float*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int q_end = min(a.Lq, valid_q);
  const float c2 = a.sm_scale * LOG2E;   // raw score -> base-2 exponent

  const int kv_end = kv_end_of(q0, BQ, valid, prefix, a.causal);
  const int ntiles = (kv_end + KV - 1) / KV;
  // Group 0: Q, dO and the first K/V tile.
  stage_tile_f32_async<D, LD, THREADS>(Qs, q, a.q_sl, q0, q_end, BQ);
  stage_tile_f32_async<D, LD, THREADS>(Gs, go, a.do_sl, q0, q_end, BQ);
  stage_tile_f32_async<D, LD, THREADS>(Ks, k, a.k_sl, 0, a.Lkv, KV);
  stage_tile_f32_async<D, LD, THREADS>(Vs, v, a.v_sl, 0, a.Lkv, KV);
  cp_async_commit();
  // This thread's chunks of O for di, loaded while the group is in flight
  // (chunk i = tid + j THREADS: row i / CH, the CH lanes of a row are
  // neighbours in one warp). Padding rows read nothing.
  float4 oc[OCH];
#pragma unroll
  for (int j = 0; j < OCH; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = i % CH;
    oc[j] = q0 + r < q_end
                ? *reinterpret_cast<const float4*>(
                      o + (long long)(q0 + r) * a.o_sl + c * 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Row state of rows g (index 0) and g + 8 (index 1); lse in base 2.
  const int row_min = q0 + warp * 16;
  const int row_lo = row_min + g;
  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    lse2[r] = row < q_end ? a.lse[stat + row] * LOG2E : INFINITY;
  }

  // di = rowsum(O dO) once dO has landed, as flash_bwd_dq_mma forms it.
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < OCH; ++j) {
    const int i = tid + j * THREADS, r = i / CH, c = i % CH;
    const float4 gv = *reinterpret_cast<const float4*>(Gs + r * LD + c * 4);
    float part = fmaf(oc[j].x, gv.x, 0.f);
    part = fmaf(oc[j].y, gv.y, part);
    part = fmaf(oc[j].z, gv.z, part);
    part = fmaf(oc[j].w, gv.w, part);
#pragma unroll
    for (int off = CH / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (c == 0) di_s[r] = part;
  }
  __syncthreads();
  const float di_r[2] = {di_s[warp * 16 + g], di_s[warp * 16 + g + 8]};
  if (tid < BQ && q0 + tid < a.Lq) a.di[stat + q0 + tid] = di_s[tid];
  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  const float* Qw = Qs + warp * 16 * LD;
  const float* Gw = Gs + warp * 16 * LD;
  // A warp whose 16 rows are all padding has dQ = 0: it skips the products.
  const bool warp_live = row_min < q_end;

  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * KV;
    // Tile j + 1 goes into the other stage while tile j is used; the group
    // is committed even when empty, so "all but the newest" is tile j.
    if (j + 1 < ntiles) {
      const int st = (j + 1) % STAGES;
      stage_tile_f32_async<D, LD, THREADS>(Ks + st * KV * LD, k, a.k_sl,
                                           kv0 + KV, a.Lkv, KV);
      stage_tile_f32_async<D, LD, THREADS>(Vs + st * KV * LD, v, a.v_sl,
                                           kv0 + KV, a.Lkv, KV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = Ks + (j % STAGES) * KV * LD;
    const float* Vt = Vs + (j % STAGES) * KV * LD;

    if (warp_live) {
      // S = Q K^T and dP = dO V^T, 16 rows x KV keys a warp.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        load_a_split(qh, ql, Qw + kk * 8, LD, g, t);
        load_a_split(gh, gl, Gw + kk * 8, LD, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bh[2], bl[2];
          load_bt_split(bh, bl, Kt + n * 8 * LD + kk * 8, LD, g, t);
          mma_tf32x3(s[n], qh, ql, bh, bl);
          load_bt_split(bh, bl, Vt + n * 8 * LD + kk * 8, LD, g, t);
          mma_tf32x3(dp[n], gh, gl, bh, bl);
        }
      }
      // s becomes dS; the mask test only where the tile cuts this warp's
      // rows (as flash_bwd_dq_mma).
      const bool inside =
          kv0 + KV <= valid && row_min + 16 <= q_end &&
          (!a.causal || kv0 + KV - 1 <= row_min || kv0 + KV <= prefix);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = exp2f(fmaf(s[n][i], c2, -lse2[i / 2]));
          if (!inside) {
            const int row = row_lo + (i / 2) * 8;
            const int col = kv0 + n * 8 + t * 2 + (i % 2);
            if (!(row < q_end && live(row, col, valid, prefix, a.causal)))
              p = 0.f;
          }
          s[n][i] = p * (dp[n][i] - di_r[i / 2]) * a.sm_scale;
        }
      }
      // dQ += dS K: dS from the accumulators, K's rows in the permuted
      // key order.
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        uint32_t ah[4], al[4];
        acc_as_a_split(ah, al, s[kk]);
        const float* kb = Kt + kk * 8 * LD;
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          uint32_t bh[2], bl[2];
          load_b_perm_split(bh, bl, kb + n * 8, LD, g, t);
          mma_tf32x3(acc[n], ah, al, bh, bl);
        }
      }
    }
    // Every warp is done with this stage before tile j + 2 refills it.
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    if (row >= a.Lq) continue;
    float* orow = dq + (long long)row * a.dq_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(Dkv32<D>::NTH, Dkv32<D>::MINB)
flash_bwd_dkv_mma32(const FlashBwdArgs a) {
  typedef Dkv32<D> C;
  constexpr int NTH = C::NTH, BKV = C::BKV, MQ = C::MQ, LD = C::LD;
  constexpr int NQ = MQ / 8;   // transposed-score n-tiles, P^T dO k-steps
  constexpr int OT = D / 8;    // dK / dV n-tiles per warp
  extern __shared__ __align__(16) float smem_f32[];
  float* Ks = smem_f32;                    // [BKV][LD]
  float* Vs = Ks + BKV * LD;               // [BKV][LD]
  float* Qs = Vs + BKV * LD;               // [STAGES][MQ][LD]
  float* Gs = Qs + STAGES * MQ * LD;       // [STAGES][MQ][LD]   dO
  float* lse_s = Gs + STAGES * MQ * LD;    // [STAGES][MQ]
  float* di_s = lse_s + STAGES * MQ;       // [STAGES][MQ]

  // Grid (Hkv, B, key tiles), the key-tile index slowest and ascending (as
  // flash_bwd_dkv_mma).
  const int kv0 = blockIdx.z * BKV, hk = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];
  const int valid = min(valid_q, a.Lkv);
  const int prefix = a.prefix_len[b];
  float* dk = (float*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  float* dv = (float*)a.dv + b * a.dv_sb + hk * a.dv_sh;
  if (kv0 >= valid) {
    const int rows = min(BKV, a.Lkv - kv0);
    zero_rows<float>(dk, a.dk_sl, kv0, rows, D, NTH);
    zero_rows<float>(dv, a.dv_sl, kv0, rows, D, NTH);
    return;
  }
  const float* k = (const float*)a.k + b * a.k_sb + hk * a.k_sh;
  const float* v = (const float*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int G = a.H / a.Hkv;
  const float c2 = a.sm_scale * LOG2E;

  // Steps: the G query heads of the group in ascending order, and in each
  // the query tiles from q_begin to q_end (the same count for every head).
  const int q_end = min(a.Lq, valid_q);
  const int q_begin = q_begin_of(kv0, prefix, a.causal, MQ);
  const int nq = q_end > q_begin ? (q_end - q_begin + MQ - 1) / MQ : 0;
  const int nsteps = G * nq;
  auto stage_step = [&](int i, int st) {
    const int hq = hk * G + i / nq, r0 = q_begin + (i % nq) * MQ;
    const float* q = (const float*)a.q + b * a.q_sb + hq * a.q_sh;
    const float* go = (const float*)a.dout + b * a.do_sb + hq * a.do_sh;
    stage_tile_f32_async<D, LD, NTH>(Qs + st * MQ * LD, q, a.q_sl, r0,
                                     q_end, MQ);
    stage_tile_f32_async<D, LD, NTH>(Gs + st * MQ * LD, go, a.do_sl, r0,
                                     q_end, MQ);
    const long long stat = ((long long)b * a.H + hq) * a.Lq;
    for (int r = tid; r < MQ; r += NTH) {
      const bool in = r0 + r < q_end;
      const long long at = stat + (in ? r0 + r : 0);
      cp_async4(lse_s + st * MQ + r, a.lse + at, in);
      cp_async4(di_s + st * MQ + r, a.di + at, in);
    }
  };
  // Group 0: this block's K and V rows and the first step's tiles.
  stage_tile_f32_async<D, LD, NTH>(Ks, k, a.k_sl, kv0, a.Lkv, BKV);
  stage_tile_f32_async<D, LD, NTH>(Vs, v, a.v_sl, kv0, a.Lkv, BKV);
  if (nsteps > 0) stage_step(0, 0);
  cp_async_commit();

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[n][i] = acc_v[n][i] = 0.f;
  const int kw0 = kv0 + warp * 16;       // this warp's first key row
  const int col_lo = kw0 + g;            // key rows g and g + 8
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;

  for (int i = 0; i < nsteps; ++i) {
    if (i + 1 < nsteps) stage_step(i + 1, (i + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int r0 = q_begin + (i % nq) * MQ;
    const int stage = i % STAGES;
    const float* Qt = Qs + stage * MQ * LD;
    const float* Gt = Gs + stage * MQ * LD;
    const float* lse_t = lse_s + stage * MQ;
    const float* di_t = di_s + stage * MQ;
    // This warp's keys are all past valid, or all above the step's last
    // query row and past the prefix: P = 0, nothing to add.
    const bool dead = kw0 >= valid || (a.causal && kw0 >= prefix &&
                                       kw0 > r0 + MQ - 1);
    if (!dead) {
      // Transposed tiles S^T = K Q^T and dP^T = V dO^T: rows are this
      // warp's 16 key rows, columns the step's query rows.
      float pt[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a_split(kh, kl, Kw + kk * 8, LD, g, t);
        load_a_split(vh, vl, Vw + kk * 8, LD, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          uint32_t bh[2], bl[2];
          load_bt_split(bh, bl, Qt + n * 8 * LD + kk * 8, LD, g, t);
          mma_tf32x3(pt[n], kh, kl, bh, bl);
          load_bt_split(bh, bl, Gt + n * 8 * LD + kk * 8, LD, g, t);
          mma_tf32x3(dpt[n], vh, vl, bh, bl);
        }
      }
      // pt becomes P^T, dpt becomes dS^T; the mask test only where the
      // step cuts this warp's keys.
      const bool inside =
          kw0 + 16 <= valid && r0 + MQ <= q_end &&
          (!a.causal || kw0 + 15 <= r0 || kw0 + 16 <= prefix);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int rl = n * 8 + t * 2;
        const float l2[2] = {lse_t[rl] * LOG2E, lse_t[rl + 1] * LOG2E};
        const float dd[2] = {di_t[rl], di_t[rl + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(pt[n][e], c2, -l2[e % 2]));
          if (!inside) {
            const int col = col_lo + (e / 2) * 8;
            const int row = r0 + rl + (e % 2);
            if (!(row < q_end && live(row, col, valid, prefix, a.causal)))
              p = 0.f;
          }
          pt[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - dd[e % 2]) * a.sm_scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T from the accumulators,
      // dO's and Q's rows in the permuted query order.
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        acc_as_a_split(ph, pl, pt[kk]);
        acc_as_a_split(sh, sl, dpt[kk]);
        const float* gb = Gt + kk * 8 * LD;
        const float* qb = Qt + kk * 8 * LD;
#pragma unroll
        for (int n = 0; n < OT; ++n) {
          uint32_t bh[2], bl[2];
          load_b_perm_split(bh, bl, gb + n * 8, LD, g, t);
          mma_tf32x3(acc_v[n], ph, pl, bh, bl);
          load_b_perm_split(bh, bl, qb + n * 8, LD, g, t);
          mma_tf32x3(acc_k[n], sh, sl, bh, bl);
        }
      }
    }
    // Every warp is done with this stage before step i + 2 refills it.
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = col_lo + r * 8;
    if (col >= a.Lkv) continue;
    float* krow = dk + (long long)col * a.dk_sl + t * 2;
    float* vrow = dv + (long long)col * a.dv_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      *reinterpret_cast<float2*>(krow + n * 8) =
          make_float2(acc_k[n][2 * r], acc_k[n][2 * r + 1]);
      *reinterpret_cast<float2*>(vrow + n * 8) =
          make_float2(acc_v[n][2 * r], acc_v[n][2 * r + 1]);
    }
  }
}

// Shared memory of the tensor-core kernels per block (bytes).
constexpr size_t dq_mma_smem(int D) {
  return (size_t)(2 * BQ + 2 * STAGES * MKV) * (D + PAD) * 2 + BQ * 4;
}
constexpr size_t dkv_mma_smem(int D, int warps, int mq) {
  return (size_t)(2 * 16 * warps + 2 * STAGES * mq) * (D + PAD) * 2 +
         2 * STAGES * mq * 4;
}

// Launch ``kernel`` with ``smem`` bytes of dynamic shared memory; a
// kernel designed for ``min_blocks`` blocks per SM refuses a card that
// holds fewer (cudaErrorLaunchOutOfResources) instead of running slower.
template <typename K>
cudaError_t launch(K kernel, const FlashBwdArgs& a, dim3 grid, int threads,
                   size_t smem, int min_blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (min_blocks > 1) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (blocks < min_blocks) return cudaErrorLaunchOutOfResources;
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int WARPS, int MQ, int MINB>
cudaError_t launch_dkv_mma(const FlashBwdArgs& a, cudaStream_t stream) {
  const dim3 grid(a.Hkv, a.B, (a.Lkv + 16 * WARPS - 1) / (16 * WARPS));
  return launch(flash_bwd_dkv_mma<D, WARPS, MQ, MINB>, a, grid, WARPS * 32,
                dkv_mma_smem(D, WARPS, MQ), MINB, stream);
}

template <int D>
cudaError_t launch_dq_mma32(const FlashBwdArgs& a, cudaStream_t stream) {
  const dim3 grid(a.H, a.B, (a.Lq + BQ - 1) / BQ);
  return launch(flash_bwd_dq_mma32<D>, a, grid, THREADS, Dq32<D>::SMEM,
                Dq32<D>::MINB, stream);
}

template <int D>
cudaError_t launch_dkv_mma32(const FlashBwdArgs& a, cudaStream_t stream) {
  typedef Dkv32<D> C;
  const dim3 grid(a.Hkv, a.B, (a.Lkv + C::BKV - 1) / C::BKV);
  return launch(flash_bwd_dkv_mma32<D>, a, grid, C::NTH, C::SMEM, C::MINB,
                stream);
}

// Every row of q, k, v, out, dO, dQ, dK and dV starts on 16 bytes.
static bool rows_aligned16(const FlashBwdArgs& a) {
  const void* ptrs[8] = {a.q, a.k, a.v, a.o, a.dout, a.dq, a.dk, a.dv};
  const long long strides[24] = {
      a.q_sb,  a.q_sh,  a.q_sl,  a.k_sb,  a.k_sh,  a.k_sl,
      a.v_sb,  a.v_sh,  a.v_sl,  a.o_sb,  a.o_sh,  a.o_sl,
      a.do_sb, a.do_sh, a.do_sl, a.dq_sb, a.dq_sh, a.dq_sl,
      a.dk_sb, a.dk_sh, a.dk_sl, a.dv_sb, a.dv_sh, a.dv_sl};
  return rows_aligned16(ptrs, strides, 8);
}

// A launch the route does not take: an unknown code, a tensor-core route on
// another dtype or head_dim, "mma32" on rows not 16-byte aligned.
static bool bad_args(const FlashBwdArgs& a) {
  if (a.D < 1 || a.D > 32 * SDJ) return true;
  if (a.Hkv < 1 || a.H % a.Hkv) return true;
  switch (a.route) {
    case ROUTE_SIMPLE:
      return false;
    case ROUTE_MMA:
      return !a.bf16 || (a.D != 64 && a.D != 128);
    case ROUTE_MMA32:
      return a.bf16 || (a.D != 64 && a.D != 128) || !rows_aligned16(a);
    default:
      return true;
  }
}

}  // namespace stair

extern "C" int stair_flash_attn_bwd_dq(const stair::FlashBwdArgs* args,
                                       void* stream) {
  using namespace stair;
  const FlashBwdArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (a.route == ROUTE_MMA32)
    return (int)(a.D == 64 ? launch_dq_mma32<64>(a, st)
                           : launch_dq_mma32<128>(a, st));
  if (a.route == ROUTE_MMA) {
    const dim3 grid(a.H, a.B, (a.Lq + BQ - 1) / BQ);
    return (int)(a.D == 64 ? launch(flash_bwd_dq_mma<64>, a, grid, THREADS,
                                    dq_mma_smem(64), 2, st)
                           : launch(flash_bwd_dq_mma<128>, a, grid, THREADS,
                                    dq_mma_smem(128), 2, st));
  }
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  const size_t smem = sizeof(float) * ((size_t)2 * BQ * a.D +
                                       2 * SKV * (a.D + 1) + 4 * SROWS * SKV);
  return (int)(a.bf16 ? launch(flash_bwd_dq_simple<__nv_bfloat16>, a, grid,
                               THREADS, smem, 1, st)
                      : launch(flash_bwd_dq_simple<float>, a, grid, THREADS,
                               smem, 1, st));
}

extern "C" int stair_flash_attn_bwd_dkv(const stair::FlashBwdArgs* args,
                                        void* stream) {
  using namespace stair;
  const FlashBwdArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (a.route == ROUTE_MMA32)
    return (int)(a.D == 64 ? launch_dkv_mma32<64>(a, st)
                           : launch_dkv_mma32<128>(a, st));
  if (a.route == ROUTE_MMA)
    return (int)(a.D == 64
                     ? launch_dkv_mma<64, DKV_WARPS_D64, DKV_MQ_D64,
                                      DKV_MINB_D64>(a, st)
                     : launch_dkv_mma<128, DKV_WARPS_D128, DKV_MQ_D128,
                                      DKV_MINB_D128>(a, st));
  const dim3 grid((a.Lkv + SBKV - 1) / SBKV, a.Hkv, a.B);
  const size_t smem =
      sizeof(float) * ((size_t)2 * SBKV * a.D + 2 * SQ * (a.D + 1) +
                       2 * 4 * CW * SQ);
  return (int)(a.bf16 ? launch(flash_bwd_dkv_simple<__nv_bfloat16>, a, grid,
                               THREADS, smem, 1, st)
                      : launch(flash_bwd_dkv_simple<float>, a, grid, THREADS,
                               smem, 1, st));
}
