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
// device memory. Both kernels keep them on chip: one block per (example,
// head, query tile) walks the live key tiles once, with scores, the running
// max and sum and the output accumulator in registers. Tiles wholly above
// the diagonal and past the prefix, or past valid, are never visited; a
// block whose rows are all padding writes zeros and leaves.
//
// Three kernels share that shape:
//  - flash_fwd_mma (bf16, head_dim 64 or 128, 16-byte aligned rows). In
//    practice it is bound by how well the key-tile loads and the barriers
//    overlap the products, not by the card's peaks, so the design aims at
//    that. K and V tiles of 64 keys go through a two-stage ring in shared
//    memory filled by cp.async (16-byte chunks, zero-fill past Lkv): tile
//    j + 1 is in flight while tile j's products run, one barrier pair per
//    tile. 64 query rows per block, 4 warps of 16 rows, Q loaded once and
//    kept as A fragments in registers; at 204 registers a thread two such
//    blocks share an SM, and one block's products run while the other
//    waits at a barrier. 128-row blocks of 8 warps read K and V half as
//    often but fit one block per SM, and measured slower at every shape of
//    this repo's paths (scripts/flash_tile_rows.py builds and times both). The
//    products are mma.sync m16n8k16 with float32 accumulation: the score
//    accumulators are re-packed in registers as the A operand of P V and
//    V's B operand comes through ldmatrix.trans. wgmma (64-row warpgroup
//    tiles, B from shared memory) would raise the tensor-core rate, but
//    these products are small (16 x 64 x D per warp and tile) and the
//    kernel is not bound by their rate at these lengths; it stays on
//    mma.sync, with wgmma queued as the kernel's next step. The softmax
//    runs in base 2: the running max m2 is kept in units of scale log2(e),
//    p = exp2(fma(s, scale log2(e), -m2)) is one FMA and one exp2, and
//    lse = (m2 + log2 l) ln 2 is written in natural log for the backward.
//    The mask test runs only on tiles that cut a warp's rows (the diagonal,
//    valid or prefix); tiles wholly inside skip it. Under a causal mask the
//    grid launches the heaviest query tiles (the last rows) first;
//  - flash_fwd_mma32 (float32, head_dim 64 or 128, 16-byte aligned rows):
//    flash_fwd_mma's shape in float32 (one block per example, head and 64
//    query rows, 4 warps of 16 rows, heaviest causal tiles first, K and V
//    through a two-stage cp.async ring with zero fill past Lkv, the mask
//    test only on tiles that cut a warp's rows, base-2 softmax, one
//    division at the end). Both products run on the tensor cores as
//    mma.sync m16n8k8 in split TF32 (flash_common.cuh): each operand as
//    a TF32 high part and a remainder, three TF32 products, about
//    float32's accuracy (one TF32 product keeps ~3 digits, and float32's
//    bound is 1e-4). At D 64 the warp's Q fragments are split once and
//    stay in registers; at D 128 they would need 128 registers, so they
//    are read and split from shared memory on every tile. K and V are
//    split as their fragments are read: for every three products a warp
//    issues two shared loads and four split operations, and the kernel is
//    bound by that issue and its latency more than by the tensor cores
//    (whose three products would take ~0.4x the float32 FMA bound). P reaches the P V product's A operand in registers: the
//    score accumulator holds keys 2t, 2t + 1 where the A fragment wants
//    depth t, t + 4, so V's rows are read in that permuted key order (the
//    float32 sum over keys may run in any order). The alternative, P
//    through a shared-memory tile a warp in the natural order, measured
//    1-4% slower at the CLI shapes and needs 10-19 KB more shared memory
//    a block, so the kernel keeps P in registers (PERF.md, section 6).
//    Rows of D + 4 floats put every fragment load on 32 distinct
//    banks. Key tiles: 64 rows at D 64 (87,040 bytes a block), 32 at D
//    128 (101,376): two blocks fit an SM at both;
//  - flash_fwd_simple (float32 or bf16, any head_dim <= 128, any strides):
//    plain float32 FMA loops, one key column per lane, 64 query rows per
//    block and synchronous tile loads; it takes the shapes the tensor-core
//    kernels refuse, and is the float32 check that chip_smoke.py holds
//    flash_fwd_mma32 against.
// All three mask ragged edges themselves (lengths need not divide a tile), use
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
  int causal, bf16, route;  // route: ROUTE_* of flash_common.cuh
  float sm_scale;
};

constexpr int BQ = 64;       // query rows per block (16 per warp)
constexpr int THREADS = 128;

// A block whose ROWS rows are all padding: zeros and +inf. NT threads.
template <typename T, int ROWS, int NT>
__device__ void write_dead_tile(const FlashArgs& a, int b, int h, int q0) {
  T* o = (T*)a.o + b * a.o_sb + h * a.o_sh;
  const int rows = min(ROWS, a.Lq - q0);
  for (int i = threadIdx.x; i < rows * a.D; i += NT) {
    const int r = i / a.D, d = i % a.D;
    o[(long long)(q0 + r) * a.o_sl + d] = from_f<T>(0.f);
  }
  if (a.lse)
    for (int r = threadIdx.x; r < rows; r += NT)
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
    write_dead_tile<T, BQ, THREADS>(a, b, h, q0);
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

  const int kv_end = kv_end_of(q0, BQ, valid, prefix, a.causal);
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

constexpr int MQ = 64;         // query rows per block (16 per warp)
constexpr int MTHREADS = 128;  // 4 warps; two blocks per SM
constexpr int MKV = 64;        // key rows per tile
constexpr float LN2 = 0.6931471805599453f;

template <int D>
__global__ void __launch_bounds__(MTHREADS, 2)
flash_fwd_mma(const FlashArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int LD = D + PAD;
  constexpr int KS = D / 16;   // k-steps of Q K^T
  constexpr int NT = MKV / 8;  // score n-tiles per warp
  constexpr int OT = D / 8;    // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [MQ][LD]
  T* Ks = Qs + MQ * LD;                    // [STAGES][MKV][LD]
  T* Vs = Ks + STAGES * MKV * LD;          // [STAGES][MKV][LD]

  // Grid (H, B, query tiles): the tile index varies slowest, and under a
  // causal mask it is reversed, so the tiles with the most live keys start
  // first and the short ones fill the tail.
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * MQ, h = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];         // rows at or past it: padding
  const int valid = min(valid_q, a.Lkv);      // live key columns end here
  const int prefix = a.prefix_len[b];
  if (q0 >= valid_q || valid <= 0) {
    write_dead_tile<T, MQ, MTHREADS>(a, b, h, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const T* q = (const T*)a.q + b * a.q_sb + h * a.q_sh;
  const T* k = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* v = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const float c2 = a.sm_scale * LOG2E;   // raw score -> base-2 exponent

  const int kv_end = kv_end_of(q0, MQ, valid, prefix, a.causal);
  const int ntiles = (kv_end + MKV - 1) / MKV;
  // Group 0: Q and the first K/V tile.
  stage_tile_async<D, MTHREADS>(Qs, q, a.q_sl, q0, a.Lq, MQ);
  stage_tile_async<D, MTHREADS>(Ks, k, a.k_sl, 0, a.Lkv, MKV);
  stage_tile_async<D, MTHREADS>(Vs, v, a.v_sl, 0, a.Lkv, MKV);
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // Row state of rows g (index 0) and g + 8 (index 1): m is the running
  // max in base-2 units (raw score times c2); l is this lane's partial
  // sum, reduced over the quad at the end.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_min = q0 + warp * 16;
  const int row_lo = row_min + g;

  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * MKV;
    // Tile j + 1 goes into the other stage while tile j is used; the group
    // is committed even when empty, so "all but the newest" is tile j.
    if (j + 1 < ntiles) {
      const int st = (j + 1) % STAGES;
      stage_tile_async<D, MTHREADS>(Ks + st * MKV * LD, k, a.k_sl, kv0 + MKV,
                                    a.Lkv, MKV);
      stage_tile_async<D, MTHREADS>(Vs + st * MKV * LD, v, a.v_sl, kv0 + MKV,
                                    a.Lkv, MKV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
      // This warp's 16 query rows as A fragments, kept for the whole walk.
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        load_a_frag(qf[kk], Qs + warp * 16 * LD + kk * 16, LD, lane);
    }
    const T* Kt = Ks + (j % STAGES) * MKV * LD;
    const T* Vt = Vs + (j % STAGES) * MKV * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kb = Kt + (n * 8 + g) * LD + kk * 16 + t * 2;
        mma_bf16(s[n], qf[kk], *reinterpret_cast<const uint32_t*>(kb),
                 *reinterpret_cast<const uint32_t*>(kb + 8));
      }
    }

    // The mask test runs only where the tile cuts this warp's rows: past
    // valid, or above the diagonal and past the prefix. A tile wholly
    // inside the mask (the same answer for all 32 lanes) skips it.
    const bool inside =
        kv0 + MKV <= valid &&
        (!a.causal || kv0 + MKV - 1 <= row_min || kv0 + MKV <= prefix);
    float m_cur[2] = {MASK_VALUE, MASK_VALUE};
    if (inside) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m_cur[i / 2] = fmaxf(m_cur[i / 2], s[n][i]);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row_lo + (i / 2) * 8;
          const int col = kv0 + n * 8 + t * 2 + (i % 2);
          if (!live(row, col, valid, prefix, a.causal)) s[n][i] = MASK_VALUE;
          m_cur[i / 2] = fmaxf(m_cur[i / 2], s[n][i]);
        }
      }
    }
    // Raw scores and their max; c2 > 0, so max(s) c2 = max(s c2) exactly.
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m[r], m_cur[r] * c2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(fmaf(s[n][i], c2, -m[i / 2]));
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

    // P V: two adjacent score n-tiles are one 16-deep A fragment; V's B
    // fragments come through ldmatrix .trans (registers 0,1 of output
    // tile n, 2,3 of tile n + 1).
#pragma unroll
    for (int kk = 0; kk < MKV / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < OT; n += 2) {
        uint32_t vb[4];
        load_b_trans(vb, Vt + kk * 16 * LD + n * 8, LD, lane);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    // Every warp is done with this stage before tile j + 2 refills it.
    __syncthreads();
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
          pad ? INFINITY : (m[r] + log2f(l[r])) * LN2;
  }
}

// ---------------------------------------------------------------------------
// float32 tensor-core kernel (float32, head_dim 64 or 128)
// ---------------------------------------------------------------------------

constexpr int M32_Q = 64;         // query rows per block (16 per warp)
constexpr int M32_THREADS = 128;  // 4 warps; two blocks per SM
constexpr int M32_KV_D64 = 64;    // key rows per tile at head_dim 64
constexpr int M32_KV_D128 = 32;   // and at 128, so that two blocks fit an SM
constexpr int M32_STAGES = 2;     // tiles in the cp.async ring

// What a head_dim fixes: the key tile, whether the warp's Q fragments stay
// in registers (split once) or are read and split from shared memory each
// tile (at D 128 the 128 registers of the split fragments would spill),
// and the shared memory: Q, then the K and V rings
// (ops/attention.py mma32_smem_bytes computes the same sum).
template <int D>
struct Mma32 {
  static constexpr int KV = D == 64 ? M32_KV_D64 : M32_KV_D128;
  static constexpr bool QREG = D == 64;
  static constexpr int LD = D + PAD32;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)M32_Q * LD + (size_t)M32_STAGES * KV * 2 * LD);
};
static_assert(2 * (Mma32<64>::SMEM + 1024) <= 233472 &&
                  2 * (Mma32<128>::SMEM + 1024) <= 233472,
              "two flash_fwd_mma32 blocks share an SM");

template <int D>
__global__ void __launch_bounds__(M32_THREADS, 2)
flash_fwd_mma32(const FlashArgs a) {
  typedef Mma32<D> C;
  constexpr int KV = C::KV, LD = C::LD;
  constexpr int NT = KV / 8;   // score n-tiles per warp, and P V k-steps
  constexpr int OT = D / 8;    // output n-tiles per warp
  extern __shared__ __align__(16) float smem_f32[];
  float* Qs = smem_f32;                      // [M32_Q][LD]
  float* Ks = Qs + M32_Q * LD;               // [STAGES][KV][LD]
  float* Vs = Ks + M32_STAGES * KV * LD;     // [STAGES][KV][LD]

  // Grid (H, B, query tiles), the heaviest causal tiles first (as
  // flash_fwd_mma).
  const int qt = a.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * M32_Q, h = blockIdx.x, b = blockIdx.y;
  const int valid_q = a.valid_len[b];         // rows at or past it: padding
  const int valid = min(valid_q, a.Lkv);      // live key columns end here
  const int prefix = a.prefix_len[b];
  if (q0 >= valid_q || valid <= 0) {
    write_dead_tile<float, M32_Q, M32_THREADS>(a, b, h, q0);
    return;
  }
  const int hk = h / (a.H / a.Hkv);
  const float* q = (const float*)a.q + b * a.q_sb + h * a.q_sh;
  const float* k = (const float*)a.k + b * a.k_sb + hk * a.k_sh;
  const float* v = (const float*)a.v + b * a.v_sb + hk * a.v_sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const float c2 = a.sm_scale * LOG2E;   // raw score -> base-2 exponent

  const int kv_end = kv_end_of(q0, M32_Q, valid, prefix, a.causal);
  const int ntiles = (kv_end + KV - 1) / KV;
  // Group 0: Q and the first K/V tile.
  stage_tile_f32_async<D, LD, M32_THREADS>(Qs, q, a.q_sl, q0, a.Lq, M32_Q);
  stage_tile_f32_async<D, LD, M32_THREADS>(Ks, k, a.k_sl, 0, a.Lkv, KV);
  stage_tile_f32_async<D, LD, M32_THREADS>(Vs, v, a.v_sl, 0, a.Lkv, KV);
  cp_async_commit();

  const float* Qw = Qs + warp * 16 * LD;
  uint32_t qh[C::QREG ? D / 8 : 1][4], ql[C::QREG ? D / 8 : 1][4];
  auto qa = [&](int kk, uint32_t(&ah)[4], uint32_t(&al)[4]) {
    if constexpr (C::QREG) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[i] = qh[kk][i];
        al[i] = ql[kk][i];
      }
    } else {
      load_a_split(ah, al, Qw + kk * 8, LD, g, t);
    }
  };
  float o[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  // Row state of rows g (index 0) and g + 8 (index 1), as flash_fwd_mma.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row_min = q0 + warp * 16;
  const int row_lo = row_min + g;

  for (int j = 0; j < ntiles; ++j) {
    const int kv0 = j * KV;
    if (j + 1 < ntiles) {
      const int st = (j + 1) % M32_STAGES;
      stage_tile_f32_async<D, LD, M32_THREADS>(Ks + st * KV * LD, k, a.k_sl,
                                               kv0 + KV, a.Lkv, KV);
      stage_tile_f32_async<D, LD, M32_THREADS>(Vs + st * KV * LD, v, a.v_sl,
                                               kv0 + KV, a.Lkv, KV);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (C::QREG) {
      if (j == 0) {
        // This warp's 16 query rows, split once, kept for the whole walk.
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk)
          load_a_split(qh[kk], ql[kk], Qw + kk * 8, LD, g, t);
      }
    }
    const float* Kt = Ks + (j % M32_STAGES) * KV * LD;
    const float* Vt = Vs + (j % M32_STAGES) * KV * LD;

    float s[NT][4];
    scores_tf32x3<D, NT, LD>(s, qa, Kt, g, t);

    // Mask and online softmax in base 2: flash_fwd_mma's code.
    const bool inside =
        kv0 + KV <= valid &&
        (!a.causal || kv0 + KV - 1 <= row_min || kv0 + KV <= prefix);
    float m_cur[2] = {MASK_VALUE, MASK_VALUE};
    if (inside) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          m_cur[i / 2] = fmaxf(m_cur[i / 2], s[n][i]);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = row_lo + (i / 2) * 8;
          const int col = kv0 + n * 8 + t * 2 + (i % 2);
          if (!live(row, col, valid, prefix, a.causal)) s[n][i] = MASK_VALUE;
          m_cur[i / 2] = fmaxf(m_cur[i / 2], s[n][i]);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
      m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
      const float m_new = fmaxf(m[r], m_cur[r] * c2);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(fmaf(s[n][i], c2, -m[i / 2]));
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

    // P V without shared memory. The C fragment of score n-tile kk holds
    // keys 2t, 2t + 1 of rows g, g + 8, and the A fragment wants depth
    // t, t + 4: so depth t is read as key 2t and t + 4 as key 2t + 1, and
    // V's B fragment reads its rows in the same order (acc_as_a_split,
    // load_b_perm_split). The sum over keys runs in another order, which
    // float32 sums allow.
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ph[4], pl[4];
      acc_as_a_split(ph, pl, s[kk]);
      const float* vb = Vt + kk * 8 * LD;
#pragma unroll
      for (int n = 0; n < OT; ++n) {
        uint32_t bh[2], bl[2];
        load_b_perm_split(bh, bl, vb + n * 8, LD, g, t);
        mma_tf32x3(o[n], ph, pl, bh, bl);
      }
    }
    // Every warp is done with this stage before tile j + 2 refills it.
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* out = (float*)a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + r * 8;
    if (row >= a.Lq) continue;
    const bool pad = row >= valid_q || l[r] == 0.f;
    const float inv = pad ? 0.f : 1.f / l[r];
    float* orow = out + (long long)row * a.o_sl + t * 2;
#pragma unroll
    for (int n = 0; n < OT; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (a.lse && t == 0)
      a.lse[((long long)b * a.H + h) * a.Lq + row] =
          pad ? INFINITY : (m[r] + log2f(l[r])) * LN2;
  }
}

// Every row of q, k, v and out starts on 16 bytes.
inline bool rows_aligned16(const FlashArgs& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const long long strides[12] = {a.q_sb, a.q_sh, a.q_sl, a.k_sb,
                                 a.k_sh, a.k_sl, a.v_sb, a.v_sh,
                                 a.v_sl, a.o_sb, a.o_sh, a.o_sl};
  return rows_aligned16(ptrs, strides, 4);
}

template <typename K>
cudaError_t launch(K kernel, const FlashArgs& a, size_t smem, dim3 grid,
                   int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace stair

extern "C" int stair_flash_attn_fwd(const stair::FlashArgs* args,
                                    void* stream) {
  using namespace stair;
  const FlashArgs& a = *args;
  cudaStream_t st = (cudaStream_t)stream;
  if (a.D < 1 || a.D > 32 * SDJ) return (int)cudaErrorInvalidValue;
  if (a.route == ROUTE_MMA32) {
    if (a.bf16 || (a.D != 64 && a.D != 128) || !rows_aligned16(a))
      return (int)cudaErrorInvalidValue;
    const dim3 grid(a.H, a.B, (a.Lq + M32_Q - 1) / M32_Q);
    return (int)(a.D == 64 ? launch(flash_fwd_mma32<64>, a, Mma32<64>::SMEM,
                                    grid, M32_THREADS, st)
                           : launch(flash_fwd_mma32<128>, a,
                                    Mma32<128>::SMEM, grid, M32_THREADS, st));
  }
  if (a.route == ROUTE_MMA) {
    if (!a.bf16 || (a.D != 64 && a.D != 128))
      return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(MQ + 2 * STAGES * MKV) * (a.D + PAD) *
                        sizeof(__nv_bfloat16);
    const dim3 grid(a.H, a.B, (a.Lq + MQ - 1) / MQ);
    return (int)(a.D == 64
                     ? launch(flash_fwd_mma<64>, a, smem, grid, MTHREADS, st)
                     : launch(flash_fwd_mma<128>, a, smem, grid, MTHREADS,
                              st));
  }
  if (a.route != ROUTE_SIMPLE) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)BQ * a.D + SKV * (a.D + 1) +
                                       SKV * a.D + 4 * SROWS * SKV);
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  return (int)(a.bf16 ? launch(flash_fwd_simple<__nv_bfloat16>, a, smem, grid,
                               THREADS, st)
                      : launch(flash_fwd_simple<float>, a, smem, grid,
                               THREADS, st));
}
