// One step of the scan executor: every [F, H]-level module family of one
// instruction per example, in one kernel (eval, parity Filter).
//
// Replaces the TPU kernel stair_tpu/ops/executor_step.py _step_kernel,
// reached through fused_step. Per example and step it computes the stage-1
// expert MLP relu(x w1 + b1) w2 + b2 (11 experts), the Filter sum-pool, the
// HasItem sigmoid of column 0, the ExistsFrame cosine, the Localize cosines
// of the projected frames against both keyword operands, the FilterFrame
// gate, the stage-2 projection with the FilterFrame (relu * vmask) or
// Temporal (relu + LayerNorm) epilogue, and the AttnVideo product; the
// frames result is stored in place into slot (example, out_frames) of the
// frames register file.
//
// Three routes, which ops/executor_step.py step_route picks before the
// launch: executor_step_tc_kernel further down (bf16 at the widths
// mega_exec.py tc_route_shape takes, any F from 16 to 256, on the tensor
// cores: above 64 frames or at a ragged F a tile's frame rows in slices
// over a thread-block cluster), executor_step_fma32_kernel at the end
// (float32 at the widths executor_step.py step_fma32_shape takes, any F
// from 16 to 256: a small launch's tiles each on a thread-block cluster,
// its products on gemm32, every output bit for bit step_kernel's) and
// step_kernel (the general route: every other dtype and width).
//
// Design of step_kernel and executor_step_tc_kernel. One thread block per
// tile (the tensor-core route's row-slice mode: a cluster of them, each its
// frame rows); tile i works on example perm[i] of the expert-sorted order
// the caller computed (S_PERM), so neighbouring blocks read the same [H, H]
// expert weights from L2. The block reads its own column of the [12, B]
// schedule from global memory and indexes the register files directly (the
// TPU kernel's scalar prefetch, block index maps and one-hot row selects are
// gone), and it writes its frames result straight into rf: SSA guarantees
// that slot (b, out_frames) is none of the tile's operands, and each example
// is exactly one tile, so the in-place write races with nothing. A tile with
// no frames result writes nothing. Both round to the compute dtype where the
// TPU kernel casts, so that the plain version (ops/executor_step.py
// fused_step_reference) shares every rounding site. Rows the executor never
// reads (pooled / hasitem of a null stage 1, loc_a / loc_b of a tile that is
// not Localize / Superlative) are written as 0.
//
// step_kernel: the [F, H] intermediates (stage-1 hidden / stage-2 operand,
// and the float32 feat tile, later the pre-LayerNorm rows) sit in a
// per-tile float32 workspace that the wrapper allocates; operand vectors
// and per-frame rows sit in shared memory. Products are the shared-memory
// tiled float32-FMA loops of mega_common.cuh. What bounds it on an H100:
// operations, on the float32 CUDA cores (a live tile does two to three
// [F, H] @ [H, H] products, about 0.1 GFLOP at F = 64, H = 512); what holds
// it back: the loop's synchronous loads, and each tile's products on one SM.

#include "mega_common.cuh"

namespace {

using stair::from_f;
using stair::rd;
using stair::sigmoid_f;
using stair::to_f;
using stair::warp_sum;
using stair::MAX_F;
using stair::MAX_H;
using stair::mega::BK;
using stair::mega::BM;
using stair::mega::BN;
using stair::mega::block_sum;
using stair::mega::COS_EPS;
using stair::mega::NWARPS;
using stair::mega::THREADS;
using stair::mega::vecmat;

// Rows of the [NS, B] schedule (ops/executor_step.py S_*).
enum {
  S_PERM, S_E1, S_W2T, S_E2, S_FA, S_FB, S_VA, S_AA, S_FILT, S_FFV, S_VB,
  S_OUTF, NS
};
enum { E2_FF, E2_TEMPORAL, E2_SUPF, E2_NULL, E2_ATTNVIDEO };
constexpr int E1_LOCALIZE = 8, E1_NULL = 9;
constexpr int NPTRS = 23;

template <typename T>
struct Args {
  const int* scal;
  const T *rv;
  T* rf;
  const T *ra, *related, *vmask;
  const float* gkb;
  const T *w1u, *b1u, *w2u, *b2u, *w2t, *b2t, *ffwf, *lns, *lnb, *wk, *bk;
  T *pooled, *has, *exf;
  float *loc_a, *loc_b;
  float* ws;
  int B, Nv, Nf, Na, F, H;
};

struct Smem {
  float va[MAX_H], vb[MAX_H], kw[MAX_H];
  float vm[MAX_F], f1[MAX_F], f2[MAX_F];
  float As[BK][BM + 1];
  float Ws[BK][BN];
  float red[NWARPS];
  int ins[NS];
};

template <typename TA, typename TW, typename Epi>
__device__ void gemm(const TA* A, const TW* W, int M, int H, Smem& sm,
                     Epi epi) {
  stair::mega::gemm<float, false, false>(A, H, 1, W, H, 1, M, H, H,
                                         &sm.As[0][0], &sm.Ws[0][0], epi);
}

// All threads of the cluster's CTAs: every write before it, to shared or
// global memory, is visible to every thread after it.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Localize cosine row of keyword v [H] (shared) through localize.k against
// the feat tile (float32 values, rounded to T as they are read):
// out[f] = (rd(cos) + 1) * 0.49 * vm[f]. Warp per frame row.
template <typename T>
__device__ void loc_cos(const float* v, const Args<T>& a, const float* feat,
                        float* out, Smem& sm) {
  const int F = a.F, H = a.H;
  vecmat<T>(v, nullptr, nullptr, a.wk, H, H, [&](int n, float y) {
    sm.kw[n] = rd<T>(rd<T>(y) + to_f(a.bk[n]));
  });
  __syncthreads();
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += sm.kw[k] * sm.kw[k];
  const float nk = sqrtf(fmaxf(block_sum(nk2, sm.red), 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = w; f < F; f += NWARPS) {
    const float* row = feat + (size_t)f * H;
    float d = 0.f, n2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float x = rd<T>(row[k]);
      d += x * sm.kw[k];
      n2 += x * x;
    }
    d = warp_sum(d);
    n2 = warp_sum(n2);
    if (lane == 0) {
      const float nf = sqrtf(fmaxf(n2, 1e-30f));
      const float c = rd<T>(d / fmaxf(nf * nk, COS_EPS));
      out[f] = (c + 1.0f) * 0.49f * sm.vm[f];
    }
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) step_kernel(const Args<T> a) {
  __shared__ Smem sm;
  const int i = blockIdx.x;
  const int B = a.B, F = a.F, H = a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t FH = (size_t)F * H;

  if (tid < NS) sm.ins[tid] = a.scal[(size_t)tid * B + i];
  __syncthreads();
  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };
  const int b = clampi(sm.ins[S_PERM], B);
  const int e1 = sm.ins[S_E1], e2 = sm.ins[S_E2];
  const bool filt = sm.ins[S_FILT] > 0, ffv = sm.ins[S_FFV] > 0;
  const int ifa = clampi(sm.ins[S_FA], a.Nf);
  const int iva = clampi(sm.ins[S_VA], a.Nv), ivb = clampi(sm.ins[S_VB], a.Nv);
  const int iaa = clampi(sm.ins[S_AA], a.Na);
  const int out_f = clampi(sm.ins[S_OUTF], a.Nf);
  const bool stage1 = e1 >= 0 && e1 != E1_NULL && e1 < 11;

  const T* x = a.rf + ((size_t)b * a.Nf + ifa) * FH;
  T* fout = a.rf + ((size_t)b * a.Nf + out_f) * FH;
  float* ws_h = a.ws + ((size_t)i * 2 + 0) * FH;   // hidden, then x2
  float* feat = a.ws + ((size_t)i * 2 + 1) * FH;   // feat32, then pre-LN y

  for (int f = tid; f < F; f += THREADS)
    sm.vm[f] = to_f(a.vmask[(size_t)b * F + f]);
  for (int j = tid; j < H; j += THREADS) {
    sm.va[j] = to_f(a.rv[((size_t)b * a.Nv + iva) * H + j]);
    sm.vb[j] = to_f(a.rv[((size_t)b * a.Nv + ivb) * H + j]);
  }
  __syncthreads();

  // ---- stage 1: expert two-layer MLP; pooled and hasitem --------------
  if (stage1) {
    const T* w1 = a.w1u + (size_t)e1 * H * H;
    const T* b1 = a.b1u + (size_t)e1 * H;
    const T* w2 = a.w2u + (size_t)e1 * H * H;
    const T* b2 = a.b2u + (size_t)e1 * H;
    gemm(x, w1, F, H, sm, [&](int m, int n, float acc) {
      ws_h[(size_t)m * H + n] = rd<T>(fmaxf(acc + to_f(b1[n]), 0.f));
    });
    gemm(ws_h, w2, F, H, sm, [&](int m, int n, float acc) {
      const float v = acc + to_f(b2[n]);
      if (n == 0) sm.f1[m] = v;                    // h2[:, 0], unrounded
      feat[(size_t)m * H + n] = filt ? fmaxf(v, 0.f) : v;
    });
    for (int k = tid; k < H; k += THREADS) {
      float p = 0.f;
      for (int f = 0; f < F; ++f)
        p += feat[(size_t)f * H + k] * (sm.vm[f] * sm.vm[f]);
      a.pooled[(size_t)i * H + k] = from_f<T>(p);
    }
    for (int f = tid; f < F; f += THREADS)
      a.has[(size_t)b * F + f] = from_f<T>(sigmoid_f(sm.f1[f]) * sm.vm[f]);
  } else {
    for (int k = tid; k < H; k += THREADS)
      a.pooled[(size_t)i * H + k] = from_f<T>(0.f);
    for (int f = tid; f < F; f += THREADS)
      a.has[(size_t)b * F + f] = from_f<T>(0.f);
  }
  __syncthreads();

  // ---- existsframe cosine of the frames operand against va ------------
  {
    float n2 = 0.f;
    for (int k = tid; k < H; k += THREADS) n2 += sm.va[k] * sm.va[k];
    const float nva = sqrtf(fmaxf(block_sum(n2, sm.red), 1e-30f));
    for (int f = warp; f < F; f += NWARPS) {
      float d = 0.f, nx = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float v = to_f(x[(size_t)f * H + k]);
        d += v * sm.va[k];
        nx += v * v;
      }
      d = warp_sum(d);
      nx = sqrtf(fmaxf(warp_sum(nx), 1e-30f));
      if (lane == 0) {
        const float c = d / fmaxf(nx * nva, COS_EPS);
        a.exf[(size_t)b * F + f] = from_f<T>((c + 1.0f) * 0.49f * sm.vm[f]);
      }
    }
  }

  // ---- localize scores against both keyword operands ------------------
  if (e1 == E1_LOCALIZE) {
    loc_cos<T>(sm.va, a, feat, sm.f1, sm);
    loc_cos<T>(sm.vb, a, feat, sm.f2, sm);
    for (int f = tid; f < F; f += THREADS) {
      a.loc_a[(size_t)b * F + f] = sm.f1[f];
      a.loc_b[(size_t)b * F + f] = sm.f2[f];
    }
  } else {
    for (int f = tid; f < F; f += THREADS) {
      a.loc_a[(size_t)b * F + f] = 0.f;
      a.loc_b[(size_t)b * F + f] = 0.f;
    }
  }
  __syncthreads();

  // ---- stage 2: FilterFrame / Temporal projection, or AttnVideo -------
  if (e2 == E2_FF && stage1) {
    // gate = sigmoid(feat @ ffwf + gkb) for the vec keyword, else 1
    const float gk = a.gkb[b];
    for (int f = warp; f < F; f += NWARPS) {
      float d = 0.f;
      if (ffv)
        for (int k = lane; k < H; k += 32)
          d += rd<T>(feat[(size_t)f * H + k]) * to_f(a.ffwf[k]);
      d = warp_sum(d);
      if (lane == 0) sm.f1[f] = ffv ? sigmoid_f(d + gk) : 1.0f;
    }
    __syncthreads();
    for (size_t j = tid; j < FH; j += THREADS)
      ws_h[j] = rd<T>(sm.f1[j / H] * rd<T>(feat[j]));
    __syncthreads();
    const T* b20 = a.b2t;
    gemm(ws_h, a.w2t, F, H, sm, [&](int m, int n, float acc) {
      fout[(size_t)m * H + n] =
          from_f<T>(fmaxf(acc + to_f(b20[n]), 0.f) * sm.vm[m]);
    });
  } else if (e2 == E2_TEMPORAL) {
    for (int f = tid; f < F; f += THREADS)
      sm.f1[f] = to_f(a.related[(size_t)b * F + f]);
    __syncthreads();
    for (size_t j = tid; j < FH; j += THREADS)
      ws_h[j] = rd<T>(sm.f1[j / H] * to_f(x[j]));
    __syncthreads();
    const T* b21 = a.b2t + H;
    gemm(ws_h, a.w2t + (size_t)H * H, F, H, sm, [&](int m, int n, float acc) {
      feat[(size_t)m * H + n] = fmaxf(acc + to_f(b21[n]), 0.f);
    });
    for (int f = warp; f < F; f += NWARPS) {
      const float* y = feat + (size_t)f * H;
      float s = 0.f;
      for (int k = lane; k < H; k += 32) s += y[k];
      const float mu = warp_sum(s) / H;
      float s2 = 0.f;
      // as the plain version and the TPU kernel: the square and the
      // last product rounded on their own (no contraction into an
      // FMA), rsqrt (the backward's recompute in mega_grad.cu too)
      for (int k = lane; k < H; k += 32)
        s2 += __fmul_rn(y[k] - mu, y[k] - mu);
      const float var = warp_sum(s2) / H;
      const float inv = rsqrtf(var + 1e-5f);
      for (int k = lane; k < H; k += 32)
        fout[(size_t)f * H + k] = from_f<T>(
            __fmul_rn((y[k] - mu) * inv, to_f(a.lns[k])) +
            to_f(a.lnb[k]));
    }
  } else if (e2 == E2_ATTNVIDEO) {
    for (int f = tid; f < F; f += THREADS)
      sm.f1[f] = to_f(a.ra[((size_t)b * a.Na + iaa) * F + f]);
    __syncthreads();
    for (size_t j = tid; j < FH; j += THREADS)
      fout[j] = from_f<T>(sm.f1[j / H] * to_f(x[j]));
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route: executor_step_tc_kernel<SLICED> (bf16 at the widths
// mega_exec.py tc_route_shape takes: H a multiple of 64 up to TC_MAX_H, any
// F in [TC_MIN_F, TC_ROUTE_MAX_F]).
//
// mega_exec_tc_kernel's per-step design (#4, mega_exec.cu) applied to one
// step of every example. Every [F, H] @ [H, H] product (the stage-1 expert
// MLP, the FilterFrame and Temporal projections) runs on mma.sync through
// fwd_gemm (mega_common.cuh): its A operand is a bf16 tile in shared memory
// and already exact in bf16 at the TPU kernel's cast sites (the frames
// operand is bf16, the hidden and the gated / related operand rows are
// rounded values), so against the plain version only the order of the
// float32 sums changes; W streams from L2 through fwd_gemm's cp.async ring.
//
// A product's output row depends on its own A row alone, and so does every
// per-row pass of the step (the ExistsFrame and Localize cosines, the
// FilterFrame gate, the LayerNorm). So a CTA walks its frame rows in slices
// of at most TC_MAX_F rows and runs the whole step on each slice in two
// [rows, H + TC_PAD] bf16 tiles (rows padded to whole 16-row mma tiles):
// the frames operand x comes into the first by cp.async and the ExistsFrame
// cosine reads it; the hidden goes into the second, and rd(feat32) replaces
// x in the first; the Localize cosines read those bf16 feat rows; the
// FilterFrame operand goes into the second tile, its result into the first
// and out as 16-byte rows; the Temporal operand into the second, its
// pre-LayerNorm rows (float32) into the workspace. A row's mma sum takes the
// same k steps on the same fragments in any slice (row tiles start at
// multiples of 16), so no output row depends on how F is cut. hasitem takes
// the unrounded column 0 in the second product's epilogue. What crosses the
// rows: the tile's vectors (|va|, the Localize keywords through vecmat_tc
// and their norms), which each CTA computes before its slices, and pooled,
// the sum over frames of the unrounded feat32 * vm^2.
//
// Two modes, the launch choosing:
// - F a multiple of 16 up to TC_MAX_F (the serving path's F 64), SLICED
//   false: one CTA a tile, one slice. Each output (m, n) of the second
//   product is one thread's (fwd_gemm's fragments: two warps down the rows,
//   eight row lanes a warp, four rows a thread and column), so the epilogue
//   adds it into pooled row group (m / 32) * 8 + m % 8 of column n in shared
//   memory, which that thread alone owns, and the POOL_ROWS groups are summed
//   in a fixed order after the slice: no atomics, the same bits from run to
//   run.
// - The row-slice mode (SLICED: F above TC_MAX_F or not a multiple of 16,
//   the NMN CLIs' default F 150; or a forced cluster): a tile on a
//   thread-block cluster of C CTAs (tc_cluster: one CTA a slice while the
//   launch fits one wave of the card's CTA slots, else 2, else 1), CTA r
//   owning the rows [r R, min(F, (r + 1) R)), R = tc_cta_rows(F, C). The
//   epilogue writes feat32 to the tile's float32 workspace; after one
//   cluster barrier (release / acquire: the peers' global writes are visible
//   after it) CTA r sums its columns [r H / C, (r + 1) H / C) of pooled, each
//   one chain over ascending frames read from L2. So every output equals one
//   CTA's bit for bit at any C, and nothing is read from a peer's shared
//   memory.
//
// Shared memory (step_tc_smem_bytes): at F = 64, H = 512 the two tiles 133
// KB, the W ring 54 KB, the pooled groups 32 KB (vecmat_tc's partials share
// them), four [H] and two [F] float vectors: 229,920 bytes; in the row-slice
// mode at F = 150, H = 512 two tiles of 64 rows, the ring, vecmat_tc's 8 KB
// of partials and the vectors: 206,032 bytes. One CTA of 8 warps an SM.
//
// What bounds it on an H100: per live tile two or three [F x 512] @ [512 x
// 512] products whose 512 KB weight tables each CTA reads from L2 (64
// operations a byte at 64 rows, so L2 bandwidth and the mma.sync rate are of
// one size). In the row-slice mode a cluster reads the tables once a CTA, C
// times a tile; at one CTA a tile the slices of a tile run in turn.

using bf16 = __nv_bfloat16;
using stair::cp_async16;
using stair::cp_async_commit;
using stair::cp_async_wait;
using stair::TC_MAX_F;
using stair::TC_MAX_H;
using stair::TC_MIN_F;
using stair::TC_ROUTE_MAX_F;
using stair::mega::FWD_BN;
using stair::mega::fwd_gemm;
using stair::mega::tc_cluster;
using stair::mega::tc_cta_rows;
using stair::mega::tc_ring;
using stair::mega::tc_slice_rows;
using stair::mega::TC_PAD;
using stair::mega::TC_PARTS;
using stair::mega::vecmat_tc;

// Row groups of the pooled partials (see above).
constexpr int POOL_ROWS = 16;

// Dynamic shared memory of executor_step_tc_kernel<sliced> in bytes
// (ops/executor_step.py step_tc_smem_bytes mirrors it): the two tiles (F
// rows, or in the row-slice mode tc_slice_rows(F)), the weight ring, four
// [H] float vectors, the pooled groups (vecmat_tc's partials share them) or
// in the row-slice mode vecmat_tc's partials alone, two [F] float vectors
// and the warp sums.
__host__ __device__ inline size_t step_tc_smem_bytes(int F, int H,
                                                     bool sliced) {
  return 2 * (size_t)(sliced ? tc_slice_rows(F) : F) * (H + TC_PAD) *
             sizeof(bf16) +
         (size_t)tc_ring<FWD_BN>() * sizeof(bf16) +
         (4 * (size_t)H +
          (sliced ? TC_PARTS
                  : (POOL_ROWS * H > TC_PARTS ? POOL_ROWS * H : TC_PARTS)) +
          2 * (size_t)F + NWARPS) * sizeof(float);
}

// The Localize keyword of v [H] (shared) through localize.k: kw = rd(rd(v
// wk) + bk) by vecmat_tc (its partials in part). Returns |kw|. Called by the
// whole block.
__device__ float loc_key_tc(const float* v, const Args<bf16>& a, float* kw,
                            float* part, float* red) {
  const int H = a.H;
  vecmat_tc(v, nullptr, nullptr, a.wk, H, H, part, [&](int n, float y) {
    kw[n] = rd<bf16>(rd<bf16>(y) + to_f(a.bk[n]));
  });
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += kw[k] * kw[k];
  return sqrtf(fmaxf(block_sum(nk2, red), 1e-30f));
}

// C: the CTAs of a tile's cluster (launched with cluster dimension C; 1 where
// SLICED is false). One CTA an SM (its shared memory), said to ptxas too:
// without the bound it holds the row-slice mode to 128 registers and spills.
template <bool SLICED>
__global__ void __launch_bounds__(THREADS, 1)
    executor_step_tc_kernel(const Args<bf16> a, int C) {
  extern __shared__ __align__(16) unsigned char step_smem[];
  __shared__ int ins[NS];
  using T = bf16;
  const int i = (int)(blockIdx.x / C);   // the tile
  const int B = a.B, F = a.F, H = a.H, LDT = H + TC_PAD;
  const int SR = SLICED ? tc_slice_rows(F) : F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t FH = (size_t)F * H;
  // this CTA's frame rows [r0, r1)
  const int R = SLICED ? tc_cta_rows(F, C) : F;
  const int r0 = SLICED ? (int)(blockIdx.x % C) * R : 0;
  const int r1 = F < r0 + R ? F : r0 + R;

  bf16* x = reinterpret_cast<bf16*>(step_smem);   // x, then feat
  bf16* h = x + (size_t)SR * LDT;   // hidden, then the stage-2 operand
  bf16* ring = h + (size_t)SR * LDT;
  float* va = reinterpret_cast<float*>(ring + tc_ring<FWD_BN>());
  float* vb = va + H;
  float* kwa = vb + H;   // the Localize keywords of va and vb
  float* kwb = kwa + H;
  float* part = kwb + H;   // vecmat_tc's parts; pooled groups [POOL_ROWS][H]
  float* vm = part + (SLICED ? TC_PARTS
                             : (POOL_ROWS * H > TC_PARTS ? POOL_ROWS * H
                                                         : TC_PARTS));
  float* g = vm + F;   // a frame's gate, related weight or attention weight
  float* red = g + F;

  if (tid < NS) ins[tid] = a.scal[(size_t)tid * B + i];
  __syncthreads();
  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };
  const int b = clampi(ins[S_PERM], B);
  const int e1 = ins[S_E1], e2 = ins[S_E2];
  const bool filt = ins[S_FILT] > 0, ffv = ins[S_FFV] > 0;
  const int ifa = clampi(ins[S_FA], a.Nf);
  const int iva = clampi(ins[S_VA], a.Nv), ivb = clampi(ins[S_VB], a.Nv);
  const int iaa = clampi(ins[S_AA], a.Na);
  const int out_f = clampi(ins[S_OUTF], a.Nf);
  const bool stage1 = e1 >= 0 && e1 != E1_NULL && e1 < 11;

  const T* xg = a.rf + ((size_t)b * a.Nf + ifa) * FH;
  T* fout = a.rf + ((size_t)b * a.Nf + out_f) * FH;
  // the tile's float32 workspace: the pre-LayerNorm rows; in the row-slice
  // mode feat32 first, then those rows
  float* feat32 = a.ws + (size_t)i * 2 * FH;
  float* y = SLICED ? feat32 + FH : a.ws + (size_t)i * FH;

  // rows [m0, m0 + rows) of the frames operand into x by cp.async, the
  // rows up to a whole mma tile zero
  const int per = H / 8;
  auto stage_x = [&](int m0, int rows) {
    const int n = ((rows + 15) & ~15) * per;
    for (int p = tid; p < n; p += THREADS) {
      const int r = p / per, c = (p % per) * 8;
      const bool in = r < rows;
      cp_async16(x + (size_t)r * LDT + c,
                 xg + (in ? (size_t)(m0 + r) * H + c : 0), in);
    }
    cp_async_commit();
  };

  // ---- the first slice's x (cp.async), the vectors meanwhile ------------
  if (r0 < r1) stage_x(r0, r1 - r0 < TC_MAX_F ? r1 - r0 : TC_MAX_F);
  for (int f = tid; f < F; f += THREADS)
    vm[f] = to_f(a.vmask[(size_t)b * F + f]);
  for (int j = tid; j < H; j += THREADS) {
    va[j] = to_f(a.rv[((size_t)b * a.Nv + iva) * H + j]);
    vb[j] = to_f(a.rv[((size_t)b * a.Nv + ivb) * H + j]);
  }
  __syncthreads();
  float nva = 0.f;
  for (int k = tid; k < H; k += THREADS) nva += va[k] * va[k];
  nva = sqrtf(fmaxf(block_sum(nva, red), 1e-30f));
  float nka = 0.f, nkb = 0.f;
  if (e1 == E1_LOCALIZE) {
    nka = loc_key_tc(va, a, kwa, part, red);
    nkb = loc_key_tc(vb, a, kwb, part, red);
  }
  if (!SLICED && stage1)
    for (int j = tid; j < POOL_ROWS * H; j += THREADS) part[j] = 0.f;

  // ---- the slices of this CTA's rows ------------------------------------
  for (int m0 = r0; m0 < r1; m0 += TC_MAX_F) {
    const int rows = r1 - m0 < TC_MAX_F ? r1 - m0 : TC_MAX_F;
    const int M = (rows + 15) & ~15;
    cp_async_wait<0>();
    __syncthreads();

    // existsframe cosine of x against va (before feat replaces x)
    for (int f = warp; f < rows; f += NWARPS) {
      float d = 0.f, nx = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float v = to_f(x[(size_t)f * LDT + k]);
        d += v * va[k];
        nx += v * v;
      }
      d = warp_sum(d);
      nx = sqrtf(fmaxf(warp_sum(nx), 1e-30f));
      if (lane == 0) {
        const float c = d / fmaxf(nx * nva, COS_EPS);
        a.exf[(size_t)b * F + m0 + f] =
            from_f<T>((c + 1.0f) * 0.49f * vm[m0 + f]);
      }
    }

    // stage 1: expert two-layer MLP; hasitem, and pooled's share
    if (stage1) {
      const T* b1 = a.b1u + (size_t)e1 * H;
      const T* b2 = a.b2u + (size_t)e1 * H;
      fwd_gemm(x, a.w1u + (size_t)e1 * H * H, M, H, H, ring,
               [&](int m, int n, float acc) {
        h[(size_t)m * LDT + n] = from_f<T>(fmaxf(acc + to_f(b1[n]), 0.f));
      });
      fwd_gemm(h, a.w2u + (size_t)e1 * H * H, M, H, H, ring,
               [&](int m, int n, float acc) {
        if (m >= rows) return;
        const int f = m0 + m;
        const float v = acc + to_f(b2[n]);
        const float fe = filt ? fmaxf(v, 0.f) : v;   // feat32
        if (n == 0)                                   // h2[:, 0], unrounded
          a.has[(size_t)b * F + f] = from_f<T>(sigmoid_f(v) * vm[f]);
        x[(size_t)m * LDT + n] = from_f<T>(fe);
        if constexpr (SLICED)
          feat32[(size_t)f * H + n] = fe;
        else
          part[((m >> 5) * 8 + (m & 7)) * H + n] += fe * (vm[f] * vm[f]);
      });
    } else {
      for (int f = tid; f < rows; f += THREADS)
        a.has[(size_t)b * F + m0 + f] = from_f<T>(0.f);
    }

    // localize scores against both keywords (the bf16 feat rows)
    if (e1 == E1_LOCALIZE) {
      for (int f = warp; f < rows; f += NWARPS) {
        float da = 0.f, db = 0.f, n2 = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float v = to_f(x[(size_t)f * LDT + k]);
          da += v * kwa[k];
          db += v * kwb[k];
          n2 += v * v;
        }
        da = warp_sum(da);
        db = warp_sum(db);
        n2 = warp_sum(n2);
        if (lane == 0) {
          const float nf = sqrtf(fmaxf(n2, 1e-30f));
          const float ca = rd<T>(da / fmaxf(nf * nka, COS_EPS));
          const float cb = rd<T>(db / fmaxf(nf * nkb, COS_EPS));
          a.loc_a[(size_t)b * F + m0 + f] = (ca + 1.0f) * 0.49f * vm[m0 + f];
          a.loc_b[(size_t)b * F + m0 + f] = (cb + 1.0f) * 0.49f * vm[m0 + f];
        }
      }
    } else {
      for (int f = tid; f < rows; f += THREADS) {
        a.loc_a[(size_t)b * F + m0 + f] = 0.f;
        a.loc_b[(size_t)b * F + m0 + f] = 0.f;
      }
    }

    // stage 2: FilterFrame / Temporal projection, or AttnVideo
    if (e2 == E2_FF && stage1) {
      // gate = sigmoid(feat @ ffwf + gkb) for the vec keyword, else 1
      const float gk = a.gkb[b];
      for (int f = warp; f < rows; f += NWARPS) {
        float d = 0.f;
        if (ffv)
          for (int k = lane; k < H; k += 32)
            d += to_f(x[(size_t)f * LDT + k]) * to_f(a.ffwf[k]);
        d = warp_sum(d);
        if (lane == 0) g[m0 + f] = ffv ? sigmoid_f(d + gk) : 1.0f;
      }
      __syncthreads();
      for (int j = tid; j < M * H; j += THREADS) {
        const int r = j / H;
        const size_t o = (size_t)r * LDT + j % H;
        h[o] = from_f<T>(r < rows ? g[m0 + r] * to_f(x[o]) : 0.f);
      }
      __syncthreads();
      // the result into x (feat is spent), then out as 16-byte rows
      fwd_gemm(h, a.w2t, M, H, H, ring, [&](int m, int n, float acc) {
        if (m < rows)
          x[(size_t)m * LDT + n] =
              from_f<T>(fmaxf(acc + to_f(a.b2t[n]), 0.f) * vm[m0 + m]);
      });
      for (int p = tid; p < rows * per; p += THREADS)
        *reinterpret_cast<uint4*>(fout + (size_t)(m0 + p / per) * H +
                                  (p % per) * 8) =
            *reinterpret_cast<const uint4*>(x + (size_t)(p / per) * LDT +
                                            (p % per) * 8);
    } else if (e2 == E2_TEMPORAL) {
      for (int f = tid; f < rows; f += THREADS)
        g[m0 + f] = to_f(a.related[(size_t)b * F + m0 + f]);
      __syncthreads();
      for (int j = tid; j < M * H; j += THREADS) {
        const int r = j / H, c = j % H;
        h[(size_t)r * LDT + c] = from_f<T>(
            r < rows ? g[m0 + r] * to_f(xg[(size_t)(m0 + r) * H + c]) : 0.f);
      }
      __syncthreads();
      const T* b21 = a.b2t + H;
      fwd_gemm(h, a.w2t + (size_t)H * H, M, H, H, ring,
               [&](int m, int n, float acc) {
        if (m < rows)
          y[(size_t)(m0 + m) * H + n] = fmaxf(acc + to_f(b21[n]), 0.f);
      });
      for (int f = m0 + warp; f < m0 + rows; f += NWARPS) {
        const float* yr = y + (size_t)f * H;
        float s = 0.f;
        for (int k = lane; k < H; k += 32) s += yr[k];
        const float mu = warp_sum(s) / H;
        float s2 = 0.f;
        // as step_kernel: the square and the last product rounded on their
        // own, rsqrt
        for (int k = lane; k < H; k += 32)
          s2 += __fmul_rn(yr[k] - mu, yr[k] - mu);
        const float var = warp_sum(s2) / H;
        const float inv = rsqrtf(var + 1e-5f);
        for (int k = lane; k < H; k += 32)
          fout[(size_t)f * H + k] = from_f<T>(
              __fmul_rn((yr[k] - mu) * inv, to_f(a.lns[k])) +
              to_f(a.lnb[k]));
      }
    } else if (e2 == E2_ATTNVIDEO) {
      // ra's [Na, F] rows start on no 16-byte boundary at an odd F: read
      // one element at a time
      for (int f = tid; f < rows; f += THREADS)
        g[m0 + f] = to_f(a.ra[((size_t)b * a.Na + iaa) * F + m0 + f]);
      __syncthreads();
      for (size_t j = tid; j < (size_t)rows * H; j += THREADS)
        fout[(size_t)m0 * H + j] =
            from_f<T>(g[m0 + j / H] * to_f(xg[(size_t)m0 * H + j]));
    }
    __syncthreads();   // every read of this slice's tiles done
    if (m0 + TC_MAX_F < r1)
      stage_x(m0 + TC_MAX_F,
              r1 - m0 - TC_MAX_F < TC_MAX_F ? r1 - m0 - TC_MAX_F : TC_MAX_F);
  }

  // ---- pooled: the groups in order, or (SLICED) my columns' chains -------
  if constexpr (SLICED) {
    if (C > 1) cluster_barrier();   // every CTA's feat32 rows
    const int r = (int)(blockIdx.x % C);
    for (int n = r * H / C + tid; n < (r + 1) * H / C; n += THREADS) {
      float p = 0.f;
      if (stage1)
        for (int f0 = 0; f0 < F; f0 += 16) {
          float v[16];   // sixteen loads in flight, summed in frame order
#pragma unroll
          for (int j = 0; j < 16; ++j)
            v[j] = f0 + j < F ? __ldcg(feat32 + (size_t)(f0 + j) * H + n)
                              : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (f0 + j < F) p += v[j] * (vm[f0 + j] * vm[f0 + j]);
        }
      a.pooled[(size_t)i * H + n] = from_f<T>(p);
    }
  } else {
    for (int n = tid; n < H; n += THREADS) {
      float p = 0.f;
      if (stage1)
#pragma unroll
        for (int q = 0; q < POOL_ROWS; ++q) p += part[q * H + n];
      a.pooled[(size_t)i * H + n] = from_f<T>(p);
    }
  }
}

// ---------------------------------------------------------------------------
// The float32 route: executor_step_fma32_kernel (float32 at the widths
// ops/executor_step.py step_fma32_shape takes, the "fma32" routes' of the
// executor megakernels: H a multiple of G32_BN up to FMA32_MAX_H, any F in
// [FMA32_MIN_F, FMA32_MAX_F], each product over gemm32's row tiles of
// G32_BM frames, the last one ragged).
//
// step_kernel's arithmetic, redesigned for Hopper in two ways.
// (1) Every [F, H] @ [H, H] product on gemm32 (mega_common.cuh): 64 x 128
// register-blocked float32 FMA tiles fed by a 3-stage cp.async ring, where
// step_kernel's gemm loads each k slice with synchronous loads. gemm32 keeps
// gemm's one FMA chain per output (from 0, ascending k), so every output is
// step_kernel<float>'s bit for bit.
// (2) While a launch's B tiles, one CTA each, would fill the card's CTA
// slots (its SMs x CTAs an SM) less than twice, one tile on a thread-block
// cluster of C = H / G32_BN CTAs, else C = 1 (step32_cluster, chosen in
// the launch; a forced C divides H / G32_BN), split by output columns: CTA
// r computes columns [r H / C, (r + 1) H / C) of each product (gemm32 on W
// + r H / C, ldw H),
// so a live tile's serial path on one SM is cut by C and each output keeps
// its chain. What a product reads whole (the hidden, the gated or related
// stage-2 operand) and the rows the per-row reductions read whole (feat,
// the Temporal pre-LayerNorm rows) go through step_kernel's per-tile
// float32 workspace, with one cluster barrier between the writes and the
// reads (release / acquire: the peers' global writes are visible after it;
// cp.async.cg and __ldcg read them from L2). The per-row reductions over H
// run a warp a row with step_kernel's lane order on CTA r's rows [r F / C,
// (r + 1) F / C): the ExistsFrame cosine, the Localize dots and norms, the
// FilterFrame gate (then the CTA writes those rows of the stage-2 operand)
// and the LayerNorm. Each CTA computes what step_kernel reduces over the
// whole block (|va|, the Localize keywords by vecmat and |kw|) itself, with
// the same threads in the same order. pooled is each column's chain over
// ascending f on the CTA that owns the column; hasitem reads column 0, on
// CTA 0. A tile without a stage 1 splits its cheap passes the same way.
// Nothing is read from a peer's shared memory, so a CTA may leave when it is
// done. The schedule is the tile's, so every CTA meets the same barriers:
// stage 1 two (after the hidden, after feat), FilterFrame and Temporal one
// before their product, Temporal one more before the LayerNorm.
//
// Shared memory: gemm32's ring and step_kernel's vectors, 83.7 KB at F =
// 64, H = 512 and 84.8 KB at F = 150 (step32_smem_bytes), and at most 128
// registers a thread (__launch_bounds__(THREADS, 2)): two CTAs an SM, 10-24% faster than one
// on an H100 at 216 tiles. The cluster against one CTA a tile, on an H100
// (132 SMs: 528 tiles fill its slots twice): 3.0x faster at 32 tiles, 1.9x
// at 128, 2.0x at 216, 1.3x at 256, 7% at 512; 1% slower at 384, 8% at
// 768, 4% at 1,024, but 10% faster at 640, where one CTA a tile leaves its
// last wave part empty (timed by scripts/step_fma32_variants.py, which
// builds this file with C or the shared memory asked patched).
//
// What bounds it on an H100: operations, on the float32 CUDA cores, as
// step_kernel.

using stair::FMA32_MAX_F;
using stair::FMA32_MAX_H;
using stair::FMA32_MIN_F;
using stair::mega::G32_BN;
using stair::mega::g32_ring;
using stair::mega::gemm32;

// CTAs of one tile's cluster at width H for a launch of B tiles on a card
// with `slots` CTA slots (SMs x CTAs an SM): the cluster while one CTA a
// tile would fill the card less than twice (ops/executor_step.py
// step_fma32_cluster mirrors it).
__host__ __device__ inline int step32_cluster(int B, int H, int slots) {
  return B < 2 * slots ? H / G32_BN : 1;
}

// Dynamic shared memory of executor_step_fma32_kernel in bytes
// (ops/executor_step.py step_fma32_smem_bytes mirrors it).
__host__ __device__ inline size_t step32_smem_bytes(int F, int H) {
  return ((size_t)g32_ring<false>() + 3 * (size_t)H + 3 * (size_t)F +
          NWARPS) * sizeof(float);
}

// Columns [c0, c0 + N) of A[F, H] @ W[H, H] on gemm32 (A and W float32,
// row stride H, 16-byte aligned); epi(m, n, acc) with n the column of W.
template <typename Epi>
__device__ void prod32(const float* A, const float* W, int F, int H, int c0,
                       int N, float* ring, Epi epi) {
  gemm32<false>(A, H, W + c0, H, F, H, N, ring,
                [&](int m, int n, float acc) { epi(m, c0 + n, acc); });
}

// loc_cos<float> on the feat rows [f0, f1) of the workspace (written by
// the cluster, read from L2; loc_cos's roundings are identities in
// float32): kw = v wk + bk by vecmat, out[f] = (cos + 1) * 0.49 * vm[f].
// Warp per frame row.
__device__ void loc_cos32(const float* v, const Args<float>& a,
                          const float* feat, int f0, int f1, float* kw,
                          const float* vm, float* red, float* out) {
  const int H = a.H;
  vecmat<float>(v, nullptr, nullptr, a.wk, H, H, [&](int n, float y) {
    kw[n] = y + a.bk[n];
  });
  __syncthreads();
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += kw[k] * kw[k];
  const float nk = sqrtf(fmaxf(block_sum(nk2, red), 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = f0 + w; f < f1; f += NWARPS) {
    const float* row = feat + (size_t)f * H;
    float d = 0.f, n2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float x = __ldcg(row + k);
      d += x * kw[k];
      n2 += x * x;
    }
    d = warp_sum(d);
    n2 = warp_sum(n2);
    if (lane == 0) {
      const float nf = sqrtf(fmaxf(n2, 1e-30f));
      const float c = d / fmaxf(nf * nk, COS_EPS);
      out[f] = (c + 1.0f) * 0.49f * vm[f];
    }
  }
  __syncthreads();
}

// C: the CTAs of a tile's cluster (launched with cluster dimension C). The
// tile's schedule and this CTA's share of it stay in shared memory (ins,
// own) and are read where they are used, so that none of it is held in
// registers across the products (held, they leave gemm32 too few of 128).
__global__ void __launch_bounds__(THREADS, 2)
    executor_step_fma32_kernel(const Args<float> a, int C) {
  extern __shared__ __align__(16) unsigned char step_smem[];
  __shared__ int ins[NS];
  __shared__ int own[5];   // tile; columns [c0, c1); rows [f0, f1)
  enum { O_TILE, O_C0, O_C1, O_F0, O_F1 };
  const int F = a.F, H = a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t FH = (size_t)F * H;

  float* ring = reinterpret_cast<float*>(step_smem);
  float* va = ring + g32_ring<false>();
  float* vb = va + H;
  float* kw = vb + H;
  float* vm = kw + H;
  float* g1 = vm + F;
  float* g2 = g1 + F;
  float* red = g2 + F;

  if (tid < NS) ins[tid] = a.scal[(size_t)tid * a.B + blockIdx.x / C];
  if (tid == 0) {
    const int r = blockIdx.x % C;
    own[O_TILE] = blockIdx.x / C;
    own[O_C0] = r * (H / C);
    own[O_C1] = (r + 1) * (H / C);
    own[O_F0] = r * F / C;
    own[O_F1] = (r + 1) * F / C;
  }
  __syncthreads();
  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };
  auto example = [&] { return clampi(ins[S_PERM], a.B); };
  auto stage1 = [&] {
    const int e1 = ins[S_E1];
    return e1 >= 0 && e1 != E1_NULL && e1 < 11;
  };
  // the frames slot of schedule row `row`; the tile's workspace k (0: the
  // hidden, then x2; 1: feat32, then the pre-LayerNorm rows)
  auto frames = [&](int row) {
    return a.rf + ((size_t)example() * a.Nf + clampi(ins[row], a.Nf)) * FH;
  };
  auto work = [&](int k) { return a.ws + ((size_t)own[O_TILE] * 2 + k) * FH; };

  {
    const int b = example();
    const int iva = clampi(ins[S_VA], a.Nv), ivb = clampi(ins[S_VB], a.Nv);
    for (int f = tid; f < F; f += THREADS) vm[f] = a.vmask[(size_t)b * F + f];
    for (int j = tid; j < H; j += THREADS) {
      va[j] = a.rv[((size_t)b * a.Nv + iva) * H + j];
      vb[j] = a.rv[((size_t)b * a.Nv + ivb) * H + j];
    }
  }
  __syncthreads();

  // ---- stage 1 on this CTA's columns; pooled and hasitem ---------------
  if (stage1()) {
    {
      const int e1 = ins[S_E1], c0 = own[O_C0];
      const float* b1 = a.b1u + (size_t)e1 * H;
      float* ws_h = work(0);
      prod32(frames(S_FA), a.w1u + (size_t)e1 * H * H, F, H, c0,
             own[O_C1] - c0, ring, [&](int m, int n, float acc) {
        ws_h[(size_t)m * H + n] = fmaxf(acc + b1[n], 0.f);
      });
    }
    cluster_barrier();   // the whole hidden
    {
      const int e1 = ins[S_E1], c0 = own[O_C0];
      const bool filt = ins[S_FILT] > 0;
      const float* b2 = a.b2u + (size_t)e1 * H;
      float* feat = work(1);
      prod32(work(0), a.w2u + (size_t)e1 * H * H, F, H, c0, own[O_C1] - c0,
             ring, [&](int m, int n, float acc) {
        const float v = acc + b2[n];
        if (n == 0) g1[m] = v;                     // h2[:, 0], unrounded
        feat[(size_t)m * H + n] = filt ? fmaxf(v, 0.f) : v;
      });
    }
    {
      const float* feat = work(1);
      const int i = own[O_TILE];
      for (int k = own[O_C0] + tid; k < own[O_C1]; k += THREADS) {
        float p = 0.f;
        for (int f = 0; f < F; ++f)
          p += feat[(size_t)f * H + k] * (vm[f] * vm[f]);
        a.pooled[(size_t)i * H + k] = p;
      }
      if (own[O_C0] == 0) {
        const int b = example();
        for (int f = tid; f < F; f += THREADS)
          a.has[(size_t)b * F + f] = sigmoid_f(g1[f]) * vm[f];
      }
    }
    cluster_barrier();   // the whole feat; every read of the hidden done
  } else {
    const int i = own[O_TILE], b = example();
    for (int k = own[O_C0] + tid; k < own[O_C1]; k += THREADS)
      a.pooled[(size_t)i * H + k] = 0.f;
    for (int f = own[O_F0] + tid; f < own[O_F1]; f += THREADS)
      a.has[(size_t)b * F + f] = 0.f;
  }

  // ---- existsframe cosine of the frames operand against va, my rows -----
  {
    const float* x = frames(S_FA);
    const int b = example();
    float n2 = 0.f;
    for (int k = tid; k < H; k += THREADS) n2 += va[k] * va[k];
    const float nva = sqrtf(fmaxf(block_sum(n2, red), 1e-30f));
    for (int f = own[O_F0] + warp; f < own[O_F1]; f += NWARPS) {
      float d = 0.f, nx = 0.f;
      for (int k = lane; k < H; k += 32) {
        const float v = x[(size_t)f * H + k];
        d += v * va[k];
        nx += v * v;
      }
      d = warp_sum(d);
      nx = sqrtf(fmaxf(warp_sum(nx), 1e-30f));
      if (lane == 0) {
        const float c = d / fmaxf(nx * nva, COS_EPS);
        a.exf[(size_t)b * F + f] = (c + 1.0f) * 0.49f * vm[f];
      }
    }
  }

  // ---- localize scores against both keyword operands, my rows ---------
  if (ins[S_E1] == E1_LOCALIZE) {
    loc_cos32(va, a, work(1), own[O_F0], own[O_F1], kw, vm, red, g1);
    loc_cos32(vb, a, work(1), own[O_F0], own[O_F1], kw, vm, red, g2);
    const int b = example();
    for (int f = own[O_F0] + tid; f < own[O_F1]; f += THREADS) {
      a.loc_a[(size_t)b * F + f] = g1[f];
      a.loc_b[(size_t)b * F + f] = g2[f];
    }
  } else {
    const int b = example();
    for (int f = own[O_F0] + tid; f < own[O_F1]; f += THREADS) {
      a.loc_a[(size_t)b * F + f] = 0.f;
      a.loc_b[(size_t)b * F + f] = 0.f;
    }
  }

  // ---- stage 2: FilterFrame / Temporal projection, or AttnVideo -------
  const int e2 = ins[S_E2];
  if (e2 == E2_FF && stage1()) {
    {
      // my rows of x2 = gate * feat, gate = sigmoid(feat @ ffwf + gkb) for
      // the vec keyword, else 1 (every lane holds the warp's sum)
      const bool ffv = ins[S_FFV] > 0;
      const float gk = a.gkb[example()];
      const float* feat = work(1);
      float* x2 = work(0);
      for (int f = own[O_F0] + warp; f < own[O_F1]; f += NWARPS) {
        const float* fr = feat + (size_t)f * H;
        float d = 0.f;
        if (ffv)
          for (int k = lane; k < H; k += 32) d += __ldcg(fr + k) * a.ffwf[k];
        d = warp_sum(d);
        const float g = ffv ? sigmoid_f(d + gk) : 1.0f;
        for (int k = lane; k < H; k += 32)
          x2[(size_t)f * H + k] = g * __ldcg(fr + k);
      }
    }
    cluster_barrier();   // the whole stage-2 operand
    float* fout = frames(S_OUTF);
    const int c0 = own[O_C0];
    prod32(work(0), a.w2t, F, H, c0, own[O_C1] - c0, ring,
           [&](int m, int n, float acc) {
      fout[(size_t)m * H + n] = fmaxf(acc + a.b2t[n], 0.f) * vm[m];
    });
  } else if (e2 == E2_TEMPORAL) {
    {
      const float* x = frames(S_FA);
      const int b = example();
      float* x2 = work(0);
      for (int f = own[O_F0] + warp; f < own[O_F1]; f += NWARPS) {
        const float rel = a.related[(size_t)b * F + f];
        for (int k = lane; k < H; k += 32)
          x2[(size_t)f * H + k] = rel * x[(size_t)f * H + k];
      }
    }
    cluster_barrier();   // the whole stage-2 operand
    {
      const float* b21 = a.b2t + H;
      float* y = work(1);
      const int c0 = own[O_C0];
      prod32(work(0), a.w2t + (size_t)H * H, F, H, c0, own[O_C1] - c0, ring,
             [&](int m, int n, float acc) {
        y[(size_t)m * H + n] = fmaxf(acc + b21[n], 0.f);
      });
    }
    cluster_barrier();   // the whole pre-LayerNorm rows
    float* fout = frames(S_OUTF);
    const float* yt = work(1);
    for (int f = own[O_F0] + warp; f < own[O_F1]; f += NWARPS) {
      const float* y = yt + (size_t)f * H;
      float s = 0.f;
      for (int k = lane; k < H; k += 32) s += __ldcg(y + k);
      const float mu = warp_sum(s) / H;
      float s2 = 0.f;
      // as step_kernel: the square and the last product rounded on their
      // own, rsqrt
      for (int k = lane; k < H; k += 32) {
        const float yk = __ldcg(y + k);
        s2 += __fmul_rn(yk - mu, yk - mu);
      }
      const float var = warp_sum(s2) / H;
      const float inv = rsqrtf(var + 1e-5f);
      for (int k = lane; k < H; k += 32)
        fout[(size_t)f * H + k] =
            __fmul_rn((__ldcg(y + k) - mu) * inv, a.lns[k]) + a.lnb[k];
    }
  } else if (e2 == E2_ATTNVIDEO) {
    const float* x = frames(S_FA);
    float* fout = frames(S_OUTF);
    const float* aa = a.ra + ((size_t)example() * a.Na +
                              clampi(ins[S_AA], a.Na)) * F;
    for (int f = own[O_F0] + warp; f < own[O_F1]; f += NWARPS)
      for (int k = lane; k < H; k += 32)
        fout[(size_t)f * H + k] = aa[f] * x[(size_t)f * H + k];
  }
}

// The pointer table of stair_executor_step as Args<T>.
template <typename T>
Args<T> args_of(const void* const* p, void* ws, int B, int Nv, int Nf,
                int Na, int F, int H) {
  Args<T> a;
  int k = 0;
  a.scal = (const int*)p[k++];
  a.rv = (const T*)p[k++];
  a.rf = (T*)p[k++];
  a.ra = (const T*)p[k++];
  a.related = (const T*)p[k++];
  a.vmask = (const T*)p[k++];
  a.gkb = (const float*)p[k++];
  const T** weights[] = {&a.w1u, &a.b1u, &a.w2u, &a.b2u, &a.w2t, &a.b2t,
                         &a.ffwf, &a.lns, &a.lnb, &a.wk, &a.bk};
  for (const T** w : weights) *w = (const T*)p[k++];
  a.pooled = (T*)p[k++];
  a.has = (T*)p[k++];
  a.exf = (T*)p[k++];
  a.loc_a = (float*)p[k++];
  a.loc_b = (float*)p[k++];
  a.ws = (float*)ws;
  a.B = B;
  a.Nv = Nv;
  a.Nf = Nf;
  a.Na = Na;
  a.F = F;
  a.H = H;
  return a;
}

}  // namespace

// ptrs, in order: scal [12, B] int32; rv [B, Nv, H], rf [B, Nf, F, H]
// (updated in place), ra [B, Na, F], related [B, F], vmask [B, F] in the
// compute type; gkb [B] float32; w1u [11, H, H], b1u [11, H], w2u, b2u,
// w2t [4, H, H], b2t [4, H], ffwf [H], ln scale [H], ln bias [H], localize.k
// w [H, H] and b [H] in the compute type; outputs pooled [B, H] (sorted
// order), hasitem [B, F], existsframe [B, F] in the compute type, loc_a and
// loc_b [B, F] float32. ws: a float32 [B, 2, F, H] workspace. H <= MAX_H,
// F <= MAX_F (mega_limits.cuh). Returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue).
extern "C" int stair_executor_step(const void* const* ptrs, int nptrs,
                                   void* ws, int B, int Nv, int Nf, int Na,
                                   int F, int H, int bf16, void* stream) {
  if (nptrs != NPTRS || B <= 0 || H <= 0 || F <= 0 || H > MAX_H ||
      F > MAX_F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    step_kernel<__nv_bfloat16><<<B, THREADS, 0, st>>>(
        args_of<__nv_bfloat16>(ptrs, ws, B, Nv, Nf, Na, F, H));
  } else {
    step_kernel<float><<<B, THREADS, 0, st>>>(
        args_of<float>(ptrs, ws, B, Nv, Nf, Na, F, H));
  }
  return (int)cudaGetLastError();
}

// The tensor-core route's mode and cluster for B tiles at (F, H): the
// row-slice mode where the shared tiles cannot hold F (above TC_MAX_F, or
// not a multiple of 16) or a cluster of 2 or more is forced; there `cluster`
// where forced (> 0), else tc_cluster over the mode's CTA slots (one CTA an
// SM). *C gets the size (1 outside the row-slice mode). Sets the kernel's
// dynamic shared memory limit.
static cudaError_t step_tc_pick(int B, int F, int H, int cluster,
                                bool* sliced, int* C) {
  *sliced = cluster > 1 || F % 16 != 0 || F > TC_MAX_F;
  *C = *sliced ? cluster : 1;
  const size_t smem = step_tc_smem_bytes(F, H, *sliced);
  cudaError_t e =
      *sliced ? cudaFuncSetAttribute(
                    executor_step_tc_kernel<true>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
              : cudaFuncSetAttribute(
                    executor_step_tc_kernel<false>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || *C > 0) return e;
  int slots = 0;
  e = stair::mega::cta_slots(executor_step_tc_kernel<true>, smem, &slots);
  *C = tc_cluster(B, F, slots);
  return e;
}

// The tensor-core route (executor_step_tc_kernel): bf16 at H a multiple of
// 64 in [64, TC_MAX_H] and any F in [TC_MIN_F, TC_ROUTE_MAX_F]
// (mega_limits.cuh); ops/executor_step.py step_route picks it. Arguments
// as stair_executor_step's, all in bf16 but gkb, loc_a and loc_b; rf and
// the w1u, w2u, w2t and localize.k tables 16-byte aligned; ws: a float32
// workspace of [B, F, H] (the Temporal pre-LayerNorm rows) or, in the
// row-slice mode, [B, 2, F, H] (feat32, then those rows). cluster: the CTAs
// of a tile's cluster, 0 for the launch's pick (step_tc_pick), at most 8;
// *used gets the size launched. A cluster that cannot launch returns its
// error: nothing falls back.
extern "C" int stair_executor_step_tc(const void* const* ptrs, int nptrs,
                                      void* ws, int B, int Nv, int Nf,
                                      int Na, int F, int H, int cluster,
                                      int* used, void* stream) {
  if (nptrs != NPTRS || B <= 0 || H % 64 != 0 || H < 64 || H > TC_MAX_H ||
      F < TC_MIN_F || F > TC_ROUTE_MAX_F || cluster < 0 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  bool sliced = false;
  int C = 1;
  cudaError_t e = step_tc_pick(B, F, H, cluster, &sliced, &C);
  *used = C;
  if (e != cudaSuccess) return (int)e;
  const Args<bf16> a = args_of<bf16>(ptrs, ws, B, Nv, Nf, Na, F, H);
  const size_t smem = step_tc_smem_bytes(F, H, sliced);
  cudaStream_t st = (cudaStream_t)stream;
  if (sliced) {
    e = stair::mega::launch_clusters(executor_step_tc_kernel<true>, B, C,
                                     smem, st, a, C);
    if (e != cudaSuccess) return (int)e;
  } else {
    executor_step_tc_kernel<false><<<B, THREADS, smem, st>>>(a, 1);
  }
  return (int)cudaGetLastError();
}

// Dynamic shared memory of executor_step_tc_kernel at (F, H), in bytes:
// one CTA a tile (sliced 0) or the row-slice mode (sliced 1).
extern "C" long stair_executor_step_tc_smem(int F, int H, int sliced) {
  return (long)step_tc_smem_bytes(F, H, sliced != 0);
}

// The CTAs of a tile's cluster that a tensor-core launch of B tiles at (F,
// H) takes on the current card (1 where the shared tiles hold F), or -1 on
// an error.
extern "C" int stair_executor_step_tc_cluster(int B, int F, int H) {
  bool sliced = false;
  int C = 1;
  if (step_tc_pick(B, F, H, 0, &sliced, &C) != cudaSuccess) return -1;
  return C;
}

// CTA slots of the current card for executor_step_fma32_kernel at `smem`
// bytes of dynamic shared memory (set as the kernel's maximum first): its
// SMs x the CTAs an SM holds.
static cudaError_t step32_slots(size_t smem, int* slots) {
  return stair::mega::cta_slots(executor_step_fma32_kernel, smem, slots);
}

// The float32 route (executor_step_fma32_kernel): float32 at H a multiple
// of G32_BN in [G32_BN, FMA32_MAX_H] and any F in [FMA32_MIN_F,
// FMA32_MAX_F] (mega_limits.cuh); ops/executor_step.py step_route picks
// it. Arguments as stair_executor_step's, all float32; rf and the w1u,
// w2u, w2t and localize.k tables 16-byte aligned; ws: a float32 [B, 2, F,
// H] workspace. cluster: the CTAs of a tile's cluster, a divisor of H /
// G32_BN up to 8, or 0 for the launch's pick (step32_cluster); *used gets
// the size launched.
extern "C" int stair_executor_step_fma32(const void* const* ptrs, int nptrs,
                                         void* ws, int B, int Nv, int Nf,
                                         int Na, int F, int H, int cluster,
                                         int* used, void* stream) {
  if (nptrs != NPTRS || B <= 0 || H % G32_BN != 0 || H < G32_BN ||
      H > FMA32_MAX_H || F < FMA32_MIN_F || F > FMA32_MAX_F ||
      cluster < 0 || cluster > 8 || (cluster > 0 && (H / G32_BN) % cluster))
    return (int)cudaErrorInvalidValue;
  const size_t smem = step32_smem_bytes(F, H);
  cudaError_t e = cudaFuncSetAttribute(
      executor_step_fma32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int slots = 0;
  if (e == cudaSuccess) e = step32_slots(smem, &slots);
  if (e != cudaSuccess) return (int)e;
  const int C = cluster > 0 ? cluster : step32_cluster(B, H, slots);
  *used = C;
  e = stair::mega::launch_clusters(
      executor_step_fma32_kernel, B, C, smem, (cudaStream_t)stream,
      args_of<float>(ptrs, ws, B, Nv, Nf, Na, F, H), C);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Dynamic shared memory of executor_step_fma32_kernel at (F, H), in bytes.
extern "C" long stair_executor_step_fma32_smem(int F, int H) {
  return (long)step32_smem_bytes(F, H);
}

// The CTAs of one tile's cluster that a launch of B tiles at (F, H) takes
// on the current card, or -1 on an error.
extern "C" int stair_executor_step_fma32_cluster(int B, int F, int H) {
  const size_t smem = step32_smem_bytes(F, H);
  int slots = 0;
  if (cudaFuncSetAttribute(executor_step_fma32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      step32_slots(smem, &slots) != cudaSuccess)
    return -1;
  return step32_cluster(B, H, slots);
}
