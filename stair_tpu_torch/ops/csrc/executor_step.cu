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
// Two routes, which ops/executor_step.py step_route picks before the
// launch: step_kernel (the general route: float32, and bf16 at widths the
// other refuses) and executor_step_tc_kernel further down (bf16 at the
// widths mega_exec.py tc_shape takes, on the tensor cores).
//
// Design of both. One thread block per tile; tile i works on example
// perm[i] of the expert-sorted order the caller computed (S_PERM), so
// neighbouring blocks read the same [H, H] expert weights from L2. The
// block reads its own column of the [12, B] schedule from global memory
// and indexes the register files directly (the TPU kernel's scalar
// prefetch, block index maps and one-hot row selects are gone), and it
// writes its frames result straight into rf: SSA guarantees that slot (b,
// out_frames) is none of the tile's operands, and each example is exactly
// one tile, so the in-place write races with nothing. A tile with no
// frames result writes nothing. Both round to the compute dtype where the
// TPU kernel casts, so that the plain version (ops/executor_step.py
// fused_step_reference) shares every rounding site. Rows the executor
// never reads (pooled / hasitem of a null stage 1, loc_a / loc_b of a tile
// that is not Localize / Superlative) are written as 0.
//
// step_kernel: the [F, H] intermediates (stage-1 hidden / stage-2 operand,
// and the float32 feat tile, later the pre-LayerNorm rows) sit in a
// per-tile float32 workspace that the wrapper allocates; operand vectors
// and per-frame rows sit in shared memory. Products are the shared-memory
// tiled float32-FMA loops of mega_common.cuh. What bounds it on an H100:
// operations, on the float32 CUDA cores (a live tile does two to three
// [F, H] @ [H, H] products, about 0.1 GFLOP at F = 64, H = 512).

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
// The tensor-core route: executor_step_tc_kernel (bf16 at the widths
// mega_exec.py tc_shape takes: H a multiple of 64 up to TC_MAX_H, F a
// multiple of 16 up to TC_MAX_F).
//
// mega_exec_tc_kernel's per-step design (#4, mega_exec.cu) applied to one
// step of every example. Every [F, H] @ [H, H] product (the stage-1 expert
// MLP, the FilterFrame and Temporal projections) runs on mma.sync through
// fwd_gemm (mega_common.cuh): its A operand is a bf16 tile in shared memory
// and already exact in bf16 at the TPU kernel's cast sites (the frames
// operand is bf16, the hidden and the gated / related operand rows are
// rounded values), so against the plain version only the order of the
// float32 sums changes; W streams from L2 through fwd_gemm's cp.async ring.
// The frames operand x comes into the first of two [F, H + TC_PAD] bf16
// tiles by cp.async; the hidden goes into the second, and rd(feat32)
// replaces x in the first (the ExistsFrame cosine has read x by then).
// The float32 sites of the TPU kernel stay float32: pooled is the sum over
// frames of the unrounded feat32 * vm^2 and hasitem takes the unrounded
// column 0, both from the second product's epilogue. Each output (m, n) of
// that product is one thread's (fwd_gemm's fragments: two warps down the
// rows, eight row lanes a warp, four rows a thread and column), so the
// epilogue adds it into pooled row group (m / 32) * 8 + m % 8 of column n
// in shared memory, which that thread alone owns, and the POOL_ROWS groups
// are summed in a fixed order after the product: no atomics, the same bits
// from run to run. The Localize keywords go through vecmat_tc, the cosines
// read the bf16 feat tile. A FilterFrame result is staged in the first tile
// and stored as 16-byte rows; only the Temporal pre-LayerNorm rows (float32)
// go to a [B, F, H] workspace.
//
// Shared memory at F = 64, H = 512: the two tiles 133 KB, the W ring 54 KB,
// the pooled groups 32 KB (vecmat_tc's partials share them), three [H]
// float vectors: 228 KB, one block of 8 warps an SM.
//
// What bounds it on an H100: per live tile two or three [64 x 512] @ [512
// x 512] products whose 512 KB weight tables each block reads from L2 (64
// operations a byte, so L2 bandwidth and the mma.sync rate are of one
// size). Two examples of one expert in one block do not fit (2 x 133 KB of
// tiles); a 2-CTA cluster sharing the weight ring, and wgmma, are the next
// step.

using bf16 = __nv_bfloat16;
using stair::cp_async16;
using stair::cp_async_commit;
using stair::cp_async_wait;
using stair::TC_MAX_F;
using stair::TC_MAX_H;
using stair::mega::FWD_BN;
using stair::mega::fwd_gemm;
using stair::mega::tc_ring;
using stair::mega::TC_PAD;
using stair::mega::TC_PARTS;
using stair::mega::vecmat_tc;

// Row groups of the pooled partials (see above).
constexpr int POOL_ROWS = 16;

// Dynamic shared memory of executor_step_tc_kernel in bytes
// (ops/executor_step.py step_tc_smem_bytes mirrors it).
__host__ __device__ inline size_t step_tc_smem_bytes(int F, int H) {
  return 2 * (size_t)F * (H + TC_PAD) * sizeof(bf16) +
         (size_t)tc_ring<FWD_BN>() * sizeof(bf16) +
         (3 * (size_t)H +
          (POOL_ROWS * H > TC_PARTS ? POOL_ROWS * H : TC_PARTS) +
          3 * (size_t)F + NWARPS) * sizeof(float);
}

// Localize cosine row of keyword v [H] (shared) through localize.k against
// the bf16 feat tile (row stride ld): kw = rd(rd(v wk) + bk) by vecmat_tc,
// out[f] = (rd(cos) + 1) * 0.49 * vm[f]. Warp per frame row.
__device__ void loc_cos_tc(const float* v, const Args<bf16>& a,
                           const bf16* feat, int ld, float* kw, float* part,
                           const float* vm, float* red, float* out) {
  const int F = a.F, H = a.H;
  vecmat_tc(v, nullptr, nullptr, a.wk, H, H, part, [&](int n, float y) {
    kw[n] = rd<bf16>(rd<bf16>(y) + to_f(a.bk[n]));
  });
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += kw[k] * kw[k];
  const float nk = sqrtf(fmaxf(block_sum(nk2, red), 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = w; f < F; f += NWARPS) {
    const bf16* row = feat + (size_t)f * ld;
    float d = 0.f, n2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float x = to_f(row[k]);
      d += x * kw[k];
      n2 += x * x;
    }
    d = warp_sum(d);
    n2 = warp_sum(n2);
    if (lane == 0) {
      const float nf = sqrtf(fmaxf(n2, 1e-30f));
      const float c = rd<bf16>(d / fmaxf(nf * nk, COS_EPS));
      out[f] = (c + 1.0f) * 0.49f * vm[f];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    executor_step_tc_kernel(const Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char step_smem[];
  __shared__ int ins[NS];
  using T = bf16;
  const int i = blockIdx.x;
  const int B = a.B, F = a.F, H = a.H, LDT = H + TC_PAD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t FH = (size_t)F * H;

  bf16* x = reinterpret_cast<bf16*>(step_smem);   // x, then feat
  bf16* h = x + (size_t)F * LDT;   // hidden, then the stage-2 operand
  bf16* ring = h + (size_t)F * LDT;
  float* va = reinterpret_cast<float*>(ring + tc_ring<FWD_BN>());
  float* vb = va + H;
  float* kw = vb + H;
  float* part = kw + H;   // pooled groups [POOL_ROWS][H], vecmat_tc's parts
  float* vm = part + (POOL_ROWS * H > TC_PARTS ? POOL_ROWS * H : TC_PARTS);
  float* f1 = vm + F;
  float* f2 = f1 + F;
  float* red = f2 + F;

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

  // ---- the frames operand into x (cp.async), the vectors meanwhile -----
  const int per = H / 8;
  for (int p = tid; p < F * per; p += THREADS)
    cp_async16(x + (size_t)(p / per) * LDT + (p % per) * 8,
               xg + (size_t)(p / per) * H + (p % per) * 8, true);
  cp_async_commit();
  for (int f = tid; f < F; f += THREADS)
    vm[f] = to_f(a.vmask[(size_t)b * F + f]);
  for (int j = tid; j < H; j += THREADS) {
    va[j] = to_f(a.rv[((size_t)b * a.Nv + iva) * H + j]);
    vb[j] = to_f(a.rv[((size_t)b * a.Nv + ivb) * H + j]);
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- existsframe cosine of x against va (before feat replaces x) -----
  {
    float n2 = 0.f;
    for (int k = tid; k < H; k += THREADS) n2 += va[k] * va[k];
    const float nva = sqrtf(fmaxf(block_sum(n2, red), 1e-30f));
    for (int f = warp; f < F; f += NWARPS) {
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
        a.exf[(size_t)b * F + f] = from_f<T>((c + 1.0f) * 0.49f * vm[f]);
      }
    }
  }

  // ---- stage 1: expert two-layer MLP; pooled and hasitem --------------
  if (stage1) {
    const T* b1 = a.b1u + (size_t)e1 * H;
    const T* b2 = a.b2u + (size_t)e1 * H;
    for (int j = tid; j < POOL_ROWS * H; j += THREADS) part[j] = 0.f;
    fwd_gemm(x, a.w1u + (size_t)e1 * H * H, F, H, H, ring,
             [&](int m, int n, float acc) {
      h[(size_t)m * LDT + n] = from_f<T>(fmaxf(acc + to_f(b1[n]), 0.f));
    });
    fwd_gemm(h, a.w2u + (size_t)e1 * H * H, F, H, H, ring,
             [&](int m, int n, float acc) {
      const float v = acc + to_f(b2[n]);
      if (n == 0) f1[m] = v;                       // h2[:, 0], unrounded
      const float fe = filt ? fmaxf(v, 0.f) : v;   // feat32
      x[(size_t)m * LDT + n] = from_f<T>(fe);
      part[((m >> 5) * 8 + (m & 7)) * H + n] += fe * (vm[m] * vm[m]);
    });
    for (int n = tid; n < H; n += THREADS) {
      float p = 0.f;
#pragma unroll
      for (int g = 0; g < POOL_ROWS; ++g) p += part[g * H + n];
      a.pooled[(size_t)i * H + n] = from_f<T>(p);
    }
    for (int f = tid; f < F; f += THREADS)
      a.has[(size_t)b * F + f] = from_f<T>(sigmoid_f(f1[f]) * vm[f]);
  } else {
    for (int k = tid; k < H; k += THREADS)
      a.pooled[(size_t)i * H + k] = from_f<T>(0.f);
    for (int f = tid; f < F; f += THREADS)
      a.has[(size_t)b * F + f] = from_f<T>(0.f);
  }
  __syncthreads();

  // ---- localize scores against both keyword operands ------------------
  if (e1 == E1_LOCALIZE) {
    loc_cos_tc(va, a, x, LDT, kw, part, vm, red, f1);
    loc_cos_tc(vb, a, x, LDT, kw, part, vm, red, f2);
    for (int f = tid; f < F; f += THREADS) {
      a.loc_a[(size_t)b * F + f] = f1[f];
      a.loc_b[(size_t)b * F + f] = f2[f];
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
          d += to_f(x[(size_t)f * LDT + k]) * to_f(a.ffwf[k]);
      d = warp_sum(d);
      if (lane == 0) f1[f] = ffv ? sigmoid_f(d + gk) : 1.0f;
    }
    __syncthreads();
    for (int j = tid; j < F * H; j += THREADS) {
      const size_t o = (size_t)(j / H) * LDT + j % H;
      h[o] = from_f<T>(f1[j / H] * to_f(x[o]));
    }
    __syncthreads();
    // the result into x (feat is spent), then out as 16-byte rows
    fwd_gemm(h, a.w2t, F, H, H, ring, [&](int m, int n, float acc) {
      x[(size_t)m * LDT + n] =
          from_f<T>(fmaxf(acc + to_f(a.b2t[n]), 0.f) * vm[m]);
    });
    for (int p = tid; p < F * per; p += THREADS)
      *reinterpret_cast<uint4*>(fout + (size_t)(p / per) * H +
                                (p % per) * 8) =
          *reinterpret_cast<const uint4*>(x + (size_t)(p / per) * LDT +
                                          (p % per) * 8);
  } else if (e2 == E2_TEMPORAL) {
    for (int f = tid; f < F; f += THREADS)
      f1[f] = to_f(a.related[(size_t)b * F + f]);
    __syncthreads();
    for (int j = tid; j < F * H; j += THREADS)
      h[(size_t)(j / H) * LDT + j % H] = from_f<T>(f1[j / H] * to_f(xg[j]));
    __syncthreads();
    float* y = a.ws + (size_t)i * FH;   // the pre-LayerNorm rows
    const T* b21 = a.b2t + H;
    fwd_gemm(h, a.w2t + (size_t)H * H, F, H, H, ring,
             [&](int m, int n, float acc) {
      y[(size_t)m * H + n] = fmaxf(acc + to_f(b21[n]), 0.f);
    });
    for (int f = warp; f < F; f += NWARPS) {
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
    for (int f = tid; f < F; f += THREADS)
      f1[f] = to_f(a.ra[((size_t)b * a.Na + iaa) * F + f]);
    __syncthreads();
    for (size_t j = tid; j < FH; j += THREADS)
      fout[j] = from_f<T>(f1[j / H] * to_f(xg[j]));
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

// The tensor-core route (executor_step_tc_kernel): bf16 at H a multiple of
// 64 in [64, TC_MAX_H] and F a multiple of 16 in [16, TC_MAX_F]
// (mega_limits.cuh); ops/executor_step.py step_route picks it. Arguments
// as stair_executor_step's, all in bf16 but gkb, loc_a and loc_b; rf and
// the w1u, w2u, w2t and localize.k tables 16-byte aligned; ws: a float32
// [B, F, H] workspace (the Temporal pre-LayerNorm rows).
extern "C" int stair_executor_step_tc(const void* const* ptrs, int nptrs,
                                      void* ws, int B, int Nv, int Nf,
                                      int Na, int F, int H, void* stream) {
  if (nptrs != NPTRS || B <= 0 || H % 64 != 0 || H < 64 || H > TC_MAX_H ||
      F % 16 != 0 || F < 16 || F > TC_MAX_F)
    return (int)cudaErrorInvalidValue;
  const size_t smem = step_tc_smem_bytes(F, H);
  cudaError_t e = cudaFuncSetAttribute(
      executor_step_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  executor_step_tc_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      args_of<__nv_bfloat16>(ptrs, ws, B, Nv, Nf, Na, F, H));
  return (int)cudaGetLastError();
}

// Dynamic shared memory of executor_step_tc_kernel at (F, H), in bytes.
extern "C" long stair_executor_step_tc_smem(int F, int H) {
  return (long)step_tc_smem_bytes(F, H);
}
