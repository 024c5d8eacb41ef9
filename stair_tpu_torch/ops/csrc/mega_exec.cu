// Executor megakernel, forward: eval, and training with dropout.
//
// Replaces the TPU kernel stair_tpu/ops/mega_exec.py _make_kernel, reached
// through forward_call: train=False (mega_exec) and, with a seed, the
// training forward (ops/mega_grad.py _train_fn / mega_exec_train), which
// multiplies the JAX kernel's eight dropout sites by the counter-hash mask
// hash_keep (common.cuh) keyed on (seed, example, step, site), so the
// backward kernels (mega_grad.cu, mega_grad_tc.cu) recompute the masks
// instead of storing them. Inputs are the tensors of ops/mega_exec.py
// prepare_args, in ARG_NAMES order.
//
// Design. One thread block per example runs that example's whole
// instruction trace: it loads its own [T, 17] int32 instruction row step by
// step (Hopper has no scalar prefetch) and dispatches on the opcode, which
// is uniform across the block, so every branch and barrier is block-wide.
// The three register files (vec [Nv, H], frames [Nf, F, H], attn [Na, F])
// live in the output tensors in global memory and are updated in place:
// the frames file is [4, 64, 512] bf16 = 256 KB per example at the bench
// shape, above one block's 227 KB of shared memory. Operand vectors,
// per-frame rows and the GEMM tiles sit in shared memory; the [F, H]
// intermediates (stage-1 hidden, the feat tile that later steps read, the
// temporal pre-LayerNorm rows) sit in a per-example float32 workspace that
// the wrapper allocates. The weight tables (~12 MB in bf16 at H = 512)
// stream from L2.
//
// In mega_exec_kernel every [F, H] @ [H, H] product (expert MLPs, stage-2
// projections, localize keywords) is a shared-memory tiled loop on the
// CUDA cores with float32 accumulation: 64 x 64 output tiles, 16-deep k
// slices, 4 x 4 outputs per thread. Vec-level [1, H] @ [H, H] products
// give each thread whole output columns. Values are rounded to the compute
// dtype exactly where the JAX kernel casts (lin_dt and friends), so bf16
// results track the TPU kernel's rounding sites.
//
// Three routes (ops/mega_exec.py fwd_route picks one before the launch):
// mega_exec_kernel<T, false> below, the general route (every dtype and
// width the others refuse, eval and training; mega_grad.cu's walk
// recomputes its training values bit for bit); mega_exec_kernel<float,
// true>, the float32 "fma32" route (H a multiple of 128 up to 512, any F
// from 16 to 256), the same kernel with every product on gemm32
// (mega_common.cuh: 64 x 128 output tiles over the frames' row tiles,
// 32-deep k slices through a 3-stage cp.async ring in dynamic shared
// memory, 4 x 8 sums a thread in registers) and so the same bits in every
// file, an example on a thread-block cluster that splits each product by
// output columns while one CTA an example would leave the card under-filled
// (mega_common.cuh mega32_cluster; the same bits again); and
// mega_exec_tc_kernel further down, the tensor-core route for
// bf16, eval (#4) and training (#5; mega_grad_tc.cu's walk recomputes its
// values bit for bit).
//
// What bounds mega_exec_kernel on an H100: B = 1024 blocks of about three
// heavy [64 x 512] @ [512 x 512] products per step on the float32 CUDA
// cores, with the weight tiles re-read from L2 by every block. gemm's
// operand tiles are loaded synchronously, two barriers a 16-deep slice and
// eight shared loads for sixteen FMAs; gemm32 keeps two slices in flight
// and reads float4 operands, a third of gemm's loads an FMA.

#include "mega_common.cuh"

namespace {

using stair::from_f;
using stair::rd;
using stair::sigmoid_f;
using stair::to_f;
using stair::warp_max;
using stair::warp_sum;
using stair::MAX_F;
using stair::MAX_H;
using stair::MAX_L;
using namespace stair::mega;

template <typename T>
struct Args : Tensors<T> {
  T *rv, *rf, *ra;
  float* ws;
  int B, T_, Nv, Nf, Na, F, H, L, fsoft;
  int C;   // CTAs of an example's cluster (the "fma32" route; else 1)
  stair::Dropout dr;
};

// Static shared memory of mega_exec_kernel. G32 (the "fma32" route) keeps
// gemm32's ring in dynamic shared memory instead of gemm's tiles.
template <bool G32>
struct SmemT {
  float va[MAX_H], vb[MAX_H], vc[MAX_H], nv[MAX_H], x1[MAX_H], x2[MAX_H];
  float vm[MAX_F], aa[MAX_F], ab[MAX_F], f1[MAX_F], f2[MAX_F], f3[MAX_F];
  float As[G32 ? 1 : BK][BM + 1];
  float Ws[G32 ? 1 : BK][BN];
  float red[NWARPS];
  int ins[NSF];
};

// C[M, N] = A[M, K] (row stride lda) @ W[K, N]; epi(m, n, acc) per output:
// gemm on gemm's tiles in sm, or (G32) gemm32 on its ring, this CTA's
// columns of it on an example's cluster of C CTAs (gemm32_part). Called by
// the whole block (G32: by every CTA of the cluster); returns after a
// barrier.
template <bool G32, typename TA, typename TW, typename S, typename Epi>
__device__ void gemm(const TA* A, int lda, const TW* W, int M, int K, int N,
                     S& sm, float* ring, int C, Epi epi) {
  if constexpr (G32)
    gemm32_part<false>(A, lda, W, N, M, K, N, C, ring, epi);
  else
    stair::mega::gemm<float, false, false>(A, lda, 1, W, N, 1, M, K, N,
                                           &sm.As[0][0], &sm.Ws[0][0], epi);
}

// Masked softmax over F entries held one per thread (f = threadIdx.x);
// an all-masked row gives 0. Returns this thread's weight.
template <typename S>
__device__ float block_masked_softmax(float x, bool valid, S& sm) {
  return stair::mega::block_masked_softmax(x, valid, sm.red);
}

// Localize/superlative cosine row of keyword kw [H] (shared) against the
// feat tile [F, H]: out[f] = (rd(cos) + 1) * 0.49 * vm[f]. Warp per row.
template <typename T, typename S>
__device__ void loc_cos(const float* kw, const float* feat, int F, int H,
                        float* out, S& sm) {
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += kw[k] * kw[k];
  const float nk = sqrtf(fmaxf(block_sum(nk2, sm.red), 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = w; f < F; f += NWARPS) {
    const float* row = feat + (size_t)f * H;
    float d = 0.f, n2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float v = row[k];
      d += v * kw[k];
      n2 += v * v;
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

// Superlative head over K candidate rows with scores row[k] (already
// summed over frames) and mask; pooled = sum_k w_k * action_k; writes
// relu(lin_dt(pooled, supw, supb)) to sm.nv. act(k, j) reads action rows.
template <typename T, typename S, typename Act>
__device__ void superlative(float* row, int K, int mode, int count_or_neg,
                            const T* supw, const T* supb, int H, S& sm,
                            Act act, float* pooled) {
  // Weights over K <= MAX_F rows, one per thread. count_or_neg >= 0: the
  // first count rows are valid (SUPERLATIVE_V); < 0: rows with vm > 0.
  const int k = threadIdx.x;
  bool valid = false;
  float x = 0.f;
  if (k < K) {
    valid = count_or_neg >= 0 ? (k < count_or_neg) : (sm.vm[k] > 0.f);
    x = row[k];
  }
  float w = block_masked_softmax(x, valid, sm);
  if (mode == 1) w = 1.0f - w;
  if (!valid) w = 0.f;
  __syncthreads();
  if (k < K) row[k] = w;
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += THREADS) {
    float p = 0.f;
    for (int kk = 0; kk < K; ++kk) p += row[kk] * act(kk, j);
    pooled[j] = rd<T>(p);
  }
  __syncthreads();
  vecmat<T>(pooled, nullptr, nullptr, supw, H, H, [&](int n, float y) {
    sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(supb[n])), 0.f);
  });
  __syncthreads();
}

template <typename T, bool G32>
__global__ void __launch_bounds__(THREADS) mega_exec_kernel(const Args<T> a) {
  __shared__ SmemT<G32> sm;
  extern __shared__ __align__(16) float g32_ring[];   // G32: gemm32's ring
  // G32: example b on a cluster of C = a.C CTAs (1: one CTA an example).
  // Its CTA 0, the lead, runs every pass and writes every file; the others
  // only compute their columns of each product (gemm).
  const int C = G32 ? a.C : 1;
  const int b = (int)(blockIdx.x / C);
  auto lead = [&] { return blockIdx.x % C == 0; };
  const int F = a.F, H = a.H, L = a.L, Hh = H / 2;
  const int Nv = a.Nv, Nf = a.Nf, Na = a.Na;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const stair::Dropout dr = a.dr;

  T* rv = a.rv + (size_t)b * Nv * H;
  T* rf = a.rf + (size_t)b * Nf * F * H;
  T* ra = a.ra + (size_t)b * Na * F;
  float* ws_h = a.ws + ((size_t)b * 3 + 0) * F * H;     // hidden / operand
  float* feat = a.ws + ((size_t)b * 3 + 1) * F * H;     // stage-1 output
  float* ws_y = a.ws + ((size_t)b * 3 + 2) * F * H;     // pre-LN rows
  const size_t FH = (size_t)F * H;

  // ---- register-file init: frames register 0 <- video * vmask ----------
  for (int f = tid; f < F; f += THREADS) sm.vm[f] = to_f(a.vm[(size_t)b * F + f]);
  __syncthreads();
  if (lead()) {
    for (int i = tid; i < Nv * H; i += THREADS) rv[i] = from_f<T>(0.f);
    for (int i = tid; i < Na * F; i += THREADS) ra[i] = from_f<T>(0.f);
    for (size_t i = tid; i < FH; i += THREADS) {
      const int f = (int)(i / H), j = (int)(i % H);
      const T v = j < Hh ? a.vf_a[((size_t)b * F + f) * Hh + j]
                         : a.vf_b[((size_t)b * F + f) * Hh + j - Hh];
      rf[i] = from_f<T>(to_f(v) * sm.vm[f]);
    }
    for (size_t i = FH + tid; i < (size_t)Nf * FH; i += THREADS)
      rf[i] = from_f<T>(0.f);
    __syncthreads();
  }

  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };

  for (int t = 0; t < a.T_; ++t) {
    if (tid < NSF) sm.ins[tid] = a.scal[((size_t)b * a.T_ + t) * NSF + tid];
    __syncthreads();
    const int op = sm.ins[F_OP], e1 = sm.ins[F_E1];
    const int mode = sm.ins[F_MODE], count = sm.ins[F_COUNT];
    const int iva = clampi(sm.ins[F_VA], Nv), ivb = clampi(sm.ins[F_VB], Nv);
    const int ivc = clampi(sm.ins[F_VC], Nv);
    const int ifa = clampi(sm.ins[F_FA], Nf), ifb = clampi(sm.ins[F_FB], Nf);
    const int iaa = clampi(sm.ins[F_AA], Na), iab = clampi(sm.ins[F_AB], Na);
    const int out_v = clampi(sm.ins[F_OUT_V], Nv);
    const int out_f = clampi(sm.ins[F_OUT_F], Nf);
    const int out_a = clampi(sm.ins[F_OUT_A], Na);
    const int out_ab = clampi(sm.ins[F_OUT_AB], Na);
    const bool is_filter = op >= OP_FV && op <= OP_FFK;
    const T* fa = rf + (size_t)ifa * FH;

    // ---- operand reads, then the zero writes of out_attn/out_attn_b ----
    if (lead()) {
      for (int j = tid; j < H; j += THREADS) {
        sm.va[j] = to_f(rv[(size_t)iva * H + j]);
        sm.vb[j] = to_f(rv[(size_t)ivb * H + j]);
        sm.nv[j] = 0.f;
      }
      for (int f = tid; f < F; f += THREADS) {
        sm.aa[f] = to_f(ra[(size_t)iaa * F + f]);
        sm.ab[f] = to_f(ra[(size_t)iab * F + f]);
      }
      __syncthreads();
      for (int f = tid; f < F; f += THREADS) {
        ra[(size_t)out_a * F + f] = from_f<T>(0.f);
        ra[(size_t)out_ab * F + f] = from_f<T>(0.f);
      }
      __syncthreads();
    }

    // ---- stage 1: expert two-layer frames MLP (e1 == 9: null) ---------
    if (e1 != 9) {
      const T* w1 = a.w1u + (size_t)e1 * H * H;
      const T* b1 = a.b1u + (size_t)e1 * H;
      const T* w2 = a.w2u + (size_t)e1 * H * H;
      const T* b2 = a.b2u + (size_t)e1 * H;
      gemm<G32>(fa, H, w1, F, H, H, sm, g32_ring, C,
                [&](int m, int n, float acc) {
        ws_h[(size_t)m * H + n] =
            rd<T>(fmaxf(acc + to_f(b1[n]), 0.f) * dr.keep(m, n, b, t, 0));
      });
      gemm<G32>(ws_h, H, w2, F, H, H, sm, g32_ring, C,
                [&](int m, int n, float acc) {
        const float v = acc + to_f(b2[n]);
        feat[(size_t)m * H + n] =
            rd<T>(is_filter ? fmaxf(v, 0.f) * dr.keep(m, n, b, t, 1) : v);
      });
    }

    // ---- vec producers (write sm.nv; zeros for non-vec ops) -----------
    // (SUPF's keyword product on every CTA of the cluster, the rest on the
    // lead)
    if (op == OP_SUPF) {
      const T* fb = rf + (size_t)ifb * FH;
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      // kw_f = lin_dt(fb, w2t[2], b2t[2]) -> ws_h [F, H]
      gemm<G32>(fb, H, wk, F, H, H, sm, g32_ring, C,
                [&](int m, int n, float acc) {
        ws_h[(size_t)m * H + n] = rd<T>(rd<T>(acc) + to_f(bk[n]));
      });
      if (lead()) {
        // Row norms: f1 = |kw_f[i]|, f2 = |feat[f]|.
        for (int r = warp; r < F; r += NWARPS) {
          float n1 = 0.f, n2 = 0.f;
          for (int k = lane; k < H; k += 32) {
            const float x = ws_h[(size_t)r * H + k];
            const float y = feat[(size_t)r * H + k];
            n1 += x * x;
            n2 += y * y;
          }
          n1 = warp_sum(n1);
          n2 = warp_sum(n2);
          if (lane == 0) {
            sm.f1[r] = sqrtf(fmaxf(n1, 1e-30f));
            sm.f2[r] = sqrtf(fmaxf(n2, 1e-30f));
          }
        }
        __syncthreads();
        // row[i] = sum_f ((rd(cos(kw_i, feat_f)) + 1) * 0.49 * vm[f]) * vm[f]
        for (int i = warp; i < F; i += NWARPS) {
          const float* ki = ws_h + (size_t)i * H;
          float row = 0.f;
          for (int f = 0; f < F; ++f) {
            const float* ff = feat + (size_t)f * H;
            float d = 0.f;
            for (int k = lane; k < H; k += 32) d += ki[k] * ff[k];
            d = warp_sum(d);
            const float c = rd<T>(d / fmaxf(sm.f1[i] * sm.f2[f], COS_EPS));
            row += ((c + 1.0f) * 0.49f * sm.vm[f]) * sm.vm[f];
          }
          if (lane == 0) sm.f3[i] = row;
        }
        __syncthreads();
        superlative<T>(sm.f3, F, mode, -1, a.supw, a.supb, H, sm,
                       [&](int k, int j) {
                         return to_f(fb[(size_t)k * H + j]);
                       },
                       sm.x1);
      }
    }
    if (lead()) {
      if (op == OP_PUSH) {
        const int ss = sm.ins[F_SS], se = sm.ins[F_SE];
        float* span_w = sm.x1;  // [L]
        for (int p = tid; p < L; p += THREADS) {
          const bool valid = to_f(a.tm[(size_t)b * L + p]) > 0.f;
          const bool in_span = p >= ss && p < se;
          span_w[p] = (ss < 0 ? valid : (in_span && valid)) ? 1.f : 0.f;
        }
        __syncthreads();
        float den = 0.f;
        for (int p = 0; p < L; ++p) den += span_w[p];
        den = fmaxf(den, 1.0f);
        for (int j = tid; j < H; j += THREADS) {
          float v;
          if (ss == -2) {
            v = to_f(a.aux[((size_t)b * a.T_ + t) * H + j]);
          } else {
            const T* tok = j < Hh ? a.tok_a : a.tok_b;
            const int jj = j < Hh ? j : j - Hh;
            float acc = 0.f;
            for (int p = 0; p < L; ++p)
              acc += span_w[p] * to_f(tok[((size_t)b * L + p) * Hh + jj]);
            v = acc / den;
          }
          sm.nv[j] = rd<T>(v);
        }
        __syncthreads();
      } else if (op == OP_ANDV) {
        for (int j = tid; j < H; j += THREADS)
          sm.nv[j] = rd<T>(fminf(sm.va[j], sm.vb[j]));
        __syncthreads();
      } else if (op == OP_CHOOSE) {
        float dac = 0.f, dbc = 0.f, na = 0.f, nb = 0.f, nc = 0.f;
        for (int j = tid; j < H; j += THREADS) {
          const float c = to_f(rv[(size_t)ivc * H + j]);
          dac += sm.va[j] * c;
          dbc += sm.vb[j] * c;
          na += sm.va[j] * sm.va[j];
          nb += sm.vb[j] * sm.vb[j];
          nc += c * c;
        }
        dac = block_sum(dac, sm.red);
        dbc = block_sum(dbc, sm.red);
        na = sqrtf(fmaxf(block_sum(na, sm.red), 1e-30f));
        nb = sqrtf(fmaxf(block_sum(nb, sm.red), 1e-30f));
        nc = sqrtf(fmaxf(block_sum(nc, sm.red), 1e-30f));
        const bool first =
            dac / fmaxf(na * nc, COS_EPS) > dbc / fmaxf(nb * nc, COS_EPS);
        for (int j = tid; j < H; j += THREADS)
          sm.nv[j] = first ? sm.va[j] : sm.vb[j];
        __syncthreads();
      } else if (op == OP_CMP || op == OP_EQ) {
        const T* w = op == OP_CMP ? a.cw : a.eqw;
        const T* bb = op == OP_CMP ? a.cb : a.eqb;
        vecmat<T>(sm.va, sm.vb, nullptr, w, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(bb[n])), 0.f);
        });
        __syncthreads();
      } else if (op == OP_XOR) {
        for (int j = tid; j < H; j += THREADS)
          sm.x1[j] = rd<T>(fabsf(sm.va[j] - sm.vb[j]));
        __syncthreads();
        vecmat<T>(sm.x1, sm.va, sm.vb, a.xw, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.xb[n])), 0.f);
        });
        __syncthreads();
      } else if (op == OP_QUERY) {
        vecmat<T>(sm.va, nullptr, nullptr, a.qw, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.qb[n])), 0.f) *
                     dr.keep(0, n, b, t, 4);
        });
        __syncthreads();
      } else if (op == OP_TOA) {
        vecmat<T>(sm.va, sm.vb, nullptr, a.taw1, H, H, [&](int n, float y) {
          sm.x1[n] = rd<T>(fmaxf(rd<T>(rd<T>(y) + to_f(a.tab1[n])), 0.f) *
                           dr.keep(0, n, b, t, 5));
        });
        __syncthreads();
        vecmat<T>(sm.x1, nullptr, nullptr, a.taw2, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.tab2[n])), 0.f);
        });
        __syncthreads();
      } else if (op == OP_EX) {
        // exists: kw = va, feat = vb, x = [feat, kw, feat * kw]
        for (int j = tid; j < H; j += THREADS)
          sm.x1[j] = rd<T>(sm.vb[j] * sm.va[j]);
        __syncthreads();
        vecmat<T>(sm.vb, sm.va, sm.x1, a.exw1, H, H, [&](int n, float y) {
          sm.x2[n] = rd<T>(fmaxf(rd<T>(rd<T>(y) + to_f(a.exb1[n])), 0.f) *
                           dr.keep(0, n, b, t, 6));
        });
        __syncthreads();
        vecmat<T>(sm.x2, nullptr, nullptr, a.exw2, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.exb2[n])), 0.f) *
                     dr.keep(0, n, b, t, 7);
        });
        __syncthreads();
      } else if (op == OP_FV || op == OP_FK) {
        // Frame weights w * vm into f2: parity pooling (w = vm), or the
        // softmax mode's masked softmax for FILTER_V.
        if (a.fsoft) {
          for (int f = warp; f < F; f += NWARPS) {
            float d = 0.f;
            for (int k = lane; k < H; k += 32)
              d += feat[(size_t)f * H + k] * to_f(a.fltw[k]);
            d = warp_sum(d);
            if (lane == 0) sm.f1[f] = d;
          }
          float kb = 0.f;
          for (int k = tid; k < H; k += THREADS)
            kb += sm.va[k] * to_f(a.fltk[k]);
          kb = block_sum(kb, sm.red) + to_f(a.fltb[0]);
          const int f = tid;
          const bool valid = f < F && sm.vm[f] > 0.f;
          const float x = f < F ? sm.f1[f] + kb : 0.f;
          const float soft = block_masked_softmax(x, valid, sm);
          if (f < F) {
            const float w = op == OP_FV ? soft : sm.vm[f];
            sm.f2[f] = w * sm.vm[f];
          }
        } else {
          for (int f = tid; f < F; f += THREADS) sm.f2[f] = sm.vm[f] * sm.vm[f];
        }
        __syncthreads();
        for (int k = tid; k < H; k += THREADS) {
          float p = 0.f;
          for (int f = 0; f < F; ++f) p += feat[(size_t)f * H + k] * sm.f2[f];
          sm.x1[k] = rd<T>(p);
        }
        __syncthreads();
        vecmat<T>(sm.x1, nullptr, nullptr, a.fdw, H, H, [&](int n, float y) {
          sm.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.fdb[n])), 0.f);
        });
        __syncthreads();
      } else if (op == OP_SUPV) {
        const T* wk = a.w2t + 2 * (size_t)H * H;
        const T* bk = a.b2t + 2 * (size_t)H;
        vecmat<T>(sm.va, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          sm.x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        vecmat<T>(sm.vb, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          sm.x2[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        __syncthreads();
        loc_cos<T>(sm.x1, feat, F, H, sm.f1, sm);
        loc_cos<T>(sm.x2, feat, F, H, sm.f2, sm);
        // row[k] = sum_f scores[k, f] * vm[f], k in {0, 1}
        float r0 = 0.f, r1 = 0.f;
        for (int f = tid; f < F; f += THREADS) {
          r0 += sm.f1[f] * sm.vm[f];
          r1 += sm.f2[f] * sm.vm[f];
        }
        r0 = block_sum(r0, sm.red);
        r1 = block_sum(r1, sm.red);
        if (tid == 0) {
          sm.f3[0] = r0;
          sm.f3[1] = r1;
        }
        __syncthreads();
        const float* va = sm.va;
        const float* vb = sm.vb;
        superlative<T>(sm.f3, 2, mode, count < 0 ? 0 : count, a.supw, a.supb,
                       H, sm,
                       [&](int k, int j) { return k == 0 ? va[j] : vb[j]; },
                       sm.vc);
      }

      for (int j = tid; j < H; j += THREADS)
        rv[(size_t)out_v * H + j] = from_f<T>(sm.nv[j]);
    }

    // ---- frames producers --------------------------------------------
    T* fout = rf + (size_t)out_f * FH;
    if (op == OP_FFV || op == OP_FFK) {
      if (lead()) {
        float gk = 0.f;
        for (int k = tid; k < H; k += THREADS) gk += sm.va[k] * to_f(a.ffkw[k]);
        gk = block_sum(gk, sm.red) + to_f(a.ffab[0]);
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32)
            d += feat[(size_t)f * H + k] * to_f(a.ffwf[k]);
          d = warp_sum(d);
          if (lane == 0) sm.f1[f] = op == OP_FFV ? sigmoid_f(d + gk) : 1.0f;
        }
        __syncthreads();
        for (size_t i = tid; i < FH; i += THREADS)
          ws_h[i] = rd<T>(sm.f1[i / H] * feat[i]);
        __syncthreads();
      }
      const T* b20 = a.b2t;
      gemm<G32>(ws_h, H, a.w2t, F, H, H, sm, g32_ring, C,
                [&](int m, int n, float acc) {
        fout[(size_t)m * H + n] = from_f<T>(
            fmaxf(acc + to_f(b20[n]), 0.f) * dr.keep(m, n, b, t, 2) *
            sm.vm[m]);
      });
    } else if (op == OP_TEMP) {
      if (lead()) {
        const int midx = mode - 1 > 0 ? mode - 1 : 0;
        const size_t FF = (size_t)F * F;
        for (int f = tid; f < F; f += THREADS) {
          const float am = count == 2 ? (sm.aa[f] + sm.ab[f]) * 0.5f : sm.aa[f];
          sm.f1[f] = am;
          sm.f2[f] = rd<T>(am);
        }
        __syncthreads();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += sm.f2[i] * to_f(a.t1[midx * FF + (size_t)i * F + j]);
          sm.f3[j] = rd<T>(fmaxf(acc + to_f(a.tb1[midx * F + j]), 0.f));
        }
        __syncthreads();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += sm.f3[i] * to_f(a.t2[midx * FF + (size_t)i * F + j]);
          sm.f2[j] = rd<T>(fmaxf(acc + to_f(a.tb2[midx * F + j]), 0.f));
        }
        __syncthreads();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += sm.f2[i] * to_f(a.t3[midx * FF + (size_t)i * F + j]);
          const float g = sigmoid_f(acc + to_f(a.tb3[midx * F + j]));
          sm.f3[j] = (mode == 0 ? sm.f1[j] : g) * sm.vm[j];  // related
        }
        __syncthreads();
        for (size_t i = tid; i < FH; i += THREADS)
          ws_h[i] = rd<T>(sm.f3[i / H] * to_f(fa[i]));
        __syncthreads();
      }
      const T* b21 = a.b2t + H;
      gemm<G32>(ws_h, H, a.w2t + (size_t)H * H, F, H, H, sm, g32_ring, C,
                [&](int m, int n, float acc) {
        ws_y[(size_t)m * H + n] =
            fmaxf(acc + to_f(b21[n]), 0.f) * dr.keep(m, n, b, t, 2);
      });
      if (lead()) {
        for (int f = warp; f < F; f += NWARPS) {
          const float* y = ws_y + (size_t)f * H;
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
        for (int f = tid; f < F; f += THREADS)
          ra[(size_t)out_ab * F + f] = from_f<T>(sm.f3[f]);
        __syncthreads();
      }
    } else if (op == OP_ATTNV && lead()) {
      for (size_t i = tid; i < FH; i += THREADS)
        fout[i] = from_f<T>(sm.aa[i / H] * to_f(fa[i]));
      __syncthreads();
    }

    // ---- attn producers ----------------------------------------------
    if (lead()) {
      T* aout = ra + (size_t)out_a * F;
      if (op == OP_ANDA || op == OP_XORF) {
        for (int f = tid; f < F; f += THREADS)
          aout[f] = from_f<T>(op == OP_ANDA ? fminf(sm.aa[f], sm.ab[f])
                                            : fabsf(sm.aa[f] - sm.ab[f]));
      } else if (op == OP_HAS) {
        for (int f = tid; f < F; f += THREADS)
          aout[f] = from_f<T>(sigmoid_f(feat[(size_t)f * H]) *
                              dr.keep(0, f, b, t, 3) * sm.vm[f]);
      } else if (op == OP_EXF) {
        float n2 = 0.f;
        for (int k = tid; k < H; k += THREADS) n2 += sm.va[k] * sm.va[k];
        const float nva = sqrtf(fmaxf(block_sum(n2, sm.red), 1e-30f));
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f, nx = 0.f;
          for (int k = lane; k < H; k += 32) {
            const float x = to_f(fa[(size_t)f * H + k]);
            d += x * sm.va[k];
            nx += x * x;
          }
          d = warp_sum(d);
          nx = sqrtf(fmaxf(warp_sum(nx), 1e-30f));
          if (lane == 0) {
            const float c = d / fmaxf(nx * nva, COS_EPS);
            aout[f] = from_f<T>((c + 1.0f) * 0.49f * sm.vm[f]);
          }
        }
      } else if (op == OP_REL) {
        const int f = tid;
        const bool valid = f < F && sm.vm[f] > 0.f;
        float x = 0.f;
        if (f < F) {
          const float beta = to_f(a.beta[f]);
          x = mode == 1 ? sm.aa[f] - beta : sm.aa[f] + beta;
        }
        const float w = block_masked_softmax(x, valid, sm);
        if (f < F) aout[f] = from_f<T>(w);
      } else if (op == OP_LOC) {
        const T* wk = a.w2t + 2 * (size_t)H * H;
        const T* bk = a.b2t + 2 * (size_t)H;
        vecmat<T>(sm.va, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          sm.x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        vecmat<T>(sm.vb, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          sm.x2[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        __syncthreads();
        loc_cos<T>(sm.x1, feat, F, H, sm.f1, sm);
        loc_cos<T>(sm.x2, feat, F, H, sm.f2, sm);
        for (int f = tid; f < F; f += THREADS) {
          aout[f] = from_f<T>(sm.f1[f]);
          ra[(size_t)out_ab * F + f] = from_f<T>(sm.f2[f]);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The tensor-core route: mega_exec_tc_kernel<TRAIN> (bf16; TRAIN false:
// eval, #4; TRAIN true: the training forward #5, with dropout).
//
// The same walk as mega_exec_kernel, one block per example, with three
// changes. (1) Every [F, H] @ [H, H] product (the stage-1 expert MLP, the
// stage-2 projections, SUPF's keyword rows) runs on mma.sync (fwd_gemm,
// mega_common.cuh): its A operand is bf16 in shared memory and already
// rounded to bf16 by the JAX kernel's casts (fa, fb and the registers are
// bf16; the stage-1 hidden, feat and the gated operand rows are rd<T>
// values), so only the order of the float32 sums changes; W streams from
// L2 through a cp.async ring. The epilogues round at the same sites.
// (2) The stage-1 hidden and feat stay on chip as bf16 tiles: two [F, H +
// 8] tiles that swap roles (the operand tile, then the other's output).
// Only SUPF's keyword rows and TEMPORAL's pre-LayerNorm rows (float32) go
// to the [F, H] workspace. (3) The vec-level [1, H] @ [H, H] products
// (vecmat_tc) read W as 16-byte vectors along n, split k across threads
// and sum the partials in shared memory in a fixed order.
//
// Training multiplies by the counter-hash mask at mega_exec_kernel's eight
// sites with its keys; the eval instantiation compiles without them. The
// backward's tensor-core walk (mega_grad_tc.cu) recomputes #5's values with
// the same product code (walk_gemm, vecmat_tc) and epilogues, so a change
// to this route's products or their order moves the walk's recompute too,
// and stair_mega_recompute_check must hold the pair equal.
//
// Shared memory at F = 64, H = 512: the operand tile 66.5 KB, feat 66.5 KB,
// the W ring 54 KB (three stages of 64 x 128 bf16), six [max(H, L)] float
// vectors, the vec products' 8 KB of partials: ~206 KB, one block an SM.
//
// The row-slice mode (SLICED: F above TC_MAX_F or not a multiple of 16, the
// NMN CLIs' default F 150; or a forced cluster): the two tiles cannot stay on
// chip (two [160, 520] bf16 tiles are 333 KB), so they live in the
// per-example workspace after its float32 rows, and each [F, H] @ [H, H]
// product stages its A rows into one shared-memory tile of at most TC_MAX_F
// rows (fwd_rows, mega_common.cuh: the same k steps and fragments, so the
// same bits per row). An example runs on a thread-block cluster of C CTAs
// (tc_cluster: one CTA a 64-row slice while the launch fits one wave of the
// card's CTA slots, so the CLIs' B 32 at F 150 takes 96 of an H100's 132
// SMs): CTA r computes its rows of every product (tc_slices, a cluster
// barrier on each side), and CTA 0, the lead, runs every other pass in the
// one-CTA order and writes rv, ra and every frames row the products do not
// write; the other CTAs wait at the products' barriers. So every file equals
// one CTA's bit for bit at any C, and a change to a pass moves both modes.
//
// What bounds it on an H100: per heavy step two or three [64 x 512] @ [512
// x 512] products whose 512 KB weight tables each block reads from L2 (64
// operations a byte, so L2 bandwidth and the mma.sync rate are of one
// size), and the latency of the vec-level ops between them. At serving B =
// 1024, ~8 waves of one block per SM; at the train step's B = 128 one
// wave, so #5's time is one example's latency through its T steps.
// Grouping examples by expert, so that one weight tile serves several
// examples, and wgmma are later work.

using bf16 = __nv_bfloat16;

// Dynamic shared memory of mega_exec_tc_kernel in bytes (ops/mega_exec.py
// tc_smem_bytes mirrors it).
__host__ __device__ inline size_t tc_smem_bytes(int F, int H, int L) {
  const size_t V = (size_t)(((H > L ? H : L) + 3) & ~3);
  return 2 * (size_t)F * (H + TC_PAD) * sizeof(bf16) +
         (size_t)tc_ring<FWD_BN>() * sizeof(bf16) +
         (6 * V + TC_PARTS + 6 * (size_t)F + NWARPS) * sizeof(float);
}

// Dynamic shared memory of the row-slice mode (SLICED) in bytes: one
// staging tile of tc_slice_rows(F) rows instead of the two [F, H + 8] tiles
// (ops/mega_exec.py tc_sliced_smem_bytes mirrors it).
__host__ __device__ inline size_t tc_sliced_smem_bytes(int F, int H, int L) {
  return tc_smem_bytes(F, H, L) -
         (2 * (size_t)F - tc_slice_rows(F)) * (H + TC_PAD) * sizeof(bf16);
}

// Pointers into mega_exec_tc_kernel's dynamic shared memory.
struct TcSmem {
  bf16* tile[2];   // [F, H + TC_PAD] each: the operand tile and feat
  bf16* ring;      // tc_gemm's weight ring
  float *va, *vb, *vc, *nv, *x1, *x2, *part;
  float *vm, *aa, *ab, *f1, *f2, *f3, *red;
};

// loc_cos over the feat tile (bf16, row stride ld).
__device__ void loc_cos_tc(const float* kw, const bf16* feat, int ld, int F,
                           int H, float* out, const TcSmem& s) {
  float nk2 = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) nk2 += kw[k] * kw[k];
  const float nk = sqrtf(fmaxf(block_sum(nk2, s.red), 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = w; f < F; f += NWARPS) {
    const bf16* row = feat + (size_t)f * ld;
    float d = 0.f, n2 = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float v = to_f(row[k]);
      d += v * kw[k];
      n2 += v * v;
    }
    d = warp_sum(d);
    n2 = warp_sum(n2);
    if (lane == 0) {
      const float nf = sqrtf(fmaxf(n2, 1e-30f));
      const float c = rd<bf16>(d / fmaxf(nf * nk, COS_EPS));
      out[f] = (c + 1.0f) * 0.49f * s.vm[f];
    }
  }
  __syncthreads();
}

// superlative with vecmat_tc (see superlative).
template <typename Act>
__device__ void superlative_tc(float* row, int K, int mode, int count_or_neg,
                               const bf16* supw, const bf16* supb, int H,
                               const TcSmem& s, Act act, float* pooled) {
  const int k = threadIdx.x;
  bool valid = false;
  float x = 0.f;
  if (k < K) {
    valid = count_or_neg >= 0 ? (k < count_or_neg) : (s.vm[k] > 0.f);
    x = row[k];
  }
  float w = stair::mega::block_masked_softmax(x, valid, s.red);
  if (mode == 1) w = 1.0f - w;
  if (!valid) w = 0.f;
  __syncthreads();
  if (k < K) row[k] = w;
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += THREADS) {
    float p = 0.f;
    for (int kk = 0; kk < K; ++kk) p += row[kk] * act(kk, j);
    pooled[j] = rd<bf16>(p);
  }
  __syncthreads();
  vecmat_tc(pooled, nullptr, nullptr, supw, H, H, s.part, [&](int n, float y) {
    s.nv[n] = fmaxf(rd<bf16>(rd<bf16>(y) + to_f(supb[n])), 0.f);
  });
}

template <bool TRAIN, bool SLICED = false>
__global__ void __launch_bounds__(THREADS)
    mega_exec_tc_kernel(const Args<bf16> a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ int ins[NSF];
  using T = bf16;
  // SLICED: example b on a cluster of C = a.C CTAs (1 too), CTA 0 the lead
  const int C = SLICED ? a.C : 1;
  const int b = (int)(blockIdx.x / C);
  auto lead = [&] { return !SLICED || blockIdx.x % C == 0; };
  const int F = a.F, H = a.H, L = a.L, Hh = H / 2, LDT = H + TC_PAD;
  const int Nv = a.Nv, Nf = a.Nf, Na = a.Na;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  TcSmem s;
  {
    bf16* p = reinterpret_cast<bf16*>(tc_smem);
    // SLICED: one staging tile (tile[0]) of a product's A rows
    s.tile[0] = p; p += (size_t)(SLICED ? tc_slice_rows(F) : F) * LDT;
    s.tile[1] = p; p += SLICED ? 0 : (size_t)F * LDT;
    s.ring = p; p += tc_ring<FWD_BN>();
    float* q = reinterpret_cast<float*>(p);
    const int V = ((H > L ? H : L) + 3) & ~3;
    float** vs[] = {&s.va, &s.vb, &s.vc, &s.nv, &s.x1, &s.x2};
    for (float** v : vs) { *v = q; q += V; }
    s.part = q; q += TC_PARTS;
    float** fs[] = {&s.vm, &s.aa, &s.ab, &s.f1, &s.f2, &s.f3};
    for (float** v : fs) { *v = q; q += F; }
    s.red = q;
  }

  T* rv = a.rv + (size_t)b * Nv * H;
  T* rf = a.rf + (size_t)b * Nf * F * H;
  T* ra = a.ra + (size_t)b * Na * F;
  // SUPF kw_f / TEMP pre-LN rows; SLICED: then the two [F, H + TC_PAD] bf16
  // tiles
  float* wsg = a.ws + (size_t)b * (SLICED ? F * (H + LDT) : F * H);
  const size_t FH = (size_t)F * H;
  bf16* const tiles[2] = {
      SLICED ? reinterpret_cast<bf16*>(wsg + FH) : s.tile[0],
      SLICED ? reinterpret_cast<bf16*>(wsg + FH) + (size_t)F * LDT
             : s.tile[1]};
  // C[F, H] = A[F, H] (bf16 rows, stride lda) @ W[H, H] for the products
  // whose A is a tile (SLICED: this CTA's rows, staged; else the shared
  // tile A itself); epi(m, n, acc) per output row m of the example
  auto prod = [&](const bf16* A, int lda, const T* W, auto epi) {
    if constexpr (SLICED)
      tc_slices(F, C, [&](int m0, int rows) {
        fwd_rows(A + (size_t)m0 * lda, lda, W, rows, H, H, s.tile[0],
                 s.ring, [&](int m, int n, float acc) { epi(m0 + m, n, acc); });
      });
    else
      fwd_gemm(A, W, F, H, H, s.ring, epi);
  };

  // ---- register-file init: frames register 0 <- video * vmask ----------
  for (int f = tid; f < F; f += THREADS)
    s.vm[f] = to_f(a.vm[(size_t)b * F + f]);
  if (lead()) {
    for (int i = tid; i < Nv * H; i += THREADS) rv[i] = from_f<T>(0.f);
    for (int i = tid; i < Na * F; i += THREADS) ra[i] = from_f<T>(0.f);
    for (int i = tid; i < F * LDT; i += THREADS) tiles[0][i] = from_f<T>(0.f);
  }
  __syncthreads();
  if (lead()) {
    pass<true>(FH, [&](size_t i) {
      const int f = (int)(i / H), j = (int)(i % H);
      const T v = j < Hh ? a.vf_a[((size_t)b * F + f) * Hh + j]
                         : a.vf_b[((size_t)b * F + f) * Hh + j - Hh];
      return to_f(v) * s.vm[f];
    }, [&](size_t i, float v) { rf[i] = from_f<T>(v); });
    for (size_t i = FH + tid; i < (size_t)Nf * FH; i += THREADS)
      rf[i] = from_f<T>(0.f);
  }
  __syncthreads();

  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };
  int fcur = 0;   // which tile holds feat

  for (int t = 0; t < a.T_; ++t) {
    if (tid < NSF) ins[tid] = a.scal[((size_t)b * a.T_ + t) * NSF + tid];
    __syncthreads();
    const int op = ins[F_OP], e1 = ins[F_E1];
    const int mode = ins[F_MODE], count = ins[F_COUNT];
    const int iva = clampi(ins[F_VA], Nv), ivb = clampi(ins[F_VB], Nv);
    const int ivc = clampi(ins[F_VC], Nv);
    const int ifa = clampi(ins[F_FA], Nf), ifb = clampi(ins[F_FB], Nf);
    const int iaa = clampi(ins[F_AA], Na), iab = clampi(ins[F_AB], Na);
    const int out_v = clampi(ins[F_OUT_V], Nv);
    const int out_f = clampi(ins[F_OUT_F], Nf);
    const int out_a = clampi(ins[F_OUT_A], Na);
    const int out_ab = clampi(ins[F_OUT_AB], Na);
    const bool is_filter = op >= OP_FV && op <= OP_FFK;
    const T* fa = rf + (size_t)ifa * FH;
    // v times the dropout mask of (r, c) at one of the eight sites
    // (training); v itself in eval
    auto drop = [&](float v, int r, int c, int site) {
      if constexpr (TRAIN)
        return v * a.dr.keep(r, c, b, t, site);
      else
        return v;
    };

    // ---- operand reads, then the zero writes of out_attn/out_attn_b ----
    if (lead()) {
      for (int j = tid; j < H; j += THREADS) {
        s.va[j] = to_f(rv[(size_t)iva * H + j]);
        s.vb[j] = to_f(rv[(size_t)ivb * H + j]);
        s.nv[j] = 0.f;
      }
      for (int f = tid; f < F; f += THREADS) {
        s.aa[f] = to_f(ra[(size_t)iaa * F + f]);
        s.ab[f] = to_f(ra[(size_t)iab * F + f]);
      }
      __syncthreads();
      for (int f = tid; f < F; f += THREADS) {
        ra[(size_t)out_a * F + f] = from_f<T>(0.f);
        ra[(size_t)out_ab * F + f] = from_f<T>(0.f);
      }
      __syncthreads();
    }

    // ---- stage 1: expert two-layer frames MLP (e1 == 9: null) ---------
    // fa -> the free tile; hidden -> feat's tile; feat -> the free tile
    // (SLICED: fa's rows straight from the file).
    if (e1 != 9) {
      bf16* x = tiles[fcur ^ 1];
      bf16* h = tiles[fcur];
      const T* b1 = a.b1u + (size_t)e1 * H;
      const T* b2 = a.b2u + (size_t)e1 * H;
      if constexpr (!SLICED) load_tile(x, LDT, fa, F, H);
      prod(SLICED ? fa : x, SLICED ? H : LDT, a.w1u + (size_t)e1 * H * H,
           [&](int m, int n, float acc) {
        h[(size_t)m * LDT + n] =
            from_f<T>(drop(fmaxf(acc + to_f(b1[n]), 0.f), m, n, 0));
      });
      prod(h, LDT, a.w2u + (size_t)e1 * H * H, [&](int m, int n, float acc) {
        const float v = acc + to_f(b2[n]);
        x[(size_t)m * LDT + n] =
            from_f<T>(is_filter ? drop(fmaxf(v, 0.f), m, n, 1) : v);
      });
      fcur ^= 1;
    }
    const bf16* feat = tiles[fcur];
    bf16* opnd = tiles[fcur ^ 1];
    auto ft = [&](int f, int k) { return to_f(feat[(size_t)f * LDT + k]); };

    // ---- SUPF's keyword rows kw_f = lin_dt(fb, w2t[2], b2t[2]) -> wsg
    // [F, H] (on every CTA of the cluster); fb's rows stay at fbt for the
    // pooling: the free tile, or (SLICED) the file
    const T* fb = rf + (size_t)ifb * FH;
    const bf16* fbt = SLICED ? fb : opnd;
    const int ldb = SLICED ? H : LDT;
    if (op == OP_SUPF) {
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      if constexpr (!SLICED) load_tile(opnd, LDT, fb, F, H);
      prod(fbt, ldb, wk, [&](int m, int n, float acc) {
        wsg[(size_t)m * H + n] = rd<T>(rd<T>(acc) + to_f(bk[n]));
      });
    }

    // ---- vec producers (write s.nv; zeros for non-vec ops), the lead ----
    if (!lead()) {
    } else if (op == OP_PUSH) {
      const int ss = ins[F_SS], se = ins[F_SE];
      float* span_w = s.x1;  // [L]
      for (int p = tid; p < L; p += THREADS) {
        const bool valid = to_f(a.tm[(size_t)b * L + p]) > 0.f;
        const bool in_span = p >= ss && p < se;
        span_w[p] = (ss < 0 ? valid : (in_span && valid)) ? 1.f : 0.f;
      }
      __syncthreads();
      float den = 0.f;
      for (int p = 0; p < L; ++p) den += span_w[p];
      den = fmaxf(den, 1.0f);
      for (int j = tid; j < H; j += THREADS) {
        float v;
        if (ss == -2) {
          v = to_f(a.aux[((size_t)b * a.T_ + t) * H + j]);
        } else {
          const T* tok = j < Hh ? a.tok_a : a.tok_b;
          const int jj = j < Hh ? j : j - Hh;
          float acc = 0.f;
          for (int p = 0; p < L; ++p)
            acc += span_w[p] * to_f(tok[((size_t)b * L + p) * Hh + jj]);
          v = acc / den;
        }
        s.nv[j] = rd<T>(v);
      }
      __syncthreads();
    } else if (op == OP_ANDV) {
      for (int j = tid; j < H; j += THREADS)
        s.nv[j] = rd<T>(fminf(s.va[j], s.vb[j]));
      __syncthreads();
    } else if (op == OP_CHOOSE) {
      float dac = 0.f, dbc = 0.f, na = 0.f, nb = 0.f, nc = 0.f;
      for (int j = tid; j < H; j += THREADS) {
        const float c = to_f(rv[(size_t)ivc * H + j]);
        dac += s.va[j] * c;
        dbc += s.vb[j] * c;
        na += s.va[j] * s.va[j];
        nb += s.vb[j] * s.vb[j];
        nc += c * c;
      }
      dac = block_sum(dac, s.red);
      dbc = block_sum(dbc, s.red);
      na = sqrtf(fmaxf(block_sum(na, s.red), 1e-30f));
      nb = sqrtf(fmaxf(block_sum(nb, s.red), 1e-30f));
      nc = sqrtf(fmaxf(block_sum(nc, s.red), 1e-30f));
      const bool first =
          dac / fmaxf(na * nc, COS_EPS) > dbc / fmaxf(nb * nc, COS_EPS);
      for (int j = tid; j < H; j += THREADS)
        s.nv[j] = first ? s.va[j] : s.vb[j];
      __syncthreads();
    } else if (op == OP_CMP || op == OP_EQ) {
      const T* w = op == OP_CMP ? a.cw : a.eqw;
      const T* bb = op == OP_CMP ? a.cb : a.eqb;
      vecmat_tc(s.va, s.vb, nullptr, w, H, H, s.part, [&](int n, float y) {
        s.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(bb[n])), 0.f);
      });
    } else if (op == OP_XOR) {
      for (int j = tid; j < H; j += THREADS)
        s.x1[j] = rd<T>(fabsf(s.va[j] - s.vb[j]));
      __syncthreads();
      vecmat_tc(s.x1, s.va, s.vb, a.xw, H, H, s.part, [&](int n, float y) {
        s.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.xb[n])), 0.f);
      });
    } else if (op == OP_QUERY) {
      vecmat_tc(s.va, nullptr, nullptr, a.qw, H, H, s.part,
                [&](int n, float y) {
        s.nv[n] = drop(fmaxf(rd<T>(rd<T>(y) + to_f(a.qb[n])), 0.f), 0, n, 4);
      });
    } else if (op == OP_TOA) {
      vecmat_tc(s.va, s.vb, nullptr, a.taw1, H, H, s.part,
                [&](int n, float y) {
        s.x1[n] = rd<T>(
            drop(fmaxf(rd<T>(rd<T>(y) + to_f(a.tab1[n])), 0.f), 0, n, 5));
      });
      vecmat_tc(s.x1, nullptr, nullptr, a.taw2, H, H, s.part,
                [&](int n, float y) {
        s.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.tab2[n])), 0.f);
      });
    } else if (op == OP_EX) {
      // exists: kw = va, feat = vb, x = [feat, kw, feat * kw]
      for (int j = tid; j < H; j += THREADS)
        s.x1[j] = rd<T>(s.vb[j] * s.va[j]);
      __syncthreads();
      vecmat_tc(s.vb, s.va, s.x1, a.exw1, H, H, s.part, [&](int n, float y) {
        s.x2[n] = rd<T>(
            drop(fmaxf(rd<T>(rd<T>(y) + to_f(a.exb1[n])), 0.f), 0, n, 6));
      });
      vecmat_tc(s.x2, nullptr, nullptr, a.exw2, H, H, s.part,
                [&](int n, float y) {
        s.nv[n] = drop(fmaxf(rd<T>(rd<T>(y) + to_f(a.exb2[n])), 0.f), 0, n, 7);
      });
    } else if (op == OP_FV || op == OP_FK) {
      if (a.fsoft) {
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32) d += ft(f, k) * to_f(a.fltw[k]);
          d = warp_sum(d);
          if (lane == 0) s.f1[f] = d;
        }
        float kb = 0.f;
        for (int k = tid; k < H; k += THREADS) kb += s.va[k] * to_f(a.fltk[k]);
        kb = block_sum(kb, s.red) + to_f(a.fltb[0]);
        const int f = tid;
        const bool valid = f < F && s.vm[f] > 0.f;
        const float x = f < F ? s.f1[f] + kb : 0.f;
        const float soft = stair::mega::block_masked_softmax(x, valid, s.red);
        if (f < F) {
          const float w = op == OP_FV ? soft : s.vm[f];
          s.f2[f] = w * s.vm[f];
        }
      } else {
        for (int f = tid; f < F; f += THREADS) s.f2[f] = s.vm[f] * s.vm[f];
      }
      __syncthreads();
      for (int k = tid; k < H; k += THREADS) {
        float p = 0.f;
        for (int f = 0; f < F; ++f) p += ft(f, k) * s.f2[f];
        s.x1[k] = rd<T>(p);
      }
      __syncthreads();
      vecmat_tc(s.x1, nullptr, nullptr, a.fdw, H, H, s.part,
                [&](int n, float y) {
        s.nv[n] = fmaxf(rd<T>(rd<T>(y) + to_f(a.fdb[n])), 0.f);
      });
    } else if (op == OP_SUPV) {
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      vecmat_tc(s.va, nullptr, nullptr, wk, H, H, s.part, [&](int n, float y) {
        s.x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
      });
      vecmat_tc(s.vb, nullptr, nullptr, wk, H, H, s.part, [&](int n, float y) {
        s.x2[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
      });
      loc_cos_tc(s.x1, feat, LDT, F, H, s.f1, s);
      loc_cos_tc(s.x2, feat, LDT, F, H, s.f2, s);
      float r0 = 0.f, r1 = 0.f;
      for (int f = tid; f < F; f += THREADS) {
        r0 += s.f1[f] * s.vm[f];
        r1 += s.f2[f] * s.vm[f];
      }
      r0 = block_sum(r0, s.red);
      r1 = block_sum(r1, s.red);
      if (tid == 0) {
        s.f3[0] = r0;
        s.f3[1] = r1;
      }
      __syncthreads();
      const float* va = s.va;
      const float* vb = s.vb;
      superlative_tc(s.f3, 2, mode, count < 0 ? 0 : count, a.supw, a.supb, H,
                     s, [&](int k, int j) { return k == 0 ? va[j] : vb[j]; },
                     s.vc);
    } else if (op == OP_SUPF) {
      for (int r = warp; r < F; r += NWARPS) {
        float n1 = 0.f, n2 = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float x = wsg[(size_t)r * H + k], y = ft(r, k);
          n1 += x * x;
          n2 += y * y;
        }
        n1 = warp_sum(n1);
        n2 = warp_sum(n2);
        if (lane == 0) {
          s.f1[r] = sqrtf(fmaxf(n1, 1e-30f));
          s.f2[r] = sqrtf(fmaxf(n2, 1e-30f));
        }
      }
      __syncthreads();
      for (int i = warp; i < F; i += NWARPS) {
        const float* ki = wsg + (size_t)i * H;
        float row = 0.f;
        for (int f = 0; f < F; ++f) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32) d += ki[k] * ft(f, k);
          d = warp_sum(d);
          const float c = rd<T>(d / fmaxf(s.f1[i] * s.f2[f], COS_EPS));
          row += ((c + 1.0f) * 0.49f * s.vm[f]) * s.vm[f];
        }
        if (lane == 0) s.f3[i] = row;
      }
      __syncthreads();
      superlative_tc(s.f3, F, mode, -1, a.supw, a.supb, H, s,
                     [&](int k, int j) {
                       return to_f(fbt[(size_t)k * ldb + j]);
                     },
                     s.x1);
    }

    if (lead())
      for (int j = tid; j < H; j += THREADS)
        rv[(size_t)out_v * H + j] = from_f<T>(s.nv[j]);

    // ---- frames producers (the stage-2 products on every CTA of the
    // cluster, the rest on the lead) ------------------------------------
    T* fout = rf + (size_t)out_f * FH;
    const int midx = mode - 1 > 0 ? mode - 1 : 0;
    if (op == OP_FFV || op == OP_FFK) {
      if (lead()) {
        float gk = 0.f;
        for (int k = tid; k < H; k += THREADS)
          gk += s.va[k] * to_f(a.ffkw[k]);
        gk = block_sum(gk, s.red) + to_f(a.ffab[0]);
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32) d += ft(f, k) * to_f(a.ffwf[k]);
          d = warp_sum(d);
          if (lane == 0) s.f1[f] = op == OP_FFV ? sigmoid_f(d + gk) : 1.0f;
        }
        __syncthreads();
        for (int i = tid; i < F * H; i += THREADS) {
          const int f = i / H, k = i % H;
          opnd[(size_t)f * LDT + k] = from_f<T>(s.f1[f] * ft(f, k));
        }
        __syncthreads();
      }
      const T* b20 = a.b2t;
      prod(opnd, LDT, a.w2t, [&](int m, int n, float acc) {
        fout[(size_t)m * H + n] =
            from_f<T>(drop(fmaxf(acc + to_f(b20[n]), 0.f), m, n, 2) * s.vm[m]);
      });
    } else if (op == OP_TEMP && lead()) {
      const size_t FF = (size_t)F * F;
      for (int f = tid; f < F; f += THREADS) {
        const float am = count == 2 ? (s.aa[f] + s.ab[f]) * 0.5f : s.aa[f];
        s.f1[f] = am;
        s.f2[f] = rd<T>(am);
      }
      __syncthreads();
      for (int j = tid; j < F; j += THREADS) {
        float acc = 0.f;
        for (int i = 0; i < F; ++i)
          acc += s.f2[i] * to_f(a.t1[midx * FF + (size_t)i * F + j]);
        s.f3[j] = rd<T>(fmaxf(acc + to_f(a.tb1[midx * F + j]), 0.f));
      }
      __syncthreads();
      for (int j = tid; j < F; j += THREADS) {
        float acc = 0.f;
        for (int i = 0; i < F; ++i)
          acc += s.f3[i] * to_f(a.t2[midx * FF + (size_t)i * F + j]);
        s.f2[j] = rd<T>(fmaxf(acc + to_f(a.tb2[midx * F + j]), 0.f));
      }
      __syncthreads();
      for (int j = tid; j < F; j += THREADS) {
        float acc = 0.f;
        for (int i = 0; i < F; ++i)
          acc += s.f2[i] * to_f(a.t3[midx * FF + (size_t)i * F + j]);
        const float g = sigmoid_f(acc + to_f(a.tb3[midx * F + j]));
        s.f3[j] = (mode == 0 ? s.f1[j] : g) * s.vm[j];  // related
      }
      __syncthreads();
      pass<true>(FH, [&](size_t i) { return s.f3[i / H] * to_f(fa[i]); },
                 [&](size_t i, float v) {
                   opnd[(i / H) * LDT + i % H] = from_f<T>(v);
                 });
      __syncthreads();
    }
    if (op == OP_TEMP) {
      const T* b21 = a.b2t + H;
      prod(opnd, LDT, a.w2t + (size_t)H * H, [&](int m, int n, float acc) {
        wsg[(size_t)m * H + n] = drop(fmaxf(acc + to_f(b21[n]), 0.f), m, n, 2);
      });
    }
    if (op == OP_TEMP && lead()) {
      for (int f = warp; f < F; f += NWARPS) {
        const float* y = wsg + (size_t)f * H;
        float sm = 0.f;
        for (int k = lane; k < H; k += 32) sm += y[k];
        const float mu = warp_sum(sm) / H;
        float s2 = 0.f;
        // rsqrt and the products rounded on their own, as mega_exec_kernel
        for (int k = lane; k < H; k += 32)
          s2 += __fmul_rn(y[k] - mu, y[k] - mu);
        const float var = warp_sum(s2) / H;
        const float inv = rsqrtf(var + 1e-5f);
        for (int k = lane; k < H; k += 32)
          fout[(size_t)f * H + k] = from_f<T>(
              __fmul_rn((y[k] - mu) * inv, to_f(a.lns[k])) +
              to_f(a.lnb[k]));
      }
      for (int f = tid; f < F; f += THREADS)
        ra[(size_t)out_ab * F + f] = from_f<T>(s.f3[f]);
      __syncthreads();
    } else if (op == OP_ATTNV && lead()) {
      pass<true>(FH, [&](size_t i) { return s.aa[i / H] * to_f(fa[i]); },
                 [&](size_t i, float v) { fout[i] = from_f<T>(v); });
      __syncthreads();
    }

    // ---- attn producers, the lead --------------------------------------
    T* aout = ra + (size_t)out_a * F;
    if (!lead()) {
    } else if (op == OP_ANDA || op == OP_XORF) {
      for (int f = tid; f < F; f += THREADS)
        aout[f] = from_f<T>(op == OP_ANDA ? fminf(s.aa[f], s.ab[f])
                                          : fabsf(s.aa[f] - s.ab[f]));
    } else if (op == OP_HAS) {
      for (int f = tid; f < F; f += THREADS)
        aout[f] = from_f<T>(drop(sigmoid_f(ft(f, 0)), 0, f, 3) * s.vm[f]);
    } else if (op == OP_EXF) {
      float n2 = 0.f;
      for (int k = tid; k < H; k += THREADS) n2 += s.va[k] * s.va[k];
      const float nva = sqrtf(fmaxf(block_sum(n2, s.red), 1e-30f));
      for (int f = warp; f < F; f += NWARPS) {
        float d = 0.f, nx = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float x = to_f(fa[(size_t)f * H + k]);
          d += x * s.va[k];
          nx += x * x;
        }
        d = warp_sum(d);
        nx = sqrtf(fmaxf(warp_sum(nx), 1e-30f));
        if (lane == 0) {
          const float c = d / fmaxf(nx * nva, COS_EPS);
          aout[f] = from_f<T>((c + 1.0f) * 0.49f * s.vm[f]);
        }
      }
    } else if (op == OP_REL) {
      const int f = tid;
      const bool valid = f < F && s.vm[f] > 0.f;
      float x = 0.f;
      if (f < F) {
        const float beta = to_f(a.beta[f]);
        x = mode == 1 ? s.aa[f] - beta : s.aa[f] + beta;
      }
      const float w = stair::mega::block_masked_softmax(x, valid, s.red);
      if (f < F) aout[f] = from_f<T>(w);
    } else if (op == OP_LOC) {
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      vecmat_tc(s.va, nullptr, nullptr, wk, H, H, s.part, [&](int n, float y) {
        s.x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
      });
      vecmat_tc(s.vb, nullptr, nullptr, wk, H, H, s.part, [&](int n, float y) {
        s.x2[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
      });
      loc_cos_tc(s.x1, feat, LDT, F, H, s.f1, s);
      loc_cos_tc(s.x2, feat, LDT, F, H, s.f2, s);
      for (int f = tid; f < F; f += THREADS) {
        aout[f] = from_f<T>(s.f1[f]);
        ra[(size_t)out_ab * F + f] = from_f<T>(s.f2[f]);
      }
    }
    __syncthreads();
  }
}

// The row-slice mode's cluster size for B examples at (F, H, L): `cluster`
// where forced (> 0), else tc_cluster over the card's CTA slots for the
// kernel at its shared memory (one an SM).
template <bool TRAIN>
cudaError_t tc_sliced_pick(int B, int F, int H, int L, int cluster,
                           int* C) {
  const auto kernel = mega_exec_tc_kernel<TRAIN, true>;
  const size_t smem = tc_sliced_smem_bytes(F, H, L);
  *C = cluster;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess || cluster > 0) return e;
  int slots = 0;
  e = cta_slots(kernel, smem, &slots);
  *C = tc_cluster(B, F, slots);
  return e;
}

// The row-slice mode's launch: example b on CTAs b C .. b C + C - 1.
template <bool TRAIN>
int launch_tc_sliced(const Args<bf16>& a, cudaStream_t stream) {
  const auto kernel = mega_exec_tc_kernel<TRAIN, true>;
  const size_t smem = tc_sliced_smem_bytes(a.F, a.H, a.L);
  const cudaError_t e = launch_clusters(kernel, a.B, a.C, smem, stream, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// cluster: the CTAs of an example's cluster, 0 for the launch's pick (one
// CTA at the widths the shared tiles hold, else tc_sliced_pick's); *used
// gets the size launched. The row-slice mode wherever the shared tiles
// cannot hold F or a cluster of 2 or more is asked for.
template <bool TRAIN>
int launch_tc(const void* const* p, void* rv, void* rf, void* ra, void* ws,
              int B, int T_, int Nv, int Nf, int Na, int F, int H, int L,
              int fsoft, stair::Dropout dr, cudaStream_t stream,
              int cluster, int* used) {
  Args<bf16> a;
  a.fill(p);
  a.rv = (bf16*)rv;
  a.rf = (bf16*)rf;
  a.ra = (bf16*)ra;
  a.ws = (float*)ws;
  a.B = B;
  a.T_ = T_;
  a.Nv = Nv;
  a.Nf = Nf;
  a.Na = Na;
  a.F = F;
  a.H = H;
  a.L = L;
  a.fsoft = fsoft;
  a.C = 1;
  a.dr = dr;
  if (cluster > 1 || F % 16 || F > stair::TC_MAX_F) {
    const cudaError_t e = tc_sliced_pick<TRAIN>(B, F, H, L, cluster, &a.C);
    *used = a.C;
    if (e != cudaSuccess) return (int)e;
    return launch_tc_sliced<TRAIN>(a, stream);
  }
  *used = 1;
  const size_t smem = tc_smem_bytes(F, H, L);
  cudaError_t e = cudaFuncSetAttribute(
      mega_exec_tc_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  mega_exec_tc_kernel<TRAIN><<<B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of mega_exec_kernel<float, true> (gemm32's ring,
// the one layout its products use), and the block's whole shared memory
// with the static part; ops/mega_exec.py fma32_smem_bytes mirrors the sum.
constexpr size_t FMA32_RING_BYTES = g32_ring<false>() * sizeof(float);
constexpr size_t FMA32_SMEM_BYTES = sizeof(SmemT<true>) + FMA32_RING_BYTES;
// Shared memory leaves room for two blocks an SM, as the general route
// runs (228 KB an SM, 1 KB of it reserved for each block); registers hold
// the route to one: ptxas gives the kernel 246-254 a thread, where the
// general instantiation's 128 spill.
static_assert(2 * (FMA32_SMEM_BYTES + 1024) <= 233472,
              "mega_exec_kernel<float, true>'s shared memory fits twice");

template <typename T, bool G32 = false>
int launch(const void* const* p, void* rv, void* rf, void* ra, void* ws,
           int B, int T_, int Nv, int Nf, int Na, int F, int H, int L,
           int fsoft, stair::Dropout dr, cudaStream_t stream,
           int cluster = 1, int* used = nullptr) {
  Args<T> a;
  a.fill(p);
  a.rv = (T*)rv;
  a.rf = (T*)rf;
  a.ra = (T*)ra;
  a.ws = (float*)ws;
  a.B = B;
  a.T_ = T_;
  a.Nv = Nv;
  a.Nf = Nf;
  a.Na = Na;
  a.F = F;
  a.H = H;
  a.L = L;
  a.fsoft = fsoft;
  a.C = 1;
  a.dr = dr;
  if constexpr (G32) {
    const size_t smem = FMA32_RING_BYTES;
    cudaError_t e = cudaFuncSetAttribute(
        mega_exec_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = pick_cluster(mega_exec_kernel<T, true>, smem, B, H, cluster, &a.C);
    if (used) *used = a.C;
    if (e == cudaSuccess)
      e = launch_clusters(mega_exec_kernel<T, true>, B, a.C, smem, stream, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    mega_exec_kernel<T, false><<<B, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: the NARGS tensors of ops/mega_exec.py prepare_args (ARG_NAMES
// order); rv/rf/ra: the output register files (written in full); ws: a
// float32 [B, 3, F, H] workspace. H even and <= MAX_H, F <= MAX_F, L <=
// MAX_L (mega_limits.cuh). drop != 0: training forward, dropout with
// hash_keep(seed0, seed1, thresh, scale); drop = 0: eval. Returns
// cudaGetLastError() after the launch (or cudaErrorInvalidValue).
extern "C" int stair_mega_exec_fwd(const void* const* ptrs, int nptrs,
                                   void* rv, void* rf, void* ra, void* ws,
                                   int B, int T, int Nv, int Nf, int Na,
                                   int F, int H, int L, int bf16, int fsoft,
                                   int drop, int seed0, int seed1,
                                   unsigned thresh, float scale,
                                   void* stream) {
  if (nptrs != NARGS || H > MAX_H || F > MAX_F || L > MAX_L || (H & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const stair::Dropout dr{drop, seed0, seed1, thresh, scale};
  if (bf16)
    return launch<__nv_bfloat16>(ptrs, rv, rf, ra, ws, B, T, Nv, Nf, Na, F,
                                 H, L, fsoft, dr, st);
  return launch<float>(ptrs, rv, rf, ra, ws, B, T, Nv, Nf, Na, F, H, L, fsoft,
                       dr, st);
}

// The widths the tensor-core route takes: H a multiple of 64 in [64,
// TC_MAX_H], any F in [TC_MIN_F, TC_ROUTE_MAX_F] (above TC_MAX_F or at a
// ragged F in the row-slice mode), L <= MAX_L; a forced cluster of at most
// 8 CTAs (the portable cluster size).
static bool tc_takes(int nptrs, int B, int F, int H, int L, int cluster) {
  return nptrs == NARGS && B > 0 && H % 64 == 0 && H >= 64 &&
         H <= stair::TC_MAX_H && F >= stair::TC_MIN_F &&
         F <= stair::TC_ROUTE_MAX_F && L <= MAX_L && cluster >= 0 &&
         cluster <= 8;
}

// The tensor-core route, eval (mega_exec_tc_kernel<false>, #4): bf16 at
// the widths tc_takes; ops/mega_exec.py fwd_route picks it. Arguments as
// stair_mega_exec_fwd's; ws: a float32 workspace of [B, F, H] (one CTA an
// example with the tiles in shared memory) or [B, F, 2 H + TC_PAD] (the
// row-slice mode: then the tiles); cluster, used: as launch_tc's. A cluster
// that cannot launch returns its error: nothing falls back.
extern "C" int stair_mega_exec_fwd_tc(const void* const* ptrs, int nptrs,
                                      void* rv, void* rf, void* ra, void* ws,
                                      int B, int T, int Nv, int Nf, int Na,
                                      int F, int H, int L, int fsoft,
                                      int cluster, int* used, void* stream) {
  if (!tc_takes(nptrs, B, F, H, L, cluster)) return (int)cudaErrorInvalidValue;
  return launch_tc<false>(ptrs, rv, rf, ra, ws, B, T, Nv, Nf, Na, F, H, L,
                          fsoft, stair::Dropout{0, 0, 0, 0u, 1.f},
                          (cudaStream_t)stream, cluster, used);
}

// The tensor-core route, training (mega_exec_tc_kernel<true>, #5): as
// stair_mega_exec_fwd_tc, with stair_mega_exec_fwd's dropout arguments
// (drop = 0: no mask).
extern "C" int stair_mega_exec_fwd_tc_train(
    const void* const* ptrs, int nptrs, void* rv, void* rf, void* ra,
    void* ws, int B, int T, int Nv, int Nf, int Na, int F, int H, int L,
    int fsoft, int drop, int seed0, int seed1, unsigned thresh, float scale,
    int cluster, int* used, void* stream) {
  if (!tc_takes(nptrs, B, F, H, L, cluster)) return (int)cudaErrorInvalidValue;
  return launch_tc<true>(ptrs, rv, rf, ra, ws, B, T, Nv, Nf, Na, F, H, L,
                         fsoft, stair::Dropout{drop, seed0, seed1, thresh,
                                               scale},
                         (cudaStream_t)stream, cluster, used);
}

// Dynamic shared memory of mega_exec_tc_kernel (both instantiations) at
// (F, H, L), in bytes: one CTA an example with the tiles in shared memory.
extern "C" long stair_mega_exec_tc_smem(int F, int H, int L) {
  return (long)tc_smem_bytes(F, H, L);
}

// The same per CTA in the row-slice mode.
extern "C" long stair_mega_exec_tc_sliced_smem(int F, int H, int L) {
  return (long)tc_sliced_smem_bytes(F, H, L);
}

// CTA slots of the row-slice mode's forward at (F, H, L) on the current
// card (its SMs x the kernel's CTAs an SM), or -1 on an error.
extern "C" int stair_mega_exec_tc_slots(int F, int H, int L) {
  const auto kernel = mega_exec_tc_kernel<true, true>;
  const size_t smem = tc_sliced_smem_bytes(F, H, L);
  int slots = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cta_slots(kernel, smem, &slots) != cudaSuccess)
    return -1;
  return slots;
}

// The CTAs of an example's cluster that a tensor-core launch of B examples
// at (F, H, L) takes on the current card (1 at the widths the shared tiles
// hold), or -1 on an error.
extern "C" int stair_mega_exec_tc_cluster(int B, int F, int H, int L) {
  if (!(F % 16 || F > stair::TC_MAX_F)) return 1;
  int C = 0;
  if (tc_sliced_pick<true>(B, F, H, L, 0, &C) != cudaSuccess) return -1;
  return C;
}

// The widths the "fma32" route takes: H a multiple of G32_BN in [G32_BN,
// FMA32_MAX_H] (whole column tiles of gemm32), F in [FMA32_MIN_F,
// FMA32_MAX_F] (row tiles of gemm32, the last one ragged), L <= MAX_L.
static bool fma32_takes(int nptrs, int F, int H, int L) {
  return nptrs == NARGS && H % G32_BN == 0 && H >= G32_BN &&
         H <= stair::FMA32_MAX_H && F >= stair::FMA32_MIN_F &&
         F <= stair::FMA32_MAX_F && L <= MAX_L;
}

// The "fma32" route (mega_exec_kernel<float, true>): float32 at the widths
// fma32_takes, eval (#4, drop = 0) and training (#5); ops/mega_exec.py
// fwd_route picks it. Arguments as stair_mega_exec_fwd's without the dtype
// flag; ws: a float32 [B, 3, F, H] workspace. cluster: the CTAs of an
// example's cluster, 0 for the launch's pick (mega32_cluster) or forced (a
// divisor of H / G32_BN); *used gets the size launched. Its register files
// equal the general route's bit for bit at every cluster size. A cluster
// that cannot launch returns its error: nothing falls back.
extern "C" int stair_mega_exec_fwd_fma32(
    const void* const* ptrs, int nptrs, void* rv, void* rf, void* ra,
    void* ws, int B, int T, int Nv, int Nf, int Na, int F, int H, int L,
    int fsoft, int drop, int seed0, int seed1, unsigned thresh, float scale,
    int cluster, int* used, void* stream) {
  if (!fma32_takes(nptrs, F, H, L) || B <= 0 || cluster < 0)
    return (int)cudaErrorInvalidValue;
  return launch<float, true>(ptrs, rv, rf, ra, ws, B, T, Nv, Nf, Na, F, H, L,
                             fsoft, stair::Dropout{drop, seed0, seed1, thresh,
                                                   scale},
                             (cudaStream_t)stream, cluster, used);
}

// Shared memory of mega_exec_kernel<float, true> per block, static and
// dynamic, in bytes (the same at every width).
extern "C" long stair_mega_exec_fma32_smem() {
  return (long)FMA32_SMEM_BYTES;
}

// Clusters of c CTAs of mega_exec_kernel<float, true> that fit the current
// card at once (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int stair_mega_exec_fma32_fit(int c) {
  int fit = 0;
  if (cudaFuncSetAttribute(mega_exec_kernel<float, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FMA32_RING_BYTES) != cudaSuccess ||
      clusters_fit(mega_exec_kernel<float, true>, FMA32_RING_BYTES, c, &fit) !=
          cudaSuccess)
    return -1;
  return fit;
}

// The CTAs of an example's cluster that a launch of B examples at width H
// takes on the current card (mega32_cluster), or -1 on an error.
extern "C" int stair_mega_exec_fma32_cluster(int B, int H) {
  int C = 0;
  if (cudaFuncSetAttribute(mega_exec_kernel<float, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)FMA32_RING_BYTES) != cudaSuccess ||
      pick_cluster(mega_exec_kernel<float, true>, FMA32_RING_BYTES, B, H, 0,
                   &C) != cudaSuccess)
    return -1;
  return C;
}
