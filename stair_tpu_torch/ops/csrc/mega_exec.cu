// Executor megakernel, forward: eval, and training with dropout.
//
// Replaces the TPU kernel stair_tpu/ops/mega_exec.py _make_kernel, reached
// through forward_call: train=False (mega_exec) and, with a seed, the
// training forward (ops/mega_grad.py _train_fn / mega_exec_train), which
// multiplies the JAX kernel's eight dropout sites by the counter-hash mask
// hash_keep (common.cuh) keyed on (seed, example, step, site), so the
// backward kernel (mega_grad.cu) recomputes the masks instead of storing
// them. Inputs are the tensors of ops/mega_exec.py prepare_args, in
// ARG_NAMES order.
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
// Every [F, H] @ [H, H] product (expert MLPs, stage-2 projections,
// localize keywords) is a shared-memory tiled loop on the CUDA cores with
// float32 accumulation: 64 x 64 output tiles, 16-deep k slices, 4 x 4
// outputs per thread. Vec-level [1, H] @ [H, H] products give each thread
// whole output columns. Values are rounded to the compute dtype exactly
// where the JAX kernel casts (lin_dt and friends), so bf16 results track
// the TPU kernel's rounding sites.
//
// What bounds it on an H100: B = 1024 blocks of about three heavy
// [64 x 512] @ [512 x 512] products per step on the float32 CUDA cores
// (no tensor cores yet), with the weight tiles re-read from L2 by every
// block. mma.sync / wgmma tiles and grouping examples by expert so that
// weight tiles are shared are later work.

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
  stair::Dropout dr;
};

struct Smem {
  float va[MAX_H], vb[MAX_H], vc[MAX_H], nv[MAX_H], x1[MAX_H], x2[MAX_H];
  float vm[MAX_F], aa[MAX_F], ab[MAX_F], f1[MAX_F], f2[MAX_F], f3[MAX_F];
  float As[BK][BM + 1];
  float Ws[BK][BN];
  float red[NWARPS];
  int ins[NSF];
};

// C[M, N] = A[M, K] (row stride lda) @ W[K, N]; epi(m, n, acc) per output.
// Called by the whole block; returns after a barrier.
template <typename TA, typename TW, typename Epi>
__device__ void gemm(const TA* A, int lda, const TW* W, int M, int K, int N,
                     Smem& sm, Epi epi) {
  stair::mega::gemm<float, false, false>(A, lda, 1, W, N, 1, M, K, N,
                                         &sm.As[0][0], &sm.Ws[0][0], epi);
}

// Masked softmax over F entries held one per thread (f = threadIdx.x);
// an all-masked row gives 0. Returns this thread's weight.
__device__ float block_masked_softmax(float x, bool valid, Smem& sm) {
  return stair::mega::block_masked_softmax(x, valid, sm.red);
}

// Localize/superlative cosine row of keyword kw [H] (shared) against the
// feat tile [F, H]: out[f] = (rd(cos) + 1) * 0.49 * vm[f]. Warp per row.
template <typename T>
__device__ void loc_cos(const float* kw, const float* feat, int F, int H,
                        float* out, Smem& sm) {
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
template <typename T, typename Act>
__device__ void superlative(float* row, int K, int mode, int count_or_neg,
                            const T* supw, const T* supb, int H, Smem& sm,
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

template <typename T>
__global__ void __launch_bounds__(THREADS) mega_exec_kernel(const Args<T> a) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
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
  for (int i = tid; i < Nv * H; i += THREADS) rv[i] = from_f<T>(0.f);
  for (int i = tid; i < Na * F; i += THREADS) ra[i] = from_f<T>(0.f);
  __syncthreads();
  for (size_t i = tid; i < FH; i += THREADS) {
    const int f = (int)(i / H), j = (int)(i % H);
    const T v = j < Hh ? a.vf_a[((size_t)b * F + f) * Hh + j]
                       : a.vf_b[((size_t)b * F + f) * Hh + j - Hh];
    rf[i] = from_f<T>(to_f(v) * sm.vm[f]);
  }
  for (size_t i = FH + tid; i < (size_t)Nf * FH; i += THREADS)
    rf[i] = from_f<T>(0.f);
  __syncthreads();

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

    // ---- stage 1: expert two-layer frames MLP (e1 == 9: null) ---------
    if (e1 != 9) {
      const T* w1 = a.w1u + (size_t)e1 * H * H;
      const T* b1 = a.b1u + (size_t)e1 * H;
      const T* w2 = a.w2u + (size_t)e1 * H * H;
      const T* b2 = a.b2u + (size_t)e1 * H;
      gemm(fa, H, w1, F, H, H, sm, [&](int m, int n, float acc) {
        ws_h[(size_t)m * H + n] =
            rd<T>(fmaxf(acc + to_f(b1[n]), 0.f) * dr.keep(m, n, b, t, 0));
      });
      gemm(ws_h, H, w2, F, H, H, sm, [&](int m, int n, float acc) {
        const float v = acc + to_f(b2[n]);
        feat[(size_t)m * H + n] =
            rd<T>(is_filter ? fmaxf(v, 0.f) * dr.keep(m, n, b, t, 1) : v);
      });
    }

    // ---- vec producers (write sm.nv; zeros for non-vec ops) -----------
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
        for (int k = tid; k < H; k += THREADS) kb += sm.va[k] * to_f(a.fltk[k]);
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
                     H, sm, [&](int k, int j) { return k == 0 ? va[j] : vb[j]; },
                     sm.vc);
    } else if (op == OP_SUPF) {
      const T* fb = rf + (size_t)ifb * FH;
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      // kw_f = lin_dt(fb, w2t[2], b2t[2]) -> ws_h [F, H]
      gemm(fb, H, wk, F, H, H, sm, [&](int m, int n, float acc) {
        ws_h[(size_t)m * H + n] = rd<T>(rd<T>(acc) + to_f(bk[n]));
      });
      // Row norms: f1 = |kw_f[i]|, f2 = |feat[f]|.
      for (int r = warp; r < F; r += NWARPS) {
        float n1 = 0.f, n2 = 0.f;
        for (int k = lane; k < H; k += 32) {
          const float x = ws_h[(size_t)r * H + k], y = feat[(size_t)r * H + k];
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
                     [&](int k, int j) { return to_f(fb[(size_t)k * H + j]); },
                     sm.x1);
    }

    for (int j = tid; j < H; j += THREADS)
      rv[(size_t)out_v * H + j] = from_f<T>(sm.nv[j]);

    // ---- frames producers --------------------------------------------
    T* fout = rf + (size_t)out_f * FH;
    if (op == OP_FFV || op == OP_FFK) {
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
      const T* b20 = a.b2t;
      gemm(ws_h, H, a.w2t, F, H, H, sm, [&](int m, int n, float acc) {
        fout[(size_t)m * H + n] = from_f<T>(
            fmaxf(acc + to_f(b20[n]), 0.f) * dr.keep(m, n, b, t, 2) *
            sm.vm[m]);
      });
    } else if (op == OP_TEMP) {
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
      const T* b21 = a.b2t + H;
      gemm(ws_h, H, a.w2t + (size_t)H * H, F, H, H, sm,
           [&](int m, int n, float acc) {
             ws_y[(size_t)m * H + n] =
                 fmaxf(acc + to_f(b21[n]), 0.f) * dr.keep(m, n, b, t, 2);
           });
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
    } else if (op == OP_ATTNV) {
      for (size_t i = tid; i < FH; i += THREADS)
        fout[i] = from_f<T>(sm.aa[i / H] * to_f(fa[i]));
      __syncthreads();
    }

    // ---- attn producers ----------------------------------------------
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
    __syncthreads();
  }
}

template <typename T>
int launch(const void* const* p, void* rv, void* rf, void* ra, void* ws,
           int B, int T_, int Nv, int Nf, int Na, int F, int H, int L,
           int fsoft, stair::Dropout dr, cudaStream_t stream) {
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
  a.dr = dr;
  mega_exec_kernel<T><<<B, THREADS, 0, stream>>>(a);
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
