// Device helpers shared by the executor's forward (mega_exec.cu) and
// backward (mega_grad.cu) kernels: the instruction layout and opcodes, the
// argument table of ops/mega_exec.py prepare_args, block reductions, and
// the block-wide matrix products. Both kernels use the same products with
// the same loop order, so the backward recomputes the forward's values bit
// for bit (relu boundaries and bf16 roundings then agree).
#pragma once

#include "common.cuh"
#include "mega_limits.cuh"

namespace stair {
namespace mega {

constexpr int NSF = 17;
enum {
  F_OP, F_E1, F_VA, F_VB, F_VC, F_FA, F_FB, F_AA, F_AB, F_MODE, F_COUNT,
  F_SS, F_SE, F_OUT_V, F_OUT_F, F_OUT_A, F_OUT_AB
};
// stair_tpu/ir/lowering.py Opcode
enum {
  OP_PUSH = 1, OP_ANDV = 2, OP_ANDA = 3, OP_CMP = 4, OP_EQ = 5,
  OP_CHOOSE = 6, OP_XOR = 7, OP_XORF = 8, OP_QUERY = 9, OP_TOA = 10,
  OP_HAS = 11, OP_EX = 12, OP_EXF = 13, OP_LOC = 14, OP_SUPV = 15,
  OP_SUPF = 16, OP_TEMP = 17, OP_ATTNV = 18, OP_FV = 19, OP_FK = 20,
  OP_FFV = 21, OP_FFK = 22, OP_REL = 23
};

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int NARGS = 49;
constexpr float COS_EPS = 1e-8f;

// GEMM tile: BM x BN outputs per pass, BK-deep k slices, 4 x 4 per thread.
constexpr int BM = 64, BN = 64, BK = 16;

// The tensors of prepare_args, in ARG_NAMES order.
template <typename T>
struct Tensors {
  const int* scal;
  const T *vf_a, *vf_b, *vm, *tok_a, *tok_b, *tm, *aux;
  const T *w1u, *b1u, *w2u, *b2u, *w2t, *b2t, *fdw, *fdb;
  const T *cw, *cb, *eqw, *eqb, *xw, *xb, *qw, *qb;
  const T *taw1, *tab1, *taw2, *tab2, *exw1, *exb1, *exw2, *exb2;
  const T *supw, *supb, *ffwf, *ffkw, *ffab, *fltw, *fltk, *fltb;
  const T *lns, *lnb, *beta, *t1, *t2, *t3, *tb1, *tb2, *tb3;

  void fill(const void* const* p) {
    int i = 0;
    scal = (const int*)p[i++];
    const T** fields[] = {
        &vf_a, &vf_b, &vm, &tok_a, &tok_b, &tm, &aux,
        &w1u, &b1u, &w2u, &b2u, &w2t, &b2t, &fdw, &fdb,
        &cw, &cb, &eqw, &eqb, &xw, &xb, &qw, &qb,
        &taw1, &tab1, &taw2, &tab2, &exw1, &exb1, &exw2, &exb2,
        &supw, &supb, &ffwf, &ffkw, &ffab, &fltw, &fltk, &fltb,
        &lns, &lnb, &beta, &t1, &t2, &t3, &tb1, &tb2, &tb3};
    for (const T** f : fields) *f = (const T*)p[i++];
  }
};

// Sum of v over the block; every thread gets the total.
__device__ inline float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = lane < NWARPS ? red[lane] : 0.f;
  return warp_sum(r);
}

__device__ inline float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float r = lane < NWARPS ? red[lane] : -INFINITY;
  return warp_max(r);
}

// Masked softmax over at most THREADS entries held one per thread; an
// all-masked row gives 0. Returns this thread's weight.
__device__ inline float block_masked_softmax(float x, bool valid,
                                             float* red) {
  const float m = block_max(valid ? x : -INFINITY, red);
  const float e = valid ? expf(x - m) : 0.f;
  const float s = block_sum(e, red);
  return e / fmaxf(s, 1e-30f);
}

// C[M, N] = A @ B with A(m, k) = A[m * sam + k * sak] and B(k, n) =
// B[k * sbk + n * sbn]; epi(m, n, acc) per output. RA / RB round the
// operand to T as it is loaded (the JAX kernels' .astype(dt) before a
// dot); for operands already in T it changes nothing. Tiles As [BK][BM+1]
// and Bs [BK][BN] are in shared memory. Called by the whole block;
// returns after a barrier.
template <typename T, bool RA, bool RB, typename TA, typename TB,
          typename Epi>
__device__ void gemm(const TA* A, long sam, long sak, const TB* Bm, long sbk,
                     long sbn, int M, int K, int N, float* As, float* Bs,
                     Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int m0 = 0; m0 < M; m0 += BM) {
    for (int n0 = 0; n0 < N; n0 += BN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < K; k0 += BK) {
        for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
          const int mm = i / BK, kk = i % BK;
          const int m = m0 + mm, k = k0 + kk;
          float v = 0.f;
          if (m < M && k < K) {
            v = to_f(A[m * sam + k * sak]);
            if (RA) v = rd<T>(v);
          }
          As[kk * (BM + 1) + mm] = v;
        }
        for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
          const int kk = i / BN, nn = i % BN;
          const int k = k0 + kk, n = n0 + nn;
          float v = 0.f;
          if (k < K && n < N) {
            v = to_f(Bm[k * sbk + n * sbn]);
            if (RB) v = rd<T>(v);
          }
          Bs[kk * BN + nn] = v;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[kk * (BM + 1) + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[kk * BN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
    }
  }
  __syncthreads();
}

// out[n] = sum over segments s of (x_s[0:K] @ W[s*K:(s+1)*K, n]), the
// segment dots summed left to right in float32 (the JAX kernel's
// dot(va, W[:H]) + dot(vb, W[H:]) form). Each thread owns columns n.
template <typename T, typename Epi>
__device__ void vecmat(const float* x0, const float* x1, const float* x2,
                       const T* W, int K, int N, Epi epi) {
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float y = 0.f;
    const float* xs[3] = {x0, x1, x2};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (xs[s] == nullptr) break;
      const float* x = xs[s];
      const T* w = W + (size_t)s * K * N + n;
      float acc = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) acc = fmaf(x[k], to_f(w[(size_t)k * N]), acc);
      y = s == 0 ? acc : y + acc;
    }
    epi(n, y);
  }
}

}  // namespace mega
}  // namespace stair
