// Device helpers shared by the executor's forward (mega_exec.cu) and
// backward (mega_grad.cu) kernels: the instruction layout and opcodes, the
// argument table of ops/mega_exec.py prepare_args, block reductions, and
// the block-wide matrix products. Both kernels use the same products with
// the same loop order, so the backward recomputes the forward's values bit
// for bit (relu boundaries and bf16 roundings then agree): gemm (the
// training forward's own) and gemm_rows (the same chains on a faster
// tiling, for the backward's tensor-core route). tc_gemm runs the products
// whose operands are exact in bf16 on the tensor cores, where the order of
// the sums may change.
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
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;

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

// gemm_rows: gemm's products with gemm's bits. Each output keeps gemm's
// chain exactly: acc = fmaf(a_k, b_k, acc) for k ascending from 0, a_k and
// b_k rounded to T where RA / RB say, the same epilogue. Only the tiling
// differs: GR_BM x GR_BN outputs a pass, GR_TM x GR_TN a thread (thread
// (ty, tx) = (tid / GR_NTX, tid % GR_NTX) owns rows GR_TM ty + i and
// columns 4 tx + j + (GR_BN / 2) (j / 4)), 16-deep k slices read from
// global memory as 16-byte vectors into registers one slice ahead,
// converted to float once and stored into a double buffer, one barrier a
// slice. A(m, k) = A[m * lda + k], B(k, n) = B[k * ldb + n]; K % 16 == 0,
// N % 8 == 0, rows 16-byte aligned. buf: GR_FLOATS floats, 16-byte
// aligned. Called by the whole block; returns after a barrier.
constexpr int GR_BM = 64;
constexpr int GR_BK = 16;
constexpr int GR_PAD = 4;
constexpr int GR_TM = 4;
constexpr int GR_TN = 4;
constexpr int GR_NTX = THREADS / (GR_BM / GR_TM);
constexpr int GR_BN = GR_NTX * GR_TN;
constexpr int GR_LDA = GR_BK + GR_PAD;
constexpr int GR_STAGE = GR_BM * GR_LDA + GR_BK * GR_BN;
constexpr int GR_FLOATS = 2 * GR_STAGE;

template <typename T, bool RA, bool RB, typename TA, typename TB,
          typename Epi>
__device__ void gemm_rows(const TA* A, long lda, const TB* Bm, long ldb,
                          int M, int K, int N, float* buf, Epi epi) {
  constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
  constexpr int NVA = GR_BM * GR_BK / VA;             // <= THREADS
  constexpr int NB = GR_BK * GR_BN / VB;              // B vectors a slice
  constexpr int NVB = (NB + THREADS - 1) / THREADS;   // a thread
  static_assert(NVA <= THREADS && (GR_TN == 4 || GR_TN == 8),
                "gemm_rows slice split");
  const int tid = threadIdx.x, ty = tid / GR_NTX, tx = tid % GR_NTX;
  uint4 ra = make_uint4(0, 0, 0, 0), rb[NVB];
  for (int m0 = 0; m0 < M; m0 += GR_BM) {
    for (int n0 = 0; n0 < N; n0 += GR_BN) {
      auto fetch = [&](int k0) {
        if (tid < NVA) {
          const int r = tid / (GR_BK / VA), c = tid % (GR_BK / VA);
          ra = m0 + r < M ? *reinterpret_cast<const uint4*>(
                                A + (m0 + r) * lda + k0 + c * VA)
                          : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int j = 0; j < NVB; ++j) {
          const int p = tid + j * THREADS;
          const int r = p / (GR_BN / VB), c = p % (GR_BN / VB);
          if (p < NB)
            rb[j] = n0 + c * VB < N ? *reinterpret_cast<const uint4*>(
                                          Bm + (long)(k0 + r) * ldb + n0 +
                                          c * VB)
                                    : make_uint4(0, 0, 0, 0);
        }
      };
      auto stash = [&](int s) {
        float* As = buf + s * GR_STAGE;
        float* Bs = As + GR_BM * GR_LDA;
        if (tid < NVA) {
          const int r = tid / (GR_BK / VA), c = tid % (GR_BK / VA);
          const TA* e = reinterpret_cast<const TA*>(&ra);
#pragma unroll
          for (int i = 0; i < VA; ++i) {
            float v = to_f(e[i]);
            if (RA) v = rd<T>(v);
            As[r * GR_LDA + c * VA + i] = v;
          }
        }
#pragma unroll
        for (int j = 0; j < NVB; ++j) {
          const int p = tid + j * THREADS;
          if (p >= NB) break;
          const int r = p / (GR_BN / VB), c = p % (GR_BN / VB);
          const TB* e = reinterpret_cast<const TB*>(&rb[j]);
#pragma unroll
          for (int i = 0; i < VB; ++i) {
            float v = to_f(e[i]);
            if (RB) v = rd<T>(v);
            Bs[r * GR_BN + c * VB + i] = v;
          }
        }
      };
      float acc[GR_TM][GR_TN];
#pragma unroll
      for (int i = 0; i < GR_TM; ++i)
#pragma unroll
        for (int j = 0; j < GR_TN; ++j) acc[i][j] = 0.f;
      fetch(0);
      stash(0);
      __syncthreads();
      const int ns = K / GR_BK;
      for (int s = 0; s < ns; ++s) {
        const bool more = s + 1 < ns;
        if (more) fetch((s + 1) * GR_BK);
        const float* As = buf + (s & 1) * GR_STAGE;
        const float* Bs = As + GR_BM * GR_LDA;
#pragma unroll
        for (int kq = 0; kq < GR_BK; kq += 4) {
          float4 a4[GR_TM];
#pragma unroll
          for (int i = 0; i < GR_TM; ++i)
            a4[i] = *reinterpret_cast<const float4*>(
                As + (ty * GR_TM + i) * GR_LDA + kq);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float b[GR_TN];
#pragma unroll
            for (int h = 0; h < GR_TN / 4; ++h) {
              const float4 b4 = *reinterpret_cast<const float4*>(
                  Bs + (kq + kk) * GR_BN + h * (GR_BN / 2) + tx * 4);
              b[4 * h] = b4.x;
              b[4 * h + 1] = b4.y;
              b[4 * h + 2] = b4.z;
              b[4 * h + 3] = b4.w;
            }
#pragma unroll
            for (int i = 0; i < GR_TM; ++i) {
              const float a = reinterpret_cast<const float*>(&a4[i])[kk];
#pragma unroll
              for (int j = 0; j < GR_TN; ++j)
                acc[i][j] = fmaf(a, b[j], acc[i][j]);
            }
          }
        }
        if (more) stash((s + 1) & 1);
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < GR_TM; ++i)
#pragma unroll
        for (int j = 0; j < GR_TN; ++j) {
          const int m = m0 + ty * GR_TM + i;
          const int n = n0 + (j / 4) * (GR_BN / 2) + tx * 4 + j % 4;
          if (m < M && n < N) epi(m, n, acc[i][j]);
        }
    }
  }
  __syncthreads();
}

// vecmat_rows: vecmat's outputs with vecmat's bits (each column's chain
// acc = fmaf(x_k, W[k, n], acc), k ascending from 0 per segment, the
// segments summed left to right), for the tensor-core walk's recompute:
// thread t owns the column pair 2t, 2t + 1 and reads both weights as one
// 4-byte vector a row, with many rows in flight. N even.
template <typename Epi>
__device__ void vecmat_rows(const float* x0, const float* x1, const float* x2,
                            const __nv_bfloat16* W, int K, int N, Epi epi) {
  for (int n = 2 * threadIdx.x; n < N; n += 2 * THREADS) {
    float y0 = 0.f, y1 = 0.f;
    const float* xs[3] = {x0, x1, x2};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (xs[s] == nullptr) break;
      const float* x = xs[s];
      const __nv_bfloat162* w =
          reinterpret_cast<const __nv_bfloat162*>(W + (size_t)s * K * N + n);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 16
      for (int k = 0; k < K; ++k) {
        const float2 f = __bfloat1622float2(w[(size_t)k * (N / 2)]);
        a0 = fmaf(x[k], f.x, a0);
        a1 = fmaf(x[k], f.y, a1);
      }
      y0 = s == 0 ? a0 : y0 + a0;
      y1 = s == 0 ? a1 : y1 + a1;
    }
    epi(n, y0);
    epi(n + 1, y1);
  }
}

// An elementwise pass over n elements, value(i) then store(i, v), with
// BATCH elements a thread computed (their loads in flight together) before
// any is stored: the stores may alias the loads' arrays, so a plain loop
// waits for each element's loads in turn. Batched only where BATCHED.
constexpr int PASS_BATCH = 8;

template <bool BATCHED, typename V, typename S>
__device__ __forceinline__ void pass(size_t n, V value, S store) {
  constexpr int BATCH = PASS_BATCH;
  if constexpr (BATCHED) {
    for (size_t i0 = threadIdx.x; i0 < n; i0 += (size_t)BATCH * THREADS) {
      float v[BATCH];
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const size_t i = i0 + (size_t)j * THREADS;
        v[j] = i < n ? value(i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const size_t i = i0 + (size_t)j * THREADS;
        if (i < n) store(i, v[j]);
      }
    }
  } else {
    for (size_t i = threadIdx.x; i < n; i += THREADS) store(i, value(i));
  }
}

// tc_gemm: C[M, N] = A @ B on the tensor cores (mma.sync m16n8k16, bf16 in,
// float32 sums), for products whose operands are both exact in bf16. A is
// bf16 in shared memory, row m at As + m * lda (lda % 8 == 0, rows 16-byte
// aligned; M <= 64, M % 16 == 0). B is bf16 in global memory (read-only
// weights): B(k, n) = W[k * ldw + n] (NK false) or W[n * ldw + k] (NK
// true); K % TC_BK == 0, N % 8 == 0. The (BN-column chunk, TC_BK-deep
// slice) pairs run as one sequence through a TC_STAGES-stage cp.async ring
// (ring: tc_ring<BN>() bf16, 16-byte aligned), two slices in flight ahead
// of the one in use, across chunk boundaries too; one barrier a slice.
// Warp w owns MT row tiles of 16 (rows 16 MT (w % WM)) and columns 32 (w /
// WM) of a chunk: BN / 32 warps across, WM down. BN 64 (one row tile a
// warp) needs fewer registers than BN 128 (two), which reads B fragments
// for two row tiles at once.
// epi(m, n, acc) per output. Called by the whole block; returns after a
// barrier.
constexpr int TC_BK = 64;
constexpr int TC_BN = 64;
constexpr int TC_PAD = 8;
constexpr int TC_STAGES = 3;

// bf16 elements of tc_gemm's ring at chunk width BN
template <int BN>
__host__ __device__ constexpr int tc_ring() {
  return TC_STAGES * BN * (TC_BK + TC_PAD);   // >= TC_BK * (BN + TC_PAD)
}

template <bool NK, int BN = TC_BN, typename Epi>
__device__ void tc_gemm(const __nv_bfloat16* As, int lda,
                        const __nv_bfloat16* W, long ldw, int M, int K, int N,
                        __nv_bfloat16* ring, Epi epi) {
  using bf16 = __nv_bfloat16;
  constexpr int STAGE = BN * (TC_BK + TC_PAD), WM = 8 / (BN / 32),
                MT = 4 / WM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int lr = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  const int nk = K / TC_BK, nc = (N + BN - 1) / BN, total = nk * nc;
  auto load = [&](int it) {
    bf16* d = ring + (it % TC_STAGES) * STAGE;
    const int n0 = (it / nk) * BN, k0 = (it % nk) * TC_BK;
    for (int p = tid; p < TC_BK * BN / 8; p += THREADS) {
      if (NK) {   // stage [n][TC_BK + TC_PAD]
        const int r = p / (TC_BK / 8), c = p % (TC_BK / 8);
        const bool in = n0 + r < N;
        cp_async16(d + r * (TC_BK + TC_PAD) + c * 8,
                   W + (in ? (long)(n0 + r) * ldw + k0 + c * 8 : 0), in);
      } else {    // stage [k][BN + TC_PAD]
        const int r = p / (BN / 8), c = p % (BN / 8);
        const bool in = n0 + c * 8 < N;
        cp_async16(d + r * (BN + TC_PAD) + c * 8,
                   W + (in ? (long)(k0 + r) * ldw + n0 + c * 8 : 0), in);
      }
    }
    cp_async_commit();
  };
  float acc[MT][4][4];
  load(0);
  if (total > 1) load(1);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();   // slice it landed; slice it - 1's stage is free
    if (it + 2 < total) load(it + 2);
    const int n0 = (it / nk) * BN, ks = it % nk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
    const bf16* st = ring + (it % TC_STAGES) * STAGE;
    const bool active = n0 + wn * 32 < N;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      if (!active) break;
      uint32_t b[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (NK)
          ldmatrix_x4(b[jj], st + (wn * 32 + jj * 16 + q2 * 8 + lr) *
                                      (TC_BK + TC_PAD) + kk + q1 * 8);
        else
          ldmatrix_x4_trans(b[jj], st + (kk + q1 * 8 + lr) * (BN + TC_PAD) +
                                       wn * 32 + jj * 16 + q2 * 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = (wm * MT + mt) * 16;
        if (r0 >= M) continue;
        uint32_t a[4];
        ldmatrix_x4(a, As + (r0 + (lane & 15)) * lda + ks * TC_BK + kk +
                           (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[mt][j], a, b[j / 2][(j % 2) * 2],
                   b[j / 2][(j % 2) * 2 + 1]);
      }
    }
    if (ks == nk - 1 && active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = (wm * MT + mt) * 16 + (lane >> 2);
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn * 32 + j * 8 + 2 * (lane & 3);
          if (n < N) {
            epi(m, n, acc[mt][j][0]);
            epi(m, n + 1, acc[mt][j][1]);
            epi(m + 8, n, acc[mt][j][2]);
            epi(m + 8, n + 1, acc[mt][j][3]);
          }
        }
      }
    }
  }
  __syncthreads();
}

}  // namespace mega
}  // namespace stair
