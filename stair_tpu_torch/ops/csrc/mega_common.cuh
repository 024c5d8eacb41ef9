// Device helpers shared by the executor's forward (mega_exec.cu) and
// backward (mega_grad.cu, mega_grad_tc.cu) kernels: the instruction layout
// and opcodes, the argument table of ops/mega_exec.py prepare_args, block
// reductions, and the block-wide matrix products. Each backward recomputes
// its route's training forward bit for bit (relu boundaries and bf16
// roundings then agree) by calling the forward's own product code: gemm
// and vecmat on the general route (mega_exec_kernel and mega_grad.cu), and
// on the tensor-core route tc_gemm (fwd_gemm in mega_exec_tc_kernel,
// walk_gemm in the walk: the same k steps and fragments, another chunk
// width) and vecmat_tc in both. stair_mega_recompute_check holds each pair
// equal on the card.
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

// Rows of a [M, K] bf16 matrix in global memory (row stride K, K % 8 ==
// 0, 16-byte aligned) into a shared-memory tile of row stride ld, four
// 16-byte vectors a thread in flight. Called by the whole block; returns
// after a barrier.
__device__ inline void load_tile(__nv_bfloat16* dst, int ld,
                                 const __nv_bfloat16* src, int M, int K) {
  const int per = K / 8, n = M * per;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n)
        v[j] = *reinterpret_cast<const uint4*>(src + (size_t)(i / per) * K +
                                               (i % per) * 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(i / per) * ld +
                                  (i % per) * 8) = v[j];
    }
  }
  __syncthreads();
}

// The executor's [M, K] @ [K, N] products on the tensor-core route, one
// definition for the training forward and the walk that recomputes it:
// B(k, n) = W[k * N + n] (bf16, read-only), epi(m, n, acc) per output.
//
// fwd_gemm: as mega_exec_tc_kernel (#4, #5) runs them, A a bf16 tile in
// shared memory (row stride K + TC_PAD), chunks of FWD_BN columns (two row
// tiles a warp), the ring apart.
// walk_gemm (below, with the row-slice mode): as mega_bwd_tc_kernel (#6)
// recomputes them, A bf16 rows in global memory (a register file or a
// record), staged into a tile with the ring after it, chunks of TC_BN
// columns (one row tile a warp: the walk is short of registers).
// Each output takes the same k steps in the same order with its operands in
// the same fragment positions (row tiles start at multiples of 16, column
// tiles at multiples of 8 in both), so the two give the same bits;
// stair_mega_recompute_check shows it on the card.
constexpr int FWD_BN = 128;

template <typename Epi>
__device__ void fwd_gemm(const __nv_bfloat16* As, const __nv_bfloat16* W,
                         int M, int K, int N, __nv_bfloat16* ring, Epi epi) {
  tc_gemm<false, FWD_BN>(As, K + TC_PAD, W, N, M, K, N, ring, epi);
}

// All threads of the cluster's CTAs: every write before it, to shared or
// global memory, is visible to every thread after it (release / acquire at
// cluster scope).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The tensor-core route's row-slice mode (F above TC_MAX_F, or not a multiple
// of 16): every [F, H] @ [H, H] product runs over slices of at most TC_MAX_F
// rows, each staged into one bf16 [rows, K + TC_PAD] tile in shared memory
// with its rows padded by zeros to whole 16-row mma tiles; the padded rows'
// outputs reach no epilogue. An output row's sum is the same k steps on the
// same fragments in any slice (row tiles start at multiples of 16 in each),
// so a slice gives the bits of the whole-tile product.

// rows of the staging tile of the row-slice mode at F frames
__host__ __device__ constexpr int tc_slice_rows(int F) {
  return F < TC_MAX_F ? (F + 15) & ~15 : TC_MAX_F;
}

// Rows [0, rows) of A (row stride lda: bf16, or float32 rounded to bf16 as it
// is staged, the walk's rd(dY)) into dst (row stride ld), rows [rows,
// pad16(rows)) zeroed. K % 8 == 0, rows 16-byte aligned. Called by the whole
// block; returns after a barrier.
__device__ inline void stage_rows(__nv_bfloat16* dst, int ld,
                                  const __nv_bfloat16* src, long lds,
                                  int rows, int K) {
  const int per = K / 8, n = ((rows + 15) & ~15) * per;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * THREADS) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * THREADS, r = i / per;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && r < rows)
        v[j] = *reinterpret_cast<const uint4*>(src + r * lds + (i % per) * 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * THREADS;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + (size_t)(i / per) * ld +
                                  (i % per) * 8) = v[j];
    }
  }
  __syncthreads();
}

__device__ inline void stage_rows(__nv_bfloat16* dst, int ld,
                                  const float* src, long lds, int rows,
                                  int K) {
  const int per = K / 4, n = ((rows + 15) & ~15) * per;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / per, c = i % per;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) v = *reinterpret_cast<const float4*>(src + r * lds + c * 4);
    __nv_bfloat162* d =
        reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c * 4);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  __syncthreads();
}

// An example's cluster in the row-slice mode: C CTAs, CTA r = blockIdx.x % C
// owning the rows [r R, min(F, (r + 1) R)) of every [F, H] product, R =
// tc_cta_rows(F, C) (a multiple of 16); a CTA walks its rows in slices of
// TC_MAX_F. Forced C from 1 to 8 (tests, scripts), else the launch's pick,
// tc_cluster (ops/mega_exec.py tc_cluster mirrors it).
__host__ __device__ constexpr int tc_cta_rows(int F, int C) {
  return ((F + C - 1) / C + 15) & ~15;
}

// slices of TC_MAX_F rows at F frames
__host__ __device__ constexpr int tc_slice_count(int F) {
  return (F + TC_MAX_F - 1) / TC_MAX_F;
}

// The launch's cluster size for B examples at F frames on a card of
// `slots` CTA slots (its SMs x the kernel's CTAs an SM: one): one CTA a
// slice while B such clusters fit one wave of slots, else 2 while B
// clusters of 2 do, else one CTA an example (every slice on it). On an
// H100 at F 150 (scripts/tc_clusters.py): clusters of 3 took #5 2.29 ms
// and the walk 6.48 at B 32 (one CTA 2.88, 8.62), clusters of 2 2.53 and
// 8.21 at B 64 (3: 2.90, 10.16; one CTA 2.92, 9.32), one CTA 2.96 and
// 10.37 at B 128 (2: 3.73, 14.61): the lead's passes stay whole, so a CTA
// that waits at a barrier while another example could run is lost.
__host__ __device__ constexpr int tc_cluster(int B, int F, int slots) {
  return B * tc_slice_count(F) <= slots
             ? tc_slice_count(F)
             : (tc_slice_count(F) > 2 && 2 * B <= slots ? 2 : 1);
}

// prod(m0, rows) on each slice [m0, m0 + rows) of this CTA's rows, between
// two cluster barriers (C > 1): the cluster's earlier writes (the lead's
// operand rows, whatever the epilogues read) are visible to the product, and
// its outputs to every CTA after it. Called by every CTA of the cluster.
template <typename Prod>
__device__ __forceinline__ void tc_slices(int F, int C, Prod prod) {
  if (C > 1) cluster_barrier();
  const int R = tc_cta_rows(F, C), r = (int)(blockIdx.x % C);
  const int end = F < (r + 1) * R ? F : (r + 1) * R;
  for (int m0 = r * R; m0 < end; m0 += TC_MAX_F)
    prod(m0, end - m0 < TC_MAX_F ? end - m0 : TC_MAX_F);
  if (C > 1) cluster_barrier();
}

// fwd_rows: fwd_gemm in the row-slice mode; walk_gemm: the walk's products
// at every F. Both on rows [0, rows) of A (bf16 rows in global memory, row
// stride lda; rows <= TC_MAX_F), staged into tile [pad16(rows), K + TC_PAD]
// (zero rows past rows) with tc_gemm's ring apart (fwd_rows) or after the
// tile (walk_gemm); epi(m, n, acc) for m < rows only. Each output row keeps
// fwd_gemm's k steps and fragments in both, so both give its bits.
template <typename Epi>
__device__ void fwd_rows(const __nv_bfloat16* A, long lda,
                         const __nv_bfloat16* W, int rows, int K, int N,
                         __nv_bfloat16* tile, __nv_bfloat16* ring, Epi epi) {
  stage_rows(tile, K + TC_PAD, A, lda, rows, K);
  fwd_gemm(tile, W, (rows + 15) & ~15, K, N, ring,
           [&](int m, int n, float acc) {
             if (m < rows) epi(m, n, acc);
           });
}

template <typename Epi>
__device__ void walk_gemm(const __nv_bfloat16* A, long lda,
                          const __nv_bfloat16* W, int rows, int K, int N,
                          __nv_bfloat16* tile, Epi epi) {
  const int ld = K + TC_PAD, M = (rows + 15) & ~15;
  stage_rows(tile, ld, A, lda, rows, K);
  tc_gemm<false, TC_BN>(tile, ld, W, N, M, K, N, tile + (size_t)M * ld,
                        [&](int m, int n, float acc) {
                          if (m < rows) epi(m, n, acc);
                        });
}

// float slots of vecmat_tc's k-split partials
constexpr int TC_PARTS = THREADS * 8;

// vecmat_tc: the tensor-core route's vec-level products (the forward's and
// the walk's recompute, so one set of bits): out[n] = sum over segments s
// of x_s[0:K] @ W[s*K:(s+1)*K, n], x_s float32 (shared memory), W bf16.
// Thread t reads the 16-byte vectors W[k, 8g .. 8g + 7] of column group g
// = t % G (G = N / 8, N % 8 == 0) for the k of its split q = t / G, so a
// warp reads contiguous rows of W; the splits' partials meet in part
// (TC_PARTS floats) and are summed in split order. Called by the whole
// block; returns after a barrier.
template <typename Epi>
__device__ void vecmat_tc(const float* x0, const float* x1, const float* x2,
                          const __nv_bfloat16* W, int K, int N, float* part,
                          Epi epi) {
  const int G = N / 8, S = THREADS / G;
  const int g = threadIdx.x % G, q = threadIdx.x / G;
  if (q < S) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    const float* xs[3] = {x0, x1, x2};
    const int ck = (K + S - 1) / S, kb = q * ck;
    const int ke = K < kb + ck ? K : kb + ck;
    for (int s = 0; s < 3 && xs[s] != nullptr; ++s) {
      const float* x = xs[s];
      const __nv_bfloat16* w = W + (size_t)s * K * N + g * 8;
#pragma unroll 8
      for (int k = kb; k < ke; ++k) {
        const uint4 v = *reinterpret_cast<const uint4*>(w + (size_t)k * N);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
        const float xk = x[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          acc[2 * i] = fmaf(xk, f.x, acc[2 * i]);
          acc[2 * i + 1] = fmaf(xk, f.y, acc[2 * i + 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) part[q * N + g * 8 + i] = acc[i];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += THREADS) {
    float y = 0.f;
    for (int qq = 0; qq < S; ++qq) y += part[qq * N + n];
    epi(n, y);
  }
  __syncthreads();
}

// gemm32: the float32 products of the "fma32" route (mega_exec_kernel<float,
// true>, #4 and #5, and mega_bwd_kernel<float, true>, #6's walk), gemm's
// contract and arithmetic on Hopper-shaped tiles. C[M, N] = A @ B with
// A(m, k) = A[m * lda + k] and B(k, n) = W[k * ldw + n] (NK false) or
// W[n * ldw + k] (NK true: the walk's dY @ W^T); A and W float32, 16-byte
// aligned, lda % 4 == 0, ldw % 4 == 0; M <= MAX_F, K % 4 == 0, and N % 4 ==
// 0 where NK is false (NK true reads B by rows of W: any N).
//
// Exactness: every output is gemm's one FMA chain, acc = fmaf(a[k], b[k],
// acc) from 0.f over ascending k, and no k at or past K enters it, so
// gemm32 returns gemm's bits on any operands and every value the float32
// forward writes is unchanged (stair_mega_f32_product_check holds the two
// equal on the card).
//
// Feeding: G32_BM x BN output tiles, G32_BK-deep k slices; the (row tile,
// column tile, k slice) triples, row tiles outermost, run as one sequence
// through a G32_STAGES-stage cp.async ring of A and B tiles (ring:
// g32_ring<NK, BN>() floats, 16-byte aligned), two slices in flight ahead of
// the one in use, across tile boundaries too; one barrier a slice. The last
// row tile may be ragged: its rows at or past M load as zeros and reach no
// epilogue. At M <= G32_BM the sequence is the one row tile's. Thread (ty,
// tx) = (tid / 16, tid % 16) keeps its 4 x BN / 16 sums in registers: rows
// m0 + ty + 16 i of the row tile at m0 and columns 64 (j / 4) + 4 tx + j % 4
// (NK false: B read as float4 along a row of W) or tx + 16 j (NK true: B
// read as float4 along k of a row of W, the tile rows padded by G32_PAD so
// that 16 rows meet no bank conflict). A is read as float4 along k. epi(m,
// n, acc) per output. Called by the whole block; returns after a barrier.
constexpr int G32_BM = 64;
constexpr int G32_BN = 128;
constexpr int G32_BK = 32;
constexpr int G32_PAD = 4;
constexpr int G32_STAGES = 3;
// the column tile of the walk's gemm32 calls (mega_grad.cu prod): 4 x 4
// sums a thread, so that the walk (247 registers on gemm) holds every value
// in registers; at 4 x 8 ptxas spills it
constexpr int G32_WALK_BN = 64;

// floats of one ring stage: the A tile [G32_BM][G32_BK + G32_PAD], then B
// as [G32_BK][BN] (NK false) or [BN][G32_BK + G32_PAD] (NK true)
template <bool NK, int BN = G32_BN>
__host__ __device__ constexpr int g32_stage() {
  return G32_BM * (G32_BK + G32_PAD) +
         (NK ? BN * (G32_BK + G32_PAD) : G32_BK * BN);
}

// floats of gemm32's ring (NK true also holds the NK false stages)
template <bool NK, int BN = G32_BN>
__host__ __device__ constexpr int g32_ring() {
  return G32_STAGES * g32_stage<NK, BN>();
}

__device__ __forceinline__ float f4_at(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

template <bool NK, int BN = G32_BN, typename Epi>
__device__ void gemm32(const float* A, int lda, const float* W, long ldw,
                       int M, int K, int N, float* ring, Epi epi) {
  static_assert(BN % 64 == 0 && THREADS == 256, "16 x 16 threads");
  constexpr int LDA = G32_BK + G32_PAD, AT = G32_BM * LDA;
  constexpr int STAGE = g32_stage<NK, BN>(), NJ = BN / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nk = (K + G32_BK - 1) / G32_BK, nc = (N + BN - 1) / BN;
  const int total = nk * nc * ((M + G32_BM - 1) / G32_BM);
  // slice it of the sequence: tile t = it / nk, row tile t / nc, column
  // tile t % nc, k slice it % nk
  auto load = [&](int it) {
    float* As = ring + (it % G32_STAGES) * STAGE;
    float* Bs = As + AT;
    const int t = it / nk, k0 = (it % nk) * G32_BK;
    const int m0 = (t / nc) * G32_BM, n0 = (t % nc) * BN;
    for (int p = tid; p < G32_BM * G32_BK / 4; p += THREADS) {
      const int r = m0 + p / (G32_BK / 4), c = (p % (G32_BK / 4)) * 4;
      const bool in = r < M && k0 + c < K;
      cp_async16(As + (r - m0) * LDA + c,
                 A + (in ? (long)r * lda + k0 + c : 0), in);
    }
    for (int p = tid; p < G32_BK * BN / 4; p += THREADS) {
      if (NK) {   // stage [n][k]
        const int r = p / (G32_BK / 4), c = (p % (G32_BK / 4)) * 4;
        const bool in = n0 + r < N && k0 + c < K;
        cp_async16(Bs + r * LDA + c,
                   W + (in ? (long)(n0 + r) * ldw + k0 + c : 0), in);
      } else {    // stage [k][n]
        const int r = p / (BN / 4), c = (p % (BN / 4)) * 4;
        const bool in = k0 + r < K && n0 + c < N;
        cp_async16(Bs + r * BN + c,
                   W + (in ? (long)(k0 + r) * ldw + n0 + c : 0), in);
      }
    }
    cp_async_commit();
  };
  float acc[4][NJ];
  load(0);
  if (total > 1) load(1);
  for (int it = 0; it < total; ++it) {
    if (it + 1 < total)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();   // slice it landed; slice it - 1's stage is free
    if (it + 2 < total) load(it + 2);
    const int t = it / nk, ks = it % nk;
    if (ks == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }
    const float* As = ring + (it % G32_STAGES) * STAGE;
    const float* Bs = As + AT;
    const int kn = K - ks * G32_BK;   // k of this slice: min(kn, G32_BK)
    // not unrolled: a 4-deep step is 128 FMAs, and one copy of it keeps the
    // walk's code (and its build) small; one float4 of B live at a time
#pragma unroll 1
    for (int k4 = 0; k4 < G32_BK; k4 += 4) {
      if (k4 >= kn) break;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (ty + 16 * i) * LDA +
                                                k4);
      if constexpr (NK) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              Bs + (tx + 16 * j) * LDA + k4);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][j] = fmaf(f4_at(a[i], q), f4_at(b, q), acc[i][j]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j4 = 0; j4 < NJ / 4; ++j4) {
            const float4 b = *reinterpret_cast<const float4*>(
                Bs + (k4 + q) * BN + 64 * j4 + 4 * tx);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int i = 0; i < 4; ++i)
                acc[i][4 * j4 + jj] = fmaf(f4_at(a[i], q), f4_at(b, jj),
                                           acc[i][4 * j4 + jj]);
          }
      }
    }
    if (ks == nk - 1) {
      const int m0 = (t / nc) * G32_BM, n0 = (t % nc) * BN;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + ty + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n0 + (NK ? tx + 16 * j : 64 * (j / 4) + 4 * tx + j % 4);
          if (n < N) epi(m, n, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();
}

// gemm32 on an example's cluster of C CTAs (the "fma32" kernels' cluster
// mode; C = 1: one CTA an example, gemm32 itself): CTA r = blockIdx.x % C
// computes the output columns [r N / C, (r + 1) N / C) over all M rows
// (gemm32 on W's columns from there, NK false, or its rows, NK true; W's
// row stride stays ldw), so each output keeps its FMA chain and its bits.
// epi(m, n, acc) gets the product's own column n. Between two cluster
// barriers (C > 1): the CTAs' earlier writes, of A and of whatever the
// epilogues read, are visible to the product, and its outputs to every CTA
// after it. r N / C is a multiple of 4 where NK is false (N = H and C
// divides H / G32_BN), so B's rows stay 16-byte aligned.
template <bool NK, int BN = G32_BN, typename Epi>
__device__ __forceinline__ void gemm32_part(const float* A, int lda,
                                            const float* W, long ldw, int M,
                                            int K, int N, int C, float* ring,
                                            Epi epi) {
  if (C > 1) cluster_barrier();
  const int r = (int)(blockIdx.x % C);
  const int c0 = r * N / C, n = (r + 1) * N / C - c0;
  gemm32<NK, BN>(A, lda, W + (NK ? c0 * ldw : (long)c0), ldw, M, K, n, ring,
                 [&](int m, int j, float acc) { epi(m, c0 + j, acc); });
  if (C > 1) cluster_barrier();
}

// The "fma32" kernels' cluster mode (mega_exec_kernel<float, true>, #4 and
// #5, and mega_grad.cu's walk mega_bwd_kernel<float, true>, #6). Each holds
// one CTA an SM (ptxas gives them 254-255 registers a thread), so a launch
// of B examples, one CTA each, leaves all but B of the card's SMs idle.
// Below that, example b runs on a thread-block cluster of C CTAs, b's CTAs
// blockIdx.x = b C .. b C + C - 1: CTA r computes the columns [r N / C,
// (r + 1) N / C) of every [F, H]-sized product (gemm32_part), over all of
// F's row tiles, so that each output keeps its FMA chain and every file,
// gradient and recomputed value stays bit for bit the one-CTA route's. CTA
// 0, the lead, runs everything else (the row passes, the vec-level
// products, the softmaxes, every register-file write but the products'
// other columns) on the rows the cluster shares through the per-example
// workspace in L2; the others wait at the products' cluster barriers. So a
// product's serial time on one SM is cut by C and the rest is not.
//
// C: H / G32_BN while one wave of CTAs holds the launch at that size (B C
// <= slots, the card's SMs x the kernel's CTAs an SM), else 2 while it
// holds it at 2 (2 a proper divisor of H / G32_BN), else 1: the largest
// cluster that runs the launch in one wave, each size only where its
// clusters fit the card at all (fit_h, fit_2: cudaOccupancyMaxActiveClusters
// at H / G32_BN and at 2; 0 where the size is not a candidate). The slots
// and not the clusters that fit bound B: on an H100 (132 slots) 30 clusters
// of 4 fit by cudaOccupancyMaxActiveClusters, yet at B 31-33 clusters of 4
// take no longer than at 30 (their examples' runs differ in length, and a
// cluster starts where a shorter one ends) and beat clusters of 2 by 1.5x,
// as clusters of 2 beat 4 at B 64 and one CTA an example ties 2 at B 128
// (scripts/fma32_clusters.py). ops/mega_exec.py fma32_cluster mirrors it.
__host__ __device__ inline int mega32_cluster(int B, int H, int slots,
                                              int fit_2, int fit_h) {
  return fit_h > 0 && B * (H / G32_BN) <= slots
             ? H / G32_BN
             : (fit_2 > 0 && 2 * B <= slots ? 2 : 1);
}

// A launch of `ctas` CTAs of THREADS threads as clusters of c, `smem`
// bytes of dynamic shared memory each; `attr` holds its one attribute.
inline cudaLaunchConfig_t cluster_config(int ctas, int c, size_t smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `c` CTAs of `kernel` (THREADS threads, `smem` bytes of
// dynamic shared memory, set as its maximum first) that fit the current card
// at once, or 0.
template <typename K>
inline cudaError_t clusters_fit(K kernel, size_t smem, int c, int* fit) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(c, c, smem, 0, &attr);
  *fit = 0;
  return cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
}

// CTA slots of the current card for `kernel` at `smem` bytes of dynamic
// shared memory (set as its maximum first): its SMs x the CTAs an SM holds.
template <typename K>
inline cudaError_t cta_slots(K kernel, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  *slots = sms * per_sm;
  return e;
}

// The cluster size of a launch of B examples at width H: `cluster` itself
// where it is forced (> 0: it must divide H / G32_BN), else
// mega32_cluster's pick from the card's slots and fits.
template <typename K>
inline cudaError_t pick_cluster(K kernel, size_t smem, int B, int H,
                                int cluster, int* C) {
  const int most = H / G32_BN;
  if (cluster > 0) {
    *C = cluster;
    return most % cluster == 0 && cluster <= 8 ? cudaSuccess
                                               : cudaErrorInvalidValue;
  }
  int slots = 0, fit_2 = 0, fit_h = 0;
  cudaError_t e = cta_slots(kernel, smem, &slots);
  if (e == cudaSuccess && most > 1)
    e = clusters_fit(kernel, smem, most, &fit_h);
  if (e == cudaSuccess && most > 2 && most % 2 == 0)
    e = clusters_fit(kernel, smem, 2, &fit_2);
  *C = mega32_cluster(B, H, slots, fit_2, fit_h);
  return e;
}

// Launches `kernel(args...)` on B examples (or tiles), C CTAs each, as
// thread-block clusters of C (C = 1 too).
template <typename K, typename... A>
inline cudaError_t launch_clusters(K kernel, int B, int C, size_t smem,
                                   cudaStream_t stream, const A&... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(B * C, C, smem, stream,
                                                &attr);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace mega
}  // namespace stair
