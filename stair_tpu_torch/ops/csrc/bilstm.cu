// Masked bidirectional LSTM recurrence: forward (eval and training) and
// backward.
//
// The forward replaces the TPU kernel stair_tpu/ops/lstm.py _bilstm_kernel,
// reached through _forward_call: train=False (bilstm_pallas) and train=True
// (bilstm_pallas_train, which also stores the float32 post-mask h/c state
// stacks as residuals). The backward replaces _bilstm_bwd_kernel, reached
// through _backward_call. The input
// projection xp = x @ wi is hoisted out (a plain matmul, ops/lstm.py
// _prep); this kernel runs only the [Bt, h] @ [h, 4h] recurrent product and
// the gate math, for both directions in one launch.
//
// Design. Grid (ceil(B / BT), 2): one block per tile of BT batch rows and
// direction; the backward direction walks positions L-1 .. 0 and writes
// each token row at its original position. The block keeps the carried h
// and c of its BT rows in shared memory (float32), plus the matmul operand
// h (rounded to wh's dtype, as the JAX kernel's h.astype(wh.dtype)) in a
// ping-pong pair: threads read all of h_{t-1} from one buffer and write
// h_t to the other, with one barrier per step. Each thread owns hidden
// units j and computes their four gate dots; the weight columns j, j+h,
// j+2h, j+3h are coalesced across threads. Masked steps carry state;
// tokens are zeroed there; the float32 final carries are the sentence
// feature.
//
// What bounds the forward on an H100: the 64-step (video) sequential
// dependence, and wh — [h, 4h], 512 KB per direction in bf16 at h = 256 —
// which is above one block's 227 KB of shared memory, so every block
// streams it from L2 (50 MB) at every step. Gate dots run on the CUDA
// cores in float32. The backward's cluster route below keeps wh on chip;
// the forward gets the same design in a later change.
//
// Training forward: the same kernel also writes the post-mask h and c of
// every step ([B, L, h] float32 per direction, in position order for both
// directions), the JAX kernel's residuals.
//
// Backward, two routes. The sequential dependence of the adjoint walk is
// only dh <- dh (1 - valid) + dgates wh^T (and dc's elementwise update);
// the gate recompute reads the stored h_{t-1} and nothing of the walk.
//
// Cluster route (bf16, h a multiple of 64 up to TC_MAX_H; the main path's
// h = 256): bilstm_bwd_tc_kernel, then bilstm_dwh_tc_kernel and
// bilstm_dwh_sum_kernel. What bounds the general route below on an H100 is
// wh: 512 KB per direction at h = 256, above one block's 227 KB, streamed
// from L2 twice per step by each of only ceil(B / 8) x 2 blocks (32 at
// B = 128), through float32 FMA loops. This route keeps wh on chip across
// a thread-block cluster of TC_CLUSTER = 4 CTAs per (8-row batch tile,
// direction): CTA c owns hidden units [c U, c U + U), U = h / 4, and their
// four gate columns, and loads its [h, h] slice of wh (128 KB) into shared
// memory once for the whole walk. At B = 128 the grid is 16 x 4 x 2 = 128
// CTAs, one wave. Per step each CTA:
//  (a) recomputes its gate columns h_{t-1} wh[:, cols] for the 8 rows on
//      the tensor cores (mma.sync m16n8k16, the batch rows as the n8 side,
//      wh^T through ldmatrix .trans), from h_{t-1} rounded to wh's dtype as
//      the JAX kernel's hp.astype(wh.dtype). The recompute sits inside the
//      walk rather than in a parallel pass over all B L rows before it:
//      the wh slice is already on chip, so it costs no device-memory
//      traffic (a pre-pass would write and read back a float32 [B, L, 4h]
//      per direction, 64 MB for the video encoder), and its operands are
//      loaded a step ahead into registers, so their latency hides behind
//      the previous step. The gates equal the forward's up to the order of
//      the float32 sum over h (the forward sums in its own FMA loop), not
//      bit for bit;
//  (b) runs the elementwise adjoint at the forward's summation order
//      ((xp + bias) + h wh), writes dgates (rounded to xp's dtype) to dxp,
//      and keeps its dbias sums, dh and dc in registers;
//  (c) forms its partial dgates[:, cols] wh[:, cols]^T, [8, h] in float32,
//      on the tensor cores, into one of two partial buffers;
//  (d) after one cluster barrier, reads the four partials of its own units
//      from its peers' shared memory (distributed shared memory) and adds
//      them in rank order 0..3, so the bits never depend on scheduling.
// Masked steps and rows past B add zero partials; a final cluster barrier
// keeps every CTA resident until its peers have read it. dbias is summed
// per CTA over its 8 rows in order. dwh = sum over (b, t) of
// rd(h_{t-1})^T dgates is bilstm_dwh_tc_kernel: mma.sync on 64 x 128
// output tiles over DW_SPLIT slices of the B L rows, each slice a float32
// partial; bilstm_dwh_sum_kernel adds the slices in order and the dbias
// partials in tile order. No float atomics: two runs give the same bits.
//
// General route (float32, the exact route, and the shapes the cluster
// kernel refuses: h not a multiple of 64 or above TC_MAX_H):
// bilstm_bwd_kernel walks each direction's steps in reverse with the
// (dh, dc) adjoint of its BT rows in shared memory. It recomputes each
// step's gates from the stored h_{t-1} cast to wh's dtype with the
// forward's loop, so there the linearization point equals the forward's
// bit for bit, and writes dgates (rounded to xp's dtype) to dxp. The
// recurrent adjoint dgates @ wh^T reads wh by rows: each warp owns rows of
// wh, its lanes walk a row's 4h contiguous entries (coalesced) and a
// shuffle sum closes each dot. dbias is summed per block in shared memory
// (float32) and written as one partial per block. dwh = sum over (b, t) of
// h_{t-1}^T dgates, both in wh's dtype with float32 sums (the JAX kernel's
// rounding), is a second launch (bilstm_dwh_kernel): a tiled float32
// product over the stored h stack and dxp, which already holds dgates in
// wh's dtype (xp and wh share a dtype here). It walks the B*L rows in a
// fixed order and also sums the dbias partials in block order.

#include "common.cuh"

#include <cooperative_groups.h>

namespace {

using stair::cp_async16;
using stair::cp_async4;
using stair::cp_async_commit;
using stair::cp_async_wait;
using stair::from_f;
using stair::ldmatrix_x4;
using stair::ldmatrix_x4_trans;
using stair::mma_bf16;
using stair::pack_bf16;
using stair::rd;
using stair::sigmoid_f;
using stair::to_f;

constexpr int BT = 8;         // batch rows per block
constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bilstm_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
                  const float* __restrict__ mask, const T* __restrict__ wh_f,
                  const T* __restrict__ wh_b,
                  const float* __restrict__ bias_f,
                  const float* __restrict__ bias_b, T* __restrict__ tok_f,
                  T* __restrict__ tok_b, float* __restrict__ sent,
                  float* __restrict__ hst_f, float* __restrict__ cst_f,
                  float* __restrict__ hst_b, float* __restrict__ cst_b,
                  int B, int L, int h) {
  extern __shared__ float smem[];
  float* hs = smem;            // [BT][h] carried h
  float* cs = hs + BT * h;     // [BT][h] carried c
  float* cur = cs + BT * h;    // [BT][h] matmul operand, step t-1
  float* nxt = cur + BT * h;   // [BT][h] matmul operand, step t

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const T* xp = dir ? xp_b : xp_f;
  const T* wh = dir ? wh_b : wh_f;
  const float* bias = dir ? bias_b : bias_f;
  T* tok = dir ? tok_b : tok_f;
  float* hst = dir ? hst_b : hst_f;  // null in eval
  float* cst = dir ? cst_b : cst_f;
  const int G = 4 * h;

  for (int i = threadIdx.x; i < 4 * BT * h; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  for (int s = 0; s < L; ++s) {
    const int t = dir ? (L - 1 - s) : s;
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      float acc[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      const T* w = wh + j;
#pragma unroll 4
      for (int k = 0; k < h; ++k) {
        const T* wk = w + (size_t)k * G;
        const float w0 = to_f(wk[0]), w1 = to_f(wk[h]);
        const float w2 = to_f(wk[2 * h]), w3 = to_f(wk[3 * h]);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hv = cur[r * h + k];
          acc[r][0] = fmaf(hv, w0, acc[r][0]);
          acc[r][1] = fmaf(hv, w1, acc[r][1]);
          acc[r][2] = fmaf(hv, w2, acc[r][2]);
          acc[r][3] = fmaf(hv, w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        if (b >= B) continue;  // rows past B stay at their zero state
        const T* x = xp + ((size_t)b * L + t) * G;
        // (xp + bias) + h @ wh, the JAX kernel's summation order.
        const float gi = (to_f(x[j]) + bias[j]) + acc[r][0];
        const float gf = (to_f(x[h + j]) + bias[h + j]) + acc[r][1];
        const float gg = (to_f(x[2 * h + j]) + bias[2 * h + j]) + acc[r][2];
        const float go = (to_f(x[3 * h + j]) + bias[3 * h + j]) + acc[r][3];
        const float ig = sigmoid_f(gi), fg = sigmoid_f(gf);
        const float og = sigmoid_f(go), g = tanhf(gg);
        const float c_new = fg * cs[r * h + j] + ig * g;
        const float h_new = og * tanhf(c_new);
        const bool v = mask[(size_t)b * L + t] > 0.f;
        const float hh = v ? h_new : hs[r * h + j];
        const float cc = v ? c_new : cs[r * h + j];
        cs[r * h + j] = cc;
        hs[r * h + j] = hh;
        nxt[r * h + j] = rd<T>(hh);
        const size_t o = ((size_t)b * L + t) * h + j;
        tok[o] = from_f<T>(v ? hh : 0.f);
        if (hst != nullptr) {
          hst[o] = hh;
          cst[o] = cc;
        }
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int j = threadIdx.x; j < h; j += blockDim.x) {
    for (int r = 0; r < BT; ++r) {
      const int b = b0 + r;
      if (b < B) sent[(size_t)b * 2 * h + dir * h + j] = hs[r * h + j];
    }
  }
}

template <typename T>
int launch(const void* xp_f, const void* xp_b, const void* mask,
           const void* wh_f, const void* wh_b, const void* bias_f,
           const void* bias_b, void* tok_f, void* tok_b, void* sent,
           void* const* st, int B, int L, int h, cudaStream_t stream) {
  const size_t smem = 4ull * BT * h * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)xp_f, (const T*)xp_b, (const float*)mask, (const T*)wh_f,
      (const T*)wh_b, (const float*)bias_f, (const float*)bias_b, (T*)tok_f,
      (T*)tok_b, (float*)sent, (float*)st[0], (float*)st[1], (float*)st[2],
      (float*)st[3], B, L, h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bilstm_bwd_kernel(const T* __restrict__ xp_f, const T* __restrict__ xp_b,
                      const float* __restrict__ mask,
                      const T* __restrict__ wh_f, const T* __restrict__ wh_b,
                      const float* __restrict__ bias_f,
                      const float* __restrict__ bias_b,
                      const float* __restrict__ hst_f,
                      const float* __restrict__ cst_f,
                      const float* __restrict__ hst_b,
                      const float* __restrict__ cst_b,
                      const T* __restrict__ dtok_f,
                      const T* __restrict__ dtok_b,
                      const float* __restrict__ dsent, T* __restrict__ dxp_f,
                      T* __restrict__ dxp_b, float* __restrict__ dbias_part,
                      int B, int L, int h) {
  extern __shared__ float smem[];
  const int G = 4 * h;
  float* dh = smem;            // [BT][h] adjoint of the carried h
  float* dc = dh + BT * h;     // [BT][h] adjoint of the carried c
  float* hp = dc + BT * h;     // [BT][h] h_{t-1} in wh's dtype
  float* dg = hp + BT * h;     // [BT][4h] dgates in wh's dtype
  float* db = dg + BT * G;     // [4h] this block's dbias sum

  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * BT;
  const T* xp = dir ? xp_b : xp_f;
  const T* wh = dir ? wh_b : wh_f;
  const float* bias = dir ? bias_b : bias_f;
  const float* hst = dir ? hst_b : hst_f;
  const float* cst = dir ? cst_b : cst_f;
  const T* dtok = dir ? dtok_b : dtok_f;
  T* dxp = dir ? dxp_b : dxp_f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int NW = THREADS / 32;

  for (int i = threadIdx.x; i < BT * h; i += blockDim.x) {
    const int r = i / h, j = i % h, b = b0 + r;
    dh[i] = b < B ? dsent[(size_t)b * 2 * h + dir * h + j] : 0.f;
    dc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) db[i] = 0.f;

  // Step k of this direction sits at position t; its predecessor (the
  // state the step read) at tp, none for k = 0.
  for (int k = L - 1; k >= 0; --k) {
    const int t = dir ? (L - 1 - k) : k;
    const int tp = dir ? t + 1 : t - 1;
    __syncthreads();
    for (int i = threadIdx.x; i < BT * h; i += blockDim.x) {
      const int r = i / h, j = i % h, b = b0 + r;
      hp[i] = (k > 0 && b < B)
                  ? rd<T>(hst[((size_t)b * L + tp) * h + j])
                  : 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.x; j < h; j += blockDim.x) {
      // The forward's gate dots, loop for loop.
      float acc[BT][4];
#pragma unroll
      for (int r = 0; r < BT; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      const T* w = wh + j;
#pragma unroll 4
      for (int kk = 0; kk < h; ++kk) {
        const T* wk = w + (size_t)kk * G;
        const float w0 = to_f(wk[0]), w1 = to_f(wk[h]);
        const float w2 = to_f(wk[2 * h]), w3 = to_f(wk[3 * h]);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hv = hp[r * h + kk];
          acc[r][0] = fmaf(hv, w0, acc[r][0]);
          acc[r][1] = fmaf(hv, w1, acc[r][1]);
          acc[r][2] = fmaf(hv, w2, acc[r][2]);
          acc[r][3] = fmaf(hv, w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
        if (b < B) {
          const size_t row = (size_t)b * L + t;
          const T* x = xp + row * G;
          const float gi = (to_f(x[j]) + bias[j]) + acc[r][0];
          const float gf = (to_f(x[h + j]) + bias[h + j]) + acc[r][1];
          const float gg = (to_f(x[2 * h + j]) + bias[2 * h + j]) + acc[r][2];
          const float go = (to_f(x[3 * h + j]) + bias[3 * h + j]) + acc[r][3];
          const float ia = sigmoid_f(gi), fa = sigmoid_f(gf);
          const float oa = sigmoid_f(go), ga = tanhf(gg);
          const float valid = mask[row] > 0.f ? 1.f : 0.f;
          const float cp =
              k > 0 ? cst[((size_t)b * L + tp) * h + j] : 0.f;
          const float cc = cst[row * h + j];
          const float dhv = dh[r * h + j] + to_f(dtok[row * h + j]) * valid;
          const float dh_new = dhv * valid;
          const float tc = tanhf(cc);
          const float dc_new =
              dc[r * h + j] * valid + dh_new * oa * (1.0f - tc * tc);
          d0 = dc_new * ga * ia * (1.0f - ia);
          d1 = dc_new * cp * fa * (1.0f - fa);
          d2 = dc_new * ia * (1.0f - ga * ga);
          d3 = dh_new * tc * oa * (1.0f - oa);
          T* dx = dxp + row * G;
          dx[j] = from_f<T>(d0);
          dx[h + j] = from_f<T>(d1);
          dx[2 * h + j] = from_f<T>(d2);
          dx[3 * h + j] = from_f<T>(d3);
          db[j] += d0;
          db[h + j] += d1;
          db[2 * h + j] += d2;
          db[3 * h + j] += d3;
          dh[r * h + j] = dhv * (1.0f - valid);
          dc[r * h + j] = dc[r * h + j] * (1.0f - valid) + dc_new * fa;
        }
        dg[r * G + j] = rd<T>(d0);
        dg[r * G + h + j] = rd<T>(d1);
        dg[r * G + 2 * h + j] = rd<T>(d2);
        dg[r * G + 3 * h + j] = rd<T>(d3);
      }
    }
    __syncthreads();
    // dh[r][i] += sum_n dg[r][n] * wh[i][n]: warp per row i of wh.
    for (int i = warp; i < h; i += NW) {
      const T* wr = wh + (size_t)i * G;
      float acc[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = 0.f;
      for (int n = lane; n < G; n += 32) {
        const float wv = to_f(wr[n]);
#pragma unroll
        for (int r = 0; r < BT; ++r) acc[r] = fmaf(dg[r * G + n], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float v = stair::warp_sum(acc[r]);
        if (lane == 0) dh[r * h + i] += v;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    dbias_part[((size_t)blockIdx.x * 2 + dir) * G + i] = db[i];
}

// dwh[dir][i][n] = sum over rows (b, t) of rd(h_{t-1})[i] * dxp[b, t, n],
// 64 x 64 output tiles, 16-row slices of the B*L rows in a fixed order;
// blocks of the first row tile also sum the nb dbias partials in order.
constexpr int WT = 64, WK = 16;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    bilstm_dwh_kernel(const float* __restrict__ hst_f,
                      const float* __restrict__ hst_b,
                      const T* __restrict__ dxp_f, const T* __restrict__ dxp_b,
                      const float* __restrict__ dbias_part, int nb,
                      float* __restrict__ dwh_f, float* __restrict__ dwh_b,
                      float* __restrict__ dbias_f, float* __restrict__ dbias_b,
                      int B, int L, int h) {
  __shared__ float As[WK][WT];
  __shared__ float Gs[WK][WT];
  const int G = 4 * h;
  const int dir = blockIdx.z;
  const int i0 = blockIdx.y * WT, n0 = blockIdx.x * WT;
  const float* hst = dir ? hst_b : hst_f;
  const T* dxp = dir ? dxp_b : dxp_f;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  const int M = B * L;
  for (int m0 = 0; m0 < M; m0 += WK) {
    for (int q = threadIdx.x; q < WK * WT; q += THREADS) {
      const int mm = q / WT, cc = q % WT, m = m0 + mm;
      float a = 0.f, g = 0.f;
      if (m < M) {
        const int b = m / L, t = m % L;
        const int tp = dir ? t + 1 : t - 1;
        if (i0 + cc < h && tp >= 0 && tp < L)
          a = rd<T>(hst[((size_t)b * L + tp) * h + i0 + cc]);
        if (n0 + cc < G) g = to_f(dxp[(size_t)m * G + n0 + cc]);
      }
      As[mm][cc] = a;
      Gs[mm][cc] = g;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < WK; ++mm) {
      float a[4], g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = As[mm][ty + 16 * q];
#pragma unroll
      for (int q = 0; q < 4; ++q) g[q] = Gs[mm][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], g[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* dwh = dir ? dwh_b : dwh_f;
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * p, n = n0 + tx + 16 * q;
      if (i < h && n < G) dwh[(size_t)i * G + n] = acc[p][q];
    }
  if (blockIdx.y == 0 && threadIdx.x < WT && n0 + threadIdx.x < G) {
    const int n = n0 + threadIdx.x;
    float s = 0.f;
    for (int q = 0; q < nb; ++q) s += dbias_part[((size_t)q * 2 + dir) * G + n];
    (dir ? dbias_b : dbias_f)[n] = s;
  }
}

template <typename T>
int launch_bwd(void* const* p, int B, int L, int h, cudaStream_t stream) {
  const size_t smem = (3ull * BT * h + (size_t)BT * 4 * h + 4 * h) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + BT - 1) / BT, 2);
  bilstm_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)p[0], (const T*)p[1], (const float*)p[2], (const T*)p[3],
      (const T*)p[4], (const float*)p[5], (const float*)p[6],
      (const float*)p[7], (const float*)p[8], (const float*)p[9],
      (const float*)p[10], (const T*)p[11], (const T*)p[12],
      (const float*)p[13], (T*)p[14], (T*)p[15], (float*)p[16], B, L, h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dwh(void* const* p, int B, int L, int h, cudaStream_t stream) {
  const int nb = (B + BT - 1) / BT;
  dim3 grid((4 * h + WT - 1) / WT, (h + WT - 1) / WT, 2);
  bilstm_dwh_kernel<T><<<grid, THREADS, 0, stream>>>(
      (const float*)p[0], (const float*)p[1], (const T*)p[2], (const T*)p[3],
      (const float*)p[4], nb, (float*)p[5], (float*)p[6], (float*)p[7],
      (float*)p[8], B, L, h);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward, cluster route (bf16, h a multiple of 64 up to TC_MAX_H)
// ---------------------------------------------------------------------------

constexpr int TC_CLUSTER = 4;    // CTAs per (batch tile, direction)
constexpr int TC_MAX_H = 256;    // largest h whose wh slice fits one CTA
constexpr int TC_THREADS = 256;  // 8 warps
constexpr int TC_PAD = 8;        // bf16 elements of row padding
constexpr int TC_FPAD = 4;       // float elements of row padding

// Per-CTA shared memory of the cluster kernel at hidden size h (the CTA's
// U = h / 4 units and 4 U = h gate columns): the wh slice [h][h] and
// dgates [BT][h] in bf16; the recomputed gates and two buffers of adjoint
// partials, each [BT][h] in float32; two stages of one step's inputs
// (h_{t-1} [BT][h], c_t and c_{t-1} [BT][U], the mask [BT] in float32;
// xp [BT][h] and dtok [BT][U] in bf16). Rows padded. The tests mirror it
// (tests/test_torch_lstm_train.py).
__host__ __device__ constexpr size_t tc_stage_floats(int h) {
  return (size_t)BT * (h + TC_FPAD + 2 * (h / 4) + 1);
}
__host__ __device__ constexpr size_t tc_stage_halves(int h) {
  return (size_t)BT * (h + h / 4);
}
__host__ __device__ constexpr size_t tc_smem_bytes(int h) {
  return 2 * ((size_t)h + BT) * (h + TC_PAD) +
         4 * (size_t)3 * BT * (h + TC_FPAD) +
         2 * (4 * tc_stage_floats(h) + 2 * tc_stage_halves(h));
}
static_assert(tc_smem_bytes(TC_MAX_H) <= 232448,
              "the wh slice of TC_MAX_H does not fit one CTA");

struct BwdTcArgs {
  const __nv_bfloat16* xp[2];
  const float* mask;
  const __nv_bfloat16* wh[2];
  const float* bias[2];
  const float* hst[2];
  const float* cst[2];
  const __nv_bfloat16* dtok[2];
  const float* dsent;
  __nv_bfloat16* dxp[2];
  float* dbias_part;
  int B, L;
};

// The two halves of a cluster barrier: arrive releases this thread's
// writes; wait acquires every cluster thread's writes before its arrive.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// out[n][m] (row stride ldo, float32) = sum_k A[m][k] x[n][k], k < H, for
// the warp's m-tiles (warp + 8 s) of M = H rows, n the BT batch rows: mma
// m16n8k16 with the rows as the n8 side. A comes from the wh slice W (bf16
// [H][LDW]): A[m][k] = W[m][k] (TRANS false) or W[k][m] (TRANS true),
// through ldmatrix. x is bf16 or float32 (then rounded to bf16, as the
// JAX kernel's hp.astype(wh.dtype)), row stride ldx. Even and odd k-steps
// accumulate apart (two independent mma chains per tile) and are added
// at the end, in that order.
template <int H, bool TRANS, typename X>
__device__ __forceinline__ void rows_product(float* out, int ldo,
                                             const __nv_bfloat16* W,
                                             const X* x, int ldx, int warp,
                                             int lane) {
  constexpr int LDW = H + TC_PAD;
  constexpr int MT = (H / 16 + 7) / 8;   // m-tiles per warp
  const int g = lane / 4, t = lane % 4;
  float acc[MT][2][4];
#pragma unroll
  for (int s = 0; s < MT; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      acc[s][e][0] = acc[s][e][1] = acc[s][e][2] = acc[s][e][3] = 0.f;
  // Lanes 8q .. 8q + 7 address matrix q of the x4 load: q & 1 picks the
  // upper 8 rows of A (m), q >> 1 the upper 8 columns (k).
  const int lr = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < H; k0 += 16) {
    uint32_t b0, b1;
    const X* xb = x + g * ldx + k0 + t * 2;
    if constexpr (sizeof(X) == 4) {
      const float2 lo = *reinterpret_cast<const float2*>(xb);
      const float2 hi = *reinterpret_cast<const float2*>(xb + 8);
      b0 = pack_bf16(lo.x, lo.y);
      b1 = pack_bf16(hi.x, hi.y);
    } else {
      b0 = *reinterpret_cast<const uint32_t*>(xb);
      b1 = *reinterpret_cast<const uint32_t*>(xb + 8);
    }
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      const int m0 = (warp + 8 * s) * 16;
      if (m0 < H) {
        uint32_t a[4];
        if constexpr (TRANS)
          ldmatrix_x4_trans(a, W + (k0 + lr + q2 * 8) * LDW + m0 + q1 * 8);
        else
          ldmatrix_x4(a, W + (m0 + lr + q1 * 8) * LDW + k0 + q2 * 8);
        mma_bf16(acc[s][(k0 / 16) & 1], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < MT; ++s) {
    const int m0 = (warp + 8 * s) * 16;
    if (m0 < H) {
      out[(2 * t) * ldo + m0 + g] = acc[s][0][0] + acc[s][1][0];
      out[(2 * t + 1) * ldo + m0 + g] = acc[s][0][1] + acc[s][1][1];
      out[(2 * t) * ldo + m0 + g + 8] = acc[s][0][2] + acc[s][1][2];
      out[(2 * t + 1) * ldo + m0 + g + 8] = acc[s][0][3] + acc[s][1][3];
    }
  }
}

template <int H>
__global__ void __cluster_dims__(TC_CLUSTER, 1, 1)
    __launch_bounds__(TC_THREADS, 1)
    bilstm_bwd_tc_kernel(const BwdTcArgs a) {
  typedef __nv_bfloat16 T;
  constexpr int U = H / TC_CLUSTER, G = 4 * H;
  constexpr int LDW = H + TC_PAD, LDF = H + TC_FPAD;
  constexpr int PAIRS = (BT * U + TC_THREADS - 1) / TC_THREADS;
  constexpr int SF = (int)tc_stage_floats(H), SB = (int)tc_stage_halves(H);
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();   // owns units [c U, c U + U)
  const int tile = blockIdx.x / TC_CLUSTER, dir = blockIdx.y;
  const int B = a.B, L = a.L, b0 = tile * BT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* xp = a.xp[dir];
  const float* hst = a.hst[dir];
  const float* cst = a.cst[dir];
  const T* dtok = a.dtok[dir];
  T* dxp = a.dxp[dir];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ws = reinterpret_cast<T*>(smem_raw);  // [H][LDW] wh[:, this CTA's cols]
  T* dgs = Ws + H * LDW;                   // [BT][LDW] rd(dgates), local cols
  float* pre = reinterpret_cast<float*>(dgs + BT * LDW);  // [BT][LDF]
  float* part = pre + BT * LDF;            // [2][BT][LDF] dgates wh^T
  float* stF = part + 2 * BT * LDF;        // [2][SF] float32 step inputs
  T* stB = reinterpret_cast<T*>(stF + 2 * SF);  // [2][SB] bf16 step inputs

  // Local gate column n = gate U + u is global column gate H + c U + u.
  for (int i = tid; i < H * H / 8; i += TC_THREADS) {
    const int row = i / (H / 8), n8 = (i % (H / 8)) * 8;
    cp_async16(Ws + row * LDW + n8,
         a.wh[dir] + (size_t)row * G + (n8 / U) * H + c * U + n8 % U, true);
  }

  // Step k of this direction sits at position t; its predecessor at tp.
  // Its inputs go to stage st: hp [BT][LDF], cc and cp [BT][U], mask [BT]
  // (float32); x [BT][H] as [gate][U], dt [BT][U] (bf16).
  auto stage_step = [&](int k, int st) {
    const int t = dir ? L - 1 - k : k, tp = dir ? t + 1 : t - 1;
    float* hpS = stF + st * SF;
    float* ccS = hpS + BT * LDF;
    float* cpS = ccS + BT * U;
    float* mS = cpS + BT * U;
    T* xS = stB + st * SB;
    T* dtS = xS + BT * H;
    for (int i = tid; i < BT * H / 4; i += TC_THREADS) {
      const int r = i / (H / 4), c4 = (i % (H / 4)) * 4, b = b0 + r;
      const bool in = k > 0 && b < B;
      cp_async16(hpS + r * LDF + c4,
           in ? hst + ((size_t)b * L + tp) * H + c4 : hst, in);
    }
    for (int i = tid; i < BT * U / 4; i += TC_THREADS) {
      const int r = i / (U / 4), c4 = (i % (U / 4)) * 4, b = b0 + r;
      const bool in = b < B;
      cp_async16(ccS + r * U + c4,
           in ? cst + ((size_t)b * L + t) * H + c * U + c4 : cst, in);
      cp_async16(cpS + r * U + c4,
           in && k > 0 ? cst + ((size_t)b * L + tp) * H + c * U + c4 : cst,
           in && k > 0);
    }
    for (int i = tid; i < BT * H / 8; i += TC_THREADS) {
      const int r = i / (H / 8), n8 = (i % (H / 8)) * 8, b = b0 + r;
      const bool in = b < B;
      cp_async16(xS + r * H + n8,
           in ? xp + ((size_t)b * L + t) * G + (n8 / U) * H + c * U + n8 % U
              : xp,
           in);
    }
    for (int i = tid; i < BT * U / 8; i += TC_THREADS) {
      const int r = i / (U / 8), u8 = (i % (U / 8)) * 8, b = b0 + r;
      const bool in = b < B;
      cp_async16(dtS + r * U + u8,
           in ? dtok + ((size_t)b * L + t) * H + c * U + u8 : dtok, in);
    }
    if (tid < BT) {
      const int b = b0 + tid;
      cp_async4(mS + tid, b < B ? a.mask + (size_t)b * L + t : a.mask, b < B);
    }
  };

  // This thread's (row, unit) pairs p = tid + j TC_THREADS < BT U: the
  // carried adjoints, the dbias sums and the bias.
  float dh[PAIRS], dc[PAIRS], db[PAIRS][4], bias[PAIRS][4];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int p = tid + j * TC_THREADS, r = p / U, u = p % U, b = b0 + r;
    const bool on = p < BT * U && b < B;
    dh[j] = on ? a.dsent[(size_t)b * 2 * H + dir * H + c * U + u] : 0.f;
    dc[j] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      db[j][q] = 0.f;
      bias[j][q] = p < BT * U ? a.bias[dir][q * H + c * U + u] : 0.f;
    }
  }

  // Prologue: wh and step L - 1's inputs, its gate recompute, then step
  // L - 2's inputs in flight.
  stage_step(L - 1, (L - 1) & 1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  rows_product<H, true>(pre, LDF, Ws, stF + ((L - 1) & 1) * SF, LDF, warp,
                        lane);
  if (L > 1) stage_step(L - 2, (L - 2) & 1);
  cp_async_commit();
  __syncthreads();

  for (int k = L - 1; k >= 0; --k) {
    const int t = dir ? L - 1 - k : k, st = k & 1;
    const float* ccS = stF + st * SF + BT * LDF;
    const float* cpS = ccS + BT * U;
    const float* mS = cpS + BT * U;
    const T* xS = stB + st * SB;
    const T* dtS = xS + BT * H;
    // (b) The elementwise pass, at the forward's summation order.
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int p = tid + j * TC_THREADS, r = p / U, u = p % U, b = b0 + r;
      if (p >= BT * U) break;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if (b < B) {
        const float* pr = pre + r * LDF + u;
        const T* x = xS + r * H + u;
        const float gi = (to_f(x[0]) + bias[j][0]) + pr[0];
        const float gf = (to_f(x[U]) + bias[j][1]) + pr[U];
        const float gg = (to_f(x[2 * U]) + bias[j][2]) + pr[2 * U];
        const float go = (to_f(x[3 * U]) + bias[j][3]) + pr[3 * U];
        const float ia = sigmoid_f(gi), fa = sigmoid_f(gf);
        const float oa = sigmoid_f(go), ga = tanhf(gg);
        const float valid = mS[r] > 0.f ? 1.f : 0.f;
        const float dhv = dh[j] + to_f(dtS[r * U + u]) * valid;
        const float dh_new = dhv * valid;
        const float tc = tanhf(ccS[r * U + u]);
        const float dc_new = dc[j] * valid + dh_new * oa * (1.0f - tc * tc);
        d[0] = dc_new * ga * ia * (1.0f - ia);
        d[1] = dc_new * cpS[r * U + u] * fa * (1.0f - fa);
        d[2] = dc_new * ia * (1.0f - ga * ga);
        d[3] = dh_new * tc * oa * (1.0f - oa);
        T* dx = dxp + ((size_t)b * L + t) * G + c * U + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dx[q * H] = from_f<T>(d[q]);
          db[j][q] += d[q];
        }
        dh[j] = dhv * (1.0f - valid);   // + the cluster's dgates wh^T, (d)
        dc[j] = dc[j] * (1.0f - valid) + dc_new * fa;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) dgs[r * LDW + q * U + u] = from_f<T>(d[q]);
    }
    __syncthreads();
    if (k == 0) break;   // the adjoint of the zero initial state is unused
    // Stage st is free: step k - 2's inputs go there (an empty group when
    // there is none, so that one group stays in flight either way).
    if (k >= 2) stage_step(k - 2, st);
    cp_async_commit();
    // (c) This CTA's partial dgates[:, cols] wh[:, cols]^T over all H
    // units, into buffer k & 1: a peer reads it after this step's cluster
    // barrier and before it arrives at the next one, and this CTA writes
    // it again only two steps later. Masked steps and rows past B add zero
    // partials, so the order of the sum never changes.
    float* pb = part + (k & 1) * BT * LDF;
    rows_product<H, false>(pb, LDF, Ws, dgs, LDW, warp, lane);
    cp_async_wait<1>();          // step k - 1's inputs have landed
    __syncthreads();
    cluster_arrive();
    // (a) Step k - 1's gate recompute h_{t-1} wh[:, cols] needs nothing
    // of the walk: it runs while the cluster barrier completes.
    rows_product<H, true>(pre, LDF, Ws, stF + (st ^ 1) * SF, LDF, warp,
                          lane);
    cluster_wait();
    // (d) dh of this CTA's units: the four partials in rank order.
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int p = tid + j * TC_THREADS, r = p / U, u = p % U;
      if (p >= BT * U) break;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < TC_CLUSTER; ++q)
        sum += cluster.map_shared_rank(pb, q)[r * LDF + c * U + u];
      dh[j] += sum;
    }
    __syncthreads();
  }
  // No CTA leaves while a peer may still read its partials.
  cluster.sync();

  // dbias of this CTA's columns: the BT rows in order, one partial per
  // (batch tile, direction), summed in tile order by bilstm_dwh_sum.
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int p = tid + j * TC_THREADS, r = p / U, u = p % U;
    if (p >= BT * U) break;
#pragma unroll
    for (int q = 0; q < 4; ++q) pre[r * LDF + q * U + u] = db[j][q];
  }
  __syncthreads();
  for (int n = tid; n < H; n += TC_THREADS) {
    float sum = 0.f;
    for (int r = 0; r < BT; ++r) sum += pre[r * LDF + n];
    a.dbias_part[((size_t)tile * 2 + dir) * G + (n / U) * H + c * U + n % U] =
        sum;
  }
}

// dwh on the tensor cores: part[dir][split][i][n] = sum over the split's
// (b, t) rows m of rd(h_{t-1})[m][i] dxp[m][n], 64 x 128 output tiles,
// 32-row stages double-buffered through registers. The B*L rows are cut
// into DW_SPLIT slices for parallelism; bilstm_dwh_sum adds the slices in
// order.
constexpr int DW_BM = 64;       // dwh rows (hidden units) per block
constexpr int DW_BN = 128;      // dwh columns (gates) per block
constexpr int DW_BK = 32;       // (b, t) rows per stage
constexpr int DW_SPLIT = 4;     // slices of the B L rows
constexpr int DW_THREADS = 256;

__global__ void __launch_bounds__(DW_THREADS)
    bilstm_dwh_tc_kernel(const float* __restrict__ hst_f,
                         const float* __restrict__ hst_b,
                         const __nv_bfloat16* __restrict__ dxp_f,
                         const __nv_bfloat16* __restrict__ dxp_b,
                         float* __restrict__ part, int B, int L, int h) {
  typedef __nv_bfloat16 T;
  constexpr int LDA = DW_BM + 8, LDB = DW_BN + 8;
  __shared__ __align__(16) T As[2][DW_BK][LDA];   // rd(h_{t-1}) [m][i]
  __shared__ __align__(16) T Bs[2][DW_BK][LDB];   // dgates [m][n]
  const int G = 4 * h, M = B * L;
  const int dir = blockIdx.z / DW_SPLIT, split = blockIdx.z % DW_SPLIT;
  const int i0 = blockIdx.y * DW_BM, n0 = blockIdx.x * DW_BN;
  const float* hst = dir ? hst_b : hst_f;
  const T* dxp = dir ? dxp_b : dxp_f;
  const int per = ((M + DW_SPLIT - 1) / DW_SPLIT + DW_BK - 1) / DW_BK * DW_BK;
  const int m_begin = split * per, m_end = min(M, m_begin + per);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wi = (warp / 4) * 32, wn = (warp % 4) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      acc[x][y][0] = acc[x][y][1] = acc[x][y][2] = acc[x][y][3] = 0.f;

  float4 ra[2];
  uint4 rb[2];
  auto fetch = [&](int m0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = tid + j * DW_THREADS, mm = q / 16, m = m0 + mm;
      ra[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      rb[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m < m_end) {
        const int b = m / L, tt = m % L, tp = dir ? tt + 1 : tt - 1;
        if (tp >= 0 && tp < L)
          ra[j] = *reinterpret_cast<const float4*>(
              hst + ((size_t)b * L + tp) * h + i0 + (q % 16) * 4);
        rb[j] = *reinterpret_cast<const uint4*>(dxp + (size_t)m * G + n0 +
                                                (q % 16) * 8);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = tid + j * DW_THREADS, mm = q / 16;
      T* d = &As[buf][mm][(q % 16) * 4];
      *reinterpret_cast<__nv_bfloat162*>(d) =
          __floats2bfloat162_rn(ra[j].x, ra[j].y);
      *reinterpret_cast<__nv_bfloat162*>(d + 2) =
          __floats2bfloat162_rn(ra[j].z, ra[j].w);
      *reinterpret_cast<uint4*>(&Bs[buf][mm][(q % 16) * 8]) = rb[j];
    }
  };

  if (m_begin < m_end) {
    fetch(m_begin);
    stash(0);
  }
  __syncthreads();
  const int lr = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  int buf = 0;
  for (int m0 = m_begin; m0 < m_end; m0 += DW_BK) {
    const bool more = m0 + DW_BK < m_end;
    if (more) fetch(m0 + DW_BK);
#pragma unroll
    for (int k0 = 0; k0 < DW_BK; k0 += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)   // A[i][m] = As[m][i]: ldmatrix .trans
        ldmatrix_x4_trans(af[x], &As[buf][k0 + lr + q2 * 8][wi + x * 16 + q1 * 8]);
#pragma unroll
      for (int y = 0; y < 2; ++y)   // B[m][n] = Bs[m][n]
        ldmatrix_x4_trans(bf[y], &Bs[buf][k0 + lr + q1 * 8][wn + y * 16 + q2 * 8]);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          mma_bf16(acc[x][y], af[x], bf[y / 2][(y % 2) * 2],
                   bf[y / 2][(y % 2) * 2 + 1]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* out = part + (size_t)(dir * DW_SPLIT + split) * h * G;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int i = i0 + wi + x * 16 + g, n = n0 + wn + y * 8 + t * 2;
      *reinterpret_cast<float2*>(out + (size_t)i * G + n) =
          make_float2(acc[x][y][0], acc[x][y][1]);
      *reinterpret_cast<float2*>(out + (size_t)(i + 8) * G + n) =
          make_float2(acc[x][y][2], acc[x][y][3]);
    }
}

// dwh = the DW_SPLIT slices in order; dbias = the nb batch tiles' partials
// in order.
__global__ void bilstm_dwh_sum_kernel(const float* __restrict__ part,
                                      const float* __restrict__ dbias_part,
                                      int nb, float* __restrict__ dwh_f,
                                      float* __restrict__ dwh_b,
                                      float* __restrict__ db_f,
                                      float* __restrict__ db_b, int h) {
  const int G = 4 * h;
  const size_t per = (size_t)h * G / 4;   // float4s per direction
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < 2 * per;
       i += stride) {
    const int dir = (int)(i / per);
    const size_t e = i % per;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < DW_SPLIT; ++q) {
      const float4 v =
          reinterpret_cast<const float4*>(part)[(dir * DW_SPLIT + q) * per + e];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    reinterpret_cast<float4*>(dir ? dwh_b : dwh_f)[e] = s;
  }
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < 2 * G;
       i += stride) {
    const int dir = (int)(i / G), n = (int)(i % G);
    float s = 0.f;
    for (int q = 0; q < nb; ++q) s += dbias_part[((size_t)q * 2 + dir) * G + n];
    (dir ? db_b : db_f)[n] = s;
  }
}

template <int H>
int launch_bwd_tc_h(const BwdTcArgs& a, int B, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_bwd_tc_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(((B + BT - 1) / BT) * TC_CLUSTER, 2);
  // Once per size: can a cluster of four such CTAs be resident at all?
  static bool checked = false;
  if (!checked) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(TC_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(
        &clusters, (void*)bilstm_bwd_tc_kernel<H>, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    checked = true;
  }
  bilstm_bwd_tc_kernel<H><<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bwd_tc(void* const* p, int B, int L, int h, cudaStream_t stream) {
  typedef __nv_bfloat16 T;
  BwdTcArgs a;
  for (int d = 0; d < 2; ++d) {
    a.xp[d] = (const T*)p[0 + d];
    a.wh[d] = (const T*)p[3 + d];
    a.bias[d] = (const float*)p[5 + d];
    a.hst[d] = (const float*)p[7 + 2 * d];
    a.cst[d] = (const float*)p[8 + 2 * d];
    a.dtok[d] = (const T*)p[11 + d];
    a.dxp[d] = (T*)p[14 + d];
  }
  a.mask = (const float*)p[2];
  a.dsent = (const float*)p[13];
  a.dbias_part = (float*)p[16];
  a.B = B;
  a.L = L;
  switch (h) {   // h a multiple of 64 up to TC_MAX_H
    case 64: return launch_bwd_tc_h<64>(a, B, stream);
    case 128: return launch_bwd_tc_h<128>(a, B, stream);
    case 192: return launch_bwd_tc_h<192>(a, B, stream);
    case 256: return launch_bwd_tc_h<256>(a, B, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_dwh_tc(void* const* p, int B, int L, int h, cudaStream_t stream) {
  if (h < 64 || h % 64) return (int)cudaErrorInvalidValue;
  const dim3 grid(4 * h / DW_BN, h / DW_BM, 2 * DW_SPLIT);
  bilstm_dwh_tc_kernel<<<grid, DW_THREADS, 0, stream>>>(
      (const float*)p[0], (const float*)p[1], (const __nv_bfloat16*)p[2],
      (const __nv_bfloat16*)p[3], (float*)p[4], B, L, h);
  return (int)cudaGetLastError();
}

}  // namespace

// xp_f/xp_b [B, L, 4h], mask [B, L] f32, wh_f/wh_b [h, 4h], bias [4h] f32
// -> tok_f/tok_b [B, L, h], sent [B, 2h] f32. stacks: null (eval), or four
// float32 [B, L, h] outputs (training): post-mask h_f, c_f, h_b, c_b in
// position order. bf16 != 0: xp, wh and tokens are bf16; otherwise
// float32. Returns cudaGetLastError() after the launch.
extern "C" int stair_bilstm_fwd(const void* xp_f, const void* xp_b,
                                const void* mask, const void* wh_f,
                                const void* wh_b, const void* bias_f,
                                const void* bias_b, void* tok_f, void* tok_b,
                                void* sent, void* const* stacks, int B, int L,
                                int h, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* none[4] = {nullptr, nullptr, nullptr, nullptr};
  void* const* s = stacks ? stacks : none;
  if (bf16)
    return launch<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                                 tok_f, tok_b, sent, s, B, L, h, st);
  return launch<float>(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b, tok_f,
                       tok_b, sent, s, B, L, h, st);
}

// ptrs: xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b, h_f, c_f, h_b, c_b
// (the forward's stacks), dtok_f, dtok_b ([B, L, h] in xp's dtype), dsent
// ([B, 2h] f32) -> dxp_f, dxp_b ([B, L, 4h] in xp's dtype), dbias_part
// (float32 [ceil(B / 8), 2, 4h]). Returns cudaGetLastError().
extern "C" int stair_bilstm_bwd(void* const* ptrs, int B, int L, int h,
                                int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return launch_bwd<__nv_bfloat16>(ptrs, B, L, h, st);
  return launch_bwd<float>(ptrs, B, L, h, st);
}

// ptrs: h_f, h_b (the forward's h stacks), dxp_f, dxp_b, dbias_part (from
// stair_bilstm_bwd) -> dwh_f, dwh_b ([h, 4h] f32), dbias_f, dbias_b ([4h]
// f32). Returns cudaGetLastError().
extern "C" int stair_bilstm_dwh(void* const* ptrs, int B, int L, int h,
                                int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) return launch_dwh<__nv_bfloat16>(ptrs, B, L, h, st);
  return launch_dwh<float>(ptrs, B, L, h, st);
}

// The cluster route (bf16 only; h a multiple of 64 up to TC_MAX_H). ptrs
// as stair_bilstm_bwd's; dbias_part is float32 [ceil(B / 8), 2, 4h].
extern "C" int stair_bilstm_bwd_tc(void* const* ptrs, int B, int L, int h,
                                   void* stream) {
  return launch_bwd_tc(ptrs, B, L, h, (cudaStream_t)stream);
}

// ptrs: h_f, h_b (the forward's h stacks), dxp_f, dxp_b (bf16, from
// stair_bilstm_bwd_tc) -> part (float32 [2, DW_SPLIT, h, 4h]). Returns
// cudaGetLastError().
extern "C" int stair_bilstm_dwh_tc(void* const* ptrs, int B, int L, int h,
                                   void* stream) {
  return launch_dwh_tc(ptrs, B, L, h, (cudaStream_t)stream);
}

// ptrs: part (from stair_bilstm_dwh_tc), dbias_part (from
// stair_bilstm_bwd_tc) -> dwh_f, dwh_b ([h, 4h] f32), dbias_f, dbias_b
// ([4h] f32); nb batch tiles. Returns cudaGetLastError().
extern "C" int stair_bilstm_dwh_sum(void* const* ptrs, int nb, int h,
                                    void* stream) {
  if (h < 1) return (int)cudaErrorInvalidValue;
  bilstm_dwh_sum_kernel<<<264, 256, 0, (cudaStream_t)stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], nb, (float*)ptrs[2],
      (float*)ptrs[3], (float*)ptrs[4], (float*)ptrs[5], h);
  return (int)cudaGetLastError();
}
