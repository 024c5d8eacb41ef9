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
// What bounds it on an H100: the 64-step (video) sequential dependence,
// and wh — [h, 4h], 512 KB per direction in bf16 at h = 256 — which is
// above one block's 227 KB of shared memory, so every block streams it
// from L2 (50 MB) at every step. Gate dots run on the CUDA cores in float32.
// Splitting wh across a thread-block cluster (distributed shared memory)
// and wgmma for the recurrent product are later work.
//
// Training forward: the same kernel also writes the post-mask h and c of
// every step ([B, L, h] float32 per direction, in position order for both
// directions), the JAX kernel's residuals.
//
// Backward (bilstm_bwd_kernel): the same grid walks each direction's steps
// in reverse with the (dh, dc) adjoint of its BT rows in shared memory. It
// recomputes each step's gates from the stored h_{t-1} cast to wh's dtype,
// with the forward's loop, so the linearization point equals the
// forward's bit for bit, and writes dgates (rounded to xp's dtype) to dxp.
// The recurrent adjoint dgates @ wh^T reads wh by rows: each warp owns rows
// of wh, its lanes walk a row's 4h contiguous entries (coalesced) and a
// shuffle sum closes each dot. dbias is summed per block in shared memory
// (float32) and written as one partial per block. dwh = sum over (b, t) of
// h_{t-1}^T dgates, both in wh's dtype with float32 sums (the JAX kernel's
// rounding), is a second launch (bilstm_dwh_kernel): a tiled product over
// the stored h stack and dxp, which already holds dgates in wh's dtype
// (xp and wh share a dtype here). It walks the B*L rows in a fixed order
// and also sums the dbias partials in block order, so two runs give the
// same bits; no float atomics. That is cheaper than a per-block [h, 4h]
// float32 partial updated at every step (1 MB per block per step at
// h = 256).

#include "common.cuh"

namespace {

using stair::from_f;
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
