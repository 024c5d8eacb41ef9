// Masked bidirectional LSTM recurrence, forward only (eval).
//
// Replaces the TPU kernel stair_tpu/ops/lstm.py _bilstm_kernel
// (train=False), reached through _forward_call / bilstm_pallas. The input
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
                  T* __restrict__ tok_b, float* __restrict__ sent, int B,
                  int L, int h) {
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
        if (v) cs[r * h + j] = c_new;
        hs[r * h + j] = hh;
        nxt[r * h + j] = rd<T>(hh);
        tok[((size_t)b * L + t) * h + j] = from_f<T>(v ? hh : 0.f);
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
           const void* bias_b, void* tok_f, void* tok_b, void* sent, int B,
           int L, int h, cudaStream_t stream) {
  const size_t smem = 4ull * BT * h * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      bilstm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + BT - 1) / BT, 2);
  bilstm_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)xp_f, (const T*)xp_b, (const float*)mask, (const T*)wh_f,
      (const T*)wh_b, (const float*)bias_f, (const float*)bias_b, (T*)tok_f,
      (T*)tok_b, (float*)sent, B, L, h);
  return (int)cudaGetLastError();
}

}  // namespace

// xp_f/xp_b [B, L, 4h], mask [B, L] f32, wh_f/wh_b [h, 4h], bias [4h] f32
// -> tok_f/tok_b [B, L, h], sent [B, 2h] f32. bf16 != 0: xp, wh and tokens
// are bf16; otherwise float32. Returns cudaGetLastError() after the launch.
extern "C" int stair_bilstm_fwd(const void* xp_f, const void* xp_b,
                                const void* mask, const void* wh_f,
                                const void* wh_b, const void* bias_f,
                                const void* bias_b, void* tok_f, void* tok_b,
                                void* sent, int B, int L, int h, int bf16,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b,
                                 tok_f, tok_b, sent, B, L, h, st);
  return launch<float>(xp_f, xp_b, mask, wh_f, wh_b, bias_f, bias_b, tok_f,
                       tok_b, sent, B, L, h, st);
}
