// Register-file slot updates, in place: set, zero, add.
//
// Replaces the TPU kernels stair_tpu/ops/regslots.py _set_kernel,
// _zero_kernel and _add_kernel (reached through _pallas_set, _pallas_zero
// and _pallas_add). A register file is [B, N, ...] with one slot index per
// example; each kernel touches only slot (b, idx[b]) of every example b:
//
//   set:  file[b, idx[b]]  = val[b]
//   zero: file[b, idx[b]]  = 0
//   add:  file[b, idx[b]] += val[b]   (in the file's type, one rounding)
//
// Design. The TPU kernels alias the file onto their output and let a block
// index map driven by the prefetched indices pick the slot; here the file
// is simply written through its pointer, and a block reads its own index.
// One launch per call over a grid of (example, chunk of the slot). A slot
// is `slot` contiguous elements; where its byte size and the pointers allow
// it a thread moves 16 bytes per load and store, else one element. The
// (b, idx[b]) pairs are unique by construction, so no two blocks write the
// same address: no atomics. An index outside [0, N) touches nothing.
//
// What bounds it on an H100: bytes. A call moves slot bytes only (set:
// read val, write slot; zero: write slot; add: read both, write slot),
// never the file, which is the point of the kernels; at the training
// shapes that is 8 KB to 8 MB per call, so the smaller files are bound by
// the launch itself.

#include "common.cuh"

namespace {

using stair::from_f;
using stair::to_f;

enum { MODE_SET = 0, MODE_ZERO = 1, MODE_ADD = 2 };
constexpr int THREADS = 256;
// 16-byte chunks one block handles (a loop of ITEMS per thread)
constexpr int ITEMS = 4;

template <typename T>
__device__ __forceinline__ uint4 add16(uint4 a, uint4 b);

template <>
__device__ __forceinline__ uint4 add16<float>(uint4 a, uint4 b) {
  float4 x = *reinterpret_cast<float4*>(&a), y = *reinterpret_cast<float4*>(&b);
  x.x += y.x;
  x.y += y.y;
  x.z += y.z;
  x.w += y.w;
  return *reinterpret_cast<uint4*>(&x);
}

template <>
__device__ __forceinline__ uint4 add16<__nv_bfloat16>(uint4 a, uint4 b) {
  __nv_bfloat16* x = reinterpret_cast<__nv_bfloat16*>(&a);
  const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    x[i] = __float2bfloat16_rn(__bfloat162float(x[i]) + __bfloat162float(y[i]));
  return a;
}

// VEC: the slot is a whole number of aligned 16-byte chunks (`n` counts
// them); otherwise `n` counts elements.
template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
slot_kernel(T* file, const int* idx, const T* val, int N, long slot, long n,
            int chunks) {
  const int b = blockIdx.x / chunks;
  const int s = idx[b];
  if (s < 0 || s >= N) return;
  T* dst = file + ((long)b * N + s) * slot;
  const T* src = MODE == MODE_ZERO ? nullptr : val + (long)b * slot;
  const long i0 =
      ((long)(blockIdx.x % chunks) * ITEMS) * THREADS + threadIdx.x;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long i = i0 + (long)k * THREADS;
    if (i >= n) return;
    if (VEC) {
      uint4* d = reinterpret_cast<uint4*>(dst) + i;
      if (MODE == MODE_ZERO) {
        *d = make_uint4(0u, 0u, 0u, 0u);
      } else {
        const uint4 v = reinterpret_cast<const uint4*>(src)[i];
        *d = MODE == MODE_SET ? v : add16<T>(*d, v);
      }
    } else {
      if (MODE == MODE_ZERO)
        dst[i] = from_f<T>(0.f);
      else if (MODE == MODE_SET)
        dst[i] = src[i];
      else
        dst[i] = from_f<T>(to_f(dst[i]) + to_f(src[i]));
    }
  }
}

template <typename T, int MODE>
int launch(void* file, const void* idx, const void* val, int B, int N,
           long slot, cudaStream_t stream) {
  const long bytes = slot * (long)sizeof(T);
  const bool vec = bytes % 16 == 0 && (size_t)file % 16 == 0 &&
                   (MODE == MODE_ZERO || (size_t)val % 16 == 0);
  const long n = vec ? bytes / 16 : slot;
  const long per_block = (long)THREADS * ITEMS;
  const long chunks = (n + per_block - 1) / per_block;
  if (chunks * B > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(chunks * B);
  if (vec)
    slot_kernel<T, MODE, true><<<grid, THREADS, 0, stream>>>(
        (T*)file, (const int*)idx, (const T*)val, N, slot, n, (int)chunks);
  else
    slot_kernel<T, MODE, false><<<grid, THREADS, 0, stream>>>(
        (T*)file, (const int*)idx, (const T*)val, N, slot, n, (int)chunks);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(void* file, const void* idx, const void* val, int B, int N,
             long slot, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || slot <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16, MODE>(file, idx, val, B, N, slot, st);
  return launch<float, MODE>(file, idx, val, B, N, slot, st);
}

}  // namespace

// file: [B, N, slot] contiguous, float32 or bf16 (bf16 != 0); idx: [B]
// int32 on the device; val: [B, slot] contiguous in the file's type. Each
// returns cudaGetLastError() after its launch (or cudaErrorInvalidValue).
extern "C" int stair_slot_set(void* file, const void* idx, const void* val,
                              int B, int N, long slot, int bf16,
                              void* stream) {
  return dispatch<MODE_SET>(file, idx, val, B, N, slot, bf16, stream);
}

extern "C" int stair_slot_zero(void* file, const void* idx, int B, int N,
                               long slot, int bf16, void* stream) {
  return dispatch<MODE_ZERO>(file, idx, nullptr, B, N, slot, bf16, stream);
}

extern "C" int stair_slot_add(void* file, const void* idx, const void* val,
                              int B, int N, long slot, int bf16,
                              void* stream) {
  return dispatch<MODE_ADD>(file, idx, val, B, N, slot, bf16, stream);
}
