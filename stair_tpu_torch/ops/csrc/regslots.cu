// Register-file slot updates, in place: set, zero (with an optional
// read-out), add.
//
// Replaces the TPU kernels stair_tpu/ops/regslots.py _set_kernel,
// _zero_kernel and _add_kernel (reached through _pallas_set, _pallas_zero
// and _pallas_add). A register file is [B, N, ...] with one slot index per
// example; each kernel touches only slot (b, idx[b]) of every example b:
//
//   set:  file[b, idx[b]]  = val[b]
//   zero: out[b] = file[b, idx[b]] (where an output is named), then
//         file[b, idx[b]]  = 0
//   add:  file[b, idx[b]] += val[b]   (in the file's type, one rounding)
//
// Design. The TPU kernels alias the file onto their output and let a block
// index map driven by the prefetched indices pick the slot; here the file
// is simply written through its pointer, and a block reads its own index.
// One launch makes up to MAX_ENTRIES updates of one kind, in the order
// given: the reversible executor's four sets of a scan step in its
// forward, and in its backward the step's eight zeros (four of them
// reading the output cotangents out first) and its seven adds. The entries
// travel by value in the kernel's parameters, so the launch needs no copy
// to the device. Entries may share a file and a slot (out_attn ==
// out_attn_b through the scratch slot; an instruction that reads one
// register twice adds twice to it), and then the updates must happen in
// the order given: a set leaves the last value, a second read-out sees the
// zero the first one wrote, each add is rounded on its own. Entries on one
// file have one slot length and the whole launch one unit (16-byte chunks
// where every entry allows it, else elements), so unit u of a slot belongs
// to the same thread in every entry: the thread walks the entries in order
// over its units, which gives the sequential result with no atomics and no
// race. An index outside [0, N) touches nothing.
//
// The caller describes a launch once (SlotLaunch: files, the base of each
// entry's [T, B] int32 index table, values or read-outs) and then names
// only the scan step t: entry e reads its indices at idx[e] + t * B. So a
// step's updates cost one launch and no per-call checks on the host
// (ops/regslots.py SlotPlan); a single update is the one-entry case.
//
// What bounds it on an H100: bytes. A launch moves slot bytes only (set:
// read val, write slot; zero: write slot, and read it into the read-out;
// add: read both, write slot), never the file, which is the point of the
// kernels. At the training shapes (B 128 bf16) a step's sets and its zeros
// each move ~17 MB, 8.4 MB of it in the frames file's 64 KB slots: the
// set / zero grid gives each block 512 16-byte units of an example's slot
// (1,024 blocks for the frames entry, all resident at once on the 132
// SMs), and a thread issues its loads before its stores. Tensor cores and
// TMA buy nothing for a copy this size; what the design removes is the
// host's time between launches.

#include <type_traits>

#include "common.cuh"

namespace {

using stair::from_f;
using stair::to_f;

// kinds of a launch (ops/regslots.py reads these)
constexpr int KIND_ADD = 0;
constexpr int KIND_SET = 1;
constexpr int KIND_ZERO = 2;
constexpr int THREADS = 256;
// units a thread of the add handles (a loop of ITEMS)
constexpr int ITEMS = 4;
// units a thread of the set / zero handles: half the add's, so that the
// frames entry's grid fills the card
constexpr int MOVE_ITEMS = 2;
// entries of one launch
constexpr int MAX_ENTRIES = 8;

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

// The entries of one launch, passed by value.
struct Entries {
  void* file[MAX_ENTRIES];
  const int* idx[MAX_ENTRIES];
  // set / add: the values [B, slot]; zero: the read-out [B, slot] or null
  void* buf[MAX_ENTRIES];
  long slot[MAX_ENTRIES];   // elements a slot
  int N[MAX_ENTRIES];
  int n;
};

// file_e[b, idx_e[b]] += val_e[b] for e = 0 .. d.n - 1 in turn, over the
// units of this block's chunk (16-byte chunks where VEC, else elements).
// The entry loop is unrolled so that every field is read from the
// parameter bank at a fixed offset.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
add_many_kernel(const Entries d, int chunks) {
  const int b = blockIdx.x / chunks;
  const long i0 =
      ((long)(blockIdx.x % chunks) * ITEMS) * THREADS + threadIdx.x;
#pragma unroll
  for (int e = 0; e < MAX_ENTRIES; ++e) {
    if (e >= d.n) break;
    const int s = d.idx[e][b];
    if (s < 0 || s >= d.N[e]) continue;
    T* dst = static_cast<T*>(d.file[e]) + ((long)b * d.N[e] + s) * d.slot[e];
    const T* src = static_cast<const T*>(d.buf[e]) + (long)b * d.slot[e];
    const long n = VEC ? d.slot[e] * (long)sizeof(T) / 16 : d.slot[e];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const long i = i0 + (long)k * THREADS;
      if (i >= n) break;
      if (VEC) {
        uint4* p = reinterpret_cast<uint4*>(dst) + i;
        *p = add16<T>(*p, reinterpret_cast<const uint4*>(src)[i]);
      } else {
        dst[i] = from_f<T>(to_f(dst[i]) + to_f(src[i]));
      }
    }
  }
}

template <typename U>
__device__ __forceinline__ U zero_unit() {
  if constexpr (std::is_same<U, uint4>::value)
    return make_uint4(0u, 0u, 0u, 0u);
  else
    return from_f<U>(0.f);
}

// KIND_SET: file_e[b, idx_e[b]] = val_e[b]; KIND_ZERO: out_e[b] =
// file_e[b, idx_e[b]] where out_e is named, then file_e[b, idx_e[b]] = 0;
// for e = 0 .. d.n - 1 in turn, over this block's units (U: 16-byte chunks
// or elements). A thread loads all its units of an entry before it stores
// any, so MOVE_ITEMS loads are in flight; its stores to one address keep
// their program order across entries.
template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(THREADS)
move_many_kernel(const Entries d, int chunks) {
  using U = typename std::conditional<VEC, uint4, T>::type;
  const int b = blockIdx.x / chunks;
  const long i0 =
      ((long)(blockIdx.x % chunks) * MOVE_ITEMS) * THREADS + threadIdx.x;
#pragma unroll
  for (int e = 0; e < MAX_ENTRIES; ++e) {
    if (e >= d.n) break;
    const long n = VEC ? d.slot[e] * (long)sizeof(T) / 16 : d.slot[e];
    if (i0 >= n) continue;
    const int s = d.idx[e][b];
    if (s < 0 || s >= d.N[e]) continue;
    U* dst = reinterpret_cast<U*>(static_cast<T*>(d.file[e]) +
                                  ((long)b * d.N[e] + s) * d.slot[e]);
    U* buf = d.buf[e] == nullptr
                 ? nullptr
                 : reinterpret_cast<U*>(static_cast<T*>(d.buf[e]) +
                                        (long)b * d.slot[e]);
    U v[MOVE_ITEMS];
    if (KIND == KIND_SET || buf != nullptr) {
#pragma unroll
      for (int k = 0; k < MOVE_ITEMS; ++k) {
        const long i = i0 + (long)k * THREADS;
        if (i < n) v[k] = KIND == KIND_SET ? buf[i] : dst[i];
      }
    }
#pragma unroll
    for (int k = 0; k < MOVE_ITEMS; ++k) {
      const long i = i0 + (long)k * THREADS;
      if (i >= n) break;
      if (KIND == KIND_SET) {
        dst[i] = v[k];
      } else {
        if (buf != nullptr) buf[i] = v[k];
        dst[i] = zero_unit<U>();
      }
    }
  }
}

// The launch's unit: 16-byte chunks where every entry's slot and pointers
// allow it (*vec), else elements; returns the units of the longest slot.
template <typename T>
long launch_units(const Entries& d, bool* vec) {
  *vec = true;
  long longest = 0;
  for (int e = 0; e < d.n; ++e) {
    *vec = *vec && d.slot[e] * (long)sizeof(T) % 16 == 0 &&
           (size_t)d.file[e] % 16 == 0 && (size_t)d.buf[e] % 16 == 0;
    longest = d.slot[e] > longest ? d.slot[e] : longest;
  }
  return *vec ? longest * (long)sizeof(T) / 16 : longest;
}

template <typename T>
int launch_add(const Entries& d, int B, cudaStream_t stream) {
  bool vec;
  const long n = launch_units<T>(d, &vec);
  const long per_block = (long)THREADS * ITEMS;
  const long chunks = (n + per_block - 1) / per_block;
  if (chunks * B > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(chunks * B);
  if (vec)
    add_many_kernel<T, true><<<grid, THREADS, 0, stream>>>(d, (int)chunks);
  else
    add_many_kernel<T, false><<<grid, THREADS, 0, stream>>>(d, (int)chunks);
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
int launch_move(const Entries& d, int B, cudaStream_t stream) {
  bool vec;
  const long n = launch_units<T>(d, &vec);
  const long per_block = (long)THREADS * MOVE_ITEMS;
  const long chunks = (n + per_block - 1) / per_block;
  if (chunks * B > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(chunks * B);
  if (vec)
    move_many_kernel<T, KIND, true>
        <<<grid, THREADS, 0, stream>>>(d, (int)chunks);
  else
    move_many_kernel<T, KIND, false>
        <<<grid, THREADS, 0, stream>>>(d, (int)chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_kind(const Entries& d, int B, int kind, cudaStream_t stream) {
  if (kind == KIND_ADD) return launch_add<T>(d, B, stream);
  if (kind == KIND_SET) return launch_move<T, KIND_SET>(d, B, stream);
  return launch_move<T, KIND_ZERO>(d, B, stream);
}

}  // namespace

// One launch, described by the caller: mirrored field for field by
// ops/regslots.py _Launch (ctypes), which must change with it.
struct SlotLaunch {
  void* file[MAX_ENTRIES];       // [B, N[e], slot[e]] contiguous
  const int* idx[MAX_ENTRIES];   // row 0 of a [T, B] int32 index table
  void* buf[MAX_ENTRIES];        // [B, slot[e]]: values, or read-out / null
  long slot[MAX_ENTRIES];
  int N[MAX_ENTRIES];
  int n;                         // entries, 1 .. MAX_ENTRIES
  int B;
  int kind;                      // KIND_ADD, KIND_SET or KIND_ZERO
  int bf16;                      // bf16 != 0, else float32; one for all
};

// The updates of `launch` at step t (entry e's indices at idx[e] + t * B),
// in one launch on `stream`. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a description the kernels do not take.
extern "C" int stair_slot_launch(const SlotLaunch* launch, long t,
                                 void* stream) {
  const SlotLaunch& h = *launch;
  if (h.n < 1 || h.n > MAX_ENTRIES || h.B <= 0 || t < 0 ||
      (h.kind != KIND_ADD && h.kind != KIND_SET && h.kind != KIND_ZERO))
    return (int)cudaErrorInvalidValue;
  Entries d;
  d.n = h.n;
  for (int e = 0; e < MAX_ENTRIES; ++e) {
    const bool live = e < h.n;
    if (live && (h.N[e] <= 0 || h.slot[e] <= 0 || h.file[e] == nullptr ||
                 h.idx[e] == nullptr ||
                 (h.kind != KIND_ZERO && h.buf[e] == nullptr)))
      return (int)cudaErrorInvalidValue;
    d.file[e] = live ? h.file[e] : nullptr;
    d.idx[e] = live ? h.idx[e] + t * h.B : nullptr;
    d.buf[e] = live ? h.buf[e] : nullptr;
    d.slot[e] = live ? h.slot[e] : 0;
    d.N[e] = live ? h.N[e] : 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (h.bf16) return launch_kind<__nv_bfloat16>(d, h.B, h.kind, st);
  return launch_kind<float>(d, h.B, h.kind, st);
}
