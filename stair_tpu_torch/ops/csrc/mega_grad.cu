// Executor megakernel, backward (training).
//
// Replaces the TPU kernel stair_tpu/ops/mega_grad.py _make_bwd_kernel,
// reached through backward_call / _train_fn (mega_exec_train). Inputs are
// the forward's prepare_args tensors (ARG_NAMES order), the forward's final
// register files and their cotangents (cast to the compute dtype).
//
// Design. The register machine is SSA: the final register files hold every
// step's operands, so, as in the JAX kernel, nothing is stored by the
// forward. One thread block per example walks its instructions in reverse:
// it rereads each step's operands from the final files, recomputes the
// step's intermediates with the forward's own products and loops (the
// shared helpers of mega_common.cuh), so relu boundaries and bf16 roundings
// agree bit for bit, recomputes the dropout masks with hash_keep, and
// applies the JAX kernel's backward math opcode by opcode. Gradient
// conventions follow JAX: min splits ties 0.5 / 0.5, |x| has slope +1 at
// 0, the softmax max is detached, and the cosine eps clamps zero their
// branch.
//
// The float32 gradient register files (vec [Nv, H], frames [Nf, F, H],
// attn [Na, F]) and the [F, H] intermediates live in a per-example global
// workspace: the frames file alone is 0.5 MB per example at F = 64, H = 512,
// above a block's 227 KB of shared memory.
//
// Weight gradients. Per-example partials of the ~43 H^2 weight values
// (45 MB at H = 512) would take 5.8 GB at B = 128, so the walk does not
// reduce them. It writes, for each step, the operands of each weight
// product instead: the input rows X (in the compute dtype, as the JAX
// kernel's outer() rounds them) and the output cotangent rows dY (float32)
// of at most five product sites (stage-1 layer 1 and 2, the stage-2
// projection, and two vec-level layers), tagged with (table, expert,
// rows). The second launch (mega_wgrad_kernel) computes each table's
// X^T dY, one 64 x 64 output tile per block, walking the (example, step)
// records in a fixed order, and its bias as the float32 row sum of dY. The
// small tables (attention heads, LayerNorm, relate beta, temporal bands)
// are per-example float32 partials, summed over examples in order by the
// same launch. No float atomics: two runs give the same bits.
//
// What bounds it on an H100: one block per example (B = 128 blocks at the
// training shape, under one per SM), and about nine [F x H] @ [H x H]
// products per heavy step on the float32 CUDA cores, with operands read
// from L2. Tensor cores, grouping examples by expert, and splitting an
// example across blocks are later work.
//
// The float32 "fma32" route (ops/mega_grad.py bwd_route, as the training
// forward's): mega_bwd_kernel<float, true> runs every [F, H]-sized product
// (recompute and gradient alike, both B layouts) on gemm32 instead of gemm
// (the prod wrapper; SUPF's two m1 products with K = F stay on gemm), as
// mega_exec_kernel<float, true> does, on the forward's thread-block cluster
// mode (mega_common.cuh mega32_cluster), so its recompute is the forward's
// by construction and every output equals the general walk's bit for bit. Its
// weight gradients (mega_wgrad_index_kernel, then mega_wgrad_fma32_kernel)
// list each table's record rows once instead of scanning meta in every
// block, and stream them through register-blocked 64 x 64 tiles, each
// output the general reduction's FMA chain in the same order: the same
// bits, no float atomics.

#include <type_traits>

#include "mega_common.cuh"

namespace {

using stair::from_f;
using stair::rd;
using stair::sigmoid_f;
using stair::to_f;
using stair::warp_sum;
using stair::MAX_F;
using stair::MAX_H;
using stair::MAX_L;
using namespace stair::mega;

constexpr int NSLOT = 5;   // weight-product record sites per step
constexpr int NFV = 12;    // scratch [F] vectors in shared memory
constexpr int NHV = 12;    // scratch [H] vectors in shared memory

// Weight tables whose gradients come from records: (experts, input rows
// as a multiple of H, record slot). Order: w1u, w2u, w2t, fdw, cw, eqw,
// xw, qw, taw1, taw2, exw1, exw2, supw.
enum {
  TB_W1U, TB_W2U, TB_W2T, TB_FDW, TB_CW, TB_EQW, TB_XW, TB_QW, TB_TAW1,
  TB_TAW2, TB_EXW1, TB_EXW2, TB_SUPW, NTABLES
};
__constant__ int TB_E[NTABLES] = {11, 11, 4, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
__constant__ int TB_K[NTABLES] = {1, 1, 1, 1, 2, 2, 3, 1, 2, 1, 3, 1, 1};
__constant__ int TB_SLOT[NTABLES] = {0, 1, 2, 3, 3, 3, 3, 3, 3, 4, 3, 4, 3};

// Offsets of the small tables in a per-example partial (float32):
// ffwf [H], ffkw [H], ffab [1], fltw [H], fltk [H], fltb [1], lns [H],
// lnb [H], beta [F], t1/t2/t3 [3, F, F], tb1/tb2/tb3 [3, F]. I: the offsets'
// type (long; the "fma32" walk holds them as int, half the registers).
template <typename I>
struct SmallT {
  I ffwf, ffkw, ffab, fltw, fltk, fltb, lns, lnb, beta, t1, t2, t3, tb1,
      tb2, tb3, size;
  __host__ __device__ SmallT(int H, int F) {
    I o = 0;
    ffwf = o; o += H;
    ffkw = o; o += H;
    ffab = o; o += 1;
    fltw = o; o += H;
    fltk = o; o += H;
    fltb = o; o += 1;
    lns = o; o += H;
    lnb = o; o += H;
    beta = o; o += F;
    t1 = o; o += 3L * F * F;
    t2 = o; o += 3L * F * F;
    t3 = o; o += 3L * F * F;
    tb1 = o; o += 3L * F;
    tb2 = o; o += 3L * F;
    tb3 = o; o += 3L * F;
    size = o;
  }
};
using Small = SmallT<long>;

// Per-example float32 workspace, in floats (offsets of type I, as SmallT).
// Every slot and every example's workspace starts on 16 bytes (H is even,
// and the [F]- and [F, F]-sized slots are padded to 4 floats): the "fma32"
// walk reads the [F, H] slots with cp.async, at any F.
__host__ __device__ constexpr long pad4(long n) { return (n + 3) & ~3L; }

template <typename I>
struct WsT {
  I grv, gra, grf, feat, hpre, h2, gfeat, w1, w2, gof, m1, m2, dtok, daux,
      size;
  __host__ __device__ WsT(int Nv, int Nf, int Na, int F, int H, int L,
                          int T) {
    const long FH = (long)F * H;
    I o = 0;
    grv = o; o += (long)Nv * H;
    gra = o; o += pad4((long)Na * F);
    grf = o; o += Nf * FH;
    feat = o; o += FH;
    hpre = o; o += FH;
    h2 = o; o += FH;
    gfeat = o; o += FH;
    w1 = o; o += FH;
    w2 = o; o += FH;
    gof = o; o += FH;
    m1 = o; o += pad4((long)F * F);
    m2 = o; o += pad4((long)F * F);
    dtok = o; o += (long)L * H;
    daux = o; o += (long)T * H;
    size = o;
  }
};
using Ws = WsT<long>;

template <typename T>
struct BArgs : Tensors<T> {
  const T *rv, *rf, *ra, *drv, *drf, *dra;
  T *dvid, *dtok, *daux;
  int* meta;                       // [B, T, NSLOT, 3]: table, expert, rows
  float *X0, *D0, *X1, *D1, *X2, *D2, *X3, *D3, *X4, *D4;
  float* small;                    // [B, Small.size]
  float* ws;                       // [B, Ws.size]
  int B, T_, Nv, Nf, Na, F, H, L, fsoft;
  int C;                           // CTAs of an example's cluster ("fma32")
  stair::Dropout dr;
};

// Shared-memory scratch, laid out in dynamic shared memory: NHV [H] and
// NFV [F] vectors, each reached as hv[i] / fv[i]. The general route keeps
// a pointer to each (ShT<false>); the "fma32" route computes them from the
// first and the stride (ShT<true>: 44 fewer registers to hold, which
// gemm32's sums need).
struct Strided {
  float* base;
  int stride;
  __device__ float* operator[](int i) const { return base + i * stride; }
};
template <bool G32>
struct ShVecs {
  float* hv[NHV];
  float* fv[NFV];
};
template <>
struct ShVecs<true> {
  Strided hv, fv;
};
template <bool G32>
struct ShT : ShVecs<G32> {
  float *vm, *aa, *ab, *goa, *goab;
  float *As, *Bs, *red;
  float* ring;   // gemm32's ring on the "fma32" route (16-byte aligned)
};

__device__ inline void sync() { __syncthreads(); }

// The walk's [F, H]-sized products, C = A @ B with A(m, k) = A[m * lda +
// k] and B(k, n) = W[k * ldw + n] (NK false) or W[n * ldw + k] (NK true):
// gemm on its tiles (RA: A rounded to T as it is loaded), or, on the
// "fma32" route (G32), gemm32 on its ring, which gives gemm's bits, this
// CTA's columns of it on an example's cluster of C CTAs (gemm32_part:
// called by every CTA of the cluster). So the recompute products are the
// forward's by construction on either route.
template <bool G32, bool RA, bool NK, typename T, typename TA, typename TW,
          typename S, typename Epi>
__device__ void prod(const TA* A, int lda, const TW* W, int ldw, int M,
                     int K, int N, int C, S& s, Epi epi) {
  if constexpr (G32)
    gemm32_part<NK, G32_WALK_BN>(A, lda, W, ldw, M, K, N, C, s.ring, epi);
  else
    gemm<T, RA, false>(A, lda, 1, W, NK ? 1 : ldw, NK ? ldw : 1, M, K, N,
                       s.As, s.Bs, epi);
}

// out[k] = sum_n rd(g[n]) * W[k * ldw + n] for k < K (the JAX kernel's
// mmT: g.astype(dt) @ W^T). Warp per row of W; lanes walk the row.
template <typename T>
__device__ void mmT_vec(const float* g, const T* W, long ldw, int K, int N,
                        float* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k = w; k < K; k += NWARPS) {
    const T* row = W + k * ldw;
    float acc = 0.f;
    for (int n = lane; n < N; n += 32) acc += rd<T>(g[n]) * to_f(row[n]);
    acc = warp_sum(acc);
    if (lane == 0) out[k] = acc;
  }
  sync();
}

// Writes one record's metadata.
__device__ inline void set_meta(int* meta, int slot, int table, int expert,
                                int rows) {
  if (threadIdx.x == 0) {
    meta[slot * 3 + 0] = table;
    meta[slot * 3 + 1] = expert;
    meta[slot * 3 + 2] = rows;
  }
}

// VJP of per-row cosine(rows [F, H], kw [H]) -> [F] against g [F]
// (shared): adds g_rows into grows [F, H] (global float32) and writes g_kw
// [H] to gkw (shared). Norms sqrt(max(ss, 1e-30)), denominator
// max(nr * nk, eps), clamped branches zeroed (the JAX cos_rows_bwd).
template <typename TR, typename S>
__device__ void cos_rows_bwd(const float* g, const TR* rows, const float* kw,
                             int F, int H, float* grows, float* gkw, S& s) {
  float* gdot = s.fv[9];
  float* gnr = s.fv[10];
  float* gdn = s.fv[11];
  float sk = 0.f;
  for (int k = threadIdx.x; k < H; k += THREADS) sk += kw[k] * kw[k];
  const float ssk = block_sum(sk, s.red);
  const float nk = sqrtf(fmaxf(ssk, 1e-30f));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int f = w; f < F; f += NWARPS) {
    float d = 0.f, sr = 0.f;
    for (int k = lane; k < H; k += 32) {
      const float x = to_f(rows[(size_t)f * H + k]);
      d += x * kw[k];
      sr += x * x;
    }
    d = warp_sum(d);
    sr = warp_sum(sr);
    if (lane == 0) {
      const float nr = sqrtf(fmaxf(sr, 1e-30f));
      const float den = fmaxf(nr * nk, COS_EPS);
      const float gden = nr * nk > COS_EPS ? -g[f] * d / (den * den) : 0.f;
      gdot[f] = g[f] / den;
      gnr[f] = sr > 1e-30f ? gden * nk / (2.0f * nr) : 0.f;
      gdn[f] = gden * nr;
    }
  }
  sync();
  float t = 0.f;
  for (int f = threadIdx.x; f < F; f += THREADS) t += gdn[f];
  const float gnk_tot = block_sum(t, s.red);
  const float gssk = ssk > 1e-30f ? gnk_tot / (2.0f * nk) : 0.f;
  for (size_t i = threadIdx.x; i < (size_t)F * H; i += THREADS) {
    const int f = (int)(i / H), k = (int)(i % H);
    grows[i] += gdot[f] * kw[k] + 2.0f * gnr[f] * to_f(rows[i]);
  }
  for (int k = threadIdx.x; k < H; k += THREADS) {
    float a = 0.f;
    for (int f = 0; f < F; ++f) a += gdot[f] * to_f(rows[(size_t)f * H + k]);
    gkw[k] = a + 2.0f * gssk * kw[k];
  }
  sync();
}

}  // namespace

namespace {

// Superlative head backward over K candidate rows (the JAX
// _superlative_bwd). score(k, f) reads the [K, F] scores (vm-scaled),
// act(k, j) the action rows, amask[k] the candidate mask (0/1). Writes the
// supw record (slot 3), returns in wv[k] the pooling weights and in grow[k]
// the softmax cotangent (g_scores[k, f] = grow[k] * vm[f]); gpool [H]
// (shared) receives mmT(g1, supw). The caller routes g_actions[k, j] =
// wv[k] * gpool[j].
template <typename T, typename Score, typename Act, typename S>
__device__ void superlative_bwd(int K, Score score, Act act,
                                const float* amask, int mode, const T* supw,
                                const T* supb, const float* gov, int H,
                                int F, float* wv, float* grow, float* gpool,
                                float* X3, float* D3, int* meta, S& s) {
  float* row = s.fv[6];
  float* smx = s.fv[7];
  float* pooled = s.hv[8];
  float* g1 = s.hv[9];
  const float* vm = s.vm;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float r = 0.f;
    for (int f = 0; f < F; ++f) r += score(k, f) * vm[f];
    row[k] = r;
  }
  sync();
  {
    const int k = threadIdx.x;
    const bool valid = k < K && amask[k] > 0.f;
    const float sm = block_masked_softmax(k < K ? row[k] : 0.f, valid,
                                          s.red);
    if (k < K) {
      smx[k] = sm;
      wv[k] = (mode == 1 ? 1.0f - sm : sm) * amask[k];
    }
  }
  sync();
  for (int j = threadIdx.x; j < H; j += THREADS) {
    float p = 0.f;
    for (int k = 0; k < K; ++k) p += wv[k] * act(k, j);
    pooled[j] = rd<T>(p);
    X3[j] = pooled[j];
  }
  sync();
  vecmat<T>(pooled, nullptr, nullptr, supw, H, H, [&](int n, float y) {
    const float pre = rd<T>(rd<T>(y) + to_f(supb[n]));
    g1[n] = pre > 0.f ? gov[n] : 0.f;
    D3[n] = g1[n];
  });
  set_meta(meta, 3, TB_SUPW, 0, 1);
  sync();
  mmT_vec<T>(g1, supw, H, H, H, gpool);
  float* gsm = s.fv[8];
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float gw = 0.f;
    for (int j = 0; j < H; ++j) gw += act(k, j) * gpool[j];
    gsm[k] = (mode == 1 ? -gw : gw) * amask[k];
  }
  sync();
  float dloc = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) dloc += gsm[k] * smx[k];
  const float d = block_sum(dloc, s.red);
  for (int k = threadIdx.x; k < K; k += THREADS)
    grow[k] = smx[k] * (gsm[k] - d);
  sync();
}

template <typename T, bool G32>
__global__ void __launch_bounds__(THREADS) mega_bwd_kernel(const BArgs<T> a) {
  extern __shared__ float smem[];
  __shared__ int ins[NSF];
  // G32: example b on a cluster of C = a.C CTAs (1: one CTA an example).
  // Its CTA 0, the lead, runs every pass and writes every gradient and
  // record; the others only compute their columns of each product (prod).
  const int C = G32 ? a.C : 1;
  const int b = (int)(blockIdx.x / C);
  auto lead = [&] { return blockIdx.x % C == 0; };
  const int F = a.F, H = a.H, L = a.L, T_ = a.T_, Hh = H / 2;
  const int Nv = a.Nv, Nf = a.Nf, Na = a.Na;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const stair::Dropout dr = a.dr;
  // the "fma32" walk holds sizes and offsets as int (they fit: one
  // example's workspace is well under 2^31 floats) to free registers
  using Idx = std::conditional_t<G32, int, long>;
  using Sz = std::conditional_t<G32, int, size_t>;
  const Sz FH = (Sz)F * H;

  ShT<G32> s;
  {
    float* p = smem;
    if constexpr (G32) {
      s.hv = Strided{p, H};
      p += NHV * H;
      s.fv = Strided{p, F};
      p += NFV * F;
    } else {
      for (int i = 0; i < NHV; ++i) { s.hv[i] = p; p += H; }
      for (int i = 0; i < NFV; ++i) { s.fv[i] = p; p += F; }
    }
    s.vm = p; p += F;
    s.aa = p; p += F;
    s.ab = p; p += F;
    s.goa = p; p += F;
    s.goab = p; p += F;
    s.As = p; p += BK * (BM + 1);
    s.Bs = p; p += BK * BN;
    s.red = p;
    if constexpr (G32)
      s.ring = (float*)(((uintptr_t)(p + NWARPS) + 15) & ~(uintptr_t)15);
  }
  float *va = s.hv[0], *vb = s.hv[1], *vc = s.hv[2], *gov = s.hv[3];
  float *x1 = s.hv[4], *x2 = s.hv[5], *u1 = s.hv[6], *u2 = s.hv[7];
  float* vm = s.vm;

  const WsT<Idx> wl(Nv, Nf, Na, F, H, L, T_);
  float* ws = a.ws + (size_t)b * wl.size;
  float* grv = ws + wl.grv;
  float* gra = ws + wl.gra;
  float* grf = ws + wl.grf;
  float* feat = ws + wl.feat;
  float* hpre = ws + wl.hpre;
  float* h2w = ws + wl.h2;
  float* gfeat = ws + wl.gfeat;
  float* w1 = ws + wl.w1;
  float* w2 = ws + wl.w2;
  float* gof = ws + wl.gof;
  float* m1 = ws + wl.m1;
  float* m2 = ws + wl.m2;
  float* dtokw = ws + wl.dtok;
  float* dauxw = ws + wl.daux;
  const SmallT<Idx> sl(H, F);
  float* sp = a.small + (size_t)b * sl.size;

  const T* rv = a.rv + (size_t)b * Nv * H;
  const T* rf = a.rf + (size_t)b * Nf * FH;
  const T* ra = a.ra + (size_t)b * Na * F;

  // ---- init: cotangents in (f32), accumulators zeroed -------------------
  for (int f = tid; f < F; f += THREADS) vm[f] = to_f(a.vm[(size_t)b * F + f]);
  if (lead()) {
    for (int i = tid; i < Nv * H; i += THREADS)
      grv[i] = to_f(a.drv[(size_t)b * Nv * H + i]);
    for (int i = tid; i < Na * F; i += THREADS)
      gra[i] = to_f(a.dra[(size_t)b * Na * F + i]);
    for (size_t i = tid; i < Nf * FH; i += THREADS)
      grf[i] = to_f(a.drf[(size_t)b * Nf * FH + i]);
    for (size_t i = tid; i < (size_t)L * H; i += THREADS) dtokw[i] = 0.f;
    for (size_t i = tid; i < (size_t)T_ * H; i += THREADS) dauxw[i] = 0.f;
    for (long i = tid; i < sl.size; i += THREADS) sp[i] = 0.f;
  }
  sync();

  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };

  for (int t = T_ - 1; t >= 0; --t) {
    if (tid < NSF) ins[tid] = a.scal[((size_t)b * T_ + t) * NSF + tid];
    const Sz rec = (Sz)b * T_ + t;
    int* meta = a.meta + (size_t)rec * NSLOT * 3;
    float* X0 = a.X0 + (size_t)rec * FH;
    float* D0 = a.D0 + (size_t)rec * FH;
    float* X1 = a.X1 + (size_t)rec * FH;
    float* D1 = a.D1 + (size_t)rec * FH;
    float* X2 = a.X2 + (size_t)rec * FH;
    float* D2 = a.D2 + (size_t)rec * FH;
    float* X3 = a.X3 + (size_t)rec * 3 * H;
    float* D3 = a.D3 + (size_t)rec * H;
    float* X4 = a.X4 + (size_t)rec * H;
    float* D4 = a.D4 + (size_t)rec * H;
    if (tid < NSLOT && lead()) {
      meta[tid * 3] = -1;
      meta[tid * 3 + 1] = 0;
      meta[tid * 3 + 2] = 0;
    }
    sync();
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
    float* gfa = grf + (size_t)ifa * FH;

    if (lead()) {
      for (int j = tid; j < H; j += THREADS) {
        va[j] = to_f(rv[(size_t)iva * H + j]);
        vb[j] = to_f(rv[(size_t)ivb * H + j]);
        gov[j] = grv[(size_t)out_v * H + j];
      }
      const bool loc_alias = op == OP_LOC && out_a == out_ab;
      for (int f = tid; f < F; f += THREADS) {
        s.aa[f] = to_f(ra[(size_t)iaa * F + f]);
        s.ab[f] = to_f(ra[(size_t)iab * F + f]);
        s.goab[f] = gra[(size_t)out_ab * F + f];
        s.goa[f] = loc_alias ? 0.f : gra[(size_t)out_a * F + f];
      }
      for (size_t i = tid; i < FH; i += THREADS) gfeat[i] = 0.f;
      if (op == OP_FFV || op == OP_FFK || op == OP_TEMP || op == OP_ATTNV)
        for (size_t i = tid; i < FH; i += THREADS)
          gof[i] = grf[(size_t)out_f * FH + i];
    }
    sync();

    // ---- stage-1 recompute: hidden into X1 (the w2u record's X), its
    // pre-activation, h2, and feat -------------------------------------
    const T* sw1 = a.w1u + (size_t)e1 * H * H;
    const T* sb1 = a.b1u + (size_t)e1 * H;
    const T* sw2 = a.w2u + (size_t)e1 * H * H;
    const T* sb2 = a.b2u + (size_t)e1 * H;
    if (e1 != 9) {
      prod<G32, false, false, T>(fa, H, sw1, H, F, H, H, C, s,
                            [&](int m, int n, float acc) {
        const float v = acc + to_f(sb1[n]);
        hpre[(size_t)m * H + n] = v;
        X1[(size_t)m * H + n] =
            rd<T>(fmaxf(v, 0.f) * dr.keep(m, n, b, t, 0));
      });
      prod<G32, false, false, T>(X1, H, sw2, H, F, H, H, C, s,
                            [&](int m, int n, float acc) {
        const float v = acc + to_f(sb2[n]);
        h2w[(size_t)m * H + n] = v;
        feat[(size_t)m * H + n] =
            rd<T>(is_filter ? fmaxf(v, 0.f) * dr.keep(m, n, b, t, 1) : v);
      });
    }

    // ================= vec producers ===================================
    // (SUPF's products on every CTA of the cluster, the rest on the lead)
    if (op == OP_SUPF) {
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      // SUPF: kw_f = lin_dt(fb, w2t[2], b2t[2]) [F, H] into w1 (the
      // forward's product), cosine matrix vs feat, superlative VJP over
      // the F candidate rows of fb, then the cosine-matrix VJP.
      const T* fb = rf + (size_t)ifb * FH;
      float* gfb = grf + (size_t)ifb * FH;
      prod<G32, false, false, T>(fb, H, wk, H, F, H, H, C, s,
                            [&](int m, int n, float acc) {
        w1[(size_t)m * H + n] = rd<T>(rd<T>(acc) + to_f(bk[n]));
      });
      prod<G32, false, true, T>(w1, H, feat, H, F, H, F, C, s,
                            [&](int m, int n, float acc) {
        m2[(size_t)m * F + n] = acc;  // dots[i][f]
      });
      if (lead()) {
        float* nk = s.fv[0];
        float* nf = s.fv[1];
        float* ssk = s.fv[2];
        float* ssf = s.fv[3];
        for (int r = warp; r < F; r += NWARPS) {
          float n1 = 0.f, n2 = 0.f;
          for (int k = lane; k < H; k += 32) {
            const float x = w1[(size_t)r * H + k], y = feat[(size_t)r * H + k];
            n1 += x * x;
            n2 += y * y;
          }
          n1 = warp_sum(n1);
          n2 = warp_sum(n2);
          if (lane == 0) {
            ssk[r] = n1;
            ssf[r] = n2;
            nk[r] = sqrtf(fmaxf(n1, 1e-30f));
            nf[r] = sqrtf(fmaxf(n2, 1e-30f));
          }
        }
        sync();
        for (int i = tid; i < F * F; i += THREADS) {
          const int r = i / F, f = i % F;
          const float c = m2[i] / fmaxf(nk[r] * nf[f], COS_EPS);
          m1[i] = (c + 1.0f) * 0.49f * vm[f];
        }
        sync();
        float* wv = s.fv[4];
        float* grow = s.fv[5];
        superlative_bwd<T>(
            F, [&](int k, int f) { return m1[(size_t)k * F + f]; },
            [&](int k, int j) { return to_f(fb[(size_t)k * H + j]); }, vm,
            mode, a.supw, a.supb, gov, H, F, wv, grow, u1, X3, D3, meta, s);
        for (size_t i = tid; i < FH; i += THREADS)
          gfb[i] += wv[i / H] * u1[i % H];
        // gcosm [F, F] into m1; then gdot (m1) and gden (m2)
        for (int i = tid; i < F * F; i += THREADS) {
          const int r = i / F, f = i % F;
          const float g = grow[r] * vm[f] * 0.49f * vm[f];
          const float prod = nk[r] * nf[f];
          const float den = fmaxf(prod, COS_EPS);
          m1[i] = g / den;
          m2[i] = prod > COS_EPS ? -g * m2[i] / (den * den) : 0.f;
        }
        sync();
        float* dnk = s.fv[6];
        float* dnf = s.fv[7];
        for (int r = tid; r < F; r += THREADS) {
          float gk = 0.f, gf = 0.f;
          for (int q = 0; q < F; ++q) {
            gk += m2[(size_t)r * F + q] * nf[q];
            gf += m2[(size_t)q * F + r] * nk[q];
          }
          dnk[r] = ssk[r] > 1e-30f ? gk / (2.0f * nk[r]) : 0.f;
          dnf[r] = ssf[r] > 1e-30f ? gf / (2.0f * nf[r]) : 0.f;
        }
        sync();
        // g_kf = gdot @ feat + 2 dnk kf -> D2 (the w2t[2] record's dY)
        gemm<T, false, false>(m1, F, 1, feat, H, 1, F, F, H, s.As, s.Bs,
                              [&](int m, int n, float acc) {
          D2[(size_t)m * H + n] = acc + 2.0f * dnk[m] * w1[(size_t)m * H + n];
        });
        // g_feat = gdot^T @ kf + 2 dnf feat
        gemm<T, false, false>(m1, 1, F, w1, H, 1, F, F, H, s.As, s.Bs,
                              [&](int m, int n, float acc) {
          gfeat[(size_t)m * H + n] +=
              acc + 2.0f * dnf[m] * feat[(size_t)m * H + n];
        });
        for (size_t i = tid; i < FH; i += THREADS) X2[i] = to_f(fb[i]);
        set_meta(meta, 2, TB_W2T, 2, F);
      }
      // fb += mmT(g_kf, w2t[2])
      prod<G32, true, true, T>(D2, H, wk, H, F, H, H, C, s,
                           [&](int m, int n, float acc) {
        gfb[(size_t)m * H + n] += acc;
      });
    } else if (lead()) {
      if (op == OP_PUSH) {
        const int ss = ins[F_SS], se = ins[F_SE];
        const T* tm = a.tm + (size_t)b * L;
        auto span_w = [&](int p) {
          const bool valid = to_f(tm[p]) > 0.f;
          const bool in_span = p >= ss && p < se;
          return (ss < 0 ? valid : (in_span && valid)) ? 1.f : 0.f;
        };
        float den = 0.f;
        for (int p = 0; p < L; ++p) den += span_w(p);
        den = fmaxf(den, 1.0f);
        const bool is_aux = ss == -2;
        for (int j = tid; j < H; j += THREADS) {
          const float gp = is_aux ? 0.f : gov[j] / den;
          for (int p = 0; p < L; ++p)
            dtokw[(size_t)p * H + j] += span_w(p) * gp;
          dauxw[(size_t)t * H + j] += is_aux ? gov[j] : 0.f;
        }
        sync();
      } else if (op == OP_ANDV) {
        for (int j = tid; j < H; j += THREADS) {
          const float lt = va[j] < vb[j] ? 1.f : 0.f;
          const float eq = va[j] == vb[j] ? 1.f : 0.f;
          const float ga = gov[j] * (lt + 0.5f * eq);
          grv[(size_t)iva * H + j] += ga;
          grv[(size_t)ivb * H + j] += gov[j] - ga;
        }
        sync();
      } else if (op == OP_CHOOSE) {
        float dac = 0.f, dbc = 0.f, na = 0.f, nb = 0.f, nc = 0.f;
        for (int j = tid; j < H; j += THREADS) {
          const float c = to_f(rv[(size_t)ivc * H + j]);
          dac += va[j] * c;
          dbc += vb[j] * c;
          na += va[j] * va[j];
          nb += vb[j] * vb[j];
          nc += c * c;
        }
        dac = block_sum(dac, s.red);
        dbc = block_sum(dbc, s.red);
        na = sqrtf(fmaxf(block_sum(na, s.red), 1e-30f));
        nb = sqrtf(fmaxf(block_sum(nb, s.red), 1e-30f));
        nc = sqrtf(fmaxf(block_sum(nc, s.red), 1e-30f));
        const bool first =
            dac / fmaxf(na * nc, COS_EPS) > dbc / fmaxf(nb * nc, COS_EPS);
        for (int j = tid; j < H; j += THREADS) {
          grv[(size_t)iva * H + j] += first ? gov[j] : 0.f;
          grv[(size_t)ivb * H + j] += first ? 0.f : gov[j];
        }
        sync();
      } else if (op == OP_CMP || op == OP_EQ || op == OP_XOR) {
        // relu(lin over [d,] va, vb) backward (Compare / Equals / Xor)
        const bool x = op == OP_XOR;
        const T* w = op == OP_CMP ? a.cw : (op == OP_EQ ? a.eqw : a.xw);
        const T* bb = op == OP_CMP ? a.cb : (op == OP_EQ ? a.eqb : a.xb);
        const int nseg = x ? 3 : 2;
        float* g1 = s.hv[9];
        for (int j = tid; j < H; j += THREADS) {
          const float d = fabsf(va[j] - vb[j]);
          x1[j] = rd<T>(d);
          if (x) {
            X3[j] = x1[j];
            X3[H + j] = va[j];
            X3[2 * H + j] = vb[j];
          } else {
            X3[j] = va[j];
            X3[H + j] = vb[j];
          }
        }
        sync();
        auto epi = [&](int n, float y) {
          const float pre = rd<T>(rd<T>(y) + to_f(bb[n]));
          g1[n] = pre > 0.f ? gov[n] : 0.f;
          D3[n] = g1[n];
        };
        if (x)
          vecmat<T>(x1, va, vb, w, H, H, epi);
        else
          vecmat<T>(va, vb, nullptr, w, H, H, epi);
        set_meta(meta, 3, op == OP_CMP ? TB_CW : (op == OP_EQ ? TB_EQW : TB_XW),
                 0, 1);
        sync();
        // segment s of W^T: rows s*H .. s*H + H - 1
        mmT_vec<T>(g1, w, H, H, H, u1);
        mmT_vec<T>(g1, w + (size_t)H * H, H, H, H, u2);
        if (x) {
          mmT_vec<T>(g1, w + (size_t)2 * H * H, H, H, H, x2);
          for (int j = tid; j < H; j += THREADS) {
            const float sgn = va[j] - vb[j] >= 0.f ? 1.f : -1.f;
            grv[(size_t)iva * H + j] += u1[j] * sgn + u2[j];
            grv[(size_t)ivb * H + j] += -u1[j] * sgn + x2[j];
          }
        } else {
          for (int j = tid; j < H; j += THREADS) {
            grv[(size_t)iva * H + j] += u1[j];
            grv[(size_t)ivb * H + j] += u2[j];
          }
        }
        sync();
      } else if (op == OP_QUERY) {
        float* g1 = s.hv[9];
        for (int j = tid; j < H; j += THREADS) X3[j] = va[j];
        vecmat<T>(va, nullptr, nullptr, a.qw, H, H, [&](int n, float y) {
          const float pre = rd<T>(rd<T>(y) + to_f(a.qb[n]));
          g1[n] = pre > 0.f ? gov[n] * dr.keep(0, n, b, t, 4) : 0.f;
          D3[n] = g1[n];
        });
        set_meta(meta, 3, TB_QW, 0, 1);
        sync();
        mmT_vec<T>(g1, a.qw, H, H, H, u1);
        for (int j = tid; j < H; j += THREADS)
          grv[(size_t)iva * H + j] += u1[j];
        sync();
      } else if (op == OP_TOA || op == OP_EX) {
        // Two-layer heads: pre1 = lin over segments, h = rd(relu(pre1) *
        // mask), out = relu(lin_dt(h)) [* mask7 for Exists].
        const bool ex = op == OP_EX;
        const T* wA = ex ? a.exw1 : a.taw1;
        const T* bA = ex ? a.exb1 : a.tab1;
        const T* wB = ex ? a.exw2 : a.taw2;
        const T* bB = ex ? a.exb2 : a.tab2;
        const int siteA = ex ? 6 : 5;
        float* pre1 = s.hv[8];
        float* g2 = s.hv[9];
        float* gh = s.hv[10];
        float* hh = s.hv[11];
        for (int j = tid; j < H; j += THREADS) {
          x1[j] = rd<T>(vb[j] * va[j]);  // Exists' product operand
          if (ex) {
            X3[j] = vb[j];
            X3[H + j] = va[j];
            X3[2 * H + j] = x1[j];
          } else {
            X3[j] = va[j];
            X3[H + j] = vb[j];
          }
        }
        sync();
        auto epiA = [&](int n, float y) {
          pre1[n] = rd<T>(rd<T>(y) + to_f(bA[n]));
          hh[n] = rd<T>(fmaxf(pre1[n], 0.f) * dr.keep(0, n, b, t, siteA));
          X4[n] = hh[n];
        };
        if (ex)
          vecmat<T>(vb, va, x1, wA, H, H, epiA);
        else
          vecmat<T>(va, vb, nullptr, wA, H, H, epiA);
        sync();
        vecmat<T>(hh, nullptr, nullptr, wB, H, H, [&](int n, float y) {
          const float pre2 = rd<T>(rd<T>(y) + to_f(bB[n]));
          const float g = ex ? gov[n] * dr.keep(0, n, b, t, 7) : gov[n];
          g2[n] = pre2 > 0.f ? g : 0.f;
          D4[n] = g2[n];
        });
        set_meta(meta, 4, ex ? TB_EXW2 : TB_TAW2, 0, 1);
        sync();
        mmT_vec<T>(g2, wB, H, H, H, u1);
        for (int j = tid; j < H; j += THREADS) {
          gh[j] = pre1[j] > 0.f ? u1[j] * dr.keep(0, j, b, t, siteA) : 0.f;
          D3[j] = gh[j];
        }
        set_meta(meta, 3, ex ? TB_EXW1 : TB_TAW1, 0, 1);
        sync();
        mmT_vec<T>(gh, wA, H, H, H, u1);
        mmT_vec<T>(gh, wA + (size_t)H * H, H, H, H, u2);
        if (ex) {
          mmT_vec<T>(gh, wA + (size_t)2 * H * H, H, H, H, x2);  // g3
          for (int j = tid; j < H; j += THREADS) {
            grv[(size_t)ivb * H + j] += u1[j] + x2[j] * va[j];
            grv[(size_t)iva * H + j] += u2[j] + x2[j] * vb[j];
          }
        } else {
          for (int j = tid; j < H; j += THREADS) {
            grv[(size_t)iva * H + j] += u1[j];
            grv[(size_t)ivb * H + j] += u2[j];
          }
        }
        sync();
      } else if (op == OP_FV || op == OP_FK) {
        float* wvm = s.fv[0];   // w * vm
        float* soft = s.fv[1];
        float* gpool = s.hv[10];
        float* g1 = s.hv[9];
        const bool sm_on = a.fsoft && op == OP_FV;
        if (a.fsoft) {
          for (int f = warp; f < F; f += NWARPS) {
            float d = 0.f;
            for (int k = lane; k < H; k += 32)
              d += feat[(size_t)f * H + k] * to_f(a.fltw[k]);
            d = warp_sum(d);
            if (lane == 0) s.fv[2][f] = d;
          }
          float kb = 0.f;
          for (int k = tid; k < H; k += THREADS) kb += va[k] * to_f(a.fltk[k]);
          kb = block_sum(kb, s.red) + to_f(a.fltb[0]);
          const int f = tid;
          const bool valid = f < F && vm[f] > 0.f;
          const float x = f < F ? s.fv[2][f] + kb : 0.f;
          const float sw = block_masked_softmax(x, valid, s.red);
          if (f < F) {
            soft[f] = sw;
            wvm[f] = (op == OP_FV ? sw : vm[f]) * vm[f];
          }
        } else {
          for (int f = tid; f < F; f += THREADS) wvm[f] = vm[f] * vm[f];
        }
        sync();
        for (int k = tid; k < H; k += THREADS) {
          float p = 0.f;
          for (int f = 0; f < F; ++f) p += feat[(size_t)f * H + k] * wvm[f];
          x1[k] = rd<T>(p);
          X3[k] = x1[k];
        }
        sync();
        vecmat<T>(x1, nullptr, nullptr, a.fdw, H, H, [&](int n, float y) {
          const float pre = rd<T>(rd<T>(y) + to_f(a.fdb[n]));
          g1[n] = pre > 0.f ? gov[n] : 0.f;
          D3[n] = g1[n];
        });
        set_meta(meta, 3, TB_FDW, 0, 1);
        sync();
        mmT_vec<T>(g1, a.fdw, H, H, H, gpool);
        for (size_t i = tid; i < FH; i += THREADS)
          gfeat[i] += wvm[i / H] * gpool[i % H];
        sync();
        if (sm_on) {
          float* gw = s.fv[2];
          float* gl = s.fv[3];
          for (int f = warp; f < F; f += NWARPS) {
            float d = 0.f;
            for (int k = lane; k < H; k += 32)
              d += feat[(size_t)f * H + k] * gpool[k];
            d = warp_sum(d);
            if (lane == 0) gw[f] = d * vm[f];
          }
          sync();
          float dl = 0.f;
          for (int f = tid; f < F; f += THREADS) dl += gw[f] * soft[f];
          const float dot = block_sum(dl, s.red);
          for (int f = tid; f < F; f += THREADS)
            gl[f] = soft[f] * (gw[f] - dot);
          sync();
          for (size_t i = tid; i < FH; i += THREADS)
            gfeat[i] += gl[i / H] * to_f(a.fltw[i % H]);
          float gs = 0.f;
          for (int f = tid; f < F; f += THREADS) gs += gl[f];
          const float gkb = block_sum(gs, s.red);
          for (int k = tid; k < H; k += THREADS) {
            float acc = 0.f;
            for (int f = 0; f < F; ++f)
              acc += feat[(size_t)f * H + k] * rd<T>(gl[f]);
            sp[sl.fltw + k] += acc;
            sp[sl.fltk + k] += va[k] * gkb;
            grv[(size_t)iva * H + k] += gkb * to_f(a.fltk[k]);
          }
          if (tid == 0) sp[sl.fltb] += gkb;
          sync();
        }
      } else if (op == OP_LOC || op == OP_SUPV) {
        const T* wk = a.w2t + 2 * (size_t)H * H;
        const T* bk = a.b2t + 2 * (size_t)H;
        float* gkw = s.hv[11];
        // keywords ka, kb = lin_dt(va|vb, w2t[2], b2t[2]) into x1, x2
        vecmat<T>(va, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        vecmat<T>(vb, nullptr, nullptr, wk, H, H, [&](int n, float y) {
          x2[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        sync();
        float* gsa = s.fv[4];
        float* gsb = s.fv[5];
        if (op == OP_LOC) {
          for (int f = tid; f < F; f += THREADS) {
            gsa[f] = s.goa[f];
            gsb[f] = s.goab[f];
          }
        } else {
          // SUPV: recompute the two score rows as the JAX backward does,
          // scores = rd((cos + 1) * 0.49 * vm), then the superlative VJP.
          float* sc[2] = {s.fv[0], s.fv[1]};
          const float* kws[2] = {x1, x2};
          for (int q = 0; q < 2; ++q) {
            const float* kw = kws[q];
            float nk2 = 0.f;
            for (int k = tid; k < H; k += THREADS) nk2 += kw[k] * kw[k];
            const float nk = sqrtf(fmaxf(block_sum(nk2, s.red), 1e-30f));
            for (int f = warp; f < F; f += NWARPS) {
              float d = 0.f, n2 = 0.f;
              for (int k = lane; k < H; k += 32) {
                const float v = feat[(size_t)f * H + k];
                d += v * kw[k];
                n2 += v * v;
              }
              d = warp_sum(d);
              n2 = warp_sum(n2);
              if (lane == 0) {
                const float nf = sqrtf(fmaxf(n2, 1e-30f));
                const float c = d / fmaxf(nf * nk, COS_EPS);
                sc[q][f] = rd<T>((c + 1.0f) * 0.49f * vm[f]);
              }
            }
            sync();
          }
          float* amask = s.fv[2];
          if (tid < 2) amask[tid] = tid < count ? 1.f : 0.f;
          sync();
          float* wv = s.fv[3];
          float* grow = s.fv[5];
          const float* s0 = sc[0];
          const float* s1 = sc[1];
          superlative_bwd<T>(
              2, [&](int k, int f) { return k == 0 ? s0[f] : s1[f]; },
              [&](int k, int j) { return k == 0 ? va[j] : vb[j]; }, amask,
              mode, a.supw, a.supb, gov, H, F, wv, grow, u1, X3, D3, meta, s);
          const float g0 = grow[0], g1v = grow[1];
          for (int j = tid; j < H; j += THREADS) {
            grv[(size_t)iva * H + j] += wv[0] * u1[j];
            grv[(size_t)ivb * H + j] += wv[1] * u1[j];
          }
          sync();
          for (int f = tid; f < F; f += THREADS) {
            gsa[f] = g0 * vm[f];
            gsb[f] = g1v * vm[f];
          }
        }
        sync();
        // _loc_bwd for ka (rows 0) and kb (row 1) of the w2t[2] record
        const int idx[2] = {iva, ivb};
        const float* kws[2] = {x1, x2};
        const float* gsc[2] = {gsa, gsb};
        float* gcos = s.fv[6];
        for (int q = 0; q < 2; ++q) {
          for (int f = tid; f < F; f += THREADS)
            gcos[f] = gsc[q][f] * 0.49f * vm[f];
          sync();
          cos_rows_bwd(gcos, feat, kws[q], F, H, gfeat, gkw, s);
          const float* vsrc = q == 0 ? va : vb;
          for (int j = tid; j < H; j += THREADS) {
            X2[(size_t)q * H + j] = vsrc[j];
            D2[(size_t)q * H + j] = gkw[j];
          }
          mmT_vec<T>(gkw, wk, H, H, H, u2);
          for (int j = tid; j < H; j += THREADS)
            grv[(size_t)idx[q] * H + j] += u2[j];
          sync();
        }
        set_meta(meta, 2, TB_W2T, 2, 2);
      }
    }

    // ================= frames producers ================================
    if (op == OP_FFV || op == OP_FFK) {
      float* gate = s.fv[0];
      if (lead()) {
        float gk = 0.f;
        for (int k = tid; k < H; k += THREADS) gk += va[k] * to_f(a.ffkw[k]);
        gk = block_sum(gk, s.red) + to_f(a.ffab[0]);
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32)
            d += feat[(size_t)f * H + k] * to_f(a.ffwf[k]);
          d = warp_sum(d);
          if (lane == 0) gate[f] = op == OP_FFV ? sigmoid_f(d + gk) : 1.0f;
        }
        sync();
        for (size_t i = tid; i < FH; i += THREADS)
          X2[i] = rd<T>(gate[i / H] * feat[i]);
        sync();
      }
      prod<G32, false, false, T>(X2, H, a.w2t, H, F, H, H, C, s,
                            [&](int m, int n, float acc) {
        const float y2 = acc + to_f(a.b2t[n]);
        D2[(size_t)m * H + n] = y2 > 0.f
            ? gof[(size_t)m * H + n] * vm[m] * dr.keep(m, n, b, t, 2)
            : 0.f;
      });
      if (lead()) set_meta(meta, 2, TB_W2T, 0, F);
      prod<G32, true, true, T>(D2, H, a.w2t, H, F, H, H, C, s,
                           [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc;  // gx2
      });
      if (lead()) {
        for (size_t i = tid; i < FH; i += THREADS)
          gfeat[i] += gate[i / H] * w2[i];
        sync();
        if (op == OP_FFV) {
          float* gpre = s.fv[1];
          for (int f = warp; f < F; f += NWARPS) {
            float d = 0.f;
            for (int k = lane; k < H; k += 32)
              d += w2[(size_t)f * H + k] * feat[(size_t)f * H + k];
            d = warp_sum(d);
            if (lane == 0) gpre[f] = d * gate[f] * (1.0f - gate[f]);
          }
          sync();
          for (size_t i = tid; i < FH; i += THREADS)
            gfeat[i] += gpre[i / H] * to_f(a.ffwf[i % H]);
          float gs = 0.f;
          for (int f = tid; f < F; f += THREADS) gs += gpre[f];
          const float ggk = block_sum(gs, s.red);
          for (int k = tid; k < H; k += THREADS) {
            float acc = 0.f;
            for (int f = 0; f < F; ++f)
              acc += feat[(size_t)f * H + k] * rd<T>(gpre[f]);
            sp[sl.ffwf + k] += acc;
            sp[sl.ffkw + k] += va[k] * ggk;
            grv[(size_t)iva * H + k] += ggk * to_f(a.ffkw[k]);
          }
          if (tid == 0) sp[sl.ffab] += ggk;
          sync();
        }
      }
    } else if (op == OP_TEMP) {
      const int midx = mode - 1 > 0 ? mode - 1 : 0;
      const size_t FF = (size_t)F * F;
      const T* t1w = a.t1 + midx * FF;
      const T* t2w = a.t2 + midx * FF;
      const T* t3w = a.t3 + midx * FF;
      float *am = s.fv[0], *p1 = s.fv[1], *h1 = s.fv[2], *p2 = s.fv[3];
      float *hh2 = s.fv[4], *gsig = s.fv[5], *rel = s.fv[6];
      float *mu = s.fv[7], *rstd = s.fv[8];
      if (lead()) {
        for (int f = tid; f < F; f += THREADS)
          am[f] = count == 2 ? (s.aa[f] + s.ab[f]) * 0.5f : s.aa[f];
        sync();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += rd<T>(am[i]) * to_f(t1w[(size_t)i * F + j]);
          p1[j] = acc + to_f(a.tb1[midx * F + j]);
          h1[j] = rd<T>(fmaxf(p1[j], 0.f));
        }
        sync();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += h1[i] * to_f(t2w[(size_t)i * F + j]);
          p2[j] = acc + to_f(a.tb2[midx * F + j]);
          hh2[j] = rd<T>(fmaxf(p2[j], 0.f));
        }
        sync();
        for (int j = tid; j < F; j += THREADS) {
          float acc = 0.f;
          for (int i = 0; i < F; ++i)
            acc += hh2[i] * to_f(t3w[(size_t)i * F + j]);
          gsig[j] = sigmoid_f(acc + to_f(a.tb3[midx * F + j]));
          rel[j] = (mode == 0 ? am[j] : gsig[j]) * vm[j];
        }
        sync();
        for (size_t i = tid; i < FH; i += THREADS)
          X2[i] = rd<T>(rel[i / H] * to_f(fa[i]));
        sync();
      }
      // y2 into w2, ry = relu(y2) * mask into w1
      prod<G32, false, false, T>(X2, H, a.w2t + (size_t)H * H, H, F, H, H, C,
                            s, [&](int m, int n, float acc) {
        const float y2 = acc + to_f(a.b2t[H + n]);
        w2[(size_t)m * H + n] = y2;
        w1[(size_t)m * H + n] = fmaxf(y2, 0.f) * dr.keep(m, n, b, t, 2);
      });
      if (lead()) {
        float* mgx = s.fv[9];
        float* mgxx = s.fv[10];
        for (int f = warp; f < F; f += NWARPS) {
          const float* ry = w1 + (size_t)f * H;
          float sum = 0.f;
          for (int k = lane; k < H; k += 32) sum += ry[k];
          const float m = warp_sum(sum) / H;
          float s2 = 0.f;
          for (int k = lane; k < H; k += 32) s2 += (ry[k] - m) * (ry[k] - m);
          const float var = warp_sum(s2) / H;
          const float r = rsqrtf(var + 1e-5f);
          float g1s = 0.f, g2s = 0.f;
          for (int k = lane; k < H; k += 32) {
            const float gx = gof[(size_t)f * H + k] * to_f(a.lns[k]);
            g1s += gx;
            g2s += gx * (ry[k] - m) * r;
          }
          g1s = warp_sum(g1s);
          g2s = warp_sum(g2s);
          if (lane == 0) {
            mu[f] = m;
            rstd[f] = r;
            mgx[f] = g1s / H;
            mgxx[f] = g2s / H;
          }
        }
        sync();
        for (int k = tid; k < H; k += THREADS) {
          float gs = 0.f, bs = 0.f;
          for (int f = 0; f < F; ++f) {
            const float g = gof[(size_t)f * H + k];
            gs += g * (w1[(size_t)f * H + k] - mu[f]) * rstd[f];
            bs += g;
          }
          sp[sl.lns + k] += gs;
          sp[sl.lnb + k] += bs;
        }
        for (size_t i = tid; i < FH; i += THREADS) {
          const int f = (int)(i / H), k = (int)(i % H);
          const float xhat = (w1[i] - mu[f]) * rstd[f];
          const float gx = gof[i] * to_f(a.lns[k]);
          const float gb = rstd[f] * (gx - mgx[f] - xhat * mgxx[f]);
          D2[i] = w2[i] > 0.f ? gb * dr.keep(f, k, b, t, 2) : 0.f;
        }
        set_meta(meta, 2, TB_W2T, 1, F);
        sync();
      }
      prod<G32, true, true, T>(D2, H, a.w2t + (size_t)H * H, H, F, H, H, C,
                           s, [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc;  // gx2
      });
      if (lead()) {
        float *gr0 = s.fv[7], *gp3 = s.fv[8], *gh2 = s.fv[9], *gh1 = s.fv[10];
        for (size_t i = tid; i < FH; i += THREADS)
          gfa[i] += rel[i / H] * w2[i];
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32)
            d += w2[(size_t)f * H + k] * to_f(fa[(size_t)f * H + k]);
          d = warp_sum(d);
          if (lane == 0) {
            const float g = (d + s.goab[f]) * vm[f];
            gr0[f] = g;
            gp3[f] = mode == 0 ? 0.f : g * gsig[f] * (1.0f - gsig[f]);
          }
        }
        sync();
        float* st1 = sp + sl.t1 + midx * FF;
        float* st2 = sp + sl.t2 + midx * FF;
        float* st3 = sp + sl.t3 + midx * FF;
        for (int i = tid; i < F * F; i += THREADS)
          st3[i] += hh2[i / F] * rd<T>(gp3[i % F]);
        for (int j = tid; j < F; j += THREADS) {
          sp[sl.tb3 + midx * F + j] += gp3[j];
          float acc = 0.f;
          for (int q = 0; q < F; ++q)
            acc += rd<T>(gp3[q]) * to_f(t3w[(size_t)j * F + q]);
          gh2[j] = p2[j] > 0.f ? acc : 0.f;
        }
        sync();
        for (int i = tid; i < F * F; i += THREADS)
          st2[i] += h1[i / F] * rd<T>(gh2[i % F]);
        for (int j = tid; j < F; j += THREADS) {
          sp[sl.tb2 + midx * F + j] += gh2[j];
          float acc = 0.f;
          for (int q = 0; q < F; ++q)
            acc += rd<T>(gh2[q]) * to_f(t2w[(size_t)j * F + q]);
          gh1[j] = p1[j] > 0.f ? acc : 0.f;
        }
        sync();
        for (int i = tid; i < F * F; i += THREADS)
          st1[i] += rd<T>(am[i / F]) * rd<T>(gh1[i % F]);
        const float half = count == 2 ? 1.f : 0.f;
        for (int j = tid; j < F; j += THREADS) {
          sp[sl.tb1 + midx * F + j] += gh1[j];
          float acc = 0.f;
          for (int q = 0; q < F; ++q)
            acc += rd<T>(gh1[q]) * to_f(t1w[(size_t)j * F + q]);
          const float gam = (mode == 0 ? gr0[j] : 0.f) + acc;
          gra[(size_t)iaa * F + j] += gam * (1.0f - half) + 0.5f * half * gam;
          gra[(size_t)iab * F + j] += 0.5f * half * gam;
        }
        sync();
      }
    } else if (op == OP_ATTNV && lead()) {
      for (size_t i = tid; i < FH; i += THREADS)
        gfa[i] += s.aa[i / H] * gof[i];
      for (int f = warp; f < F; f += NWARPS) {
        float d = 0.f;
        for (int k = lane; k < H; k += 32)
          d += gof[(size_t)f * H + k] * to_f(fa[(size_t)f * H + k]);
        d = warp_sum(d);
        if (lane == 0) gra[(size_t)iaa * F + f] += d;
      }
      sync();
    }

    // ================= attn producers ==================================
    if (lead()) {
      if (op == OP_ANDA || op == OP_XORF) {
        for (int f = tid; f < F; f += THREADS) {
          const float x = s.aa[f], y = s.ab[f], g = s.goa[f];
          float ga;
          if (op == OP_ANDA)
            ga = g * ((x < y ? 1.f : 0.f) + 0.5f * (x == y ? 1.f : 0.f));
          else
            ga = g * (x - y >= 0.f ? 1.f : -1.f);
          gra[(size_t)iaa * F + f] += ga;
          gra[(size_t)iab * F + f] += op == OP_ANDA ? g - ga : -ga;
        }
        sync();
      } else if (op == OP_HAS) {
        for (int f = tid; f < F; f += THREADS) {
          const float sg = sigmoid_f(feat[(size_t)f * H]);
          const float g = s.goa[f] * vm[f] * dr.keep(0, f, b, t, 3);
          gfeat[(size_t)f * H] += g * sg * (1.0f - sg);
        }
        sync();
      } else if (op == OP_EXF) {
        float* gcos = s.fv[0];
        for (int f = tid; f < F; f += THREADS)
          gcos[f] = s.goa[f] * 0.49f * vm[f];
        sync();
        cos_rows_bwd(gcos, fa, va, F, H, gfa, u1, s);
        for (int j = tid; j < H; j += THREADS)
          grv[(size_t)iva * H + j] += u1[j];
        sync();
      } else if (op == OP_REL) {
        const int f = tid;
        const bool valid = f < F && vm[f] > 0.f;
        float x = 0.f;
        if (f < F) {
          const float beta = to_f(a.beta[f]);
          x = mode == 1 ? s.aa[f] - beta : s.aa[f] + beta;
        }
        const float w = block_masked_softmax(x, valid, s.red);
        const float gw = f < F ? s.goa[f] * w : 0.f;
        const float tot = block_sum(gw, s.red);
        if (f < F) {
          const float gs = w * (s.goa[f] - tot);
          gra[(size_t)iaa * F + f] += gs;
          sp[sl.beta + f] += mode == 1 ? -gs : gs;
        }
        sync();
      }
    }

    // ---- stage-1 backward over the collected g_feat ---------------------
    if (e1 != 9) {
      if (lead()) {
        for (size_t i = tid; i < FH; i += THREADS) {
          const int m = (int)(i / H), n = (int)(i % H);
          D1[i] = is_filter ? (h2w[i] > 0.f
                                   ? gfeat[i] * dr.keep(m, n, b, t, 1)
                                   : 0.f)
                            : gfeat[i];
          X0[i] = to_f(fa[i]);
        }
        set_meta(meta, 1, TB_W2U, e1, F);
        set_meta(meta, 0, TB_W1U, e1, F);
        sync();
      }
      prod<G32, true, true, T>(D1, H, sw2, H, F, H, H, C, s,
                           [&](int m, int n, float acc) {
        const size_t i = (size_t)m * H + n;
        D0[i] = hpre[i] > 0.f ? acc * dr.keep(m, n, b, t, 0) : 0.f;
      });
      prod<G32, true, true, T>(D0, H, sw1, H, F, H, H, C, s,
                           [&](int m, int n, float acc) {
        gfa[(size_t)m * H + n] += acc;
      });
    }
  }

  // ---- data cotangents out -------------------------------------------
  if (!lead()) return;
  for (size_t i = tid; i < FH; i += THREADS)
    a.dvid[(size_t)b * FH + i] = from_f<T>(grf[i] * vm[i / H]);
  for (size_t i = tid; i < (size_t)L * H; i += THREADS)
    a.dtok[(size_t)b * L * H + i] = from_f<T>(dtokw[i]);
  for (size_t i = tid; i < (size_t)T_ * H; i += THREADS)
    a.daux[(size_t)b * T_ * H + i] = from_f<T>(dauxw[i]);
}

// Weight gradients from the walk's records: block (n tile, k tile, job)
// computes the 64 x 64 tile of dW[table][expert] = sum over records of
// rd(X)^T rd(dY), the records visited in (example, step) order; the blocks
// of k tile 0 also write db = the float32 row sum of dY. Job ids past the
// record tables sum the small per-example partials over examples in order.
struct WArgs {
  const int* meta;
  const float *X[NSLOT], *D[NSLOT];
  const float* small;
  float* dw[NTABLES];
  float* db[NTABLES];
  float* dsmall;
  int B, T_, F, H, njobs;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) mega_wgrad_kernel(const WArgs a) {
  __shared__ float Xs[BK][BM];
  __shared__ float Gs[BK][BN];
  const int H = a.H, F = a.F;
  const int tid = threadIdx.x;
  if ((int)blockIdx.z >= a.njobs) {
    // small tables: one flat element range, examples summed in order
    const long n = Small(H, F).size;
    const long stride = (long)gridDim.x * gridDim.y * THREADS;
    for (long e = ((long)blockIdx.y * gridDim.x + blockIdx.x) * THREADS + tid;
         e < n; e += stride) {
      float acc = 0.f;
      for (int b = 0; b < a.B; ++b) acc += a.small[(size_t)b * n + e];
      a.dsmall[e] = acc;
    }
    return;
  }
  int job = blockIdx.z, table = 0;
  while (job >= TB_E[table]) job -= TB_E[table++];
  const int expert = job;
  const int Kin = TB_K[table] * H, slot = TB_SLOT[table];
  const int k0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  if (k0 >= Kin || n0 >= H) return;
  const long xrow = slot == 3 ? 3L * H : H;  // X row stride of the slot
  const long xrec = slot <= 2 ? (long)F * H : xrow;
  const long drec = slot <= 2 ? (long)F * H : H;
  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;  // column n0 + tid of db (k tile 0, tid < BN)
  const int nrec = a.B * a.T_;
  for (int r = 0; r < nrec; ++r) {
    const int* m = a.meta + ((size_t)r * NSLOT + slot) * 3;
    if (m[0] != table || m[1] != expert) continue;
    const int rows = m[2];
    const float* X = a.X[slot] + r * xrec;
    const float* D = a.D[slot] + r * drec;
    for (int r0 = 0; r0 < rows; r0 += BK) {
      for (int i = tid; i < BK * BM; i += THREADS) {
        const int rr = i / BM, c = i % BM, row = r0 + rr;
        const bool in = row < rows;
        Xs[rr][c] = in && k0 + c < Kin ? rd<T>(X[row * xrow + k0 + c]) : 0.f;
        Gs[rr][c] = in && n0 + c < H ? D[(size_t)row * H + n0 + c] : 0.f;
      }
      __syncthreads();
      if (k0 == 0 && tid < BN)
        for (int rr = 0; rr < BK; ++rr) bsum += Gs[rr][tid];
#pragma unroll
      for (int rr = 0; rr < BK; ++rr) {
        float x[4], g[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = Xs[rr][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = rd<T>(Gs[rr][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], g[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
  float* dw = a.dw[table] + (size_t)expert * Kin * H;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (k < Kin && n < H) dw[(size_t)k * H + n] = acc[i][j];
    }
  if (k0 == 0 && tid < BN && n0 + tid < H)
    a.db[table][(size_t)expert * H + n0 + tid] = bsum;
}

#ifdef STAIR_GRAD_FMA32
// The "fma32" route's weight gradients (float32 only): what
// mega_wgrad_kernel computes, on register-blocked tiles, bit for bit.
//
// mega_wgrad_index_kernel, one block per job (a table's expert), lists the
// job's record rows once, in (example, step, row) order: a prefix over the
// rows of the matching meta entries, 256 records a round. A row is g = rec *
// R + i (R = F in the [F, H] slots 0-2, 1 in the vec slots 3-4), so its X
// row is X[slot] + g * xrow and its dY row D[slot] + g * H. The blocks past
// the jobs sum the small per-example partials over examples in order, as
// mega_wgrad_kernel does, one element a thread (its loads in flight
// together: the sum is a chain of B adds).
//
// mega_wgrad_fma32_kernel: block (n tile, k tile, job) computes the WG_TILE x
// WG_TILE tile of dW = sum over the job's rows of X^T dY, each output one
// FMA chain over the rows in list order (mega_wgrad_kernel's chain without
// its zero padding rows, which add nothing), 4 x 4 sums a thread in
// registers, the X and dY rows streamed WG_ROWS at a time through a
// WG_STAGES-stage cp.async ring, each thread's list entries read a chunk
// ahead of its copies. A chain cannot be split without moving the bits, so
// the largest job (phase 8: one expert's 126 records x 64 rows) bounds the
// launch by its tiles' chains: 64 x 64 tiles give it 64 blocks (128 x 128
// gave 16), and on the card 256 threads a tile finished the launch sooner
// than 64 threads with 8 x 8 sums each, which feed the FMAs with fewer
// shared loads. The blocks of k tile 0 also write db, the float32 row sum
// of dY in list order. No float atomics: two runs give the same bits.
struct W32Args : WArgs {
  int* list;      // record rows of each job, at job_rows(job)
  int* counts;    // [njobs] rows listed
};

// Offset of job's list in W32Args::list (nrec * R rows of room a job) and
// its table and expert.
__device__ inline long job_rows(int job, int nrec, int F, int& table,
                                int& expert) {
  long base = 0;
  table = 0;
  while (job >= TB_E[table]) {
    base += (long)TB_E[table] * nrec * (TB_SLOT[table] <= 2 ? F : 1);
    job -= TB_E[table++];
  }
  expert = job;
  return base + (long)job * nrec * (TB_SLOT[table] <= 2 ? F : 1);
}

constexpr int WG_TILE = 64;
// WG_SIDE^2 threads a block, (WG_TILE / WG_SIDE)^2 sums a thread
constexpr int WG_SIDE = 16;
constexpr int WG_THREADS = WG_SIDE * WG_SIDE;
static_assert(WG_THREADS >= WG_TILE, "a thread a column of db");
constexpr int WG_ROWS = 32;
constexpr int WG_STAGES = 3;
constexpr int WG_STAGE = 2 * WG_ROWS * WG_TILE;   // X rows, then dY rows
constexpr size_t WG_SMEM_BYTES = WG_STAGES * WG_STAGE * sizeof(float);

__global__ void __launch_bounds__(THREADS)
    mega_wgrad_index_kernel(const W32Args a) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if ((int)blockIdx.x >= a.njobs) {   // an element a thread
    const long n = Small(a.H, a.F).size;
    const long e = (long)(blockIdx.x - a.njobs) * THREADS + tid;
    if (e < n) {
      float acc = 0.f;
#pragma unroll 8
      for (int b = 0; b < a.B; ++b) acc += a.small[(size_t)b * n + e];
      a.dsmall[e] = acc;
    }
    return;
  }
  __shared__ int wsum[NWARPS];
  const int nrec = a.B * a.T_;
  int table, expert;
  int* list = a.list + job_rows(blockIdx.x, nrec, a.F, table, expert);
  const int slot = TB_SLOT[table], R = slot <= 2 ? a.F : 1;
  int base = 0;
  for (int r0 = 0; r0 < nrec; r0 += THREADS) {
    const int r = r0 + tid;
    int rows = 0;
    if (r < nrec) {
      const int* m = a.meta + ((size_t)r * NSLOT + slot) * 3;
      if (m[0] == table && m[1] == expert) rows = m[2];
    }
    int incl = rows;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int q = 0; q < NWARPS; ++q) {
      before += q < w ? wsum[q] : 0;
      total += wsum[q];
    }
    const int off = base + before + incl - rows;
    for (int i = 0; i < rows; ++i) list[off + i] = r * R + i;
    base += total;
    __syncthreads();   // wsum is written again next round
  }
  if (tid == 0) a.counts[blockIdx.x] = base;
}

__global__ void __launch_bounds__(WG_THREADS)
    mega_wgrad_fma32_kernel(const W32Args a) {
  extern __shared__ __align__(16) float wg_ring[];
  // WG_SIDE x WG_SIDE threads, NT x NT sums each: thread (ty, tx) owns rows
  // k0 + 4 WG_SIDE h + 4 ty + i and columns n0 + 4 WG_SIDE h + 4 tx + j (h <
  // NT / 4, i, j < 4): 16-byte loads a quarter warp reads from one address
  // (X) or 128 contiguous bytes (dY)
  constexpr int NT = WG_TILE / WG_SIDE, SPAN = 4 * WG_SIDE;
  constexpr int COPIES = WG_ROWS * WG_TILE / 4 / WG_THREADS;
  const int H = a.H, tid = threadIdx.x;
  const int tx = tid % WG_SIDE, ty = tid / WG_SIDE;
  int table, expert;
  const int* list =
      a.list + job_rows(blockIdx.z, a.B * a.T_, a.F, table, expert);
  const int Kin = TB_K[table] * H, slot = TB_SLOT[table];
  const int k0 = blockIdx.y * WG_TILE, n0 = blockIdx.x * WG_TILE;
  if (k0 >= Kin) return;
  const long xrow = slot == 3 ? 3L * H : H;
  const float* X = a.X[slot] + k0;
  const float* D = a.D[slot] + n0;
  const int n = a.counts[blockIdx.z];
  const int nch = (n + WG_ROWS - 1) / WG_ROWS;
  // the record rows of this thread's copies of chunk c, read a chunk ahead
  // of their copies so that the list's latency hides behind a chunk's FMAs
  int g[COPIES];
  auto rows_of = [&](int c) {
#pragma unroll
    for (int q = 0; q < COPIES; ++q) {
      const int row = c * WG_ROWS + (tid + q * WG_THREADS) / (WG_TILE / 4);
      g[q] = row < n ? list[row] : -1;
    }
  };
  auto load = [&](int c) {
    float* Xs = wg_ring + (c % WG_STAGES) * WG_STAGE;
    float* Ds = Xs + WG_ROWS * WG_TILE;
#pragma unroll
    for (int q = 0; q < COPIES; ++q) {
      const int p = tid + q * WG_THREADS;
      const int rr = p / (WG_TILE / 4), col = (p % (WG_TILE / 4)) * 4;
      const bool in = g[q] >= 0;
      const long r = in ? g[q] : 0;
      stair::cp_async16(Xs + rr * WG_TILE + col, X + r * xrow + col, in);
      stair::cp_async16(Ds + rr * WG_TILE + col, D + r * H + col, in);
    }
    stair::cp_async_commit();
  };
  float acc[NT][NT];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;   // column n0 + tid of db (k tile 0, tid < WG_TILE)
  const bool dbias = blockIdx.y == 0 && tid < WG_TILE;
  if (nch > 0) {
    rows_of(0);
    load(0);
  }
  if (nch > 1) {
    rows_of(1);
    load(1);
  }
  if (nch > 2) rows_of(2);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch)
      stair::cp_async_wait<1>();
    else
      stair::cp_async_wait<0>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is free
    if (c + 2 < nch) load(c + 2);
    if (c + 3 < nch) rows_of(c + 3);
    const float* Xs = wg_ring + (c % WG_STAGES) * WG_STAGE;
    const float* Ds = Xs + WG_ROWS * WG_TILE;
    const int rows = min(WG_ROWS, n - c * WG_ROWS);
    if (dbias)
      for (int rr = 0; rr < rows; ++rr) bsum += Ds[rr * WG_TILE + tid];
#pragma unroll 2
    for (int rr = 0; rr < rows; ++rr) {
      float x[NT], d[NT];
#pragma unroll
      for (int h = 0; h < NT / 4; ++h) {
        const float4 u = *reinterpret_cast<const float4*>(
            Xs + rr * WG_TILE + SPAN * h + 4 * ty);
        const float4 v = *reinterpret_cast<const float4*>(
            Ds + rr * WG_TILE + SPAN * h + 4 * tx);
        x[4 * h] = u.x;
        x[4 * h + 1] = u.y;
        x[4 * h + 2] = u.z;
        x[4 * h + 3] = u.w;
        d[4 * h] = v.x;
        d[4 * h + 1] = v.y;
        d[4 * h + 2] = v.z;
        d[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(x[i], d[j], acc[i][j]);
    }
  }
  float* dw = a.dw[table] + (size_t)expert * Kin * H;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int k = k0 + SPAN * (i / 4) + 4 * ty + i % 4;
#pragma unroll
    for (int h = 0; h < NT / 4; ++h)
      *reinterpret_cast<float4*>(dw + (size_t)k * H + n0 + SPAN * h +
                                 4 * tx) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  }
  if (dbias) a.db[table][(size_t)expert * H + n0 + tid] = bsum;
}

// stair_mega_f32_product_check's kernel: block 0 runs gemm, block 1 gemm32
// (column tile BN), reps times each on the same operands (A [M, K], W [K, N]
// or, NK, [N, K]), the sums stored as they are; clk[block] is the block's
// clock64() span.
template <bool NK, int BN>
__global__ void __launch_bounds__(THREADS)
    f32_product_check_kernel(const float* A, const float* W, int M, int K,
                             int N, int reps, float* outg, float* out32,
                             long long* clk) {
  extern __shared__ __align__(16) float pc_smem[];
  const long long c0 = clock64();
  for (int r = 0; r < reps; ++r) {
    if (blockIdx.x == 0)
      gemm<float, false, false>(A, K, 1, W, NK ? 1 : N, NK ? K : 1, M, K, N,
                                pc_smem, pc_smem + BK * (BM + 1),
                                [&](int m, int n, float acc) {
        outg[(size_t)m * N + n] = acc;
      });
    else
      gemm32<NK, BN>(A, K, W, NK ? K : N, M, K, N, pc_smem,
                     [&](int m, int n, float acc) {
        out32[(size_t)m * N + n] = acc;
      });
  }
  if (threadIdx.x == 0) clk[blockIdx.x] = clock64() - c0;
}

template <bool NK, int BN>
int product_check(const float* A, const float* W, int M, int K, int N,
                  int reps, float* outg, float* out32, long long* clk,
                  cudaStream_t stream) {
  const size_t smem = g32_ring<NK, BN>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      f32_product_check_kernel<NK, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  f32_product_check_kernel<NK, BN><<<2, THREADS, smem, stream>>>(
      A, W, M, K, N, reps, outg, out32, clk);
  return (int)cudaGetLastError();
}
#endif  // STAIR_GRAD_FMA32

// Dynamic shared memory of the walk per block, in bytes: NHV [H] and NFV +
// 5 [F] float vectors, gemm's tiles, the reduction slots; on the "fma32"
// route (G32) also gemm32's ring at the walk's column tile (both B
// layouts) after 16 bytes of room to align it. ops/mega_grad.py
// bwd_smem_bytes mirrors it.
__host__ __device__ constexpr size_t bwd_smem_bytes(int F, int H, bool G32) {
  return ((size_t)NHV * H + (size_t)(NFV + 5) * F + BK * (BM + 1) + BK * BN +
          NWARPS) * sizeof(float) +
         (G32 ? 16 + g32_ring<true, G32_WALK_BN>() * sizeof(float) : 0);
}
static_assert(bwd_smem_bytes(stair::FMA32_MAX_F, stair::FMA32_MAX_H, true) <=
                  232448,
              "the fma32 walk's shared memory fits one block's 227 KB");

template <typename T, bool G32 = false>
int launch_bwd(const void* const* p, void* ws, int B, int T_, int Nv, int Nf,
               int Na, int F, int H, int L, int fsoft, stair::Dropout dr,
               cudaStream_t stream, int cluster = 1, int* used = nullptr) {
  BArgs<T> a;
  a.fill(p);
  int i = NARGS;
  a.rv = (const T*)p[i++];
  a.rf = (const T*)p[i++];
  a.ra = (const T*)p[i++];
  a.drv = (const T*)p[i++];
  a.drf = (const T*)p[i++];
  a.dra = (const T*)p[i++];
  a.dvid = (T*)p[i++];
  a.dtok = (T*)p[i++];
  a.daux = (T*)p[i++];
  a.meta = (int*)p[i++];
  float** recs[] = {&a.X0, &a.D0, &a.X1, &a.D1, &a.X2,
                    &a.D2, &a.X3, &a.D3, &a.X4, &a.D4};
  for (float** r : recs) *r = (float*)p[i++];
  a.small = (float*)p[i++];
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
  const size_t smem = bwd_smem_bytes(F, H, G32);
  cudaError_t e = cudaFuncSetAttribute(
      mega_bwd_kernel<T, G32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  if constexpr (G32) {
    // the cluster mode (mega_common.cuh mega32_cluster)
    e = pick_cluster(mega_bwd_kernel<T, true>, smem, B, H, cluster, &a.C);
    if (used) *used = a.C;
    if (e == cudaSuccess)
      e = launch_clusters(mega_bwd_kernel<T, true>, B, a.C, smem, stream, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    mega_bwd_kernel<T, false><<<B, THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Each translation unit instantiates one route and compute dtype, so the
// three build in parallel: this file the general route in float32 (entry
// points *_f32), mega_grad_bf16.cu in bf16 (entry points *_bf16),
// mega_grad_fma32.cu the float32 "fma32" route (entry points *_fma32,
// stair_mega_exec_bwd_smem, stair_mega_f32_product_check).
#ifdef STAIR_GRAD_BF16
using GradT = __nv_bfloat16;
#define STAIR_GRAD_ENTRY(name) name##_bf16
#else
using GradT = float;
#define STAIR_GRAD_ENTRY(name) name##_f32
#endif

// Number of pointers stair_mega_exec_bwd_* takes: the NARGS prepare_args
// tensors, rv, rf, ra, drv, drf, dra, dvid, dtok, daux, meta, ten record
// buffers and the small partials.
constexpr int NBWD = NARGS + 10 + 2 * NSLOT + 1;

#ifndef STAIR_GRAD_FMA32
// ptrs: see NBWD. ws: float32 [B, Ws(Nv, Nf, Na, F, H, L, T).size]; record
// buffers X0..D2 [B*T, F, H], X3 [B*T, 3H], D3/X4/D4 [B*T, H], meta int32
// [B*T, 5, 3], small [B, Small(H, F).size], all float32 unless stated.
// dvid [B, F, H], dtok [B, L, H], daux [B, T, H] in the compute dtype.
// Returns cudaGetLastError() after the launch (or cudaErrorInvalidValue).
extern "C" int STAIR_GRAD_ENTRY(stair_mega_exec_bwd)(
    const void* const* ptrs, int nptrs, void* ws, int B, int T, int Nv,
    int Nf, int Na, int F, int H, int L, int fsoft, int drop, int seed0,
    int seed1, unsigned thresh, float scale, void* stream) {
  if (nptrs != NBWD || H > MAX_H || F > MAX_F || F > THREADS || L > MAX_L ||
      (H & 1))
    return (int)cudaErrorInvalidValue;
  const stair::Dropout dr{drop, seed0, seed1, thresh, scale};
  return launch_bwd<GradT>(ptrs, ws, B, T, Nv, Nf, Na, F, H, L, fsoft, dr,
                           (cudaStream_t)stream);
}

// ptrs: meta, X0, D0, ..., X4, D4, small (as stair_mega_exec_bwd_*), then
// the outputs: dW and db of the NTABLES record tables (table order: w1u,
// w2u, w2t, fdw, cw, eqw, xw, qw, taw1, taw2, exw1, exw2, supw; dW [E, K*H,
// H], db [E, H], float32) and the small tables' sum [Small(H, F).size].
extern "C" int STAIR_GRAD_ENTRY(stair_mega_exec_wgrad)(
    const void* const* ptrs, int nptrs, int B, int T, int F, int H,
    void* stream) {
  if (nptrs != 1 + 2 * NSLOT + 1 + 2 * NTABLES + 1)
    return (int)cudaErrorInvalidValue;
  WArgs a;
  int i = 0;
  a.meta = (const int*)ptrs[i++];
  for (int s = 0; s < NSLOT; ++s) {
    a.X[s] = (const float*)ptrs[i++];
    a.D[s] = (const float*)ptrs[i++];
  }
  a.small = (const float*)ptrs[i++];
  for (int t = 0; t < NTABLES; ++t) {
    a.dw[t] = (float*)ptrs[i++];
    a.db[t] = (float*)ptrs[i++];
  }
  a.dsmall = (float*)ptrs[i++];
  a.B = B;
  a.T_ = T;
  a.F = F;
  a.H = H;
  a.njobs = 11 + 11 + 4 + 10;  // sum of TB_E
  dim3 grid((H + BN - 1) / BN, (3 * H + BM - 1) / BM, a.njobs + 1);
  mega_wgrad_kernel<GradT><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#else
// The widths the "fma32" route takes (as mega_exec.cu fma32_takes): H a
// multiple of G32_BN in [G32_BN, FMA32_MAX_H], F in [FMA32_MIN_F,
// FMA32_MAX_F], L <= MAX_L.
static bool fma32_takes(int F, int H, int L) {
  return H % G32_BN == 0 && H >= G32_BN && H <= stair::FMA32_MAX_H &&
         F >= stair::FMA32_MIN_F && F <= stair::FMA32_MAX_F && L <= MAX_L;
}

// The "fma32" walk (mega_bwd_kernel<float, true>): float32 at the widths
// fma32_takes; arguments, records and outputs as stair_mega_exec_bwd_f32's,
// every output equal to its bit for bit at every cluster size. cluster:
// the CTAs of an example's cluster, 0 for the launch's pick
// (mega32_cluster) or forced (a divisor of H / G32_BN); *used gets the size
// launched. A cluster that cannot launch returns its error.
extern "C" int stair_mega_exec_bwd_fma32(
    const void* const* ptrs, int nptrs, void* ws, int B, int T, int Nv,
    int Nf, int Na, int F, int H, int L, int fsoft, int drop, int seed0,
    int seed1, unsigned thresh, float scale, int cluster, int* used,
    void* stream) {
  if (nptrs != NBWD || !fma32_takes(F, H, L) || B <= 0 || cluster < 0)
    return (int)cudaErrorInvalidValue;
  const stair::Dropout dr{drop, seed0, seed1, thresh, scale};
  return launch_bwd<float, true>(ptrs, ws, B, T, Nv, Nf, Na, F, H, L, fsoft,
                                 dr, (cudaStream_t)stream, cluster, used);
}

// Clusters of c CTAs of the "fma32" walk at (F, H) that fit the current
// card at once (cudaOccupancyMaxActiveClusters), or -1 on an error.
extern "C" int stair_mega_exec_bwd_fma32_fit(int F, int H, int c) {
  const size_t smem = bwd_smem_bytes(F, H, true);
  int fit = 0;
  if (cudaFuncSetAttribute(mega_bwd_kernel<float, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      clusters_fit(mega_bwd_kernel<float, true>, smem, c, &fit) !=
          cudaSuccess)
    return -1;
  return fit;
}

// The CTAs of an example's cluster that a launch of the "fma32" walk on B
// examples at (F, H) takes on the current card (mega32_cluster), or -1 on
// an error.
extern "C" int stair_mega_exec_bwd_fma32_cluster(int B, int F, int H) {
  const size_t smem = bwd_smem_bytes(F, H, true);
  int C = 0;
  if (cudaFuncSetAttribute(mega_bwd_kernel<float, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      pick_cluster(mega_bwd_kernel<float, true>, smem, B, H, 0, &C) !=
          cudaSuccess)
    return -1;
  return C;
}

// The "fma32" weight gradients: ptrs as stair_mega_exec_wgrad_f32's, then
// list (int32, B * T * (26 F + 10) rows of room: job_rows) and counts
// (int32 [36]), both scratch. Two launches: the index (and the small
// tables' sum), then mega_wgrad_fma32_kernel. Outputs equal
// stair_mega_exec_wgrad_f32's bit for bit.
extern "C" int stair_mega_exec_wgrad_fma32(const void* const* ptrs,
                                           int nptrs, int B, int T, int F,
                                           int H, void* stream) {
  if (nptrs != 1 + 2 * NSLOT + 1 + 2 * NTABLES + 1 + 2 || H % WG_TILE)
    return (int)cudaErrorInvalidValue;
  W32Args a;
  int i = 0;
  a.meta = (const int*)ptrs[i++];
  for (int s = 0; s < NSLOT; ++s) {
    a.X[s] = (const float*)ptrs[i++];
    a.D[s] = (const float*)ptrs[i++];
  }
  a.small = (const float*)ptrs[i++];
  for (int t = 0; t < NTABLES; ++t) {
    a.dw[t] = (float*)ptrs[i++];
    a.db[t] = (float*)ptrs[i++];
  }
  a.dsmall = (float*)ptrs[i++];
  a.list = (int*)ptrs[i++];
  a.counts = (int*)ptrs[i++];
  a.B = B;
  a.T_ = T;
  a.F = F;
  a.H = H;
  a.njobs = 11 + 11 + 4 + 10;  // sum of TB_E
  cudaStream_t st = (cudaStream_t)stream;
  const int small_blocks = (int)((Small(H, F).size + THREADS - 1) / THREADS);
  mega_wgrad_index_kernel<<<a.njobs + small_blocks, THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(mega_wgrad_fma32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)WG_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H / WG_TILE, 3 * H / WG_TILE, a.njobs);
  mega_wgrad_fma32_kernel<<<grid, WG_THREADS, WG_SMEM_BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the walk per block at (F, H): the general route
// (fma32 = 0) or the "fma32" route.
extern "C" long stair_mega_exec_bwd_smem(int F, int H, int fma32) {
  return (long)bwd_smem_bytes(F, H, fma32 != 0);
}

// The card check of gemm32 against gemm: block 0 runs gemm, block 1
// gemm32 with column tile bn (64, 128 or 256), reps times each, on A
// [M, K] and W [K, N] (nk = 0) or [N, K] (nk = 1), float32; outg and out32
// get the [M, N] sums, clk (int64 [2]) each block's clock64() span. M <=
// MAX_F (several row tiles of gemm32 past G32_BM), K and N multiples of 4.
extern "C" int stair_mega_f32_product_check(const void* A, const void* W,
                                            int M, int K, int N, int nk,
                                            int bn, int reps, void* outg,
                                            void* out32, void* clk,
                                            void* stream) {
  if (M < 1 || M > MAX_F || K % 4 || N % 4 || reps < 1)
    return (int)cudaErrorInvalidValue;
  const float* a = (const float*)A;
  const float* w = (const float*)W;
  float* g = (float*)outg;
  float* o = (float*)out32;
  long long* c = (long long*)clk;
  cudaStream_t st = (cudaStream_t)stream;
  if (bn == 64)
    return nk ? product_check<true, 64>(a, w, M, K, N, reps, g, o, c, st)
              : product_check<false, 64>(a, w, M, K, N, reps, g, o, c, st);
  if (bn == 128)
    return nk ? product_check<true, 128>(a, w, M, K, N, reps, g, o, c, st)
              : product_check<false, 128>(a, w, M, K, N, reps, g, o, c, st);
  if (bn == 256)
    return nk ? product_check<true, 256>(a, w, M, K, N, reps, g, o, c, st)
              : product_check<false, 256>(a, w, M, K, N, reps, g, o, c, st);
  return (int)cudaErrorInvalidValue;
}
#endif  // STAIR_GRAD_FMA32
