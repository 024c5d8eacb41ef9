// Executor megakernel, backward (training): the tensor-core route.
//
// Replaces the TPU kernel stair_tpu/ops/mega_grad.py _make_bwd_kernel,
// reached through backward_call / _train_fn (mega_exec_train), for bf16 at
// H a multiple of 64 up to TC_MAX_H and any F from TC_MIN_F to
// TC_ROUTE_MAX_F (ops/mega_grad.py bwd_route picks the route before the
// launch). float32 and every other width take the general route,
// mega_grad.cu (float32) and mega_grad_bf16.cu (bf16): mega_bwd_kernel and
// mega_wgrad_kernel, every product on gemm, float32 records. This file
// follows that design and changes its products and records:
//
// - The walk (mega_bwd_tc_kernel), one block per example in reverse, as
//   the general route's; where the forward runs its row-slice mode (F above
//   TC_MAX_F or ragged, the NMN CLIs' F 150), on the forward's thread-block
//   cluster: each CTA its frame rows of every [F, H] product, in slices of
//   at most TC_MAX_F rows, the lead CTA the rest (bwd_walk). Its recompute
//   products (stage 1, SUPF's keyword rows, the FilterFrame and Temporal
//   projections, the vec-level layers) rebuild values of this route's
//   training forward (#5, mega_exec_tc_kernel<true>), so they call #5's
//   own product code on the tensor cores: walk_gemm (tc_gemm at #5's k
//   order, the A rows staged from the files or records into a bf16 tile)
//   and vecmat_tc, with #5's epilogues; stair_mega_recompute_check
//   holds each equal to the forward's call on the card. The gradient
//   products whose operands are both exact in bf16 (the cotangent rounded
//   as it is loaded, as the JAX kernel's .astype(dt), and a bf16 weight
//   table: SUPF, FilterFrame and Temporal's rd(dY) @ W^T and stage 1's
//   two) run on mma.sync (grad_tc, tc_gemm); only their order of sums
//   changes. The products of the
//   float32 cotangent m1 (SUPF) stay on gemm.
// - Its records are bf16 rows (the weight products round them anyway:
//   half the bytes), and each (record, slot) gets a float32 [H] bias
//   partial, the row sum of the unrounded dY.
// - mega_wgrad_tc_kernel takes X^T dY on mma.sync over 128 x 128 tiles,
//   the rows of an expert's records gathered in (example, step) order into
//   32-row chunks through a cp.async ring, and sums the bias partials in
//   the same order. No float atomics: two runs give the same bits.
//
// What bounds it on an H100: one block per example (B = 128 blocks at the
// training shape, under one per SM): the latency of the per-step vec and
// elementwise passes over float32 [F, H] rows through L2, then the tensor-
// core products (about four recompute and four gradient products per heavy
// step). On a cluster (F 150: 3 CTAs) the products split by rows and the
// lead's passes stay whole.

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
// lnb [H], beta [F], t1/t2/t3 [3, F, F], tb1/tb2/tb3 [3, F]. (int: under
// MAX_H and MAX_F they stay far below 2^31, and half the registers.)
struct Small {
  int ffwf, ffkw, ffab, fltw, fltk, fltb, lns, lnb, beta, t1, t2, t3, tb1,
      tb2, tb3, size;
  __host__ __device__ Small(int H, int F) {
    int o = 0;
    ffwf = o; o += H;
    ffkw = o; o += H;
    ffab = o; o += 1;
    fltw = o; o += H;
    fltk = o; o += H;
    fltb = o; o += 1;
    lns = o; o += H;
    lnb = o; o += H;
    beta = o; o += F;
    t1 = o; o += 3 * F * F;
    t2 = o; o += 3 * F * F;
    t3 = o; o += 3 * F * F;
    tb1 = o; o += 3 * F;
    tb2 = o; o += 3 * F;
    tb3 = o; o += 3 * F;
    size = o;
  }
};

// Per-example float32 workspace, in floats: the general route's (mega_grad.cu
// Ws) and the float32 dY rows of the five record slots (d0 .. d4), kept
// until the step ends and its bf16 records and bias partials are written;
// the [F, H], [F, F] and [H] slots first, at strides of the route's largest
// F and H, so that their offsets are compile-time constants (no register
// holds them across the walk); the [Na, F] slot padded to 4 floats, so
// that at any F every slot and every example's workspace start on 16 bytes
// (the dY rows are staged as float4). ops/mega_grad.py workspace_floats
// mirrors it.
struct Ws {
  int grv, gra, grf, feat, hpre, h2, gfeat, w1, w2, gof, m1, m2, dtok, daux,
      d0, d1, d2, d3, d4, size;
  __host__ __device__ Ws(int Nv, int Nf, int Na, int F, int H, int L,
                         int T) {
    const int FH = F * H;
    int o = 0;
    const int S = stair::TC_ROUTE_MAX_F * stair::TC_MAX_H;
    const int SF = stair::TC_ROUTE_MAX_F * stair::TC_ROUTE_MAX_F;
    int* fh[] = {&feat, &hpre, &h2, &gfeat, &w1, &w2, &gof, &d0, &d1, &d2};
    for (int* f : fh) { *f = o; o += S; }
    m1 = o; o += SF;
    m2 = o; o += SF;
    d3 = o; o += stair::TC_MAX_H;
    d4 = o; o += stair::TC_MAX_H;
    grv = o; o += (long)Nv * H;
    gra = o; o += ((long)Na * F + 3) & ~3L;   // the next slots on 16 bytes
    grf = o; o += Nf * FH;
    dtok = o; o += (long)L * H;
    daux = o; o += (long)T * H;
    size = o;
  }
};

// The walk's arguments (records in bf16, RT; bias partials).
template <typename T>
struct BArgs : Tensors<T> {
  using RT = __nv_bfloat16;
  const T *rv, *rf, *ra, *drv, *drf, *dra;
  T *dvid, *dtok, *daux;
  int* meta;                       // [B, T, NSLOT, 3]: table, expert, rows
  RT *X0, *D0, *X1, *D1, *X2, *D2, *X3, *D3, *X4, *D4;
  float* bias;                     // [B, T, NSLOT, H] row sums of dY
  float* small;                    // [B, Small.size]
  float* ws;                       // [B, Ws.size]
  int B, T_, Nv, Nf, Na, F, H, L, fsoft;
  int C;                           // CTAs of an example's cluster
  stair::Dropout dr;
};

// Shared-memory scratch, laid out in dynamic shared memory; tc: the
// product scratch (a bf16 [tc_slice_rows(F), H + TC_PAD] operand tile and
// tc_gemm's ring, or vecmat_tc's partials).
struct Sh {
  float* hv[NHV];
  float* fv[NFV];
  float *vm, *aa, *ab, *goa, *goab;
  float *As, *Bs, *red, *tc;
};

// Dynamic shared memory of the walk in floats (the product scratch 16-byte
// aligned at the end: the larger of the operand tile of a row slice with
// tc_gemm's ring and vecmat_tc's partials); ops/mega_grad.py bwd_smem_bytes
// mirrors it. The vectors are laid out at the route's largest H and F, so
// that every shared-memory address is a compile-time offset and holds no
// register across the walk.
__host__ __device__ inline long bwd_smem_floats(int F, int H) {
  long n = (long)NHV * stair::TC_MAX_H +
           (long)(NFV + 5) * stair::TC_ROUTE_MAX_F + BK * (BM + 1) +
           BK * BN + NWARPS;
  n = (n + 3) & ~3L;
  const long t =
      ((long)tc_slice_rows(F) * (H + TC_PAD) + tc_ring<TC_BN>()) / 2;
  return n + (t > TC_PARTS ? t : TC_PARTS);
}

__device__ inline void sync() { __syncthreads(); }

// out[k] = sum_n rd(g[n]) * W[k * ldw + n] for k < K (the JAX kernel's
// mmT: g.astype(dt) @ W^T). Warp per MV_ROWS rows of W; lanes walk the
// rows, 8 bf16 a lane as one 16-byte vector (N % 8 == 0).
constexpr int MV_ROWS = 4;

template <typename T>
__device__ void mmT_vec(const float* g, const T* W, long ldw, int K, int N,
                        float* out) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k0 = MV_ROWS * w; k0 < K; k0 += MV_ROWS * NWARPS) {
    float acc[MV_ROWS];
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) acc[r] = 0.f;
    for (int n = lane * 8; n < N; n += 256) {
      float gv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gv[i] = rd<T>(g[n + i]);
#pragma unroll
      for (int r = 0; r < MV_ROWS; ++r) {
        if (k0 + r >= K) break;
        const uint4 v =
            *reinterpret_cast<const uint4*>(W + (k0 + r) * ldw + n);
        const __nv_bfloat162* p =
            reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(p[i]);
          acc[r] += gv[2 * i] * f.x + gv[2 * i + 1] * f.y;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < MV_ROWS; ++r) {
      const float v = warp_sum(acc[r]);
      if (lane == 0 && k0 + r < K) out[k0 + r] = v;
    }
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
template <typename TR>
__device__ void cos_rows_bwd(const float* g, const TR* rows, const float* kw,
                             int F, int H, float* grows, float* gkw, Sh& s) {
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
  pass<true>((size_t)F * H, [&](size_t i) {
    const int f = (int)(i / H), k = (int)(i % H);
    return grows[i] + (gdot[f] * kw[k] + 2.0f * gnr[f] * to_f(rows[i]));
  }, [&](size_t i, float v) { grows[i] = v; });
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
template <typename T, typename RX, typename Score, typename Act>
__device__ void superlative_bwd(int K, Score score, Act act,
                                const float* amask, int mode, const T* supw,
                                const T* supb, const float* gov, int H,
                                int F, float* wv, float* grow, float* gpool,
                                RX* X3, float* D3, int* meta, Sh& s) {
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
    X3[j] = from_f<RX>(pooled[j]);
  }
  sync();
  auto epi = [&](int n, float y) {
    const float pre = rd<T>(rd<T>(y) + to_f(supb[n]));
    g1[n] = pre > 0.f ? gov[n] : 0.f;
    D3[n] = g1[n];
  };
  vecmat_tc(pooled, nullptr, nullptr, supw, H, H, s.tc, epi);
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

// rd(D) @ W^T on the tensor cores (the walk's gradient products) over rows
// [0, rows) of D (a row slice, rows <= TC_MAX_F): D float32 [rows, H] is
// rounded to bf16 as it is staged into a tile in shared memory (the JAX
// kernel's .astype(dt) of the cotangent; zero rows to a multiple of 16), B(k,
// n) = W[n * H + k]; scratch holds the tile, then tc_gemm's ring. epi(m, n,
// acc) per output row m < rows.
template <typename Epi>
__device__ void grad_tc(const float* D, const __nv_bfloat16* W, int rows, int H,
                        float* scratch, Epi epi) {
  __nv_bfloat16* At = reinterpret_cast<__nv_bfloat16*>(scratch);
  const int ld = H + TC_PAD, M = (rows + 15) & ~15;
  stage_rows(At, ld, D, H, rows, H);
  tc_gemm<true>(At, ld, W, H, M, H, H, At + (size_t)M * ld,
                [&](int m, int n, float acc) {
                  if (m < rows) epi(m, n, acc);
                });
}

// The reverse walk of one example: #5's walk_gemm and vecmat_tc
// for the recompute products, grad_tc for the bf16 gradient products, bf16
// records with bias partials. Example b on a cluster of C = a.C CTAs (1:
// one CTA an example), the forward's: CTA r runs its frame rows of every
// [F, H] product (tc_slices; every product's operand and output rows live
// in the files, the records and the workspace), CTA 0, the lead, runs
// every other pass in the one-CTA order and writes every gradient, record
// and bias partial; the others wait at the products' cluster barriers. So
// every output equals one CTA's bit for bit at any C.
template <typename T>
__device__ __forceinline__ void bwd_walk(const BArgs<T>& a, int* ins) {
  using RT = typename BArgs<T>::RT;
  extern __shared__ __align__(16) float smem[];
  const int C = a.C;
  const int b = (int)(blockIdx.x / C);
  auto lead = [&] { return blockIdx.x % C == 0; };
  const int F = a.F, H = a.H, L = a.L, T_ = a.T_, Hh = H / 2;
  const int Nv = a.Nv, Nf = a.Nf, Na = a.Na;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const stair::Dropout& dr = a.dr;   // read where used, from the arguments
  const size_t FH = (size_t)F * H;

  // vector strides: compile-time (bwd_smem_floats)
  constexpr int SH = stair::TC_MAX_H, SF = stair::TC_ROUTE_MAX_F;
  Sh s;
  {
    float* p = smem;
    for (int i = 0; i < NHV; ++i) { s.hv[i] = p; p += SH; }
    for (int i = 0; i < NFV; ++i) { s.fv[i] = p; p += SF; }
    s.vm = p; p += SF;
    s.aa = p; p += SF;
    s.ab = p; p += SF;
    s.goa = p; p += SF;
    s.goab = p; p += SF;
    s.As = p; p += BK * (BM + 1);
    s.Bs = p; p += BK * BN;
    s.red = p; p += NWARPS;
    s.tc = smem + ((p - smem + 3) & ~3L);
  }
  float *va = s.hv[0], *vb = s.hv[1], *vc = s.hv[2], *gov = s.hv[3];
  float *x1 = s.hv[4], *x2 = s.hv[5], *u1 = s.hv[6], *u2 = s.hv[7];
  float* vm = s.vm;

  const Ws wl(Nv, Nf, Na, F, H, L, T_);
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
  const Small sl(H, F);
  float* sp = a.small + (size_t)b * sl.size;

  const T* rv = a.rv + (size_t)b * Nv * H;
  const T* rf = a.rf + (size_t)b * Nf * FH;
  const T* ra = a.ra + (size_t)b * Na * F;

  // ---- init: cotangents in (f32), accumulators zeroed -------------------
  if (lead()) {
    for (int f = tid; f < F; f += THREADS)
      vm[f] = to_f(a.vm[(size_t)b * F + f]);
    for (int i = tid; i < Nv * H; i += THREADS)
      grv[i] = to_f(a.drv[(size_t)b * Nv * H + i]);
    for (int i = tid; i < Na * F; i += THREADS)
      gra[i] = to_f(a.dra[(size_t)b * Na * F + i]);
    for (size_t i = tid; i < Nf * FH; i += THREADS)
      grf[i] = to_f(a.drf[(size_t)b * Nf * FH + i]);
    for (size_t i = tid; i < (size_t)L * H; i += THREADS) dtokw[i] = 0.f;
    for (size_t i = tid; i < (size_t)T_ * H; i += THREADS) dauxw[i] = 0.f;
    for (int i = tid; i < sl.size; i += THREADS) sp[i] = 0.f;
  }
  sync();

  auto clampi = [](int v, int n) { return v < 0 ? 0 : (v >= n ? n - 1 : v); };

  // [F, H] @ [H, H] products, this CTA's rows of them (every CTA of the
  // cluster calls each): the recompute of a forward value (A bf16 rows of a
  // file or a record, B(k, n) = B[k * H + n]), bit for bit as #5 computed
  // it; and a gradient product rd(D) @ W^T. epi(m, n, acc) per output row m
  // of the example.
  auto recompute = [&](const RT* A, const T* Bm, auto epi) {
    tc_slices(F, C, [&](int m0, int rows) {
      walk_gemm(A + (size_t)m0 * H, H, Bm, rows, H, H,
                reinterpret_cast<RT*>(s.tc),
                [&](int m, int n, float acc) { epi(m0 + m, n, acc); });
    });
  };
  // the vec-level recompute ([1, H] @ [H, H] over up to three segments)
  auto vecmul = [&](const float* x0, const float* x1, const float* x2,
                    const T* W, auto epi) {
    vecmat_tc(x0, x1, x2, W, H, H, s.tc, epi);
  };
  auto grad = [&](const float* D, const T* W, auto epi) {
    tc_slices(F, C, [&](int m0, int rows) {
      grad_tc(D + (size_t)m0 * H, W, rows, H, s.tc,
              [&](int m, int n, float acc) { epi(m0 + m, n, acc); });
    });
  };

  for (int t = T_ - 1; t >= 0; --t) {
    if (tid < NSF) ins[tid] = a.scal[((size_t)b * T_ + t) * NSF + tid];
    const size_t rec = (size_t)b * T_ + t;
    int* meta = a.meta + rec * NSLOT * 3;
    // Record slot q of this step: its X rows (RT) and dY rows (float32, in
    // the workspace until the step ends), taken
    // where an op writes them, so that no register holds them across it.
    const size_t rw[NSLOT] = {FH, FH, FH, (size_t)H, (size_t)H};
    auto Xq = [&](int q) -> RT* {
      RT* const x[NSLOT] = {a.X0, a.X1, a.X2, a.X3, a.X4};
      return x[q] + rec * (q == 3 ? 3 * (size_t)H : rw[q]);
    };
    auto Dq = [&](int q) -> float* {
      const int d[NSLOT] = {wl.d0, wl.d1, wl.d2, wl.d3, wl.d4};
      return ws + d[q];
    };
    if (lead() && tid < NSLOT) {
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
        pass<true>(FH, [&](size_t i) { return grf[(size_t)out_f * FH + i]; },
                   [&](size_t i, float v) { gof[i] = v; });
      sync();
    }

    // ---- stage-1 recompute: hidden into X1 (the w2u record's X), its
    // pre-activation, h2, and feat -------------------------------------
    const T* sw1 = a.w1u + (size_t)e1 * H * H;
    const T* sb1 = a.b1u + (size_t)e1 * H;
    const T* sw2 = a.w2u + (size_t)e1 * H * H;
    const T* sb2 = a.b2u + (size_t)e1 * H;
    if (e1 != 9) {
      RT* const X1 = Xq(1);
      // store-only epilogues (the pre-activations), then batched passes
      // for #5's rounding epilogues
      recompute(fa, sw1, [&](int m, int n, float acc) {
        hpre[(size_t)m * H + n] = acc + to_f(sb1[n]);
      });
      if (lead()) {
        pass<true>(FH, [&](size_t i) {
          return rd<T>(fmaxf(hpre[i], 0.f) *
                       dr.keep((int)(i / H), (int)(i % H), b, t, 0));
        }, [&](size_t i, float v) { X1[i] = from_f<RT>(v); });
        sync();
      }
      recompute(X1, sw2, [&](int m, int n, float acc) {
        h2w[(size_t)m * H + n] = acc + to_f(sb2[n]);
      });
      if (lead()) {
        pass<true>(FH, [&](size_t i) {
          const float v = h2w[i];
          return rd<T>(is_filter ? fmaxf(v, 0.f) * dr.keep((int)(i / H),
                                                           (int)(i % H), b,
                                                           t, 1)
                                 : v);
        }, [&](size_t i, float v) { feat[i] = v; });
        sync();
      }
    }

    // ================= vec producers (the lead; SUPF's products on every
    // CTA of the cluster) ==================================================
    if (!lead() && op != OP_SUPF) {
    } else if (op == OP_PUSH) {
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
      RT* const X3 = Xq(3);
      float* const D3 = Dq(3);
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
          X3[j] = from_f<RT>(x1[j]);
          X3[H + j] = from_f<RT>(va[j]);
          X3[2 * H + j] = from_f<RT>(vb[j]);
        } else {
          X3[j] = from_f<RT>(va[j]);
          X3[H + j] = from_f<RT>(vb[j]);
        }
      }
      sync();
      auto epi = [&](int n, float y) {
        const float pre = rd<T>(rd<T>(y) + to_f(bb[n]));
        g1[n] = pre > 0.f ? gov[n] : 0.f;
        D3[n] = g1[n];
      };
      if (x)
        vecmul(x1, va, vb, w, epi);
      else
        vecmul(va, vb, nullptr, w, epi);
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
      RT* const X3 = Xq(3);
      float* const D3 = Dq(3);
      float* g1 = s.hv[9];
      for (int j = tid; j < H; j += THREADS) X3[j] = from_f<RT>(va[j]);
      vecmul(va, nullptr, nullptr, a.qw, [&](int n, float y) {
        const float pre = rd<T>(rd<T>(y) + to_f(a.qb[n]));
        g1[n] = pre > 0.f ? gov[n] * dr.keep(0, n, b, t, 4) : 0.f;
        D3[n] = g1[n];
      });
      set_meta(meta, 3, TB_QW, 0, 1);
      sync();
      mmT_vec<T>(g1, a.qw, H, H, H, u1);
      for (int j = tid; j < H; j += THREADS) grv[(size_t)iva * H + j] += u1[j];
      sync();
    } else if (op == OP_TOA || op == OP_EX) {
      RT* const X3 = Xq(3);
      float* const D3 = Dq(3);
      RT* const X4 = Xq(4);
      float* const D4 = Dq(4);
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
          X3[j] = from_f<RT>(vb[j]);
          X3[H + j] = from_f<RT>(va[j]);
          X3[2 * H + j] = from_f<RT>(x1[j]);
        } else {
          X3[j] = from_f<RT>(va[j]);
          X3[H + j] = from_f<RT>(vb[j]);
        }
      }
      sync();
      auto epiA = [&](int n, float y) {
        pre1[n] = rd<T>(rd<T>(y) + to_f(bA[n]));
        hh[n] = rd<T>(fmaxf(pre1[n], 0.f) * dr.keep(0, n, b, t, siteA));
        X4[n] = from_f<RT>(hh[n]);
      };
      if (ex)
        vecmul(vb, va, x1, wA, epiA);
      else
        vecmul(va, vb, nullptr, wA, epiA);
      sync();
      vecmul(hh, nullptr, nullptr, wB, [&](int n, float y) {
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
      RT* const X3 = Xq(3);
      float* const D3 = Dq(3);
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
        X3[k] = from_f<RT>(x1[k]);
      }
      sync();
      vecmul(x1, nullptr, nullptr, a.fdw, [&](int n, float y) {
        const float pre = rd<T>(rd<T>(y) + to_f(a.fdb[n]));
        g1[n] = pre > 0.f ? gov[n] : 0.f;
        D3[n] = g1[n];
      });
      set_meta(meta, 3, TB_FDW, 0, 1);
      sync();
      mmT_vec<T>(g1, a.fdw, H, H, H, gpool);
      pass<true>(FH, [&](size_t i) {
        return gfeat[i] + wvm[i / H] * gpool[i % H];
      }, [&](size_t i, float v) { gfeat[i] = v; });
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
        pass<true>(FH, [&](size_t i) {
          return gfeat[i] + gl[i / H] * to_f(a.fltw[i % H]);
        }, [&](size_t i, float v) { gfeat[i] = v; });
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
    } else if (op == OP_LOC || op == OP_SUPV || op == OP_SUPF) {
      RT* const X3 = Xq(3);
      float* const D3 = Dq(3);
      RT* const X2 = Xq(2);
      float* const D2 = Dq(2);
      const T* wk = a.w2t + 2 * (size_t)H * H;
      const T* bk = a.b2t + 2 * (size_t)H;
      float* gkw = s.hv[11];
      if (op != OP_SUPF) {
        // keywords ka, kb = lin_dt(va|vb, w2t[2], b2t[2]) into x1, x2
        vecmul(va, nullptr, nullptr, wk, [&](int n, float y) {
          x1[n] = rd<T>(rd<T>(y) + to_f(bk[n]));
        });
        vecmul(vb, nullptr, nullptr, wk, [&](int n, float y) {
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
            X2[(size_t)q * H + j] = from_f<RT>(vsrc[j]);
            D2[(size_t)q * H + j] = gkw[j];
          }
          mmT_vec<T>(gkw, wk, H, H, H, u2);
          for (int j = tid; j < H; j += THREADS)
            grv[(size_t)idx[q] * H + j] += u2[j];
          sync();
        }
        set_meta(meta, 2, TB_W2T, 2, 2);
      } else {
        // SUPF: kw_f = lin_dt(fb, w2t[2], b2t[2]) [F, H] into w1 (the
        // forward's product), cosine matrix vs feat, superlative VJP over
        // the F candidate rows of fb, then the cosine-matrix VJP.
        const T* fb = rf + (size_t)ifb * FH;
        float* gfb = grf + (size_t)ifb * FH;
        recompute(fb, wk, [&](int m, int n, float acc) {
          w1[(size_t)m * H + n] = rd<T>(rd<T>(acc) + to_f(bk[n]));
        });
        if (lead()) {
          gemm<T, false, false>(w1, H, 1, feat, 1, H, F, H, F, s.As, s.Bs,
                                [&](int m, int n, float acc) {
            m2[(size_t)m * F + n] = acc;  // dots[i][f]
          });
          float* nk = s.fv[0];
          float* nf = s.fv[1];
          float* ssk = s.fv[2];
          float* ssf = s.fv[3];
          for (int r = warp; r < F; r += NWARPS) {
            float n1 = 0.f, n2 = 0.f;
            for (int k = lane; k < H; k += 32) {
              const float x = w1[(size_t)r * H + k];
              const float y = feat[(size_t)r * H + k];
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
        pass<true>(FH, [&](size_t i) { return gfb[i] + wv[i / H] * u1[i % H]; },
                 [&](size_t i, float v) { gfb[i] = v; });
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
        pass<true>(FH, [&](size_t i) { return to_f(fb[i]); },
                 [&](size_t i, float v) { X2[i] = from_f<RT>(v); });
        set_meta(meta, 2, TB_W2T, 2, F);
        }
        // fb += mmT(g_kf, w2t[2]): the product stored, then added in a
        // batched pass
        grad(D2, wk, [&](int m, int n, float acc) {
          w2[(size_t)m * H + n] = acc;
        });
        if (lead()) {
          pass<true>(FH, [&](size_t i) { return gfb[i] + w2[i]; },
                     [&](size_t i, float v) { gfb[i] = v; });
          sync();
        }
      }
    }

    // ================= frames producers ================================
    if (op == OP_FFV || op == OP_FFK) {
      RT* const X2 = Xq(2);
      float* const D2 = Dq(2);
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
        pass<true>(FH, [&](size_t i) { return rd<T>(gate[i / H] * feat[i]); },
                 [&](size_t i, float v) { X2[i] = from_f<RT>(v); });
        sync();
      }
      // D2 = relu'(y2) * g_out * vm * mask: y2 stored, the rest applied in
      // a batched pass
      auto d2_of = [&](int m, int n, float y2) {
        return y2 > 0.f
            ? gof[(size_t)m * H + n] * vm[m] * dr.keep(m, n, b, t, 2)
            : 0.f;
      };
      recompute(X2, a.w2t, [&](int m, int n, float acc) {
        const float y2 = acc + to_f(a.b2t[n]);
        D2[(size_t)m * H + n] = y2;
      });
      if (lead()) {
        pass<true>(FH, [&](size_t i) {
          return d2_of((int)(i / H), (int)(i % H), D2[i]);
        }, [&](size_t i, float v) { D2[i] = v; });
        sync();
        set_meta(meta, 2, TB_W2T, 0, F);
      }
      grad(D2, a.w2t, [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc;  // gx2
      });
      if (lead()) {
        pass<true>(FH,
                   [&](size_t i) { return gfeat[i] + gate[i / H] * w2[i]; },
                   [&](size_t i, float v) { gfeat[i] = v; });
        sync();
      }
      if (op == OP_FFV && lead()) {
        float* gpre = s.fv[1];
        for (int f = warp; f < F; f += NWARPS) {
          float d = 0.f;
          for (int k = lane; k < H; k += 32)
            d += w2[(size_t)f * H + k] * feat[(size_t)f * H + k];
          d = warp_sum(d);
          if (lane == 0) gpre[f] = d * gate[f] * (1.0f - gate[f]);
        }
        sync();
        pass<true>(FH, [&](size_t i) {
          return gfeat[i] + gpre[i / H] * to_f(a.ffwf[i % H]);
        }, [&](size_t i, float v) { gfeat[i] = v; });
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
    } else if (op == OP_TEMP) {
      RT* const X2 = Xq(2);
      float* const D2 = Dq(2);
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
        for (int i = 0; i < F; ++i) acc += h1[i] * to_f(t2w[(size_t)i * F + j]);
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
      pass<true>(FH, [&](size_t i) { return rd<T>(rel[i / H] * to_f(fa[i])); },
               [&](size_t i, float v) { X2[i] = from_f<RT>(v); });
      sync();
      }
      // y2 into w2, ry = relu(y2) * mask into w1
      recompute(X2, a.w2t + (size_t)H * H, [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc + to_f(a.b2t[H + n]);
      });
      float* mgx = s.fv[9];
      float* mgxx = s.fv[10];
      if (lead()) {
        pass<true>(FH, [&](size_t i) {
          return fmaxf(w2[i], 0.f) *
                 dr.keep((int)(i / H), (int)(i % H), b, t, 2);
        }, [&](size_t i, float v) { w1[i] = v; });
        sync();
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
      pass<true>(FH, [&](size_t i) {
        const int f = (int)(i / H), k = (int)(i % H);
        const float xhat = (w1[i] - mu[f]) * rstd[f];
        const float gx = gof[i] * to_f(a.lns[k]);
        const float gb = rstd[f] * (gx - mgx[f] - xhat * mgxx[f]);
        return w2[i] > 0.f ? gb * dr.keep(f, k, b, t, 2) : 0.f;
      }, [&](size_t i, float v) { D2[i] = v; });
      set_meta(meta, 2, TB_W2T, 1, F);
      sync();
      }
      grad(D2, a.w2t + (size_t)H * H, [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc;  // gx2
      });
      float *gr0 = s.fv[7], *gp3 = s.fv[8], *gh2 = s.fv[9], *gh1 = s.fv[10];
      if (lead()) {
        pass<true>(FH, [&](size_t i) { return gfa[i] + rel[i / H] * w2[i]; },
                 [&](size_t i, float v) { gfa[i] = v; });
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
      pass<true>(FH, [&](size_t i) { return gfa[i] + s.aa[i / H] * gof[i]; },
               [&](size_t i, float v) { gfa[i] = v; });
      for (int f = warp; f < F; f += NWARPS) {
        float d = 0.f;
        for (int k = lane; k < H; k += 32)
          d += gof[(size_t)f * H + k] * to_f(fa[(size_t)f * H + k]);
        d = warp_sum(d);
        if (lane == 0) gra[(size_t)iaa * F + f] += d;
      }
      sync();
    }

    // ================= attn producers (the lead) =======================
    if (!lead()) {
    } else if (op == OP_ANDA || op == OP_XORF) {
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
      for (int j = tid; j < H; j += THREADS) grv[(size_t)iva * H + j] += u1[j];
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

    // ---- stage-1 backward over the collected g_feat ---------------------
    if (e1 != 9) {
      RT* const X0 = Xq(0);
      float* const D0 = Dq(0);
      float* const D1 = Dq(1);
      if (lead()) {
        pass<true>(FH, [&](size_t i) {
          const int m = (int)(i / H), n = (int)(i % H);
          return is_filter ? (h2w[i] > 0.f
                                  ? gfeat[i] * dr.keep(m, n, b, t, 1)
                                  : 0.f)
                           : gfeat[i];
        }, [&](size_t i, float v) { D1[i] = v; });
        pass<true>(FH, [&](size_t i) { return to_f(fa[i]); },
                   [&](size_t i, float v) { X0[i] = from_f<RT>(v); });
        set_meta(meta, 1, TB_W2U, e1, F);
        set_meta(meta, 0, TB_W1U, e1, F);
        sync();
      }
      auto d0_of = [&](size_t i, float acc) {
        return hpre[i] > 0.f
            ? acc * dr.keep((int)(i / H), (int)(i % H), b, t, 0) : 0.f;
      };
      // store-only epilogues, then batched passes for the mask and the
      // accumulation
      grad(D1, sw2, [&](int m, int n, float acc) {
        D0[(size_t)m * H + n] = acc;
      });
      if (lead()) {
        pass<true>(FH, [&](size_t i) { return d0_of(i, D0[i]); },
                   [&](size_t i, float v) { D0[i] = v; });
        sync();
      }
      grad(D0, sw1, [&](int m, int n, float acc) {
        w2[(size_t)m * H + n] = acc;
      });
      if (lead())
        pass<true>(FH, [&](size_t i) { return gfa[i] + w2[i]; },
                   [&](size_t i, float v) { gfa[i] = v; });
    }

    // ---- the step's records as bf16 rows, and each
    // used slot's bias partial (the float32 row sum of dY, rows in order) -
    sync();   // every CTA: this step's reads of ins are done
    if (lead()) {
      RT* const Rs[NSLOT] = {a.D0, a.D1, a.D2, a.D3, a.D4};
      for (int q = 0; q < NSLOT; ++q) {
        if (meta[q * 3] < 0) continue;
        const int rows = meta[q * 3 + 2];
        const float* Dv = Dq(q);
        RT* R = Rs[q] + rec * rw[q];
        float* bias = a.bias + (rec * NSLOT + q) * H;
        for (int n = tid; n < H; n += THREADS) {
          float sum = 0.f;
          for (int r0 = 0; r0 < rows; r0 += 8) {   // 8 rows' loads in flight
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              v[j] = r0 + j < rows ? Dv[(size_t)(r0 + j) * H + n] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (r0 + j < rows) {
                sum += v[j];
                R[(size_t)(r0 + j) * H + n] = from_f<RT>(v[j]);
              }
            }
          }
          bias[n] = sum;
        }
      }
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

__global__ void __launch_bounds__(THREADS)
    mega_bwd_tc_kernel(const BArgs<__nv_bfloat16> a) {
  __shared__ int ins[NSF];
  bwd_walk<__nv_bfloat16>(a, ins);
}

// The small tables' sum (the job past the record tables): one flat element
// range over the grid's (x, y) blocks, examples summed in order.
__device__ void small_sum(const float* small, float* dsmall, int B, int H,
                          int F) {
  const long n = Small(H, F).size;
  const long stride = (long)gridDim.x * gridDim.y * THREADS;
  for (long e = ((long)blockIdx.y * gridDim.x + blockIdx.x) * THREADS +
                threadIdx.x;
       e < n; e += stride) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += small[(size_t)b * n + e];
    dsmall[e] = acc;
  }
}

// Weight gradients of the tensor-core route: block (n tile, k tile, job)
// owns the WG_TILE x WG_TILE tile of dW[table][expert] = X^T dY over the
// bf16 records. It takes the records of its (table, expert) in (example,
// step) order, a window of THREADS records at a time (compacted by a block
// scan), and streams their rows in WG_KC-row chunks through a two-stage
// cp.async ring (a chunk may span records: the vec slots have one row a
// record), with mma.sync on each chunk: warp w owns rows 64 (w % 2) and
// columns 32 (w / 2) of the tile. The k-tile-0 blocks sum the records' bias
// partials in the same order. No atomics: two runs give the same bits.
constexpr int WG_TILE = 128, WG_KC = 32, WG_LD = WG_TILE + 8;

struct WTArgs {
  const int* meta;
  const __nv_bfloat16 *X[NSLOT], *D[NSLOT];
  const float* bias;
  const float* small;
  float* dw[NTABLES];
  float* db[NTABLES];
  float* dsmall;
  int B, T_, F, H, njobs;
};

// Exclusive prefix sum of v over the block; total gets the sum.
__device__ int block_scan(int v, int* wsum, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) wsum[w] = x;
  __syncthreads();
  int off = 0;
  total = 0;
  for (int i = 0; i < NWARPS; ++i) {
    off += i < w ? wsum[i] : 0;
    total += wsum[i];
  }
  return off + x - v;
}

__global__ void __launch_bounds__(THREADS)
    mega_wgrad_tc_kernel(const WTArgs a) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 Xs[2][WG_KC][WG_LD];
  __shared__ __align__(16) bf16 Ds[2][WG_KC][WG_LD];
  __shared__ int rec_of[THREADS];
  __shared__ int start[THREADS + 1];
  __shared__ int wsum[NWARPS];
  const int H = a.H, F = a.F;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if ((int)blockIdx.z >= a.njobs) {
    small_sum(a.small, a.dsmall, a.B, H, F);
    return;
  }
  int job = blockIdx.z, table = 0;
  while (job >= TB_E[table]) job -= TB_E[table++];
  const int expert = job;
  const int Kin = TB_K[table] * H, slot = TB_SLOT[table];
  const int k0 = blockIdx.y * WG_TILE, n0 = blockIdx.x * WG_TILE;
  if (k0 >= Kin || n0 >= H) return;
  const long xrow = slot == 3 ? 3L * H : H;  // X row stride of the slot
  const long xrec = slot <= 2 ? (long)F * H : xrow;
  const long drec = slot <= 2 ? (long)F * H : H;
  const bf16* X = a.X[slot];
  const bf16* D = a.D[slot];
  const int wm = warp & 1, wn = warp >> 1;
  const int lr = lane & 7, q1 = (lane >> 3) & 1, q2 = lane >> 4;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float bsum = 0.f;   // column n0 + tid of db (k tile 0, tid < WG_TILE)
  const int nrec = a.B * a.T_;
  for (int base = 0; base < nrec; base += THREADS) {
    const int r = base + tid;
    bool match = false;
    int rows = 0;
    if (r < nrec) {
      const int* m = a.meta + ((size_t)r * NSLOT + slot) * 3;
      match = m[0] == table && m[1] == expert;
      rows = match ? m[2] : 0;
    }
    int nm, R;
    const int pos = block_scan(match ? 1 : 0, wsum, nm);
    const int row0 = block_scan(rows, wsum, R);
    if (match) {
      rec_of[pos] = r;
      start[pos] = row0;
    }
    if (tid == 0) start[nm] = R;
    __syncthreads();
    if (k0 == 0 && tid < WG_TILE && n0 + tid < H)
      for (int j = 0; j < nm; ++j)
        bsum += a.bias[((size_t)rec_of[j] * NSLOT + slot) * H + n0 + tid];
    // chunk rows g0 .. g0 + WG_KC - 1 of the window into stage st
    auto load = [&](int st, int g0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tid + h * THREADS;   // 16 pieces of 8 a row
        const int rr = p / (WG_TILE / 8), c = p % (WG_TILE / 8);
        const int g = g0 + rr;
        const bool in = g < R;
        long xo = 0, dof = 0;
        if (in) {
          int lo = 0, hi = nm - 1;   // the last record starting at <= g
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (start[mid] <= g) lo = mid; else hi = mid - 1;
          }
          const long rec = rec_of[lo], row = g - start[lo];
          xo = rec * xrec + row * xrow;
          dof = rec * drec + row * H;
        }
        const bool xin = in && k0 + c * 8 < Kin, din = in && n0 + c * 8 < H;
        stair::cp_async16(&Xs[st][rr][c * 8],
                          X + (xin ? xo + k0 + c * 8 : 0), xin);
        stair::cp_async16(&Ds[st][rr][c * 8],
                          D + (din ? dof + n0 + c * 8 : 0), din);
      }
      stair::cp_async_commit();
    };
    const int nch = (R + WG_KC - 1) / WG_KC;
    if (nch > 0) load(0, 0);
    for (int ch = 0; ch < nch; ++ch) {
      stair::cp_async_wait<0>();
      __syncthreads();   // chunk ch landed; chunk ch - 1's stage is free
      if (ch + 1 < nch) load((ch + 1) & 1, (ch + 1) * WG_KC);
      const int st = ch & 1;
#pragma unroll
      for (int kk = 0; kk < WG_KC; kk += 16) {
        uint32_t af[4][4], bf[2][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)   // A[k_in][row] = Xs[row][k_in]
          stair::ldmatrix_x4_trans(
              af[x], &Xs[st][kk + lr + q2 * 8][wm * 64 + x * 16 + q1 * 8]);
#pragma unroll
        for (int y = 0; y < 2; ++y)   // B[row][n] = Ds[row][n]
          stair::ldmatrix_x4_trans(
              bf[y], &Ds[st][kk + lr + q1 * 8][wn * 32 + y * 16 + q2 * 8]);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            stair::mma_bf16(acc[x][y], af[x], bf[y / 2][(y % 2) * 2],
                            bf[y / 2][(y % 2) * 2 + 1]);
      }
    }
    __syncthreads();   // the window's lists and ring are free
  }
  float* dw = a.dw[table] + (size_t)expert * Kin * H;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int k = k0 + wm * 64 + x * 16 + g;
      const int n = n0 + wn * 32 + y * 8 + tq * 2;
      if (n < H) {
        if (k < Kin)
          *reinterpret_cast<float2*>(dw + (size_t)k * H + n) =
              make_float2(acc[x][y][0], acc[x][y][1]);
        if (k + 8 < Kin)
          *reinterpret_cast<float2*>(dw + (size_t)(k + 8) * H + n) =
              make_float2(acc[x][y][2], acc[x][y][3]);
      }
    }
  if (k0 == 0 && tid < WG_TILE && n0 + tid < H)
    a.db[table][(size_t)expert * H + n0 + tid] = bsum;
}

// The walk's cluster size for B examples at (F, H): `cluster` where forced
// (> 0), one CTA at the widths the forward's shared tiles hold, else
// tc_cluster over the walk's CTA slots. Sets the walk's shared memory.
static cudaError_t bwd_tc_pick(int B, int F, int H, int cluster, int* C) {
  const size_t smem = bwd_smem_floats(F, H) * sizeof(float);
  *C = cluster > 0 ? cluster : 1;
  cudaError_t e = cudaFuncSetAttribute(
      mega_bwd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess || cluster > 0 || !(F % 16 || F > stair::TC_MAX_F))
    return e;
  int slots = 0;
  e = cta_slots(mega_bwd_tc_kernel, smem, &slots);
  *C = tc_cluster(B, F, slots);
  return e;
}

// cluster: as launch_tc's (mega_exec.cu): 0 for the forward's rule (one CTA
// at the widths its shared tiles hold, else tc_cluster over the walk's own
// CTA slots: one an SM, as the forward's), else forced; *used gets the size
// launched.
template <typename T>
int launch_bwd(const void* const* p, void* ws, int B, int T_, int Nv, int Nf,
               int Na, int F, int H, int L, int fsoft, stair::Dropout dr,
               cudaStream_t stream, int cluster, int* used) {
  using RT = typename BArgs<T>::RT;
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
  RT** recs[] = {&a.X0, &a.D0, &a.X1, &a.D1, &a.X2,
                 &a.D2, &a.X3, &a.D3, &a.X4, &a.D4};
  for (RT** r : recs) *r = (RT*)p[i++];
  a.bias = (float*)p[i++];
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
  a.dr = dr;
  cudaError_t e = bwd_tc_pick(B, F, H, cluster, &a.C);
  *used = a.C;
  if (e != cudaSuccess) return (int)e;
  const size_t smem = bwd_smem_floats(F, H) * sizeof(float);
  const auto kernel = mega_bwd_tc_kernel;
  if (a.C > 1) {
    e = launch_clusters(kernel, B, a.C, smem, stream, a);
    if (e != cudaSuccess) return (int)e;
  } else {
    kernel<<<B, THREADS, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Number of pointers the general route's stair_mega_exec_bwd_* take: the
// NARGS prepare_args tensors, rv, rf, ra, drv, drf, dra, dvid, dtok, daux,
// meta, ten record buffers and the small partials (this walk takes the
// bias partials besides).
constexpr int NBWD = NARGS + 10 + 2 * NSLOT + 1;

// The walk: bf16, H a multiple of 64 in [64, TC_MAX_H], any F in
// [TC_MIN_F, TC_ROUTE_MAX_F]. ptrs: as stair_mega_exec_bwd_bf16's
// (mega_grad.cu), with the record buffers in bf16 and the bias partials
// (float32 [B*T, NSLOT, H]) after them; ws: float32 [B, Ws(Nv, Nf, Na, F,
// H, L, T).size]. cluster, used: as launch_bwd's; hand the walk the
// forward's cluster size or 0 (its outputs equal at every size). A cluster
// that cannot launch returns its error: nothing falls back.
extern "C" int stair_mega_exec_bwd_tc(
    const void* const* ptrs, int nptrs, void* ws, int B, int T, int Nv,
    int Nf, int Na, int F, int H, int L, int fsoft, int drop, int seed0,
    int seed1, unsigned thresh, float scale, int cluster, int* used,
    void* stream) {
  if (nptrs != NBWD + 1 || B <= 0 || H % 64 || H < 64 ||
      H > stair::TC_MAX_H || F < stair::TC_MIN_F ||
      F > stair::TC_ROUTE_MAX_F || L > MAX_L || cluster < 0 || cluster > 8)
    return (int)cudaErrorInvalidValue;
  const stair::Dropout dr{drop, seed0, seed1, thresh, scale};
  return launch_bwd<__nv_bfloat16>(ptrs, ws, B, T, Nv, Nf, Na, F, H, L, fsoft,
                                   dr, (cudaStream_t)stream, cluster, used);
}

// ptrs: meta, X0, D0, ..., X4, D4 (bf16), the bias partials, small, then
// the outputs as stair_mega_exec_wgrad_bf16's.
extern "C" int stair_mega_exec_wgrad_tc(const void* const* ptrs, int nptrs,
                                        int B, int T, int F, int H,
                                        void* stream) {
  if (nptrs != 1 + 2 * NSLOT + 2 + 2 * NTABLES + 1 || H % 64)
    return (int)cudaErrorInvalidValue;
  WTArgs a;
  int i = 0;
  a.meta = (const int*)ptrs[i++];
  for (int s = 0; s < NSLOT; ++s) {
    a.X[s] = (const __nv_bfloat16*)ptrs[i++];
    a.D[s] = (const __nv_bfloat16*)ptrs[i++];
  }
  a.bias = (const float*)ptrs[i++];
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
  dim3 grid((H + WG_TILE - 1) / WG_TILE, (3 * H + WG_TILE - 1) / WG_TILE,
            a.njobs + 1);
  mega_wgrad_tc_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the walk in bytes.
extern "C" long stair_mega_exec_bwd_tc_smem(int F, int H) {
  return bwd_smem_floats(F, H) * (long)sizeof(float);
}

// The CTAs of an example's cluster that the walk on B examples at (F, H)
// takes on the current card, or -1 on an error.
extern "C" int stair_mega_exec_bwd_tc_cluster(int B, int F, int H) {
  int C = 0;
  return bwd_tc_pick(B, F, H, 0, &C) == cudaSuccess ? C : -1;
}

// The recompute products' check: block 0 runs each product as the
// training forward #5 (mega_exec_tc_kernel<true>) calls it, block 1 as the
// walk (mega_bwd_tc_kernel) recomputes it, on the same operands and
// epilogue (the float32 sum stored as it is), into out_fwd and out_walk.
//
// Matrix (vec 0): A bf16 [M, K], B bf16 [K, N]; out [M, N] = A @ B: the
// walk's walk_gemm on A's rows in global memory over slices of TC_MAX_F
// rows, against the forward's fwd_gemm on A staged into a shared-memory
// tile (M a multiple of 16 up to TC_MAX_F: one CTA an example) or its
// fwd_rows over the same slices (any other M up to TC_ROUTE_MAX_F: the
// row-slice mode). With chain, stage 1's pair instead: h = bf16(relu(A @
// B)), out = h @ B[:N, :N], the forward keeping h as a tile in shared
// memory (one CTA) or as bf16 rows in hbuf's first half (the row-slice
// mode, as its tiles in the workspace), the walk as bf16 rows in hbuf's
// second half (hbuf [2, M, N]; as its X1 record). K % 64 == 0, N % 8 ==
// 0; chained N % 64 == 0 and N <= K.
// Vec (vec 1): x float32 [M, K], M <= 3 segments, B bf16 [M K, N]; out [N]
// = vecmat_tc over the segments (the forward's partials after its vectors,
// the walk's in its product scratch); with chain h = rd(relu(rd(y))), out =
// vecmat_tc(h, B[:N, :N]). N % 8 == 0; chained N <= K.
__global__ void __launch_bounds__(THREADS)
    recompute_check_kernel(const void* A, const __nv_bfloat16* Bm, int M,
                           int K, int N, int vec, int chain,
                           __nv_bfloat16* hbuf, float* out_fwd,
                           float* out_walk) {
  extern __shared__ __align__(16) unsigned char buf[];
  using bf16 = __nv_bfloat16;
  const bool fwd = blockIdx.x == 0;
  float* out = fwd ? out_fwd : out_walk;
  auto store = [&](int m, int n, float acc) { out[(size_t)m * N + n] = acc; };
  if (vec) {
    float* x = reinterpret_cast<float*>(buf);
    float* h = x + M * K;
    float* part = fwd ? h + N : h + N + 4;   // at another offset in each
    for (int i = threadIdx.x; i < M * K; i += THREADS)
      x[i] = reinterpret_cast<const float*>(A)[i];
    __syncthreads();
    const float* xs[3] = {x, M > 1 ? x + K : nullptr,
                          M > 2 ? x + 2 * K : nullptr};
    auto out_vec = [&](int n, float y) { out[n] = y; };
    if (!chain) {
      vecmat_tc(xs[0], xs[1], xs[2], Bm, K, N, part, out_vec);
      return;
    }
    vecmat_tc(xs[0], xs[1], xs[2], Bm, K, N, part, [&](int n, float y) {
      h[n] = rd<bf16>(fmaxf(rd<bf16>(y), 0.f));
    });
    vecmat_tc(h, nullptr, nullptr, Bm, N, N, part, out_vec);
    return;
  }
  const bf16* Ab = reinterpret_cast<const bf16*>(A);
  bf16* t0 = reinterpret_cast<bf16*>(buf);
  if (!fwd || M % 16 || M > stair::TC_MAX_F) {
    // slices of rows: h = relu(A @ B) rows into this side's half of hbuf
    bf16* hb = hbuf + (fwd ? 0 : (size_t)M * N);
    bf16* ring = t0 + (size_t)tc_slice_rows(M) * (K + TC_PAD);
    auto slices = [&](const bf16* X, int KX, auto epi) {
      for (int m0 = 0; m0 < M; m0 += stair::TC_MAX_F) {
        const int rows =
            M - m0 < stair::TC_MAX_F ? M - m0 : stair::TC_MAX_F;
        auto e = [&](int m, int n, float acc) { epi(m0 + m, n, acc); };
        if (fwd)
          fwd_rows(X + (size_t)m0 * KX, KX, Bm, rows, KX, N, t0, ring, e);
        else
          walk_gemm(X + (size_t)m0 * KX, KX, Bm, rows, KX, N, t0, e);
      }
    };
    if (!chain) {
      slices(Ab, K, store);
      return;
    }
    slices(Ab, K, [&](int m, int n, float acc) {
      hb[(size_t)m * N + n] = from_f<bf16>(rd<bf16>(fmaxf(acc, 0.f)));
    });
    __syncthreads();
    slices(hb, N, store);
    return;
  }
  // the forward, one CTA an example: A and h as tiles in shared memory
  bf16* th = t0 + (size_t)M * (K + TC_PAD);
  bf16* ring = th + (size_t)M * (N + TC_PAD);
  load_tile(t0, K + TC_PAD, Ab, M, K);
  if (!chain) {
    fwd_gemm(t0, Bm, M, K, N, ring, store);
    return;
  }
  fwd_gemm(t0, Bm, M, K, N, ring, [&](int m, int n, float acc) {
    th[(size_t)m * (N + TC_PAD) + n] = from_f<bf16>(fmaxf(acc, 0.f));
  });
  fwd_gemm(th, Bm, M, N, N, ring, store);
}

// Dynamic shared memory of recompute_check_kernel in bytes.
static size_t check_smem_bytes(int M, int K, int N, int vec) {
  if (vec) return ((size_t)M * K + N + 4 + TC_PARTS) * sizeof(float);
  if (M % 16 || M > stair::TC_MAX_F)   // one staging tile, the larger ring
    return ((size_t)tc_slice_rows(M) * (K + TC_PAD) + tc_ring<FWD_BN>()) *
           sizeof(__nv_bfloat16);
  return ((size_t)M * (K + TC_PAD) + (size_t)M * (N + TC_PAD) +
          tc_ring<FWD_BN>()) * sizeof(__nv_bfloat16);
}

extern "C" int stair_mega_recompute_check(const void* A, const void* Bm,
                                          int M, int K, int N, int vec,
                                          int chain, void* hbuf,
                                          void* out_fwd, void* out_walk,
                                          void* stream) {
  const bool ok =
      vec ? (M >= 1 && M <= 3 && N % 8 == 0 && (!chain || N <= K))
          : (M >= 16 && M <= stair::TC_ROUTE_MAX_F && K % TC_BK == 0 &&
             N % 8 == 0 && (!chain || (N % TC_BK == 0 && N <= K)));
  if (!ok) return (int)cudaErrorInvalidValue;
  const size_t smem = check_smem_bytes(M, K, N, vec);
  cudaError_t e = cudaFuncSetAttribute(
      recompute_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  recompute_check_kernel<<<2, THREADS, smem, (cudaStream_t)stream>>>(
      A, (const __nv_bfloat16*)Bm, M, K, N, vec, chain,
      (__nv_bfloat16*)hbuf, (float*)out_fwd, (float*)out_walk);
  return (int)cudaGetLastError();
}
