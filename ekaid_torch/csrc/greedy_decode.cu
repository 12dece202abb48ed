// Whole-loop greedy answer decode for Hopper (sm_90a), one cooperative kernel.
//
// Replaces ekaid_tpu/models/pallas_decode.py::_decode_kernel (the TPU's
// Pallas kernel of the same loop). Per step t < T, for all B rows:
//
//   xt     = relu(word_emb[tok])
//   h_mod  = LSTM([fused, h_lang] @ wih_mod + h_mod @ whh_mod + b_mod)
//   mw     = softmax_f32(h_mod @ wfc + bfc)                      [B, 3]
//   vpos   = relu(h_lang @ wpos1 + bpos1)
//   ppos   = softmax_f32(vpos @ wwp + bwp) @ wpos2 + bpos2
//   att    = mw0 * f_bef + mw1 * f_diff + mw2 * f_aft
//   gate   = sigmoid_f32(relu([h_lang, ppos, att] @ wg1 + bg1) @ wg2 + bg2)
//   h_lang = LSTM(xt @ wih_x + (gate * att) @ wih_a + h_lang @ whh_lang + b)
//   logp   = log_softmax_f32(h_lang @ wlogit + blogit), NULL banned at t=0,
//            the previous token banned when `constraint` is set
//   tok    = argmax(logp) (lowest index on ties); rows that emit 0 finish
//
// and the loop stops once no row is unfinished. Rounding points are the
// reference's: every product accumulates in f32 over its whole K and
// rounds once to the compute type T; bias adds and sums of products run
// in T in the reference's order; LSTM gates, softmaxes and the sigmoid
// run in f32 from the rounded inputs, and h, c are rounded back to T.
// T is float (the exactness gate) or __nv_bfloat16 (serving).
//
// Loop. One persistent cooperative grid (every block co-resident). A step is
// seven phases separated by grid.sync():
//   1. step-start products: the module LSTM (two products, each rounded
//      on its own, then the gates), vpos, xt @ wih_x and h_lang @ whh_lang;
//   2. per row: mw, the POS softmax, ppos and att;
//   3. gate1x;  4. gate2x and gate * att;
//   5. (gate * att) @ wih_a and the language LSTM;  6. logits;
//   7. a warp per row: log-softmax, argmax, outputs, and a device-wide
//      count of unfinished rows that every block reads after the same
//      grid.sync(), so every block takes the same exit decision.
// States and per-step intermediates live in global scratch (L2-resident
// at these sizes) and are read through L2; h_mod is double-buffered
// because every block reads the old value while others write the new.
//
// Product phases (1, 3-6). The wrapper's work plan (greedy_decode.py::
// decode_plan) cuts each into units of up to 64 batch rows (all of a
// batch of <= 64, so each weight is read once a step) x `nu` weight
// columns x one K-slice of one product, at least one unit for each SM.
// A unit stages its rows' inputs in shared memory (bf16 stays bf16, rows
// past B are zero), streams its weight slab through a 5-stage cp.async
// ring of 8 KB stages (four ahead: 32 KB in flight where the slab holds
// that much), and multiplies: bf16 with mma.sync m16n8k16 (A by
// ldmatrix, B by ldmatrix.trans from the row-major [k][nu] tile), f32
// with FFMA over the same tiles. The wrapper packs each product weight
// tile-major ([ntiles][K][nu], padding columns zero) once per parameter
// set, so a unit's slab is contiguous and every copy a whole, aligned
// 16-byte chunk. Warps split columns and K, never rows, so a batch of 1
// wastes no warp on empty rows. Each unit writes its f32 partial to
// scratch and takes a ticket (an acq_rel atomic) for its (column tile,
// row group); the last unit brings every slice and its epilogue's
// operands into shared memory in one copy group, sums the slices in
// slice order, rounds once and runs the phase's epilogue (bias, relu,
// sigmoid, the LSTM gates), so results are the same from run to run and
// the loop keeps its seven barriers. Gate tiles hold the four gates of
// nu/4 hidden units, so the reducing unit has all of them for the LSTM.
// bf16 runs two blocks an SM, so that one block's copies overlap the
// other's dependent loads.
//
// What bounds it. The flagship bf16 step (E=D=1024, R=512, W=300,
// V=148, B=64) multiplies B rows by ~14.6M weight values, ~1.9 GFLOP,
// ~1.9 us at 989 TFLOP/s; its 29.3 MB of weights take 8.8 us a step from
// device memory. Neither sets the time: each product phase is a chain of
// dependent trips to L2 (the unit's copies, its ticket, the reducer's
// copy group) behind the SM's other copies, plus a grid barrier, and its
// slowest block is a reducer. The activation rows, re-read by every
// column tile, move more bytes than the weights in gate1x and gate2x.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W, us a
// step at B=64: module LSTM + vpos + zx + zh 41.45, gate1x 31.99, gate2x
// 25.12, language LSTM 29.72, logits 19.34, and the per-row phases 2 and
// 7 16.48 and 6.41; 15.492 ms a 90-step decode (11.360 ms at B=1).

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerGroup = 64;
constexpr int kRingStages = 5;               // as greedy_decode.py
constexpr int kStageBytes = 8192;
constexpr int kMaxJobs = 4;
constexpr int kJobInts = 16;
constexpr int kPhaseInts = 2 + kMaxJobs * kJobInts;
constexpr int kPhases = 5;                   // product phases in the plan

enum Kind { MOD, VPOS, ZX, ZH, G1, G2, LANG, LOGIT };
enum JobField {
  J_KIND, J_NU, J_NTILES, J_KS, J_NPROD, J_K0, J_S0, J_K1, J_S1, J_UNIT,
  J_NUNITS, J_PART, J_TICKET, J_N, J_GATES, J_NVALID
};

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float to(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float x) {
    return __float2bfloat16(x);
  }
};

// weights: read-only for the whole kernel
template <typename T> __device__ __forceinline__ float ldw(const T* p) {
  return Cvt<T>::f(__ldg(p));
}
// activations: written by other blocks, so read through L2
template <typename T> __device__ __forceinline__ float lda(const T* p) {
  return Cvt<T>::f(__ldcg(p));
}
template <typename T> __device__ __forceinline__ void st(T* p, float x) {
  *p = Cvt<T>::to(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return Cvt<T>::f(Cvt<T>::to(x));
}
// one rounded add / multiply in T (never contracted into an fma)
template <typename T> __device__ __forceinline__ float addr(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
template <typename T> __device__ __forceinline__ float mulr(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- Hopper data movement and tensor-core primitives -------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)), "l"(src));
}
// a ticket: releases this block's earlier writes (ordered by the
// __syncthreads before it) and acquires those of the blocks before it
__device__ __forceinline__ int ticket_add(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(p) : "memory");
  return old;
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T> struct Args {
  // weights, in the reference kernel's order
  const T *wemb, *wih_mod, *whh_mod, *b_mod, *wfc, *bfc, *wpos1, *bpos1,
      *wwp, *bwp, *wpos2, *bpos2, *wg1, *bg1, *wg2, *bg2, *wih_x, *wih_a,
      *whh_lang, *b_lang, *wlogit, *blogit;
  const T *fused, *feats;                   // [B, E], [B, 3D]
  int* seq;                                 // [B, T]
  float *lps, *mw_out;                      // [B, T], [B, T, 3]
  T *h_mod, *c_mod, *h_lang, *c_lang;       // h_mod [2, B, R], others [B, R]
  T *vpos, *zx, *zh, *att, *ppos, *gate_h, *ga;
  float *mw, *logits;                       // [B, 3], [B, V]
  int *tok, *unfin, *counts;                // [B], [B], [T]
  const int* plan;                          // [5, kPhaseInts]
  float* part;                              // split-K partials
  int* tickets;                             // one per (tile, row group)
  unsigned long long* phase_ns;             // [7] or null
  int B, steps, E, R, D, W, V, P, constraint, bu_pad, groups, lda;
};

// One segment of a product's input row: `k` values at p[b * ld], or at
// p[rows[b] * ld] (an embedding gather), optionally through relu.
template <typename T> struct Seg {
  const T* p;
  int ld, k;
  const int* rows;
  bool relu;
};
template <typename T> struct Input {
  Seg<T> s[3];
  int n;
};
template <typename T>
__device__ Input<T> input(Seg<T> a, Seg<T> b = Seg<T>{nullptr, 0, 0},
                          Seg<T> c = Seg<T>{nullptr, 0, 0}) {
  Input<T> in{{a, b, c}, 1 + (b.k > 0) + (c.k > 0)};
  return in;
}

// Tile column j -> weight column n0 + (j / group) * stride + j % group;
// valid while j % group < gvalid.
struct ColMap {
  int n0, group, stride, gvalid;
  __device__ int col(int j) const {
    return n0 + (j / group) * stride + (j % group);
  }
  __device__ bool valid(int j) const { return (j % group) < gvalid; }
};

struct Job {
  int kind, nu, ntiles, ks, k0, s0, k1, s1, unit, part, ticket, n, gates,
      nvalid;
};
// a job's fields, from the phase's plan in shared memory
__device__ Job load_job(const int* p) {
  return Job{p[J_KIND], p[J_NU], p[J_NTILES], p[J_KS], p[J_K0], p[J_S0],
             p[J_K1], p[J_S1], p[J_UNIT], p[J_PART], p[J_TICKET], p[J_N],
             p[J_GATES], p[J_NVALID]};
}

// 16-byte chunks: shared-memory tiles are stored in chunks of kCE values,
// XOR-swizzled so that ldmatrix's eight rows fall in distinct banks.
template <typename T> struct Tile {
  static constexpr int kCE = 16 / sizeof(T);
  // activation rows [bu_pad][lda]: lda / kCE >= 8 chunks a row
  static __device__ __forceinline__ int a_at(int r, int k, int lda) {
    return r * lda + (((k / kCE) ^ (r & 7)) * kCE) + (k % kCE);
  }
  // weight stage [kc][nu], nch = nu / kCE chunks a row
  static __device__ __forceinline__ int b_chunk(int k, int c, int nch) {
    if (nch >= 8) return c ^ (k & 7);
    const int shift = nch == 4 ? 1 : 2;     // nch is 2 or 4 otherwise
    return c ^ ((k >> shift) & (nch - 1));
  }
};

// Stage rows [0, mt*16) x slice columns [k0, k0 + kpad) of the unit's
// input. A thread keeps one 16-byte chunk column (its segment and source
// found once) and walks the rows: cp.async for whole, aligned chunks of
// one segment (committed with the first weight stage), plain loads for
// the rest (the embedding gather through relu, ragged ends); rows past
// nb and columns past k1 are zero. kpad / kCE <= kThreads (ks <= 512).
template <typename T>
__device__ void stage_a(const Input<T>& in, int b0, int nb, int mt, int k0,
                        int k1, int kpad, T* as, int ldas, const int* rows) {
  constexpr int CE = Tile<T>::kCE;
  const int cpr = kpad / CE, rstep = kThreads / cpr;
  const int c = threadIdx.x % cpr, r0 = threadIdx.x / cpr;
  if (r0 >= rstep) return;
  const int k = k0 + c * CE;
  int s = 0, off = k;
  while (s + 1 < in.n && off >= in.s[s].k) { off -= in.s[s].k; ++s; }
  const Seg<T> sg = in.s[s];
  // whole chunks of one segment go by cp.async: 16-byte aligned, or (an
  // embedding row) 8-byte aligned as two halves
  const bool whole = k + CE <= k1 && off + CE <= sg.k;
  const bool a16 = whole && sg.ld % CE == 0 &&
                   (reinterpret_cast<uintptr_t>(sg.p + off) & 15) == 0;
  const bool a8 = whole && (sg.ld * sizeof(T)) % 8 == 0 &&
                  (reinterpret_cast<uintptr_t>(sg.p + off) & 7) == 0;
  for (int r = r0; r < mt * 16; r += rstep) {
    T* dst = as + Tile<T>::a_at(r, c * CE, ldas);
    if (r < nb && (a16 || a8)) {
      const T* src = sg.p + (size_t)(sg.rows ? rows[r] : b0 + r) * sg.ld + off;
      if (a16 && !sg.rows) {
        cp_async16(dst, src);
      } else {
        cp_async8(dst, src);
        cp_async8(dst + CE / 2, src + CE / 2);
      }
      continue;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nb && k < k1) {
      T* e = reinterpret_cast<T*>(&v);
      const int b = b0 + r;
#pragma unroll
      for (int q = 0; q < CE; ++q) {
        int kk = k + q, ss = 0, oo = kk;
        if (kk >= k1) { e[q] = Cvt<T>::to(0.f); continue; }
        while (ss + 1 < in.n && oo >= in.s[ss].k) { oo -= in.s[ss].k; ++ss; }
        const Seg<T>& g = in.s[ss];
        const T* rw = g.p + (size_t)(g.rows ? rows[r] : b) * g.ld;
        e[q] = Cvt<T>::to(g.rows ? ldw(rw + oo) : lda(rw + oo));
      }
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

// One thread's share of a weight ring stage: one 16-byte chunk column of
// the tile's packed slab (rows of nu values, contiguous), every rstep-th
// row, by cp.async; rows past the slice up to the next multiple of 16
// are zero.
template <typename T> struct StageCopy {
  static constexpr int CE = Tile<T>::kCE;
  const T* src;            // the tile's row 0, at this thread's chunk
  int c, r0, rstep, nch, nu;
  __device__ StageCopy(const T* tile, int nu_) : nu(nu_) {
    nch = nu / CE;
    rstep = kThreads / nch;
    c = threadIdx.x % nch;
    r0 = threadIdx.x / nch;
    src = tile + c * CE;
  }
  // rows [kq0, kq1) into `stage`
  __device__ void issue(int kq0, int kq1, T* stage) const {
    const int rows = (kq1 - kq0 + 15) / 16 * 16;
    for (int r = r0; r < rows; r += rstep) {
      T* dst = stage + r * nu + Tile<T>::b_chunk(r, c, nch) * CE;
      if (kq0 + r < kq1)
        cp_async16(dst, src + (size_t)(kq0 + r) * nu);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Shared memory of a product unit.
template <typename T> struct Smem {
  T* as;          // [bu_pad][lda] input rows
  T* ring;        // kRingStages x kStageBytes
  float* red;     // [groups along K][bu_pad][nu], over the ring
};

// bf16: warps split nu into 16-column pairs of n8 tiles and K into
// k16 steps; each warp covers all mt row tiles of its columns.
__device__ __forceinline__ void chunk_mma(const Smem<__nv_bfloat16>& sm,
                                          const __nv_bfloat16* stage, int nu,
                                          int mt, int ka0, int nrows,
                                          int ldas, float (&acc)[4][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int np = nu / 16, wn = warp % np, wk = warp / np, nwk = kWarps / np;
  const int nch = nu / 8, steps = (nrows + 15) / 16;
  for (int s = wk; s < steps; s += nwk) {
    const int kk = s * 16;
    const int br = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
    unsigned b[4];
    ldsm_x4_t(b, stage + br * nu +
                     Tile<__nv_bfloat16>::b_chunk(br, wn * 2 + (lane >> 4), nch) * 8);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= mt) break;
      const int ar = m * 16 + (lane & 15);
      unsigned a[4];
      ldsm_x4(a, sm.as + Tile<__nv_bfloat16>::a_at(ar, ka0 + kk + (lane >> 4) * 8,
                                                     ldas));
      mma_bf16(acc[m][0], a, b[0], b[1]);
      mma_bf16(acc[m][1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ int mma_red_groups(int nu) {
  return kWarps / (nu / 16);
}

__device__ __forceinline__ void mma_store(const Smem<__nv_bfloat16>& sm, int nu,
                                          int mt, int bu_pad,
                                          const float (&acc)[4][2][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int np = nu / 16, wn = warp % np, wk = warp / np;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m >= mt) break;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = m * 16 + (lane >> 2), c = wn * 16 + t * 8 + (lane & 3) * 2;
      float* p = sm.red + ((size_t)wk * bu_pad + r) * nu + c;
      p[0] = acc[m][t][0];
      p[1] = acc[m][t][1];
      p[8 * nu] = acc[m][t][2];
      p[8 * nu + 1] = acc[m][t][3];
    }
  }
}

// f32: each thread takes 4 columns x mt rows (rg, rg + 16, ...) over
// every (16 / (nu / 4))-th row of the stage; no TF32.
__device__ __forceinline__ void chunk_ffma(const Smem<float>& sm,
                                           const float* stage, int nu, int mt,
                                           int ka0, int nrows, int ldas,
                                           float (&acc)[4][2][4]) {
  const int ncg = nu / 4, kgn = 16 / ncg;
  const int cgi = threadIdx.x % ncg, rg = (threadIdx.x / ncg) % 16,
            kg = threadIdx.x / (ncg * 16);
  for (int kk = kg; kk < nrows; kk += kgn) {
    const float4 w4 = *reinterpret_cast<const float4*>(
        stage + kk * nu + Tile<float>::b_chunk(kk, cgi, ncg) * 4);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m >= mt) break;
      const float x = sm.as[Tile<float>::a_at(rg + 16 * m, ka0 + kk, ldas)];
      acc[m][0][0] = fmaf(x, w4.x, acc[m][0][0]);
      acc[m][0][1] = fmaf(x, w4.y, acc[m][0][1]);
      acc[m][0][2] = fmaf(x, w4.z, acc[m][0][2]);
      acc[m][0][3] = fmaf(x, w4.w, acc[m][0][3]);
    }
  }
}

__device__ __forceinline__ void ffma_store(const Smem<float>& sm, int nu,
                                           int mt, int bu_pad,
                                           const float (&acc)[4][2][4]) {
  const int ncg = nu / 4;
  const int cgi = threadIdx.x % ncg, rg = (threadIdx.x / ncg) % 16,
            kg = threadIdx.x / (ncg * 16);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (m >= mt) break;
    float* p = sm.red + ((size_t)kg * bu_pad + rg + 16 * m) * nu + cgi * 4;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[m][0][0], acc[m][0][1], acc[m][0][2], acc[m][0][3]);
  }
}

__device__ __forceinline__ int ffma_red_groups(int nu) { return 16 / (nu / 4); }

template <typename T> struct Core;
template <> struct Core<__nv_bfloat16> {
  static __device__ void chunk(const Smem<__nv_bfloat16>& sm,
                               const __nv_bfloat16* stage, int nu, int mt,
                               int ka0, int nrows, int ldas,
                               float (&acc)[4][2][4]) {
    chunk_mma(sm, stage, nu, mt, ka0, nrows, ldas, acc);
  }
  static __device__ void store(const Smem<__nv_bfloat16>& sm, int nu, int mt,
                               int bu_pad, const float (&acc)[4][2][4]) {
    mma_store(sm, nu, mt, bu_pad, acc);
  }
  static __device__ int groups(int nu) { return mma_red_groups(nu); }
};
template <> struct Core<float> {
  static __device__ void chunk(const Smem<float>& sm, const float* stage,
                               int nu, int mt, int ka0, int nrows, int ldas,
                               float (&acc)[4][2][4]) {
    chunk_ffma(sm, stage, nu, mt, ka0, nrows, ldas, acc);
  }
  static __device__ void store(const Smem<float>& sm, int nu, int mt,
                               int bu_pad, const float (&acc)[4][2][4]) {
    ffma_store(sm, nu, mt, bu_pad, acc);
  }
  static __device__ int groups(int nu) { return ffma_red_groups(nu); }
};

// One unit's product: out[r][j] = sum_{k in [k0, k1)} X[b0 + r][k] *
// Wt[k][j] for r < mt*16, in f32, written to the unit's partial `out` in
// global memory; Wt is the tile's packed slab [K][nu].
template <typename T>
__device__ void unit_product(const Input<T>& in, const T* __restrict__ w,
                             int nu, int b0, int nb,
                             int mt, int k0, int k1, int ldas, int bu_pad,
                             const Smem<T>& sm, float* out) {
  const int kc = kStageBytes / (nu * (int)sizeof(T));
  const int nq = (k1 - k0 + kc - 1) / kc;
  T* const stages = sm.ring;
  const int stage_elems = kStageBytes / sizeof(T);
  const StageCopy<T> cp(w, nu);
  const int kpad = (k1 - k0 + 15) / 16 * 16;
  // an embedding gather: the rows' tokens, read once
  __shared__ int rows[kRowsPerGroup];
  int rlo = kpad, rhi = 0, kseg = 0;         // slice columns through relu
  for (int q = 0; q < in.n; ++q) {
    const Seg<T>& g = in.s[q];
    if (g.rows) {
      for (int i = threadIdx.x; i < nb; i += kThreads)
        rows[i] = __ldcg(g.rows + b0 + i);
      __syncthreads();
    }
    if (g.relu) {
      rlo = max(0, kseg - k0);
      rhi = min(kpad, kseg + g.k - k0);
    }
    kseg += g.k;
  }
  // the input rows join the first weight stage's copy group
  stage_a(in, b0, nb, mt, k0, k1, kpad, sm.as, ldas, rows);
#pragma unroll
  for (int q = 0; q < kRingStages - 1; ++q) {
    if (q < nq)
      cp.issue(k0 + q * kc, min(k0 + (q + 1) * kc, k1),
               stages + q * stage_elems);
    cp_async_commit();
  }
  float acc[4][2][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.f;
  for (int q = 0; q < nq; ++q) {
    cp_async_wait<kRingStages - 2>();
    __syncthreads();
    if (q == 0 && rlo < rhi) {               // relu of staged embeddings
      constexpr int CE = Tile<T>::kCE;
      const int c0 = rlo / CE, nc = (rhi + CE - 1) / CE - c0;
      for (int o = threadIdx.x; o < nb * nc; o += kThreads) {
        const int r = o / nc, c = c0 + o % nc;
        T* e = sm.as + Tile<T>::a_at(r, c * CE, ldas);
#pragma unroll
        for (int i = 0; i < CE; ++i) {
          const int kk = c * CE + i;
          if (kk >= rlo && kk < rhi)
            e[i] = Cvt<T>::to(fmaxf(Cvt<T>::f(e[i]), 0.f));
        }
      }
      __syncthreads();
    }
    const int qn = q + kRingStages - 1;
    if (qn < nq)
      cp.issue(k0 + qn * kc, min(k0 + (qn + 1) * kc, k1),
               stages + (qn % kRingStages) * stage_elems);
    cp_async_commit();
    Core<T>::chunk(sm, stages + (q % kRingStages) * stage_elems, nu, mt,
                   q * kc, min(kc, k1 - k0 - q * kc), ldas, acc);
  }
  cp_async_wait<0>();
  __syncthreads();                           // the ring becomes `red`
  Core<T>::store(sm, nu, mt, bu_pad, acc);
  __syncthreads();
  // the warp (bf16) or thread (f32) groups along K, summed in order
  const int ng = Core<T>::groups(nu), gstride = bu_pad * nu / 4;
  const float4* red4 = reinterpret_cast<const float4*>(sm.red);
  for (int o = threadIdx.x; o < mt * 4 * nu; o += kThreads) {
    float4 v[8];
#pragma unroll
    for (int g = 0; g < 8; ++g)
      if (g < ng) v[g] = red4[g * gstride + o];
    float4 s = v[0];
#pragma unroll
    for (int g = 1; g < 8; ++g)
      if (g < ng) {
        s.x += v[g].x; s.y += v[g].y; s.z += v[g].z; s.w += v[g].w;
      }
    __stcg(reinterpret_cast<float4*>(out) + o, s);
  }
}

// The input rows and the packed weight ([ntiles][K][nu]) of product `p`
// of a job kind.
template <typename T>
__device__ Input<T> job_input(const Args<T>& a, int kind, int p,
                              const T* h_mod_cur) {
  const int R = a.R, D = a.D;
  switch (kind) {
    case MOD:
      return p == 0 ? input(Seg<T>{a.fused, a.E, a.E, nullptr, false},
                            Seg<T>{a.h_lang, R, R, nullptr, false})
                    : input(Seg<T>{h_mod_cur, R, R, nullptr, false});
    case ZX: return input(Seg<T>{a.wemb, a.W, a.W, a.tok, true});
    case G1:
      return input(Seg<T>{a.h_lang, R, R, nullptr, false},
                   Seg<T>{a.ppos, R, R, nullptr, false},
                   Seg<T>{a.att, D, D, nullptr, false});
    case G2: return input(Seg<T>{a.gate_h, 2 * R + D, 2 * R + D, nullptr, false});
    case LANG: return input(Seg<T>{a.ga, D, D, nullptr, false});
    default:   // VPOS, ZH, LOGIT
      return input(Seg<T>{a.h_lang, R, R, nullptr, false});
  }
}
template <typename T>
__device__ const T* job_weight(const Args<T>& a, int kind, int p) {
  switch (kind) {
    case MOD: return p == 0 ? a.wih_mod : a.whh_mod;
    case VPOS: return a.wpos1;
    case ZX: return a.wih_x;
    case ZH: return a.whh_lang;
    case G1: return a.wg1;
    case G2: return a.wg2;
    case LANG: return a.wih_a;
    default: return a.wlogit;
  }
}

// Copy rows x len values (row r at src + r * ld, `nvalid` of each valid,
// the rest zero) into dst [rows][len] in shared memory: cp.async for whole,
// aligned chunks, plain loads for the rest. len is a multiple of kCE.
template <typename T>
__device__ void stage_rows(T* dst, const T* src, int rows, int len,
                           size_t ld, int nvalid) {
  constexpr int CE = Tile<T>::kCE;
  const int cpr = len / CE;
  for (int o = threadIdx.x; o < rows * cpr; o += kThreads) {
    const int r = o / cpr, c = (o % cpr) * CE;
    const T* p = src + r * ld + c;
    T* d = dst + r * len + c;
    if (c + CE <= nvalid && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      cp_async16(d, p);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e)
        d[e] = c + e < nvalid ? __ldcg(p + e) : Cvt<T>::to(0.f);
    }
  }
}

// The reducing unit. One copy group brings the tile's partials (rows <
// mt*16 of each slice) and every operand of its epilogue (biases, the
// LSTM cell, zx and zh, att) into shared memory; then it sums the slices
// of each product in slice order, rounds once to T, and runs the kind's
// epilogue for rows b0 .. b0 + nb from shared memory alone.
template <typename T>
__device__ void reduce_epilogue(const Args<T>& a, const Job& j, ColMap cm,
                                const float* base, int stot, int b0, int nb,
                                int mt, float* sp, T* h_mod_nxt) {
  const int nu = j.nu, rows = mt * 16, R = a.R, hid = nu / 4;
  const int per = rows * nu / 4;             // 16-byte chunks a slice
  for (int q = 0; q < stot; ++q)
    for (int e = threadIdx.x; e < per; e += kThreads)
      cp_async16(sp + ((size_t)q * per + e) * 4,
                 base + (size_t)q * a.bu_pad * nu + e * 4);
  // operands, after the partials: bias [4][hid] or [nu]; for the gates
  // c [nb][hid], and for the language LSTM zx, zh [nb * 4][hid]; for
  // gate2x att [nb][nu]
  T* bias = reinterpret_cast<T*>(sp + (size_t)stot * rows * nu);
  T* cst = bias + nu;
  T* zxs = cst + nb * hid;
  T* zhs = zxs + nb * nu;
  T* att = bias + nu;
  if (j.gates) {
    const bool mod = j.kind == MOD;
    stage_rows(bias, (mod ? a.b_mod : a.b_lang) + cm.n0, 4, hid, R, cm.gvalid);
    stage_rows(cst, (mod ? a.c_mod : a.c_lang) + (size_t)b0 * R + cm.n0, nb,
               hid, R, cm.gvalid);
    if (!mod) {
      stage_rows(zxs, a.zx + (size_t)b0 * 4 * R + cm.n0, nb * 4, hid, R,
                 cm.gvalid);
      stage_rows(zhs, a.zh + (size_t)b0 * 4 * R + cm.n0, nb * 4, hid, R,
                 cm.gvalid);
    }
  } else if (j.kind != ZX && j.kind != ZH) {
    const T* b = j.kind == VPOS ? a.bpos1 : j.kind == G1 ? a.bg1
               : j.kind == G2 ? a.bg2 : a.blogit;
    stage_rows(bias, b + cm.n0, 1, nu, 0, cm.gvalid);
    if (j.kind == G2)
      stage_rows(att, a.att + (size_t)b0 * a.D + cm.n0, nb, nu, a.D,
                 cm.gvalid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  auto prod = [&](int i, int c, int p) {
    const int sb = p ? j.s0 : 0, se = p ? stot : j.s0;
    float s = 0.f;
    for (int q = sb; q < se; ++q) s += sp[((size_t)q * rows + i) * nu + c];
    return rnd<T>(s);
  };
  auto f = [](T x) { return Cvt<T>::f(x); };
  if (j.gates) {
    for (int o = threadIdx.x; o < nb * hid; o += kThreads) {
      const int i = o / hid, rr = o % hid, b = b0 + i, r = cm.n0 + rr;
      if (rr >= cm.gvalid) continue;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = q * hid + rr;
        const float bq = f(bias[q * hid + rr]);
        z[q] = j.kind == MOD
                   ? addr<T>(addr<T>(prod(i, c, 0), prod(i, c, 1)), bq)
                   : addr<T>(addr<T>(addr<T>(f(zxs[(i * 4 + q) * hid + rr]),
                                             prod(i, c, 0)),
                                     f(zhs[(i * 4 + q) * hid + rr])),
                             bq);
      }
      const float cn = sigm(z[1]) * f(cst[o]) + sigm(z[0]) * tanhf(z[2]);
      const float hn = sigm(z[3]) * tanhf(cn);
      T* h = j.kind == MOD ? h_mod_nxt : a.h_lang;
      T* c = j.kind == MOD ? a.c_mod : a.c_lang;
      st(h + (size_t)b * R + r, hn);
      st(c + (size_t)b * R + r, cn);
    }
    return;
  }
  for (int o = threadIdx.x; o < nb * nu; o += kThreads) {
    const int i = o / nu, c = o % nu, b = b0 + i;
    if (!cm.valid(c)) continue;
    const int n = cm.col(c);
    const float v = prod(i, c, 0);
    switch (j.kind) {
      case VPOS:
        st(a.vpos + (size_t)b * R + n, fmaxf(addr<T>(v, f(bias[c])), 0.f));
        break;
      case ZX: st(a.zx + (size_t)b * 4 * R + n, v); break;
      case ZH: st(a.zh + (size_t)b * 4 * R + n, v); break;
      case G1:
        st(a.gate_h + (size_t)b * (2 * R + a.D) + n,
           fmaxf(addr<T>(v, f(bias[c])), 0.f));
        break;
      case G2: {
        const float g = rnd<T>(sigm(addr<T>(v, f(bias[c]))));
        st(a.ga + (size_t)b * a.D + n, mulr<T>(g, f(att[o])));
        break;
      }
      default:                               // LOGIT
        a.logits[(size_t)b * a.V + n] = addr<T>(v, f(bias[c]));
    }
  }
}

// Every unit of one product phase, grid-strided over the blocks; `plan`
// is the kernel's copy of the plan in shared memory.
template <typename T>
__device__ void product_phase(const Args<T>& a, int phase, const T* h_mod_cur,
                              T* h_mod_nxt, const Smem<T>& sm, int* last,
                              const int* plan) {
  const int* splan = plan + phase * kPhaseInts;
  const int njobs = splan[0], nunits = splan[1];
  for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
    int ji = 0;
    while (ji + 1 < njobs && u >= splan[2 + (ji + 1) * kJobInts + J_UNIT]) ++ji;
    const Job j = load_job(splan + 2 + ji * kJobInts);
    const int stot = j.s0 + j.s1, tgs = j.ntiles * a.groups;
    const int ul = u - j.unit, s = ul / tgs, tg = ul % tgs;
    const int tile = tg / a.groups, grp = tg % a.groups;
    const int b0 = grp * kRowsPerGroup, nb = min(kRowsPerGroup, a.B - b0);
    const int mt = (nb + 15) / 16;
    const int p = s < j.s0 ? 0 : 1, sl = p ? s - j.s0 : s;
    const int K = p ? j.k1 : j.k0, k0 = sl * j.ks, k1 = min(k0 + j.ks, K);
    ColMap cm;
    if (j.gates) {
      const int hid = j.nu / 4;
      cm = ColMap{tile * hid, hid, j.n / 4, min(hid, j.nvalid - tile * hid)};
    } else {
      cm = ColMap{tile * j.nu, j.nu, 0, min(j.nu, j.nvalid - tile * j.nu)};
    }
    float* base = a.part + j.part + (size_t)tg * stot * a.bu_pad * j.nu;
    unit_product(job_input(a, j.kind, p, h_mod_cur),
                 job_weight(a, j.kind, p) + (size_t)tile * K * j.nu, j.nu, b0,
                 nb, mt, k0, k1, a.lda, a.bu_pad, sm,
                 base + (size_t)s * a.bu_pad * j.nu);
    __syncthreads();
    if (stot > 1) {
      // the last of the tile's units to take a ticket reduces; a tile of
      // one slice reduces its own partial
      int* ticket = a.tickets + j.ticket + tg;
      if (threadIdx.x == 0) {
        *last = ticket_add(ticket) == stot - 1;
        if (*last) *ticket = 0;              // for the next step
      }
      __syncthreads();
      if (!*last) continue;
    }
    reduce_epilogue(a, j, cm, base, stot, b0, nb, mt,
                    reinterpret_cast<float*>(sm.as), h_mod_nxt);
    __syncthreads();
  }
}

// bf16 runs two blocks an SM (128 registers), so that two units' load
// and reduction chains overlap on every SM; f32, the exactness
// instance, runs one.
template <typename T> struct BlocksPerSm { static constexpr int v = 1; };
template <> struct BlocksPerSm<__nv_bfloat16> { static constexpr int v = 2; };

template <typename T>
__global__ void __launch_bounds__(kThreads, BlocksPerSm<T>::v)
    greedy_decode_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  __shared__ int last;
  __shared__ int splan[kPhases * kPhaseInts];
  float* smem = reinterpret_cast<float*>(smem4);
  const int B = a.B, R = a.R, D = a.D, V = a.V, P = a.P;
  Smem<T> sm;
  sm.as = reinterpret_cast<T*>(smem4);
  sm.ring = sm.as + (size_t)a.bu_pad * a.lda;
  sm.red = reinterpret_cast<float*>(sm.ring);  // once a unit's loop is done
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = kWarps;
  for (int i = threadIdx.x; i < kPhases * kPhaseInts; i += kThreads)
    splan[i] = __ldg(a.plan + i);
  __syncthreads();

  // phase times summed over steps, as block 0 sees them between barriers
  const bool timing = a.phase_ns && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t_last = timing ? globaltimer() : 0;
  auto sync = [&](int phase) {
    grid.sync();
    if (timing) {
      const unsigned long long now = globaltimer();
      a.phase_ns[phase] += now - t_last;
      t_last = now;
    }
  };

  for (int t = 0; t < a.steps; ++t) {
    const T* h_mod_cur = a.h_mod + (size_t)(t & 1) * B * R;
    T* h_mod_nxt = a.h_mod + (size_t)((t + 1) & 1) * B * R;

    // ---- phase 1: step-start products -----------------------------
    product_phase(a, 0, h_mod_cur, h_mod_nxt, sm, &last, splan);
    sync(0);

    // ---- phase 2 (per row): mw, POS head, att ---------------------
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      float* hm = smem;                      // [R]
      float* vp = hm + R;                    // [R]
      float* zs = vp + R;                    // [3 + P] rounded logits
      float* ps = zs + 3 + P;                // [3 + P] softmaxes
      for (int k = threadIdx.x; k < R; k += kThreads) {
        hm[k] = lda(h_mod_nxt + (size_t)b * R + k);
        vp[k] = lda(a.vpos + (size_t)b * R + k);
      }
      __syncthreads();
      for (int d = warp; d < 3 + P; d += nwarps) {
        const bool is_mw = d < 3;
        const int col = is_mw ? d : d - 3, ld = is_mw ? 3 : P;
        const float* x = is_mw ? hm : vp;
        const T* wt = is_mw ? a.wfc : a.wwp;
        float s = 0.f;
#pragma unroll 4
        for (int k = lane; k < R; k += 32) s += x[k] * ldw(wt + (size_t)k * ld + col);
        s = warp_sum(s);
        if (lane == 0)
          zs[d] = addr<T>(rnd<T>(s), ldw((is_mw ? a.bfc : a.bwp) + col));
      }
      __syncthreads();
      if (threadIdx.x < 2) {                 // softmax_f32 over 3, then P
        const int lo = threadIdx.x == 0 ? 0 : 3, n = threadIdx.x == 0 ? 3 : P;
        float m = -INFINITY, s = 0.f;
        for (int q = 0; q < n; ++q) m = fmaxf(m, zs[lo + q]);
        for (int q = 0; q < n; ++q) s += expf(zs[lo + q] - m);
        for (int q = 0; q < n; ++q) {
          const float p = expf(zs[lo + q] - m) / s;
          ps[lo + q] = threadIdx.x == 0 ? p : rnd<T>(p);
          if (threadIdx.x == 0) a.mw[b * 3 + q] = p;
        }
      }
      __syncthreads();
      for (int n = threadIdx.x; n < R; n += kThreads) {   // ppos
        float s = 0.f;
#pragma unroll 4
        for (int q = 0; q < P; ++q) s += ps[3 + q] * ldw(a.wpos2 + (size_t)q * R + n);
        st(a.ppos + (size_t)b * R + n, addr<T>(rnd<T>(s), ldw(a.bpos2 + n)));
      }
      const float m0 = rnd<T>(ps[0]), m1 = rnd<T>(ps[1]), m2 = rnd<T>(ps[2]);
      const T* f = a.feats + (size_t)b * 3 * D;
      for (int d = threadIdx.x; d < D; d += kThreads) {   // att
        const float v = addr<T>(addr<T>(mulr<T>(m0, ldw(f + d)),
                                        mulr<T>(m1, ldw(f + D + d))),
                                mulr<T>(m2, ldw(f + 2 * D + d)));
        st(a.att + (size_t)b * D + d, v);
      }
      __syncthreads();
    }
    sync(1);

    // ---- phase 3: gate_h = relu([h_lang, ppos, att] @ wg1 + bg1) --
    product_phase(a, 1, h_mod_cur, h_mod_nxt, sm, &last, splan);
    sync(2);
    // ---- phase 4: gate = sigmoid(gate_h @ wg2 + bg2); ga = gate*att
    product_phase(a, 2, h_mod_cur, h_mod_nxt, sm, &last, splan);
    sync(3);
    // ---- phase 5: language LSTM -----------------------------------
    product_phase(a, 3, h_mod_cur, h_mod_nxt, sm, &last, splan);
    sync(4);
    // ---- phase 6: logits = h_lang @ wlogit + blogit -----------------
    product_phase(a, 4, h_mod_cur, h_mod_nxt, sm, &last, splan);
    sync(5);

    // ---- phase 7 (a warp per row): log-softmax -> greedy token ------
    for (int b = blockIdx.x * nwarps + warp; b < B; b += gridDim.x * nwarps) {
      const float* lg = a.logits + (size_t)b * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, __ldcg(lg + v));
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float s = 0.f;
      for (int v = lane; v < V; v += 32) s += expf(__ldcg(lg + v) - m);
      s = warp_sum(s);
      const float lse = m + logf(s);
      const int prev = __ldcg(a.tok + b);
      float best = -INFINITY;
      int arg = V;
      for (int v = lane; v < V; v += 32) {
        float lp = __ldcg(lg + v) - lse;
        if ((t == 0 && v == 0) || (a.constraint && t > 0 && v == prev))
          lp = -INFINITY;
        if (lp > best || (lp == best && v < arg)) { best = lp; arg = v; }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
      }
      if (lane == 0) {
        const int live = __ldcg(a.unfin + b) && arg > 0;
        const int nxt = live ? arg : 0;
        const size_t bt = (size_t)b * a.steps + t;
        a.seq[bt] = nxt;
        a.lps[bt] = best;
        for (int q = 0; q < 3; ++q)
          a.mw_out[bt * 3 + q] = nxt > 0 ? __ldcg(a.mw + b * 3 + q) : 0.f;
        a.tok[b] = nxt;
        a.unfin[b] = live;
        if (live) atomicAdd(a.counts + t, 1);
      }
    }
    sync(6);
    if (__ldcg(a.counts + t) == 0) break;    // same value in every block
  }
}

// Pointer slots of ekaid_greedy_decode's `ptrs` (weights first, in the
// order of Args).
enum {
  kNumWeights = 22,
  P_FUSED = kNumWeights, P_FEATS, P_SEQ, P_LPS, P_MW_OUT, P_H_MOD, P_C_MOD,
  P_H_LANG, P_C_LANG, P_VPOS, P_ZX, P_ZH, P_ATT, P_PPOS, P_GATE_H, P_GA,
  P_MW, P_LOGITS, P_TOK, P_UNFIN, P_COUNTS, P_PLAN, P_PART, P_TICKETS,
  P_PHASE_NS, P_COUNT
};
enum {
  D_B, D_T, D_E, D_R, D_D, D_W, D_V, D_P, D_CONSTRAINT, D_BU_PAD, D_GROUPS,
  D_LDA, D_SMEM, D_COUNT
};

template <typename T>
int launch(void* const* p, const int* d, cudaStream_t stream, int* grid_out) {
  Args<T> a;
  auto w = [p](int i) { return static_cast<const T*>(p[i]); };
  a.wemb = w(0); a.wih_mod = w(1); a.whh_mod = w(2); a.b_mod = w(3);
  a.wfc = w(4); a.bfc = w(5); a.wpos1 = w(6); a.bpos1 = w(7);
  a.wwp = w(8); a.bwp = w(9); a.wpos2 = w(10); a.bpos2 = w(11);
  a.wg1 = w(12); a.bg1 = w(13); a.wg2 = w(14); a.bg2 = w(15);
  a.wih_x = w(16); a.wih_a = w(17); a.whh_lang = w(18); a.b_lang = w(19);
  a.wlogit = w(20); a.blogit = w(21);
  a.fused = static_cast<const T*>(p[P_FUSED]);
  a.feats = static_cast<const T*>(p[P_FEATS]);
  a.seq = static_cast<int*>(p[P_SEQ]);
  a.lps = static_cast<float*>(p[P_LPS]);
  a.mw_out = static_cast<float*>(p[P_MW_OUT]);
  a.h_mod = static_cast<T*>(p[P_H_MOD]);
  a.c_mod = static_cast<T*>(p[P_C_MOD]);
  a.h_lang = static_cast<T*>(p[P_H_LANG]);
  a.c_lang = static_cast<T*>(p[P_C_LANG]);
  a.vpos = static_cast<T*>(p[P_VPOS]);
  a.zx = static_cast<T*>(p[P_ZX]);
  a.zh = static_cast<T*>(p[P_ZH]);
  a.att = static_cast<T*>(p[P_ATT]);
  a.ppos = static_cast<T*>(p[P_PPOS]);
  a.gate_h = static_cast<T*>(p[P_GATE_H]);
  a.ga = static_cast<T*>(p[P_GA]);
  a.mw = static_cast<float*>(p[P_MW]);
  a.logits = static_cast<float*>(p[P_LOGITS]);
  a.tok = static_cast<int*>(p[P_TOK]);
  a.unfin = static_cast<int*>(p[P_UNFIN]);
  a.counts = static_cast<int*>(p[P_COUNTS]);
  a.plan = static_cast<const int*>(p[P_PLAN]);
  a.part = static_cast<float*>(p[P_PART]);
  a.tickets = static_cast<int*>(p[P_TICKETS]);
  a.phase_ns = static_cast<unsigned long long*>(p[P_PHASE_NS]);
  a.B = d[D_B]; a.steps = d[D_T]; a.E = d[D_E]; a.R = d[D_R]; a.D = d[D_D];
  a.W = d[D_W]; a.V = d[D_V]; a.P = d[D_P]; a.constraint = d[D_CONSTRAINT];
  a.bu_pad = d[D_BU_PAD]; a.groups = d[D_GROUPS]; a.lda = d[D_LDA];
  const int smem = d[D_SMEM];

  // the plan's shared memory must hold this instance's layout
  const size_t need = std::max<size_t>(
      (size_t)a.bu_pad * a.lda * sizeof(T) + kRingStages * kStageBytes,
      sizeof(float) * (2 * a.R + 2 * (3 + a.P)));
  if ((size_t)smem < need || a.lda % 64 || a.bu_pad % 16 || a.bu_pad > 64)
    return cudaErrorInvalidValue;
  auto* fn = greedy_decode_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms;             // every block co-resident
  *grid_out = grid;
  void* kargs[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn), dim3(grid),
                                  dim3(kThreads), kargs, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype 0: float, 1: bfloat16. Returns a cudaError_t (0 on success).
int ekaid_greedy_decode(int dtype, void* const* ptrs, const int* dims,
                        void* stream, int* grid_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(ptrs, dims, s, grid_out);
  if (dtype == 1) return launch<__nv_bfloat16>(ptrs, dims, s, grid_out);
  return cudaErrorInvalidValue;
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ekaid_num_pointer_slots() { return P_COUNT; }
int ekaid_num_dims() { return D_COUNT; }

}  // extern "C"
