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
// Design. One persistent cooperative grid (occupancy x SMs blocks). A
// step is seven phases separated by grid.sync():
//   1. step-start products: the module LSTM (both products + gates, in
//      the epilogue of a tile that holds all four gates of 16 hidden
//      units), vpos, xt @ wih_x and h_lang @ whh_lang;
//   2. per row: mw, the POS softmax, ppos and att;
//   3. gate1x;  4. gate2x and gate * att;
//   5. (gate * att) @ wih_a and the language LSTM;  6. logits;
//   7. a warp per row: log-softmax, argmax, outputs, and a device-wide
//      count of unfinished rows that every block reads after the same
//      grid.sync(), so every block takes the same exit decision.
// A work unit of the product phases is 16 batch rows x 64 weight
// columns: the rows' inputs are staged in shared memory as f32, each
// thread accumulates 2 columns x 16 rows in registers over a slice of K,
// and the 8 K-slices are summed in a fixed order. States and per-step
// intermediates live in a global scratch buffer (L2-resident at these
// sizes) and are read through L2 (__ldcg); h_mod is double-buffered
// because every block reads the old value while others write the new.
//
// Bound on an H100 (flagship widths E=D=1024, R=512, W=300, V=148, B=64,
// bf16): each step multiplies B rows by ~14.6M weight values, ~1.9 GFLOP
// a step. Read once, the 29.3 MB of bf16 weights take 8.8 us at
// 3.35 TB/s, so with the weights held in the 50 MB L2 between steps the
// least time is the tensor-core time of the products (~1.9 us a step at
// 989 TFLOP/s); streamed from device memory each step it is 8.8 us a
// step. This first version does the products on the CUDA cores in f32
// (67 TFLOP/s: ~28 us a step at best) and pays seven grid-wide barriers
// a step; wgmma, TMA and warp specialisation are later work. Measured
// on an H100 (chip_smoke.py): ~243 us a step at B=64. The weight
// stream bounds it, not the arithmetic: a unit has ~16 KB of weight
// loads in flight per SM, and the four 16-row groups of a 64-row batch
// each re-read every weight tile. A faster version reads each weight
// once a step, from units that span all rows (PERF.md).

#include <algorithm>
#include <cmath>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRB = 16;                      // batch rows per work unit
constexpr int kTN = 64;                      // weight columns per work unit
constexpr int kTX = kTN / 2;                 // threads along the columns
constexpr int kKS = kThreads / kTX;          // K-slices per unit (8)
constexpr int kGT = kTN / 4;                 // hidden units per gate tile

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
  unsigned long long* phase_ns;             // [7] or null
  int B, steps, E, R, D, W, V, P, constraint;
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
__device__ ColMap contiguous(int tile, int N) {
  int n0 = tile * kTN;
  return ColMap{n0, kTN, 0, min(kTN, N - n0)};
}
// the four gate columns (i, f, g, o) of hidden units [r0, r0 + kGT)
__device__ ColMap gates(int tile, int R) {
  int r0 = tile * kGT;
  return ColMap{r0, kGT, R, min(kGT, R - r0)};
}

// res[i][j] = round_T(sum_k X[b0 + i][k] * W[k][col(j)]) for kRB rows and
// kTN tile columns (rows past B and invalid columns give 0).
template <typename T>
__device__ void tile_mm(const Input<T>& in, const T* __restrict__ w, int ldn,
                        ColMap cm, int b0, int B, float* xs, float* red,
                        float* res) {
  // stage the rows' inputs transposed, xs[k][i], as f32 (kRB loads in
  // flight per thread; rows past B are zero)
  const int nb = min(kRB, B - b0);
  int K = 0;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s >= in.n) break;
    const Seg<T> sg = in.s[s];
    const T* row[kRB];
#pragma unroll
    for (int i = 0; i < kRB; ++i)
      row[i] = i < nb ? sg.p + (size_t)(sg.rows ? __ldcg(sg.rows + b0 + i)
                                                : b0 + i) * sg.ld
                      : nullptr;
    for (int k = threadIdx.x; k < sg.k; k += kThreads) {
      float v[kRB];
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        v[i] = row[i] ? (sg.rows ? ldw(row[i] + k) : lda(row[i] + k)) : 0.f;
        if (sg.relu) v[i] = fmaxf(v[i], 0.f);
      }
      float4* dst = reinterpret_cast<float4*>(xs + (K + k) * kRB);
#pragma unroll
      for (int q = 0; q < kRB / 4; ++q)
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
    K += sg.k;
  }
  __syncthreads();

  // each thread: 2 columns x kRB rows over the K-slice ty, ty + kKS, ...
  constexpr int kU = 8;                      // weight loads in flight
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX, j0 = 2 * tx;
  const bool v0 = cm.valid(j0), v1 = cm.valid(j0 + 1);
  const T* w0 = w + cm.col(j0);
  const T* w1 = w + cm.col(j0 + 1);
  float acc0[kRB], acc1[kRB];
#pragma unroll
  for (int i = 0; i < kRB; ++i) acc0[i] = acc1[i] = 0.f;
  auto fma_row = [&](int k, float a, float c) {
    const float4* xv = reinterpret_cast<const float4*>(xs + k * kRB);
#pragma unroll
    for (int q = 0; q < kRB / 4; ++q) {
      const float4 x = xv[q];
      acc0[4 * q + 0] = fmaf(x.x, a, acc0[4 * q + 0]);
      acc0[4 * q + 1] = fmaf(x.y, a, acc0[4 * q + 1]);
      acc0[4 * q + 2] = fmaf(x.z, a, acc0[4 * q + 2]);
      acc0[4 * q + 3] = fmaf(x.w, a, acc0[4 * q + 3]);
      acc1[4 * q + 0] = fmaf(x.x, c, acc1[4 * q + 0]);
      acc1[4 * q + 1] = fmaf(x.y, c, acc1[4 * q + 1]);
      acc1[4 * q + 2] = fmaf(x.z, c, acc1[4 * q + 2]);
      acc1[4 * q + 3] = fmaf(x.w, c, acc1[4 * q + 3]);
    }
  };
  auto load_chunk = [&](int k, float (&a)[kU], float (&c)[kU]) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      a[u] = v0 ? ldw(w0 + (size_t)(k + u * kKS) * ldn) : 0.f;
      c[u] = v1 ? ldw(w1 + (size_t)(k + u * kKS) * ldn) : 0.f;
    }
  };
  int k = ty;
  if (k + (kU - 1) * kKS < K) {
    // the next chunk's weights load while this chunk is multiplied
    float a[kU], c[kU];
    load_chunk(k, a, c);
    while (true) {
      const int kn = k + kU * kKS;
      const bool more = kn + (kU - 1) * kKS < K;
      float an[kU], cn[kU];
      if (more) load_chunk(kn, an, cn);
#pragma unroll
      for (int u = 0; u < kU; ++u) fma_row(k + u * kKS, a[u], c[u]);
      k = kn;
      if (!more) break;
#pragma unroll
      for (int u = 0; u < kU; ++u) { a[u] = an[u]; c[u] = cn[u]; }
    }
  }
  for (; k < K; k += kKS)
    fma_row(k, v0 ? ldw(w0 + (size_t)k * ldn) : 0.f,
            v1 ? ldw(w1 + (size_t)k * ldn) : 0.f);
#pragma unroll
  for (int i = 0; i < kRB; ++i) {
    red[(ty * kRB + i) * kTN + j0] = acc0[i];
    red[(ty * kRB + i) * kTN + j0 + 1] = acc1[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kKS; ++q) s += red[q * kRB * kTN + o];
    res[o] = rnd<T>(s);
  }
  __syncthreads();
}

// LSTM gate math in f32 from rounded pre-activations z (i, f, g, o).
template <typename T>
__device__ void lstm_store(const float z[4], T* h, T* c) {
  const float c_prev = lda(c);
  const float cn = sigm(z[1]) * c_prev + sigm(z[0]) * tanhf(z[2]);
  const float hn = sigm(z[3]) * tanhf(cn);
  st(h, hn);
  st(c, cn);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    greedy_decode_kernel(Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int B = a.B, R = a.R, D = a.D, E = a.E, V = a.V, P = a.P;
  const int R4 = 4 * R, G1 = 2 * R + D;
  const int RG = (B + kRB - 1) / kRB;
  const int KX = max(max(E + R, G1), max(a.W, D));
  float* xs = smem;
  float* red = xs + kRB * KX;
  float* res0 = red + kKS * kRB * kTN;
  float* res1 = res0 + kRB * kTN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = kThreads / 32;

  const int u_mod = ((R + kGT - 1) / kGT) * RG;
  const int u_vpos = ((R + kTN - 1) / kTN) * RG;
  const int u_4r = ((R4 + kTN - 1) / kTN) * RG;
  const int u_g1 = ((G1 + kTN - 1) / kTN) * RG;
  const int u_g2 = ((D + kTN - 1) / kTN) * RG;
  const int u_v = ((V + kTN - 1) / kTN) * RG;
  // phase times summed over steps, as block 0 sees them between barriers
  const bool timing = a.phase_ns && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long last = timing ? globaltimer() : 0;
  auto sync = [&](int phase) {
    grid.sync();
    if (timing) {
      const unsigned long long now = globaltimer();
      a.phase_ns[phase] += now - last;
      last = now;
    }
  };

  for (int t = 0; t < a.steps; ++t) {
    const T* h_mod_cur = a.h_mod + (size_t)(t & 1) * B * R;
    T* h_mod_nxt = a.h_mod + (size_t)((t + 1) & 1) * B * R;

    // ---- phase 1: step-start products -----------------------------
    for (int u = blockIdx.x; u < u_mod + u_vpos + 2 * u_4r; u += gridDim.x) {
      if (u < u_mod) {                       // module-attention LSTM
        const int tile = u / RG, b0 = (u % RG) * kRB;
        const ColMap cm = gates(tile, R);
        tile_mm(input(Seg<T>{a.fused, E, E, nullptr, false},
                      Seg<T>{a.h_lang, R, R, nullptr, false}),
                a.wih_mod, R4, cm, b0, B, xs, red, res0);
        tile_mm(input(Seg<T>{h_mod_cur, R, R, nullptr, false}), a.whh_mod,
                R4, cm, b0, B, xs, red, res1);
        for (int o = threadIdx.x; o < kRB * kGT; o += kThreads) {
          const int i = o / kGT, rr = o % kGT, b = b0 + i, r = cm.n0 + rr;
          if (b >= B || rr >= cm.gvalid) continue;
          float z[4];
          for (int q = 0; q < 4; ++q) {
            const int j = i * kTN + q * kGT + rr;
            z[q] = addr<T>(addr<T>(res0[j], res1[j]), ldw(a.b_mod + q * R + r));
          }
          lstm_store(z, h_mod_nxt + (size_t)b * R + r, a.c_mod + (size_t)b * R + r);
        }
      } else if (u < u_mod + u_vpos) {       // vpos = relu(h_lang @ wpos1 + b)
        const int v = u - u_mod, tile = v / RG, b0 = (v % RG) * kRB;
        const ColMap cm = contiguous(tile, R);
        tile_mm(input(Seg<T>{a.h_lang, R, R, nullptr, false}), a.wpos1, R,
                cm, b0, B, xs, red, res0);
        for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
          const int i = o / kTN, j = o % kTN, b = b0 + i, n = cm.n0 + j;
          if (b >= B || !cm.valid(j)) continue;
          st(a.vpos + (size_t)b * R + n,
             fmaxf(addr<T>(res0[o], ldw(a.bpos1 + n)), 0.f));
        }
      } else {                               // xt @ wih_x, h_lang @ whh_lang
        const int v = u - u_mod - u_vpos, which = v / u_4r;
        const int tile = (v % u_4r) / RG, b0 = (v % RG) * kRB;
        const ColMap cm = contiguous(tile, R4);
        if (which == 0) {
          tile_mm(input(Seg<T>{a.wemb, a.W, a.W, a.tok, true}), a.wih_x,
                  R4, cm, b0, B, xs, red, res0);
        } else {
          tile_mm(input(Seg<T>{a.h_lang, R, R, nullptr, false}), a.whh_lang,
                  R4, cm, b0, B, xs, red, res0);
        }
        T* out = which == 0 ? a.zx : a.zh;
        for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
          const int i = o / kTN, j = o % kTN, b = b0 + i;
          if (b >= B || !cm.valid(j)) continue;
          st(out + (size_t)b * R4 + cm.n0 + j, res0[o]);
        }
      }
      __syncthreads();
    }
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
    for (int u = blockIdx.x; u < u_g1; u += gridDim.x) {
      const int tile = u / RG, b0 = (u % RG) * kRB;
      const ColMap cm = contiguous(tile, G1);
      tile_mm(input(Seg<T>{a.h_lang, R, R, nullptr, false},
                    Seg<T>{a.ppos, R, R, nullptr, false},
                    Seg<T>{a.att, D, D, nullptr, false}),
              a.wg1, G1, cm, b0, B, xs, red, res0);
      for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
        const int i = o / kTN, j = o % kTN, b = b0 + i, n = cm.n0 + j;
        if (b >= B || !cm.valid(j)) continue;
        st(a.gate_h + (size_t)b * G1 + n,
           fmaxf(addr<T>(res0[o], ldw(a.bg1 + n)), 0.f));
      }
      __syncthreads();
    }
    sync(2);

    // ---- phase 4: gate = sigmoid(gate_h @ wg2 + bg2); ga = gate*att
    for (int u = blockIdx.x; u < u_g2; u += gridDim.x) {
      const int tile = u / RG, b0 = (u % RG) * kRB;
      const ColMap cm = contiguous(tile, D);
      tile_mm(input(Seg<T>{a.gate_h, G1, G1, nullptr, false}), a.wg2, D, cm,
              b0, B, xs, red, res0);
      for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
        const int i = o / kTN, j = o % kTN, b = b0 + i, n = cm.n0 + j;
        if (b >= B || !cm.valid(j)) continue;
        const float g = rnd<T>(sigm(addr<T>(res0[o], ldw(a.bg2 + n))));
        st(a.ga + (size_t)b * D + n, mulr<T>(g, lda(a.att + (size_t)b * D + n)));
      }
      __syncthreads();
    }
    sync(3);

    // ---- phase 5: language LSTM -----------------------------------
    for (int u = blockIdx.x; u < u_mod; u += gridDim.x) {
      const int tile = u / RG, b0 = (u % RG) * kRB;
      const ColMap cm = gates(tile, R);
      tile_mm(input(Seg<T>{a.ga, D, D, nullptr, false}), a.wih_a, R4, cm, b0,
              B, xs, red, res0);
      for (int o = threadIdx.x; o < kRB * kGT; o += kThreads) {
        const int i = o / kGT, rr = o % kGT, b = b0 + i, r = cm.n0 + rr;
        if (b >= B || rr >= cm.gvalid) continue;
        float z[4];
        for (int q = 0; q < 4; ++q) {
          const size_t n = (size_t)b * R4 + q * R + r;
          z[q] = addr<T>(addr<T>(addr<T>(lda(a.zx + n), res0[i * kTN + q * kGT + rr]),
                                 lda(a.zh + n)),
                         ldw(a.b_lang + q * R + r));
        }
        lstm_store(z, a.h_lang + (size_t)b * R + r, a.c_lang + (size_t)b * R + r);
      }
      __syncthreads();
    }
    sync(4);

    // ---- phase 6: logits = h_lang @ wlogit + blogit -----------------
    for (int u = blockIdx.x; u < u_v; u += gridDim.x) {
      const int tile = u / RG, b0 = (u % RG) * kRB;
      const ColMap cm = contiguous(tile, V);
      tile_mm(input(Seg<T>{a.h_lang, R, R, nullptr, false}), a.wlogit, V, cm,
              b0, B, xs, red, res0);
      for (int o = threadIdx.x; o < kRB * kTN; o += kThreads) {
        const int i = o / kTN, j = o % kTN, b = b0 + i, n = cm.n0 + j;
        if (b >= B || !cm.valid(j)) continue;
        a.logits[(size_t)b * V + n] = addr<T>(res0[o], ldw(a.blogit + n));
      }
      __syncthreads();
    }
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
  P_MW, P_LOGITS, P_TOK, P_UNFIN, P_COUNTS, P_PHASE_NS, P_COUNT
};
enum { D_B, D_T, D_E, D_R, D_D, D_W, D_V, D_P, D_CONSTRAINT, D_COUNT };

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
  a.phase_ns = static_cast<unsigned long long*>(p[P_PHASE_NS]);
  a.B = d[D_B]; a.steps = d[D_T]; a.E = d[D_E]; a.R = d[D_R]; a.D = d[D_D];
  a.W = d[D_W]; a.V = d[D_V]; a.P = d[D_P]; a.constraint = d[D_CONSTRAINT];

  const int KX = std::max({a.E + a.R, 2 * a.R + a.D, a.W, a.D});
  const int xs_floats =
      std::max(kRB * KX, 2 * a.R + 2 * (3 + a.P));
  const size_t smem = sizeof(float) *
      ((size_t)xs_floats + kKS * kRB * kTN + 2 * kRB * kTN);
  auto* fn = greedy_decode_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
