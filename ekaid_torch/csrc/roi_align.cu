// Batched multilevel ROIAlignV2 for Hopper (sm_90a): the K2 and K3 kernels.
//
// Replaces two Pallas kernels of ekaid_tpu/ops/pallas_roi.py with one
// template:
//   K2  _make_canvas_kernel (roi_backend 'canvas', the extraction default):
//       instance <T, kRoundA = (T is bf16)>: the row weights a_y are
//       rounded to the feature type, products accumulate in f32;
//   K3  _make_kernel (roi_backend 'pallas'): instance <T, false>: every
//       operand is f32.
// Both write the result rounded once to the feature type T (float or
// __nv_bfloat16).
//
// Contract (each ROI r, at the level and patch origin (ys, xs) of
// roi_kernels.py::_roi_geometry, with the elongated-ROI level bump):
//   out[r, oy, ox, c] = sum_px b_x[ox, px] * sum_py a_y[oy, py]
//                       * level[img, ys + py, xs + px, c]
// a_y [out, 48] and b_x [out, 56] are the bin-averaged hat matrices of
// the reference: for sample i of bin o, raw = origin + bin * (o + (i+0.5)/s)
// (patch-relative), weight 0 unless the absolute coordinate lies in
// [-1, H], clamped to [0, hi], and max(0, 1 - |clamped - p|) on patch
// row p; a_y[o, p] = sum_i (1/s) * w_i(p). Rows outside the 48x56
// patch carry no weight. So a bin has at most 2s non-zero rows and 2s
// non-zero columns, and only those are read.
//
// Bound on an H100 (extraction: 8 images x 1000 ROIs, p2..p5 of a
// 1024^2 batch, C = 256, bf16): the taps are ~1.2 GFLOP, ~0.02 ms at
// the 67 TFLOP/s of the CUDA cores; the bytes are the map positions the
// ROIs read (about a tenth of the 357 MB pyramid on the proposals of a
// flagship batch) once plus the 201 MB output written once, ~0.07 ms at
// 3.35 TB/s. So bytes bound it (chip_smoke.py::roi_bound computes it
// from each call's ROIs). The taps themselves are read through L1/L2:
// every (bin, row tap, column tap) reads all C channels of one position,
// about 1 GB a call at bf16, from positions that fit in the 50 MB L2.
//
// Design:
// - The ROI geometry is computed here, not in torch. The wrapper passes
//   the raw boxes [n, 4] f32 and a table of the levels (pointer,
//   height, scale). Each ROI's warp computes its level (the FPN
//   heuristic plus the bump to the first level whose 44-px cap fits
//   the long side) and the 8 patch floats with explicitly rounded
//   operations in the order of _roi_geometry: true divisions
//   (__fdiv_rn), log2 in double rounded once to f32, floorf and ceilf.
//   So the kernel, the plain geometry on the card and on the CPU give
//   the same bits. An optional debug buffer receives (image, level, the
//   8 floats) of each ROI.
// - One warp per ROI, two warps per block, no block-wide barrier. Lanes
//   0..out-1 build the column taps of one bin column each, the next out
//   lanes the row taps of one bin row each (one instruction stream, the
//   axis picked by lane), into the warp's slice of shared memory as
//   element offsets and weights, the way _hats builds the hat matrices;
//   then the warp walks the out x out bins, computing the geometry and
//   the taps once. 8,000 ROIs are 4,000 blocks, a few waves of the SMs.
// - 16-byte channel vectors: a lane owns 8 contiguous bf16 channels (4
//   for f32) and reads each tap position as one uint4, so a warp reads
//   512 contiguous bytes a request, a whole (bin, 256 channels) segment
//   at bf16. The output goes out the same way, with streaming stores.
// - Independent taps in flight: the tap lists have compile-time maxima
//   (kTaps = 2s: 4 for s <= 2, 8 up to s = 4), and the loads of a group
//   of up to kLoads taps (two column taps of a bin at s <= 2, so a bin
//   of 2 x 2 taps, the common one on the extraction ROIs, at once) are
//   issued, predicated, before their sums. The sums keep the
//   reference's order: a_y times the patch per column tap, then b_x, in
//   f32. Loads in flight cost registers, and registers set how many
//   warps an SM holds (chip_smoke.py prints both). Tried and slower: all
//   16 taps of a bin at once (fewer warps), registers capped by
//   __launch_bounds__ (loads serialised), a separate 2 x 2-tap path
//   (more registers), a warp per bin row (the prologue out times), and
//   carrying a column's row sum to the next bin that shares the column
//   (fewer loads, but a dependence from bin to bin).
// Times: PERF.md (chip_smoke.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxOut = 16;
constexpr int kMaxS = 4;
constexpr int kPatchY = 48;
constexpr int kPatchX = 56;
constexpr float kLevelCap = 44.0f;      // roi_kernels.py::LEVEL_CAP
constexpr float kCanonicalSize = 224.0f;
constexpr float kCanonicalLevel = 4.0f;
constexpr int kWarps = 2;               // warps (ROIs) per block
constexpr int kLoads = 8;               // tap loads a lane issues at once
constexpr int kGeoFloats = 10;          // image, level, 8 patch floats

// Filled by roi_kernels.py::level_table (ctypes) with the same layout.
struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  float scale[kMaxLevels];
  int num;
  int min_level;
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* x) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack2(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ uint4 pack(const float* x) {
    return make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]),
                      pack2(x[4], x[5]), pack2(x[6], x[7]));
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// log2 rounded once to f32 (computed in double): the same bits on the
// card and on the CPU, see roi_align.py::log2_f32.
__device__ __forceinline__ float log2_f32(float x) {
  return static_cast<float>(log2(static_cast<double>(x)));
}

struct Geometry {
  int img;
  int lvl;              // index into Levels
  float f[8];           // y/x origin, bin h/w, y/x hi, y/x start
};

// _roi_geometry for one box, operation for operation.
__device__ Geometry roi_geometry(float4 b, int img, const Levels& lv,
                                 int out_size, int s) {
  Geometry g;
  g.img = img;
  const float w = __fsub_rn(b.z, b.x);
  const float h = __fsub_rn(b.w, b.y);
  // assign_levels: floor(4 + log2(max(sqrt(w h), 1e-6) / 224)), clamped
  const float size = __fsqrt_rn(__fmul_rn(fmaxf(w, 0.0f), fmaxf(h, 0.0f)));
  float l = floorf(__fadd_rn(
      kCanonicalLevel,
      log2_f32(__fdiv_rn(fmaxf(size, 1e-6f), kCanonicalSize))));
  const int max_level = lv.min_level + lv.num - 1;
  l = fminf(fmaxf(l, static_cast<float>(lv.min_level)),
            static_cast<float>(max_level));
  int lvl = static_cast<int>(l) - lv.min_level;
  // the elongated-ROI bump: the first level whose cap fits the long side
  const float long_side = fmaxf(fmaxf(w, h), 0.0f);
  const int needed = static_cast<int>(ceilf(log2_f32(fmaxf(
      __fdiv_rn(__fmul_rn(long_side, lv.scale[0]), kLevelCap), 1e-6f))));
  lvl = min(max(max(lvl, needed), 0), lv.num - 1);
  g.lvl = lvl;

  const float hf = static_cast<float>(lv.h[lvl]);
  const float py = fminf(hf, static_cast<float>(kPatchY));
  const float px = fminf(hf, static_cast<float>(kPatchX));
  const float sc = lv.scale[lvl];
  const float x1 = __fsub_rn(__fmul_rn(b.x, sc), 0.5f);
  const float y1 = __fsub_rn(__fmul_rn(b.y, sc), 0.5f);
  const float osz = static_cast<float>(out_size);
  const float bin_w = __fdiv_rn(__fmul_rn(w, sc), osz);
  const float bin_h = __fdiv_rn(__fmul_rn(h, sc), osz);
  const float half_s = static_cast<float>(0.5 / s);
  const float first_y = __fadd_rn(y1, __fmul_rn(bin_h, half_s));
  const float first_x = __fadd_rn(x1, __fmul_rn(bin_w, half_s));
  const float ys = fminf(fmaxf(floorf(first_y), 0.0f), __fsub_rn(hf, py));
  const float xs = __fmul_rn(
      floorf(__fdiv_rn(fminf(fmaxf(floorf(first_x), 0.0f),
                             __fsub_rn(hf, px)), 8.0f)), 8.0f);
  const float hi = __fsub_rn(hf, 1.0f);
  g.f[0] = __fsub_rn(y1, ys);
  g.f[1] = __fsub_rn(x1, xs);
  g.f[2] = bin_h;
  g.f[3] = bin_w;
  g.f[4] = __fsub_rn(hi, ys);
  g.f[5] = __fsub_rn(hi, xs);
  g.f[6] = ys;
  g.f[7] = xs;
  return g;
}

// The non-zero taps of one bin along one axis: absolute map positions,
// returned as element offsets (position * stride), and their
// bin-averaged weights, rounded to T when `round` is set (the rows of
// the K2 instance). Returns the count. Mirrors roi_kernels.py::_hats
// operation for operation.
template <typename T>
__device__ int bin_taps(float origin, float binsz, float hi, float start,
                        int bin, int s, int patch, bool round, int stride,
                        int* off, float* wt) {
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(s));
  const float full = __fadd_rn(__fadd_rn(hi, start), 1.0f);
  int* pos = off;                        // patch positions until the end
  int n = 0;
  for (int i = 0; i < s; ++i) {
    const float g = __fadd_rn(
        static_cast<float>(bin),
        __fdiv_rn(__fadd_rn(static_cast<float>(i), 0.5f),
                  static_cast<float>(s)));
    const float raw = __fadd_rn(origin, __fmul_rn(binsz, g));
    const float absc = __fadd_rn(raw, start);
    if (!(absc >= -1.0f && absc <= full)) continue;   // zero weight row
    const float cl = fminf(fmaxf(raw, 0.0f), hi);
    const float p0 = floorf(cl);
    for (int k = 0; k < 2; ++k) {
      const float p = __fadd_rn(p0, static_cast<float>(k));
      const float w = fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(cl, p))));
      const int pi = static_cast<int>(p);
      if (w == 0.0f || pi >= patch) continue;
      const float wa = __fmul_rn(w, inv_s);
      int j = 0;
      while (j < n && pos[j] != pi) ++j;
      if (j == n) {
        pos[n] = pi;
        wt[n++] = wa;
      } else {
        wt[j] = __fadd_rn(wt[j], wa);
      }
    }
  }
  const int base = static_cast<int>(start);
  for (int j = 0; j < n; ++j) {
    off[j] = (pos[j] + base) * stride;
    if (round) wt[j] = Vec<T>::round(wt[j]);
  }
  return n;
}

// One warp's taps: axis 0 the rows of each bin row, axis 1 the columns
// of each bin column (element offsets and weights), and their counts.
template <int kTaps>
struct WarpTaps {
  int off[2][kMaxOut][kTaps];
  float w[2][kMaxOut][kTaps];
  int n[2][kMaxOut];
};

// One output bin (oy, ox), lane channels [c0, c0 + kN). The loads of
// kCols column taps (two of them at s <= 2) are issued, predicated,
// before their sums.
template <typename T, int kTaps>
__device__ __forceinline__ void pool_bin(const T* __restrict__ base,
                                         const WarpTaps<kTaps>& tp, int oy,
                                         int ox, int c0,
                                         T* __restrict__ dst) {
  constexpr int kN = Vec<T>::kN;
  constexpr int kCols = kTaps * kTaps <= kLoads ? kTaps
                        : kLoads / kTaps > 0 ? kLoads / kTaps : 1;
  const int ny = tp.n[0][oy], nx = tp.n[1][ox];
  const int* roff = tp.off[0][oy];
  const float* rw = tp.w[0][oy];
  const int* coff = tp.off[1][ox];
  const float* cw = tp.w[1][ox];
  float acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.0f;
#pragma unroll
  for (int j0 = 0; j0 < kTaps; j0 += kCols) {
    if (j0 >= nx) break;
    uint4 v[kCols][kTaps];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
#pragma unroll
      for (int i = 0; i < kTaps; ++i)
        if (j0 + j < nx && i < ny)
          v[j][i] = __ldg(reinterpret_cast<const uint4*>(
              base + roff[i] + coff[j0 + j] + c0));
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (j0 + j >= nx) break;
      float tv[kN];
#pragma unroll
      for (int k = 0; k < kN; ++k) tv[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
        if (i >= ny) break;
        float x[kN];
        Vec<T>::unpack(v[j][i], x);
        const float a = rw[i];
#pragma unroll
        for (int k = 0; k < kN; ++k) tv[k] = fmaf(a, x[k], tv[k]);
      }
      const float b = cw[j0 + j];
#pragma unroll
      for (int k = 0; k < kN; ++k) acc[k] = fmaf(b, tv[k], acc[k]);
    }
  }
  __stcs(reinterpret_cast<uint4*>(dst + c0), Vec<T>::pack(acc));
}

// One warp per ROI.
template <typename T, bool kRoundA, int kTaps>
__global__ void __launch_bounds__(kWarps * 32)
roi_align_kernel(Levels lv, const float4* __restrict__ rois, int n_rois,
                 int rois_per_image, T* __restrict__ out, int C,
                 int out_size, int s, float* __restrict__ geo) {
  __shared__ WarpTaps<kTaps> taps[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= n_rois) return;

  const Geometry g = roi_geometry(rois[r], r / rois_per_image, lv,
                                  out_size, s);
  if (geo != nullptr && lane < kGeoFloats) {
    float v = lane == 0 ? static_cast<float>(g.img) : static_cast<float>(g.lvl);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (lane == k + 2) v = g.f[k];
    geo[static_cast<size_t>(r) * kGeoFloats + lane] = v;
  }
  const int h = lv.h[g.lvl];
  WarpTaps<kTaps>& tp = taps[warp];
  // lanes 0 .. out-1 build the columns of bin column `lane`, the next
  // out lanes the rows of each bin row: one instruction stream
  const int ax = lane < out_size ? 1 : 0;
  const int bin = ax ? lane : lane - out_size;
  if (bin < out_size) {
    tp.n[ax][bin] = bin_taps<T>(
        ax ? g.f[1] : g.f[0], ax ? g.f[3] : g.f[2], ax ? g.f[5] : g.f[4],
        ax ? g.f[7] : g.f[6], bin, s, ax ? kPatchX : kPatchY,
        kRoundA && !ax, ax ? C : h * C, tp.off[ax][bin], tp.w[ax][bin]);
  }
  __syncwarp();

  const T* base = static_cast<const T*>(lv.ptr[g.lvl])
                  + static_cast<size_t>(g.img) * h * h * C;
  T* o = out + static_cast<size_t>(r) * out_size * out_size * C;
  constexpr int kN = Vec<T>::kN;
  for (int oy = 0; oy < out_size; ++oy)
    for (int ox = 0; ox < out_size; ++ox)
      for (int c0 = lane * kN; c0 < C; c0 += 32 * kN)
        pool_bin<T, kTaps>(base, tp, oy, ox, c0,
                           o + (static_cast<size_t>(oy) * out_size + ox) * C);
}

template <typename T, bool kRoundA, int kTaps>
int launch(const Levels& lv, const float4* rois, int n_rois,
           int rois_per_image, void* out, int C, int out_size, int s,
           float* geo, cudaStream_t stream) {
  if (n_rois == 0) return 0;
  const int blocks = (n_rois + kWarps - 1) / kWarps;
  roi_align_kernel<T, kRoundA, kTaps><<<blocks, kWarps * 32, 0, stream>>>(
      lv, rois, n_rois, rois_per_image, static_cast<T*>(out), C, out_size,
      s, geo);
  return static_cast<int>(cudaGetLastError());
}

// The instance for (dtype, round_a, sampling): its launch and its kernel.
template <int kTaps>
int dispatch(int dtype, int round_a, const Levels& lv, const float4* rois,
             int n_rois, int rois_per_image, void* out, int C, int out_size,
             int s, float* geo, cudaStream_t st, int* blocks_per_sm) {
  auto run = [&](auto kernel, auto launcher) {
    if (blocks_per_sm != nullptr)
      return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, kernel, kWarps * 32, 0));
    return launcher(lv, rois, n_rois, rois_per_image, out, C, out_size, s,
                    geo, st);
  };
  if (dtype == 0)
    return run(roi_align_kernel<float, false, kTaps>,
               launch<float, false, kTaps>);
  if (round_a)
    return run(roi_align_kernel<__nv_bfloat16, true, kTaps>,
               launch<__nv_bfloat16, true, kTaps>);
  return run(roi_align_kernel<__nv_bfloat16, false, kTaps>,
             launch<__nv_bfloat16, false, kTaps>);
}

int entry(int dtype, int round_a, const Levels& lv, const float4* rois,
          int n_rois, int rois_per_image, void* out, int C, int out_size,
          int s, float* geo, cudaStream_t st, int* blocks_per_sm) {
  if (s <= 2)
    return dispatch<4>(dtype, round_a, lv, rois, n_rois, rois_per_image,
                       out, C, out_size, s, geo, st, blocks_per_sm);
  return dispatch<2 * kMaxS>(dtype, round_a, lv, rois, n_rois,
                             rois_per_image, out, C, out_size, s, geo, st,
                             blocks_per_sm);
}

}  // namespace

extern "C" {

// dtype 0: float, 1: bfloat16. round_a: round the row weights to the
// feature type (the K2 instance; no effect for float). levels: a host
// struct of the level maps (NHWC, square, 16-byte aligned), heights,
// scales, count and first level. rois: device f32 [n_rois, 4] boxes,
// rois_per_image of each image in turn. out: device [n_rois, out_size,
// out_size, C] of the feature type; C a multiple of 16 bytes. geo: null,
// or device f32 [n_rois, 10] for each ROI's image, level and patch
// geometry. Returns a cudaError_t (0 on success).
int ekaid_roi_align(int dtype, int round_a, const void* levels,
                    const void* rois, int n_rois, int rois_per_image,
                    void* out, int C, int out_size, int sampling,
                    void* geo, void* stream) {
  const Levels& lv = *static_cast<const Levels*>(levels);
  const int vec = dtype == 0 ? 4 : 8;
  if (lv.num < 1 || lv.num > kMaxLevels || out_size < 1
      || out_size > kMaxOut || sampling < 1 || sampling > kMaxS
      || C < vec || C % vec || n_rois < 0 || rois_per_image < 1
      || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return entry(dtype, round_a, lv, static_cast<const float4*>(rois), n_rois,
               rois_per_image, out, C, out_size, sampling,
               static_cast<float*>(geo), static_cast<cudaStream_t>(stream),
               nullptr);
}

// The resident warps per SM of the instance that the same dtype,
// round_a and sampling launch, into *warps. Returns a cudaError_t.
int ekaid_roi_align_warps_per_sm(int dtype, int round_a, int sampling,
                                 int* warps) {
  if (sampling < 1 || sampling > kMaxS || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  const int err = entry(dtype, round_a, Levels{}, nullptr, 0, 1, nullptr,
                        0, 1, sampling, nullptr, nullptr, &blocks);
  *warps = blocks * kWarps;
  return err;
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
