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
// Contract (each ROI r, at the level and patch origin (ys, xs) that the
// wrapper's `_roi_geometry` assigns, with the elongated-ROI level bump):
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
// Design. One block per ROI. Threads 0..2*out-1 first build one bin's
// taps each (rows or columns with their merged weights) in shared
// memory, from the per-ROI geometry the wrapper computes in torch
// (fmeta, 8 floats: y/x origin, bin h/w, y/x hi, y/x start). The
// weight arithmetic uses explicitly rounded operations, so the taps
// equal the plain version's hat matrices bit for bit. Then each thread
// owns one channel c (looping if C > blockDim) and, for every output
// bin, sums the taps it reads: with NHWC maps a warp reads one
// contiguous row segment of a (row, col) position, coalesced.
//
// Bound on an H100 (extraction: 8 images x 1000 ROIs, p2..p5 of a
// 1024^2 batch, C = 256, bf16): the taps of these ROIs are ~1.2 GFLOP,
// ~0.02 ms at the 67 TFLOP/s of the CUDA cores; the bytes are the map
// positions the ROIs read (a tenth of the 357 MB pyramid on the
// proposals of a flagship batch) once plus the 201 MB output written
// once, ~0.07 ms at 3.35 TB/s. So bytes bound it (chip_smoke.py::
// roi_bound computes it from each call's ROIs). This version reads
// every tap through L1/L2 and writes each output once. Its time does
// not change when the maps and the output are f32 (twice the bytes), so
// bytes do not set it. The likely cause is load latency: each thread
// walks a bin's taps in loops of run-time length into one serial sum,
// which leaves few loads in flight. More independent loads in flight
// (a bin's taps unrolled, several channels a thread) are later work
// (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxOut = 16;
constexpr int kMaxS = 4;
constexpr int kMaxTaps = 2 * kMaxS;
constexpr int kPatchY = 48;
constexpr int kPatchX = 56;
constexpr int kMaxThreads = 256;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
};

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float to(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 to(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The non-zero taps of one bin along one axis: patch positions p (as
// absolute map coordinates) and their bin-averaged weights, rounded to
// T when `round` is set (the rows of the K2 instance). Returns the
// count. Mirrors roi_kernels.py::_hats operation for operation.
template <typename T>
__device__ int bin_taps(float origin, float binsz, float hi, float start,
                        int bin, int s, int patch, bool round, int* pos,
                        float* wt) {
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(s));
  const float full = __fadd_rn(__fadd_rn(hi, start), 1.0f);
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
    pos[j] += base;
    if (round) wt[j] = Cvt<T>::round(wt[j]);
  }
  return n;
}

template <typename T, bool kRoundA>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_kernel(Levels lv, const int* __restrict__ meta,
                 const float* __restrict__ fmeta, T* __restrict__ out,
                 int C, int out_size, int s) {
  __shared__ int tap_pos[2][kMaxOut][kMaxTaps];
  __shared__ float tap_w[2][kMaxOut][kMaxTaps];
  __shared__ int tap_n[2][kMaxOut];

  const int r = blockIdx.x;
  const int img = meta[2 * r];
  const int lvl = meta[2 * r + 1];
  const float* fm = fmeta + 8 * static_cast<size_t>(r);
  const int t = threadIdx.x;
  if (t < 2 * out_size) {
    const int ax = t >= out_size;          // 0: rows (y), 1: columns (x)
    const int bin = t - ax * out_size;
    tap_n[ax][bin] = bin_taps<T>(
        fm[ax], fm[2 + ax], fm[4 + ax], fm[6 + ax], bin, s,
        ax ? kPatchX : kPatchY, kRoundA && ax == 0, tap_pos[ax][bin],
        tap_w[ax][bin]);
  }
  __syncthreads();

  const int h = lv.h[lvl];
  const T* base = static_cast<const T*>(lv.ptr[lvl])
                  + static_cast<size_t>(img) * h * h * C;
  T* o = out + static_cast<size_t>(r) * out_size * out_size * C;
  for (int c = t; c < C; c += blockDim.x) {
    for (int oy = 0; oy < out_size; ++oy) {
      const int ny = tap_n[0][oy];
      for (int ox = 0; ox < out_size; ++ox) {
        const int nx = tap_n[1][ox];
        float acc = 0.0f;
        for (int j = 0; j < nx; ++j) {
          const T* col = base + static_cast<size_t>(tap_pos[1][ox][j]) * C + c;
          float tv = 0.0f;
          for (int i = 0; i < ny; ++i)
            tv += tap_w[0][oy][i]
                  * Cvt<T>::f(col[static_cast<size_t>(tap_pos[0][oy][i]) * h * C]);
          acc += tap_w[1][ox][j] * tv;
        }
        o[(static_cast<size_t>(oy) * out_size + ox) * C + c] = Cvt<T>::to(acc);
      }
    }
  }
}

template <typename T, bool kRoundA>
int launch(const Levels& lv, const int* meta, const float* fmeta, void* out,
           int n_rois, int C, int out_size, int s, cudaStream_t stream) {
  if (n_rois == 0) return 0;
  int threads = ((C + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 2 * out_size) threads = ((2 * out_size + 31) / 32) * 32;
  roi_align_kernel<T, kRoundA><<<n_rois, threads, 0, stream>>>(
      lv, meta, fmeta, static_cast<T*>(out), C, out_size, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype 0: float, 1: bfloat16. round_a: round the row weights to the
// feature type (the K2 instance; no effect for float). level_ptrs and
// level_h are host arrays of num_levels entries; meta (int32 [n, 2]:
// image, level) and fmeta (f32 [n, 8]) are device arrays. Returns a
// cudaError_t (0 on success).
int ekaid_roi_align(int dtype, int round_a, void* const* level_ptrs,
                    const int* level_h, int num_levels, const void* meta,
                    const void* fmeta, void* out, int n_rois, int C,
                    int out_size, int sampling, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || out_size < 1
      || out_size > kMaxOut || sampling < 1 || sampling > kMaxS || C < 1
      || n_rois < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = level_ptrs[i];
    lv.h[i] = level_h[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* m = static_cast<const int*>(meta);
  const float* f = static_cast<const float*>(fmeta);
  if (dtype == 0)
    return launch<float, false>(lv, m, f, out, n_rois, C, out_size, sampling,
                                st);
  if (dtype == 1 && round_a)
    return launch<__nv_bfloat16, true>(lv, m, f, out, n_rois, C, out_size,
                                       sampling, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(lv, m, f, out, n_rois, C, out_size,
                                        sampling, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
