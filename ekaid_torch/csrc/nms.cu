// Greedy NMS for Hopper (sm_90a): the K4 kernel.
//
// Replaces ekaid_tpu/ops/pallas_nms.py::_nms_kernel, which nms_pallas runs
// for one image and callers vmap over a batch. Here one launch serves the
// batch: block b runs image b.
//
// Contract (each image, rows j < R): row j is live iff score[j] > NEG / 2
// (NEG = -1e9). For slot i = 0 .. max_out - 1: take the live row with the
// largest score, the lowest index among equal scores. If none is live,
// every remaining slot is (0, false). Otherwise write (best, true) and kill
// best and every row j with iou(best, j) > thresh, where
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   iw/ih = max(min(x2_j, x2_b) - max(x1_j, x1_b), 0), the same in y
//   union = (area_j + area_b) - iw * ih
//   iou   = union > 0 ? iw * ih / union : 0.
// Every rounding is explicit (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn):
// nvcc contracts nothing into an FMA, so a box near the threshold goes the
// same way as in the plain version (ops/nms_kernel.py) and the selections
// are bit-equal.
//
// Design. Each thread owns rows t, t + blockDim, ...; their x1, y1, x2, y2,
// area and live score (NEG once dead) sit in dynamic shared memory, 24
// bytes a row, so up to 9,664 rows an image. A row is written by its owner
// only; the one read by other threads is the picked row's box, which never
// changes after the first barrier. One pass a step kills what the last pick
// suppresses and finds each thread's best survivor on the way; a block
// reduction picks the next row. The reduction compares (score desc, index
// asc), a total order on distinct rows, so its result does not depend on
// the shape of the shuffle tree. Warp results are double-buffered, so a
// step takes one __syncthreads.
//
// Bound on an H100. The work is the IoU pass over the rows still live at
// each step that picks a row (~14 f32 operations a row) and the boxes and
// scores read once: at the bench geometry (8 images x 1000 rows, 100 slots)
// 10 MFLOP and 164 KB, under a microsecond at 67 TFLOP/s or 3.35 TB/s. What sets
// this kernel's time is its serial depth instead: max_out dependent steps,
// each a strided pass, a warp reduction, a barrier and a second warp
// reduction, on one SM per image (8 of 132). This version does nothing
// about that beyond one barrier a step; an R x R IoU bitmask built in
// parallel and then scanned, and selection within a warp, are later work
// (PERF.md).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
constexpr int kSmemBytes = 232448;        // the most one sm_90 block may use
constexpr int kScratchBytes = 2 * kWarps * (sizeof(float) + sizeof(int));
constexpr int kRowBytes = 6 * sizeof(float);

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
greedy_nms_kernel(const float* __restrict__ boxes,
                  const float* __restrict__ scores, float thresh,
                  int* __restrict__ idx_out, bool* __restrict__ valid_out,
                  int R, int M) {
  extern __shared__ float rows[];
  float* x1 = rows;
  float* y1 = x1 + R;
  float* x2 = y1 + R;
  float* y2 = x2 + R;
  float* area = y2 + R;
  float* live = area + R;
  __shared__ float s_v[2][kWarps];
  __shared__ int s_i[2][kWarps];

  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* bx = boxes + static_cast<size_t>(blockIdx.x) * R * 4;
  const float* sc = scores + static_cast<size_t>(blockIdx.x) * R;
  int* io = idx_out + static_cast<size_t>(blockIdx.x) * M;
  bool* vo = valid_out + static_cast<size_t>(blockIdx.x) * M;

  // rows ascend within a thread, so a strict > keeps the lowest index
  float v = kNeg;
  int vi = INT_MAX;
  for (int j = t; j < R; j += T) {
    const float a = bx[4 * j], b = bx[4 * j + 1];
    const float c = bx[4 * j + 2], d = bx[4 * j + 3];
    x1[j] = a;
    y1[j] = b;
    x2[j] = c;
    y2[j] = d;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(c, a), 0.0f),
                        fmaxf(__fsub_rn(d, b), 0.0f));
    const float s = sc[j];
    const float m = s > 0.5f * kNeg ? s : kNeg;
    live[j] = m;
    if (m > v) {
      v = m;
      vi = j;
    }
  }

  for (int i = 0; i < M; ++i) {
    warp_best(v, vi);
    const int buf = i & 1;
    if (lane == 0) {
      s_v[buf][warp] = v;
      s_i[buf][warp] = vi;
    }
    __syncthreads();
    v = lane < (T >> 5) ? s_v[buf][lane] : kNeg;
    vi = lane < (T >> 5) ? s_i[buf][lane] : INT_MAX;
    warp_best(v, vi);                        // every thread: the block's pick
    const int best = vi;
    if (!(v > kNeg)) {                       // nothing live: the block agrees
      for (int k = i + t; k < M; k += T) {
        io[k] = 0;
        vo[k] = false;
      }
      return;
    }
    if (t == 0) {
      io[i] = best;
      vo[i] = true;
    }
    const float bx1 = x1[best], by1 = y1[best];
    const float bx2 = x2[best], by2 = y2[best];
    const float barea = area[best];
    v = kNeg;
    vi = INT_MAX;
    for (int j = t; j < R; j += T) {
      const float m = live[j];
      if (!(m > kNeg)) continue;
      const float iw = fmaxf(
          __fsub_rn(fminf(x2[j], bx2), fmaxf(x1[j], bx1)), 0.0f);
      const float ih = fmaxf(
          __fsub_rn(fminf(y2[j], by2), fmaxf(y1[j], by1)), 0.0f);
      const float inter = __fmul_rn(iw, ih);
      const float uni = __fsub_rn(__fadd_rn(area[j], barea), inter);
      const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
      if (iou > thresh || j == best) {
        live[j] = kNeg;
      } else if (m > v) {
        v = m;
        vi = j;
      }
    }
  }
}

}  // namespace

extern "C" {

// boxes f32 [n, R, 4], scores f32 [n, R], idx int32 [n, M] and valid bool
// [n, M], all contiguous device arrays; one block per image. Returns a
// cudaError_t (0 on success).
int ekaid_nms(const void* boxes, const void* scores, float thresh, void* idx,
              void* valid, int n, int R, int M, void* stream) {
  if (n < 0 || R < 0 || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || M == 0) return 0;
  const size_t smem = static_cast<size_t>(kRowBytes) * R;
  if (smem + kScratchBytes > static_cast<size_t>(kSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  int threads = ((R + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_nms_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      thresh, static_cast<int*>(idx), static_cast<bool*>(valid), R, M);
  return static_cast<int>(cudaGetLastError());
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
