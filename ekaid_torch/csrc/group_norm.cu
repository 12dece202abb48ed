// GroupNorm over channels-last bf16 maps, with its ReLU and residual add
// fused, for Hopper (sm_90a): the K5 kernel.
//
// Replaces no Pallas kernel: the JAX package's ResNet trunks (the mode0
// PixelEncoder's R101, the detectors' R50-FPN) run flax nn.GroupNorm(32)
// under XLA, which fuses the normalisation into its neighbours. In the
// port the same layer ran as a chain of PyTorch operations: a cast to f32,
// a copy to NCHW, the moments, the affine, a cast back to bf16, a ReLU
// pass, a mixed-layout residual add and the next convolution's copy back
// to channels-last, some 40 bytes moved per element. This kernel reads
// the convolution's output once and writes the block's output once.
//
// Contract (ops/group_norm.py::group_norm_plain computes the same):
// x bf16 [N, P, C] (an NHWC map, P = H * W positions), G groups of
// Cg = C / G neighbouring channels. For image n and group g, over its
// P * Cg elements in f32: the mean and the biased variance var, and
// rstd = rsqrtf(var + eps). Channel c of group g then takes
//   a = gamma[c] * rstd,  b = fmaf(-a, mean, beta[c]),
//   y = bf16(fmaf(a, x, b))                     (rounded once)
// (PyTorch's CUDA group_norm computes its affine in this form), and the
// epilogue writes y (0), relu(y) (1) or relu(bf16(float(y) + float(r)))
// (2, r a bf16 residual [N, P, C]: the bf16 add of eager PyTorch, rounded
// once). gamma and beta are f32 or bf16 [C]. Output bf16 [N, P, C]. The
// statistics are Welford moments merged by Chan's formula, never
// E[x^2] - E[x]^2; only their order of summation differs from PyTorch's.
//
// Bound on an H100: bytes. The trunk's maps are read once and written
// once (plus the residual for epilogue 2): at mode0's B = 64 two R101
// trunks at 128^2 move 3.46 GB a batch, ~1.0 ms at 3.35 TB/s.
//
// Design:
// - A cluster of S blocks (S <= 8, portable) shares one image's channel
//   block: the wrapper splits each image into `blocks` channel blocks
//   (whole groups, rows of >= 32 bytes) and `split` position chunks, one
//   chunk a block, chosen from N, P and C (ops/group_norm.py::plan) so
//   that batch 1 still puts some dozens of blocks on the card.
// - Each thread owns one 16-byte vector column (8 channels) of the block
//   and walks the rows; so its channels, and their affine, never change.
//   A vector holds part of one group (Cg >= 8) or 8 / Cg whole groups.
// - Cached: when the block's chunk fits in shared memory (the wrapper's
//   budget), the whole chunk is fetched by cp.async at once, every load
//   in flight, and both passes read it from there: one read from HBM.
//   Streaming (a map of tens of MB an image, as extraction's 1024^2
//   R50-FPN has): the second pass reads it again, 4 rows in flight.
// - Statistics: per thread, the moments of each vector's slice of a group
//   (a two-pass mean and M2 over <= 8 values in registers) merged into a
//   running (n, mean, M2); per block, each group's partials merged by one
//   warp in a fixed order; per cluster, each block reads the others'
//   partials through distributed shared memory and merges them in rank
//   order, so every block of an image computes the same bits, and two
//   calls give the same bits.
// - The epilogue reads the residual with 16-byte loads in the same order
//   and writes 16-byte vectors; the output is channels-last, so the next
//   convolution's layout copy is a no-op.
// Launches on the caller's stream, allocates nothing, synchronises
// nothing: CUDA-graph capture records it as one kernel node.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxGroups = 32;
constexpr int kMaxSplit = 8;          // blocks of a cluster (portable size)
constexpr int kThreads = 256;         // most threads a block
constexpr int kMaxSmem = 128 * 1024;  // dynamic shared memory of a block
constexpr int kMaxDevices = 64;       // devices whose limits are raised

struct Args {
  const uint4* x;
  const uint4* res;  // epilogue 2 only
  uint4* y;
  const void* gamma;
  const void* beta;
  int affine_bf16;
  int epilogue;
  int P, C, G;
  int blocks;  // channel blocks an image
  int split;   // position chunks an image (the cluster's size)
  int chunk;   // positions a chunk
  float eps;
};

struct Moments {
  float n, mean, m2;
};

// Chan's merge of b into a
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  a.mean += delta * wb;
  a.m2 += b.m2 + delta * delta * a.n * wb;
  a.n = n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// torch.relu: NaN stays NaN, -0.0 becomes 0.0
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// the moments of each group slice of one vector, merged into acc
template <int kGpv>
__device__ __forceinline__ void accumulate(const uint4& v,
                                           Moments (&acc)[kGpv]) {
  constexpr int kPer = 8 / kGpv;  // elements of a slice
  float f[8];
  unpack(v, f);
#pragma unroll
  for (int j = 0; j < kGpv; ++j) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) s += f[j * kPer + e];
    const float m = s * (1.f / kPer);
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float d = f[j * kPer + e] - m;
      q = fmaf(d, d, q);
    }
    merge(acc[j], Moments{static_cast<float>(kPer), m, q});
  }
}

__device__ __forceinline__ float param(const void* p, int affine_bf16,
                                       int c) {
  return affine_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
             : static_cast<const float*>(p)[c];
}

// Grid: N * blocks * split blocks; block ((n * blocks) + cb) * split + s
// takes image n, channel block cb, positions [s * chunk, (s + 1) * chunk)
// of P; a cluster is the `split` blocks of one (n, cb). Dynamic shared
// memory: the chunk's vectors (cached only), then each thread's kGpv
// partial moments.
template <int kGpv, bool kCached>
__global__ void __launch_bounds__(kThreads) group_norm_kernel(Args a) {
  extern __shared__ uint4 tile[];
  __shared__ float4 part[kMaxGroups];  // this block's (n, mean, M2)
  __shared__ float2 stat[kMaxGroups];  // the image's (mean, rstd)
  cg::cluster_group cluster = cg::this_cluster();
  const int s = static_cast<int>(cluster.block_rank());
  const int cb = (blockIdx.x / a.split) % a.blocks;
  const int n = blockIdx.x / (a.split * a.blocks);
  const int width = a.C / a.blocks;  // channels of the block
  const int vpr = width / 8;         // vectors of a row
  const int cpg = a.C / a.G;         // channels of a group
  const int gb = a.G / a.blocks;     // groups of the block
  const int t = threadIdx.x;
  const int col = t % vpr;
  const int r0 = t / vpr;
  const int rstep = blockDim.x / vpr;
  const int p0 = s * a.chunk;
  const int rows = max(0, min(a.P - p0, a.chunk));
  // row r's vector of this thread is at x[base + r * pstride]
  const size_t pstride = static_cast<size_t>(a.C / 8);
  const size_t base = (static_cast<size_t>(n) * a.P + p0) * pstride +
                      static_cast<size_t>(cb) * vpr + col;
  Moments* red = reinterpret_cast<Moments*>(
      tile + (kCached ? static_cast<size_t>(a.chunk) * vpr : 0));

  // ---- pass 1: moments --------------------------------------------------
  Moments acc[kGpv];
#pragma unroll
  for (int j = 0; j < kGpv; ++j) acc[j] = Moments{0.f, 0.f, 0.f};
  if constexpr (kCached) {
    for (int r = r0; r < rows; r += rstep)
      cp_async16(tile + r * vpr + col, a.x + base + r * pstride);
    if (a.epilogue == 2)  // the residual on its way to L2 meanwhile
      for (int r = r0; r < rows; r += rstep)
        prefetch_l2(a.res + base + static_cast<size_t>(r) * pstride);
    cp_async_wait_all();  // a thread reads back only what it fetched
    for (int r = r0; r < rows; r += rstep)
      accumulate<kGpv>(tile[r * vpr + col], acc);
  } else {
    int r = r0;
    for (; r + 3 * rstep < rows; r += 4 * rstep) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldg(a.x + base + static_cast<size_t>(r + u * rstep) * pstride);
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<kGpv>(v[u], acc);
    }
    for (; r < rows; r += rstep)
      accumulate<kGpv>(__ldg(a.x + base + static_cast<size_t>(r) * pstride),
                       acc);
  }
#pragma unroll
  for (int j = 0; j < kGpv; ++j) red[t * kGpv + j] = acc[j];
  // this thread's channels' affine, read while the statistics merge
  float gam[8], bet[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = cb * width + col * 8 + e;
    gam[e] = param(a.gamma, a.affine_bf16, c);
    bet[e] = param(a.beta, a.affine_bf16, c);
  }
  __syncthreads();

  // a warp merges each group's partials: the threads of its columns (a
  // group spans `per` columns, or shares one column with others at slot
  // g % kGpv), every row, in a fixed order
  const int per = cpg >= 8 ? cpg / 8 : 1;
  const int items = rstep * per;
  const int lane = t % 32;
  for (int g = t / 32; g < gb; g += blockDim.x / 32) {
    const int c0 = kGpv > 1 ? g / kGpv : g * per;
    const int slot = kGpv > 1 ? g % kGpv : 0;
    Moments m{0.f, 0.f, 0.f};
    for (int i = lane; i < items; i += 32)
      merge(m, red[((i / per) * vpr + c0 + i % per) * kGpv + slot]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Moments o{__shfl_down_sync(0xffffffffu, m.n, off),
                      __shfl_down_sync(0xffffffffu, m.mean, off),
                      __shfl_down_sync(0xffffffffu, m.m2, off)};
      if (lane + off < 32) merge(m, o);
    }
    if (lane == 0) part[g] = make_float4(m.n, m.mean, m.m2, 0.f);
  }
  cluster.sync();  // every block's partials are in

  // every block of the cluster merges the same partials in rank order
  if (t < gb) {
    float4 v[kMaxSplit];  // every load in flight before the merges
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < a.split) v[q] = *cluster.map_shared_rank(&part[t], q);
    Moments m{0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < kMaxSplit; ++q)
      if (q < a.split) merge(m, Moments{v[q].x, v[q].y, v[q].z});
    const float var = fmaxf(m.m2 / m.n, 0.f);
    stat[t] = make_float2(m.mean, rsqrtf(var + a.eps));
  }
  cluster.sync();  // the partials are read (a block may leave); stat is in

  // ---- pass 2: the affine and the epilogue -----------------------------
  float sc[8], sh[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 st = stat[(col * 8 + e) / cpg];
    sc[e] = gam[e] * st.y;
    sh[e] = fmaf(-sc[e], st.x, bet[e]);
  }
  const int epi = a.epilogue;
  auto finish = [&](const uint4& v, const uint4& q) {
    float f[8];
    unpack(v, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = round_bf16(fmaf(sc[e], f[e], sh[e]));
    if (epi == 2) {
      float g[8];
      unpack(q, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = relu(round_bf16(f[e] + g[e]));
    } else if (epi == 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = relu(f[e]);
    }
    return pack(f);
  };
  auto load = [&](int r) {
    if constexpr (kCached) return tile[r * vpr + col];
    else return __ldg(a.x + base + static_cast<size_t>(r) * pstride);
  };
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  int r = r0;
  for (; r + 3 * rstep < rows; r += 4 * rstep) {
    uint4 v[4], q[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = load(r + u * rstep);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      q[u] = epi == 2 ? __ldg(a.res + base +
                              static_cast<size_t>(r + u * rstep) * pstride)
                      : zero;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      a.y[base + static_cast<size_t>(r + u * rstep) * pstride] =
          finish(v[u], q[u]);
  }
  for (; r < rows; r += rstep) {
    const size_t i = base + static_cast<size_t>(r) * pstride;
    a.y[i] = finish(load(r), epi == 2 ? __ldg(a.res + i) : zero);
  }
}

// the dynamic shared memory limit of each instance, raised once a device
std::atomic<unsigned> g_raised[kMaxDevices];

template <int kGpv, bool kCached>
cudaError_t launch(const Args& a, int n, int threads, size_t smem,
                   cudaStream_t st) {
  auto* kern = group_norm_kernel<kGpv, kCached>;
  constexpr unsigned bit = 1u << (2 * (kGpv == 1 ? 0 : kGpv == 2 ? 1
                                                   : kGpv == 4 ? 2 : 3) +
                                  (kCached ? 1 : 0));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices || !(g_raised[dev].load() & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
    if (e != cudaSuccess) return e;
    if (dev < kMaxDevices) g_raised[dev].fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * a.blocks * a.split));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int kGpv>
cudaError_t launch_gpv(const Args& a, int n, int threads, size_t smem,
                       int cached, cudaStream_t st) {
  return cached ? launch<kGpv, true>(a, n, threads, smem, st)
                : launch<kGpv, false>(a, n, threads, smem, st);
}

}  // namespace

extern "C" {

// x, residual (epilogue 2, else null) and y: bf16 [N, P, C] device arrays
// on 16-byte boundaries; gamma, beta: [C], f32 (affine_bf16 0) or bf16 (1);
// groups G; the plan of ops/group_norm.py::plan: `blocks` channel blocks
// and `split` position chunks an image, `threads` a block, `cached` 1 to
// hold each chunk in shared memory. Launches on `stream`; returns a
// cudaError_t (0 on success): cudaErrorInvalidValue for arguments the
// kernel does not take.
int ekaid_group_norm(const void* x, const void* residual, void* y,
                     const void* gamma, const void* beta, int affine_bf16,
                     int epilogue, int N, int P, int C, int G, int blocks,
                     int split, int threads, int cached, float eps,
                     void* stream) {
  const cudaError_t bad = cudaErrorInvalidValue;
  if (N < 0 || P < 0 || C <= 0 || G <= 0 || G > kMaxGroups || C % G ||
      C % 8 || blocks <= 0 || G % blocks || (C / blocks) % 8 || split < 1 ||
      split > kMaxSplit || epilogue < 0 || epilogue > 2 ||
      (epilogue == 2) != (residual != nullptr))
    return static_cast<int>(bad);
  if (N == 0 || P == 0) return 0;
  const int cpg = C / G;
  if (cpg < 8 ? 8 % cpg : cpg % 8) return static_cast<int>(bad);
  const int gpv = cpg < 8 ? 8 / cpg : 1;
  const int vpr = C / blocks / 8;
  if (threads <= 0 || threads > kThreads || threads % 32 || threads % vpr)
    return static_cast<int>(bad);
  if (static_cast<long long>(N) * blocks * split > 0x7fffffffLL)
    return static_cast<int>(bad);
  Args a{static_cast<const uint4*>(x),  static_cast<const uint4*>(residual),
         static_cast<uint4*>(y),        gamma,
         beta,                          affine_bf16,
         epilogue,                      P,
         C,                             G,
         blocks,                        split,
         (P + split - 1) / split,       eps};
  const size_t smem =
      (cached ? static_cast<size_t>(a.chunk) * vpr * sizeof(uint4) : 0) +
      static_cast<size_t>(threads) * gpv * sizeof(Moments);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(bad);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (gpv) {
    case 1: e = launch_gpv<1>(a, N, threads, smem, cached, st); break;
    case 2: e = launch_gpv<2>(a, N, threads, smem, cached, st); break;
    case 4: e = launch_gpv<4>(a, N, threads, smem, cached, st); break;
    default: e = launch_gpv<8>(a, N, threads, smem, cached, st); break;
  }
  return static_cast<int>(e);
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
