// Greedy NMS for Hopper (sm_90a): the K4 kernels.
//
// Replaces ekaid_tpu/ops/pallas_nms.py::_nms_kernel, which nms_pallas runs
// for one image and callers vmap over a batch. Here one call of ekaid_nms
// serves the batch with two kernels on the caller's stream.
//
// Contract (each image, rows j < R): row j is live iff score[j] > NEG / 2
// (NEG = -1e9), so a NaN score is dead. For slot i = 0 .. max_out - 1: take
// the live row with the largest score, the lowest index among equal scores
// (-0.0 and 0.0 are equal). If none is live, every remaining slot is
// (0, false). Otherwise write (best, true) and kill best and every row j
// with iou(best, j) > thresh, where
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   iw/ih = max(min(x2_j, x2_b) - max(x1_j, x1_b), 0), the same in y
//   union = (area_j + area_b) - iw * ih
//   iou   = union > 0 ? iw * ih / union : 0.
// Every rounding is explicit (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn):
// nvcc contracts nothing into an FMA, so a box near the threshold goes the
// same way as in the plain versions (ops/nms_kernel.py) and the selections
// are bit-equal.
//
// Design. Greedy NMS is a walk in (score desc, index asc) order in which a
// row is kept iff no kept row before it suppresses it. So:
// 1. nms_order_kernel sorts each image's rows with a cluster of 8 blocks:
//    each block sorts an eighth of the (score, index) keys, compared as
//    floats (dead rows carry -inf and sort last, by index; -0.0 == 0.0), by
//    a bitonic network in registers, warp shuffles and, for strides across
//    warps, shared memory; it copies the other seven sorted runs out of
//    their blocks' shared memory in one round, and a row's place is its
//    place in its own run plus its count in each other run (a binary
//    search). It writes the sorted indices, the sorted boxes and L, the
//    number of live rows.
// 2. nms_select_kernel, one cooperative launch, builds the suppression mask
//    and scans it at once. Producer blocks (64 threads) take tiles of 64
//    sorted rows x 64 sorted columns on or right of the diagonal from a
//    queue in column-chunk order, all images over the whole card: thread k
//    builds word c of row k, bit b set iff column l = 64 c + b > k, l < L
//    and iou(sorted[k], sorted[l]) > thresh (a branch-free pass finds the
//    columns whose intersection is not 0; where it is 0 the IoU is 0
//    without the division, still compared with thresh). A counter per
//    (image, column chunk) says when its column is whole, a bitmap which of
//    its row tiles hold a word other than 0. One warp per image walks the
//    sorted rows in chunks of 64 as their columns become whole: the chunk's
//    removed word is the OR of word c of the rows kept so far (read only
//    from the tiles the bitmap names); its candidates are resolved in order
//    in registers from their diagonal words, visiting only those whose word
//    suppresses something; the next chunk's words are in flight meanwhile.
//    The walk stops after max_out picks or L rows, and the producers then
//    leave the rest of the mask unbuilt. Only words at or right of the
//    diagonal of rows < L are ever read. With full_mask the producers build
//    the whole upper triangle (the debug output).
//
// Bound on an H100. The function's least work is the IoU pass over the rows
// live at each pick and the boxes and scores read once (well under a
// microsecond at both geometries). This design does other work for less
// depth: the sort's passes on eight SMs an image, the mask tiles of the
// columns the walk reaches, built ahead of it over every SM, and one chunk
// step per 64 rows walked instead of an IoU pass and a barrier per pick.
// What is left to set its time is serial: the two launches, the sort's
// network and searches, the first column's tile, and the scan's chunk steps
// (a resolve, a warp reduction and the wait for the next chunk's words
// from L2). So the select grid is small (at most 4 x SMs blocks, so that
// the producers leave issue slots and L2 to the scans), the scan's loads
// are issued a chunk ahead, and its gather skips tiles that hold only
// zeros. A scan waits only on tiles that some producer has taken or will
// take: the producers pull from the queue until every scan has ended or
// the list is done, and the cooperative launch keeps every block resident.
// The scratch comes from the wrapper (nms_kernel.py::scratch_bytes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr float kNeg = -1e9f;
constexpr int kParts = 8;          // blocks (a cluster) sorting one image
constexpr int kMaxPart = 2048;     // keys a block sorts: 2 a thread
constexpr int kMaxRows = kParts * kMaxPart;
constexpr int kTile = 64;          // sorted rows or columns a mask word covers
constexpr int kNzWords = kMaxRows / kTile / 64;   // row tiles / 64
constexpr int kBlocksPerSm = 4;    // select blocks an SM at most
constexpr int kMaxDevices = 64;    // devices select_capacity caches
constexpr unsigned kFull = 0xffffffffu;

struct __align__(8) Key {
  float s;                         // the score, -inf for a dead row
  int i;                           // the row; >= R for padding
};

// Scratch, one buffer from the wrapper, each part on a 16-byte boundary:
//   mask   u64    [n, W, R]   word c of every sorted row, c < W = ceil(R / 64)
//   sboxes float4 [n, R]      boxes in sorted order (rows < L)
//   order  int    [n, R]      original index of each sorted row
//   stats  int    [n, 4]      L, rows walked, chunks walked, picks
//   done   int    [n, W]      row tiles built in each column chunk
//   nz     u64    [n, W, 4]   the row tiles holding a word other than 0 in
//                             each column chunk, one bit each
//   queue  u64    [1]         the next tile of the select kernel's list
//   flags  int    [n + 1]     the scan of each image has ended; scans ended
// nms_kernel.py::scratch_bytes computes the same sizes.
struct Scratch {
  u64* mask;
  float4* sboxes;
  int* order;
  int* stats;
  int* done;
  u64* nz;
  u64* queue;
  int* stop;
  int* finished;
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ __forceinline__ int words_per_row(int R) {
  return (R + kTile - 1) / kTile;
}

Scratch carve(void* base, int n, int R) {
  char* p = static_cast<char*>(base);
  const size_t nr = static_cast<size_t>(n) * R;
  const size_t W = static_cast<size_t>(words_per_row(R));
  Scratch s;
  s.mask = reinterpret_cast<u64*>(p);
  p += align16(nr * W * sizeof(u64));
  s.sboxes = reinterpret_cast<float4*>(p);
  p += align16(nr * sizeof(float4));
  s.order = reinterpret_cast<int*>(p);
  p += align16(nr * sizeof(int));
  s.stats = reinterpret_cast<int*>(p);
  p += align16(static_cast<size_t>(n) * 4 * sizeof(int));
  s.done = reinterpret_cast<int*>(p);
  p += align16(static_cast<size_t>(n) * W * sizeof(int));
  s.nz = reinterpret_cast<u64*>(p);
  p += align16(static_cast<size_t>(n) * W * kNzWords * sizeof(u64));
  s.queue = reinterpret_cast<u64*>(p);
  p += align16(sizeof(u64));
  s.stop = reinterpret_cast<int*>(p);
  s.finished = s.stop + n;
  return s;
}

// (score desc, index asc): a total order on keys with distinct indices
__device__ __forceinline__ bool before(Key a, Key b) {
  return a.s > b.s || (a.s == b.s && a.i < b.i);
}

// the element a place keeps of the pair (mine, theirs): the first in order
// if `first`, else the second
__device__ __forceinline__ Key keep_of(Key mine, Key theirs, bool first) {
  return before(mine, theirs) == first ? mine : theirs;
}

__device__ __forceinline__ Key shfl_xor(Key v, int m) {
  return {__shfl_xor_sync(kFull, v.s, m), __shfl_xor_sync(kFull, v.i, m)};
}

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.0f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.0f));
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  for (int off = 16; off > 0; off >>= 1) v |= __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *static_cast<const volatile int*>(p);
}

// a load that orders the loads after it behind the writes released before
// the value it reads
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// ---- 1. order ---------------------------------------------------------
// Grid: kParts blocks an image, one cluster; block `part` sorts places
// part * Pt .. part * Pt + Pt - 1 (Pt a power of two, 64 .. 2048, so a
// whole warp of key pairs at least) with Pt / 2 threads, thread t holding
// places 2t and 2t + 1. Dynamic shared
// memory: kParts runs of Pt keys (the first two double-buffer the sort;
// run `part` is this block's, the others copies).
template <int Pt>
__global__ void __cluster_dims__(kParts, 1, 1) __launch_bounds__(Pt / 2)
nms_order_kernel(const float* __restrict__ boxes,
                 const float* __restrict__ scores, int R, Scratch s) {
  extern __shared__ float4 smem[];
  Key* buf = reinterpret_cast<Key*>(smem);   // [kParts][Pt]
  __shared__ int s_live;
  cg::cluster_group cluster = cg::this_cluster();
  const int part = static_cast<int>(cluster.block_rank());
  const int img = blockIdx.x / kParts;
  const int t = threadIdx.x;
  const int W = words_per_row(R);

  // the select kernel's counters start at 0
  for (int c = part * blockDim.x + t; c < W; c += kParts * blockDim.x) {
    s.done[static_cast<size_t>(img) * W + c] = 0;
#pragma unroll
    for (int q = 0; q < kNzWords; ++q)
      s.nz[(static_cast<size_t>(img) * W + c) * kNzWords + q] = 0;
  }
  if (part == 0 && t == 0) s.stop[img] = 0;
  if (img == 0 && part == 0 && t == 0) {
    *s.finished = 0;
    *s.queue = 0;
  }
  if (t == 0) s_live = 0;

  const float* sc = scores + static_cast<size_t>(img) * R;
  const int e0 = 2 * t;            // my places within the part
  Key v[2];
  int live = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = part * Pt + e0 + r;
    float key = -INFINITY;
    if (j < R) {
      const float x = sc[j];
      if (x > 0.5f * kNeg) {
        key = x;
        ++live;
      }
    }
    v[r] = {key, j};
  }
  __syncthreads();                 // s_live is 0
  live = __reduce_add_sync(kFull, live);
  if ((t & 31) == 0) atomicAdd(&s_live, live);

  // bitonic network over Pt places; a run of length k ascends (in
  // `before` order) iff bit k of its places is clear
  int flip = 0;
#pragma unroll
  for (int k = 2; k <= Pt; k <<= 1) {
    const bool up = (e0 & k) == 0;
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {                // both places are mine
        if (before(v[1], v[0]) == up) {
          const Key x = v[0];
          v[0] = v[1];
          v[1] = x;
        }
        continue;
      }
      const bool first = ((e0 & j) == 0) == up;
      Key o[2];
      if (j < 64) {                // the partner is lane ^ (j / 2)
        o[0] = shfl_xor(v[0], j >> 1);
        o[1] = shfl_xor(v[1], j >> 1);
      } else {                     // across warps: through shared memory
        Key* b = buf + flip * Pt;
        flip ^= 1;
        b[e0] = v[0];
        b[e0 + 1] = v[1];
        __syncthreads();
        o[0] = b[e0 ^ j];
        o[1] = b[(e0 + 1) ^ j];
      }
      v[0] = keep_of(v[0], o[0], first);
      v[1] = keep_of(v[1], o[1], first);
    }
  }
  __syncthreads();                 // nobody reads either buffer any more
  Key* run = buf + part * Pt;      // my sorted run, read by the others
  run[e0] = v[0];
  run[e0 + 1] = v[1];
  cluster.sync();                  // every part sorted, every count in

  // the other parts' runs into my shared memory, in one round of
  // independent 16-byte loads
  int L = 0;
  for (int o = 0; o < kParts; ++o) L += *cluster.map_shared_rank(&s_live, o);
#pragma unroll
  for (int o = 0; o < kParts; ++o) {
    if (o == part) continue;
    const float4* from =
        reinterpret_cast<const float4*>(cluster.map_shared_rank(buf, o) +
                                        o * Pt);
    reinterpret_cast<float4*>(buf + o * Pt)[t] = from[t];
  }
  cluster.sync();                  // copies made: a block may leave

  // a key's place: its place in its own run plus the keys before it in
  // each other run, each count a branchless binary search, the runs
  // interleaved
  int pos[2][kParts];
#pragma unroll
  for (int o = 0; o < kParts; ++o) pos[0][o] = pos[1][o] = 0;
#pragma unroll
  for (int step = Pt >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int o = 0; o < kParts; ++o) {
      if (o == part) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (before(buf[o * Pt + pos[r][o] + step - 1], v[r]))
          pos[r][o] += step;
    }
  }
  const size_t row0 = static_cast<size_t>(img) * R;
  const float* bx = boxes + row0 * 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int rank = e0 + r;
#pragma unroll
    for (int o = 0; o < kParts; ++o)
      if (o != part)
        rank += pos[r][o] + (before(buf[o * Pt + pos[r][o]], v[r]) ? 1 : 0);
    const int i = v[r].i;
    if (i < R) {                   // padding sorts after every row
      s.order[row0 + rank] = i;
      if (rank < L)
        s.sboxes[row0 + rank] = make_float4(bx[4 * i], bx[4 * i + 1],
                                            bx[4 * i + 2], bx[4 * i + 3]);
    }
  }
  if (part == 0 && t == 0) s.stats[4 * img] = L;
}

// ---- 2. select: the mask and the scan -----------------------------------
// Tile pair p of an image, column-major over the upper triangle:
// p = cb (cb + 1) / 2 + rb, rb <= cb.
__device__ __forceinline__ void tile_of(int p, int& rb, int& cb) {
  cb = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (cb * (cb + 1) / 2 > p) --cb;
  while ((cb + 1) * (cb + 2) / 2 <= p) ++cb;
  rb = p - cb * (cb + 1) / 2;
}

// One tile of the mask, by a 64-thread block: word cb of sorted rows
// 64 rb .. 64 rb + 63, and its bit in nz. A branch-free pass finds the
// columns whose intersection is not 0; only those take the union and the
// division. Returns false, the tile left unbuilt, if `stop` (null for the
// whole mask) says the image's walk has ended by then.
__device__ bool build_tile(const Scratch& s, int img, int R, int L, int rb,
                           int cb, float thresh, const int* stop,
                           float4* cbox, float* carea) {
  const int t = threadIdx.x;
  const size_t row0 = static_cast<size_t>(img) * R;
  const int l = cb * kTile + t;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 c = l < L ? s.sboxes[row0 + l] : zero;
  cbox[t] = c;
  carea[t] = box_area(c);
  __syncthreads();
  const int k = rb * kTile + t;
  const float4 bk = k < L ? s.sboxes[row0 + k] : zero;
  u64 meet = 0;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    const float4 b = cbox[j];
    const float iw = fmaxf(__fsub_rn(fminf(b.z, bk.z), fmaxf(b.x, bk.x)),
                           0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(b.w, bk.w), fmaxf(b.y, bk.y)),
                           0.0f);
    if (__fmul_rn(iw, ih) != 0.0f) meet |= 1ull << j;
  }
  // only columns above k and below L count
  const int lo = rb == cb ? t + 1 : 0;
  const int hi = min(kTile, L - cb * kTile);
  const u64 cols = (hi == kTile ? ~0ull : (1ull << hi) - 1) &
                   (lo == kTile ? 0ull : ~0ull << lo);
  u64 word = 0.0f > thresh ? ~meet : 0ull;   // iou 0 against thresh
  if (__syncthreads_or(stop != nullptr && t == 0 && load_volatile(stop)))
    return false;                            // uniform over the block
  const float ak = box_area(bk);
  for (u64 rest = meet & cols; rest; rest &= rest - 1) {
    const int j = __ffsll(static_cast<long long>(rest)) - 1;
    const float4 b = cbox[j];
    const float iw = fmaxf(__fsub_rn(fminf(b.z, bk.z), fmaxf(b.x, bk.x)),
                           0.0f);
    const float ih = fmaxf(__fsub_rn(fminf(b.w, bk.w), fmaxf(b.y, bk.y)),
                           0.0f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(carea[j], ak), inter);
    const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
    if (iou > thresh) word |= 1ull << j;
  }
  word = k < L ? word & cols : 0ull;
  if (k < L)
    s.mask[(static_cast<size_t>(img) * words_per_row(R) + cb) * R + k] = word;
  if (__syncthreads_or(word != 0ull) && t == 0)
    atomicOr(s.nz + (static_cast<size_t>(img) * words_per_row(R) + cb) *
                        kNzWords + rb / 64,
             1ull << (rb % 64));
  return true;
}

// Column chunks c .. c + 31 of an image whose c + 1 .. row tiles are all
// built: the count of them from c on without a gap (lane l polls chunk
// c + l; the loads after it see the tiles' words).
__device__ __forceinline__ int whole_columns(const int* done, int c, int W) {
  const int l = c + threadIdx.x;
  const unsigned ready =
      __ballot_sync(kFull, l < W && load_acquire(done + l) >= l + 1);
  __syncwarp();
  return __ffs(~ready) ? __ffs(~ready) - 1 : 32;
}

// One image's walk, by one warp; keeps[c] holds chunk c's picks. The
// words chunk c + 1 needs are loaded (through L2: the producers wrote them
// during this launch) before chunk c is resolved: chunk c + 1's diagonal
// words and original indices, word c + 1 of chunk c's 64 rows (masked by
// its picks once resolved), and which earlier chunks' tiles in column
// c + 1 hold a word other than 0; after the resolve, word c + 1 of the
// rows kept in those chunks. The column counters are polled 32 chunks at
// a time.
__device__ void scan_image(const Scratch& s, int img, int R, int M,
                           int* __restrict__ idx_out,
                           bool* __restrict__ valid_out, u64* keeps) {
  const int lane = threadIdx.x;
  const int W = words_per_row(R);
  const int* order = s.order + static_cast<size_t>(img) * R;
  const int* done = s.done + static_cast<size_t>(img) * W;
  const u64* mask = s.mask + static_cast<size_t>(img) * W * R;
  int* io = idx_out + static_cast<size_t>(img) * M;
  bool* vo = valid_out + static_cast<size_t>(img) * M;
  const int L = s.stats[4 * img];

  int picks = 0, walked = 0, chunks = 0;
  int whole = 0;                   // chunks [0, whole) have whole columns
  // chunk c's diagonal words, original indices and removed word
  u64 d0 = 0, d1 = 0, rem = 0;
  int o0 = 0, o1 = 0;
  if (L > 0) {
    while (whole < 1) {
      whole += whole_columns(done, whole, W);
      if (whole < 1) __nanosleep(32);
    }
    d0 = lane < L ? __ldcg(mask + lane) : 0ull;
    d1 = lane + 32 < L ? __ldcg(mask + lane + 32) : 0ull;
    o0 = lane < L ? order[lane] : 0;
    o1 = lane + 32 < L ? order[lane + 32] : 0;
  }
  for (int c = 0; c * kTile < L && picks < M; ++c) {
    ++chunks;
    const int base = c * kTile;
    const int nc = min(kTile, L - base);
    // chunk c + 1's words, in flight during the resolve
    const int next = base + kTile;
    u64 nd0 = 0, nd1 = 0, n0 = 0, n1 = 0, g = 0;
    u64 nzw[kNzWords] = {};
    int no0 = 0, no1 = 0;
    if (next < L) {
      while (whole < c + 2) {
        whole += whole_columns(done, whole, W);
        if (whole < c + 2) __nanosleep(32);
      }
      const u64* col = mask + static_cast<size_t>(c + 1) * R;
      nd0 = next + lane < L ? __ldcg(col + next + lane) : 0ull;
      nd1 = next + lane + 32 < L ? __ldcg(col + next + lane + 32) : 0ull;
      no0 = next + lane < L ? order[next + lane] : 0;
      no1 = next + lane + 32 < L ? order[next + lane + 32] : 0;
      n0 = base + lane < L ? __ldcg(col + base + lane) : 0ull;
      n1 = base + lane + 32 < L ? __ldcg(col + base + lane + 32) : 0ull;
      // the earlier chunks whose tile in column c + 1 holds a word other
      // than 0 (gathered after the resolve)
      const u64* nzc =
          s.nz + (static_cast<size_t>(img) * W + c + 1) * kNzWords;
#pragma unroll
      for (int q = 0; q < kNzWords; ++q)
        if (q * 64 < c) {
          nzw[q] = __ldcg(nzc + q);
          if (c - q * 64 < 64) nzw[q] &= (1ull << (c - q * 64)) - 1;
        }
    }
    if (nc < kTile) rem |= ~0ull << nc;      // places past L are not rows

    // resolve in order: a candidate is kept iff its bit is clear when its
    // turn comes; only candidates whose word suppresses something change
    // rem, and a bit of rem is final once the walk has passed it
    u64 active = static_cast<u64>(__ballot_sync(kFull, d0 != 0ull)) |
                 (static_cast<u64>(__ballot_sync(kFull, d1 != 0ull)) << 32);
    active &= ~rem;
    while (active) {
      const int i = __ffsll(static_cast<long long>(active)) - 1;
      rem |= __shfl_sync(kFull, i < 32 ? d0 : d1, i & 31);
      active &= ~rem & ~((2ull << i) - 1);
    }
    u64 keep = ~rem;
    int nk = __popcll(keep);
    if (picks + nk >= M) {
      while (nk > M - picks) {
        keep &= ~(1ull << (63 - __clzll(static_cast<long long>(keep))));
        --nk;
      }
      walked = base + 64 - __clzll(static_cast<long long>(keep));
    } else {
      walked = base + nc;
    }
    const bool k0 = (keep >> lane) & 1ull;
    const bool k1 = (keep >> (lane + 32)) & 1ull;
    const int below = __popcll(keep & ((1ull << lane) - 1));
    if (k0) {
      io[picks + below] = o0;
      vo[picks + below] = true;
    }
    if (k1) {
      const int slot = picks + __popcll(keep & ((1ull << (lane + 32)) - 1));
      io[slot] = o1;
      vo[slot] = true;
    }
    if (lane == 0) keeps[c] = keep;
    picks += nk;
    // chunk c + 1's removed word: the rows kept so far, word c + 1
    if (k0) g |= n0;
    if (k1) g |= n1;
    const u64* col = mask + static_cast<size_t>(c + 1) * R;
#pragma unroll
    for (int q = 0; q < kNzWords; ++q) {
      for (u64 tiles = nzw[q]; tiles; tiles &= tiles - 1) {
        const int c2 = q * 64 + __ffsll(static_cast<long long>(tiles)) - 1;
        const u64 kw = keeps[c2];
        if ((kw >> lane) & 1ull) g |= __ldcg(col + c2 * kTile + lane);
        if ((kw >> (lane + 32)) & 1ull)
          g |= __ldcg(col + c2 * kTile + lane + 32);
      }
    }
    rem = warp_or(g);
    d0 = nd0;
    d1 = nd1;
    o0 = no0;
    o1 = no1;
    __syncwarp();
  }
  for (int j = picks + lane; j < M; j += 32) {
    io[j] = 0;
    vo[j] = false;
  }
  if (lane == 0) {
    s.stats[4 * img + 1] = walked;
    s.stats[4 * img + 2] = chunks;
    s.stats[4 * img + 3] = picks;
    *static_cast<volatile int*>(s.stop + img) = 1;
    atomicAdd(s.finished, 1);
  }
}

// Blocks 0 .. consumers - 1 scan (warp 0; image b, b + consumers, ...);
// the rest take (tile pair, image) items from a queue in tile-pair order
// and build them, skipping images whose scan has ended, until every scan
// has ended (with full_mask: until the list is done).
__global__ void __launch_bounds__(kTile)
nms_select_kernel(Scratch s, int n, int R, int M, float thresh,
                  int consumers, int full_mask,
                  int* __restrict__ idx_out, bool* __restrict__ valid_out) {
  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  __shared__ u64 keeps[kMaxRows / kTile];
  __shared__ int task[4];
  const int b = blockIdx.x;
  if (b < consumers) {
    if (threadIdx.x >= 32) return;
    for (int img = b; img < n; img += consumers)
      scan_image(s, img, R, M, idx_out, valid_out, keeps);
    return;
  }
  const int W = words_per_row(R);
  const u64 total = static_cast<u64>(W) * (W + 1) / 2 * n;
  for (;;) {
    __syncthreads();                         // task[] is read
    if (threadIdx.x == 0) {
      int img = -1, rb = 0, cb = 0, L = 0;
      while (full_mask || load_volatile(s.finished) < n) {
        const u64 item = atomicAdd(s.queue, 1ull);
        if (item >= total) break;
        const int i = static_cast<int>(item % n);
        int r_, c_;
        tile_of(static_cast<int>(item / n), r_, c_);
        const int Li = s.stats[4 * i];
        if (c_ * kTile >= Li || (!full_mask && load_volatile(s.stop + i)))
          continue;
        img = i;
        rb = r_;
        cb = c_;
        L = Li;
        break;
      }
      task[0] = img;
      task[1] = rb;
      task[2] = cb;
      task[3] = L;
    }
    __syncthreads();
    const int img = task[0];
    if (img < 0) return;                     // uniform over the block
    const int cb = task[2];
    if (!build_tile(s, img, R, task[3], task[1], cb, thresh,
                    full_mask ? nullptr : s.stop + img, cbox, carea))
      continue;
    __threadfence();
    __syncthreads();                         // the tile's words are out
    if (threadIdx.x == 0)
      atomicAdd(s.done + static_cast<size_t>(img) * W + cb, 1);
  }
}

// The order kernel for runs of Pt keys: kParts blocks (a cluster) an image,
// kParts runs of Pt keys of dynamic shared memory each (past the default
// 48 KB from Pt = 1024 on: the limit, kept per device, is raised on every
// call).
template <int Pt>
cudaError_t launch_order(const float* boxes, const float* scores, int n,
                         int R, Scratch s, cudaStream_t st) {
  constexpr size_t smem = static_cast<size_t>(kParts) * Pt * sizeof(Key);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_order_kernel<Pt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  nms_order_kernel<Pt><<<n * kParts, Pt / 2, smem, st>>>(boxes, scores, R, s);
  return cudaGetLastError();
}

// The blocks of the select kernel the current device runs at once (at most
// kBlocksPerSm an SM), cached per device (0: not asked yet).
std::atomic<int> g_capacity[kMaxDevices];

int select_capacity(int* capacity_out) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int capacity = dev < kMaxDevices ? g_capacity[dev].load() : 0;
  if (capacity == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, nms_select_kernel, kTile, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    capacity = sms * (per_sm < kBlocksPerSm ? per_sm : kBlocksPerSm);
    if (dev < kMaxDevices) g_capacity[dev].store(capacity);
  }
  *capacity_out = capacity;
  return 0;
}

}  // namespace

extern "C" {

// boxes f32 [n, R, 4], scores f32 [n, R], idx int32 [n, M] and valid bool
// [n, M], all contiguous device arrays; scratch the bytes that
// nms_kernel.py::scratch_bytes(n, R) gives, on a 16-byte boundary;
// full_mask 1 builds the whole mask (the debug output), 0 only what the
// walk needs. Runs the order and select kernels on `stream`. Returns a
// cudaError_t (0 on success).
int ekaid_nms(const void* boxes, const void* scores, float thresh, void* idx,
              void* valid, void* scratch, int n, int R, int M, int full_mask,
              void* stream) {
  if (n < 0 || R < 0 || M < 0 || R > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Scratch s = carve(scratch, n, R);
  int capacity = 0;
  int err = select_capacity(&capacity);
  if (err != 0) return err;
  if (capacity < 2) return static_cast<int>(cudaErrorInvalidConfiguration);

  cudaError_t e;
  const float* b = static_cast<const float*>(boxes);
  const float* sc = static_cast<const float*>(scores);
  if (R <= kParts * 64) e = launch_order<64>(b, sc, n, R, s, st);
  else if (R <= kParts * 128) e = launch_order<128>(b, sc, n, R, s, st);
  else if (R <= kParts * 256) e = launch_order<256>(b, sc, n, R, s, st);
  else if (R <= kParts * 512) e = launch_order<512>(b, sc, n, R, s, st);
  else if (R <= kParts * 1024) e = launch_order<1024>(b, sc, n, R, s, st);
  else e = launch_order<kMaxPart>(b, sc, n, R, s, st);
  if (e != cudaSuccess) return static_cast<int>(e);

  // every block resident at once: the scans wait on the producers
  const int W = words_per_row(R);
  const long long items = static_cast<long long>(W) * (W + 1) / 2 * n;
  int consumers = capacity / 4 < n ? capacity / 4 : n;
  if (consumers < 1) consumers = 1;
  const long long room = capacity - consumers;
  const int producers = static_cast<int>(items < room ? items : room);
  float th = thresh;
  int* idx_p = static_cast<int*>(idx);
  bool* valid_p = static_cast<bool*>(valid);
  void* args[] = {&s, &n, &R, &M, &th, &consumers, &full_mask, &idx_p,
                  &valid_p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(nms_select_kernel),
      dim3(consumers + producers), dim3(kTile), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

const char* ekaid_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
