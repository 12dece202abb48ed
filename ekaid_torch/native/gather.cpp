// Native row gather for the mmap HDF5 path (ekaid_torch/data/pipeline.py
// `_RawRows.take`): the port's own copy of ekaid_tpu/native/gather.cpp.
//
// The loader reads row blobs straight out of an mmap of the uncompressed
// HDF5. numpy slice-copies hold the GIL, so a threaded Loader cannot
// scale past one core; these gathers run under a released GIL (ctypes)
// and spread the memcpy over host threads.
//
// gather_rows_i64_i32 also fuses the int64 -> int32 narrowing of the
// reference's adjacency dtype (combine_dicts.py:176-183 writes int64;
// the model reads int32), saving one pass over the largest arrays of a
// batch.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

template <typename Fn>
void parallel_rows(int64_t n, int64_t nthreads, Fn fn) {
  nthreads = std::max<int64_t>(1, std::min<int64_t>(nthreads, n));
  if (nthreads == 1) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t b = t * per, e = std::min(n, b + per);
    if (b >= e) break;
    ts.emplace_back([&fn, b, e] { fn(b, e); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// out[i, :] = base[starts[i] : starts[i] + rowbytes]
void gather_rows(const uint8_t* base, const int64_t* starts, int64_t n,
                 int64_t rowbytes, uint8_t* out, int64_t nthreads) {
  parallel_rows(n, nthreads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i)
      std::memcpy(out + i * rowbytes, base + starts[i], (size_t)rowbytes);
  });
}

// out[i, j] = (int32) load_i64(base + starts[i] + 8*j), j < rowelems.
// memcpy per element keeps unaligned source offsets well-defined; the
// compiler lowers it to a plain load.
void gather_rows_i64_i32(const uint8_t* base, const int64_t* starts,
                         int64_t n, int64_t rowelems, int32_t* out,
                         int64_t nthreads) {
  parallel_rows(n, nthreads, [=](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      const uint8_t* src = base + starts[i];
      int32_t* dst = out + i * rowelems;
      for (int64_t j = 0; j < rowelems; ++j) {
        int64_t v;
        std::memcpy(&v, src + 8 * j, 8);
        dst[j] = (int32_t)v;
      }
    }
  });
}

}  // extern "C"
