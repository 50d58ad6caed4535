// apex_tpu_torch host runtime: the port's copy of the JAX package's
// native/apex_tpu_native.cpp, host-side C++ hot paths.
//
// Reference: csrc/flatten_unflatten.cpp (apex_C.flatten/unflatten).
// The host-side work that stays hot around a training step is
// checkpoint serialization (gather a whole param tree into one
// contiguous blob) and input-batch assembly (gather sample rows into a
// batch buffer).  Those are multithreaded memcpy problems, which is what
// this library provides through a tiny C ABI loaded with ctypes.  It is
// a host library apart from the CUDA kernels: g++ alone builds it.
//
// Build: see apex_tpu_torch/io/native.py (g++ -O3 -shared -fPIC -pthread).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, n) over a small thread pool.
template <typename F>
void parallel_for(int64_t n, int threads, F fn) {
  if (n <= 0) return;
  if (threads <= 1 || n == 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      fn(i);
    }
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : static_cast<int>(n);
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Gather n buffers (byte sizes in `sizes`) into contiguous `dst`.
// Offsets are the exclusive prefix sum of sizes.  apex_C.flatten.
void apex_tpu_flatten(const void** srcs, const int64_t* sizes, int64_t n,
                      void* dst, int threads) {
  std::vector<int64_t> offsets(n);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    off += sizes[i];
  }
  char* out = static_cast<char*>(dst);
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(out + offsets[i], srcs[i], static_cast<size_t>(sizes[i]));
  });
}

// Scatter contiguous `src` back into n buffers.  apex_C.unflatten.
void apex_tpu_unflatten(const void* src, void** dsts, const int64_t* sizes,
                        int64_t n, int threads) {
  std::vector<int64_t> offsets(n);
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    off += sizes[i];
  }
  const char* in = static_cast<const char*>(src);
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(dsts[i], in + offsets[i], static_cast<size_t>(sizes[i]));
  });
}

// Gather `n` rows of `row_bytes` each from `src` at `indices` into `dst`
// (input-batch assembly: dst[i] = src[indices[i]]).
void apex_tpu_gather_rows(const void* src, const int64_t* indices, int64_t n,
                          int64_t row_bytes, void* dst, int threads) {
  const char* in = static_cast<const char*>(src);
  char* out = static_cast<char*>(dst);
  parallel_for(n, threads, [&](int64_t i) {
    std::memcpy(out + i * row_bytes, in + indices[i] * row_bytes,
                static_cast<size_t>(row_bytes));
  });
}

int apex_tpu_native_abi_version() { return 1; }

}  // extern "C"
