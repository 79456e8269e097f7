// Native host-side runtime pieces for the input pipeline (a copy of the JAX
// package's csrc/devit_host.cpp, which the port does not read).
//
// Batches are gathers out of in-memory (or memory-mapped) uint8 arrays,
// where numpy's fancy indexing is a single-threaded memcpy. This library
// does the gather with a thread pool, overlapping cores.
//
// Built at first use by devit_tpu_torch/io/native.py (g++ -O3 -shared
// -fPIC, into build/ at the root of the checkout); used via ctypes. A failed
// build raises: there is no numpy fallback.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather rows: dst[i] = src[idx[i]] for i in [0, n); each row is item_bytes.
void devit_gather_u8(const uint8_t* src, const int64_t* idx, int64_t n,
                     int64_t item_bytes, uint8_t* dst, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * item_bytes, src + idx[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
  };
  if (n_threads == 1 || n < n_threads * 2) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
