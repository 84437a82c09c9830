// Host-side multithreaded random-walk feeder.
//
// The PyTorch port's copy of come_tpu/native/walker.cpp: the walk arithmetic
// (splitmix64 per walk, Lemire bounding, restart at the origin, isolated
// nodes stay put) is the JAX package's byte for byte, so the same starts and
// seed give the same walks in both packages.  std::thread workers write walk
// batches straight into a caller's buffer (a pinned host tensor when the
// trainer runs on a CUDA card) while the device trains on earlier batches.
//
// Two changes of scheduling, none of arithmetic: a worker takes 16 walks at
// a time, not 256, so a batch of 256 walks spreads over the threads; and
// come_random_walks_batched makes many batches, each with its own seed, in
// one call, so the threads start once for all of them.
//
// Build (come_tpu_torch/native/build.py does this at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -o libcomewalk.so walker.cpp -lpthread

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// splitmix64 — tiny, fast, per-walk seedable PRNG
static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// map 64 random bits to [0, n) without modulo bias (Lemire)
static inline uint32_t bounded(uint64_t r, uint32_t n) {
  return static_cast<uint32_t>((static_cast<__uint128_t>(r) * n) >> 64);
}

// walk w of a batch walked with `seed`: come_tpu/native/walker.cpp's body
static inline void walk_one(const int32_t* indptr, const int32_t* indices,
                            int32_t start, int32_t length, uint64_t seed,
                            int64_t w, uint32_t restart_u32, int32_t* row) {
  uint64_t rng = seed ^ (0x2545F4914F6CDD1Dull * (uint64_t)(w + 1));
  int32_t v = start;
  const int32_t origin = v;
  row[0] = v;
  for (int32_t t = 1; t < length; ++t) {
    uint64_t r = splitmix64(rng);
    if (restart_u32 && static_cast<uint32_t>(r >> 32) < restart_u32) {
      v = origin;
    } else {
      const int32_t lo = indptr[v];
      const int32_t deg = indptr[v + 1] - lo;
      if (deg > 0) v = indices[lo + bounded(r, (uint32_t)deg)];
      // deg == 0: isolated node stays put (matches device walker)
    }
    row[t] = v;
  }
}

}  // namespace

extern "C" {

// Walks `num_batches` batches of `batch` truncated random walks of `length`
// steps over the CSR graph, batch b with seeds[b]: walk w of batch b is the
// walk come_tpu's come_random_walks makes as walk w of a call with seed
// seeds[b].  starts holds num_batches*batch start nodes; outs[b] must hold
// batch*length int32s (row-major [batch, length]) for batch b.
// restart_prob in [0,1) restarts a walk at its origin (deepwalk's alpha).
void come_random_walks_batched(const int32_t* indptr, const int32_t* indices,
                               const int32_t* starts, int64_t num_batches,
                               int64_t batch, int32_t length,
                               const uint64_t* seeds,
                               float restart_prob, int32_t* const* outs,
                               int32_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  const int64_t total = num_batches * batch;
  std::atomic<int64_t> next(0);
  const int64_t chunk = 16;
  const uint32_t restart_u32 =
      restart_prob <= 0.f
          ? 0u
          : static_cast<uint32_t>(restart_prob * 4294967296.0);

  auto worker = [&]() {
    for (;;) {
      int64_t begin = next.fetch_add(chunk);
      if (begin >= total) break;
      int64_t end = begin + chunk < total ? begin + chunk : total;
      for (int64_t i = begin; i < end; ++i) {
        const int64_t b = i / batch, w = i % batch;
        walk_one(indptr, indices, starts[i], length, seeds[b], w,
                 restart_u32, outs[b] + w * length);
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int32_t i = 0; i < num_threads; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
