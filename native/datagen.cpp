// Native host-side relation generator for htm_hashjoin_tpu.
//
// Counterpart of the reference's C generator stack (mc/src/generator.c:58-545,
// mc/src/genzipf.c:28-158, include/DataGen.hpp:14-122) re-implemented as a
// multithreaded C++17 shared library.  It generates relations on the host
// (then feeds device buffers); for 2^27+ tuple relations the
// Python/numpy path is the bottleneck, so generation is native, parallel and
// seeded (xoshiro256**, one independently-jumped stream per thread).
//
// Exposed via a plain C ABI consumed with ctypes (no pybind11 dependency).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxThreads = 32;

inline unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  if (n == 0) n = 4;
  return std::min<unsigned>(n, kMaxThreads);
}

// xoshiro256** — public-domain PRNG; splitmix64 seeding.
struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    uint64_t x = seed;
    for (int i = 0; i < 4; i++) {
      x += 0x9E3779B97F4A7C15ull;
      uint64_t z = x;
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t v, int k) {
    return (v << k) | (v >> (64 - k));
  }
  uint64_t next() {
    uint64_t result = rotl(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  // unbiased bounded draw
  uint64_t bounded(uint64_t bound) {
    uint64_t threshold = -bound % bound;
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return r % bound;
    }
  }
  double uniform01() { return (next() >> 11) * 0x1.0p-53; }
};

template <typename F>
void parallel_for(int64_t n, F f) {
  unsigned nt = hw_threads();
  if (n < (1 << 16) || nt == 1) {
    f(0, n, 0);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=] { f(lo, hi, t); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// 1..N in order (DataGen.hpp:78-85 "sorted").
void htm_gen_sorted(int32_t* out, int64_t n) {
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t i = lo; i < hi; i++) out[i] = (int32_t)(i + 1);
  });
}

// 1..N Knuth-shuffled (generator.c:240-260 create_relation_pk).  The shuffle
// itself is serial Fisher-Yates for an exact uniform permutation; fill is
// parallel.
void htm_gen_shuffled(int32_t* out, int64_t n, uint64_t seed) {
  htm_gen_sorted(out, n);
  Xoshiro rng(seed ^ 0xA5A5A5A5ull);
  for (int64_t i = n - 1; i > 0; i--) {
    int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
    std::swap(out[i], out[j]);
  }
}

// Windowed local shuffle with the reference's exact swap semantics
// (generator.c:95-110 knuth_shuffle_lshuffle / DataGen.hpp:96-115):
// for each i, swap(out[i], out[i + rand % window]) clamped to the end.
// Serial by construction (swaps chain); still memory-bound fast.
void htm_gen_local_shuffle(int32_t* out, int64_t n, int64_t window,
                           uint64_t seed) {
  htm_gen_sorted(out, n);
  if (window <= 1) return;
  Xoshiro rng(seed ^ 0x5C5C5C5Cull);
  for (int64_t i = 0; i < n; i++) {
    int64_t span = std::min<int64_t>(window, n - i);
    int64_t j = i + (int64_t)rng.bounded((uint64_t)span);
    std::swap(out[i], out[j]);
  }
}

// rand into [1, distinct], sorted, then local shuffle (DataGen.hpp:30-54).
void htm_gen_uniform(int32_t* out, int64_t n, int32_t distinct,
                     int64_t window, uint64_t seed) {
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    Xoshiro rng(seed + 0x1000 + t);
    for (int64_t i = lo; i < hi; i++)
      out[i] = (int32_t)(1 + rng.bounded((uint64_t)distinct));
  });
  std::sort(out, out + n);
  if (window > 1) {
    Xoshiro rng(seed ^ 0x3C3C3C3Cull);
    for (int64_t i = 0; i < n; i++) {
      int64_t span = std::min<int64_t>(window, n - i);
      int64_t j = i + (int64_t)rng.bounded((uint64_t)span);
      std::swap(out[i], out[j]);
    }
  }
}

// Foreign keys tiling the PK domain then shuffled (generator.c:458-491):
// every key 1..r_size appears floor/ceil(s_size/r_size) times.
void htm_gen_fk_from_pk(int32_t* out, int64_t s_size, int64_t r_size,
                        uint64_t seed) {
  parallel_for(s_size, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t i = lo; i < hi; i++) out[i] = (int32_t)(1 + (i % r_size));
  });
  Xoshiro rng(seed ^ 0x77777777ull);
  for (int64_t i = s_size - 1; i > 0; i--) {
    int64_t j = (int64_t)rng.bounded((uint64_t)(i + 1));
    std::swap(out[i], out[j]);
  }
}

// Zipf(theta) over a permuted alphabet via CDF inversion + binary search
// (genzipf.c:97-158 gen_zipf).
void htm_gen_zipf(int32_t* out, int64_t n, int32_t alphabet, double theta,
                  uint64_t seed) {
  std::vector<double> cdf((size_t)alphabet);
  double sum = 0.0;
  for (int32_t i = 0; i < alphabet; i++) {
    sum += 1.0 / std::pow((double)(i + 1), theta);
    cdf[(size_t)i] = sum;
  }
  for (int32_t i = 0; i < alphabet; i++) cdf[(size_t)i] /= sum;
  // permuted alphabet so hot keys are not the small integers
  std::vector<int32_t> alpha((size_t)alphabet);
  for (int32_t i = 0; i < alphabet; i++) alpha[(size_t)i] = i + 1;
  Xoshiro arng(seed ^ 0x2222ull);
  for (int64_t i = alphabet - 1; i > 0; i--) {
    int64_t j = (int64_t)arng.bounded((uint64_t)(i + 1));
    std::swap(alpha[(size_t)i], alpha[(size_t)j]);
  }
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    Xoshiro rng(seed + 0x9000 + t);
    for (int64_t i = lo; i < hi; i++) {
      double u = rng.uniform01();
      auto it = std::lower_bound(cdf.begin(), cdf.end(), u);
      size_t idx = std::min((size_t)(it - cdf.begin()), (size_t)alphabet - 1);
      out[i] = alpha[idx];
    }
  });
}

// Random keys with duplicates in [1, max_key] (generator.c:493-509).
void htm_gen_nonunique(int32_t* out, int64_t n, int32_t max_key,
                       uint64_t seed) {
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    Xoshiro rng(seed + 0x4000 + t);
    for (int64_t i = lo; i < hi; i++)
      out[i] = (int32_t)(1 + rng.bounded((uint64_t)max_key));
  });
}

// Parallel Σ keys — the inputSum conservation oracle, natively.
int64_t htm_checksum(const int32_t* keys, int64_t n) {
  std::atomic<int64_t> total{0};
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned) {
    int64_t local = 0;
    for (int64_t i = lo; i < hi; i++) local += keys[i];
    total.fetch_add(local, std::memory_order_relaxed);
  });
  return total.load();
}

}  // extern "C"
