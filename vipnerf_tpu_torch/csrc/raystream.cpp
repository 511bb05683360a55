// Native ray-index stream: epoch permutation + chunked batch assembly.
//
// Host C++ (no CUDA). The training loop takes (K, num_rays) index blocks per
// chunk (vipnerf_tpu_torch/data/preprocessor.py get_index_chunk). This keeps
// a persistent stream state (permutation + cursor + xorshift128+ generator)
// and fills whole (K, batch) blocks in one call, epoch reshuffles included.
//
// A copy of vipnerf_tpu/native/raystream.cpp with the same C ABI and the
// same semantics (splitmix64 seeding, Lemire bounded draws, Fisher-Yates
// epoch reshuffles, candidate sets, reset), so that the same seed gives the
// JAX package's index streams index for index.
//
// Built with g++ -O3 -shared -fPIC -std=c++17 by
// vipnerf_tpu_torch/kernels/build.py at first use, loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct XorShift128 {
  // xorshift128+ — fast, good-enough stream RNG for shuffling
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9E3779B97F4A7C15ull;
    auto next = [&z]() {
      z += 0x9E3779B97F4A7C15ull;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
      x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
      return x ^ (x >> 31);
    };
    s0 = next();
    s1 = next();
  }
  inline uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // unbiased bounded draw (Lemire)
  inline uint64_t bounded(uint64_t n) {
    __uint128_t m = (__uint128_t)next() * (__uint128_t)n;
    uint64_t l = (uint64_t)m;
    if (l < n) {
      uint64_t t = -n % n;
      while (l < t) {
        m = (__uint128_t)next() * (__uint128_t)n;
        l = (uint64_t)m;
      }
    }
    return (uint64_t)(m >> 64);
  }
};

struct RayStream {
  std::vector<int32_t> indices;
  size_t cursor = 0;
  XorShift128 rng;
  explicit RayStream(uint64_t seed) : rng(seed) {}

  void shuffle() {
    const size_t n = indices.size();
    if (n < 2) return;  // n == 0 would underflow the loop index
    for (size_t i = n - 1; i > 0; --i) {
      const size_t j = (size_t)rng.bounded(i + 1);
      std::swap(indices[i], indices[j]);
    }
  }
};

}  // namespace

extern "C" {

// Create a stream over `count` candidate indices. If `candidates` is
// non-null it supplies the index values (e.g. valid sparse-depth rays);
// otherwise 0..count-1 is used. The stream is shuffled immediately.
void* raystream_create(const int32_t* candidates, int64_t count,
                       uint64_t seed) {
  auto* s = new RayStream(seed);
  s->indices.resize((size_t)count);
  if (candidates) {
    std::memcpy(s->indices.data(), candidates, sizeof(int32_t) * count);
  } else {
    for (int64_t i = 0; i < count; ++i) s->indices[(size_t)i] = (int32_t)i;
  }
  s->shuffle();
  return s;
}

void raystream_destroy(void* handle) { delete (RayStream*)handle; }

int64_t raystream_size(void* handle) {
  return (int64_t)((RayStream*)handle)->indices.size();
}

// Replace the candidate set (e.g. when the precrop window ends) and
// reshuffle; the cursor resets to 0.
void raystream_reset(void* handle, const int32_t* candidates, int64_t count) {
  auto* s = (RayStream*)handle;
  s->indices.resize((size_t)count);
  if (candidates) {
    std::memcpy(s->indices.data(), candidates, sizeof(int32_t) * count);
  } else {
    for (int64_t i = 0; i < count; ++i) s->indices[(size_t)i] = (int32_t)i;
  }
  s->shuffle();
  s->cursor = 0;
}

// Fill a (k, batch) block of indices. Epoch semantics match the Python
// stream (preprocessor._next_nerf_indices): sequential slices of the
// permutation; when the cursor passes the end, reshuffle and restart;
// a short tail wraps into the fresh permutation.
void raystream_next_block(void* handle, int64_t k, int64_t batch,
                          int32_t* out) {
  auto* s = (RayStream*)handle;
  const size_t n = s->indices.size();
  if (n == 0) {  // degenerate stream: nothing to draw from
    std::memset(out, 0, sizeof(int32_t) * (size_t)(k * batch));
    return;
  }
  for (int64_t row = 0; row < k; ++row) {
    int64_t remaining = batch;
    int32_t* dst = out + row * batch;
    while (remaining > 0) {
      const size_t take =
          std::min((size_t)remaining, n - s->cursor);
      std::memcpy(dst, s->indices.data() + s->cursor,
                  sizeof(int32_t) * take);
      dst += take;
      s->cursor += take;
      remaining -= (int64_t)take;
      if (s->cursor >= n) {
        s->shuffle();
        s->cursor = 0;
      }
    }
  }
}

}  // extern "C"
