// Host-side ray-batch sampler of the PyTorch port, loaded with ctypes by
// lib.py next to this file.
//
// It assembles the (camera, row, col) index triples of a training batch and
// gathers their supervision pixels (rgb, depth) on the host, in parallel and
// outside the interpreter lock. It keeps the arithmetic of the JAX package's
// native sampler without masks, so both draw the same batches at the same
// OpenMP thread count: each thread seeds its own xorshift128+ with
// seed * 0x100000001b3 + thread id and takes a static share of the batch, so
// the draws depend on the thread count. The JAX sampler's masked-pixel
// rejection, index shuffle and row gather have no caller and are not here.
//
// Build: build.py (g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17).

#include <cstdint>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct XorShift128 {
  uint64_t s0, s1;
  explicit XorShift128(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9e3779b97f4a7c15ULL;
    auto mix = [&z]() {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t x = z;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
      return x ^ (x >> 31);
    };
    s0 = mix();
    s1 = mix();
  }
  inline uint64_t next() {
    uint64_t x = s0;
    const uint64_t y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  inline uint32_t below(uint32_t bound) {
    return static_cast<uint32_t>(next() % bound);
  }
};

}  // namespace

extern "C" {

// Sample `batch` uniform random pixels from an image stack.
//   images:  (n, h, w, 3) uint8
//   depths:  (n, h, w) float32 or nullptr
// Outputs (preallocated by the caller):
//   ray_indices: (batch, 3) int32 (camera, row, col)
//   rgb:         (batch, 3) float32 in [0, 1]
//   depth_out:   (batch,) float32, or nullptr when depths == nullptr
void sample_ray_batch(const uint8_t* images, const float* depths, int64_t n,
                      int64_t h, int64_t w, int64_t batch, uint64_t seed,
                      int32_t* ray_indices, float* rgb, float* depth_out) {
  const int64_t hw = h * w;
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    XorShift128 prng(seed * 0x100000001b3ULL + static_cast<uint64_t>(tid));
#pragma omp for schedule(static)
    for (int64_t i = 0; i < batch; ++i) {
      const int64_t cam = prng.below(static_cast<uint32_t>(n));
      const int64_t row = prng.below(static_cast<uint32_t>(h));
      const int64_t col = prng.below(static_cast<uint32_t>(w));
      const int64_t pix = cam * hw + row * w + col;
      ray_indices[i * 3 + 0] = static_cast<int32_t>(cam);
      ray_indices[i * 3 + 1] = static_cast<int32_t>(row);
      ray_indices[i * 3 + 2] = static_cast<int32_t>(col);
      const uint8_t* px = images + pix * 3;
      rgb[i * 3 + 0] = px[0] * (1.0f / 255.0f);
      rgb[i * 3 + 1] = px[1] * (1.0f / 255.0f);
      rgb[i * 3 + 2] = px[2] * (1.0f / 255.0f);
      if (depths) depth_out[i] = depths[pix];
    }
  }
}

int nkt_native_abi_version() { return 2; }

}  // extern "C"
