// Bit-exact replay of the reference problem generator.
//
// The reference generates its point cloud host-side with std::mt19937 +
// std::uniform_real_distribution<float>(-100, 100) (Utility.cpp:6-18), and
// its MPI variant skips to a shard's rows with random.discard(rows * dim)
// (kdtree_mpi.cpp:24,32) — one 32-bit draw per float on libstdc++, which is
// what makes the discard arithmetic line up.
//
// The package generates with threefry on the device by default
// (kdtree_tpu_torch/ops/generate.py); this tiny native library exists so the
// harness protocol can reproduce the course grading stream bit-for-bit and
// the golden-parity tests can compare against the reference binary's output.
// It is kdtree_tpu/native/gen.cpp's generator, copied so that the two
// packages build the same stream from their own sources.
//
// Built as a shared library with g++ at first use, bound via ctypes.

#include <cstdint>
#include <random>

extern "C" {

// Fill out[row_count * dim] with rows [row_start, row_start + row_count) of
// the infinite row stream defined by (seed, dim). Row r's floats are draws
// [r*dim, (r+1)*dim) of the distribution stream — the generalization that
// covers both the sequential layout (rows 0..n+q) and the MPI shard-local
// layout (any row window).
void kdt_generate_rows(int32_t seed, int32_t dim, int64_t row_start,
                       int64_t row_count, float* out) {
  std::mt19937 random(seed);
  std::uniform_real_distribution<float> distribution(-100.0f, 100.0f);
  random.discard(static_cast<unsigned long long>(row_start) * dim);
  const int64_t total = row_count * dim;
  for (int64_t i = 0; i < total; ++i) {
    out[i] = distribution(random);
  }
}

}  // extern "C"
