// Device helpers shared by the HSTU attention forward and backward kernels.
//
// Both kernels must put a (query, key) pair into the same time bucket to the
// bit, and both stage strided q/k/v rows into shared memory the same way, so
// the two pieces live here once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hstu {

// bucket(d) = clip(int(logf(max(|d|, 1)) / 0.301f), 0, num_buckets), with
// logf and IEEE division (never __logf or --use_fast_math, which would move
// deltas near a bucket boundary into the next bucket).
__device__ __forceinline__ int bucketize(int delta, int num_buckets) {
  // |delta| in int32 as jnp.abs gives it (INT_MIN stays negative, clamps to 1)
  const unsigned int mag = delta < 0 ? 0u - (unsigned int)delta : (unsigned int)delta;
  const float x = logf(fmaxf((float)(int)mag, 1.0f)) / 0.301f;
  return min(max((int)x, 0), num_buckets);
}

constexpr int kLoadBatch = 16;  // global loads a thread issues before it stores

// Copies `rows` rows of `width` floats (source row stride `stride`) into
// dst[r * dst_stride + c], zero-filling rows at or past `valid`. Each thread
// issues kLoadBatch independent loads before its first store, so their
// device-memory latencies overlap instead of adding up.
template <int kThreads>
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* __restrict__ src,
                                          int64_t stride, int rows, int width,
                                          int valid) {
  const int total = rows * width;
  for (int base = threadIdx.x; base < total; base += kThreads * kLoadBatch) {
    float buf[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = base + u * kThreads;
      const int r = e / width;
      buf[u] = e < total && r < valid ? src[r * stride + (e - r * width)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int e = base + u * kThreads;
      const int r = e / width;
      if (e < total) dst[r * dst_stride + (e - r * width)] = buf[u];
    }
  }
}

}  // namespace hstu
