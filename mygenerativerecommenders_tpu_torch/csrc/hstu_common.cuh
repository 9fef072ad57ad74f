// Device helpers shared by the HSTU attention forward and backward kernels.
//
// Both kernels must put a (query, key) pair into the same time bucket to the
// bit, both stage strided q/k/v rows into shared memory the same way, and both
// bound a packed row's key walk by its segments' starts, so the pieces live
// here once.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
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

// The first key row that query row `row` may see: 0 in an unpacked row
// (seg_pos null), else the start of the row's segment, row - seg_pos[row].
// Rows at or past the length see nothing and must not lower a tile's bound.
__device__ __forceinline__ int segment_start(const int* __restrict__ seg_pos,
                                             int64_t row_offset, int row, int seq_len) {
  if (seg_pos == nullptr) return 0;
  return row < seq_len ? row - seg_pos[row_offset + row] : INT_MAX;
}

// The earliest segment start among a query tile's rows (never below 0): key
// tiles before it hold only cross-segment pairs.
__device__ __forceinline__ int first_key_row(const int* start_s, int rows) {
  int lo = INT_MAX;
  for (int i = 0; i < rows; ++i) lo = min(lo, start_s[i]);
  return max(lo, 0);
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
