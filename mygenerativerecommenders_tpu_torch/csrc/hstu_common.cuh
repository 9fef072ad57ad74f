// Device helpers shared by the HSTU attention kernels (full-sequence and
// ring chunk, forward and backward).
//
// All of them must put a (query, key) pair into the same time bucket to the
// bit and stage strided q/k/v rows into shared memory the same way; the
// full-sequence kernels bound a packed row's key walk by its segments'
// starts; the two backward kernels share their register tiles. So the pieces
// live here once.

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

// Asynchronous copies (cp.async, sm_80 and later): the copy runs while the
// thread goes on; cp_async_commit() closes a group of them and
// cp_async_wait_all() waits for every group the thread has issued. Only a
// barrier after the wait makes one thread's copies visible to the others.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of `rows` rows of `width` floats (source row stride
// `stride`) into dst[r * dst_stride + c]; dst must be 16-byte aligned and
// dst_stride a multiple of 4. Columns from `width` up to the next multiple of
// 4, and whole rows at or past `valid`, are zero-filled with plain stores
// (rows past `valid` are never read). A 4-float chunk goes as one 16-byte
// copy where its source is 16-byte aligned (q, k and v may be column slices
// at any offset), else as four 4-byte copies.
template <int kThreads>
__device__ __forceinline__ void copy_rows_async(float* dst, int dst_stride,
                                                const float* __restrict__ src,
                                                int64_t stride, int rows, int width,
                                                int valid) {
  const int chunks = (width + 3) >> 2;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks, c = (e - r * chunks) * 4;
    float* d = dst + r * dst_stride + c;
    const float* s = src + r * stride + c;
    if (r >= valid) {
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (c + 4 <= width && (reinterpret_cast<uintptr_t>(s) & 15) == 0) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < width) cp_async4(d + u, s + u);
        else d[u] = 0.f;
      }
    }
  }
}

// Register tiles of the two-pass backward kernels (hstu_attention_bwd.cu,
// hstu_chunk_bwd.cu). A block's warps split a 32-row resident tile and a
// 32-row streamed tile into halves; a lane owns 4 resident x 2 streamed
// pairs of its warp's 16 x 16 and reads its operands as float4.
constexpr int kHalf = 16;       // rows a warp owns on each side of a tile
constexpr int kLdW = kHalf + 4; // per-warp dz / p rows: 16-byte aligned, 5 x 16 B

// Row stride in shared memory for rows of d floats: d rounded up to a
// multiple of 4 whose number of 16-byte chunks is odd.
inline int shared_ld(int d) {
  const int ld = (d + 3) / 4 * 4;
  return (ld / 4) % 2 ? ld : ld + 4;
}

// acc[i][j] += sum_e a[i][e] b[j][e] over e < depth (a multiple of 4): a's
// rows are `lda` apart, b's rows 8 * ldb apart.
__device__ __forceinline__ void dot_tile(float (&acc)[4][2], const float* a, int lda,
                                         const float* b, int ldb, int depth) {
#pragma unroll 2
  for (int e = 0; e < depth; e += 4) {
    float4 av[4], bv[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * lda + e);
#pragma unroll
    for (int j = 0; j < 2; ++j) bv[j] = *reinterpret_cast<const float4*>(b + 8 * j * ldb + e);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// out[i][u] += sum_s w[s][i] b[s][cols of group u] over the warp's 16
// streamed rows: w is the warp's [kHalf][kLdW] array at its lane's 4 rows,
// b the warp's first streamed row, groups[u] the lane's 4-column groups.
template <int kU>
__device__ __forceinline__ void accumulate_rows(float4 (&out)[4][kU], const float* w,
                                                const float* b, int ldb,
                                                const int (&groups)[kU]) {
#pragma unroll 4
  for (int s = 0; s < kHalf; ++s) {
    const float4 wv = *reinterpret_cast<const float4*>(w + s * kLdW);
    const float wi[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float4 bv = *reinterpret_cast<const float4*>(b + s * ldb + 4 * groups[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][u].x = fmaf(wi[i], bv.x, out[i][u].x);
        out[i][u].y = fmaf(wi[i], bv.y, out[i][u].y);
        out[i][u].z = fmaf(wi[i], bv.z, out[i][u].z);
        out[i][u].w = fmaf(wi[i], bv.w, out[i][u].w);
      }
    }
  }
}

// Writes the lane's 4 rows x kU column groups of one output, [B, N, H, d]
// contiguous, from row `row0`; rows at or past n are not written.
template <int kU>
__device__ __forceinline__ void store_rows(float* out, const float4 (&acc)[4][kU], int64_t base,
                                           int row0, int n, int h, int d,
                                           const int (&groups)[kU], int n_groups) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= n) continue;
    float* o = out + base + (int64_t)row * h * d;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = 4 * groups[u];
      if (groups[u] >= n_groups) continue;
      const float x[4] = {acc[i][u].x, acc[i][u].y, acc[i][u].z, acc[i][u].w};
      if (c + 4 <= d && (d & 3) == 0) {
        *reinterpret_cast<float4*>(o + c) = acc[i][u];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < d) o[c + e] = x[e];
      }
    }
  }
}

}  // namespace hstu
