// Device helpers shared by the HSTU attention kernels (full-sequence and
// ring chunk, forward and backward).
//
// All of them must put a (query, key) pair into the same time bucket to the
// bit and stage strided q/k/v rows into shared memory the same way; the
// full-sequence kernels bound a packed row's key walk by its segments'
// starts; all four share their register tiles, and the two forwards their
// tile step. So the pieces live here once.

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

// Register tiles of the attention kernels. A block's warps split a 32-row
// resident tile into halves and a streamed tile into 16-row slices (two in
// the backwards); a lane owns 4 resident x 2 streamed pairs of its warp's 16 x
// 16 and reads its operands as float4.
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

// The forward's tile step (csrc/hstu_attention_fwd.cu, csrc/hstu_chunk_fwd.cu):
// out[i][u] += sum over the warp's 16 streamed keys s of p(i, s) v[s][group u],
// with p = silu(q_i.k_s + bias) inv_n on a live pair and 0 on a dead one.
// q is the lane's first resident row (rows ldq apart), k and v the warp's
// first streamed rows, w the warp's [kHalf][kLdW] array of p. The lane owns
// the 4 x 2 pairs of dot_tile; `bias(i, j, b)` says whether its pair (row i,
// streamed row ls + 8 j) is live and, if so, sets b to the pair's bias.
template <int kU, class Bias>
__device__ __forceinline__ void forward_tile(float4 (&out)[4][kU], const float* q, int ldq,
                                             const float* k, const float* v, int ldv,
                                             int depth, float* w, float inv_n,
                                             const int (&groups)[kU], Bias bias) {
  const int lane = threadIdx.x & 31, lr = lane >> 3, ls = lane & 7;
  float x[4][2] = {};
  dot_tile(x, q, ldq, k + ls * ldq, ldq, depth);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float b = 0.f;
      const bool live = bias(i, j, b);
      const float z = x[i][j] + b;
      p[i] = live ? z / (1.f + expf(-z)) * inv_n : 0.f;
    }
    *reinterpret_cast<float4*>(w + (ls + 8 * j) * kLdW + 4 * lr) =
        make_float4(p[0], p[1], p[2], p[3]);
  }
  __syncwarp();
  accumulate_rows<kU>(out, w + 4 * lr, v, ldv, groups);
  __syncwarp();  // the next tile's p overwrites what the lanes read
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

// The end of a forward pass, for every thread of the block: the kSlices
// streamed slices (ws 0 .. kSlices - 1) of each resident row meet in `red`
// ([kSlices - 1][2 kHalf] rows ld apart; free shared memory, the caller's
// copies waited for); slice 0 adds the others in order, so the sum has one
// order, and writes the rows once. `groups` are the lane's unclamped column
// groups.
template <int kU, int kSlices>
__device__ __forceinline__ void store_slices(float* out, float4 (&acc)[4][kU], float* red,
                                             int ld, int row_lane, int ws, int64_t base,
                                             int row0, int n, int h, int d,
                                             const int (&groups)[kU], int n_groups) {
  if (ws > 0) {
    float* mine = red + (ws - 1) * 2 * kHalf * ld;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (groups[u] < n_groups)
          *reinterpret_cast<float4*>(mine + (row_lane + i) * ld + 4 * groups[u]) = acc[i][u];
  }
  __syncthreads();
  if (ws == 0) {
#pragma unroll
    for (int s = 0; s < kSlices - 1; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (groups[u] >= n_groups) continue;
          const float4 o = *reinterpret_cast<const float4*>(
              red + (s * 2 * kHalf + row_lane + i) * ld + 4 * groups[u]);
          acc[i][u].x += o.x;
          acc[i][u].y += o.y;
          acc[i][u].z += o.z;
          acc[i][u].w += o.w;
        }
    store_rows<kU>(out, acc, base, row0, n, h, d, groups, n_groups);
  }
}

// ------------------------------------------------------------ wide heads
//
// The kernels for heads wider than 128 (dqk or dv) stage depth in slices of
// kSliceW columns, rows kLdSlice floats apart, and keep one kSliceW-column
// slice of each output a block (4 x 8-column groups a lane, as kU = 4).
constexpr int kSliceW = 128;
constexpr int kLdSlice = 132;  // shared_ld(128)

// The first half of store_slices: afterwards the lanes of slice 0 (ws 0)
// hold each resident row's sum over the kSlices streamed slices, added in
// slice order. Every thread of the block calls it.
template <int kU, int kSlices>
__device__ __forceinline__ void sum_slices(float4 (&acc)[4][kU], float* red, int ld,
                                           int row_lane, int ws, const int (&groups)[kU],
                                           int n_groups) {
  if (ws > 0) {
    float* mine = red + (ws - 1) * 2 * kHalf * ld;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (groups[u] < n_groups)
          *reinterpret_cast<float4*>(mine + (row_lane + i) * ld + 4 * groups[u]) = acc[i][u];
  }
  __syncthreads();
  if (ws == 0) {
#pragma unroll
    for (int s = 0; s < kSlices - 1; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (groups[u] >= n_groups) continue;
          const float4 o = *reinterpret_cast<const float4*>(
              red + (s * 2 * kHalf + row_lane + i) * ld + 4 * groups[u]);
          acc[i][u].x += o.x;
          acc[i][u].y += o.y;
          acc[i][u].z += o.z;
          acc[i][u].w += o.w;
        }
  }
}

// store_rows for a column slice: the lane's 4 rows x kU column groups of a
// slice `width` columns wide, at out[base + row * row_stride + 4 group];
// rows at or past n are not written.
template <int kU>
__device__ __forceinline__ void store_rows_at(float* out, const float4 (&acc)[4][kU],
                                              int64_t base, int row0, int n,
                                              int64_t row_stride, int width,
                                              const int (&groups)[kU], int n_groups) {
  const bool vec = (row_stride & 3) == 0 && (base & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + i;
    if (row >= n) continue;
    float* o = out + base + (int64_t)row * row_stride;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (groups[u] >= n_groups) continue;
      const int c = 4 * groups[u];
      const float x[4] = {acc[i][u].x, acc[i][u].y, acc[i][u].z, acc[i][u].w};
      if (vec && c + 4 <= width) {
        *reinterpret_cast<float4*>(o + c) = acc[i][u];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < width) o[c + e] = x[e];
      }
    }
  }
}

}  // namespace hstu
