// Chunk HSTU attention forward of one ring step, for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_chunk.py:70
// (`_chunk_kernel`, launched through `hstu_chunk_attention`, :515). For Nq query
// rows against one Nc-row K/V chunk whose first global column lies `offd` past
// the rows' first global row, it computes
//
//   out[b,n,h,:] = sum_m silu(q[b,n,h].k[b,m,h] + pos_w[clip(m-n+offd+L-1, 0, 2L-2)]
//                             + ts_w[bucket(tsq[b,n] - tsk[b,m])]) * inv_n * v[b,m,h,:]
//
// over the live pairs: n - m >= offd, n < Nq, m < Nc (the TPU kernel's mask,
// :111-114). There is no length and no "less than L apart": rows past a
// user's length are live, and rows of a sequence padded past L read the
// clipped table slot (:144-161). Each query row's time bias takes the
// next-item timestamp `tsq` that the caller supplies; nothing is shifted here.
// With offd >= Nq no pair is live and the output is zeros.
//
// What bounds it. At the ring's chunk of ml-20m-hstu-long (B=32, 130 x 130,
// H=2, d=64, offd < 0: every pair live) it does 32 x 16,900 x 2 x 256 = 277
// MFLOP of fp32 FMA (~4 us at 67 TFLOP/s) against ~4.3 MB of q, k, v and out
// (~1.3 us at 3.35 TB/s): operations bound it, and a launch's own overhead is
// of the same order. What this simple version pays on top is the serial walk
// over key tiles with three barriers each.
//
// Design. That of csrc/hstu_attention_fwd.cu, whose staging and bucketize
// (hstu_common.cuh) it shares: one block of 128 threads per (batch row,
// 16-row query tile); the block keeps ts_w, its q tile and one 32-row key /
// value tile in shared memory. Warp w owns query rows 4w..4w+3: lane j builds
// the bias of its 4 pairs with key j once and runs the dot products of every
// head; then lane c sums p.v for output columns c, c+32, ... into the block's
// accumulator. The key walk stops at the last tile with a live pair for the
// tile's last row (the TPU kernel's `_live_n_kj`, :58-67, negative case
// included), so the diagonal chunk skips its dead upper triangle and a dead
// chunk walks no tile. The TPU kernel's 128-row pad and Toeplitz position
// stripe exist for Mosaic and are not carried over. q, k and v are read
// through their batch and row strides (chunk slices of the uvqk projection
// need no copy), as are the two timestamp rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;              // query rows per block
constexpr int kBK = 32;              // key rows per tile: one per lane
constexpr int kRows = kBQ / kWarps;  // query rows per warp

// Key tiles with a live pair for query rows below `row_end`: the last row
// sees keys m <= row_end - 1 - offd (none when that is negative).
__device__ __forceinline__ int live_key_tiles(int row_end, int offd, int nc) {
  const int last = row_end - 1 - offd;
  if (last < 0) return 0;
  return min(last / kBK + 1, (nc + kBK - 1) / kBK);
}

__global__ void __launch_bounds__(kThreads) hstu_chunk_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ tsq,
    const int* __restrict__ tsk, const float* __restrict__ pos_w,
    const float* __restrict__ ts_w, float* __restrict__ out, int nq, int nc,
    int h, int dqk, int dv, int64_t q_sb, int64_t q_sn, int64_t k_sb,
    int64_t k_sn, int64_t v_sb, int64_t v_sn, int64_t tsq_sb, int64_t tsk_sb,
    int offd, int max_len, int num_buckets, float inv_n) {
  extern __shared__ float smem[];
  const int hq = h * dqk;  // q/k row width
  const int hv = h * dv;   // v/out row width
  const int ks = hq | 1;   // odd k-tile row stride: the 32 lanes hit 32 banks
  float* tsw_s = smem;                        // [num_buckets + 1]
  float* q_s = tsw_s + (num_buckets + 1);     // [kBQ, hq]
  float* k_s = q_s + kBQ * hq;                // [kBK, ks]
  float* v_s = k_s + kBK * ks;                // [kBK, hv]
  float* p_s = v_s + kBK * hv;                // [h, kBQ, kBK]
  float* acc_s = p_s + h * kBQ * kBK;         // [kBQ, hv]
  int* tsq_s = (int*)(acc_s + kBQ * hv);      // [kBQ] next-item timestamps
  int* tsk_s = tsq_s + kBQ;                   // [kBK]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;  // this warp's first query row in the tile
  const int q_rows = min(kBQ, nq - q0);
  const float* qb = q + b * q_sb;
  const float* kb = k + b * k_sb;
  const float* vb = v + b * v_sb;
  const int* tsqb = tsq + b * tsq_sb;
  const int* tskb = tsk + b * tsk_sb;
  const int pos_hi = 2 * max_len - 2;

  for (int e = tid; e < kBQ * hv; e += kThreads) acc_s[e] = 0.f;

  const int n_tiles = live_key_tiles(q0 + q_rows, offd, nc);
  if (n_tiles > 0) {
    for (int e = tid; e <= num_buckets; e += kThreads) tsw_s[e] = ts_w[e];
    hstu::copy_rows<kThreads>(q_s, hq, qb + q0 * q_sn, q_sn, kBQ, hq, q_rows);
    if (tid < kBQ) tsq_s[tid] = tid < q_rows ? tsqb[q0 + tid] : 0;
    __syncthreads();

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      __syncthreads();  // the last tile's readers are done with k_s/v_s/p_s
      hstu::copy_rows<kThreads>(k_s, ks, kb + k0 * k_sn, k_sn, kBK, hq, nc - k0);
      hstu::copy_rows<kThreads>(v_s, hv, vb + k0 * v_sn, v_sn, kBK, hv, nc - k0);
      if (tid < kBK) tsk_s[tid] = k0 + tid < nc ? tskb[k0 + tid] : 0;
      __syncthreads();

      // scores of pairs (r0 + p, lane) for every head, as p = silu(z) * inv_n
      const int col = k0 + lane;
      float bias[kRows];
      bool live[kRows];
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        const int row = q0 + r0 + p;
        live[p] = row - col >= offd && row < nq && col < nc;
        const int delta = (int)((unsigned int)tsq_s[r0 + p] - (unsigned int)tsk_s[lane]);
        const int slot = min(max(col - row + offd + max_len - 1, 0), pos_hi);
        bias[p] = live[p] ? pos_w[slot] + tsw_s[hstu::bucketize(delta, num_buckets)] : 0.f;
      }
      for (int hh = 0; hh < h; ++hh) {
        const float* kr = k_s + lane * ks + hh * dqk;
        const float* qr = q_s + r0 * hq + hh * dqk;
        float s[kRows] = {};
#pragma unroll 4
        for (int d = 0; d < dqk; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int p = 0; p < kRows; ++p) s[p] = fmaf(qr[p * hq + d], kd, s[p]);
        }
#pragma unroll
        for (int p = 0; p < kRows; ++p) {
          const float z = s[p] + bias[p];
          p_s[(hh * kBQ + r0 + p) * kBK + lane] =
              live[p] ? z / (1.f + expf(-z)) * inv_n : 0.f;
        }
      }
      __syncthreads();

      // p.v for rows r0..r0+3, columns lane, lane+32, ...
      for (int c = lane; c < hv; c += 32) {
        const float* pr = p_s + ((c / dv) * kBQ + r0) * kBK;
        float a[kRows] = {};
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) {
          const float vj = v_s[j * hv + c];
#pragma unroll
          for (int p = 0; p < kRows; ++p) a[p] = fmaf(pr[p * kBK + j], vj, a[p]);
        }
#pragma unroll
        for (int p = 0; p < kRows; ++p) acc_s[(r0 + p) * hv + c] += a[p];
      }
    }
  }
  __syncthreads();
  float* ob = out + ((int64_t)b * nq + q0) * hv;
  for (int e = tid; e < q_rows * hv; e += kThreads) ob[e] = acc_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long hstu_chunk_fwd_smem_bytes(int h, int dqk, int dv, int num_buckets) {
  const long long hq = (long long)h * dqk, hv = (long long)h * dv;
  const long long floats = (num_buckets + 1) + kBQ * hq + kBK * (hq | 1) +
                           kBK * hv + (long long)h * kBQ * kBK + kBQ * hv;
  return 4 * (floats + kBQ + kBK);
}

// q [b, nq, h, dqk], k [b, nc, h, dqk], v [b, nc, h, dv] float32 with heads
// contiguous in a row (batch and row strides given); tsq [b, nq] and tsk
// [b, nc] int32 with the row strides given; out [b, nq, h, dv] contiguous.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int hstu_chunk_fwd(const float* q, const float* k, const float* v,
                   const int* tsq, const int* tsk, const float* pos_w,
                   const float* ts_w, float* out, int b, int nq, int nc, int h,
                   int dqk, int dv, long long q_sb, long long q_sn,
                   long long k_sb, long long k_sn, long long v_sb,
                   long long v_sn, long long tsq_sb, long long tsk_sb,
                   int offd, int max_len, int num_buckets, float inv_n,
                   void* stream) {
  const long long smem = hstu_chunk_fwd_smem_bytes(h, dqk, dv, num_buckets);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_chunk_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nq + kBQ - 1) / kBQ, b);
  hstu_chunk_fwd_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      q, k, v, tsq, tsk, pos_w, ts_w, out, nq, nc, h, dqk, dv, q_sb, q_sn, k_sb,
      k_sn, v_sb, v_sn, tsq_sb, tsk_sb, offd, max_len, num_buckets, inv_n);
  return (int)cudaGetLastError();
}

const char* hstu_chunk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
