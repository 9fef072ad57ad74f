// Fused HSTU pointwise attention forward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:118
// (`_kernel`, launched through `hstu_attention_fused`, :225). It computes, for
// query rows n < len_b and keys m <= n, m < len_b,
//
//   out[b,n,h,:] = sum_m silu(q[b,n,h].k[b,m,h] + pos_w[m-n+L-1]
//                             + ts_w[bucket(ts_next[b,n] - ts[b,m])]) / L * v[b,m,h,:]
//
// with L = max_len, ts_next[n] = ts[n+1] (the last column repeated), and
// bucket(d) = clip(int(logf(max(|d|,1)) / 0.301f), 0, num_buckets). Rows at
// or past len_b are written as zeros: the output comes from torch.empty.
//
// What bounds it. At serving shapes (B=32, N=L=211, H=1, d=50) the kernel
// moves ~5.4 MB (q, k, v, out) and does ~0.14 GFLOP of causal fp32 work:
// ~1.6 us at 3.35 TB/s and ~2 us at 67 TFLOP/s. Both are below a launch's
// own overhead, so what limits this kernel is latency: each block walks its
// key tiles one after another, and the longest walk (the last query tile of
// the longest row) sets the time. The design keeps the [B, N, N] bias and
// scores out of device memory, as the TPU kernel does, and keeps every
// thread's arithmetic in independent chains so that shared-memory latency
// overlaps.
//
// Design. One block of 128 threads (4 warps) per (batch row, 16-row query
// tile); the TPU's 128-row pad, its [BQ, NP] Toeplitz position stripe and its
// 128-lane bucket gather exist for Mosaic's limits and are not carried over.
// The block keeps the ts_w table, its q tile and one 32-row key/value tile
// in shared memory; tiles are copied in with each thread's loads batched
// ahead of its stores. Warp w owns query rows 4w..4w+3 of the tile:
//   scores: lane j takes key j of the tile, builds the bias of its 4 pairs
//     once, then per head runs 4 independent dot products, reading each k
//     value once for the 4 rows;
//   p.v: lane c takes output columns c, c+32, ...; per column it sums the
//     tile's 32 keys for its 4 rows in registers and adds them into the
//     block's fp32 accumulator in shared memory.
// Key tiles past min(len_b, last query row) are never loaded; query tiles
// past len_b only write zeros. q, k and v are read through their row
// strides, so the column slices of the fused uvqk projection need no copy.
// wgmma and TMA are left for a later change.
//
// Numerics: the bucket comes from hstu_common.cuh (logf and IEEE division,
// never __logf or --use_fast_math); the delta is taken in wrapping int32 as
// XLA does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 16;              // query rows per block
constexpr int kBK = 32;              // key rows per tile: one per lane
constexpr int kRows = kBQ / kWarps;  // query rows per warp

__global__ void __launch_bounds__(kThreads) hstu_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ ts,
    const int* __restrict__ lengths, const float* __restrict__ pos_w,
    const float* __restrict__ ts_w, float* __restrict__ out, int n, int h,
    int dqk, int dv, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
    int64_t v_sb, int64_t v_sn, int64_t ts_sb, int max_len, int num_buckets,
    float inv_n) {
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
  const int seq_len = min(lengths[b], n);
  const int q_rows = min(kBQ, n - q0);
  const float* qb = q + b * q_sb;
  const float* kb = k + b * k_sb;
  const float* vb = v + b * v_sb;
  const int* tsb = ts + b * ts_sb;

  for (int e = tid; e < kBQ * hv; e += kThreads) acc_s[e] = 0.f;

  if (q0 < seq_len) {
    for (int e = tid; e <= num_buckets; e += kThreads) tsw_s[e] = ts_w[e];
    hstu::copy_rows<kThreads>(q_s, hq, qb + q0 * q_sn, q_sn, kBQ, hq, q_rows);
    if (tid < kBQ) tsq_s[tid] = tsb[min(q0 + tid + 1, n - 1)];

    const int n_tiles = (min(q0 + kBQ, seq_len) - 1) / kBK + 1;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      __syncthreads();  // the last tile's readers are done with k_s/v_s/p_s
      hstu::copy_rows<kThreads>(k_s, ks, kb + k0 * k_sn, k_sn, kBK, hq, seq_len - k0);
      hstu::copy_rows<kThreads>(v_s, hv, vb + k0 * v_sn, v_sn, kBK, hv, seq_len - k0);
      if (tid < kBK) tsk_s[tid] = tsb[min(k0 + tid, n - 1)];
      __syncthreads();

      // scores of pairs (r0 + p, lane) for every head, as p = silu(z) / L
      const int col = k0 + lane;
      float bias[kRows];
      bool live[kRows];
#pragma unroll
      for (int p = 0; p < kRows; ++p) {
        const int row = q0 + r0 + p;
        live[p] = col <= row && col < seq_len && row < seq_len;
        const int delta = (int)((unsigned int)tsq_s[r0 + p] - (unsigned int)tsk_s[lane]);
        bias[p] = live[p] ? pos_w[col - row + max_len - 1] +
                                tsw_s[hstu::bucketize(delta, num_buckets)]
                          : 0.f;
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
  float* ob = out + ((int64_t)b * n + q0) * hv;
  for (int e = tid; e < q_rows * hv; e += kThreads) ob[e] = acc_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long hstu_attention_fwd_smem_bytes(int h, int dqk, int dv, int num_buckets) {
  const long long hq = (long long)h * dqk, hv = (long long)h * dv;
  const long long floats = (num_buckets + 1) + kBQ * hq + kBK * (hq | 1) +
                           kBK * hv + (long long)h * kBQ * kBK + kBQ * hv;
  return 4 * (floats + kBQ + kBK);
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
int hstu_attention_fwd(const float* q, const float* k, const float* v,
                       const int* ts, const int* lengths, const float* pos_w,
                       const float* ts_w, float* out, int b, int n, int h,
                       int dqk, int dv, long long q_sb, long long q_sn,
                       long long k_sb, long long k_sn, long long v_sb,
                       long long v_sn, long long ts_sb, int max_len,
                       int num_buckets, void* stream) {
  const long long smem = hstu_attention_fwd_smem_bytes(h, dqk, dv, num_buckets);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  const float inv_n = (float)(1.0 / (double)max_len);
  hstu_attention_fwd_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      q, k, v, ts, lengths, pos_w, ts_w, out, n, h, dqk, dv, q_sb, q_sn, k_sb,
      k_sn, v_sb, v_sn, ts_sb, max_len, num_buckets, inv_n);
  return (int)cudaGetLastError();
}

const char* hstu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
