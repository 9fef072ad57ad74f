// Fused HSTU pointwise attention backward for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:425
// (`_bwd_fused_kernel`, launched from `_fused_bwd_impl`; `_dtw_from_dz`, :635,
// finishes d_ts_w there for short sequences). Like that kernel it keeps nothing
// [N, N]-shaped from the forward: it recomputes, for every live pair (query row
// m < len_b, key n <= m),
//
//   z   = q[b,m,h].k[b,n,h] + pos_w[n-m+L-1] + ts_w[bucket(ts_next[b,m] - ts[b,n])]
//   sig = sigmoid(z),  p = z sig / L,  dp = g[b,m,h].v[b,n,h]
//   dz  = dp (sig + z sig (1 - sig)) / L
//
// and from these  dq[m] += dz k[n],  dk[n] += dz q[m],  dv[n] += p g[m],
// d_pos_w[n-m+L-1] += sum_h dz,  d_ts_w[bucket] += sum_h dz.  Rows at or past
// len_b come out exactly zero in dq, dk and dv.
//
// Packed rows. With `seg_pos` [B, N] (null = one sequence per row) a pair is
// live only inside one segment, n >= m - seg_pos[b,m], as in the forward (the
// TPU kernel's has_seg branch, :445-473, :513-514): p and dz are masked alike,
// so dk, dv, the diagonal array and the histogram see in-segment pairs only,
// and the key walk starts at the tile of the earliest segment start among the
// block's query rows. Only pairs less than L apart are live, so a row wider
// than L neither reads pos_w nor writes the [L] diagonal array out of range.
//
// What bounds it. At the training shape (B=128, N=L=211, H=1, d=50) the live
// causal half is ~2.9 M pairs x 500 flop = ~1.4 GFLOP of fp32 FMA (~21 us at
// 67 TFLOP/s) against ~43 MB of q, k, v, g, dq, dk, dv (~13 us at 3.35 TB/s):
// operations bound it, and what this simple version pays on top is the serial
// walk over key tiles (three barriers each) and the global atomics of dk/dv.
//
// Design. One block of 256 threads (8 warps) per (batch row, 32-row query
// tile) walks the key tiles up to its last live key. The TPU kernel's 128-row
// pad, Toeplitz position stripe, barrel-rotate skew and one-hot bucket
// products exist for Mosaic and are not carried over. Per 32-key tile:
//   scores: warp w owns query rows 4w..4w+3, lane j key j. The lane builds the
//     bias of its 4 pairs once, then per head runs the 4 q.k and 4 g.v dot
//     products, and writes p and dz of its pairs to shared memory. The
//     head-summed dz goes into a [L] diagonal array and a [num_buckets+1]
//     histogram in shared memory (shared atomics);
//   dq: lane c takes columns c, c+32, ... of rows 4w..4w+3 and adds dz.k into
//     the block's dq accumulator in shared memory (dq of a query tile belongs
//     to this block alone: no atomics, written once at the end);
//   dk, dv: each thread takes (key, column) outputs of the tile, sums over the
//     tile's 32 query rows and adds the partial into the zeroed dk / dv with
//     atomicAdd: other query tiles of the same batch row add to the same keys.
// At the end the block adds the non-zero entries of its diagonal array and
// histogram into d_pos_w and d_ts_w with global atomics: one histogram serves
// short and long sequences. Float atomics sum in an order that changes from
// run to run, so dk, dv and the table gradients differ in their last bits
// between runs; dq is deterministic.
//
// q, k and v are read through their row strides (column slices of the fused
// uvqk projection); g, dq, dk and dv are contiguous [B, N, H*d].

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;              // query rows per block
constexpr int kBK = 32;              // key rows per tile: one per lane
constexpr int kRows = kBQ / kWarps;  // query rows per warp

__global__ void __launch_bounds__(kThreads) hstu_attention_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const int* __restrict__ ts, const int* __restrict__ lengths,
    const int* __restrict__ seg_pos, const float* __restrict__ pos_w,
    const float* __restrict__ ts_w, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dpw,
    float* __restrict__ dtw, int n, int h, int dqk, int dvh, int64_t q_sb,
    int64_t q_sn, int64_t k_sb, int64_t k_sn, int64_t v_sb, int64_t v_sn,
    int64_t ts_sb, int64_t seg_sb, int max_len, int num_buckets, float inv_n) {
  extern __shared__ float smem[];
  const int hq = h * dqk;  // q/k row width
  const int hv = h * dvh;  // v/g row width
  const int ks = hq | 1;   // odd row strides: the 32 lanes hit 32 banks
  const int vs = hv | 1;
  const int nb1 = num_buckets + 1;
  float* tsw_s = smem;                    // [nb1]
  float* hist_s = tsw_s + nb1;            // [nb1] d_ts_w of this block
  float* diag_s = hist_s + nb1;           // [max_len] d_pos_w[0..L-1] of this block
  float* q_s = diag_s + max_len;          // [kBQ, hq]
  float* g_s = q_s + kBQ * hq;            // [kBQ, hv]
  float* k_s = g_s + kBQ * hv;            // [kBK, ks]
  float* v_s = k_s + kBK * ks;            // [kBK, vs]
  float* dz_s = v_s + kBK * vs;           // [h, kBQ, kBK]
  float* p_s = dz_s + h * kBQ * kBK;      // [h, kBQ, kBK]
  float* acc_s = p_s + h * kBQ * kBK;     // [kBQ, hq] dq of this tile
  int* tsq_s = (int*)(acc_s + kBQ * hq);  // [kBQ] next-item timestamps
  int* tsk_s = tsq_s + kBQ;               // [kBK]
  int* start_s = tsk_s + kBK;             // [kBQ] segment start of each query row

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
  const float* gb = g + (int64_t)b * n * hv;
  const int* tsb = ts + b * ts_sb;

  for (int e = tid; e < kBQ * hq; e += kThreads) acc_s[e] = 0.f;

  if (q0 < seq_len) {
    for (int e = tid; e < nb1; e += kThreads) {
      tsw_s[e] = ts_w[e];
      hist_s[e] = 0.f;
    }
    for (int e = tid; e < max_len; e += kThreads) diag_s[e] = 0.f;
    // rows at or past the length are staged as zeros, whatever they hold
    hstu::copy_rows<kThreads>(q_s, hq, qb + q0 * q_sn, q_sn, kBQ, hq, seq_len - q0);
    hstu::copy_rows<kThreads>(g_s, hv, gb + (int64_t)q0 * hv, hv, kBQ, hv, seq_len - q0);
    if (tid < kBQ) {
      const int row = q0 + tid;
      tsq_s[tid] = tsb[min(row + 1, n - 1)];
      start_s[tid] = hstu::segment_start(seg_pos, b * seg_sb, row, seq_len);
    }
    __syncthreads();

    const int n_tiles = (min(q0 + kBQ, seq_len) - 1) / kBK + 1;
    const int t_lo = seg_pos ? hstu::first_key_row(start_s, kBQ) / kBK : 0;
    for (int t = t_lo; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      const int k_valid = min(kBK, seq_len - k0);
      __syncthreads();  // the last tile's readers are done with k_s/v_s/dz_s/p_s
      hstu::copy_rows<kThreads>(k_s, ks, kb + k0 * k_sn, k_sn, kBK, hq, k_valid);
      hstu::copy_rows<kThreads>(v_s, vs, vb + k0 * v_sn, v_sn, kBK, hv, k_valid);
      if (tid < kBK) tsk_s[tid] = tsb[min(k0 + tid, n - 1)];
      __syncthreads();

      // p and dz of pairs (r0 + i, lane) for every head
      const int col = k0 + lane;
      float bias[kRows], dz_sum[kRows];
      int bucket[kRows];
      bool live[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + r0 + i;
        live[i] = col <= row && col < seq_len && row < seq_len &&
                  col >= start_s[r0 + i] && row - col < max_len;
        const int delta = (int)((unsigned int)tsq_s[r0 + i] - (unsigned int)tsk_s[lane]);
        bucket[i] = hstu::bucketize(delta, num_buckets);
        bias[i] = live[i] ? pos_w[col - row + max_len - 1] + tsw_s[bucket[i]] : 0.f;
        dz_sum[i] = 0.f;
      }
      for (int hh = 0; hh < h; ++hh) {
        const float* kr = k_s + lane * ks + hh * dqk;
        const float* qr = q_s + r0 * hq + hh * dqk;
        float s[kRows] = {};
#pragma unroll 4
        for (int d = 0; d < dqk; ++d) {
          const float kd = kr[d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) s[i] = fmaf(qr[i * hq + d], kd, s[i]);
        }
        const float* vr = v_s + lane * vs + hh * dvh;
        const float* gr = g_s + r0 * hv + hh * dvh;
        float dp[kRows] = {};
#pragma unroll 4
        for (int d = 0; d < dvh; ++d) {
          const float vd = vr[d];
#pragma unroll
          for (int i = 0; i < kRows; ++i) dp[i] = fmaf(gr[i * hv + d], vd, dp[i]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float z = s[i] + bias[i];
          const float sig = 1.f / (1.f + expf(-z));
          const float pz = live[i] ? z * sig * inv_n : 0.f;
          const float dz =
              live[i] ? dp[i] * (sig + z * sig * (1.f - sig)) * inv_n : 0.f;
          p_s[(hh * kBQ + r0 + i) * kBK + lane] = pz;
          dz_s[(hh * kBQ + r0 + i) * kBK + lane] = dz;
          dz_sum[i] += dz;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (live[i]) {
          atomicAdd(&diag_s[col - (q0 + r0 + i) + max_len - 1], dz_sum[i]);
          atomicAdd(&hist_s[bucket[i]], dz_sum[i]);
        }
      }
      __syncthreads();

      // dq of rows r0..r0+3, columns lane, lane+32, ...
      for (int c = lane; c < hq; c += 32) {
        const float* dzr = dz_s + ((c / dqk) * kBQ + r0) * kBK;
        float a[kRows] = {};
#pragma unroll 8
        for (int j = 0; j < kBK; ++j) {
          const float kj = k_s[j * ks + c];
#pragma unroll
          for (int i = 0; i < kRows; ++i) a[i] = fmaf(dzr[i * kBK + j], kj, a[i]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc_s[(r0 + i) * hq + c] += a[i];
      }

      // dk and dv of this key tile: partial sums over the block's 32 query
      // rows (only rows at or after the key are live), added into the outputs
      const int first = max(k0 - q0, 0);  // first query row that sees key k0
      float* dkb = dk + ((int64_t)b * n + k0) * hq;
      for (int e = tid; e < k_valid * hq; e += kThreads) {
        const int j = e / hq, c = e - j * hq;
        const float* dzc = dz_s + (c / dqk) * kBQ * kBK + j;
        float a = 0.f;
#pragma unroll 8
        for (int r = first; r < kBQ; ++r) a = fmaf(dzc[r * kBK], q_s[r * hq + c], a);
        atomicAdd(&dkb[e], a);
      }
      float* dvb = dv + ((int64_t)b * n + k0) * hv;
      for (int e = tid; e < k_valid * hv; e += kThreads) {
        const int j = e / hv, c = e - j * hv;
        const float* pc = p_s + (c / dvh) * kBQ * kBK + j;
        float a = 0.f;
#pragma unroll 8
        for (int r = first; r < kBQ; ++r) a = fmaf(pc[r * kBK], g_s[r * hv + c], a);
        atomicAdd(&dvb[e], a);
      }
    }
    __syncthreads();
    // only offsets key - query in (-(q0 + kBQ), 0] were touched
    for (int e = max(max_len - q0 - kBQ, 0) + tid; e < max_len; e += kThreads) {
      const float x = diag_s[e];
      if (x != 0.f) atomicAdd(&dpw[e], x);
    }
    for (int e = tid; e < nb1; e += kThreads) {
      const float x = hist_s[e];
      if (x != 0.f) atomicAdd(&dtw[e], x);
    }
  }
  __syncthreads();
  float* ob = dq + ((int64_t)b * n + q0) * hq;
  for (int e = tid; e < q_rows * hq; e += kThreads) ob[e] = acc_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long hstu_attention_bwd_smem_bytes(int h, int dqk, int dv, int max_len,
                                        int num_buckets) {
  const long long hq = (long long)h * dqk, hv = (long long)h * dv;
  const long long floats = 2LL * (num_buckets + 1) + max_len + 2 * kBQ * hq +
                           kBQ * hv + kBK * (hq | 1) + kBK * (hv | 1) +
                           2LL * h * kBQ * kBK;
  return 4 * (floats + 2 * kBQ + kBK);
}

// dk, dv, dpw and dtw must arrive zeroed; dq is written whole. `seg_pos` is
// [b, n] int32 with row stride seg_sb, or null for unpacked rows. Launches on
// `stream` without synchronising; returns cudaGetLastError().
int hstu_attention_bwd(const float* q, const float* k, const float* v,
                       const float* g, const int* ts, const int* lengths,
                       const int* seg_pos, const float* pos_w,
                       const float* ts_w, float* dq, float* dk, float* dv,
                       float* dpw, float* dtw, int b, int n, int h, int dqk,
                       int dvh, long long q_sb, long long q_sn, long long k_sb,
                       long long k_sn, long long v_sb, long long v_sn,
                       long long ts_sb, long long seg_sb, int max_len,
                       int num_buckets, void* stream) {
  const long long smem =
      hstu_attention_bwd_smem_bytes(h, dqk, dvh, max_len, num_buckets);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  const float inv_n = (float)(1.0 / (double)max_len);
  hstu_attention_bwd_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      q, k, v, g, ts, lengths, seg_pos, pos_w, ts_w, dq, dk, dv, dpw, dtw, n, h,
      dqk, dvh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, ts_sb, seg_sb, max_len,
      num_buckets, inv_n);
  return (int)cudaGetLastError();
}

const char* hstu_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
