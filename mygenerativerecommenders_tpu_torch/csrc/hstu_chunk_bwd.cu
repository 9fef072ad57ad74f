// Chunk HSTU attention backward of one ring step, for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_chunk.py:254
// (`_bwd_kernel`, launched from `_bwd_impl`, :418). Like that kernel it keeps
// nothing [Nq, Nc]-shaped from the forward: for every live pair (n - m >= offd,
// n < Nq, m < Nc; see csrc/hstu_chunk_fwd.cu) it recomputes
//
//   slot = clip(m - n + offd + L - 1, 0, 2L - 2)
//   z    = q[b,n,h].k[b,m,h] + pos_w[slot] + ts_w[bucket(tsq[b,n] - tsk[b,m])]
//   sig  = sigmoid(z),  p = z sig inv_n,  dp = g[b,n,h].v[b,m,h]
//   dz   = dp (sig + z sig (1 - sig)) inv_n
//
// and from these  dq[n] += dz k[m],  dk[m] += dz q[n],  dv[m] += p g[n],
// d_pos_w[slot] += sum_h dz,  d_ts_w[bucket] += sum_h dz. A pair whose slot
// was clipped adds its gradient into the slot it read (the TPU wrapper's
// clipped scatter-add, :469-481). A live pair has m - n + offd <= 0, so its
// slot lies in [0, L-1]. With offd >= Nq no pair is live and dq, dk and dv
// are zeros.
//
// What bounds it. At the ring's chunk of ml-20m-hstu-long (B=32, 130 x 130,
// H=2, d=64, every pair live) it does 32 x 16,900 x 2 x 640 = 692 MFLOP of
// fp32 FMA (~10 us at 67 TFLOP/s) against ~7.5 MB of q, k, v, g, dq, dk, dv
// (~2 us at 3.35 TB/s): operations bound it; this simple version pays the
// serial walk over key tiles and the global atomics of dk and dv on top.
//
// Design. That of csrc/hstu_attention_bwd.cu: one block of 256 threads per
// (batch row, 32-row query tile) walks the key tiles up to the last one with
// a live pair (the forward's bound). dq of the tile stays in shared memory and
// is written once; dk and dv of a key tile are summed over the block's 32
// query rows and added into the zeroed outputs with atomicAdd, since the other
// query tiles of the batch row add to the same keys (the TPU kernel
// accumulates them across its sequential query grid, :296-299, which CUDA
// blocks cannot share). d_pos_w and d_ts_w sum over batch rows, heads and
// tiles (:301-304, :354-392): each block sums its head-summed dz into an [L]
// array indexed by slot and a [num_buckets+1] histogram in shared memory, and
// at the end adds their non-zero entries into d_pos_w and d_ts_w with global
// atomics. The barrel-rotate skew and the bucket sweep of the TPU kernel exist
// for Mosaic and are not carried over. Float atomics sum in an order that
// changes from run to run, so dk, dv and the table gradients differ in their
// last bits between runs; dq is deterministic.
//
// q, k, v and the timestamps are read through their strides (chunk slices of
// the uvqk projection); g, dq, dk and dv are contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 32;              // query rows per block
constexpr int kBK = 32;              // key rows per tile: one per lane
constexpr int kRows = kBQ / kWarps;  // query rows per warp

// Key tiles with a live pair for query rows below `row_end` (as the forward).
__device__ __forceinline__ int live_key_tiles(int row_end, int offd, int nc) {
  const int last = row_end - 1 - offd;
  if (last < 0) return 0;
  return min(last / kBK + 1, (nc + kBK - 1) / kBK);
}

__global__ void __launch_bounds__(kThreads) hstu_chunk_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const int* __restrict__ tsq, const int* __restrict__ tsk,
    const float* __restrict__ pos_w, const float* __restrict__ ts_w,
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dpw, float* __restrict__ dtw, int nq, int nc, int h,
    int dqk, int dvh, int64_t q_sb, int64_t q_sn, int64_t k_sb, int64_t k_sn,
    int64_t v_sb, int64_t v_sn, int64_t tsq_sb, int64_t tsk_sb, int offd,
    int max_len, int num_buckets, float inv_n) {
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

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * kRows;  // this warp's first query row in the tile
  const int q_rows = min(kBQ, nq - q0);
  const float* qb = q + b * q_sb;
  const float* kb = k + b * k_sb;
  const float* vb = v + b * v_sb;
  const float* gb = g + (int64_t)b * nq * hv;
  const int* tsqb = tsq + b * tsq_sb;
  const int* tskb = tsk + b * tsk_sb;

  for (int e = tid; e < kBQ * hq; e += kThreads) acc_s[e] = 0.f;

  const int n_tiles = live_key_tiles(q0 + q_rows, offd, nc);
  if (n_tiles > 0) {
    for (int e = tid; e < nb1; e += kThreads) {
      tsw_s[e] = ts_w[e];
      hist_s[e] = 0.f;
    }
    for (int e = tid; e < max_len; e += kThreads) diag_s[e] = 0.f;
    hstu::copy_rows<kThreads>(q_s, hq, qb + q0 * q_sn, q_sn, kBQ, hq, q_rows);
    hstu::copy_rows<kThreads>(g_s, hv, gb + (int64_t)q0 * hv, hv, kBQ, hv, q_rows);
    if (tid < kBQ) tsq_s[tid] = tid < q_rows ? tsqb[q0 + tid] : 0;
    __syncthreads();

    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      const int k_valid = min(kBK, nc - k0);
      __syncthreads();  // the last tile's readers are done with k_s/v_s/dz_s/p_s
      hstu::copy_rows<kThreads>(k_s, ks, kb + k0 * k_sn, k_sn, kBK, hq, k_valid);
      hstu::copy_rows<kThreads>(v_s, vs, vb + k0 * v_sn, v_sn, kBK, hv, k_valid);
      if (tid < kBK) tsk_s[tid] = tid < k_valid ? tskb[k0 + tid] : 0;
      __syncthreads();

      // p and dz of pairs (r0 + i, lane) for every head
      const int col = k0 + lane;
      float bias[kRows], dz_sum[kRows];
      int bucket[kRows], slot[kRows];
      bool live[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + r0 + i;
        live[i] = row - col >= offd && row < nq && col < nc;
        const int delta = (int)((unsigned int)tsq_s[r0 + i] - (unsigned int)tsk_s[lane]);
        bucket[i] = hstu::bucketize(delta, num_buckets);
        // a live pair's slot is at most L-1: only the lower clip can bind
        slot[i] = min(max(col - row + offd + max_len - 1, 0), max_len - 1);
        bias[i] = live[i] ? pos_w[slot[i]] + tsw_s[bucket[i]] : 0.f;
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
          atomicAdd(&diag_s[slot[i]], dz_sum[i]);
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
      // rows (only rows at or past key k0 + offd are live), added into the
      // outputs
      const int first = min(max(k0 + offd - q0, 0), kBQ);
      float* dkb = dk + ((int64_t)b * nc + k0) * hq;
      for (int e = tid; e < k_valid * hq; e += kThreads) {
        const int j = e / hq, c = e - j * hq;
        const float* dzc = dz_s + (c / dqk) * kBQ * kBK + j;
        float a = 0.f;
#pragma unroll 8
        for (int r = first; r < kBQ; ++r) a = fmaf(dzc[r * kBK], q_s[r * hq + c], a);
        atomicAdd(&dkb[e], a);
      }
      float* dvb = dv + ((int64_t)b * nc + k0) * hv;
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
    for (int e = tid; e < max_len; e += kThreads) {
      const float x = diag_s[e];
      if (x != 0.f) atomicAdd(&dpw[e], x);
    }
    for (int e = tid; e < nb1; e += kThreads) {
      const float x = hist_s[e];
      if (x != 0.f) atomicAdd(&dtw[e], x);
    }
  }
  __syncthreads();
  float* ob = dq + ((int64_t)b * nq + q0) * hq;
  for (int e = tid; e < q_rows * hq; e += kThreads) ob[e] = acc_s[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long hstu_chunk_bwd_smem_bytes(int h, int dqk, int dv, int max_len,
                                    int num_buckets) {
  const long long hq = (long long)h * dqk, hv = (long long)h * dv;
  const long long floats = 2LL * (num_buckets + 1) + max_len + 2 * kBQ * hq +
                           kBQ * hv + kBK * (hq | 1) + kBK * (hv | 1) +
                           2LL * h * kBQ * kBK;
  return 4 * (floats + kBQ + kBK);
}

// dk, dv, dpw and dtw must arrive zeroed; dq is written whole. Strides as in
// hstu_chunk_fwd; g [b, nq, h, dv] contiguous. Launches on `stream` without
// synchronising; returns cudaGetLastError().
int hstu_chunk_bwd(const float* q, const float* k, const float* v,
                   const float* g, const int* tsq, const int* tsk,
                   const float* pos_w, const float* ts_w, float* dq, float* dk,
                   float* dv, float* dpw, float* dtw, int b, int nq, int nc,
                   int h, int dqk, int dvh, long long q_sb, long long q_sn,
                   long long k_sb, long long k_sn, long long v_sb,
                   long long v_sn, long long tsq_sb, long long tsk_sb,
                   int offd, int max_len, int num_buckets, float inv_n,
                   void* stream) {
  const long long smem =
      hstu_chunk_bwd_smem_bytes(h, dqk, dvh, max_len, num_buckets);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_chunk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nq + kBQ - 1) / kBQ, b);
  hstu_chunk_bwd_kernel<<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      q, k, v, g, tsq, tsk, pos_w, ts_w, dq, dk, dv, dpw, dtw, nq, nc, h, dqk,
      dvh, q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, tsq_sb, tsk_sb, offd, max_len,
      num_buckets, inv_n);
  return (int)cudaGetLastError();
}

const char* hstu_chunk_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
