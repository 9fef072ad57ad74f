// Chunk HSTU attention forward of one ring step, for Hopper (sm_90a), plain
// C ABI: one register-tiled fp32 pass.
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
// clipped table slot (:144-161); a live pair has m - n + offd <= 0, so only
// the lower clip can bind. Each query row's time bias takes the next-item
// timestamp `tsq` that the caller supplies; nothing is shifted here. With
// offd >= Nq no pair is live and the output is exact zeros.
//
// What bounds it. At the ring's fully live chunk of ml-20m-hstu-long (B=32,
// 130 x 130, H=2, d=64) the function is 32 x 16,900 x 2 pairs of 2 products
// 64 long, 138 M FMA (~4 us at the 67 TFLOP/s fp32 non-tensor peak), against
// ~4.3 MB of q, k, v and out (~1.3 us at 3.35 TB/s): operations bound it, and
// a launch's own overhead is of the same order. This design computes 32 x 32
// block tiles on 16 x 16 warp tiles: 20,736 pairs for 16,900 live ones.
//
// What held the first version back (one 128-thread block per batch row and
// 16-query tile, the heads walked inside the block), and what this one does:
//  1. Each key tile was copied in synchronously and took three block
//     barriers. Now cp.async brings tile t+1 into a second buffer while tile t
//     is computed, with one barrier a tile.
//  2. Scalar shared-memory loads: the q.k loop read a k value and four
//     broadcast q values for every 4 FMAs, and p.v the same. Now the tile step
//     of the backwards' pass Q (hstu_common.cuh, forward_tile): a lane owns 4 x
//     2 pairs of its warp's 16 x 16 and reads its operands as float4 from rows
//     4 (mod 8) floats apart; p goes through a per-warp array (a __syncwarp,
//     no block barrier) into 4 rows x 8 columns of the output a lane.
//  3. The output was summed in shared memory, read and written on every
//     tile. Now it stays in registers, the two 16-key slices of a row meet
//     once in shared memory in a fixed order, and each row is written once:
//     no atomics, the same bits from call to call.
//  4. Too few blocks: 9 x 32 = 288 of ~53 KB at the 130 x 130 chunk. Now
//     heads are on the grid, one block per (32-query tile, head, batch row):
//     5 x 2 x 32 = 320 blocks of four warps and ~49 KB, all resident at once
//     (three an SM). Each warp takes one 16-query half and one 16-key slice
//     of a 32-key tile; eight warps on 64-key tiles (the full-sequence
//     forward's choice) were slower on this fully live chunk.
//  5. The walk. A block of query rows [q0, q_end) walks key tiles 0 .. (min(Nc,
//     q_end - offd) - 1) / 32, each of which holds a live pair (the TPU
//     kernel's `_live_n_kj`, :58-67, negative case included); a block whose
//     walk is empty writes zeros. Inside a tile a warp skips its 16 x 16 pairs
//     when none is live (the rows past a ragged chunk's end, the dead corner
//     of a diagonal tile). The longest walks (the last query tiles) go first.
//  6. Exact fp32 as before: no TF32, no --use_fast_math, the time bucket
//     through hstu::bucketize and expf in silu.
//
// Heads wider than 128 (dqk or dv) take the wide kernel at the end of this
// file, which stages depth in 128-column slices (see there).
//
// The TPU kernel's 128-row pad and Toeplitz position stripe exist for Mosaic
// and are not carried over. q, k and v are read through their batch and row
// strides (chunk slices of the uvqk projection need no copy), as are the two
// timestamp rows; out is contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

using hstu::kHalf;
using hstu::kLdW;
constexpr int kSlices = 2;           // 16-key slices of a streamed tile
constexpr int kWarps = 2 * kSlices;  // two 16-query halves x the slices
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 2 * kHalf;        // query rows of a block
constexpr int kS = kSlices * kHalf;  // key rows of a streamed tile
constexpr int kMaxDepth = 128;       // widest head the 4 x 8-column output tiles reach;
                                     // wider ones take the wide kernel (below)

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int* tsq;
  const int* tsk;
  const float* pos_w;
  const float* ts_w;
  float* out;
  int b, nq, nc, h, dqk, dv;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, tsq_sb, tsk_sb;
  int offd, max_len, num_buckets;
  float inv_n;
  int ld1, ld2;  // shared row strides of dqk- and dv-wide rows
  int nq_tiles;
};

long long smem_floats(int ld1, int ld2, int num_buckets) {
  const long long rows = (kT + 2LL * kS) * ld1 + 2LL * kS * ld2;  // q; two stages of k and v
  return rows + kWarps * kHalf * kLdW + (num_buckets + 1) + kT + 2LL * kS;  // p, ts_w, stamps
}

// Block i: query tile nq_tiles - 1 - i / (B H), so the longest walks go
// first, then batch row and head.
template <int kU>
__global__ void __launch_bounds__(kThreads, kU <= 2 ? 3 : 2)
    hstu_chunk_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int r0 = (a.nq_tiles - 1 - idx / a.b) * kT;  // first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 1, ws = warp >> 1;  // query half and key slice of the warp
  const int ls = lane & 7;
  const int nq = a.nq, nc = a.nc, offd = a.offd, L = a.max_len, nb1 = a.num_buckets + 1;
  const int ld1 = a.ld1, ld2 = a.ld2;

  float* res1 = smem;                        // [kT][ld1] q
  float* str1 = res1 + kT * ld1;             // [2][kS][ld1] k
  float* str2 = str1 + 2 * kS * ld1;         // [2][kS][ld2] v
  float* w = str2 + 2 * kS * ld2;            // [kWarps][kHalf][kLdW] p
  float* tsw_s = w + kWarps * kHalf * kLdW;  // [nb1]
  int* res_ts = reinterpret_cast<int*>(tsw_s + nb1);  // [kT]
  int* str_ts = res_ts + kT;                 // [2][kS]

  const int ng1 = (a.dqk + 3) / 4, ng2 = (a.dv + 3) / 4;  // 4-column groups
  int g[kU];  // the lane's output column groups, clamped for the loads
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = min(ls + 8 * u, ng2 - 1);
  const int row_lane = kHalf * wr + 4 * (lane >> 3);  // the lane's first query row in the tile

  // the walk: key tiles 0 .. cnt - 1, up to the last key that query q_end - 1 sees
  const int q_end = min(r0 + kT, nq);
  const int keys = min(nc, q_end - offd);
  const int cnt = keys > 0 ? (keys - 1) / kS + 1 : 0;

  float4 acc[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (cnt > 0) {
    const float* kb = a.k + b * a.k_sb + hh * a.dqk;
    const float* vb = a.v + b * a.v_sb + hh * a.dv;
    const int* tsqb = a.tsq + b * a.tsq_sb;
    const int* tskb = a.tsk + b * a.tsk_sb;
    hstu::copy_rows_async<kThreads>(res1, ld1, a.q + b * a.q_sb + hh * a.dqk + r0 * a.q_sn,
                                    a.q_sn, kT, a.dqk, nq - r0);
    hstu::cp_async_commit();
    if (tid < kT) res_ts[tid] = tsqb[min(r0 + tid, nq - 1)];
    for (int e = tid; e < nb1; e += kThreads) tsw_s[e] = a.ts_w[e];

    auto load_stream = [&](int t, int stage) {
      const int s0 = t * kS;
      hstu::copy_rows_async<kThreads>(str1 + stage * kS * ld1, ld1, kb + s0 * a.k_sn, a.k_sn,
                                      kS, a.dqk, nc - s0);
      hstu::copy_rows_async<kThreads>(str2 + stage * kS * ld2, ld2, vb + s0 * a.v_sn, a.v_sn,
                                      kS, a.dv, nc - s0);
      if (tid < kS) hstu::cp_async4(str_ts + stage * kS + tid, tskb + min(s0 + tid, nc - 1));
      hstu::cp_async_commit();
    };
    load_stream(0, 0);

    const int depth1 = 4 * ng1;
    const float* q_lane = res1 + row_lane * ld1;
    float* w_warp = w + warp * kHalf * kLdW;
    for (int it = 0; it < cnt; ++it) {
      hstu::cp_async_wait_all();
      // tile it has landed for every thread (and the set-up above is
      // visible), and every thread is done with tile it - 1, whose buffer
      // the next copy overwrites
      __syncthreads();
      if (it + 1 < cnt) load_stream(it + 1, (it + 1) & 1);
      const int stage = it & 1;
      const int n_lo = r0 + kHalf * wr, m_lo = it * kS + kHalf * ws;  // the warp's first pair
      // the warp's 16 x 16 pairs are skipped when none is live (the test is
      // the same for every lane)
      if (n_lo >= nq || m_lo >= nc || min(n_lo + kHalf - 1, nq - 1) - m_lo < offd) continue;
      const int* ts_warp = str_ts + stage * kS + kHalf * ws;
      hstu::forward_tile<kU>(
          acc, q_lane, ld1, str1 + (stage * kS + kHalf * ws) * ld1,
          str2 + (stage * kS + kHalf * ws) * ld2, ld2, depth1, w_warp, a.inv_n, g,
          [&](int i, int j, float& bias) {
            const int n = r0 + row_lane + i, m = m_lo + ls + 8 * j;
            if (n - m < offd || n >= nq || m >= nc) return false;
            const int bucket = hstu::bucketize(
                (int)((unsigned int)res_ts[row_lane + i] - (unsigned int)ts_warp[ls + 8 * j]),
                a.num_buckets);
            bias = __ldg(a.pos_w + max(m - n + offd + L - 1, 0)) + tsw_s[bucket];
            return true;
          });
    }
  }

  hstu::cp_async_wait_all();
  __syncthreads();  // every warp is done with the v buffers, which take the halves' sum
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = ls + 8 * u;
  hstu::store_slices<kU, kSlices>(a.out, acc, str2, ld2, row_lane, ws,
                                  ((int64_t)b * nq * a.h + hh) * a.dv, r0 + row_lane, nq,
                                  a.h, a.dv, g, ng2);
}

template <int kU>
int launch(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_chunk_fwd_kernel<kU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.nq_tiles * a.b * a.h;
  hstu_chunk_fwd_kernel<kU><<<(unsigned int)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ wide heads
//
// Heads wider than kMaxDepth (dqk or dv above 128). The kernel above holds a
// q tile and two stages of k and v as wide as the head, and a lane's 4 x 8
// output columns reach 128: at dqk = dv = 256 that is ~100 KB of rows, and
// the output tile no longer fits a lane's registers. This kernel keeps the
// block above (four warps: two 16-query halves x two 16-key slices of a
// 32-key tile, 4 x 2 pairs a lane), its walk and its live-pair tests, and
// walks depth in slices of kSliceW = 128 columns, as the full-sequence
// forward's wide kernel (csrc/hstu_attention_fwd.cu) does:
//  - dqk: for each key tile the q and k columns of one slice at a time are
//    staged in shared memory, and the lane's partial q.k sums stay in
//    registers until the last slice; then silu gives p;
//  - dv: one 128-column slice of the output a block, on the grid
//    (blockIdx.y). Each slice's block recomputes the score tile (dqk / 128
//    staged slices a key tile), where one block would have to keep every
//    key tile's p, or all of dv in registers.
// Stages are single (copy, wait, barrier, compute). Shared memory is the
// same at every width (wide_smem_floats: ~57 KB at 128 buckets). The two
// key slices of a row meet once in shared memory in a fixed order and each
// row is written once, as above: no atomics, the same bits from call to call.
// It is the simple form of the wide path, not a fast one; widths up to 128
// never reach it.

long long wide_smem_floats(int num_buckets) {
  const long long rows = (kT + 2LL * kS) * hstu::kLdSlice;  // q, k and v slices
  return rows + kWarps * kHalf * kLdW + (num_buckets + 1) + kT + kS;
}

__global__ void __launch_bounds__(kThreads, 2)
    hstu_chunk_fwd_wide_kernel(const __grid_constant__ Args a) {
  constexpr int kU = 4;
  constexpr int ld = hstu::kLdSlice;
  constexpr int kW = hstu::kSliceW;
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int r0 = (a.nq_tiles - 1 - idx / a.b) * kT;  // first query row
  const int c0 = blockIdx.y * kW;                    // the block's output columns
  const int wv = min(kW, a.dv - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 1, ws = warp >> 1;  // query half and key slice of the warp
  const int lr = lane >> 3, ls = lane & 7;
  const int nq = a.nq, nc = a.nc, offd = a.offd, L = a.max_len, nb1 = a.num_buckets + 1;
  const int n_ks = (a.dqk + kW - 1) / kW;  // depth slices of q.k

  float* qs = smem;                          // [kT][ld] q slice
  float* ks = qs + kT * ld;                  // [kS][ld] k slice
  float* vs = ks + kS * ld;                  // [kS][ld] v, the block's output columns
  float* w = vs + kS * ld;                   // [kWarps][kHalf][kLdW] p
  float* tsw_s = w + kWarps * kHalf * kLdW;  // [nb1]
  int* res_ts = reinterpret_cast<int*>(tsw_s + nb1);  // [kT]
  int* str_ts = res_ts + kT;                 // [kS]

  const int ngv = (wv + 3) / 4;
  int g[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = min(ls + 8 * u, ngv - 1);
  const int row_lane = kHalf * wr + 4 * lr;

  // the walk, as the kernel above takes it
  const int q_end = min(r0 + kT, nq);
  const int keys = min(nc, q_end - offd);
  const int cnt = keys > 0 ? (keys - 1) / kS + 1 : 0;

  float4 acc[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (cnt > 0) {
    const float* qb = a.q + b * a.q_sb + hh * a.dqk + r0 * a.q_sn;
    const float* kb = a.k + b * a.k_sb + hh * a.dqk;
    const float* vb = a.v + b * a.v_sb + hh * a.dv + c0;
    const int* tsqb = a.tsq + b * a.tsq_sb;
    const int* tskb = a.tsk + b * a.tsk_sb;
    if (tid < kT) res_ts[tid] = tsqb[min(r0 + tid, nq - 1)];
    for (int e = tid; e < nb1; e += kThreads) tsw_s[e] = a.ts_w[e];

    const float* q_lane = qs + row_lane * ld;
    float* w_warp = w + warp * kHalf * kLdW;
    for (int it = 0; it < cnt; ++it) {
      const int s0 = it * kS;
      const int n_lo = r0 + kHalf * wr, m_lo = s0 + kHalf * ws;  // the warp's first pair
      // the warp's 16 x 16 pairs hold a live one (the test above)
      const bool live =
          !(n_lo >= nq || m_lo >= nc || min(n_lo + kHalf - 1, nq - 1) - m_lo < offd);
      float x[4][2] = {};
      for (int s = 0; s < n_ks; ++s) {
        const int e0 = s * kW, we = min(kW, a.dqk - e0);
        __syncthreads();  // every warp is done with what the buffers hold
        if (n_ks > 1 || it == 0)  // one slice of q stays for the whole walk
          hstu::copy_rows_async<kThreads>(qs, ld, qb + e0, a.q_sn, kT, we, nq - r0);
        hstu::copy_rows_async<kThreads>(ks, ld, kb + s0 * a.k_sn + e0, a.k_sn, kS, we, nc - s0);
        if (s == 0) {
          hstu::copy_rows_async<kThreads>(vs, ld, vb + s0 * a.v_sn, a.v_sn, kS, wv, nc - s0);
          if (tid < kS) str_ts[tid] = tskb[min(s0 + tid, nc - 1)];
        }
        hstu::cp_async_commit();
        hstu::cp_async_wait_all();
        __syncthreads();
        if (live)
          hstu::dot_tile(x, q_lane, ld, ks + (kHalf * ws + ls) * ld, ld, 4 * ((we + 3) / 4));
      }
      if (!live) continue;
      // p of the lane's pairs into the warp's array, then out += p v
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = r0 + row_lane + i, m = m_lo + ls + 8 * j;
          p[i] = 0.f;
          if (n - m >= offd && n < nq && m < nc) {
            const int bucket = hstu::bucketize(
                (int)((unsigned int)res_ts[row_lane + i] -
                      (unsigned int)str_ts[kHalf * ws + ls + 8 * j]),
                a.num_buckets);
            // live: m - n + offd <= 0, so only the lower clip can bind
            const float z =
                x[i][j] + (__ldg(a.pos_w + max(m - n + offd + L - 1, 0)) + tsw_s[bucket]);
            p[i] = z / (1.f + expf(-z)) * a.inv_n;
          }
        }
        *reinterpret_cast<float4*>(w_warp + (ls + 8 * j) * kLdW + 4 * lr) =
            make_float4(p[0], p[1], p[2], p[3]);
      }
      __syncwarp();
      hstu::accumulate_rows<kU>(acc, w_warp + 4 * lr, vs + kHalf * ws * ld, ld, g);
      __syncwarp();
    }
  }

  hstu::cp_async_wait_all();
  __syncthreads();  // the k slice (32 rows) takes key slice 1's sums
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = ls + 8 * u;
  hstu::sum_slices<kU, kSlices>(acc, ks, ld, row_lane, ws, g, ngv);
  if (ws == 0)
    hstu::store_rows_at<kU>(a.out, acc, ((int64_t)b * nq * a.h + hh) * a.dv + c0,
                            r0 + row_lane, nq, (int64_t)a.h * a.dv, wv, g, ngv);
}

int launch_wide(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_chunk_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.nq_tiles * a.b * a.h;
  const dim3 grid((unsigned int)blocks, (unsigned int)((a.dv + hstu::kSliceW - 1) / hstu::kSliceW));
  hstu_chunk_fwd_wide_kernel<<<grid, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool is_wide(int dqk, int dv) { return dqk > kMaxDepth || dv > kMaxDepth; }

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (the wide kernel's above
// 128 columns).
long long hstu_chunk_fwd_smem_bytes(int dqk, int dv, int num_buckets) {
  if (is_wide(dqk, dv)) return 4 * wide_smem_floats(num_buckets);
  return 4 * smem_floats(hstu::shared_ld(dqk), hstu::shared_ld(dv), num_buckets);
}

// q [b, nq, h, dqk], k [b, nc, h, dqk], v [b, nc, h, dv] float32 with heads
// contiguous in a row (batch and row strides given); tsq [b, nq] and tsk
// [b, nc] int32 with the row strides given; out [b, nq, h, dv] contiguous,
// written whole. Heads up to 128 wide take the kernel above, wider ones the
// wide kernel. Launches on `stream` without synchronising; returns
// cudaGetLastError().
int hstu_chunk_fwd(const float* q, const float* k, const float* v,
                   const int* tsq, const int* tsk, const float* pos_w,
                   const float* ts_w, float* out, int b, int nq, int nc, int h,
                   int dqk, int dv, long long q_sb, long long q_sn,
                   long long k_sb, long long k_sn, long long v_sb,
                   long long v_sn, long long tsq_sb, long long tsk_sb,
                   int offd, int max_len, int num_buckets, float inv_n,
                   void* stream) {
  if (dqk <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)b * nq * h == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.tsq = tsq;
  a.tsk = tsk;
  a.pos_w = pos_w;
  a.ts_w = ts_w;
  a.out = out;
  a.b = b;
  a.nq = nq;
  a.nc = nc;
  a.h = h;
  a.dqk = dqk;
  a.dv = dv;
  a.q_sb = q_sb;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_sn = v_sn;
  a.tsq_sb = tsq_sb;
  a.tsk_sb = tsk_sb;
  a.offd = offd;
  a.max_len = max_len;
  a.num_buckets = num_buckets;
  a.inv_n = inv_n;
  a.ld1 = hstu::shared_ld(dqk);
  a.ld2 = hstu::shared_ld(dv);
  a.nq_tiles = (nq + kT - 1) / kT;
  const long long smem = hstu_chunk_fwd_smem_bytes(dqk, dv, num_buckets);
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_wide(dqk, dv)) return launch_wide(a, smem, st);
  return (dv + 3) / 4 <= 16 ? launch<2>(a, smem, st) : launch<4>(a, smem, st);
}

const char* hstu_chunk_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
