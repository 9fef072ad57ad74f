// Fused HSTU pointwise attention forward for Hopper (sm_90a), plain C ABI:
// one register-tiled fp32 pass.
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
// Packed rows. With `seg_pos` [B, N] (each token's position inside its
// segment; null = one sequence per row) several sequences lie end to end in a
// row and a pair is live only inside one segment: key m >= n - seg_pos[b,n],
// the query's segment start (the TPU kernel's has_seg branch, :145-155,
// :179-181). ts_next stays the plain shift along the row, across segment
// boundaries too, as there. A packed row may be wider than L: only pairs less
// than L apart are live (in-segment pairs always are, segments being at most L
// long), so pos_w is never read outside its 2L-1 entries.
//
// What bounds it. Per live pair and head it does two products d long (q.k and
// p.v) in fp32 at the 67 TFLOP/s non-tensor peak, against the bytes of q, k,
// v and out at 3.35 TB/s. At B=4, N=1152, L=1035, H=2, d=64, packed (1.3 M
// live pairs a head) operations bound it: ~0.010 ms. At B=32, N=L=211, H=1,
// d=50 with ragged lengths both bounds are ~1 us, below a launch's own
// overhead: there the longest walk sets the time.
//
// What held the first version back (one 128-thread block per batch row and
// 16-query tile, the heads walked inside the block), and what this one does
// (the design of the backwards' pass Q, csrc/hstu_attention_bwd.cu, with p.v
// in place of dz.k and no tables to write):
//  1. Each key tile was copied in synchronously and took three block
//     barriers. Now cp.async brings tile t+1 into a second buffer while tile t
//     is computed, with one barrier a tile.
//  2. Scalar shared-memory loads: the q.k loop read a k value and four
//     broadcast q values for every 4 FMAs, and p.v the same. Now the shared
//     tile step (hstu_common.cuh, forward_tile): a lane owns 4 x 2 pairs of
//     its warp's 16 x 16 and reads its operands as float4 from rows 4 (mod 8)
//     floats apart; p goes through a per-warp array (a __syncwarp, no block
//     barrier) into 4 rows x 8 columns of the output a lane.
//  3. The output was summed in shared memory, read and written on every
//     tile. Now it stays in registers, the key slices of a row meet once in
//     shared memory in a fixed order, and each row is written once: no
//     atomics, the same bits from call to call.
//  4. Too few warps and long serial walks. Heads are on the grid now, one
//     block per (32-query tile, head, batch row): 36 x 2 x 4 = 288 blocks at
//     the packed long shape, 7 x 32 = 224 at the serving shape, about two an
//     SM. The last query tile of a 1,035-row segment walks 33 key tiles of 32
//     one after another, so with the four warps of the backwards' pass Q the
//     SMs sat latency-bound. Eight warps split a 64-key tile into four 16-key
//     slices, each warp one query half and one slice: half the serial steps,
//     twice the warps an SM, and on an H100 about 0.6 times the four-warp
//     time at the long shape (six slices were faster there, slower on packed
//     rows of 256).
//  5. The walk. A block of query rows [r0, r0 + 32) walks the 64-key tiles
//     from the earliest segment start among its valid rows (and no more than
//     L - 1 before r0) to its last valid row; a block past the length writes
//     zeros. So a packed row costs sum(segment^2), not row^2. Inside a tile a
//     warp skips its 16 x 16 pairs when none is live: rows past the length,
//     the causal corner of the diagonal tile, keys before every one of its
//     rows' segments, keys L or more behind them. The longest walks (the last
//     query tiles) go first.
//  6. Exact fp32 as before: no TF32, no --use_fast_math, the time bucket
//     through hstu::bucketize (the delta in wrapping int32, as XLA takes it)
//     and expf in silu.
//
// The TPU's 128-row pad, its [BQ, NP] Toeplitz position stripe and its
// 128-lane bucket gather exist for Mosaic's limits and are not carried over.
// q, k and v are read through their batch and row strides (column slices of
// the fused uvqk projection need no copy); out is contiguous. Depths that are
// not a multiple of 4 (d=50) are zero-padded in shared memory, and the
// padding columns are never stored.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

using hstu::kHalf;
using hstu::kLdW;
constexpr int kSlices = 4;           // 16-key slices of a streamed tile
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
  const int* ts;
  const int* lengths;
  const int* seg_pos;
  const float* pos_w;
  const float* ts_w;
  float* out;
  int b, n, h, dqk, dv;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, ts_sb, seg_sb;
  int max_len, num_buckets;
  float inv_n;
  int ld1, ld2;  // shared row strides of dqk- and dv-wide rows
  int n_tiles;
};

long long smem_floats(int ld1, int ld2, int num_buckets) {
  const long long rows = (kT + 2LL * kS) * ld1 + 2LL * kS * ld2;  // q; two stages of k and v
  return rows + kWarps * kHalf * kLdW + (num_buckets + 1) + 2LL * kT + 2LL * kS;  // p, ts_w, ints
}

// Block i: query tile n_tiles - 1 - i / (B H), so the longest walks go
// first, then batch row and head.
template <int kU>
__global__ void __launch_bounds__(kThreads, kU <= 2 ? 2 : 1)
    hstu_attention_fwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int r0 = (a.n_tiles - 1 - idx / a.b) * kT;  // first query row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 1, ws = warp >> 1;  // query half and key slice of the warp
  const int ls = lane & 7;
  const int n = a.n, L = a.max_len, nb1 = a.num_buckets + 1;
  const int ld1 = a.ld1, ld2 = a.ld2;
  const int seq_len = min(a.lengths[b], n);

  float* res1 = smem;                        // [kT][ld1] q
  float* str1 = res1 + kT * ld1;             // [2][kS][ld1] k
  float* str2 = str1 + 2 * kS * ld1;         // [2][kS][ld2] v
  float* w = str2 + 2 * kS * ld2;            // [kWarps][kHalf][kLdW] p
  float* tsw_s = w + kWarps * kHalf * kLdW;  // [nb1]
  int* res_ts = reinterpret_cast<int*>(tsw_s + nb1);  // [kT] next-item stamps of the queries
  int* res_start = res_ts + kT;              // [kT] segment start of each query row
  int* str_ts = res_start + kT;              // [2][kS]

  const int ng1 = (a.dqk + 3) / 4, ng2 = (a.dv + 3) / 4;  // 4-column groups
  int g[kU];  // the lane's output column groups, clamped for the loads
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = min(ls + 8 * u, ng2 - 1);
  const int row_lane = kHalf * wr + 4 * (lane >> 3);  // the lane's first query row in the tile

  float4 acc[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (r0 < seq_len) {
    const float* kb = a.k + b * a.k_sb + hh * a.dqk;
    const float* vb = a.v + b * a.v_sb + hh * a.dv;
    const int* tsb = a.ts + b * a.ts_sb;
    hstu::copy_rows_async<kThreads>(res1, ld1, a.q + b * a.q_sb + hh * a.dqk + r0 * a.q_sn,
                                    a.q_sn, kT, a.dqk, seq_len - r0);
    hstu::cp_async_commit();
    if (tid < kT) {
      const int row = r0 + tid;
      res_ts[tid] = tsb[min(row + 1, n - 1)];
      res_start[tid] = hstu::segment_start(a.seg_pos, b * a.seg_sb, row, seq_len);
    }
    for (int e = tid; e < nb1; e += kThreads) tsw_s[e] = a.ts_w[e];
    __syncthreads();  // res_start

    // the walk: key tiles t_lo .. t_lo + cnt - 1, from the earliest key a
    // valid row sees to the last valid row
    const int first = max(hstu::first_key_row(res_start, kT), max(r0 - L + 1, 0));
    const int t_lo = first / kS;
    const int cnt = (min(r0 + kT, seq_len) - 1) / kS - t_lo + 1;
    const int warp_first = hstu::first_key_row(res_start + kHalf * wr, kHalf);

    auto load_stream = [&](int t, int stage) {
      const int s0 = t * kS;
      hstu::copy_rows_async<kThreads>(str1 + stage * kS * ld1, ld1, kb + s0 * a.k_sn, a.k_sn,
                                      kS, a.dqk, seq_len - s0);
      hstu::copy_rows_async<kThreads>(str2 + stage * kS * ld2, ld2, vb + s0 * a.v_sn, a.v_sn,
                                      kS, a.dv, seq_len - s0);
      if (tid < kS) hstu::cp_async4(str_ts + stage * kS + tid, tsb + min(s0 + tid, n - 1));
      hstu::cp_async_commit();
    };
    load_stream(t_lo, 0);

    const int depth1 = 4 * ng1;
    const float* q_lane = res1 + row_lane * ld1;
    float* w_warp = w + warp * kHalf * kLdW;
    for (int it = 0; it < cnt; ++it) {
      hstu::cp_async_wait_all();
      // tile it has landed for every thread, and every thread is done with
      // tile it - 1, whose buffer the next copy overwrites
      __syncthreads();
      if (it + 1 < cnt) load_stream(t_lo + it + 1, (it + 1) & 1);
      const int stage = it & 1;
      // the warp's first pair
      const int n_lo = r0 + kHalf * wr, m_lo = (t_lo + it) * kS + kHalf * ws;
      // the warp's 16 x 16 pairs are skipped when none is live (the test is
      // the same for every lane): no valid row, every key after the rows,
      // before their segments or L or more behind them
      if (n_lo >= seq_len || m_lo > min(n_lo + kHalf - 1, seq_len - 1) ||
          m_lo + kHalf - 1 < warp_first || n_lo - (m_lo + kHalf - 1) >= L)
        continue;
      const int* ts_warp = str_ts + stage * kS + kHalf * ws;
      hstu::forward_tile<kU>(
          acc, q_lane, ld1, str1 + (stage * kS + kHalf * ws) * ld1,
          str2 + (stage * kS + kHalf * ws) * ld2, ld2, depth1, w_warp, a.inv_n, g,
          [&](int i, int j, float& bias) {
            const int row = r0 + row_lane + i, m = m_lo + ls + 8 * j;
            // m <= row < seq_len: causal, both inside the length
            if (m > row || row >= seq_len || row - m >= L || m < res_start[row_lane + i])
              return false;
            const int bucket = hstu::bucketize(
                (int)((unsigned int)res_ts[row_lane + i] - (unsigned int)ts_warp[ls + 8 * j]),
                a.num_buckets);
            bias = __ldg(a.pos_w + m - row + L - 1) + tsw_s[bucket];
            return true;
          });
    }
  }

  hstu::cp_async_wait_all();
  __syncthreads();  // every warp is done with the v buffers, which take the halves' sum
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = ls + 8 * u;
  hstu::store_slices<kU, kSlices>(a.out, acc, str2, ld2, row_lane, ws,
                                  ((int64_t)b * n * a.h + hh) * a.dv, r0 + row_lane, n,
                                  a.h, a.dv, g, ng2);
}

template <int kU>
int launch(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_fwd_kernel<kU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.n_tiles * a.b * a.h;
  hstu_attention_fwd_kernel<kU><<<(unsigned int)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ wide heads
//
// Heads wider than kMaxDepth (dqk or dv above 128). The kernel above holds a
// q tile and two stages of k and v as wide as the head, and a lane's 4 x 8
// output columns reach 128: at dqk = dv = 256 its shared memory alone would
// be ~300 KB, past the 227 KB a block may have. This kernel keeps its block
// (eight warps: two 16-query halves x four 16-key slices of a 64-key tile,
// 4 x 2 pairs a lane) and walks depth in slices of kSliceW = 128 columns:
//  - dqk: for each key tile the q and k columns of one slice at a time are
//    staged in shared memory, and the lane's partial q.k sums stay in
//    registers until the last slice; then silu gives p, as forward_tile does;
//  - dv: one 128-column slice of the output a block, on the grid
//    (blockIdx.y). A lane's 4 x 8-column output tile is what its registers
//    hold, so any dv runs this way; each slice's block recomputes the score
//    tile (dqk / 128 staged slices a key tile), where a loop inside the
//    block would have to keep every key tile's p, or all of dv in registers.
// Stages are single (copy, wait, barrier, compute). Shared memory is the
// same at every width (wide_smem_floats: ~94 KB at 128 buckets). It is the
// simple form of the wide path, not a fast one; widths up to 128 never reach
// it.

long long wide_smem_floats(int num_buckets) {
  const long long rows = (kT + 2LL * kS) * hstu::kLdSlice;  // q, k and v slices
  return rows + kWarps * kHalf * kLdW + (num_buckets + 1) + 2LL * kT + kS;
}

__global__ void __launch_bounds__(kThreads, 1)
    hstu_attention_fwd_wide_kernel(const __grid_constant__ Args a) {
  constexpr int kU = 4;
  constexpr int ld = hstu::kLdSlice;
  constexpr int kW = hstu::kSliceW;
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int r0 = (a.n_tiles - 1 - idx / a.b) * kT;  // first query row
  const int c0 = blockIdx.y * kW;                   // the block's output columns
  const int wv = min(kW, a.dv - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 1, ws = warp >> 1;
  const int lr = lane >> 3, ls = lane & 7;
  const int n = a.n, L = a.max_len, nb1 = a.num_buckets + 1;
  const int seq_len = min(a.lengths[b], n);
  const int n_ks = (a.dqk + kW - 1) / kW;  // depth slices of q.k

  float* qs = smem;                        // [kT][ld] q slice
  float* ks = qs + kT * ld;                // [kS][ld] k slice
  float* vs = ks + kS * ld;                // [kS][ld] v, the block's output columns
  float* w = vs + kS * ld;                 // [kWarps][kHalf][kLdW] p
  float* tsw_s = w + kWarps * kHalf * kLdW;  // [nb1]
  int* res_ts = reinterpret_cast<int*>(tsw_s + nb1);  // [kT]
  int* res_start = res_ts + kT;            // [kT]
  int* str_ts = res_start + kT;            // [kS]

  const int ngv = (wv + 3) / 4;
  int g[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = min(ls + 8 * u, ngv - 1);
  const int row_lane = kHalf * wr + 4 * lr;

  float4 acc[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (r0 < seq_len) {
    const float* qb = a.q + b * a.q_sb + hh * a.dqk + r0 * a.q_sn;
    const float* kb = a.k + b * a.k_sb + hh * a.dqk;
    const float* vb = a.v + b * a.v_sb + hh * a.dv + c0;
    const int* tsb = a.ts + b * a.ts_sb;
    if (tid < kT) {
      const int row = r0 + tid;
      res_ts[tid] = tsb[min(row + 1, n - 1)];
      res_start[tid] = hstu::segment_start(a.seg_pos, b * a.seg_sb, row, seq_len);
    }
    for (int e = tid; e < nb1; e += kThreads) tsw_s[e] = a.ts_w[e];
    __syncthreads();  // res_start

    const int first = max(hstu::first_key_row(res_start, kT), max(r0 - L + 1, 0));
    const int t_lo = first / kS;
    const int cnt = (min(r0 + kT, seq_len) - 1) / kS - t_lo + 1;
    const int warp_first = hstu::first_key_row(res_start + kHalf * wr, kHalf);
    const float* q_lane = qs + row_lane * ld;
    float* w_warp = w + warp * kHalf * kLdW;
    for (int it = 0; it < cnt; ++it) {
      const int s0 = (t_lo + it) * kS;
      const int n_lo = r0 + kHalf * wr, m_lo = s0 + kHalf * ws;
      // the warp's 16 x 16 pairs hold a live one (the forward's test)
      const bool live = !(n_lo >= seq_len || m_lo > min(n_lo + kHalf - 1, seq_len - 1) ||
                          m_lo + kHalf - 1 < warp_first || n_lo - (m_lo + kHalf - 1) >= L);
      float x[4][2] = {};
      for (int s = 0; s < n_ks; ++s) {
        const int e0 = s * kW, we = min(kW, a.dqk - e0);
        __syncthreads();  // every warp is done with what the buffers hold
        if (n_ks > 1 || it == 0)  // one slice of q stays for the whole walk
          hstu::copy_rows_async<kThreads>(qs, ld, qb + e0, a.q_sn, kT, we, seq_len - r0);
        hstu::copy_rows_async<kThreads>(ks, ld, kb + s0 * a.k_sn + e0, a.k_sn, kS, we,
                                        seq_len - s0);
        if (s == 0) {
          hstu::copy_rows_async<kThreads>(vs, ld, vb + s0 * a.v_sn, a.v_sn, kS, wv, seq_len - s0);
          if (tid < kS) str_ts[tid] = tsb[min(s0 + tid, n - 1)];
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
          const int row = r0 + row_lane + i, m = m_lo + ls + 8 * j;
          p[i] = 0.f;
          if (m <= row && row < seq_len && row - m < L && m >= res_start[row_lane + i]) {
            const int bucket = hstu::bucketize(
                (int)((unsigned int)res_ts[row_lane + i] -
                      (unsigned int)str_ts[kHalf * ws + ls + 8 * j]),
                a.num_buckets);
            const float z = x[i][j] + (__ldg(a.pos_w + m - row + L - 1) + tsw_s[bucket]);
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
  __syncthreads();  // the k and v slices (128 rows) take the key slices' sums
#pragma unroll
  for (int u = 0; u < kU; ++u) g[u] = ls + 8 * u;
  hstu::sum_slices<kU, kSlices>(acc, ks, ld, row_lane, ws, g, ngv);
  if (ws == 0)
    hstu::store_rows_at<kU>(a.out, acc, ((int64_t)b * n * a.h + hh) * a.dv + c0, r0 + row_lane,
                            n, (int64_t)a.h * a.dv, wv, g, ngv);
}

int launch_wide(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)a.n_tiles * a.b * a.h;
  const dim3 grid((unsigned int)blocks, (unsigned int)((a.dv + hstu::kSliceW - 1) / hstu::kSliceW));
  hstu_attention_fwd_wide_kernel<<<grid, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool is_wide(int dqk, int dv) { return dqk > kMaxDepth || dv > kMaxDepth; }

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (the wide kernel's above
// 128 columns).
long long hstu_attention_fwd_smem_bytes(int dqk, int dv, int num_buckets) {
  if (is_wide(dqk, dv)) return 4 * wide_smem_floats(num_buckets);
  return 4 * smem_floats(hstu::shared_ld(dqk), hstu::shared_ld(dv), num_buckets);
}

// q, k [b, n, h, dqk] and v [b, n, h, dv] float32 with heads contiguous in a
// row (batch and row strides given); ts [b, n] int32 with row stride ts_sb;
// lengths [b] int32; `seg_pos` is [b, n] int32 with row stride seg_sb, or
// null for unpacked rows; out [b, n, h, dv] contiguous, written whole. Heads
// up to 128 wide take the kernel above, wider ones the wide kernel.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int hstu_attention_fwd(const float* q, const float* k, const float* v,
                       const int* ts, const int* lengths, const int* seg_pos,
                       const float* pos_w, const float* ts_w, float* out, int b,
                       int n, int h, int dqk, int dv, long long q_sb,
                       long long q_sn, long long k_sb, long long k_sn,
                       long long v_sb, long long v_sn, long long ts_sb,
                       long long seg_sb, int max_len, int num_buckets,
                       void* stream) {
  if (dqk <= 0 || dv <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)b * n * h == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.ts = ts;
  a.lengths = lengths;
  a.seg_pos = seg_pos;
  a.pos_w = pos_w;
  a.ts_w = ts_w;
  a.out = out;
  a.b = b;
  a.n = n;
  a.h = h;
  a.dqk = dqk;
  a.dv = dv;
  a.q_sb = q_sb;
  a.q_sn = q_sn;
  a.k_sb = k_sb;
  a.k_sn = k_sn;
  a.v_sb = v_sb;
  a.v_sn = v_sn;
  a.ts_sb = ts_sb;
  a.seg_sb = seg_sb;
  a.max_len = max_len;
  a.num_buckets = num_buckets;
  a.inv_n = (float)(1.0 / (double)max_len);
  a.ld1 = hstu::shared_ld(dqk);
  a.ld2 = hstu::shared_ld(dv);
  a.n_tiles = (n + kT - 1) / kT;
  const long long smem = hstu_attention_fwd_smem_bytes(dqk, dv, num_buckets);
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_wide(dqk, dv)) return launch_wide(a, smem, st);
  return (dv + 3) / 4 <= 16 ? launch<2>(a, smem, st) : launch<4>(a, smem, st);
}

const char* hstu_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
