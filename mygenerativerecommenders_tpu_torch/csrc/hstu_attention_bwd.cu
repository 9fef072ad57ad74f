// Fused HSTU pointwise attention backward for Hopper (sm_90a), plain C ABI:
// two deterministic register-tiled fp32 passes in one launch.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_attention.py:425
// (`_bwd_fused_kernel`, launched from `_fused_bwd_impl` through the
// pallas_call at :763; `_dtw_from_dz`, :635, finishes d_ts_w there for short
// sequences). Like that kernel it keeps nothing [N, N]-shaped from the
// forward: it recomputes, for every live pair (query row m < len_b, key
// n <= m, m - n < L),
//
//   z   = q[b,m,h].k[b,n,h] + pos_w[n-m+L-1] + ts_w[bucket(ts_next[b,m] - ts[b,n])]
//   sig = sigmoid(z),  p = z sig / L,  dp = g[b,m,h].v[b,n,h]
//   dz  = dp (sig + z sig (1 - sig)) / L
//
// and from these  dq[m] = sum_n dz k[n],  dk[n] = sum_m dz q[m],
// dv[n] = sum_m p g[m],  d_pos_w[n-m+L-1] += dz,  d_ts_w[bucket] += dz.
// Rows at or past len_b come out exactly zero in dq, dk and dv.
//
// Packed rows. With `seg_pos` [B, N] (null = one sequence per row) a pair is
// live only inside one segment, n >= m - seg_pos[b,m], as in the forward (the
// TPU kernel's has_seg branch, :445-473, :513-514): p and dz are masked
// alike, so every gradient sees in-segment pairs only. Only pairs less than L
// apart are live, so a row wider than L (a packed row) neither reads pos_w
// nor writes the [L] diagonal array out of range.
//
// What bounds it. PERF.md section 6 row 2 counts 5 products of d-long dot
// products per live pair and head (q.k, g.v, dz k, dz q, p g) in fp32 at the
// 67 TFLOP/s non-tensor peak, against the bytes of q, k, v, g, dq, dk, dv at
// 3.35 TB/s. At B=4, N=1152, L=1035, H=2, d=64, packed (1.3 M live pairs a
// head), operations bound it: ~0.025 ms. At B=128, N=L=211, H=1, d=50 with
// ragged lengths (~0.95 M pairs) the two are within 15% (~8 us of bytes,
// ~7 us of operations). This design computes q.k and g.v in both passes,
// 7 products a pair, so its own least time is 1.4 times the operation bound.
//
// What held the single-pass version back, and what this one does about it:
//  1. Float atomics into dk and dv for every key tile (and a zero fill
//     before the launch), which also made dk and dv change in their last
//     bits from run to run. Now two passes (the FlashAttention-2 split), each
//     owning its outputs: pass K, one block per (32-key tile, head, batch
//     row), keeps its k and v tile in shared memory and dk, dv in registers,
//     walks the 32-query tiles that can see its keys, recomputes z, p and dz
//     and writes dk and dv once; pass Q, one block per (32-query tile, head,
//     batch row), walks the key tiles its queries can see, keeps dq in
//     registers and writes it once, and sums the two table gradients in
//     shared memory (a [L] diagonal array and a [num_buckets+1] histogram,
//     one atomic per touched entry per block into d_pos_w and d_ts_w). dq, dk
//     and dv take no atomics and no zero fill: every sum runs in a fixed
//     order, so they are bit-identical from run to run. Only the table
//     gradients keep float atomics (order free, last bits vary).
//  2. Scalar shared-memory loads, ~5 for every 4 FMAs. Now register tiles:
//     each warp owns 16 resident rows x 16 rows of the streamed tile; a lane
//     owns 4 x 2 of those pairs and reads its operands as float4 along the
//     depth (4 resident + 2 streamed loads for 32 FMAs a product). Rows are
//     stored with a stride of 4 (mod 8) floats, so the 8 lanes of a
//     quarter-warp read 8 consecutive rows from 8 distinct bank groups, and
//     the resident loads are broadcasts. The second product of a pass (dz k,
//     dz q, p g) reads dz or p of the warp's own 16 x 16 pairs back from a
//     per-warp shared array (a __syncwarp, no block barrier) and keeps 4 rows
//     x 8 columns of each output a lane (3 loads for 32 FMAs).
//  3. No overlap of copy and compute, and three barriers a tile. Now
//     cp.async (16-byte .cg copies where the source is aligned, 4-byte ones
//     otherwise: q, k, v are column slices of the uvqk projection) brings
//     tile t+1 into a second buffer while tile t is computed, with one block
//     barrier a tile.
//  4. Too few blocks (36 x 4 at the long shape, ~104 KB of shared memory
//     each, one block an SM). Now heads are on the grid and the two passes
//     share one launch: 36 tiles x 2 heads x 4 rows x 2 passes = 576 blocks
//     at the long shape, ~69 KB each (three blocks an SM; nvcc -Xptxas -v:
//     166 registers, no spills for heads up to 64 wide), 1,792 at the
//     padded one. The walks of uneven length (the causal triangle) are
//     launched longest first: pass Q's tiles in reverse, pass K's in order,
//     interleaved.
//  5. Exact fp32 as before: no TF32, no --use_fast_math, the time bucket
//     through hstu::bucketize (logf and IEEE division, the forward's bits)
//     and expf in the sigmoid.
//
// q, k and v are read through their row strides; g, dq, dk and dv are
// contiguous [B, N, H, d].

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
using hstu::kHalf;
using hstu::kLdW;
constexpr int kT = 2 * kHalf;   // rows of a tile, resident or streamed
constexpr int kMaxDepth = 128;  // widest head the 4 x 8-column output tiles reach;
                                // wider ones take the wide kernel (below)

using hstu::accumulate_rows;
using hstu::dot_tile;
using hstu::shared_ld;
using hstu::store_rows;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const int* ts;
  const int* lengths;
  const int* seg_pos;
  const float* pos_w;
  const float* ts_w;
  float* dq;
  float* dk;
  float* dv;
  float* dpw;
  float* dtw;
  int b, n, h, dqk, dvh;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, ts_sb, seg_sb;
  int max_len, num_buckets;
  float inv_n;
  int ld1, ld2;  // shared row strides of dqk- and dv-wide rows
  int n_tiles;
};

long long smem_floats(int ld1, int ld2, int max_len, int num_buckets, int n_tiles) {
  const long long rows = 3LL * kT * (ld1 + ld2);       // resident + two streamed stages
  const long long w = 2LL * kWarps * kHalf * kLdW;     // dz and p of each warp's pairs
  const long long tables = 2LL * (num_buckets + 1) + max_len;
  const long long ints = 6LL * kT + n_tiles + 1;
  return rows + w + tables + ints;
}

// One block of pass K (kPassK: resident keys, streamed queries; writes dk,
// dv) or pass Q (resident queries, streamed keys; writes dq and adds into
// d_pos_w and d_ts_w) for resident tile `tile` of batch row b, head hh.
template <bool kPassK, int kU>
__device__ __forceinline__ void run_pass(const Args& a, float* smem, int tile, int b,
                                         int hh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, ws = warp & 1;  // resident and streamed half of the warp
  const int lr = lane >> 3, ls = lane & 7;
  const int n = a.n, L = a.max_len, nb1 = a.num_buckets + 1;
  const int ld1 = a.ld1, ld2 = a.ld2;
  const int seq_len = min(a.lengths[b], n);
  const int r0 = tile * kT;  // first resident row
  const int hv = a.h * a.dvh;

  // side 1 is dqk wide (q or k), side 2 dv wide (g or v)
  const float* qb = a.q + b * a.q_sb + hh * a.dqk;
  const float* kb = a.k + b * a.k_sb + hh * a.dqk;
  const float* vb = a.v + b * a.v_sb + hh * a.dvh;
  const float* gb = a.g + (int64_t)b * n * hv + hh * a.dvh;
  const float* res1_src = kPassK ? kb : qb;
  const float* res2_src = kPassK ? vb : gb;
  const int64_t res1_sn = kPassK ? a.k_sn : a.q_sn;
  const int64_t res2_sn = kPassK ? a.v_sn : hv;
  const float* str1_src = kPassK ? qb : kb;
  const float* str2_src = kPassK ? gb : vb;
  const int64_t str1_sn = kPassK ? a.q_sn : a.k_sn;
  const int64_t str2_sn = kPassK ? hv : a.v_sn;
  const int* tsb = a.ts + b * a.ts_sb;
  const int* segb = a.seg_pos ? a.seg_pos + b * a.seg_sb : nullptr;

  float* res1 = smem;                               // [kT][ld1]
  float* res2 = res1 + kT * ld1;                    // [kT][ld2]
  float* str1 = res2 + kT * ld2;                    // [2][kT][ld1]
  float* str2 = str1 + 2 * kT * ld1;                // [2][kT][ld2]
  float* w1 = str2 + 2 * kT * ld2;                  // [kWarps][kHalf][kLdW] dz
  float* w2 = w1 + kWarps * kHalf * kLdW;           // [kWarps][kHalf][kLdW] p (pass K)
  float* tsw_s = w2 + kWarps * kHalf * kLdW;        // [nb1]
  float* hist_s = tsw_s + nb1;                      // [nb1] d_ts_w of this block
  float* diag_s = hist_s + nb1;                     // [L] d_pos_w by m - n
  int* res_ts = reinterpret_cast<int*>(diag_s + L);  // [kT]
  int* res_start = res_ts + kT;                     // [kT] segment start of query rows
  int* str_ts = res_start + kT;                     // [2][kT]
  int* str_seg = str_ts + 2 * kT;                   // [2][kT] seg_pos of query rows
  int* tiles_s = str_seg + 2 * kT;                  // [n_tiles + 1] the walk, then its length

  const int ng1 = (a.dqk + 3) / 4, ng2 = (a.dvh + 3) / 4;  // 4-column groups
  int g1[kU], g2[kU];  // this lane's groups, clamped for the loads
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = ls + 8 * u;
    g2[u] = ls + 8 * u;
  }
  const int row_lane = 16 * wr + 4 * lr;  // the lane's first resident row in the tile
  const int64_t out1_base = ((int64_t)b * n * a.h + hh) * a.dqk;
  const int64_t out2_base = ((int64_t)b * n * a.h + hh) * a.dvh;

  if (r0 >= seq_len) {
    // every pair of the tile is dead: the rows are zero
    float4 zero[4][kU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u) zero[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ws == 0) {
      float* out1 = kPassK ? a.dk : a.dq;
      store_rows<kU>(out1, zero, out1_base, r0 + row_lane, n, a.h, a.dqk, g1, ng1);
      if (kPassK) store_rows<kU>(a.dv, zero, out2_base, r0 + row_lane, n, a.h, a.dvh, g2, ng2);
    }
    return;
  }

  // the resident tile and its timestamps (and, for queries, segment starts)
  hstu::copy_rows_async<kThreads>(res1, ld1, res1_src + r0 * res1_sn, res1_sn, kT,
                                  a.dqk, seq_len - r0);
  hstu::copy_rows_async<kThreads>(res2, ld2, res2_src + r0 * res2_sn, res2_sn, kT,
                                  a.dvh, seq_len - r0);
  hstu::cp_async_commit();
  if (tid < kT) {
    const int row = r0 + tid;
    res_ts[tid] = tsb[kPassK ? min(row, n - 1) : min(row + 1, n - 1)];
    if (!kPassK) res_start[tid] = hstu::segment_start(a.seg_pos, b * a.seg_sb, row, seq_len);
  }
  for (int e = tid; e < nb1; e += kThreads) {
    tsw_s[e] = a.ts_w[e];
    hist_s[e] = 0.f;
  }
  const int diag_hi = min(L, r0 + kT);  // m - n < r0 + kT in this tile's pairs
  if (!kPassK)
    for (int e = tid; e < diag_hi; e += kThreads) diag_s[e] = 0.f;

  // The walk: the streamed tiles that hold live pairs for this tile.
  const int res_last = min(r0 + kT, seq_len) - 1;  // last valid resident row
  int t_lo, t_hi;
  if (kPassK) {
    // queries from the first key on, less than L past the last key
    t_lo = r0 / kT;
    t_hi = min(seq_len - 1, res_last + L - 1) / kT;
  } else {
    __syncthreads();  // res_start
    const int first = max(hstu::first_key_row(res_start, kT), max(r0 - L + 1, 0));
    t_lo = first / kT;
    t_hi = res_last / kT;
  }
  for (int t = t_lo + warp; t <= t_hi; t += kWarps) {
    bool live = true;
    if (kPassK && segb != nullptr) {
      // a query tile is skipped when every valid row's segment starts past
      // this tile's last key
      const int m = t * kT + lane;
      const int start = m < seq_len ? m - segb[m] : INT_MAX;
      live = __reduce_min_sync(0xffffffffu, (unsigned int)max(start, 0)) <= (unsigned int)res_last;
    }
    if (lane == 0) tiles_s[t - t_lo] = live ? t : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    for (int t = 0; t <= t_hi - t_lo; ++t)
      if (tiles_s[t] >= 0) tiles_s[cnt++] = tiles_s[t];
    tiles_s[a.n_tiles] = cnt;
  }
  __syncthreads();
  const int cnt = tiles_s[a.n_tiles];

  auto load_stream = [&](int t, int stage) {
    const int s0 = t * kT;
    hstu::copy_rows_async<kThreads>(str1 + stage * kT * ld1, ld1, str1_src + s0 * str1_sn,
                                    str1_sn, kT, a.dqk, seq_len - s0);
    hstu::copy_rows_async<kThreads>(str2 + stage * kT * ld2, ld2, str2_src + s0 * str2_sn,
                                    str2_sn, kT, a.dvh, seq_len - s0);
    if (tid < kT) {
      const int row = s0 + tid;
      hstu::cp_async4(str_ts + stage * kT + tid,
                      tsb + (kPassK ? min(row + 1, n - 1) : min(row, n - 1)));
      if (kPassK && segb != nullptr)
        hstu::cp_async4(str_seg + stage * kT + tid, segb + min(row, n - 1));
    }
    hstu::cp_async_commit();
  };
  if (cnt > 0) load_stream(tiles_s[0], 0);

  float4 acc1[4][kU], acc2[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      acc1[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc2[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  int run_bucket = -1;  // pass Q: d_ts_w of the lane's pairs, summed while the bucket holds
  float run_sum = 0.f;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = min(g1[u], ng1 - 1);
    g2[u] = min(g2[u], ng2 - 1);
  }
  const int depth1 = 4 * ng1, depth2 = 4 * ng2;
  float* w1_warp = w1 + warp * kHalf * kLdW;
  float* w2_warp = w2 + warp * kHalf * kLdW;

  for (int it = 0; it < cnt; ++it) {
    hstu::cp_async_wait_all();
    // tile it has landed for every thread, and every thread is done with
    // tile it - 1, whose buffer the next copy overwrites
    __syncthreads();
    if (it + 1 < cnt) load_stream(tiles_s[it + 1], (it + 1) & 1);
    const int stage = it & 1;
    const int s0 = tiles_s[it] * kT;
    const float* s1 = str1 + stage * kT * ld1 + (kHalf * ws) * ld1;  // the warp's streamed rows
    const float* s2 = str2 + stage * kT * ld2 + (kHalf * ws) * ld2;

    // scores of the lane's pairs (resident row_lane + i, streamed 16 ws + ls + 8 j)
    float x[4][2] = {}, y[4][2] = {};
    dot_tile(x, res1 + row_lane * ld1, ld1, s1 + ls * ld1, ld1, depth1);
    dot_tile(y, res2 + row_lane * ld2, ld2, s2 + ls * ld2, ld2, depth2);

    float dz[4][2], pz[4][2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sl = kHalf * ws + ls + 8 * j;  // streamed row in the tile
      const int srow = s0 + sl;
      const int s_ts = str_ts[stage * kT + sl];
      int s_start = 0;
      if (kPassK && segb != nullptr) s_start = srow < seq_len ? srow - str_seg[stage * kT + sl] : INT_MAX;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rrow = r0 + row_lane + i;
        const int m = kPassK ? srow : rrow;      // query
        const int key = kPassK ? rrow : srow;
        const int start = kPassK ? s_start : res_start[row_lane + i];
        const bool live = key <= m && m < seq_len && m - key < L && key >= start;
        dz[i][j] = 0.f;
        pz[i][j] = 0.f;
        if (live) {
          const int ts_m = kPassK ? s_ts : res_ts[row_lane + i];
          const int ts_k = kPassK ? res_ts[row_lane + i] : s_ts;
          const int bucket =
              hstu::bucketize((int)((unsigned int)ts_m - (unsigned int)ts_k), a.num_buckets);
          const float z = x[i][j] + (__ldg(a.pos_w + key - m + L - 1) + tsw_s[bucket]);
          const float sig = 1.f / (1.f + expf(-z));
          pz[i][j] = z * sig * a.inv_n;
          dz[i][j] = y[i][j] * (sig + z * sig * (1.f - sig)) * a.inv_n;
          if (!kPassK) {
            atomicAdd(&diag_s[m - key], dz[i][j]);
            if (bucket != run_bucket) {
              if (run_bucket >= 0) atomicAdd(&hist_s[run_bucket], run_sum);
              run_bucket = bucket;
              run_sum = 0.f;
            }
            run_sum += dz[i][j];
          }
        }
      }
      // dz (and p) of the lane's pairs, streamed-row major, for the second product
      *reinterpret_cast<float4*>(w1_warp + (ls + 8 * j) * kLdW + 4 * lr) =
          make_float4(dz[0][j], dz[1][j], dz[2][j], dz[3][j]);
      if (kPassK)
        *reinterpret_cast<float4*>(w2_warp + (ls + 8 * j) * kLdW + 4 * lr) =
            make_float4(pz[0][j], pz[1][j], pz[2][j], pz[3][j]);
    }
    __syncwarp();
    // pass Q: dq += dz k; pass K: dk += dz^T q, dv += p^T g
    accumulate_rows<kU>(acc1, w1_warp + 4 * lr, s1, ld1, g1);
    if (kPassK) accumulate_rows<kU>(acc2, w2_warp + 4 * lr, s2, ld2, g2);
    __syncwarp();  // the next tile's dz and p overwrite what the lanes read
  }
  if (!kPassK && run_bucket >= 0) atomicAdd(&hist_s[run_bucket], run_sum);

  // The two streamed halves of each resident row meet in shared memory
  // (the stream buffers, free now), half 1 first, so the sum has one order.
  hstu::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = ls + 8 * u;
    g2[u] = ls + 8 * u;
  }
  float* red1 = str1;  // [kT][ld1]
  float* red2 = str2;  // [kT][ld2]
  if (ws == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (g1[u] < ng1)
          *reinterpret_cast<float4*>(red1 + (row_lane + i) * ld1 + 4 * g1[u]) = acc1[i][u];
        if (kPassK && g2[u] < ng2)
          *reinterpret_cast<float4*>(red2 + (row_lane + i) * ld2 + 4 * g2[u]) = acc2[i][u];
      }
  }
  __syncthreads();
  if (ws == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (g1[u] < ng1) {
          const float4 o = *reinterpret_cast<const float4*>(red1 + (row_lane + i) * ld1 + 4 * g1[u]);
          acc1[i][u].x += o.x;
          acc1[i][u].y += o.y;
          acc1[i][u].z += o.z;
          acc1[i][u].w += o.w;
        }
        if (kPassK && g2[u] < ng2) {
          const float4 o = *reinterpret_cast<const float4*>(red2 + (row_lane + i) * ld2 + 4 * g2[u]);
          acc2[i][u].x += o.x;
          acc2[i][u].y += o.y;
          acc2[i][u].z += o.z;
          acc2[i][u].w += o.w;
        }
      }
    store_rows<kU>(kPassK ? a.dk : a.dq, acc1, out1_base, r0 + row_lane, n, a.h, a.dqk, g1, ng1);
    if (kPassK) store_rows<kU>(a.dv, acc2, out2_base, r0 + row_lane, n, a.h, a.dvh, g2, ng2);
  }
  if (!kPassK) {
    // the block's table gradients: one atomic per touched entry
    for (int e = tid; e < diag_hi; e += kThreads) {
      const float x = diag_s[e];
      if (x != 0.f) atomicAdd(&a.dpw[L - 1 - e], x);
    }
    for (int e = tid; e < nb1; e += kThreads) {
      const float x = hist_s[e];
      if (x != 0.f) atomicAdd(&a.dtw[e], x);
    }
  }
}

// Block i: rank i / (2 B H) of its pass, the longest walks first (pass Q's
// last query tiles, pass K's first key tiles), then batch row, head and pass.
template <int kU>
__global__ void __launch_bounds__(kThreads, 3) hstu_attention_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const bool pass_k = idx & 1;
  idx >>= 1;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int rank = idx / a.b;
  if (pass_k)
    run_pass<true, kU>(a, smem, rank, b, hh);
  else
    run_pass<false, kU>(a, smem, a.n_tiles - 1 - rank, b, hh);
}

template <int kU>
int launch(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_bwd_kernel<kU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = 2LL * a.n_tiles * a.b * a.h;
  hstu_attention_bwd_kernel<kU><<<(unsigned int)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ wide heads
//
// Heads wider than kMaxDepth (dqk or dv above 128): the passes above keep a
// resident and two streamed stages as wide as the head and 4 x 8 columns of
// each output a lane, which reach 128. Here the same two passes, the same
// walks and the same live-pair tests, with depth in slices of kSliceW = 128:
//  - the scores: for each streamed tile, q.k is summed over the dqk slices
//    and g.v over the dv slices, one slice of the resident and the streamed
//    rows staged in shared memory at a time, the lane's partial sums in
//    registers. dP = g.v sums over all of dv before the silu derivative, so
//    dz exists only after the last dv slice;
//  - the outputs: one 128-column slice of them a block, on the grid
//    (blockIdx.y = c): pass Q writes dq[:, c], pass K dk[:, c] and dv[:, c]
//    (each where the head has that slice). The streamed rows of slice c (k,
//    or q and g) are staged once a tile beside the score slices. Each slice's
//    block recomputes z and dz for the walk: no block keeps a tile's dz for
//    another, and a lane's 4 x 8-column tiles are what its registers hold.
//  - dq, dk and dv keep the two-pass order: every sum in registers in walk
//    order, the two streamed halves added in a fixed order, each row written
//    once (bit-identical from call to call). The table gradients are added by
//    the blocks of slice 0 of pass Q only, as the pass above adds them.
// Stages are single (copy, wait, barrier, compute). Shared memory is
// wide_smem_floats (~80 KB at L = 211, ~84 KB at 1,035): the same at every
// width. The simple form of the wide path, not a fast one.

long long wide_smem_floats(int max_len, int num_buckets, int n_tiles) {
  const long long rows = 4LL * kT * hstu::kLdSlice;  // two score slices, two output slices
  const long long w = 2LL * kWarps * kHalf * kLdW;
  const long long tables = 2LL * (num_buckets + 1) + max_len;
  const long long ints = 4LL * kT + n_tiles + 1;
  return rows + w + tables + ints;
}

template <bool kPassK>
__device__ __forceinline__ void run_wide_pass(const Args& a, float* smem, int tile, int b,
                                              int hh, int c) {
  constexpr int kU = 4;
  constexpr int ld = hstu::kLdSlice;
  constexpr int kW = hstu::kSliceW;
  const int n_qk = (a.dqk + kW - 1) / kW, n_v = (a.dvh + kW - 1) / kW;
  const bool out1 = c < n_qk;           // dq (pass Q) or dk (pass K) has slice c
  const bool out2 = kPassK && c < n_v;  // dv has slice c
  if (!out1 && !out2) return;           // the whole block
  const bool tables = !kPassK && c == 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp >> 1, ws = warp & 1;
  const int lr = lane >> 3, ls = lane & 7;
  const int n = a.n, L = a.max_len, nb1 = a.num_buckets + 1;
  const int seq_len = min(a.lengths[b], n);
  const int r0 = tile * kT;
  const int hv = a.h * a.dvh;
  const int c1 = c * kW;
  const int w1c = out1 ? min(kW, a.dqk - c1) : 0, w2c = out2 ? min(kW, a.dvh - c1) : 0;

  const float* qb = a.q + b * a.q_sb + hh * a.dqk;
  const float* kb = a.k + b * a.k_sb + hh * a.dqk;
  const float* vb = a.v + b * a.v_sb + hh * a.dvh;
  const float* gb = a.g + (int64_t)b * n * hv + hh * a.dvh;
  const float* res1_src = kPassK ? kb : qb;
  const float* res2_src = kPassK ? vb : gb;
  const int64_t res1_sn = kPassK ? a.k_sn : a.q_sn;
  const int64_t res2_sn = kPassK ? a.v_sn : hv;
  const float* str1_src = kPassK ? qb : kb;
  const float* str2_src = kPassK ? gb : vb;
  const int64_t str1_sn = kPassK ? a.q_sn : a.k_sn;
  const int64_t str2_sn = kPassK ? hv : a.v_sn;
  const int* tsb = a.ts + b * a.ts_sb;
  const int* segb = a.seg_pos ? a.seg_pos + b * a.seg_sb : nullptr;

  float* res_s = smem;                              // [kT][ld] resident slice
  float* str_s = res_s + kT * ld;                   // [kT][ld] streamed slice
  float* o1_s = str_s + kT * ld;                    // [kT][ld] streamed side 1, slice c
  float* o2_s = o1_s + kT * ld;                     // [kT][ld] streamed side 2, slice c
  float* w1 = o2_s + kT * ld;                       // [kWarps][kHalf][kLdW] dz
  float* w2 = w1 + kWarps * kHalf * kLdW;           // [kWarps][kHalf][kLdW] p (pass K)
  float* tsw_s = w2 + kWarps * kHalf * kLdW;        // [nb1]
  float* hist_s = tsw_s + nb1;                      // [nb1]
  float* diag_s = hist_s + nb1;                     // [L]
  int* res_ts = reinterpret_cast<int*>(diag_s + L);  // [kT]
  int* res_start = res_ts + kT;                     // [kT]
  int* str_ts = res_start + kT;                     // [kT]
  int* str_seg = str_ts + kT;                       // [kT]
  int* tiles_s = str_seg + kT;                      // [n_tiles + 1]

  const int ng1 = (w1c + 3) / 4, ng2 = (w2c + 3) / 4;
  int g1[kU], g2[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = ls + 8 * u;
    g2[u] = ls + 8 * u;
  }
  const int row_lane = 16 * wr + 4 * lr;
  const int64_t out1_base = ((int64_t)b * n * a.h + hh) * a.dqk + c1;
  const int64_t out2_base = ((int64_t)b * n * a.h + hh) * a.dvh + c1;
  const int64_t out1_sn = (int64_t)a.h * a.dqk, out2_sn = (int64_t)hv;

  if (r0 >= seq_len) {
    float4 zero[4][kU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u) zero[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ws == 0) {
      if (out1)
        hstu::store_rows_at<kU>(kPassK ? a.dk : a.dq, zero, out1_base, r0 + row_lane, n,
                                out1_sn, w1c, g1, ng1);
      if (out2)
        hstu::store_rows_at<kU>(a.dv, zero, out2_base, r0 + row_lane, n, out2_sn, w2c, g2, ng2);
    }
    return;
  }

  if (tid < kT) {
    const int row = r0 + tid;
    res_ts[tid] = tsb[kPassK ? min(row, n - 1) : min(row + 1, n - 1)];
    if (!kPassK) res_start[tid] = hstu::segment_start(a.seg_pos, b * a.seg_sb, row, seq_len);
  }
  for (int e = tid; e < nb1; e += kThreads) {
    tsw_s[e] = a.ts_w[e];
    hist_s[e] = 0.f;
  }
  const int diag_hi = min(L, r0 + kT);
  if (tables)
    for (int e = tid; e < diag_hi; e += kThreads) diag_s[e] = 0.f;

  // the walk, as run_pass takes it
  const int res_last = min(r0 + kT, seq_len) - 1;
  int t_lo, t_hi;
  if (kPassK) {
    t_lo = r0 / kT;
    t_hi = min(seq_len - 1, res_last + L - 1) / kT;
  } else {
    __syncthreads();  // res_start
    const int first = max(hstu::first_key_row(res_start, kT), max(r0 - L + 1, 0));
    t_lo = first / kT;
    t_hi = res_last / kT;
  }
  for (int t = t_lo + warp; t <= t_hi; t += kWarps) {
    bool live = true;
    if (kPassK && segb != nullptr) {
      const int m = t * kT + lane;
      const int start = m < seq_len ? m - segb[m] : INT_MAX;
      live = __reduce_min_sync(0xffffffffu, (unsigned int)max(start, 0)) <= (unsigned int)res_last;
    }
    if (lane == 0) tiles_s[t - t_lo] = live ? t : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int cnt = 0;
    for (int t = 0; t <= t_hi - t_lo; ++t)
      if (tiles_s[t] >= 0) tiles_s[cnt++] = tiles_s[t];
    tiles_s[a.n_tiles] = cnt;
  }
  __syncthreads();
  const int cnt = tiles_s[a.n_tiles];

  float4 acc1[4][kU], acc2[4][kU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      acc1[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc2[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  int run_bucket = -1;
  float run_sum = 0.f;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = min(g1[u], max(ng1, 1) - 1);
    g2[u] = min(g2[u], max(ng2, 1) - 1);
  }
  float* w1_warp = w1 + warp * kHalf * kLdW;
  float* w2_warp = w2 + warp * kHalf * kLdW;
  const float* res_lane = res_s + row_lane * ld;
  const float* str_lane = str_s + (kHalf * ws + ls) * ld;

  for (int it = 0; it < cnt; ++it) {
    const int s0 = tiles_s[it] * kT;
    float x[4][2] = {}, y[4][2] = {};
    // x = q.k over the dqk slices; the slice-c rows of the streamed side
    // come with the first
    for (int s = 0; s < n_qk; ++s) {
      const int e0 = s * kW, we = min(kW, a.dqk - e0);
      __syncthreads();  // every warp is done with what the buffers hold
      hstu::copy_rows_async<kThreads>(res_s, ld, res1_src + r0 * res1_sn + e0, res1_sn, kT, we,
                                      seq_len - r0);
      hstu::copy_rows_async<kThreads>(str_s, ld, str1_src + s0 * str1_sn + e0, str1_sn, kT, we,
                                      seq_len - s0);
      if (s == 0) {
        if (out1)
          hstu::copy_rows_async<kThreads>(o1_s, ld, str1_src + s0 * str1_sn + c1, str1_sn, kT,
                                          w1c, seq_len - s0);
        if (out2)
          hstu::copy_rows_async<kThreads>(o2_s, ld, str2_src + s0 * str2_sn + c1, str2_sn, kT,
                                          w2c, seq_len - s0);
        if (tid < kT) {
          const int row = s0 + tid;
          str_ts[tid] = tsb[kPassK ? min(row + 1, n - 1) : min(row, n - 1)];
          if (kPassK && segb != nullptr) str_seg[tid] = segb[min(row, n - 1)];
        }
      }
      hstu::cp_async_commit();
      hstu::cp_async_wait_all();
      __syncthreads();
      dot_tile(x, res_lane, ld, str_lane, ld, 4 * ((we + 3) / 4));
    }
    // y = g.v over the dv slices
    for (int s = 0; s < n_v; ++s) {
      const int e0 = s * kW, we = min(kW, a.dvh - e0);
      __syncthreads();
      hstu::copy_rows_async<kThreads>(res_s, ld, res2_src + r0 * res2_sn + e0, res2_sn, kT, we,
                                      seq_len - r0);
      hstu::copy_rows_async<kThreads>(str_s, ld, str2_src + s0 * str2_sn + e0, str2_sn, kT, we,
                                      seq_len - s0);
      hstu::cp_async_commit();
      hstu::cp_async_wait_all();
      __syncthreads();
      dot_tile(y, res_lane, ld, str_lane, ld, 4 * ((we + 3) / 4));
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int sl = kHalf * ws + ls + 8 * j;
      const int srow = s0 + sl;
      const int s_ts = str_ts[sl];
      int s_start = 0;
      if (kPassK && segb != nullptr) s_start = srow < seq_len ? srow - str_seg[sl] : INT_MAX;
      float dz[4], pz[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rrow = r0 + row_lane + i;
        const int m = kPassK ? srow : rrow;
        const int key = kPassK ? rrow : srow;
        const int start = kPassK ? s_start : res_start[row_lane + i];
        const bool live = key <= m && m < seq_len && m - key < L && key >= start;
        dz[i] = 0.f;
        pz[i] = 0.f;
        if (live) {
          const int ts_m = kPassK ? s_ts : res_ts[row_lane + i];
          const int ts_k = kPassK ? res_ts[row_lane + i] : s_ts;
          const int bucket =
              hstu::bucketize((int)((unsigned int)ts_m - (unsigned int)ts_k), a.num_buckets);
          const float z = x[i][j] + (__ldg(a.pos_w + key - m + L - 1) + tsw_s[bucket]);
          const float sig = 1.f / (1.f + expf(-z));
          pz[i] = z * sig * a.inv_n;
          dz[i] = y[i][j] * (sig + z * sig * (1.f - sig)) * a.inv_n;
          if (tables) {
            atomicAdd(&diag_s[m - key], dz[i]);
            if (bucket != run_bucket) {
              if (run_bucket >= 0) atomicAdd(&hist_s[run_bucket], run_sum);
              run_bucket = bucket;
              run_sum = 0.f;
            }
            run_sum += dz[i];
          }
        }
      }
      *reinterpret_cast<float4*>(w1_warp + (ls + 8 * j) * kLdW + 4 * lr) =
          make_float4(dz[0], dz[1], dz[2], dz[3]);
      if (kPassK)
        *reinterpret_cast<float4*>(w2_warp + (ls + 8 * j) * kLdW + 4 * lr) =
            make_float4(pz[0], pz[1], pz[2], pz[3]);
    }
    __syncwarp();
    // pass Q: dq[:, c] += dz k[:, c]; pass K: dk[:, c] += dz^T q[:, c], dv[:, c] += p^T g[:, c]
    if (out1) accumulate_rows<kU>(acc1, w1_warp + 4 * lr, o1_s + kHalf * ws * ld, ld, g1);
    if (out2) accumulate_rows<kU>(acc2, w2_warp + 4 * lr, o2_s + kHalf * ws * ld, ld, g2);
    __syncwarp();
  }
  if (tables && run_bucket >= 0) atomicAdd(&hist_s[run_bucket], run_sum);

  hstu::cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = ls + 8 * u;
    g2[u] = ls + 8 * u;
  }
  // the two streamed halves of each resident row, half 1 added to half 0
  hstu::sum_slices<kU, 2>(acc1, res_s, ld, row_lane, ws, g1, ng1);
  if (kPassK) hstu::sum_slices<kU, 2>(acc2, str_s, ld, row_lane, ws, g2, ng2);
  if (ws == 0) {
    if (out1)
      hstu::store_rows_at<kU>(kPassK ? a.dk : a.dq, acc1, out1_base, r0 + row_lane, n, out1_sn,
                              w1c, g1, ng1);
    if (out2)
      hstu::store_rows_at<kU>(a.dv, acc2, out2_base, r0 + row_lane, n, out2_sn, w2c, g2, ng2);
  }
  if (tables) {
    for (int e = tid; e < diag_hi; e += kThreads) {
      const float v = diag_s[e];
      if (v != 0.f) atomicAdd(&a.dpw[L - 1 - e], v);
    }
    for (int e = tid; e < nb1; e += kThreads) {
      const float v = hist_s[e];
      if (v != 0.f) atomicAdd(&a.dtw[e], v);
    }
  }
}

// Block (i, c): as hstu_attention_bwd_kernel's block i, for output slice c.
__global__ void __launch_bounds__(kThreads, 2)
    hstu_attention_bwd_wide_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const bool pass_k = idx & 1;
  idx >>= 1;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int rank = idx / a.b;
  if (pass_k)
    run_wide_pass<true>(a, smem, rank, b, hh, blockIdx.y);
  else
    run_wide_pass<false>(a, smem, a.n_tiles - 1 - rank, b, hh, blockIdx.y);
}

int launch_wide(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_attention_bwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int kW = hstu::kSliceW;
  const int slices = (max(a.dqk, a.dvh) + kW - 1) / kW;
  const long long blocks = 2LL * a.n_tiles * a.b * a.h;
  const dim3 grid((unsigned int)blocks, (unsigned int)slices);
  hstu_attention_bwd_wide_kernel<<<grid, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool is_wide(int dqk, int dv) { return dqk > kMaxDepth || dv > kMaxDepth; }

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes (the wide kernel's above
// 128 columns).
long long hstu_attention_bwd_smem_bytes(int n, int dqk, int dv, int max_len,
                                        int num_buckets) {
  if (is_wide(dqk, dv)) return 4 * wide_smem_floats(max_len, num_buckets, (n + kT - 1) / kT);
  return 4 * smem_floats(shared_ld(dqk), shared_ld(dv), max_len, num_buckets,
                         (n + kT - 1) / kT);
}

// dpw and dtw must arrive zeroed; dq, dk and dv are written whole. `seg_pos`
// is [b, n] int32 with row stride seg_sb, or null for unpacked rows. Heads
// up to 128 wide take the kernel above, wider ones the wide kernel.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int hstu_attention_bwd(const float* q, const float* k, const float* v,
                       const float* g, const int* ts, const int* lengths,
                       const int* seg_pos, const float* pos_w,
                       const float* ts_w, float* dq, float* dk, float* dv,
                       float* dpw, float* dtw, int b, int n, int h, int dqk,
                       int dvh, long long q_sb, long long q_sn, long long k_sb,
                       long long k_sn, long long v_sb, long long v_sn,
                       long long ts_sb, long long seg_sb, int max_len,
                       int num_buckets, void* stream) {
  if (dqk <= 0 || dvh <= 0) return (int)cudaErrorInvalidValue;
  if ((long long)b * n * h == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.ts = ts;
  a.lengths = lengths;
  a.seg_pos = seg_pos;
  a.pos_w = pos_w;
  a.ts_w = ts_w;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dpw = dpw;
  a.dtw = dtw;
  a.b = b;
  a.n = n;
  a.h = h;
  a.dqk = dqk;
  a.dvh = dvh;
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
  a.ld1 = shared_ld(dqk);
  a.ld2 = shared_ld(dvh);
  a.n_tiles = (n + kT - 1) / kT;
  const long long smem = hstu_attention_bwd_smem_bytes(n, dqk, dvh, max_len, num_buckets);
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_wide(dqk, dvh)) return launch_wide(a, smem, st);
  const int groups = ((dqk > dvh ? dqk : dvh) + 3) / 4;
  return groups <= 16 ? launch<2>(a, smem, st) : launch<4>(a, smem, st);
}

const char* hstu_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
