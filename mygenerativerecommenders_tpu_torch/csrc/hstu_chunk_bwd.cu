// Chunk HSTU attention backward of one ring step, for Hopper (sm_90a), plain
// C ABI: two deterministic register-tiled fp32 passes in one launch.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/hstu_chunk.py:254
// (`_bwd_kernel`, launched from `_bwd_impl` through the pallas_call at :418).
// Like that kernel it keeps nothing [Nq, Nc]-shaped from the forward: for
// every live pair (n - m >= offd, n < Nq, m < Nc; see csrc/hstu_chunk_fwd.cu)
// it recomputes
//
//   slot = clip(m - n + offd + L - 1, 0, 2L - 2)
//   z    = q[b,n,h].k[b,m,h] + pos_w[slot] + ts_w[bucket(tsq[b,n] - tsk[b,m])]
//   sig  = sigmoid(z),  p = z sig inv_n,  dp = g[b,n,h].v[b,m,h]
//   dz   = dp (sig + z sig (1 - sig)) inv_n
//
// and from these  dq[n] = sum_m dz k[m],  dk[m] = sum_n dz q[n],
// dv[m] = sum_n p g[n],  d_pos_w[slot] += sum_h dz,  d_ts_w[bucket] += sum_h dz.
//
// The mask is the chunk's, not the full sequence's: there are no lengths,
// no segments and no window of L. A live pair has m - n + offd <= 0, so its
// slot lies in [0, L-1]; a pair L or more apart (a padded row past the bias
// table) is live and reads the clipped slot 0, and its gradient goes into
// slot 0, the slot it read (the TPU wrapper's clipped scatter-add,
// :469-481). tsq holds the query rows' next-item timestamps and tsk the
// chunk's, each with its own batch stride; neither is shifted here. With
// offd >= Nq no pair is live and dq, dk and dv come out exactly zero.
//
// What bounds it. At the ring's fully live chunk of ml-20m-hstu-long (B=32,
// 130 x 130, H=2, d=64) the function is 32 x 16,900 x 2 pairs of 5 products
// 64 long, 346 M FMA (~10 us at the 67 TFLOP/s fp32 non-tensor peak),
// against ~7.5 MB of q, k, v, g, dq, dk, dv (~2 us at 3.35 TB/s): operations
// bound it. This design computes q.k and g.v in both passes, 7 products a
// pair (485 M FMA), on 16 x 16 warp tiles of 32 x 32 block tiles: a 130-row
// chunk is 8 x 16 + 2 rows, so 20,736 pairs are computed for 16,900 live
// ones (25,600 on whole block tiles).
//
// What held the single-pass version back, and what this one does about it
// (the design of csrc/hstu_attention_bwd.cu, whose tile helpers it shares
// through hstu_common.cuh):
//  1. dk and dv were atomicAdded into zero-filled outputs by every query
//     tile, so they changed in their last bits from run to run. Now two
//     passes, each owning its outputs: pass K, one block per (32-key tile,
//     head, batch row), keeps its k and v tile in shared memory and dk, dv in
//     registers, walks the query tiles that can see its keys and writes dk
//     and dv once; pass Q, one block per (32-query tile, head, batch row),
//     keeps q and g resident, walks the key tiles its queries can see, keeps
//     dq in registers and writes it once, and sums the two table gradients in
//     shared memory (a [L] array by slot and a [num_buckets+1] histogram,
//     one global atomic per touched entry per block). dq, dk and dv take no
//     atomics and no zero fill, and are bit-identical from run to run; only
//     d_pos_w and d_ts_w keep float atomics.
//  2. Scalar shared-memory loads and three block barriers a key tile. Now a
//     lane owns a 4 x 2 register tile of pairs and reads its operands as
//     float4 from rows whose stride is 4 (mod 8) floats; cp.async brings the
//     next streamed tile into a second buffer while the current one is
//     computed, with one block barrier a tile.
//  3. One block of 256 threads per (batch row, query tile): 160 blocks at the
//     130 x 130 chunk, about one wave of 132 SMs. Now heads are on the grid
//     and both passes share one launch: 2 x 5 tiles x 2 heads x 32 rows = 640
//     blocks of 128 threads, ~69 KB of shared memory each (three an SM).
//  4. The walks, with Nq and Nc free to differ. Pass Q's tile of query rows
//     [q0, q_end) walks key tiles 0 .. (min(Nc, q_end - offd) - 1) / 32; pass
//     K's tile of keys [k0, k0 + 32) walks query tiles max(0, k0 + offd) / 32
//     .. (Nq - 1) / 32. Every tile of a walk holds a live pair. A tile whose
//     walk is empty (k0 + offd >= Nq, or q_end - offd <= 0) writes exact
//     zeros. Inside a tile step a warp skips its 16 x 16 pairs when none is
//     live (the rows past a ragged chunk's end, the dead corner of a
//     diagonal tile). The longest walks go first: pass Q's last tiles, pass
//     K's first.
//  5. Exact fp32 as before: no TF32, no --use_fast_math, the time bucket
//     through hstu::bucketize and expf in the sigmoid.
//
// q, k, v and the timestamps are read through their strides (chunk slices of
// the uvqk projection); g, dq, dk and dv are contiguous.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hstu_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
using hstu::kHalf;
using hstu::kLdW;
constexpr int kT = 2 * kHalf;   // rows of a tile, resident or streamed
constexpr int kMaxDepth = 128;  // widest head the 4 x 8-column output tiles reach

using hstu::accumulate_rows;
using hstu::dot_tile;
using hstu::shared_ld;
using hstu::store_rows;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* g;
  const int* tsq;
  const int* tsk;
  const float* pos_w;
  const float* ts_w;
  float* dq;
  float* dk;
  float* dv;
  float* dpw;
  float* dtw;
  int b, nq, nc, h, dqk, dvh;
  int64_t q_sb, q_sn, k_sb, k_sn, v_sb, v_sn, tsq_sb, tsk_sb;
  int offd, max_len, num_buckets;
  float inv_n;
  int ld1, ld2;  // shared row strides of dqk- and dv-wide rows
  int nq_tiles, nc_tiles;
};

long long smem_floats(int ld1, int ld2, int max_len, int num_buckets) {
  const long long rows = 3LL * kT * (ld1 + ld2);    // resident + two streamed stages
  const long long w = 2LL * kWarps * kHalf * kLdW;  // dz and p of each warp's pairs
  const long long tables = 2LL * (num_buckets + 1) + max_len;
  return rows + w + tables + 3LL * kT;  // + the timestamps
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
  const int nq = a.nq, nc = a.nc, offd = a.offd, L = a.max_len, nb1 = a.num_buckets + 1;
  const int ld1 = a.ld1, ld2 = a.ld2;
  const int n_res = kPassK ? nc : nq;  // rows of the resident side
  const int n_str = kPassK ? nq : nc;  // rows of the streamed side
  const int r0 = tile * kT;            // first resident row
  const int hv = a.h * a.dvh;

  // side 1 is dqk wide (q or k), side 2 dv wide (g or v)
  const float* qb = a.q + b * a.q_sb + hh * a.dqk;
  const float* kb = a.k + b * a.k_sb + hh * a.dqk;
  const float* vb = a.v + b * a.v_sb + hh * a.dvh;
  const float* gb = a.g + (int64_t)b * nq * hv + hh * a.dvh;
  const float* res1_src = kPassK ? kb : qb;
  const float* res2_src = kPassK ? vb : gb;
  const int64_t res1_sn = kPassK ? a.k_sn : a.q_sn;
  const int64_t res2_sn = kPassK ? a.v_sn : hv;
  const float* str1_src = kPassK ? qb : kb;
  const float* str2_src = kPassK ? gb : vb;
  const int64_t str1_sn = kPassK ? a.q_sn : a.k_sn;
  const int64_t str2_sn = kPassK ? hv : a.v_sn;
  const int* tsqb = a.tsq + b * a.tsq_sb;
  const int* tskb = a.tsk + b * a.tsk_sb;
  const int* res_tsb = kPassK ? tskb : tsqb;
  const int* str_tsb = kPassK ? tsqb : tskb;

  float* res1 = smem;                          // [kT][ld1]
  float* res2 = res1 + kT * ld1;               // [kT][ld2]
  float* str1 = res2 + kT * ld2;               // [2][kT][ld1]
  float* str2 = str1 + 2 * kT * ld1;           // [2][kT][ld2]
  float* w1 = str2 + 2 * kT * ld2;             // [kWarps][kHalf][kLdW] dz
  float* w2 = w1 + kWarps * kHalf * kLdW;      // [kWarps][kHalf][kLdW] p (pass K)
  float* tsw_s = w2 + kWarps * kHalf * kLdW;   // [nb1]
  float* hist_s = tsw_s + nb1;                 // [nb1] d_ts_w of this block
  float* diag_s = hist_s + nb1;                // [L] d_pos_w by slot
  int* res_ts = reinterpret_cast<int*>(diag_s + L);  // [kT]
  int* str_ts = res_ts + kT;                   // [2][kT]

  const int ng1 = (a.dqk + 3) / 4, ng2 = (a.dvh + 3) / 4;  // 4-column groups
  int g1[kU], g2[kU];  // this lane's groups, clamped for the loads
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g1[u] = ls + 8 * u;
    g2[u] = ls + 8 * u;
  }
  const int row_lane = 16 * wr + 4 * lr;  // the lane's first resident row in the tile
  const int64_t out1_base = ((int64_t)b * n_res * a.h + hh) * a.dqk;
  const int64_t out2_base = ((int64_t)b * n_res * a.h + hh) * a.dvh;

  // The walk: streamed tiles t_lo .. t_lo + cnt - 1, each holding a live pair.
  int t_lo = 0, cnt = 0;
  const int q_end = min(r0 + kT, nq);  // pass Q: past the tile's last query row
  if (kPassK) {
    // queries from the first that sees key r0 on
    const int first = max(0, r0 + offd);
    if (first < nq) {
      t_lo = first / kT;
      cnt = (nq - 1) / kT - t_lo + 1;
    }
  } else {
    // keys up to the last that query q_end - 1 sees
    const int keys = min(nc, q_end - offd);
    if (keys > 0) cnt = (keys - 1) / kT + 1;
  }

  if (cnt == 0) {
    // no pair of the tile is live: its rows are zero
    float4 zero[4][kU];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < kU; ++u) zero[i][u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ws == 0) {
      float* out1 = kPassK ? a.dk : a.dq;
      store_rows<kU>(out1, zero, out1_base, r0 + row_lane, n_res, a.h, a.dqk, g1, ng1);
      if (kPassK)
        store_rows<kU>(a.dv, zero, out2_base, r0 + row_lane, n_res, a.h, a.dvh, g2, ng2);
    }
    return;
  }

  // the resident tile and its timestamps
  hstu::copy_rows_async<kThreads>(res1, ld1, res1_src + r0 * res1_sn, res1_sn, kT,
                                  a.dqk, n_res - r0);
  hstu::copy_rows_async<kThreads>(res2, ld2, res2_src + r0 * res2_sn, res2_sn, kT,
                                  a.dvh, n_res - r0);
  hstu::cp_async_commit();
  if (tid < kT) res_ts[tid] = res_tsb[min(r0 + tid, n_res - 1)];
  for (int e = tid; e < nb1; e += kThreads) {
    tsw_s[e] = a.ts_w[e];
    hist_s[e] = 0.f;
  }
  // pass Q: the slots of the block's pairs, (query q_end - 1, key 0) to
  // (query r0, the walk's last key), clipped as the pairs' are
  int slot_lo = 0, slot_hi = -1;
  if (!kPassK) {
    const int last_key = min(nc, q_end - offd) - 1;
    slot_lo = min(max(offd + L - 1 - (q_end - 1), 0), L - 1);
    slot_hi = min(max(last_key - r0 + offd + L - 1, 0), L - 1);
    for (int e = slot_lo + tid; e <= slot_hi; e += kThreads) diag_s[e] = 0.f;
  }

  auto load_stream = [&](int t, int stage) {
    const int s0 = t * kT;
    hstu::copy_rows_async<kThreads>(str1 + stage * kT * ld1, ld1, str1_src + s0 * str1_sn,
                                    str1_sn, kT, a.dqk, n_str - s0);
    hstu::copy_rows_async<kThreads>(str2 + stage * kT * ld2, ld2, str2_src + s0 * str2_sn,
                                    str2_sn, kT, a.dvh, n_str - s0);
    if (tid < kT) hstu::cp_async4(str_ts + stage * kT + tid, str_tsb + min(s0 + tid, n_str - 1));
    hstu::cp_async_commit();
  };
  load_stream(t_lo, 0);

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
    // tile it has landed for every thread (and the set-up above is visible),
    // and every thread is done with tile it - 1, whose buffer the next copy
    // overwrites
    __syncthreads();
    if (it + 1 < cnt) load_stream(t_lo + it + 1, (it + 1) & 1);
    const int stage = it & 1;
    const int s0 = (t_lo + it) * kT;
    const float* s1 = str1 + stage * kT * ld1 + (kHalf * ws) * ld1;  // the warp's streamed rows
    const float* s2 = str2 + stage * kT * ld2 + (kHalf * ws) * ld2;
    // The warp's 16 x 16 pairs are skipped when none is live (a ragged last
    // tile's missing rows, the dead corner of a diagonal tile): they would
    // add only zeros. The test is the same for every lane.
    const int n_lo = kPassK ? s0 + kHalf * ws : r0 + kHalf * wr;  // first query row
    const int m_lo = kPassK ? r0 + kHalf * wr : s0 + kHalf * ws;  // first key row
    if (n_lo >= nq || m_lo >= nc || min(n_lo + kHalf - 1, nq - 1) - m_lo < offd) continue;

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
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rrow = r0 + row_lane + i;
        const int n = kPassK ? srow : rrow;  // query
        const int m = kPassK ? rrow : srow;  // key
        const bool live = n - m >= offd && n < nq && m < nc;
        dz[i][j] = 0.f;
        pz[i][j] = 0.f;
        if (live) {
          const int ts_n = kPassK ? s_ts : res_ts[row_lane + i];
          const int ts_m = kPassK ? res_ts[row_lane + i] : s_ts;
          const int bucket =
              hstu::bucketize((int)((unsigned int)ts_n - (unsigned int)ts_m), a.num_buckets);
          // live: m - n + offd <= 0, so only the lower clip can bind
          const int slot = max(m - n + offd + L - 1, 0);
          const float z = x[i][j] + (__ldg(a.pos_w + slot) + tsw_s[bucket]);
          const float sig = 1.f / (1.f + expf(-z));
          pz[i][j] = z * sig * a.inv_n;
          dz[i][j] = y[i][j] * (sig + z * sig * (1.f - sig)) * a.inv_n;
          if (!kPassK) {
            atomicAdd(&diag_s[slot], dz[i][j]);
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
    store_rows<kU>(kPassK ? a.dk : a.dq, acc1, out1_base, r0 + row_lane, n_res, a.h,
                         a.dqk, g1, ng1);
    if (kPassK)
      store_rows<kU>(a.dv, acc2, out2_base, r0 + row_lane, n_res, a.h, a.dvh, g2, ng2);
  }
  if (!kPassK) {
    // the block's table gradients: one atomic per touched entry
    for (int e = slot_lo + tid; e <= slot_hi; e += kThreads) {
      const float x = diag_s[e];
      if (x != 0.f) atomicAdd(&a.dpw[e], x);
    }
    for (int e = tid; e < nb1; e += kThreads) {
      const float x = hist_s[e];
      if (x != 0.f) atomicAdd(&a.dtw[e], x);
    }
  }
}

// Block i: rank i / (2 B H) of its pass, the longest walks first (pass Q's
// last query tiles, pass K's first key tiles), then batch row, head and pass.
// The grid covers the larger tile count of the two sides; a rank past its
// own side's count returns at once.
template <int kU>
__global__ void __launch_bounds__(kThreads, 3) hstu_chunk_bwd_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  int idx = blockIdx.x;
  const bool pass_k = idx & 1;
  idx >>= 1;
  const int hh = idx % a.h;
  idx /= a.h;
  const int b = idx % a.b;
  const int rank = idx / a.b;
  if (pass_k) {
    if (rank < a.nc_tiles) run_pass<true, kU>(a, smem, rank, b, hh);
  } else {
    if (rank < a.nq_tiles) run_pass<false, kU>(a, smem, a.nq_tiles - 1 - rank, b, hh);
  }
}

template <int kU>
int launch(const Args& a, long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hstu_chunk_bwd_kernel<kU>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = a.nq_tiles > a.nc_tiles ? a.nq_tiles : a.nc_tiles;
  const long long blocks = 2LL * tiles * a.b * a.h;
  hstu_chunk_bwd_kernel<kU><<<(unsigned int)blocks, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest head (dqk and dv) the kernel takes.
int hstu_chunk_bwd_max_depth() { return kMaxDepth; }

// Dynamic shared memory one block needs, in bytes.
long long hstu_chunk_bwd_smem_bytes(int dqk, int dv, int max_len, int num_buckets) {
  return 4 * smem_floats(shared_ld(dqk), shared_ld(dv), max_len, num_buckets);
}

// dpw and dtw must arrive zeroed; dq, dk and dv are written whole. Strides as
// in hstu_chunk_fwd; g [b, nq, h, dv] contiguous. Launches on `stream`
// without synchronising; returns cudaGetLastError().
int hstu_chunk_bwd(const float* q, const float* k, const float* v,
                   const float* g, const int* tsq, const int* tsk,
                   const float* pos_w, const float* ts_w, float* dq, float* dk,
                   float* dv, float* dpw, float* dtw, int b, int nq, int nc,
                   int h, int dqk, int dvh, long long q_sb, long long q_sn,
                   long long k_sb, long long k_sn, long long v_sb,
                   long long v_sn, long long tsq_sb, long long tsk_sb,
                   int offd, int max_len, int num_buckets, float inv_n,
                   void* stream) {
  if (dqk > kMaxDepth || dvh > kMaxDepth) return (int)cudaErrorInvalidValue;
  if ((long long)b * h * (nq + nc) == 0) return (int)cudaSuccess;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.g = g;
  a.tsq = tsq;
  a.tsk = tsk;
  a.pos_w = pos_w;
  a.ts_w = ts_w;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dpw = dpw;
  a.dtw = dtw;
  a.b = b;
  a.nq = nq;
  a.nc = nc;
  a.h = h;
  a.dqk = dqk;
  a.dvh = dvh;
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
  a.ld1 = shared_ld(dqk);
  a.ld2 = shared_ld(dvh);
  a.nq_tiles = (nq + kT - 1) / kT;
  a.nc_tiles = (nc + kT - 1) / kT;
  const long long smem = hstu_chunk_bwd_smem_bytes(dqk, dvh, max_len, num_buckets);
  const cudaStream_t st = (cudaStream_t)stream;
  const int groups = ((dqk > dvh ? dqk : dvh) + 3) / 4;
  return groups <= 16 ? launch<2>(a, smem, st) : launch<4>(a, smem, st);
}

const char* hstu_chunk_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
