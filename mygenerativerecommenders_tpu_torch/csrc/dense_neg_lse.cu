// Dense-catalog negative log-sum-exp, forward and backward, for Hopper
// (sm_90a), plain C ABI.
//
// Replaces the TPU kernels of mygenerativerecommenders_tpu/ops/pallas/dense_softmax.py:
// `_fwd_kernel3` (:425, launched through `fused_dense_neg_lse_t`, :633) and
// `_bwd_kernel3` (:464). With al[i, x] = q[i].cat[x] / tau and a logit live
// only where count[i, x] > 0, the forward computes per row
//
//   m      = max over live al            (-1e30 if the row has none)
//   m_safe = m > -0.5e30 ? m : 0
//   s      = sum over live count exp(al - m_safe)
//   lse    = s > 0 ? m_safe + log(max(s, 1e-30)) : -inf
//
// (the select comes before the exponential, so a dead logit above the live
// maximum cannot overflow), and the backward, given gl = d loss / d lse,
//
//   dal  = count exp(al - m_safe) (s > 0 ? gl / max(s, 1e-30) : 0) / tau   (live)
//   dq   = dal cat,   dcat = dal^T q.
//
// The [BT, X] logits never reach device memory in either direction. No
// gradient flows to count.
//
// The same two entry points replace the 2-D-count kernels of that file too:
// `_fwd_kernel` (:75, launched through `fused_dense_neg_lse`, :168) and its
// backward `_bwd_single_kernel`, `_bwd_dq_kernel`, `_bwd_dcat_kernel` (:116,
// :138, :152). Those take an optional `sup_off` [BT] (the row's positive
// catalog offset, -1 for none) and zero the count at x == sup_off[i] before
// the select (:67-68), and a count whose rows may be padded past X
// (`count_ld`). A null sup_off takes an instantiation without the mask and
// the stride (kMasked false), the training path's code: its arithmetic is
// that of the unmasked kernels, bit for bit.
//
// count is uint8 (R <= 255 draws a row) or, with `wide`, int32 (R > 255,
// where a bin could pass 255; csrc/count_offsets.cu). The kernels are
// templated on the count's type; sup_off takes uint8 counts only.
//
// The forward. One block of 256 threads owns 64 rows and streams the catalog
// through shared memory 64 rows at a time, computing every logit of its rows
// as the TPU kernel does (only the live ones are used). Both operands of the
// logits product are staged transposed ([D][64+4]), so that a thread reads
// its 4 rows and 4 columns as two float4s per depth step and does 16 FMAs on
// them. Each thread carries an online (m, s) for its 4 rows over its share of
// the columns; the 16 threads of a row merge theirs with shuffles at the end.
// At BT=26,880, D=50, X=3,706 that is 10.0 GFLOP of fp32 FMA for a 99.6 MB
// count: it is bound by its own FMA loops, not by the count (~30 us).
//
// The backward computes only the live logits, which is a sparse walk: a
// live logit needs count[i, x] > 0, at most R a row (R=128: 3.4% of a row at
// X=3,706, 0.5% at X=26,744). The least it must do is read the count once
// (99.6 MB at [26880, 3706], 657 MB at [24552, 26744]: 0.03 and 0.20 ms at
// 3.35 TB/s) and add ~BT.R.D floats into dcat (~170 M at [26880, 50] x [3706,
// 50], ~900 adds an address). Measured (PERF.md), the scan sets the time at
// [24552, 26744], and at [26880, 3706] the chain each live pair takes: an L2
// gather, a shuffle sum, an exponential. The design:
//   - rows to warps: a warp owns a row, four a block, so even 4,297 rows (a
//     packed step's 256-token class) make 1,075 blocks, eight an SM;
//   - the scan: 16-byte loads (__ldcs: read once, evicted first, so the
//     catalog stays in L2), neighbouring lanes on neighbouring addresses, four
//     in flight a lane, a scalar head and tail where the row is not 16-byte
//     aligned (rows start at i * count_ld bytes); the live (x, count) pairs
//     go into the warp's list in shared memory in column order (__popc and a
//     shuffle scan over the lanes), and a list that fills is computed and
//     refilled, so a row may hold any number of live logits;
//   - the pairs: a group of 16 or 32 lanes takes one pair, its lanes across
//     D with 1-4 floats each; it gathers cat[x] (0.74 MB or 6.8 MB: L2
//     hits), sums q[i].cat[x] with shuffles, forms dal, accumulates dq[i] in
//     registers and adds dal q[i] into a float64 copy of dcat[x] with
//     atomics, the group's lanes on neighbouring columns;
//   - the outputs: dq is stored once, summed in list order in each group
//     and over the groups in a fixed order, so it is the same bits from call
//     to call, and whatever the row's alignment (sup_off all -1 on a padded
//     count gives the null pointer's dq). A row with s == 0 (or gl == 0)
//     reads no count, stores an exact 0 in dq and sends nothing to dcat;
//   - dcat: an entry sums one term a live pair, thousands of them where the
//     rows are dense (4,096 rows on 150 columns: terms of 41 in absolute
//     value in all for an entry of 0.04), in an order the atomics choose anew
//     each run. Summed in float32, two such orders (or the kernel and
//     autograd's ordered product) part by up to the whole of rtol 2e-4 /
//     atol 2e-5 on those entries. So each term dal q[i, c], a product of two
//     floats and exact in float64, goes into a float64 accumulator, and a
//     second small kernel in the same call rounds the sums into dcat: dcat
//     is the float32 rounding of the sum of the float32 terms, off only by
//     float64's own error (~1e-16 of the largest partial sum), and its bits
//     can change between runs only where that sum lies that close to a
//     rounding boundary. The price is twice the atomic bytes of float32
//     vectors: a group's lanes take neighbouring columns, so one atomic
//     instruction covers 128 or 256 contiguous bytes of the accumulator.
// al is summed in another order than the forward's, so exp(al - m_safe) may
// pass 1 by an ulp; nothing clamps it.
//
// The TPU kernels' b-major [BT, HI, 128] count layout, their radix-256
// unpacking and their one-x-block restriction exist for Mosaic and are not
// carried over: count is plain [BT, X] and the catalog may be any width, so
// the backward computes the function of `_bwd_dq_kernel3` / `_bwd_dcat_kernel3`
// (:491 / :509) as well.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;       // rows of q per block
constexpr int kBN = 64;       // catalog rows per tile
constexpr int kLdT = kBM + 4; // transposed tiles: 16-byte aligned, 4d + r banks
constexpr float kNoLogit = -1e30f;

// Stages `rows_valid` rows of a row-major [*, d] matrix, starting at `src`,
// transposed into dst_t[d][kLdT]; rows past `rows_valid` are zeros. A warp
// takes 4 rows x 8 consecutive columns: whole 32-byte sectors from device
// memory, distinct banks in dst_t.
__device__ __forceinline__ void stage_tile(float* dst_t, const float* __restrict__ src, int d,
                                           int rows_valid) {
  const int r_lo = threadIdx.x >> 3;  // 0..31
  const int d_lo = threadIdx.x & 7;
  for (int r = r_lo; r < kBM; r += kThreads / 8) {
    for (int c = d_lo; c < d; c += 8)
      dst_t[c * kLdT + r] = r < rows_valid ? src[(int64_t)r * d + c] : 0.f;
  }
}

// acc[i][j] = q_t[:, 4ty+i] . c_t[:, 4tx+j]
__device__ __forceinline__ void logits_4x4(float (&acc)[4][4], const float* q_t,
                                           const float* c_t, int d, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int e = 0; e < d; ++e) {
    const float4 a = *reinterpret_cast<const float4*>(q_t + e * kLdT + 4 * ty);
    const float4 c = *reinterpret_cast<const float4*>(c_t + e * kLdT + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
  }
}

// kMasked: the kernels of `fused_dense_neg_lse`, which take sup_off and a
// count row stride; without it the instantiation is the training path's,
// whose count rows are x wide and which masks nothing.

// The positive's catalog offset of the thread's 4 rows (-1 past bt).
template <bool kMasked>
__device__ __forceinline__ void load_sup(int (&sup)[4], const int* __restrict__ sup_off,
                                         int row0, int bt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) sup[i] = kMasked && row0 + i < bt ? sup_off[row0 + i] : -1;
}

// The thread's 4x4 counts; 0 outside [bt, x) and, with kMasked, at the
// row's positive column (the TPU kernel's cmask, dense_softmax.py:67-68).
template <bool kMasked, typename C>
__device__ __forceinline__ void load_counts(C (&cnt)[4][4], const C* __restrict__ count,
                                            int64_t count_ld, const int (&sup)[4],
                                            int row0, int col0, int bt, int x) {
  const int64_t ld = kMasked ? count_ld : x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + i, col = col0 + j;
      cnt[i][j] = row < bt && col < x && (!kMasked || col != sup[i])
                      ? count[(int64_t)row * ld + col]
                      : (C)0;
    }
}

template <bool kMasked, typename C>
__global__ void __launch_bounds__(kThreads) dense_neg_lse_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ cat,
    const C* __restrict__ count, const int* __restrict__ sup_off,
    float* __restrict__ lse, float* __restrict__ m_out, float* __restrict__ s_out,
    int bt, int d, int x, int64_t count_ld, float inv_tau) {
  extern __shared__ __align__(16) float smem[];
  float* q_t = smem;            // [d][kLdT]
  float* c_t = q_t + d * kLdT;  // [d][kLdT]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;

  stage_tile(q_t, q + (int64_t)row0 * d, d, bt - row0);
  int sup[4];
  load_sup<kMasked>(sup, sup_off, row0 + 4 * ty, bt);
  float m[4], s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNoLogit;
    s[i] = 0.f;
  }
  for (int x0 = 0; x0 < x; x0 += kBN) {
    __syncthreads();  // the last tile's readers are done with c_t
    stage_tile(c_t, cat + (int64_t)x0 * d, d, x - x0);
    C cnt[4][4];
    load_counts<kMasked>(cnt, count, count_ld, sup, row0 + 4 * ty, x0 + 4 * tx, bt, x);
    __syncthreads();
    float acc[4][4];
    logits_4x4(acc, q_t, c_t, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cnt[i][j] == 0) continue;
        const float al = acc[i][j] * inv_tau, c = (float)cnt[i][j];
        if (al > m[i]) {
          s[i] = s[i] * expf(m[i] - al) + c;
          m[i] = al;
        } else {
          s[i] += c * expf(al - m[i]);
        }
      }
  }
  // merge the 16 threads (tx) of each row: they sit in one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float s2 = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float mm = fmaxf(m[i], m2);
      s[i] = s[i] * expf(m[i] - mm) + s2 * expf(m2 - mm);
      m[i] = mm;
    }
    const int row = row0 + 4 * ty + i;
    if (tx == 0 && row < bt) {
      const float m_safe = m[i] > 0.5f * kNoLogit ? m[i] : 0.f;
      m_out[row] = m_safe;
      s_out[row] = s[i];
      lse[row] = s[i] > 0.f ? m_safe + logf(fmaxf(s[i], 1e-30f)) : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- backward
//
// A warp owns one row i of q. It reads the row's counts once, lists each live
// (x, count) in shared memory in column order and, when the list fills and at
// the end of the row, computes the listed pairs: al = q[i].cat[x] / tau with
// its lanes across D, dal from it, dq[i] += dal cat[x] in registers and
// dcat[x] += dal q[i] with float64 atomics into the float64 accumulator.

constexpr int kBwdWarps = 4;    // rows a block, one a warp
constexpr int kList = 128;      // live pairs a warp lists before computing them
constexpr int kScanUnroll = 4;  // 16-byte count loads a lane has in flight
constexpr int kPairUnroll = 2;  // pairs a lane group has in flight
constexpr unsigned kAll = 0xffffffffu;

// Bit j is set where element j of 16 bytes of counts is nonzero. uint8:
// __vcmpne4 turns each nonzero byte into 0xff, and the multiply gathers the
// four top bits into bits 28-31 (its partial products never overlap).
__device__ __forceinline__ unsigned live_bits(uint4 v, uint8_t) {
  auto nib = [](unsigned w) { return ((__vcmpne4(w, 0u) & 0x80808080u) * 0x00204081u) >> 28; };
  return nib(v.x) | nib(v.y) << 4 | nib(v.z) << 8 | nib(v.w) << 12;
}
__device__ __forceinline__ unsigned live_bits(uint4 v, int) {
  return (v.x != 0u) | (v.y != 0u) << 1 | (v.z != 0u) << 2 | (v.w != 0u) << 3;
}

// element j of 16 bytes of counts
__device__ __forceinline__ int count_at(uint4 v, int j, uint8_t) {
  const unsigned w = j < 8 ? (j < 4 ? v.x : v.y) : (j < 12 ? v.z : v.w);
  return (int)((w >> (8 * (j & 3))) & 0xffu);
}
__device__ __forceinline__ int count_at(uint4 v, int j, int) {
  return (int)(j < 2 ? (j == 0 ? v.x : v.y) : (j == 2 ? v.z : v.w));
}

template <int kVec>
__device__ __forceinline__ void load_vec(float (&dst)[kVec], const float* __restrict__ src) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = t.x, dst[1] = t.y, dst[2] = t.z, dst[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(src));
    dst[0] = t.x, dst[1] = t.y;
  } else {
    dst[0] = __ldg(src);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* dst, const float (&v)[kVec]) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (kVec == 2)
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  else
    dst[0] = v[0];
}

// dcat = the float64 sums rounded to float32, once each
__global__ void round_dcat_kernel(const double* __restrict__ acc, float* __restrict__ dcat,
                                  int64_t n) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x)
    dcat[e] = __double2float_rn(acc[e]);
}

// One warp's row. Its lanes form 32 / kLanes groups, each computing one pair
// at a time; lane l of a group holds columns (r kLanes + l) kVec .. + kVec of
// q[i] and of its group's share of dq[i], for r < kReps, and for dcat q[i]'s
// columns l + t kLanes, t < kT, so that one float64 atomic of the group's
// lanes covers kLanes neighbouring columns.
template <int kVec, int kLanes, int kReps>
struct RowWalk {
  static constexpr int kGroups = 32 / kLanes;
  static constexpr int kT = kReps * kVec;
  const float* cat;
  double* dcat;  // the float64 accumulator
  int2* pairs;  // the warp's list: (x, count as float bits)
  int n;        // pairs listed
  int d, g, lg, col;  // lg: the lane in its group
  float inv_tau, mi, coef;
  float qv[kReps][kVec], acc[kReps][kVec], qt[kT];

  __device__ __forceinline__ int column(int r) const { return col + r * kLanes * kVec; }

  __device__ __forceinline__ void load_q(const float* __restrict__ q_row) {
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) qv[r][v] = acc[r][v] = 0.f;
      if (column(r) < d) load_vec(qv[r], q_row + column(r));
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = lg + t * kLanes;
      qt[t] = c < d ? __ldg(q_row + c) : 0.f;
    }
  }

  // dcat[x, c] += dal q[i, c] for the lane's columns c = lg + t kLanes, at =
  // x d, in float64: each product of two floats is exact there
  __device__ __forceinline__ void add_dcat(double* __restrict__ dcat, int64_t at, float dal) const {
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = lg + t * kLanes;
      if (c < d) atomicAdd(dcat + at + c, (double)dal * (double)qt[t]);
    }
  }

  // Group g takes pairs g, g + kGroups, ... in list order, so each column of
  // dq sums its pairs in one order however the counts were split into loads.
  __device__ __forceinline__ void compute() {
    for (int jb = 0; jb < n; jb += kGroups * kPairUnroll) {
      int xs[kPairUnroll];
      float cnt[kPairUnroll], cv[kPairUnroll][kReps][kVec], dal[kPairUnroll];
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        const int j = jb + u * kGroups + g;
        const int2 p = j < n ? pairs[j] : make_int2(-1, 0);
        xs[u] = p.x;
        cnt[u] = __int_as_float(p.y);
#pragma unroll
        for (int r = 0; r < kReps; ++r) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) cv[u][r][v] = 0.f;
          if (p.x >= 0 && column(r) < d) load_vec(cv[u][r], cat + (int64_t)p.x * d + column(r));
        }
      }
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int r = 0; r < kReps; ++r)
#pragma unroll
          for (int v = 0; v < kVec; ++v) dot = fmaf(qv[r][v], cv[u][r][v], dot);
#pragma unroll
        for (int off = kLanes / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kAll, dot, off);
        dal[u] = xs[u] >= 0 ? cnt[u] * expf(dot * inv_tau - mi) * coef : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        if (dal[u] == 0.f) continue;
#pragma unroll
        for (int r = 0; r < kReps; ++r) {
          if (column(r) >= d) continue;
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(dal[u], cv[u][r][v], acc[r][v]);
        }
        add_dcat(dcat, (int64_t)xs[u] * d, dal[u]);
      }
    }
  }

  // Lists the lane's live elements (bit j of `bits`: element j of `v`, at
  // column x0 + j) after those of the lower lanes; a stretch denser than the
  // list's room fills it, computes it and goes on.
  template <typename C>
  __device__ __forceinline__ void append(unsigned bits, uint4 v, int x0) {
    const int lane = threadIdx.x & 31;
    const int mine = __popc(bits);
    int before = mine;  // an inclusive sum over the lanes, then exclusive
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kAll, before, off);
      if (lane >= off) before += t;
    }
    const int total = __shfl_sync(kAll, before, 31);
    before -= mine;
    for (int done = 0; done < total;) {
      const int take = min(kList - n, total - done);
      int k = before;
      for (unsigned b = bits; b; b &= b - 1, ++k)
        if (k >= done && k < done + take) {
          const int j = __ffs(b) - 1;
          pairs[n + k - done] = make_int2(x0 + j, __float_as_int((float)count_at(v, j, C{})));
        }
      n += take;
      done += take;
      if (n == kList) {
        __syncwarp();
        compute();
        __syncwarp();
        n = 0;
      }
    }
  }

  // The groups' partial sums in a fixed order; the first group writes dq[i].
  __device__ __forceinline__ void store_dq(float* __restrict__ dq_row) {
#pragma unroll
    for (int off = 16; off >= kLanes; off >>= 1)
#pragma unroll
      for (int r = 0; r < kReps; ++r)
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[r][v] += __shfl_down_sync(kAll, acc[r][v], off);
    if (g != 0) return;
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (column(r) < d) store_vec(dq_row + column(r), acc[r]);
  }
};

template <int kVec, int kLanes, int kReps, bool kMasked, typename C>
__global__ void __launch_bounds__(kBwdWarps * 32, 4) dense_neg_lse_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ cat,
    const C* __restrict__ count, const int* __restrict__ sup_off,
    const float* __restrict__ m_safe, const float* __restrict__ s_in,
    const float* __restrict__ gl, float* __restrict__ dq, double* __restrict__ dcat,
    int bt, int d, int x, int64_t count_ld, float inv_tau) {
  constexpr int kPer = 16 / (int)sizeof(C);  // counts in 16 bytes
  __shared__ int2 pairs_s[kBwdWarps][kList];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBwdWarps + warp;
  if (row >= bt) return;  // the whole warp

  RowWalk<kVec, kLanes, kReps> w;
  w.cat = cat;
  w.dcat = dcat;
  w.pairs = pairs_s[warp];
  w.n = 0;
  w.d = d;
  w.g = lane / kLanes;
  w.lg = lane % kLanes;
  w.col = w.lg * kVec;
  w.inv_tau = inv_tau;
  w.load_q(q + (int64_t)row * d);
  const float si = s_in[row];
  w.mi = m_safe[row];
  w.coef = si > 0.f ? gl[row] / fmaxf(si, 1e-30f) * inv_tau : 0.f;

  // coef 0 makes every dal 0: the row's dq stays exactly 0, dcat untouched
  if (w.coef != 0.f) {
    const int sup = kMasked ? sup_off[row] : -1;
    const C* crow = count + (int64_t)row * (kMasked ? count_ld : (int64_t)x);
    // a row starts anywhere: a scalar head up to a 16-byte boundary, slots of
    // 32 whole vectors (one a lane), a scalar tail
    const int mis = (int)(reinterpret_cast<uintptr_t>(crow) & 15) / (int)sizeof(C);
    const int head = min(x, mis ? kPer - mis : 0);
    const int nvec = (x - head) / kPer;
    const int nslot = (nvec + 31) / 32;
    const uint4* vrow = reinterpret_cast<const uint4*>(crow + head);
    uint4 cur[kScanUnroll];
    for (int s = -1; s <= nslot; ++s) {  // -1: the head, nslot: the tail
      unsigned bits;
      uint4 v;
      int x0;
      if (s < 0 || s == nslot) {
        const int lo = s < 0 ? 0 : head + nvec * kPer, hi = s < 0 ? head : x;
        x0 = lo + lane;
        const int c = x0 < hi && !(kMasked && x0 == sup) ? (int)crow[x0] : 0;
        v = make_uint4((unsigned)c, 0u, 0u, 0u);
        bits = c != 0;
      } else {
        const int u = s % kScanUnroll;
        if (u == 0) {  // the next kScanUnroll slots' loads, all in flight at once
#pragma unroll
          for (int k = 0; k < kScanUnroll; ++k) {
            const int iv = (s + k) * 32 + lane;
            cur[k] = iv < nvec ? __ldcs(vrow + iv) : make_uint4(0u, 0u, 0u, 0u);
          }
        }
#pragma unroll
        for (int k = 0; k < kScanUnroll; ++k)
          if (k == u) v = cur[k];
        x0 = head + (s * 32 + lane) * kPer;
        bits = live_bits(v, C{});
        if (kMasked && (unsigned)(sup - x0) < (unsigned)kPer) bits &= ~(1u << (sup - x0));
      }
      if (__any_sync(kAll, bits != 0u)) w.template append<C>(bits, v, x0);
    }
    __syncwarp();
    w.compute();
  }
  w.store_dq(dq + (int64_t)row * d);
}

long long fwd_smem_bytes(int d) { return 4LL * 2 * d * kLdT; }

template <bool kMasked, typename C>
int launch_fwd(const float* q, const float* cat, const C* count,
               const int* sup_off, float* lse, float* m_safe, float* s, int bt, int d,
               int x, int64_t count_ld, float inv_tau, cudaStream_t stream) {
  const long long smem = fwd_smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_neg_lse_fwd_kernel<kMasked, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_neg_lse_fwd_kernel<kMasked, C><<<(bt + kBM - 1) / kBM, kThreads, (size_t)smem, stream>>>(
      q, cat, count, sup_off, lse, m_safe, s, bt, d, x, count_ld, inv_tau);
  return (int)cudaGetLastError();
}

template <int kVec, int kLanes, int kReps, bool kMasked, typename C>
int launch_bwd_as(const float* q, const float* cat, const C* count, const int* sup_off,
                  const float* m_safe, const float* s, const float* gl, float* dq,
                  double* dcat_acc, float* dcat, int bt, int d, int x, int64_t count_ld,
                  float inv_tau, cudaStream_t stream) {
  dense_neg_lse_bwd_kernel<kVec, kLanes, kReps, kMasked, C>
      <<<(bt + kBwdWarps - 1) / kBwdWarps, kBwdWarps * 32, 0, stream>>>(
          q, cat, count, sup_off, m_safe, s, gl, dq, dcat_acc, bt, d, x, count_ld, inv_tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)x * d;
  if (n > 0) {
    const int threads = 256;
    const int64_t need = (n + threads - 1) / threads, most = 132 * 16;  // 16 an H100 SM
    round_dcat_kernel<<<(int)(need < most ? need : most), threads, 0, stream>>>(dcat_acc, dcat,
                                                                                 n);
  }
  return (int)cudaGetLastError();
}

// The widest vector of floats that d and the three float operands' addresses
// allow, 16 lanes a pair where they hold a row (two pairs a warp at once), and
// as few vectors a lane as hold it: one at D=50 and D=64.
template <bool kMasked, typename C>
int launch_bwd(const float* q, const float* cat, const C* count, const int* sup_off,
               const float* m_safe, const float* s, const float* gl, float* dq,
               double* dcat_acc, float* dcat, int bt, int d, int x, int64_t count_ld,
               float inv_tau, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(cat) |
                         reinterpret_cast<uintptr_t>(dq);
  const int vec = d % 4 == 0 && addr % 16 == 0 ? 4 : d % 2 == 0 && addr % 8 == 0 ? 2 : 1;
  const int chunks = (d + vec - 1) / vec;
#define DENSE_NEG_LSE_BWD(V, L, R)                                                            \
  launch_bwd_as<V, L, R, kMasked, C>(q, cat, count, sup_off, m_safe, s, gl, dq, dcat_acc, dcat, \
                                     bt, d, x, count_ld, inv_tau, stream)
  if (chunks <= 16) {
    return vec == 4   ? DENSE_NEG_LSE_BWD(4, 16, 1)
           : vec == 2 ? DENSE_NEG_LSE_BWD(2, 16, 1)
                      : DENSE_NEG_LSE_BWD(1, 16, 1);
  }
  if (chunks <= 32) {
    return vec == 4   ? DENSE_NEG_LSE_BWD(4, 32, 1)
           : vec == 2 ? DENSE_NEG_LSE_BWD(2, 32, 1)
                      : DENSE_NEG_LSE_BWD(1, 32, 1);
  }
  return vec == 2 ? DENSE_NEG_LSE_BWD(2, 32, 2)
                  : chunks <= 64 ? DENSE_NEG_LSE_BWD(1, 32, 2) : DENSE_NEG_LSE_BWD(1, 32, 4);
#undef DENSE_NEG_LSE_BWD
}

}  // namespace

extern "C" {

// Widest depth the backward takes (32 lanes of 4 floats a row).
int dense_neg_lse_max_depth() { return 128; }

// Dynamic shared memory one block of the forward needs, in bytes.
long long dense_neg_lse_fwd_smem_bytes(int d) { return fwd_smem_bytes(d); }

// q [bt, d], cat [x, d] float32 contiguous, count [bt, >= x] uint8 (int32 if
// `wide`) with row stride count_ld, sup_off [bt] int32 or null -> lse,
// m_safe, s [bt]. A null sup_off masks nothing; sup_off takes uint8 counts
// only. Launches on `stream` without synchronising; returns
// cudaGetLastError().
int dense_neg_lse_fwd(const float* q, const float* cat, const void* count,
                      const int* sup_off, float* lse, float* m_safe, float* s,
                      int bt, int d, int x, long long count_ld, float inv_tau,
                      int wide, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c8 = static_cast<const uint8_t*>(count);
  if (sup_off) {
    if (wide) return (int)cudaErrorInvalidValue;
    return launch_fwd<true>(q, cat, c8, sup_off, lse, m_safe, s, bt, d, x, count_ld,
                            inv_tau, st);
  }
  if (wide)
    return launch_fwd<false>(q, cat, static_cast<const int*>(count), sup_off, lse, m_safe, s,
                             bt, d, x, count_ld, inv_tau, st);
  return launch_fwd<false>(q, cat, c8, sup_off, lse, m_safe, s, bt, d, x, count_ld,
                           inv_tau, st);
}

// dcat_acc [x, d] float64 must arrive zeroed: the walk adds into it, and a
// second kernel rounds it into dcat [x, d] float32. dq [bt, d] and dcat are
// written whole. count, wide and sup_off as in dense_neg_lse_fwd.
int dense_neg_lse_bwd(const float* q, const float* cat, const void* count,
                      const int* sup_off, const float* m_safe, const float* s,
                      const float* gl, float* dq, double* dcat_acc, float* dcat, int bt,
                      int d, int x, long long count_ld, float inv_tau, int wide,
                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c8 = static_cast<const uint8_t*>(count);
  if (sup_off) {
    if (wide) return (int)cudaErrorInvalidValue;
    return launch_bwd<true>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat_acc, dcat, bt, d, x,
                            count_ld, inv_tau, st);
  }
  if (wide)
    return launch_bwd<false>(q, cat, static_cast<const int*>(count), sup_off, m_safe, s, gl,
                             dq, dcat_acc, dcat, bt, d, x, count_ld, inv_tau, st);
  return launch_bwd<false>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat_acc, dcat, bt, d, x,
                           count_ld, inv_tau, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
