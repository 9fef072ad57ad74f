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
// Both kernels compute only the live logits, which is a sparse walk: a live
// logit needs count[i, x] > 0, at most R a row (R=128: 3.4% of a row at
// X=3,706, 0.5% at X=26,744). The least the forward must do is read the count
// once (99.6 MB at [26880, 3706], 657 MB at [24552, 26744]: 0.03 and 0.20 ms
// at 3.35 TB/s); the backward reads it too and adds ~BT.R.D floats into dcat
// (~170 M at [26880, 50] x [3706, 50], ~900 adds an address). Measured
// (PERF.md), the scan sets the backward's time at [24552, 26744], and at
// [26880, 3706] the chain each live pair takes: an L2 gather, a shuffle sum,
// an exponential. The walk, shared by both kernels:
//   - rows to warps: a warp owns a row, four a block, so even 4,297 rows (a
//     packed step's 256-token class) make 1,075 blocks, eight an SM;
//   - the scan (scan_row): 16-byte loads (__ldcs: read once, evicted first,
//     so the catalog stays in L2), neighbouring lanes on neighbouring
//     addresses, four in flight a lane, a scalar head and tail where the row
//     is not 16-byte aligned (rows start at i * count_ld bytes); the live (x,
//     count) pairs go into the warp's list in shared memory in column order
//     (__popc and a shuffle scan over the lanes), and a list that fills is
//     handed to the kernel's step and refilled, so a row may hold any number
//     of live logits;
//   - the pairs (RowPairs::logits): a group of 16 or 32 lanes takes one pair,
//     its lanes across D with 1-4 floats each; it gathers cat[x] (0.74 MB or
//     6.8 MB: L2 hits) and sums q[i].cat[x] with shuffles in one fixed order.
//     Both kernels take their lane layout from the same operands (by_layout),
//     so the forward's al is the very float the backward forms again, and
//     exp(al - m_safe) never passes 1.
// The forward's step: each group keeps an online (m, s) over its pairs, its
// largest al and the sum of count exp(al - m), rescaled when m rises; at the
// end of the row the groups merge theirs with shuffles in a fixed order and
// lane 0 writes lse, m_safe and s. The pairs reach each group in list order
// whatever the row's alignment, so the three are the same bits from call to
// call, and sup_off all -1 on a padded count gives the null pointer's bits. A
// row with no live logit (all hits, sentinels) lists nothing and writes
// m_safe = 0, s = 0, lse = -inf.
// The backward's step:
//   - dq: each group accumulates dal cat[x] in registers; dq is stored once,
//     summed in list order in each group and over the groups in a fixed
//     order, so it is the same bits from call to call, and whatever the row's
//     alignment. A row with s == 0 (or gl == 0) reads no count, stores an
//     exact 0 in dq and sends nothing to dcat;
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

// ---------------------------------------------------------------- the walk
//
// A warp owns one row i of q. It reads the row's counts once, lists each live
// (x, count) in shared memory in column order and, when the list fills and
// at the end of the row, hands the listed pairs to its kernel's step.

constexpr int kWarps = 4;       // rows a block, one a warp
constexpr int kList = 128;      // live pairs a warp lists before its step takes them
constexpr int kScanUnroll = 4;  // 16-byte count loads a lane has in flight
constexpr int kPairUnroll = 2;  // pairs a lane group has in flight
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNoLogit = -1e30f;

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

// A warp's row: its list of live pairs and its lanes' layout. The lanes form
// 32 / kLanes groups, each taking one pair at a time; lane l of a group holds
// columns (r kLanes + l) kVec .. + kVec of q[i], for r < kReps.
template <int kVec, int kLanes, int kReps>
struct RowPairs {
  static constexpr int kGroups = 32 / kLanes;
  const float* cat;
  int2* pairs;  // the warp's list: (x, count as float bits)
  int n;        // pairs listed
  int d, g, lg, col;  // lg: the lane in its group
  float inv_tau;
  float qv[kReps][kVec];

  __device__ __forceinline__ int column(int r) const { return col + r * kLanes * kVec; }

  __device__ __forceinline__ void start(const float* __restrict__ q_row,
                                        const float* __restrict__ cat_, int2* list, int d_,
                                        float inv_tau_) {
    const int lane = threadIdx.x & 31;
    cat = cat_;
    pairs = list;
    n = 0;
    d = d_;
    g = lane / kLanes;
    lg = lane % kLanes;
    col = lg * kVec;
    inv_tau = inv_tau_;
#pragma unroll
    for (int r = 0; r < kReps; ++r) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) qv[r][v] = 0.f;
      if (column(r) < d) load_vec(qv[r], q_row + column(r));
    }
  }

  // Pairs jb + u kGroups + g of the list, u < kPairUnroll (x -1 past its
  // end): x, the count, the lane's columns of cat[x] and al = q[i].cat[x] /
  // tau. Group g takes pairs g, g + kGroups, ... in list order, so each
  // group meets its pairs in one order however the counts were split into
  // loads. The lanes' products are summed by shuffles in one fixed order, and
  // the product by 1 / tau is rounded on its own (__fmul_rn: never fused into
  // a later subtraction), so both kernels form the very same al.
  __device__ __forceinline__ void logits(int jb, int (&xs)[kPairUnroll],
                                         float (&cnt)[kPairUnroll],
                                         float (&cv)[kPairUnroll][kReps][kVec],
                                         float (&al)[kPairUnroll]) const {
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
      al[u] = __fmul_rn(dot, inv_tau);
    }
  }

  // Lists the lane's live elements (bit j of `bits`: element j of `v`, at
  // column x0 + j) after those of the lower lanes; a stretch denser than the
  // list's room fills it, hands it to `step` and goes on.
  template <typename C, typename Step>
  __device__ __forceinline__ void append(unsigned bits, uint4 v, int x0, Step&& step) {
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
        step();
        __syncwarp();
        n = 0;
      }
    }
  }
};

// The warp's scan of one row of counts `crow`, x wide (with kMasked, the
// element at column `sup` taken as 0): every live pair goes through the list
// to `step`, the last ones at the end of the row. A row starts anywhere: a
// scalar head up to a 16-byte boundary, slots of 32 whole vectors (one a
// lane), a scalar tail.
template <bool kMasked, typename C, typename Pairs, typename Step>
__device__ __forceinline__ void scan_row(Pairs& w, const C* __restrict__ crow, int x, int sup,
                                         Step&& step) {
  constexpr int kPer = 16 / (int)sizeof(C);  // counts in 16 bytes
  const int lane = threadIdx.x & 31;
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
    if (__any_sync(kAll, bits != 0u)) w.template append<C>(bits, v, x0, step);
  }
  __syncwarp();
  step();
}

template <bool kMasked, typename C>
__device__ __forceinline__ const C* count_row(const C* __restrict__ count, int row, int x,
                                              int64_t count_ld) {
  return count + (int64_t)row * (kMasked ? count_ld : (int64_t)x);
}

// ---------------------------------------------------------------- forward

// One warp's row of the forward: each group's running (m, s) over its pairs.
template <int kVec, int kLanes, int kReps>
struct RowLse {
  RowPairs<kVec, kLanes, kReps> p;
  float m = kNoLogit;  // the group's largest al so far
  float s = 0.f;       // its sum of count exp(al - m)

  __device__ __forceinline__ void step() {
    for (int jb = 0; jb < p.n; jb += p.kGroups * kPairUnroll) {
      int xs[kPairUnroll];
      float cnt[kPairUnroll], cv[kPairUnroll][kReps][kVec], al[kPairUnroll];
      p.logits(jb, xs, cnt, cv, al);
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        if (xs[u] < 0) continue;
        if (al[u] > m) {
          s = fmaf(s, expf(m - al[u]), cnt[u]);
          m = al[u];
        } else {
          s = fmaf(cnt[u], expf(al[u] - m), s);
        }
      }
    }
  }

  // The groups' (m, s) merged in a fixed order; lane 0 writes the row.
  __device__ __forceinline__ void store(int row, float* __restrict__ lse,
                                        float* __restrict__ m_out, float* __restrict__ s_out) {
#pragma unroll
    for (int off = 16; off >= kLanes; off >>= 1) {
      const float m2 = __shfl_down_sync(kAll, m, off);
      const float s2 = __shfl_down_sync(kAll, s, off);
      const float mm = fmaxf(m, m2);
      s = s * expf(m - mm) + s2 * expf(m2 - mm);
      m = mm;
    }
    if ((threadIdx.x & 31) != 0) return;
    const float m_safe = m > 0.5f * kNoLogit ? m : 0.f;
    m_out[row] = m_safe;
    s_out[row] = s;
    lse[row] = s > 0.f ? m_safe + logf(fmaxf(s, 1e-30f)) : -INFINITY;
  }
};

template <int kVec, int kLanes, int kReps, bool kMasked, typename C>
__global__ void __launch_bounds__(kWarps * 32) dense_neg_lse_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ cat,
    const C* __restrict__ count, const int* __restrict__ sup_off,
    float* __restrict__ lse, float* __restrict__ m_out, float* __restrict__ s_out,
    int bt, int d, int x, int64_t count_ld, float inv_tau) {
  __shared__ int2 pairs_s[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= bt) return;  // the whole warp

  RowLse<kVec, kLanes, kReps> w;
  w.p.start(q + (int64_t)row * d, cat, pairs_s[warp], d, inv_tau);
  scan_row<kMasked>(w.p, count_row<kMasked>(count, row, x, count_ld), x,
                    kMasked ? sup_off[row] : -1, [&] { w.step(); });
  w.store(row, lse, m_out, s_out);
}

// ---------------------------------------------------------------- backward
//
// The backward's step on the listed pairs: dal from al, dq[i] += dal cat[x]
// in registers and dcat[x] += dal q[i] with float64 atomics into the float64
// accumulator; for dcat lane l of a group holds q[i]'s columns l + t kLanes,
// t < kT, so that one float64 atomic of the group's lanes covers kLanes
// neighbouring columns.

// dcat = the float64 sums rounded to float32, once each
__global__ void round_dcat_kernel(const double* __restrict__ acc, float* __restrict__ dcat,
                                  int64_t n) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x)
    dcat[e] = __double2float_rn(acc[e]);
}

template <int kVec, int kLanes, int kReps>
struct RowWalk {
  static constexpr int kT = kReps * kVec;
  RowPairs<kVec, kLanes, kReps> p;
  double* dcat;  // the float64 accumulator
  float mi, coef;
  float acc[kReps][kVec], qt[kT];

  __device__ __forceinline__ void load_q(const float* __restrict__ q_row) {
#pragma unroll
    for (int r = 0; r < kReps; ++r)
#pragma unroll
      for (int v = 0; v < kVec; ++v) acc[r][v] = 0.f;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = p.lg + t * kLanes;
      qt[t] = c < p.d ? __ldg(q_row + c) : 0.f;
    }
  }

  // dcat[x, c] += dal q[i, c] for the lane's columns c = lg + t kLanes, at =
  // x d, in float64: each product of two floats is exact there
  __device__ __forceinline__ void add_dcat(double* __restrict__ dcat, int64_t at, float dal) const {
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const int c = p.lg + t * kLanes;
      if (c < p.d) atomicAdd(dcat + at + c, (double)dal * (double)qt[t]);
    }
  }

  __device__ __forceinline__ void step() {
    for (int jb = 0; jb < p.n; jb += p.kGroups * kPairUnroll) {
      int xs[kPairUnroll];
      float cnt[kPairUnroll], cv[kPairUnroll][kReps][kVec], al[kPairUnroll], dal[kPairUnroll];
      p.logits(jb, xs, cnt, cv, al);
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u)
        dal[u] = xs[u] >= 0 ? cnt[u] * expf(al[u] - mi) * coef : 0.f;
#pragma unroll
      for (int u = 0; u < kPairUnroll; ++u) {
        if (dal[u] == 0.f) continue;
#pragma unroll
        for (int r = 0; r < kReps; ++r) {
          if (p.column(r) >= p.d) continue;
#pragma unroll
          for (int v = 0; v < kVec; ++v) acc[r][v] = fmaf(dal[u], cv[u][r][v], acc[r][v]);
        }
        add_dcat(dcat, (int64_t)xs[u] * p.d, dal[u]);
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
    if (p.g != 0) return;
#pragma unroll
    for (int r = 0; r < kReps; ++r)
      if (p.column(r) < p.d) store_vec(dq_row + p.column(r), acc[r]);
  }
};

template <int kVec, int kLanes, int kReps, bool kMasked, typename C>
__global__ void __launch_bounds__(kWarps * 32, 4) dense_neg_lse_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ cat,
    const C* __restrict__ count, const int* __restrict__ sup_off,
    const float* __restrict__ m_safe, const float* __restrict__ s_in,
    const float* __restrict__ gl, float* __restrict__ dq, double* __restrict__ dcat,
    int bt, int d, int x, int64_t count_ld, float inv_tau) {
  __shared__ int2 pairs_s[kWarps][kList];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= bt) return;  // the whole warp

  RowWalk<kVec, kLanes, kReps> w;
  const float* q_row = q + (int64_t)row * d;
  w.p.start(q_row, cat, pairs_s[warp], d, inv_tau);
  w.load_q(q_row);
  w.dcat = dcat;
  const float si = s_in[row];
  w.mi = m_safe[row];
  w.coef = si > 0.f ? gl[row] / fmaxf(si, 1e-30f) * inv_tau : 0.f;

  // coef 0 makes every dal 0: the row's dq stays exactly 0, dcat untouched
  if (w.coef != 0.f)
    scan_row<kMasked>(w.p, count_row<kMasked>(count, row, x, count_ld), x,
                      kMasked ? sup_off[row] : -1, [&] { w.step(); });
  w.store_dq(dq + (int64_t)row * d);
}

// ---------------------------------------------------------------- launch

// Calls K<kVec, kLanes, kReps>::run(args...) with the widest vector of floats
// that d and the float operands' addresses `addr` allow, 16 lanes a pair where
// they hold a row (two pairs a warp at once), and as few vectors a lane as
// hold it: one at D=50 and D=64. Both kernels are given the addresses of q
// and cat (the backward also those of dq, which the wrapper allocates as
// aligned as any tensor), so they take one layout and form the same al.
template <template <int, int, int> class K, typename... Args>
int by_layout(int d, uintptr_t addr, Args... args) {
  const int vec = d % 4 == 0 && addr % 16 == 0 ? 4 : d % 2 == 0 && addr % 8 == 0 ? 2 : 1;
  const int chunks = (d + vec - 1) / vec;
  if (chunks <= 16) {
    return vec == 4   ? K<4, 16, 1>::run(args...)
           : vec == 2 ? K<2, 16, 1>::run(args...)
                      : K<1, 16, 1>::run(args...);
  }
  if (chunks <= 32) {
    return vec == 4   ? K<4, 32, 1>::run(args...)
           : vec == 2 ? K<2, 32, 1>::run(args...)
                      : K<1, 32, 1>::run(args...);
  }
  return vec == 2 ? K<2, 32, 2>::run(args...)
                  : chunks <= 64 ? K<1, 32, 2>::run(args...) : K<1, 32, 4>::run(args...);
}

uintptr_t addr_of(const void* a, const void* b, const void* c = nullptr) {
  return reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
         reinterpret_cast<uintptr_t>(c);
}

int blocks_for(int bt) { return (bt + kWarps - 1) / kWarps; }

template <bool kMasked, typename C>
struct Fwd {
  template <int kVec, int kLanes, int kReps>
  struct As {
    static int run(const float* q, const float* cat, const C* count, const int* sup_off,
                   float* lse, float* m_safe, float* s, int bt, int d, int x, int64_t count_ld,
                   float inv_tau, cudaStream_t stream) {
      dense_neg_lse_fwd_kernel<kVec, kLanes, kReps, kMasked, C>
          <<<blocks_for(bt), kWarps * 32, 0, stream>>>(q, cat, count, sup_off, lse, m_safe, s,
                                                        bt, d, x, count_ld, inv_tau);
      return (int)cudaGetLastError();
    }
  };
};

template <bool kMasked, typename C>
struct Bwd {
  template <int kVec, int kLanes, int kReps>
  struct As {
    static int run(const float* q, const float* cat, const C* count, const int* sup_off,
                   const float* m_safe, const float* s, const float* gl, float* dq,
                   double* dcat_acc, float* dcat, int bt, int d, int x, int64_t count_ld,
                   float inv_tau, cudaStream_t stream) {
      dense_neg_lse_bwd_kernel<kVec, kLanes, kReps, kMasked, C>
          <<<blocks_for(bt), kWarps * 32, 0, stream>>>(q, cat, count, sup_off, m_safe, s, gl,
                                                        dq, dcat_acc, bt, d, x, count_ld,
                                                        inv_tau);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      const int64_t n = (int64_t)x * d;
      if (n > 0) {
        const int threads = 256;
        const int64_t need = (n + threads - 1) / threads, most = 132 * 16;  // 16 an H100 SM
        round_dcat_kernel<<<(int)(need < most ? need : most), threads, 0, stream>>>(dcat_acc,
                                                                                   dcat, n);
      }
      return (int)cudaGetLastError();
    }
  };
};

template <bool kMasked, typename C>
int launch_fwd(const float* q, const float* cat, const C* count, const int* sup_off,
               float* lse, float* m_safe, float* s, int bt, int d, int x, int64_t count_ld,
               float inv_tau, cudaStream_t stream) {
  return by_layout<Fwd<kMasked, C>::template As>(d, addr_of(q, cat), q, cat, count, sup_off,
                                                  lse, m_safe, s, bt, d, x, count_ld, inv_tau,
                                                  stream);
}

template <bool kMasked, typename C>
int launch_bwd(const float* q, const float* cat, const C* count, const int* sup_off,
               const float* m_safe, const float* s, const float* gl, float* dq,
               double* dcat_acc, float* dcat, int bt, int d, int x, int64_t count_ld,
               float inv_tau, cudaStream_t stream) {
  return by_layout<Bwd<kMasked, C>::template As>(d, addr_of(q, cat, dq), q, cat, count,
                                                  sup_off, m_safe, s, gl, dq, dcat_acc, dcat,
                                                  bt, d, x, count_ld, inv_tau, stream);
}

}  // namespace

extern "C" {

// Widest depth the kernels take (32 lanes of 4 floats a row).
int dense_neg_lse_max_depth() { return 128; }

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
