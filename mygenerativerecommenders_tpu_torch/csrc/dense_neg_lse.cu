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
// templated on the count's type, so the uint8 instantiation is the code that
// ran before int32 counts existed; sup_off takes uint8 counts only.
//
// What bounds it. At BT=26,880, D=50, X=3,706 the dense products are 10.0
// GFLOP forward and 19.9 GFLOP more backward in fp32 FMA, and both passes read
// the 99.6 MB uint8 count. Only the live logits are needed for the result
// (R=128 draws a row: ~3.4% of the row), so the least the card must do is read
// count (~30 us at 3.35 TB/s); this version computes every logit, as the TPU
// kernel does, and is bound by its own FMA loops.
//
// Design. The TPU kernel's b-major [BT, HI, 128] count layout, its radix-256
// unpacking and its one-x-block restriction exist for Mosaic and are not
// carried over: count is plain [BT, X] bytes and the catalog may be any width
// (so the backward computes the function of `_bwd_dq_kernel3` /
// `_bwd_dcat_kernel3`, :491 / :509, as well). One block of 256 threads owns 64
// rows and streams the catalog through shared memory 64 rows at a time. Both
// operands of the logits product are staged transposed ([D][64+4]) so that a
// thread reads its 4 rows and 4 columns as two float4s per depth step and
// does 16 FMAs on them.
//   forward: each thread carries an online (m, s) for its 4 rows over its
//     share of the columns; the 16 threads of a row merge theirs with
//     shuffles at the end.
//   backward: the thread writes dal of its 4x4 logits to shared memory; then
//     the block forms dq += dal cat_tile (kept in registers over the whole
//     catalog, rows 4ty..4ty+3, columns tx, tx+16, ...) and the tile's
//     dcat partial dal^T q_tile, which it adds into the zeroed dcat with
//     atomicAdd, since every row block contributes to every catalog row.
//     dal is mostly zero, so both products skip a depth step whose dal
//     values are zero for the whole warp. Float atomics sum in an order that
//     changes from run to run, so dcat differs in its last bits between runs;
//     lse and dq are deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;       // rows of q per block
constexpr int kBN = 64;       // catalog rows per tile
constexpr int kLdT = kBM + 4; // transposed tiles: 16-byte aligned, 4d + r banks
constexpr int kLdDal = kBN + 1;
constexpr float kNoLogit = -1e30f;

// Stages `rows_valid` rows of a row-major [*, d] matrix, starting at `src`,
// transposed into dst_t[d][kLdT] and, if dst_rm is given, row-major into
// dst_rm[64][ld_rm] (columns past d zeroed); rows past `rows_valid` are zeros.
// A warp takes 4 rows x 8 consecutive columns: whole 32-byte sectors from
// device memory, distinct banks in dst_t.
__device__ __forceinline__ void stage_tile(float* dst_t, float* dst_rm, int ld_rm,
                                           const float* __restrict__ src, int d,
                                           int rows_valid) {
  const int r_lo = threadIdx.x >> 3;  // 0..31
  const int d_lo = threadIdx.x & 7;
  const int d_end = dst_rm ? ld_rm - 8 : d;  // dst_rm: all 16*kDC columns a thread reads
  for (int r = r_lo; r < kBM; r += kThreads / 8) {
    for (int c = d_lo; c < d_end; c += 8) {
      const float x = r < rows_valid && c < d ? src[(int64_t)r * d + c] : 0.f;
      if (c < d) dst_t[c * kLdT + r] = x;
      if (dst_rm) dst_rm[r * ld_rm + c] = x;
    }
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

  stage_tile(q_t, nullptr, 0, q + (int64_t)row0 * d, d, bt - row0);
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
    stage_tile(c_t, nullptr, 0, cat + (int64_t)x0 * d, d, x - x0);
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

// kDC: depth columns per thread, ceil(d / 16)
template <int kDC, bool kMasked, typename C>
__global__ void __launch_bounds__(kThreads) dense_neg_lse_bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ cat,
    const C* __restrict__ count, const int* __restrict__ sup_off,
    const float* __restrict__ m_safe, const float* __restrict__ s_in,
    const float* __restrict__ gl, float* __restrict__ dq, float* __restrict__ dcat,
    int bt, int d, int x, int64_t count_ld, float inv_tau) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kLd = 16 * kDC + 8;  // row-major tiles: 72r + c banks
  float* q_t = smem;                 // [d][kLdT]
  float* c_t = q_t + d * kLdT;       // [d][kLdT]
  float* q_r = c_t + d * kLdT;       // [kBM][kLd]
  float* c_r = q_r + kBM * kLd;      // [kBN][kLd]
  float* dal_s = c_r + kBN * kLd;    // [kBM][kLdDal]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kBM;

  stage_tile(q_t, q_r, kLd, q + (int64_t)row0 * d, d, bt - row0);
  int sup[4];
  load_sup<kMasked>(sup, sup_off, row0 + 4 * ty, bt);
  float mi[4], coef[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    const float si = row < bt ? s_in[row] : 0.f;
    mi[i] = row < bt ? m_safe[row] : 0.f;
    coef[i] = si > 0.f ? gl[row] / fmaxf(si, 1e-30f) * inv_tau : 0.f;
  }
  float dq_acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dq_acc[i][c] = 0.f;

  for (int x0 = 0; x0 < x; x0 += kBN) {
    __syncthreads();  // the last tile's readers are done with c_t/c_r/dal_s
    stage_tile(c_t, c_r, kLd, cat + (int64_t)x0 * d, d, x - x0);
    C cnt[4][4];
    load_counts<kMasked>(cnt, count, count_ld, sup, row0 + 4 * ty, x0 + 4 * tx, bt, x);
    __syncthreads();
    float acc[4][4];
    logits_4x4(acc, q_t, c_t, d, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dal_s[(4 * ty + i) * kLdDal + 4 * tx + j] =
            cnt[i][j] ? (float)cnt[i][j] * expf(acc[i][j] * inv_tau - mi[i]) * coef[i]
                      : 0.f;
    __syncthreads();

    // dq[4ty+i, tx+16c] += sum_xx dal[4ty+i, xx] cat[x0+xx, tx+16c]
    for (int xx = 0; xx < kBN; ++xx) {
      float a[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = dal_s[(4 * ty + i) * kLdDal + xx];
        any |= a[i] != 0.f;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float bc = c_r[xx * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][c] = fmaf(a[i], bc, dq_acc[i][c]);
      }
    }
    // dcat[x0+4ty+i, tx+16c] += sum_r dal[r, 4ty+i] q[row0+r, tx+16c]
    float dc[4][kDC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < kDC; ++c) dc[i][c] = 0.f;
    for (int r = 0; r < kBM; ++r) {
      float a[4];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = dal_s[r * kLdDal + 4 * ty + i];
        any |= a[i] != 0.f;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float bc = q_r[r * kLd + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dc[i][c] = fmaf(a[i], bc, dc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = x0 + 4 * ty + i;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int e = tx + 16 * c;
        if (col < x && e < d && dc[i][c] != 0.f)
          atomicAdd(&dcat[(int64_t)col * d + e], dc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int e = tx + 16 * c;
      if (row < bt && e < d) dq[(int64_t)row * d + e] = dq_acc[i][c];
    }
  }
}

long long fwd_smem_bytes(int d) { return 4LL * 2 * d * kLdT; }

long long bwd_smem_bytes(int d, int dc) {
  return 4LL * (2LL * d * kLdT + 2LL * kBM * (16 * dc + 8) + kBM * kLdDal);
}

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

template <int kDC, bool kMasked, typename C>
int launch_bwd(const float* q, const float* cat, const C* count,
               const int* sup_off, const float* m_safe, const float* s,
               const float* gl, float* dq, float* dcat, int bt, int d, int x,
               int64_t count_ld, float inv_tau, cudaStream_t stream) {
  const long long smem = bwd_smem_bytes(d, kDC);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_neg_lse_bwd_kernel<kDC, kMasked, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_neg_lse_bwd_kernel<kDC, kMasked, C>
      <<<(bt + kBM - 1) / kBM, kThreads, (size_t)smem, stream>>>(
          q, cat, count, sup_off, m_safe, s, gl, dq, dcat, bt, d, x, count_ld, inv_tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widest depth the backward takes (8 depth columns a thread).
int dense_neg_lse_max_depth() { return 128; }

// Dynamic shared memory one block needs, in bytes.
long long dense_neg_lse_fwd_smem_bytes(int d) { return fwd_smem_bytes(d); }
long long dense_neg_lse_bwd_smem_bytes(int d) { return bwd_smem_bytes(d, d <= 64 ? 4 : 8); }

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

// dcat [x, d] must arrive zeroed; dq [bt, d] is written whole. count, wide
// and sup_off as in dense_neg_lse_fwd.
int dense_neg_lse_bwd(const float* q, const float* cat, const void* count,
                      const int* sup_off, const float* m_safe, const float* s,
                      const float* gl, float* dq, float* dcat, int bt, int d, int x,
                      long long count_ld, float inv_tau, int wide, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* c8 = static_cast<const uint8_t*>(count);
  if (sup_off) {
    if (wide) return (int)cudaErrorInvalidValue;
    return d <= 64 ? launch_bwd<4, true>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat, bt,
                                         d, x, count_ld, inv_tau, st)
                   : launch_bwd<8, true>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat, bt,
                                         d, x, count_ld, inv_tau, st);
  }
  if (wide) {
    const int* c32 = static_cast<const int*>(count);
    return d <= 64 ? launch_bwd<4, false>(q, cat, c32, sup_off, m_safe, s, gl, dq, dcat, bt,
                                          d, x, count_ld, inv_tau, st)
                   : launch_bwd<8, false>(q, cat, c32, sup_off, m_safe, s, gl, dq, dcat, bt,
                                          d, x, count_ld, inv_tau, st);
  }
  return d <= 64 ? launch_bwd<4, false>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat, bt, d,
                                        x, count_ld, inv_tau, st)
                 : launch_bwd<8, false>(q, cat, c8, sup_off, m_safe, s, gl, dq, dcat, bt, d,
                                        x, count_ld, inv_tau, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
