// Multiplicity matrix of the sampled negatives for Hopper (sm_90a), plain C ABI.
//
// Replaces the TPU kernel mygenerativerecommenders_tpu/ops/pallas/count_kernel.py:58
// (`_kernel`, launched through `count_offsets_packed4_tpu`, :99). For each
// supervision row i it counts how often each catalog offset was drawn:
//
//   count[i, x] = #{r : offsets[i, r] == x},  x != positive[i]
//
// A draw equal to the row's positive offset (an accidental hit) counts 0, and
// so does a draw outside [0, X) (the sentinel that pads rows). count is uint8
// for R <= 255 draws a row, which cannot overflow it, and int32 above (the
// JAX package keeps bf16 counts there, exact up to 256).
//
// What bounds it: bytes. It reads BT*R*4 bytes of offsets and writes BT*X
// bytes of count (at BT=26,880, R=128, X=3,706: 13.8 MB in, 99.6 MB out,
// ~34 us at 3.35 TB/s); the arithmetic is one compare and one add per draw.
//
// Design. The TPU kernel builds the counts as block-diagonal one-hot matrix
// products and packs four catalog slices into one u32 lane (radix 256) in a
// [BT, S/4, 128] layout, because the MXU is the TPU's only fast scatter and
// its consumers read 128-lane slices. A GPU block scatters into its own
// shared memory directly, so none of that is carried over: one block per row
// keeps an X-bin histogram in shared memory, four bins to a 32-bit word (a
// draw adds 1 << 8*(x & 3) to word x >> 2 with a shared atomic; bins cannot
// carry into their neighbours since each stays <= 255), and then writes the
// row out as plain bytes, neighbouring threads to neighbouring addresses.
// With R > 255 draws a bin could pass 255, so the int32 instantiation
// (kWide) keeps one bin to a word (4 X bytes of shared memory) and writes
// int32. Every element of the output is written here: the wrapper allocates
// it with torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool kWide>
__global__ void __launch_bounds__(kThreads) count_offsets_kernel(
    const int* __restrict__ offsets, const int* __restrict__ positive,
    void* __restrict__ count, int r, int x) {
  extern __shared__ unsigned int bins[];  // [(x + 3) / 4], or [x] if kWide
  const int64_t row = blockIdx.x;
  const int words = kWide ? x : (x + 3) >> 2;
  for (int e = threadIdx.x; e < words; e += kThreads) bins[e] = 0u;
  __syncthreads();
  const int pos = positive[row];
  const int* off = offsets + row * r;
  for (int e = threadIdx.x; e < r; e += kThreads) {
    const int o = off[e];
    if (o >= 0 && o < x && o != pos) {
      if (kWide)
        atomicAdd(&bins[o], 1u);
      else
        atomicAdd(&bins[o >> 2], 1u << (8 * (o & 3)));
    }
  }
  __syncthreads();
  if (kWide) {
    int* out = static_cast<int*>(count) + row * x;
    for (int e = threadIdx.x; e < x; e += kThreads) out[e] = (int)bins[e];
  } else {
    uint8_t* out = static_cast<uint8_t*>(count) + row * x;
    for (int e = threadIdx.x; e < x; e += kThreads)
      out[e] = (uint8_t)((bins[e >> 2] >> (8 * (e & 3))) & 0xffu);
  }
}

template <bool kWide>
int launch(const int* offsets, const int* positive, void* count, int bt, int r, int x,
           long long smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        count_offsets_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  count_offsets_kernel<kWide><<<bt, kThreads, (size_t)smem, stream>>>(offsets, positive,
                                                                      count, r, x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs, in bytes.
long long count_offsets_smem_bytes(int x, int wide) {
  return wide ? 4LL * x : 4LL * ((x + 3) / 4);
}

// offsets [bt, r] int32, positive [bt] int32 (-1 = none) -> count [bt, x],
// uint8, or int32 if `wide` (the wrapper sets it for r > 255). Launches on
// `stream` without synchronising; returns cudaGetLastError().
int count_offsets(const int* offsets, const int* positive, void* count, int bt, int r,
                  int x, int wide, void* stream) {
  const long long smem = count_offsets_smem_bytes(x, wide);
  const cudaStream_t st = (cudaStream_t)stream;
  return wide ? launch<true>(offsets, positive, count, bt, r, x, smem, st)
              : launch<false>(offsets, positive, count, bt, r, x, smem, st);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
