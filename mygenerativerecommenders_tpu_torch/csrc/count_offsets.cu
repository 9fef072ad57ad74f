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
// keeps an X-bin histogram in shared memory, laid out as the row's bytes in
// device memory, and writes it out with 16-byte stores.
//   - The histogram: bin x sits at element b = x + pad, where pad is the
//     row's offset in elements from the 16-byte boundary below its start
//     (rows start at i * X elements: X = 3,706 starts most rows mid-vector),
//     so the histogram and the output row share their alignment. uint8
//     counts take four bins to a 32-bit word (a draw adds 1 << 8*(b & 3) to
//     word b >> 2 with a shared atomic; bins cannot carry into their
//     neighbours since each stays <= 255), the byte order of the output. With R > 255
//     draws a bin could pass 255, so the int32 instantiation (kWide) keeps
//     one bin to a word and writes int32.
//   - The row out: every whole 16-byte slot as one uint4 store, neighbouring
//     threads on neighbouring slots; the partial first and last slots element
//     by element. Every element of the output is written here: the wrapper
//     allocates it with torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

template <bool kWide>
__global__ void __launch_bounds__(kThreads) count_offsets_kernel(
    const int* __restrict__ offsets, const int* __restrict__ positive,
    void* __restrict__ count, int r, int x) {
  using C = std::conditional_t<kWide, int, uint8_t>;
  constexpr int kPer = 16 / (int)sizeof(C);  // elements in 16 bytes
  extern __shared__ uint4 bins_v[];          // [x / kPer + 2]: the row from its 16-byte boundary
  unsigned* bins = reinterpret_cast<unsigned*>(bins_v);
  const int64_t row = blockIdx.x;
  C* out = static_cast<C*>(count) + row * x;
  const int pad = (int)(reinterpret_cast<uintptr_t>(out) & 15) / (int)sizeof(C);
  const int nslot = (pad + x + kPer - 1) / kPer;
  for (int j = threadIdx.x; j < nslot; j += kThreads) bins_v[j] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int pos = positive[row];
  const int* off = offsets + row * r;
  for (int e = threadIdx.x; e < r; e += kThreads) {
    const int o = off[e];
    if (o >= 0 && o < x && o != pos) {
      const int b = o + pad;
      if (kWide)
        atomicAdd(&bins[b], 1u);
      else
        atomicAdd(&bins[b >> 2], 1u << (8 * (b & 3)));
    }
  }
  __syncthreads();
  // slots [whole0, whole1) lie inside the row; the row's head before them and
  // its tail after them are each less than a slot
  const int whole0 = pad ? 1 : 0, whole1 = (pad + x) / kPer;
  uint4* out_v = reinterpret_cast<uint4*>(out - pad);
  for (int j = whole0 + threadIdx.x; j < whole1; j += kThreads) out_v[j] = bins_v[j];
  const C* row_s = reinterpret_cast<const C*>(bins_v) + pad;  // element e of the row
  const int head = pad ? min(x, kPer - pad) : 0;
  const int tail = max(head, whole1 * kPer - pad);
  if ((int)threadIdx.x < head) out[threadIdx.x] = row_s[threadIdx.x];
  if ((int)threadIdx.x < x - tail) out[tail + threadIdx.x] = row_s[tail + threadIdx.x];
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
  return 16LL * (x / (wide ? 4 : 16) + 2);
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
