// Masked row softmax over the blocked-ELL slot axis (GAT edge attention),
// for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of src/repro/kernels/segment_softmax.py
// (launched by ell_softmax): _stats_kernel, the online row max and
// sum-exp across slot tiles, and _norm_kernel, the normalising pass.
//
// One warp per row, 8 rows per 256-thread block, rows flattened onto
// blockIdx.x.  Inside the warp a loop over the row's slots takes the place
// of the Pallas grid's sequential slot axis: lane l reads slots l, l + 32,
// … (coalesced).  Pass 1 keeps each lane's running (max m, sum s) over its
// real slots, starting from (-1e30, 0) as the reference does, then merges
// the 32 pairs with a butterfly (m = max(m, m'), s = s·e^(m_old − m) +
// s'·e^(m' − m)).  Pass 2 writes exp(score − m) / max(s, 1e-30) on real
// slots; a masked slot is set to 0 by select, never by multiplying by the
// mask, because the raw score of a masked slot may exponentiate to inf
// (inf·0 = NaN).  An empty row comes out all zeros.  Arithmetic is float32
// for float32 and bfloat16 scores; the output has the scores' type.
//
// What bounds it on an H100: bytes (one read of scores and mask, one write
// of the output: 9 bytes a slot in float32); this simple kernel reads the
// scores and the mask twice, once per pass.
#include <cstdint>
#include <math.h>

#include "dtypes.cuh"

namespace grafs {

constexpr float SOFTMAX_NEG = -1e30f;

template <class T>
__global__ void __launch_bounds__(256)
ell_softmax_kernel(const T* __restrict__ scores,
                   const unsigned char* __restrict__ mask,
                   T* __restrict__ out, long long n_rows, long long width) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;                  // whole warps leave together
  const T* s = scores + row * width;
  const unsigned char* mk = mask + row * width;
  T* o = out + row * width;
  float m = SOFTMAX_NEG, sum = 0.f;
  for (long long c = lane; c < width; c += 32) {
    if (!mk[c]) continue;
    const float x = to_f(s[c]);
    if (x > m) {
      sum = sum * expf(m - x);
      m = x;
    }
    sum = sum + expf(x - m);
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float so = __shfl_xor_sync(0xffffffffu, sum, off);
    const float mn = fmaxf(m, mo);
    sum = sum * expf(m - mn) + so * expf(mo - mn);
    m = mn;
  }
  const float denom = fmaxf(sum, 1e-30f);
  for (long long c = lane; c < width; c += 32) {
    const float w = expf(to_f(s[c]) - m) / denom;
    o[c] = mk[c] ? from_f<T>(w) : from_f<T>(0.f);
  }
}

}  // namespace grafs

// scores/out [n_rows, width] of dtype grafs::DT_F32 or DT_BF16, mask bool
// [n_rows, width].  Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int grafs_ell_softmax(const void* scores, const void* mask,
                                 void* out, long long n_rows, long long width,
                                 int dtype, void* stream) {
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + 7) / 8;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == grafs::DT_BF16)
    grafs::ell_softmax_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        (const __nv_bfloat16*)scores, (const unsigned char*)mask,
        (__nv_bfloat16*)out, n_rows, width);
  else
    grafs::ell_softmax_kernel<float><<<blocks, 256, 0, st>>>(
        (const float*)scores, (const unsigned char*)mask, (float*)out,
        n_rows, width);
  return (int)cudaGetLastError();
}
