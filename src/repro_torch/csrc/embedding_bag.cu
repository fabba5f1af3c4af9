// Fixed-width EmbeddingBag for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/embedding_bag.py
// _bag_kernel and _bag_kernel_weighted (launched by embedding_bag): out[b]
// = Σ_k table[idx[b, k]] (times weights[b, k] when given), divided by K in
// mean mode, weights or not.
//
// One thread per (bag, column), the (bag, column) pairs flattened onto the
// grid, so a warp reads 32 neighbouring columns of one table row: 128
// coalesced bytes in float32.  Each thread sums the K rows in slot order in
// float32, ((x0 + x1) + x2) + …, starting from 0; with weights each row is
// multiplied by its weight before it is added; mean divides by K after the
// sum.  It writes the table's type.  Built with --fmad=false, so the plain
// version (kernels/embedding_bag.py _bag_plain), which adds in the same
// order, agrees bitwise.
//
// Indices follow JAX's table[idx]: a negative index wraps once (idx + V),
// then every index is clamped into [0, V).
//
// What bounds it on an H100: bytes — the referenced rows, the indices, the
// weights and the output, with one multiply-add per element read.
#include <cstdint>

#include "dtypes.cuh"

namespace grafs {

template <class T>
__global__ void __launch_bounds__(256)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long V, int D, long long B, int K, int mean) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * D) return;
  const long long b = t / D;
  const int d = (int)(t % D);
  const int* ib = idx + b * K;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    long long i = ib[k];
    if (i < 0) i += V;
    i = i < 0 ? 0 : (i >= V ? V - 1 : i);
    float x = to_f(table[i * D + d]);
    if (weights != nullptr) x = x * weights[b * K + k];
    acc = acc + x;
  }
  if (mean) acc = acc / (float)K;
  out[t] = from_f<T>(acc);
}

}  // namespace grafs

// weights may be null (unweighted); dtype is grafs::DT_F32 or DT_BF16 (the
// table's and the output's type); mode 0 = sum, 1 = mean.  Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int grafs_embedding_bag(const void* table, const void* idx,
                                   const void* weights, void* out,
                                   long long V, int D, long long B, int K,
                                   int dtype, int mode, void* stream) {
  const long long n = B * D;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == grafs::DT_BF16)
    grafs::embedding_bag_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)table, (const int*)idx, (const float*)weights,
        (__nv_bfloat16*)out, V, D, B, K, mode);
  else
    grafs::embedding_bag_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)table, (const int*)idx, (const float*)weights,
        (float*)out, V, D, B, K, mode);
  return (int)cudaGetLastError();
}
