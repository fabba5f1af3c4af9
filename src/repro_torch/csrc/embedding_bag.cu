// Fixed-width EmbeddingBag for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/embedding_bag.py
// _bag_kernel and _bag_kernel_weighted (launched by embedding_bag): out[b]
// = Σ_k table[idx[b, k]] (times weights[b, k] when given), divided by K in
// mean mode, weights or not.
//
// Geometry: a block of (lanes × bags) threads, the grid over bags (bag b =
// blockIdx.x · bags + threadIdx.y, no division per element).  A thread owns
// VEC consecutive columns of its bag: on the vector path VEC = 16 bytes'
// worth (4 in float32, 8 in bfloat16), loaded and stored as one 16-byte
// vector, so for DLRM's D = 64 a group of 16 lanes (float32) or 8 lanes
// (bfloat16) covers one row and a warp covers 2 or 4 bags; the scalar path
// (VEC = 1) takes any D and any base alignment.  The wrapper picks the
// path from D and the table's and output's alignment (vector_width).
//
// Loads first: per chunk of CHUNK slots (BAG_CHUNK, 1 for bags of one
// row) a thread loads the chunk's indices, then issues every row load of
// the chunk, then adds, so that CHUNK row loads per thread are in flight
// at once, not one behind each index; the rows stay raw 16-byte words until
// the add.  The sum runs in slot order in float32, ((x0 + x1) + x2) + …,
// starting from 0; with weights each row is multiplied by its weight
// before it is added; mean divides by K after the sum.  It writes the
// table's type.  Built with --fmad=false, so the plain version
// (kernels/embedding_bag.py _bag_plain), which adds in the same order,
// agrees bitwise.
//
// Indices follow JAX's table[idx]: a negative index wraps once (idx + V),
// then every index is clamped into [0, V).
//
// What bounds it on an H100: bytes — the referenced rows, the indices, the
// weights and the output, with one multiply-add per element read.
#include <cstdint>

#include "dtypes.cuh"

namespace grafs {

constexpr int BAG_THREADS = 256;
// Rows in flight per thread.  Two beat four and eight on the RM2 table
// (4,000,000 × 64, K = 8, H100): eight rows of 16 bytes take 69 registers
// in float32 and 79 in bfloat16, and the fuller card wins over the deeper
// queue per thread; one row was within 4 % of two
// (benchmarks/torch_bag_chunks.py).
constexpr int BAG_CHUNK = 2;

// One thread's VEC columns of a row as raw words: one 16-byte vector
// (4 float32 or 8 bfloat16) on the vector path, one element (in .x) on the
// scalar path.  Kept raw until the add, so a chunk of rows in flight costs
// 4 registers a row whatever the type.
template <class T, int VEC>
__device__ __forceinline__ uint4 load_raw(const T* p) {
  if constexpr (VEC == 1) {
    uint4 u{};
    if constexpr (sizeof(T) == 4)
      u.x = __float_as_uint(to_f(*p));
    else
      u.x = __bfloat16_as_ushort(*reinterpret_cast<const __nv_bfloat16*>(p));
    return u;
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte vector");
    return *reinterpret_cast<const uint4*>(p);
  }
}

// Element v of a raw vector as float32 (bfloat16 widens exactly: its bits
// are the float32's upper half, as __bfloat162float gives them).
template <class T, int VEC>
__device__ __forceinline__ float raw_f(const uint4& u, int v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[v]);
  const uint32_t x = VEC == 1 ? w[0] : w[v >> 1];
  return __uint_as_float((v & 1) && VEC > 1 ? x & 0xffff0000u : x << 16);
}

template <class T, int VEC>
__device__ __forceinline__ void store_cols(T* p, const float x[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        __float_as_uint(x[0]), __float_as_uint(x[1]), __float_as_uint(x[2]),
        __float_as_uint(x[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = (uint32_t)__bfloat16_as_ushort(from_f<T>(x[2 * q])) |
             ((uint32_t)__bfloat16_as_ushort(from_f<T>(x[2 * q + 1])) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// CHUNK = rows in flight per thread: 1 for bags of one row, else BAG_CHUNK.
template <class T, int VEC, int CHUNK>
__global__ void __launch_bounds__(BAG_THREADS)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long V, int D, long long B, int K, int mean) {
  const long long b = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int* ib = idx + b * K;
  const float* wb = weights == nullptr ? nullptr : weights + b * K;
  for (int d = threadIdx.x * VEC; d < D; d += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.f;
    for (int k0 = 0; k0 < K; k0 += CHUNK) {
      const int n = K - k0 < CHUNK ? K - k0 : CHUNK;
      long long row[CHUNK];
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        long long i = s < n ? ib[k0 + s] : 0;
        if (i < 0) i += V;
        row[s] = i < 0 ? 0 : (i >= V ? V - 1 : i);
      }
      uint4 x[CHUNK];
#pragma unroll
      for (int s = 0; s < CHUNK; ++s)
        if (s < n) x[s] = load_raw<T, VEC>(table + row[s] * D + d);
      float w[CHUNK];
      if (wb != nullptr) {
#pragma unroll
        for (int s = 0; s < CHUNK; ++s) w[s] = s < n ? wb[k0 + s] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < CHUNK; ++s) {
        if (s < n) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float xv = raw_f<T, VEC>(x[s], v);
            if (wb != nullptr) xv = xv * w[s];
            acc[v] = acc[v] + xv;
          }
        }
      }
    }
    if (mean) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] = acc[v] / (float)K;
    }
    store_cols<T, VEC>(out + b * D + d, acc);
  }
}

// One launch at VEC columns per thread: lanes = D / VEC threads per bag (at
// most BAG_THREADS; wider rows loop), as many bags per block as fit.
template <class T, int VEC, int CHUNK>
inline int launch_bag(const void* table, const void* idx, const void* weights,
                      void* out, long long V, int D, long long B, int K,
                      int mode, cudaStream_t s) {
  const int cols = D / VEC;
  const int lanes = cols < BAG_THREADS ? cols : BAG_THREADS;
  const int bags = BAG_THREADS / lanes;
  const long long blocks = (B + bags - 1) / bags;
  embedding_bag_kernel<T, VEC, CHUNK>
      <<<(unsigned)blocks, dim3(lanes, bags), 0, s>>>(
          (const T*)table, (const int*)idx, (const float*)weights, (T*)out,
          V, D, B, K, mode);
  return (int)cudaGetLastError();
}

template <class T, int VEC>
inline int launch_bag(const void* table, const void* idx, const void* weights,
                      void* out, long long V, int D, long long B, int K,
                      int mode, cudaStream_t s) {
  if (K <= 1)
    return launch_bag<T, VEC, 1>(table, idx, weights, out, V, D, B, K, mode,
                                 s);
  return launch_bag<T, VEC, BAG_CHUNK>(table, idx, weights, out, V, D, B, K,
                                       mode, s);
}

}  // namespace grafs

// weights may be null (unweighted); dtype is grafs::DT_F32 or DT_BF16 (the
// table's and the output's type); mode 0 = sum, 1 = mean; vec is the
// columns per thread, 1 (scalar path) or 16 bytes' worth (vector path,
// which needs D a multiple of vec and table and out 16-byte aligned; any
// other vec is refused).  Returns the launch's cudaGetLastError() (0 =
// launched), cudaErrorInvalidValue for a vec the shape does not allow.
extern "C" int grafs_embedding_bag(const void* table, const void* idx,
                                   const void* weights, void* out,
                                   long long V, int D, long long B, int K,
                                   int dtype, int mode, int vec,
                                   void* stream) {
  if (B == 0 || D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = dtype == grafs::DT_BF16;
  if (vec == 1)
    return bf16 ? grafs::launch_bag<__nv_bfloat16, 1>(table, idx, weights,
                                                      out, V, D, B, K, mode, s)
                : grafs::launch_bag<float, 1>(table, idx, weights, out, V, D,
                                              B, K, mode, s);
  const bool aligned =
      (((uintptr_t)table | (uintptr_t)out) & 15) == 0 && D % vec == 0;
  if (!aligned || vec != (bf16 ? 8 : 4)) return (int)cudaErrorInvalidValue;
  return bf16 ? grafs::launch_bag<__nv_bfloat16, 8>(table, idx, weights, out,
                                                    V, D, B, K, mode, s)
              : grafs::launch_bag<float, 4>(table, idx, weights, out, V, D, B,
                                            K, mode, s);
}
