// What the two Hopper flash-attention kernels share (flash_attention_sm90.cu
// in bfloat16, flash_attention_3xtf32.cu in float32): mbarriers, 3-D TMA
// loads and their tensor maps, wgmma descriptors, fences and waits, the
// masks, and the online softmax of one KV tile held in wgmma accumulator
// registers.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>

namespace grafs {
namespace sm90 {

constexpr int WG_THREADS = 128;
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni LAB_DONE;\nbra.uni LAB_WAIT;\nLAB_DONE:\n}\n"
      ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2) : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed wgmma groups are still running (groups
// complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading accumulators before wgmma.wait_group.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The keys that rows [qa, qb] see through the masks, [lo, hi).
__device__ __forceinline__ void key_range(int qa, int qb, int T_, int causal,
                                          int chunk, int& lo, int& hi) {
  lo = 0;
  hi = T_;
  if (causal) hi = min(hi, qb + 1);
  if (chunk > 0) {
    lo = (qa / chunk) * chunk;
    hi = min(hi, (qb / chunk + 1) * chunk);
  }
}

__device__ __forceinline__ bool visible(int key, int row, int T_, int causal,
                                        int chunk) {
  return key < T_ && (!causal || key <= row) &&
         (chunk <= 0 || key / chunk == row / chunk);
}

// The mask and scaling facts a warpgroup's softmax needs.
struct Rows {
  int wq0, wq1;         // first and last live row of the warpgroup
  int r0;               // this thread's first row (the other is r0 + 8)
  int c_lane;           // this thread's first column in each n8 block
  int T_, causal, chunk;
  float scale_log2;
};

// Masks the scores of the BK-key tile at key k0 (only where it straddles an
// edge of the mask), folds them into the rows' running max m and sum l,
// and turns them into p in place.  sc is a wgmma accumulator of 64 × BK:
// slots 4j, 4j+1 hold row r0's keys 8j + c_lane and the one after, slots
// 4j+2, 4j+3 row r0 + 8's.  m is in log2 units: p = exp2(s·scale·log2 e −
// m), the scaled logit and the subtraction in one explicit fmaf (the build
// uses --fmad=false).  A masked logit is −inf, so its p is exactly 0 and a
// row that sees nothing keeps m = −1e30.  a0, a1: the factors α that
// rescale the rows' earlier accumulators.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], int k0,
                                             const Rows& w, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
  bool clean = k0 + BK <= w.T_;
  if (w.causal) clean = clean && k0 + BK - 1 <= w.wq0;
  if (w.chunk > 0) {
    const int c = w.wq0 / w.chunk;
    clean = clean && w.wq1 / w.chunk == c && k0 / w.chunk == c &&
            (k0 + BK - 1) / w.chunk == c;
  }
  if (!clean) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + w.c_lane + e;
        if (!visible(key, w.r0, w.T_, w.causal, w.chunk))
          sc[4 * j + e] = -INFINITY;
        if (!visible(key, w.r0 + 8, w.T_, w.causal, w.chunk))
          sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
  }
  const float mn0 = fmaxf(m0, x0 * w.scale_log2);
  const float mn1 = fmaxf(m1, x1 * w.scale_log2);
  a0 = exp2f(m0 - mn0);
  a1 = exp2f(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], w.scale_log2, -mn0));
      sc[4 * j + 2 + e] = exp2f(fmaf(sc[4 * j + 2 + e], w.scale_log2, -mn1));
      s0 += sc[4 * j + e];
      s1 += sc[4 * j + 2 + e];
    }
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
}

// The l of each of the thread's two rows, summed over the quad of lanes that
// share them, as the epilogue's divisors max(l, 1e-30).
__device__ __forceinline__ void row_divisors(float l0, float l1, float& d0,
                                             float& d1) {
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  d0 = fmaxf(l0, 1e-30f);
  d1 = fmaxf(l1, 1e-30f);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a [planes, rows, D] tensor of ``type`` (``elem`` bytes an
// element), boxes of (cols, box_rows, 1).  Rows past ``rows`` read as zeros.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem,
                   const void* ptr, int D, int rows, long long planes,
                   int cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * elem,
                                 static_cast<cuuint64_t>(rows) * D * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace grafs
