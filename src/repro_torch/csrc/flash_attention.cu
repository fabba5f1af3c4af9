// Forward flash attention in float32 for Hopper (sm_90a): online-softmax
// attention with causal and chunked-local masks and grouped-query heads, on
// the CUDA cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// _flash_kernel (launched by flash_attention) for float32 inputs; bfloat16
// calls take flash_attention_sm90.cu's tensor-core kernel.  For q [B, H, S,
// D] and k, v [B, Hkv, T, D]:
//
//   m ← max(m, rowmax(logits));  p = exp(logits − m) (0 under the mask)
//   l ← l·α + rowsum(p);         acc ← acc·α + p·V_tile,  α = exp(m_old − m)
//   out = acc / max(l, 1e-30).
//
// Masks come from positions that start at 0 for queries and keys alike:
// causal keeps key ≤ query, a chunk keeps key // chunk == query // chunk,
// and keys at or past T are masked.  Masked logits are −1e30 and their p is
// 0.  The KV head of query head h is h / (H / Hkv): K and V are never
// repeated.
//
// Geometry: 128 threads per block, one block per (b·h, tile of queries),
// flattened onto blockIdx.x.  G = max(1, D / 32) neighbouring lanes share
// one query row, each holding 16 or 32 of its dimensions as float4 chunks
// (chunk g + G·c of the row, so the G lanes of a row read neighbouring
// 16-byte words of shared memory and the rows of a warp read the same key);
// a block holds 128 / G query rows.  The block walks its KV tiles of 32 keys
// in order, staging K and V in shared memory, and skips a tile only when
// the causal or chunk mask hides all of it from every row of the block
// (then α = 1 and p = 0, so skipping is exact).  Both products, q·kᵀ and
// p·v, are float32 fused multiply-adds on the CUDA cores (fmaf, which
// --fmad=false leaves alone: the kernel is held to a tolerance, not
// bitwise, against its plain version); the row's G partial dot products
// are summed with shuffles.
//
// What bounds it on an H100: operations (4·D per unmasked query–key pair at
// the CUDA cores' 67 TFLOP/s in float32).  The tensor cores' TF32 would
// keep about three decimal digits, short of the float32 reference.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace grafs {

constexpr int FA_THREADS = 128;
constexpr int FA_BK = 32;                     // keys per KV tile
constexpr float FA_NEG = -1e30f;

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int Hkv, int S, int T_, int causal, int chunk, float scale,
                 int n_qt) {
  constexpr int G = D >= 32 ? D / 32 : 1;     // lanes per query row
  constexpr int NCH = D / G / 4;              // float4 chunks per lane
  constexpr int BQ = FA_THREADS / G;          // query rows per block
  constexpr int D4 = D / 4;
  __shared__ float4 ks[FA_BK][D4];
  __shared__ float4 vs[FA_BK][D4];
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int r = threadIdx.x / G, g = threadIdx.x % G;
  const int q0 = qt * BQ;
  const int qi = q0 + r;
  const bool live = qi < S;
  const float* qrow = q + ((long long)bh * S + (live ? qi : 0)) * D;
  const long long kv0 = ((long long)b * Hkv + hk) * T_ * D;
  float4 qv[NCH], acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = 4 * (g + G * c);
    qv[c] = make_float4(qrow[d], qrow[d + 1], qrow[d + 2], qrow[d + 3]);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = FA_NEG, l = 0.f;
  // the keys any row of this block may see
  const int q_last = min(q0 + BQ, S) - 1;
  int k_lo = 0, k_hi = T_;
  if (causal) k_hi = min(k_hi, q_last + 1);
  if (chunk > 0) {
    k_lo = (q0 / chunk) * chunk;
    k_hi = min(k_hi, (q_last / chunk + 1) * chunk);
  }
  k_lo = (k_lo / FA_BK) * FA_BK;
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);
  for (int k0 = k_lo; k0 < k_hi; k0 += FA_BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < FA_BK * D; e += FA_THREADS) {
      const int kk = k0 + e / D;
      const long long at = kv0 + (long long)k0 * D + e;
      ksf[e] = kk < T_ ? k[at] : 0.f;
      vsf[e] = kk < T_ ? v[at] : 0.f;
    }
    __syncthreads();
    float p[FA_BK];
    float mt = FA_NEG;
    uint32_t ok = 0;
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kx = ks[j][g + G * c];
        dot = fmaf(qv[c].x, kx.x, dot);
        dot = fmaf(qv[c].y, kx.y, dot);
        dot = fmaf(qv[c].z, kx.z, dot);
        dot = fmaf(qv[c].w, kx.w, dot);
      }
#pragma unroll
      for (int off = G / 2; off >= 1; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kpos = k0 + j;
      const bool vis = kpos < T_ && (!causal || kpos <= qi) &&
                       (chunk <= 0 || kpos / chunk == qi / chunk);
      p[j] = vis ? dot * scale : FA_NEG;
      ok |= (vis ? 1u : 0u) << j;
      mt = fmaxf(mt, p[j]);
    }
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
      p[j] = (ok >> j) & 1u ? expf(p[j] - mn) : 0.f;
      ls += p[j];
    }
    l = l * alpha + ls;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < FA_BK; ++j) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) fma4(acc[c], p[j], vs[j][g + G * c]);
    }
    m = mn;
  }
  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  float* orow = out + ((long long)bh * S + qi) * D;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = 4 * (g + G * c);
    orow[d] = acc[c].x / den;
    orow[d + 1] = acc[c].y / den;
    orow[d + 2] = acc[c].z / den;
    orow[d + 3] = acc[c].w / den;
  }
}

template <int D>
int launch_flash_f32(const float* q, const float* k, const float* v,
                     float* out, int B, int H, int Hkv, int S, int T_,
                     int causal, int chunk, float scale, cudaStream_t st) {
  constexpr int G = D >= 32 ? D / 32 : 1;
  constexpr int BQ = FA_THREADS / G;
  const int n_qt = (S + BQ - 1) / BQ;
  const long long blocks = (long long)B * H * n_qt;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_f32_kernel<D><<<(unsigned)blocks, FA_THREADS, 0, st>>>(
      q, k, v, out, H, Hkv, S, T_, causal, chunk, scale, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace grafs

// q/out [B, H, S, D], k/v [B, Hkv, T, D], all float32; D in {16, 32, 64,
// 128}; chunk <= 0 means no chunk mask.  Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int grafs_flash_f32(const float* q, const float* k,
                               const float* v, float* out, int B, int H,
                               int Hkv, int S, int T_, int D, int causal,
                               int chunk, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 16: return grafs::launch_flash_f32<16>(q, k, v, out, B, H, Hkv, S,
                                                T_, causal, chunk, scale, st);
    case 32: return grafs::launch_flash_f32<32>(q, k, v, out, B, H, Hkv, S,
                                                T_, causal, chunk, scale, st);
    case 64: return grafs::launch_flash_f32<64>(q, k, v, out, B, H, Hkv, S,
                                                T_, causal, chunk, scale, st);
    case 128: return grafs::launch_flash_f32<128>(q, k, v, out, B, H, Hkv, S,
                                                  T_, causal, chunk, scale,
                                                  st);
    default: return (int)cudaErrorInvalidValue;
  }
}
