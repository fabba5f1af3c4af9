// Forward flash attention in bfloat16 for Hopper (sm_90a): TMA loads into a
// shared-memory ring, wgmma on the tensor cores, the online softmax in
// registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// _flash_kernel (launched by flash_attention) for bfloat16 inputs; float32
// calls take flash_attention_3xtf32.cu's kernel.  For q [B, H, S, D] and
// k, v [B, Hkv, T, D], all bfloat16, D in {16, 32, 64, 128}:
//
//   m ← max(m, rowmax(logits));  p = exp(logits − m) (0 under the mask)
//   l ← l·α + rowsum(p);         acc ← acc·α + p·V_tile,  α = exp(m_old − m)
//   out = acc / max(l, 1e-30), rounded once to bfloat16.
//
// Masks come from positions that start at 0 for queries and keys alike:
// causal keeps key ≤ query, a chunk keeps key // chunk == query // chunk,
// and keys at or past T are masked.  The KV head of query head h is
// h / (H / Hkv): K and V are never repeated.
//
// What bounds it on an H100: tensor-core operations (4·D per visible
// query–key pair at 989 TFLOP/s in bfloat16; the bytes, each of q, k, v and
// out once, take a tenth of that at llama3.2-3B's S = T = 4096).  The design:
//
// - Work split.  One block per (b·h, tile of BQ = 128 query rows), the
//   longest causal tiles launched first.  Warpgroups 0 and 1 each own 64
//   rows; warp 8 is the producer, whose one thread issues every TMA load.
// - Loads.  The Q tile arrives once; K and V tiles of BK = 64 keys stream
//   through a STAGES-deep ring, each slot guarded by a "full" mbarrier (TMA
//   transaction bytes) and an "empty" one (every consumer thread arrives
//   once its warpgroup's wgmma no longer reads the slot, or, for a tile the
//   warpgroup skips, once the slot has been filled).  The tensor maps
//   are 3-D (D, rows, b·h), so the ragged end of a head's rows is
//   zero-filled, never the next head's.  Rows are cut into boxes of
//   min(D, 64) columns, swizzled at the box's row width: 128 B for D ≥ 64
//   (two boxes at D = 128), 64 B for D = 32, 32 B for D = 16, which is what
//   the wgmma descriptors read.
// - S = Q·Kᵀ: wgmma m64n64k16, bfloat16 products (exact in float32) summed
//   in float32 accumulators, both operands K-major in shared memory.
// - Online softmax in registers: each thread holds two rows' slots of the
//   accumulator; row maxima are taken over the quad of lanes that share a
//   row with shuffles.  p = exp2(s·scale·log2 e − m), with the scaled
//   logit and the subtraction in one explicit fmaf (the build uses
//   --fmad=false); m is kept in those log2 units.  A masked logit is −inf,
//   so its p is exactly 0 and a row that sees nothing keeps m = −1e30.
// - O += P·V: wgmma m64nDk16 with P from registers and V from shared
//   memory (MN-major).  The reference computes p·v in float32, so P is
//   split into a bfloat16 high part and the bfloat16 rounding of the rest,
//   p ≈ hi + lo to about 2^-16 of p, and both products go to the tensor
//   cores against the same V tile (1.5× the work of one bfloat16 P, still
//   far above the CUDA cores' float32 rate).
// - Pipelining inside a warpgroup: tile j's Q·Kᵀ and tile j − 1's P·V are
//   issued together, and tile j's softmax runs while P·V is in flight; the
//   two warpgroups of a block also overlap each other.
// - Tile skipping.  A block walks only the KV tiles that its live rows can
//   see through the causal and chunk masks; a warpgroup releases, without
//   computing on it, a tile that hides every key from all its rows.  Masks
//   are applied element by element only on the tiles that straddle an
//   edge.  Skipping is exact: such a tile would add p = 0 with α = 1.
// - Epilogue: divide by max(l, 1e-30) and round once to bfloat16.
//
// The tensor maps are encoded on the host in the C entry point through
// cuTensorMapEncodeTiled, reached with cudaGetDriverEntryPoint(ByVersion),
// so the library needs no -lcuda.
#include <cuda_bf16.h>

#include "flash_sm90.cuh"

namespace grafs {
namespace sm90 {

constexpr int CONSUMERS = 2;                  // warpgroups of 64 query rows
constexpr int BQ = 64 * CONSUMERS;            // query rows per block
constexpr int BK = 64;                        // keys per KV tile
constexpr int STAGES = 3;                     // K/V slots in the ring
constexpr int THREADS = CONSUMERS * WG_THREADS + 32;   // + the producer warp

// The shared-memory geometry at head dim D.  Every box starts on a 1024-byte
// boundary, a multiple of each swizzle pattern's period.
template <int D>
struct Geo {
  static constexpr int COLS = D < 64 ? D : 64;      // columns of one box
  static constexpr int NBOX = D / COLS;             // boxes per row
  static constexpr int ROW_B = COLS * 2;            // box row bytes = swizzle
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : ROW_B == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr uint64_t LAYOUT = ROW_B == 128 ? 1 : ROW_B == 64 ? 2 : 3;
  static constexpr int SBO = 8 * ROW_B;             // 8-row group stride
  static constexpr int KSTEPS_BOX = COLS / 16;      // k16 steps per box
  static constexpr int Q_BOX = BQ * ROW_B;
  static constexpr int KV_BOX = BK * ROW_B;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;    // K or V of one slot
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES + 1024;
};

// D(64×N, float32) (+)= A(64×16, shared memory, K-major) · B(16×N, shared
// memory, K-major); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D(64×N, float32) += A(64×16, bfloat16 pairs in registers) · B(16×N,
// shared memory, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two neighbouring p values (a in the lower column) as a bfloat16 pair, and
// the pair of what each rounding left over.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a);
  const __nv_bfloat16 hb = __float2bfloat16_rn(b);
  hi = pack_bf16(ha, hb);
  lo = pack_bf16(__float2bfloat16_rn(a - __bfloat162float(ha)),
                 __float2bfloat16_rn(b - __bfloat162float(hb)));
}

// S(64×BK) = Q(64×D)·K_tileᵀ, issued as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[BK / 2],
                                             uint32_t q_wg, uint32_t ks) {
  using G = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / G::KSTEPS_BOX;
    const int off = (kk % G::KSTEPS_BOX) * 32;
    wgmma_ss<BK>(sc,
                 smem_desc(q_wg + box * G::Q_BOX + off, 16, G::SBO,
                           G::LAYOUT),
                 smem_desc(ks + box * G::KV_BOX + off, 16, G::SBO, G::LAYOUT),
                 kk > 0);
  }
  wg_commit();
}

// O(64×D) += P(64×BK)·V_tile, issued as one wgmma group: P's high part,
// then its low part, against the same V.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&ph)[BK / 16][4],
                                         const uint32_t (&pl)[BK / 16][4],
                                         uint32_t vs) {
  using G = Geo<D>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = smem_desc(vs + kk * 16 * G::ROW_B, G::KV_BOX, G::SBO,
                                  G::LAYOUT);
    wgmma_rs<D>(o, ph[kk], dv);
    wgmma_rs<D>(o, pl[kk], dv);
  }
  wg_commit();
}

// p as wgmma A fragments, high and low part: k16 step kk covers n8 blocks
// 2kk and 2kk + 1.
__device__ __forceinline__ void to_fragments(const float (&p)[BK / 2],
                                             uint32_t (&ph)[BK / 16][4],
                                             uint32_t (&pl)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = 8 * kk + 2 * r;
      split_pair(p[at], p[at + 1], ph[kk][r], pl[kk][r]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ out, int BH, int H, int Hkv,
                  int S, int T_, int causal, int chunk, float scale_log2,
                  int n_qt) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + G::Q_BYTES;        // slot s: K, then V
  const uint32_t full = smem_u32(bars);          // + 8·s
  const uint32_t empty = full + 8 * STAGES;      // + 8·s
  const uint32_t q_bar = full + 16 * STAGES;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = qt * BQ;
  int k_lo, k_hi;
  key_range(q0, min(q0 + BQ, S) - 1, T_, causal, chunk, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == CONSUMERS) {
    // The producer: one thread issues Q, then K and V tile by tile.
    if (threadIdx.x != CONSUMERS * WG_THREADS) return;
    mbar_expect_tx(q_bar, G::Q_BYTES);
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c)
      tma_load(q_s + c * G::Q_BOX, &qmap, q_bar, c * G::COLS, q0, bh);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
      mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
      const int k0 = (t_lo + it) * BK;
      const uint32_t ks = kv_s + s * 2 * G::KV_BYTES;
#pragma unroll
      for (int c = 0; c < G::NBOX; ++c) {
        tma_load(ks + c * G::KV_BOX, &kmap, full + 8 * s, c * G::COLS, k0,
                 kvh);
        tma_load(ks + G::KV_BYTES + c * G::KV_BOX, &vmap, full + 8 * s,
                 c * G::COLS, k0, kvh);
      }
    }
    return;
  }

  // A consumer warpgroup: rows wq0 .. wq0 + 63; this thread holds rows r0
  // and r0 + 8, and of each n8 block j of an accumulator the columns
  // 8j + 2·(lane % 4) and the one after (slots 4j, 4j+1 for r0; 4j+2, 4j+3
  // for r0 + 8).
  const int tid = threadIdx.x % WG_THREADS;
  const int lane = tid % 32;
  Rows w;
  w.wq0 = q0 + 64 * wg;
  w.wq1 = min(w.wq0 + 63, S - 1);
  w.r0 = w.wq0 + 16 * (tid / 32) + lane / 4;
  w.c_lane = 2 * (lane % 4);
  w.T_ = T_;
  w.causal = causal;
  w.chunk = chunk;
  w.scale_log2 = scale_log2;
  // this warpgroup's tiles, as block iterations [ia, ib)
  int ia = 0, ib = 0;
  if (w.wq0 < S) {
    int lo, hi;
    key_range(w.wq0, w.wq1, T_, causal, chunk, lo, hi);
    if (hi > lo) {
      ia = lo / BK - t_lo;
      ib = (hi + BK - 1) / BK - t_lo;
    }
  }
  float o[D / 2], sc[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  uint32_t ph[BK / 16][4], pl[BK / 16][4];
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, a0, a1;
  mbar_wait(q_bar, 0);
  const uint32_t q_wg = q_s + wg * 64 * G::ROW_B;
  auto k_slot = [&](int it) {                  // V follows at + KV_BYTES
    return kv_s + (it % STAGES) * 2 * G::KV_BYTES;
  };
  auto wait_full = [&](int it) {
    mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto release = [&](int it) { mbar_arrive(empty + 8 * (it % STAGES)); };

  // A tile this warpgroup skips is released once it has been filled: an
  // arrival on the empty barrier before the slot's load was issued would
  // count towards the slot's previous use.
  for (int it = 0; it < ia; ++it) {
    wait_full(it);
    release(it);
  }
  if (ia < ib) {
    wait_full(ia);
    issue_scores<D>(sc, q_wg, k_slot(ia));
    wg_wait<0>();
    fence_regs(sc);
    softmax_tile<BK>(sc, (t_lo + ia) * BK, w, m0, m1, l0, l1, a0, a1);
    to_fragments(sc, ph, pl);
    // Tile it's scores and tile it − 1's P·V go to the tensor cores
    // together; tile it's softmax runs while P·V is still in flight.
    for (int it = ia + 1; it < ib; ++it) {
      wait_full(it);
      issue_scores<D>(sc, q_wg, k_slot(it));
      issue_pv<D>(o, ph, pl, k_slot(it - 1) + G::KV_BYTES);
      wg_wait<1>();
      fence_regs(sc);
      softmax_tile<BK>(sc, (t_lo + it) * BK, w, m0, m1, l0, l1, a0, a1);
      wg_wait<0>();
      fence_regs(o);
      release(it - 1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
      to_fragments(sc, ph, pl);
    }
    issue_pv<D>(o, ph, pl, k_slot(ib - 1) + G::KV_BYTES);
    wg_wait<0>();
    fence_regs(o);
    release(ib - 1);
  }
  for (int it = ib; it < n_tiles; ++it) {
    wait_full(it);
    release(it);
  }

  // epilogue: the quad's partial sums, then one rounding to bfloat16
  float d0, d1;
  row_divisors(l0, l1, d0, d1);
  const long long row0 = static_cast<long long>(bh) * S;
  const int r1 = w.r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + w.c_lane;
    if (w.r0 < S)
      *reinterpret_cast<uint32_t*>(out + (row0 + w.r0) * D + col) =
          pack_bf16(__float2bfloat16_rn(o[4 * j] / d0),
                    __float2bfloat16_rn(o[4 * j + 1] / d0));
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(out + (row0 + r1) * D + col) =
          pack_bf16(__float2bfloat16_rn(o[4 * j + 2] / d1),
                    __float2bfloat16_rn(o[4 * j + 3] / d1));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int T_, int causal, int chunk, float scale,
           cudaStream_t st) {
  using G = Geo<D>;
  const int n_qt = (S + BQ - 1) / BQ;
  const long long bh = static_cast<long long>(B) * H;
  const long long blocks = bh * n_qt;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(
      cudaErrorInvalidConfiguration);
  CUtensorMap qm, km, vm;
  // T = 0: a map of one (never loaded) row; every block's key range is empty
  const int t_rows = T_ > 0 ? T_ : 1;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long planes = static_cast<long long>(B) * Hkv;
  if (!encode(&qm, BF16, 2, q, D, S, bh, G::COLS, BQ, G::SWIZZLE) ||
      !encode(&km, BF16, 2, k, D, t_rows, planes, G::COLS, BK, G::SWIZZLE) ||
      !encode(&vm, BF16, 2, v, D, t_rows, planes, G::COLS, BK, G::SWIZZLE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_sm90_kernel<D><<<static_cast<unsigned>(blocks), THREADS, G::SMEM,
                         st>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), static_cast<int>(bh), H,
      Hkv, S, T_, causal, chunk, scale * LOG2E, n_qt);
  return static_cast<int>(cudaGetLastError());
}

inline int dispatch(const void* q, const void* k, const void* v, void* out,
                    int B, int H, int Hkv, int S, int T_, int D, int causal,
                    int chunk, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16>(q, k, v, out, B, H, Hkv, S, T_, causal, chunk,
                               scale, st);
    case 32: return launch<32>(q, k, v, out, B, H, Hkv, S, T_, causal, chunk,
                               scale, st);
    case 64: return launch<64>(q, k, v, out, B, H, Hkv, S, T_, causal, chunk,
                               scale, st);
    case 128: return launch<128>(q, k, v, out, B, H, Hkv, S, T_, causal,
                                 chunk, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace sm90
}  // namespace grafs

// q/out [B, H, S, D], k/v [B, Hkv, T, D], all bfloat16, 16-byte aligned and
// contiguous; D in {16, 32, 64, 128}; chunk <= 0 means no chunk mask.
// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int grafs_flash_sm90(const void* q, const void* k, const void* v,
                                void* out, int B, int H, int Hkv, int S,
                                int T_, int D, int causal, int chunk,
                                float scale, void* stream) {
  return grafs::sm90::dispatch(q, k, v, out, B, H, Hkv, S, T_, D, causal,
                               chunk, scale, static_cast<cudaStream_t>(stream));
}

// The compiled kernel's registers per thread, local (spill) bytes per
// thread, static and dynamic shared-memory bytes per block, into attrs[4].
extern "C" int grafs_flash_sm90_attributes(int D, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t err;
  int smem = 0;
  switch (D) {
#define GRAFS_SM90_ATTR(d)                                                 \
    case d:                                                               \
      err = cudaFuncGetAttributes(&fa, grafs::sm90::flash_sm90_kernel<d>); \
      smem = grafs::sm90::Geo<d>::SMEM;                                   \
      break;
    GRAFS_SM90_ATTR(16)
    GRAFS_SM90_ATTR(32)
    GRAFS_SM90_ATTR(64)
    GRAFS_SM90_ATTR(128)
#undef GRAFS_SM90_ATTR
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = smem;
  return 0;
}
