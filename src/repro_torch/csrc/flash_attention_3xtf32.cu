// Forward flash attention in float32 for Hopper (sm_90a), with both matrix
// products on the tensor cores as 3xTF32: TMA loads into a shared-memory
// ring, wgmma, the online softmax in registers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// _flash_kernel (launched by flash_attention) for float32 inputs; bfloat16
// calls take flash_attention_sm90.cu's kernel.  For q [B, H, S, D] and k, v
// [B, Hkv, T, D], all float32, D in {16, 32, 64, 128}:
//
//   m ← max(m, rowmax(logits));  p = exp(logits − m) (0 under the mask)
//   l ← l·α + rowsum(p);         acc ← acc·α + p·V_tile,  α = exp(m_old − m)
//   out = acc / max(l, 1e-30).
//
// Masks come from positions that start at 0 for queries and keys alike:
// causal keeps key ≤ query, a chunk keeps key // chunk == query // chunk,
// and keys at or past T are masked.  The KV head of query head h is
// h / (H / Hkv): K and V are never repeated.
//
// Precision.  The reference computes both products in float32.  One TF32
// product keeps 11 significant bits of each operand, short of that, so
// every operand x is split into hi = x rounded to TF32 (to nearest) and
// lo = x − hi rounded to TF32 (x − hi is exact in float32), and a product
// is a_hi·b_hi + a_hi·b_lo + a_lo·b_hi: the dropped a_lo·b_lo and the
// rounding of lo are each at most 2^-22 of the product, float32's own
// order.  The tensor cores round each float32 sum toward zero, so sums
// are kept short and small: the small products go to an accumulator
// before the large ones; S takes one accumulator per 32 dimensions,
// summed on the CUDA cores; and each tile's P·V gets an accumulator of
// its own that is added to the running one there (acc = fmaf(acc, α,
// pv)), so the rounding never builds up over the tiles.
//
// What bounds it on an H100: tensor-core operations, three TF32 products
// of 4·D operations per visible query–key pair at 495 TFLOP/s (the bytes,
// each of q, k, v and out once, take a quarter of that at llama3.2-3B's
// S = T = 1024).  The design:
//
// - Work split.  One block per (b·h, tile of BQ = 64 query rows), the
//   longest causal tiles launched first: one consumer warpgroup and a
//   producer warp whose one thread issues every TMA load.  Q's hi and lo
//   take 64 KB at D = 128, so a block holds one warpgroup's rows
//   (230,400 bytes of shared memory at D = 128, one block per SM).
// - Loads.  The Q tile arrives once; K and V tiles of BK = 32 keys stream
//   through a STAGES-deep ring, each slot guarded by a "full" mbarrier (TMA
//   transaction bytes) and an "empty" one (every consumer thread arrives
//   once no wgmma reads the slot).  The tensor maps are 3-D (D, rows, b·h),
//   so the ragged end of a head's rows is zero-filled, never the next
//   head's.  Rows are cut into boxes of min(D, 32) floats, swizzled at the
//   box's row width: 128 B for D ≥ 32 (four boxes at D = 128), 64 B for
//   D = 16, which is what the wgmma descriptors read.
// - The split, on the CUDA cores.  Q is split once: hi in place, lo beside
//   it.  Each K tile likewise, its lo into one of two buffers.  TF32 wgmma
//   reads its shared-memory operands K-major only, so P·V needs Vᵀ (for
//   each dimension, the keys contiguous); TMA cannot transpose, so the
//   pass that splits V writes hi and lo transposed, into one of two Vᵀ
//   buffers.  A warp reads one key per lane and four dimensions with one
//   16-byte load, and writes each dimension's 32 keys to 32 banks.
// - S = Q·Kᵀ: wgmma m64n32k8, Q_hi·K_lo, Q_lo·K_hi, then Q_hi·K_hi for each
//   box of 32 dimensions, both operands K-major in shared memory.
// - Online softmax in registers, as in the bfloat16 kernel: exp2 with the
//   scale folded into one explicit fmaf (the build uses --fmad=false).
// - O += P·V: wgmma m64nDk8 with P from registers and Vᵀ from shared
//   memory.  The S accumulator gives a thread keys 2t and 2t + 1 of each
//   8-key group; a TF32 A fragment wants keys t and t + 4.  So the split
//   pass stores the keys of each 8-key group of Vᵀ in the order 0, 2, 4,
//   6, 1, 3, 5, 7, and the thread's p values go to wgmma as they lie, split
//   into hi and lo, with no shuffle and no trip through shared memory.
// - Pipelining.  Tile j − 1's P·V and tile j's S are on the tensor cores
//   together while the CUDA cores split tile j + 1; then tile j's softmax.
//   Two named barriers of the warpgroup per tile: one before tile j + 1's
//   V is split (every warp's P·V of tile j − 1, which read that Vᵀ buffer,
//   is done), and one after the wait for tile j's products (every warp is
//   done with tile j's slot and K lo buffer, and tile j + 1's split,
//   fenced to the async proxy, is visible to the wgmma that reads it).
// - Tile skipping.  A block walks only the KV tiles that its rows can see
//   through the causal and chunk masks; masks are applied element by
//   element only on the tiles that straddle an edge.
// - Epilogue: divide by max(l, 1e-30).
#include "flash_sm90.cuh"

namespace grafs {
namespace tf32 {

using sm90::fence_regs;
using sm90::key_range;
using sm90::LOG2E;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::NEG;
using sm90::Rows;
using sm90::smem_desc;
using sm90::smem_u32;
using sm90::tma_load;
using sm90::WG_THREADS;
using sm90::wg_commit;
using sm90::wg_fence;
using sm90::wg_wait;

constexpr int BQ = 64;                        // query rows per block
constexpr int BK = 32;                        // keys per KV tile
constexpr int STAGES = 2;                     // K/V slots in the ring
constexpr int THREADS = WG_THREADS + 32;      // + the producer warp

// The shared-memory geometry at head dim D, in bytes from a 1024-aligned
// base: Q hi | Q lo | K lo buffers 0 and 1 | Vᵀ buffers 0 and 1 (hi, lo) |
// the ring's slots (K, then V); 230,400 bytes at D = 128.  Every box
// starts on a 1024-byte boundary, a multiple of each swizzle pattern's
// period.
template <int D>
struct Geo {
  static constexpr int COLS = D < 32 ? D : 32;      // floats of one box row
  static constexpr int NBOX = D / COLS;             // boxes per row
  static constexpr int ROW_B = COLS * 4;            // box row bytes = swizzle
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static constexpr uint64_t LAYOUT = ROW_B == 128 ? 1 : 2;
  static constexpr int SBO = 8 * ROW_B;             // 8-row group stride
  static constexpr int KSTEPS_BOX = COLS / 8;       // k8 steps per box
  static constexpr int Q_BOX = BQ * ROW_B;
  static constexpr int KV_BOX = BK * ROW_B;
  static constexpr int Q_BYTES = NBOX * Q_BOX;
  static constexpr int KV_BYTES = NBOX * KV_BOX;    // K or V of one tile
  static constexpr int VT_BYTES = D * BK * 4;       // hi or lo of one Vᵀ
  static constexpr int Q_LO = Q_BYTES;
  static constexpr int K_LO = 2 * Q_BYTES;          // two buffers
  static constexpr int VT = K_LO + 2 * KV_BYTES;
  static constexpr int RING = VT + 4 * VT_BYTES;
  static constexpr int SMEM = RING + STAGES * 2 * KV_BYTES + 1024;
};

// A byte offset from a 1024-aligned base, swizzled as TMA writes a box of
// ROW_B-byte rows: the 16-byte chunk index XOR the row's bits above it.
template <int ROW_B>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & (ROW_B / 16 - 1)) << 4);
}

// x rounded to TF32 (to nearest, ties away from zero: cvt.rna.tf32.f32),
// as a float; two integer operations, cheaper than the conversion.
__device__ __forceinline__ float round_tf32(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - hi);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG_THREADS) : "memory");
}

// Makes this thread's shared-memory writes visible to wgmma and TMA.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D(64×N, float32) (+)= A(64×8, shared memory, K-major) · B(8×N, shared
// memory, K-major); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D(64×N, float32) (+)= A(64×8, TF32 in registers) · B(8×N, shared memory,
// K-major); scale_d = 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Splits ``BYTES`` bytes of float32 at ``x`` into their TF32 hi, in place,
// and lo, at the same offsets from ``lo`` (the layout does not matter: the
// split is elementwise).
template <int BYTES>
__device__ __forceinline__ void split_rows(uint8_t* x, uint8_t* lo, int tid) {
  static_assert(BYTES % (16 * WG_THREADS) == 0, "whole float4 rounds");
#pragma unroll
  for (int u = 0; u < BYTES / (16 * WG_THREADS); ++u) {
    const int off = 16 * (tid + WG_THREADS * u);
    float4 v = *reinterpret_cast<const float4*>(x + off), l;
    split(v.x, v.x, l.x);
    split(v.y, v.y, l.y);
    split(v.z, v.z, l.z);
    split(v.w, v.w, l.w);
    *reinterpret_cast<float4*>(x + off) = v;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// The V tile at ``v`` (BK rows of D floats, as TMA wrote it) split into
// Vᵀ's hi at ``vh`` and lo at ``vl``: row n holds dimension n's BK keys,
// 128 bytes swizzled, the keys of each 8-key group in the order 0, 2, 4,
// 6, 1, 3, 5, 7 (the order of the p values in the A fragments).  Lane i
// takes the key at position i, warp w the dimensions 4c .. 4c + 3 for c
// ≡ w (mod 4).
template <int D>
__device__ __forceinline__ void split_v(const uint8_t* v, uint8_t* vh,
                                        uint8_t* vl, int warp, int lane) {
  using G = Geo<D>;
  const int p = lane & 7;
  const int key = (lane & 24) | (p < 4 ? 2 * p : 2 * p - 7);
#pragma unroll
  for (int u = 0; u < D / 16; ++u) {
    const int col = 4 * (warp + 4 * u);
    const float4 x = *reinterpret_cast<const float4*>(
        v + (col / G::COLS) * G::KV_BOX +
        swz<G::ROW_B>(key * G::ROW_B + (col % G::COLS) * 4));
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t off = swz<128>((col + e) * 128 + lane * 4);
      float hi, lo;
      split(xs[e], hi, lo);
      *reinterpret_cast<float*>(vh + off) = hi;
      *reinterpret_cast<float*>(vl + off) = lo;
    }
  }
}

// S(64×BK) = Q(64×D)·K_tileᵀ in 3xTF32, issued as one wgmma group: each
// box of 32 dimensions into an accumulator of its own (small products
// first), the accumulators summed on the CUDA cores by sum_scores once the
// group is done.  The tensor cores round a float32 sum toward zero; shorter
// sums of smaller magnitude keep that error well below one float32 step
// of S.
template <int D>
__device__ __forceinline__ void issue_scores(
    float (&acc)[Geo<D>::NBOX][BK / 2], uint32_t qh, uint32_t ql,
    uint32_t kh, uint32_t kl) {
  using G = Geo<D>;
  // a descriptor's address field is its low bits in 16-byte units: an
  // offset is added to the descriptor of the operand's base
  const uint64_t dq[2] = {smem_desc(qh, 16, G::SBO, G::LAYOUT),
                          smem_desc(ql, 16, G::SBO, G::LAYOUT)};
  const uint64_t dk[2] = {smem_desc(kh, 16, G::SBO, G::LAYOUT),
                          smem_desc(kl, 16, G::SBO, G::LAYOUT)};
  wg_fence();
#pragma unroll
  for (int box = 0; box < G::NBOX; ++box) {
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int k = 0; k < G::KSTEPS_BOX; ++k)
        wgmma_ss<BK>(acc[box],
                     dq[pass == 1] + (box * G::Q_BOX + 32 * k) / 16,
                     dk[pass == 0] + (box * G::KV_BOX + 32 * k) / 16,
                     pass > 0 || k > 0);
    }
  }
  wg_commit();
}

// The boxes' scores summed pairwise into acc[0].
template <int D>
__device__ __forceinline__ void sum_scores(
    float (&acc)[Geo<D>::NBOX][BK / 2]) {
#pragma unroll
  for (int step = 1; step < Geo<D>::NBOX; step *= 2) {
#pragma unroll
    for (int c = 0; c + step < Geo<D>::NBOX; c += 2 * step) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) acc[c][i] += acc[c + step][i];
    }
  }
}

// PV(64×D) = P(64×BK)·V_tile in 3xTF32 into a fresh accumulator, issued as
// one wgmma group: P_hi·V_lo and P_lo·V_hi, then P_hi·V_hi.
template <int D>
__device__ __forceinline__ void issue_pv(float (&pv)[D / 2],
                                         const uint32_t (&ph)[BK / 8][4],
                                         const uint32_t (&pl)[BK / 8][4],
                                         uint32_t vh, uint32_t vl) {
  const uint64_t dh = smem_desc(vh, 16, 1024, 1);
  const uint64_t dl = smem_desc(vl, 16, 1024, 1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_rs<D>(pv, ph[kk], dl + 2 * kk, kk > 0);
    wgmma_rs<D>(pv, pl[kk], dh + 2 * kk, 1);
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) wgmma_rs<D>(pv, ph[kk], dh + 2 * kk, 1);
  wg_commit();
}

// p as TF32 A fragments, hi and lo: k8 step kk is the 8-key group kk, whose
// A columns t and t + 4 are the thread's keys 2t and 2t + 1 (slots 4kk,
// 4kk + 1 of row r0; 4kk + 2, 4kk + 3 of row r0 + 8).
__device__ __forceinline__ void to_fragments(const float (&p)[BK / 2],
                                             uint32_t (&ph)[BK / 8][4],
                                             uint32_t (&pl)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {            // slots 0, 2, 1, 3
      float hi, lo;
      split(p[4 * kk + 2 * (r & 1) + (r >> 1)], hi, lo);
      ph[kk][r] = __float_as_uint(hi);
      pl[kk][r] = __float_as_uint(lo);
    }
  }
}

// acc ← acc·α + pv, row by row.
template <int D>
__device__ __forceinline__ void fold(float (&o)[D / 2],
                                     const float (&pv)[D / 2], float a0,
                                     float a1) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] = fmaf(o[4 * j], a0, pv[4 * j]);
    o[4 * j + 1] = fmaf(o[4 * j + 1], a0, pv[4 * j + 1]);
    o[4 * j + 2] = fmaf(o[4 * j + 2], a1, pv[4 * j + 2]);
    o[4 * j + 3] = fmaf(o[4 * j + 3], a1, pv[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_3xtf32_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    float* __restrict__ out, int BH, int H, int Hkv, int S,
                    int T_, int causal, int chunk, float scale_log2,
                    int n_qt) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t full = smem_u32(bars);          // + 8·s
  const uint32_t empty = full + 8 * STAGES;      // + 8·s
  const uint32_t q_bar = full + 16 * STAGES;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = qt * BQ;
  const int q1 = min(q0 + BQ, S) - 1;
  int k_lo, k_hi;
  key_range(q0, q1, T_, causal, chunk, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int n_tiles = k_hi > k_lo ? (k_hi + BK - 1) / BK - t_lo : 0;
  auto slot = [&](int it) {                      // V follows at + KV_BYTES
    return G::RING + (it % STAGES) * 2 * G::KV_BYTES;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_THREADS);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {
    // The producer: one thread issues Q, then K and V tile by tile.
    if (threadIdx.x != WG_THREADS) return;
    mbar_expect_tx(q_bar, G::Q_BYTES);
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c)
      tma_load(base + c * G::Q_BOX, &qmap, q_bar, c * G::COLS, q0, bh);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(empty + 8 * s, ((it / STAGES) - 1) & 1);
      mbar_expect_tx(full + 8 * s, 2 * G::KV_BYTES);
      const int k0 = (t_lo + it) * BK;
      const uint32_t ks = base + slot(it);
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

  // The consumer warpgroup: rows q0 .. q0 + 63; this thread holds rows r0
  // and r0 + 8, and of each n8 block j of an accumulator the columns
  // 8j + 2·(lane % 4) and the one after (slots 4j, 4j+1 for r0; 4j+2, 4j+3
  // for r0 + 8).
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  Rows w;
  w.wq0 = q0;
  w.wq1 = q1;
  w.r0 = q0 + 16 * warp + lane / 4;
  w.c_lane = 2 * (lane % 4);
  w.T_ = T_;
  w.causal = causal;
  w.chunk = chunk;
  w.scale_log2 = scale_log2;
  float o[D / 2], pv[D / 2], sc[G::NBOX][BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = pv[i] = 0.f;
#pragma unroll
  for (int c = 0; c < G::NBOX; ++c) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[c][i] = 0.f;
  }
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, a0 = 1.f, a1 = 1.f;
  auto klo_buf = [&](int it) { return G::K_LO + (it & 1) * G::KV_BYTES; };
  auto vt_buf = [&](int it) {                       // Vᵀ hi, then lo
    return G::VT + (it & 1) * 2 * G::VT_BYTES;
  };
  auto split_k = [&](int it) {
    mbar_wait(full + 8 * (it % STAGES), (it / STAGES) & 1);
    split_rows<G::KV_BYTES>(sm + slot(it), sm + klo_buf(it), tid);
  };
  auto split_vt = [&](int it) {
    split_v<D>(sm + slot(it) + G::KV_BYTES, sm + vt_buf(it),
               sm + vt_buf(it) + G::VT_BYTES, warp, lane);
    fence_async();
  };
  mbar_wait(q_bar, 0);
  if (n_tiles > 0) {
    split_rows<G::Q_BYTES>(sm, sm + G::Q_LO, tid);
    split_k(0);
    split_vt(0);
    consumers_sync();
    issue_scores<D>(sc, base, base + G::Q_LO, base + slot(0),
                    base + klo_buf(0));
  }
  // Tile it's scores and tile it − 1's P·V are on the tensor cores while
  // the CUDA cores split tile it + 1; then tile it's softmax, and tile it's
  // P·V and tile it + 1's scores go to the tensor cores together.
  for (int it = 0; it < n_tiles; ++it) {
    const bool next = it + 1 < n_tiles;
    if (next) {
      split_k(it + 1);               // K lo buffer last read by S of it − 1
      wg_wait<1>();                  // P·V of it − 1 done: its Vᵀ is free
      consumers_sync();
      split_vt(it + 1);
    }
    wg_wait<0>();
#pragma unroll
    for (int c = 0; c < G::NBOX; ++c) fence_regs(sc[c]);
    fence_regs(pv);
    // every warp's products of tile it are done and tile it + 1's split is
    // written: the slot goes back to the producer
    consumers_sync();
    mbar_arrive(empty + 8 * (it % STAGES));
    fold<D>(o, pv, a0, a1);
    sum_scores<D>(sc);
    sm90::softmax_tile<BK>(sc[0], (t_lo + it) * BK, w, m0, m1, l0, l1, a0,
                           a1);
    to_fragments(sc[0], ph, pl);
    issue_pv<D>(pv, ph, pl, base + vt_buf(it),
                base + vt_buf(it) + G::VT_BYTES);
    if (next)
      issue_scores<D>(sc, base, base + G::Q_LO, base + slot(it + 1),
                      base + klo_buf(it + 1));
  }
  if (n_tiles > 0) {
    wg_wait<0>();
    fence_regs(pv);
    fold<D>(o, pv, a0, a1);
  }

  // epilogue: the quad's partial sums, then the division
  float d0, d1;
  sm90::row_divisors(l0, l1, d0, d1);
  const long long row0 = static_cast<long long>(bh) * S;
  const int r1 = w.r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + w.c_lane;
    if (w.r0 < S)
      *reinterpret_cast<float2*>(out + (row0 + w.r0) * D + col) =
          make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
    if (r1 < S)
      *reinterpret_cast<float2*>(out + (row0 + r1) * D + col) =
          make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
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
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const long long planes = static_cast<long long>(B) * Hkv;
  if (!sm90::encode(&qm, F32, 4, q, D, S, bh, G::COLS, BQ, G::SWIZZLE) ||
      !sm90::encode(&km, F32, 4, k, D, t_rows, planes, G::COLS, BK,
                    G::SWIZZLE) ||
      !sm90::encode(&vm, F32, 4, v, D, t_rows, planes, G::COLS, BK,
                    G::SWIZZLE))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_3xtf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_3xtf32_kernel<D><<<static_cast<unsigned>(blocks), THREADS, G::SMEM,
                           st>>>(
      qm, km, vm, static_cast<float*>(out), static_cast<int>(bh), H, Hkv, S,
      T_, causal, chunk, scale * LOG2E, n_qt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32
}  // namespace grafs

// q/out [B, H, S, D], k/v [B, Hkv, T, D], all float32, 16-byte aligned and
// contiguous; D in {16, 32, 64, 128}; chunk <= 0 means no chunk mask.
// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int grafs_flash_3xtf32(const void* q, const void* k,
                                  const void* v, void* out, int B, int H,
                                  int Hkv, int S, int T_, int D, int causal,
                                  int chunk, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define GRAFS_3XTF32_LAUNCH(d)                                              \
    case d:                                                                 \
      return grafs::tf32::launch<d>(q, k, v, out, B, H, Hkv, S, T_, causal, \
                                    chunk, scale, st);
    GRAFS_3XTF32_LAUNCH(16)
    GRAFS_3XTF32_LAUNCH(32)
    GRAFS_3XTF32_LAUNCH(64)
    GRAFS_3XTF32_LAUNCH(128)
#undef GRAFS_3XTF32_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The compiled kernel's registers per thread, local (spill) bytes per
// thread, static and dynamic shared-memory bytes per block, into attrs[4].
extern "C" int grafs_flash_3xtf32_attributes(int D, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t err;
  int smem = 0;
  switch (D) {
#define GRAFS_3XTF32_ATTR(d)                                                \
    case d:                                                                 \
      err = cudaFuncGetAttributes(&fa, grafs::tf32::flash_3xtf32_kernel<d>); \
      smem = grafs::tf32::Geo<d>::SMEM;                                     \
      break;
    GRAFS_3XTF32_ATTR(16)
    GRAFS_3XTF32_ATTR(32)
    GRAFS_3XTF32_ATTR(64)
    GRAFS_3XTF32_ATTR(128)
#undef GRAFS_3XTF32_ATTR
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  attrs[0] = fa.numRegs;
  attrs[1] = static_cast<int>(fa.localSizeBytes);
  attrs[2] = static_cast<int>(fa.sharedSizeBytes);
  attrs[3] = smem;
  return 0;
}
