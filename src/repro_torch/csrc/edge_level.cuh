// One lexicographic level of the blocked-ELL edge reduction, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_reduce.py
// _level_kernel (launched by ell_level_reduce): the per-level reference
// sweep that reduces ONE lex level per launch into a [n_pad] vector,
// re-deriving the tie mask of every earlier level from its already reduced
// best values.
//
// A generated translation unit (repro_torch.core.synthesis.emit_cuda_level)
// defines `struct Level` — the number of levels NC, the reduced level's
// monoid OP, the mode (NONBOT: reduce "source state is not ⊥" as int32 max
// instead of the P values), the output's type and identity, which per-edge
// inputs the P functions read (READS_*), per-level float/int flag and
// identity, and one P per level printed from its expression — and expands
// GRAFS_DEFINE_LEVEL_ENTRY(Level) behind a plain C entry point.
//
// Geometry: one 256-thread block per row tile of 8 rows, the row tile
// flattened onto blockIdx.x (the uniform graphs have 262,144 of them).  Warp
// r owns row r; inside the block a loop over the row's 128-slot tiles takes
// the place of the Pallas grid's sequential slot axis.  Per slot tile, lane
// l owns the four contiguous slots 4l..4l+3 (16-byte loads), folds them in
// order, and the warp's halving tree (edge_sweep.cuh warp_reduce) gives the
// tile's partial, which is combined into the row's running value starting
// from the identity: acc = combine(acc, partial), slot tiles in order.  The
// plain version (kernels/edge_reduce.py _level_plain) repeats that order, so
// with --fmad=false the two agree bitwise on the card, float sums included.
//
// Empty tiles are skipped.  The layout's tile_nnz counts the real slots of
// each (block_v × block_e) layout tile, a multiple of (8 × 128); the 32
// lanes of a warp read the counts of 32 slot tiles at once and a ballot
// hands the warp the non-empty ones in order.  An empty tile's partial is
// the identity, and combining the identity into acc leaves acc's bits as
// they are: min and max keep acc on its side of the identity it started
// from, and a float sum that starts at +0.0 never reaches -0.0, so adding
// +0.0 is exact (adding -0.0 always is).  Where a sum's or product's ⊥ is
// not the monoid's identity, the kernel visits every tile (SKIPS_EMPTY).
//
// What bounds it on an H100: bytes.  The tile counts, then of each
// non-empty tile every slot's mask byte and source index, plus the weight
// and capacity where P reads them, then the gathered state words of every
// level; a handful of operations per slot.
#pragma once

#include "edge_sweep.cuh"

namespace grafs {

// Whether skipping an empty tile (partial = OUT_IDENT) is exact: always for
// min and max; for sum and product only when OUT_IDENT is the monoid's
// identity (0 or ±0.0, 1 or 1.0f).
template <class L>
__host__ __device__ constexpr bool skips_empty() {
  if (L::OP == OP_MIN || L::OP == OP_MAX) return true;
  if (L::OP == OP_SUM)
    return L::OUT_IDENT == 0u || (L::OUT_FLOAT && L::OUT_IDENT == 0x80000000u);
  return L::OUT_IDENT == (L::OUT_FLOAT ? 0x3f800000u : 1u);
}

template <class L>
__global__ void __launch_bounds__(THREADS)
level_kernel(const int* __restrict__ tile_nnz, const int* __restrict__ srcs,
             const float* __restrict__ weight,
             const float* __restrict__ capacity,
             const unsigned char* __restrict__ mask,
             const int* __restrict__ active,
             const float* __restrict__ outdeg,
             const float* __restrict__ wdeg, Ptrs states, Ptrs bests,
             uint32_t* __restrict__ out, int width, int tile_rows,
             int tile_slots, float nv) {
  constexpr int LAST = L::NC - 1;
  constexpr bool SKIPS_EMPTY = skips_empty<L>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * BLOCK_V + warp;
  const int n_j = width / BLOCK_E;
  // this row's layout tile counts: slot tile j lies in layout tile j / per
  const int per = tile_slots / BLOCK_E;
  const int* nnz = tile_nnz + (row / tile_rows) * (width / tile_slots);
  uint32_t best[L::NC > 1 ? L::NC - 1 : 1];
#pragma unroll
  for (int l = 0; l < LAST; ++l)
    best[l] = static_cast<const uint32_t*>(bests.p[l])[row];
  uint32_t acc = L::OUT_IDENT;
  for (int j0 = 0; j0 < n_j; j0 += 32) {
    const int jl = j0 + lane;
    const bool busy = jl < n_j && (!SKIPS_EMPTY || nnz[jl / per] != 0);
    for (uint32_t todo = __ballot_sync(0xffffffffu, busy); todo;
         todo &= todo - 1) {
      const int j = j0 + __ffs(todo) - 1;
      const long long base =
          row * width + (long long)j * BLOCK_E + lane * SLOTS;
      int sv[SLOTS];
      float wv[SLOTS] = {}, cv[SLOTS] = {};
      bool live[SLOTS];
      load4<int4>(srcs + base, sv);
      if constexpr (L::READS_W) load4<float4>(weight + base, wv);
      if constexpr (L::READS_C) load4<float4>(capacity + base, cv);
      load_mask4(mask + base, live);
      uint32_t vals[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        bool tie = live[s] && active[sv[s]] != 0;
        float od = 0.f, wd = 0.f;
        if constexpr (L::READS_OUTDEG) od = outdeg[sv[s]];
        if constexpr (L::READS_WDEG) wd = wdeg[sv[s]];
        const Env e{wv[s], cv[s], sv[s], (int)row, od, wd, nv};
#pragma unroll
        for (int l = 0; l < LAST; ++l) {        // tie masks of prior levels
          const uint32_t id = L::ident(l);
          const bool f = L::comp_float(l);
          const uint32_t nw =
              static_cast<const uint32_t*>(states.p[l])[sv[s]];
          const uint32_t pv = weq(nw, id, f) ? id : L::P(l, e, nw);  // C3
          tie = tie && weq(pv, best[l], f);
        }
        const uint32_t id = L::ident(LAST);
        const bool f = L::comp_float(LAST);
        const uint32_t nw =
            static_cast<const uint32_t*>(states.p[LAST])[sv[s]];
        uint32_t v;
        if constexpr (L::NONBOT)
          v = weq(nw, id, f) ? 0u : 1u;
        else
          v = weq(nw, id, f) ? id : L::P(LAST, e, nw);             // C3
        vals[s] = tie ? v : L::OUT_IDENT;
      }
      acc = combine<L::OP, L::OUT_FLOAT>(
          acc, warp_reduce<L::OP, L::OUT_FLOAT>(vals));
    }
  }
  if (lane == 0) out[row] = acc;
}

}  // namespace grafs

// Plain C entry point of one level's library; returns the cudaGetLastError()
// of its launch (0 = launched).
#define GRAFS_DEFINE_LEVEL_ENTRY(L)                                           \
  extern "C" int grafs_level(const void* tile_nnz, const void* srcs,         \
                             const void* weight, const void* capacity,       \
                             const void* mask, const void* active,           \
                             const void* outdeg, const void* wdeg,           \
                             void* const* states, void* const* bests,        \
                             void* out, int n_row_tiles, int width,          \
                             int tile_rows, int tile_slots, float nv,        \
                             void* stream) {                                 \
    grafs::level_kernel<L><<<n_row_tiles, grafs::THREADS, 0,                 \
                             (cudaStream_t)stream>>>(                        \
        (const int*)tile_nnz, (const int*)srcs, (const float*)weight,        \
        (const float*)capacity, (const unsigned char*)mask,                  \
        (const int*)active, (const float*)outdeg, (const float*)wdeg,        \
        grafs::pack(states, L::NC), grafs::pack(bests, L::NC - 1),           \
        (uint32_t*)out, width, tile_rows, tile_slots, nv);                   \
    return (int)cudaGetLastError();                                          \
  }
