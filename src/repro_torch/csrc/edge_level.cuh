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
// Geometry: the walk of the sweep kernels (edge_sweep.cuh walk_tiles_if).
// The [n_pad, width] rectangle is cut into (8 × 128) tiles, flattened row
// tile by row tile, and a grid of as many blocks as the card holds at once
// deals them out to its blocks in turn, tile t to block t mod gridDim.x,
// so that the hub row tiles of a skewed graph (one rmat16 row tile holds 49
// non-empty tiles, the median one) spread over the card instead of
// queueing on one block.  In a visited tile warp r owns row r and lane l
// the four contiguous slots 4l..4l+3 (16-byte loads); the lane folds them
// in order and the warp's halving tree (edge_sweep.cuh warp_reduce) gives
// the row's partial of that slot tile.  Where the row tile holds no other
// walked tile, combine(identity, partial) is the row's result and lane 0
// writes it to out.  Else it writes the partial into cell [row, j] of a
// per-call [n_pad, n_j] buffer, and a second kernel (level_combine_kernel,
// one block per such row tile, one warp per row) folds each row's cells in
// slot-tile order, acc = combine(acc, cell[row, j]), starting from the
// identity and reading only the cells of the tiles the walk visited.  The
// walk's plan (which tiles, how many per row tile, which row tiles to
// combine) is built once per layout (BlockedELL.row_tile_walk).  The plain
// version (kernels/edge_reduce.py _level_plain) combines every slot tile's
// partial in that order, so with --fmad=false the two agree bitwise on the
// card, float sums included; no value is ever added atomically.
//
// Empty tiles are skipped.  The layout's tile_nnz counts the real slots of
// each (block_v × block_e) layout tile, a multiple of (8 × 128); the plan
// marks each (8 × 128) tile of a non-empty layout tile, and the walk visits
// those.  An empty tile's partial is the identity, and combining the
// identity into acc leaves acc's bits as they are: min and max keep acc on
// its side of the identity it started from, and a float sum that starts at
// +0.0 never reaches -0.0, so adding +0.0 is exact (adding -0.0 always
// is).  Where a sum's or product's ⊥ is not the monoid's identity, the
// walk visits every tile and the combine reads every cell (skips_empty).
// The same holds inside a visited tile: a lane whose four slots are all
// padding loads only their mask bytes.
//
// What bounds it on an H100: bytes.  The plan's words, then of each
// non-empty tile every slot's mask byte, and of its real slots the source
// index, plus the weight and capacity where P reads them (read in 16-byte
// groups of four slots), then the gathered state words of every level; a
// handful of operations per slot.  The cells (4 bytes per row and visited
// tile of the row tiles to combine, written once and read once) add a few
// percent.
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

// The walk's plan, built once per layout (BlockedELL.row_tile_walk) at
// (8 × 128) tiles: which tiles are walked, how many in each 8-row tile, and
// the 8-row tiles with two or more, whose rows need the combine.  Where ⊥
// is not the monoid's identity every tile is walked and the entry point
// passes null pointers: n_j tiles in every row tile, every row tile
// combined (when n_j > 1).
struct LevelWalk {
  const int* __restrict__ tiles;    // [n_i, n_j], or null: every tile
  const int* __restrict__ counts;   // [n_i], or null: n_j each
  const int* __restrict__ multi;    // row tiles to combine, or null: all
  int n_j;

  __device__ __forceinline__ bool busy(int t) const {
    return tiles == nullptr || tiles[t] != 0;
  }
  __device__ __forceinline__ int count(int i) const {
    return counts == nullptr ? n_j : counts[i];
  }
};

// The walk.  A visit computes each of its 8 rows' partial of one slot
// tile; where the row tile holds no other walked tile that partial
// combined into the identity is the row's result and goes straight to out,
// else it goes to cells[row, j] for the combine.  Rows of row tiles with no
// walked tile get the identity first, in a grid-stride pass.
template <class L>
__global__ void __launch_bounds__(THREADS)
level_kernel(LevelWalk walk, int n_i, const int* __restrict__ srcs,
             const float* __restrict__ weight,
             const float* __restrict__ capacity,
             const unsigned char* __restrict__ mask,
             const int* __restrict__ active,
             const float* __restrict__ outdeg,
             const float* __restrict__ wdeg, Ptrs states, Ptrs bests,
             uint32_t* __restrict__ cells, uint32_t* __restrict__ out,
             int width, float nv) {
  constexpr int LAST = L::NC - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_j = walk.n_j;
  if (walk.counts != nullptr)
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < n_i;
         i += gridDim.x * THREADS)
      if (walk.counts[i] == 0)
#pragma unroll
        for (int r = 0; r < BLOCK_V; ++r)
          out[(long long)i * BLOCK_V + r] = L::OUT_IDENT;
  auto visit = [&](long long tile) {
    const int i = (int)tile / n_j, j = (int)tile - i * n_j;  // < 2^31 tiles
    const long long row = (long long)i * BLOCK_V + warp;
    const long long base = row * width + (long long)j * BLOCK_E + lane * SLOTS;
    const int alone = walk.count(i) == 1;
    uint32_t best[L::NC > 1 ? L::NC - 1 : 1];
#pragma unroll
    for (int l = 0; l < LAST; ++l)
      best[l] = static_cast<const uint32_t*>(bests.p[l])[row];
    // The mask first: a lane whose four slots are all padding reads no
    // source, weight or capacity (its slots give the identity whatever
    // they hold), so a padded tile costs its mask and its real slots.
    bool live[SLOTS];
    load_mask4(mask + base, live);
    int sv[SLOTS] = {};
    float wv[SLOTS] = {}, cv[SLOTS] = {};
    if (live[0] || live[1] || live[2] || live[3]) {
      load4<int4>(srcs + base, sv);
      if constexpr (L::READS_W) load4<float4>(weight + base, wv);
      if constexpr (L::READS_C) load4<float4>(capacity + base, cv);
    }
    uint32_t vals[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      bool tie = live[s] && active[sv[s]] != 0;
      float od = 0.f, wd = 0.f;
      if constexpr (L::READS_OUTDEG) od = outdeg[sv[s]];
      if constexpr (L::READS_WDEG) wd = wdeg[sv[s]];
      const Env e{wv[s], cv[s], sv[s], (int)row, od, wd, nv};
#pragma unroll
      for (int l = 0; l < LAST; ++l) {          // tie masks of prior levels
        const uint32_t id = L::ident(l);
        const bool f = L::comp_float(l);
        const uint32_t nw = static_cast<const uint32_t*>(states.p[l])[sv[s]];
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
        v = weq(nw, id, f) ? id : L::P(LAST, e, nw);               // C3
      vals[s] = tie ? v : L::OUT_IDENT;
    }
    const uint32_t part = warp_reduce<L::OP, L::OUT_FLOAT>(vals);
    if (lane == 0) {
      if (alone)
        out[row] = combine<L::OP, L::OUT_FLOAT>(L::OUT_IDENT, part);
      else
        cells[row * n_j + j] = part;
    }
  };
  walk_tiles_if((long long)n_i * n_j,
                [&](long long t) { return walk.busy((int)t); }, visit);
}

// The combine: block b takes row tile multi[b] (b without the list), warp
// r its row r.  The lanes load the flags and cells of 32 slot tiles at
// once, and the warp folds the walked ones in slot-tile order from the
// identity, acc = combine(acc, cell), every lane alike; lane 0 writes.
template <class L>
__global__ void __launch_bounds__(THREADS)
level_combine_kernel(LevelWalk walk, const uint32_t* __restrict__ cells,
                     uint32_t* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_j = walk.n_j;
  const int i = walk.multi == nullptr ? (int)blockIdx.x : walk.multi[blockIdx.x];
  const long long row = (long long)i * BLOCK_V + warp;
  uint32_t acc = L::OUT_IDENT;
  for (int j0 = 0; j0 < n_j; j0 += 32) {
    const int j = j0 + lane;
    const bool walked = j < n_j && walk.busy(i * n_j + j);
    // read beside the flag, not behind it: an unwalked cell is read and
    // never used
    const uint32_t v = j < n_j ? cells[row * n_j + j] : 0u;
    for (uint32_t m = __ballot_sync(0xffffffffu, walked); m; m &= m - 1)
      acc = combine<L::OP, L::OUT_FLOAT>(
          acc, __shfl_sync(0xffffffffu, v, __ffs(m) - 1));
  }
  if (lane == 0) out[row] = acc;
}

// One call: the walk on the resident grid (asked once and cached), then,
// where a row tile holds two or more walked tiles, the combine.  Returns
// the cudaGetLastError() of the launches.
template <class L>
inline int launch_level(const void* tiles, const void* counts,
                        const void* multi, int n_multi, const void* srcs,
                        const void* weight, const void* capacity,
                        const void* mask, const void* active,
                        const void* outdeg, const void* wdeg,
                        void* const* states, void* const* bests, void* cells,
                        void* out, int n_i, int width, float nv,
                        cudaStream_t stream) {
  static int resident = 0;
  if (!resident) resident = resident_blocks(level_kernel<L>);
  const int n_j = width / BLOCK_E;
  LevelWalk walk{(const int*)tiles, (const int*)counts, (const int*)multi,
                 n_j};
  int n_comb = n_multi;
  if constexpr (!skips_empty<L>()) {
    walk = LevelWalk{nullptr, nullptr, nullptr, n_j};
    n_comb = n_j > 1 ? n_i : 0;
  }
  level_kernel<L><<<walk_grid(resident, (long long)n_i * n_j), THREADS, 0,
                    stream>>>(
      walk, n_i, (const int*)srcs, (const float*)weight,
      (const float*)capacity, (const unsigned char*)mask, (const int*)active,
      (const float*)outdeg, (const float*)wdeg, pack(states, L::NC),
      pack(bests, L::NC - 1), (uint32_t*)cells, (uint32_t*)out, width, nv);
  if (n_comb > 0)
    level_combine_kernel<L><<<n_comb, THREADS, 0, stream>>>(
        walk, (const uint32_t*)cells, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace grafs

// Plain C entry points of one level's library.  grafs_level runs one call
// over the layout's walk plan (tiles, counts, multi: BlockedELL.
// row_tile_walk; cells: uint32 [n_pad, width / 128], written only for the
// row tiles in multi) and returns the cudaGetLastError() of its launches
// (0 = launched); grafs_level_attributes writes the walk kernel's
// registers per thread and resident grid.
#define GRAFS_DEFINE_LEVEL_ENTRY(L)                                           \
  extern "C" int grafs_level(const void* tiles, const void* counts,          \
                             const void* multi, int n_multi,                 \
                             const void* srcs, const void* weight,           \
                             const void* capacity, const void* mask,         \
                             const void* active, const void* outdeg,         \
                             const void* wdeg, void* const* states,          \
                             void* const* bests, void* cells, void* out,     \
                             int n_i, int width, float nv, void* stream) {   \
    return grafs::launch_level<L>(                                           \
        tiles, counts, multi, n_multi, srcs, weight, capacity, mask, active, \
        outdeg, wdeg, states, bests, cells, out, n_i, width, nv,             \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int grafs_level_attributes(int* out) {                          \
    grafs::walk_attributes(grafs::level_kernel<L>, out);                     \
    return (int)cudaGetLastError();                                          \
  }
