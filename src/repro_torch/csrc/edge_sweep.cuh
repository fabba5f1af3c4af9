// Blocked-ELL edge sweeps of one fused GraFS round, for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of src/repro/kernels/edge_reduce.py
// on the main path:
//   pull_kernel    <- _fused_kernel   (the pull sweep, fused_ell_sweep)
//   push_kernel    <- _push_kernel    (the push sweep, fused_ell_push_sweep)
//   resolve_kernel <- _resolve_kernel (dst-sorted push resolution,
//                                      _resolve_push_sorted)
//
// A generated translation unit (repro_torch.core.synthesis.emit_cuda_round)
// defines `struct Round` — the round's component count, which per-edge
// inputs its P functions read (READS_W, READS_C, READS_EDST, READS_OUTDEG,
// READS_WDEG), per-component float/int flag and identity, the flattened lex
// levels of its plans, and one P per component printed from the synthesized
// expression — and expands
// GRAFS_DEFINE_ENTRY_POINTS(Round) to instantiate the kernels behind plain
// C entry points that ctypes loads (kernels/build.py).
//
// Geometry.  Inside a tile (8 rows × 128 slots) warp r owns row r and lane
// l owns the four contiguous slots 4l..4l+3, loaded as one 16-byte vector
// per array; addresses are computed in 64 bits.  All three kernels walk
// their tiles (walk_tiles): a grid of as many blocks as the card holds at
// once deals the flattened tiles out to its blocks in turn; each thread
// reads one word of the walked tile list, each warp ballots its 32, and
// the block then visits the tiles whose word is set, in order, with the
// tile geometry above.  No host read and no work list: a skipped tile
// costs one word.  The cells of the tiles the walk skips get the
// identities in one coalesced grid-stride pass (fill_skipped).
//
// The pull kernel has two modes.  Given activity walks the frontier's
// tile activity as the caller computed it.  Derived activity walks the
// layout's static non-empty tiles and decides each tile's activity itself:
// every warp tests its row's slots (mask && active[src]), the block votes
// (__syncthreads_or, one decision per tile, as the reference skips or runs
// whole tiles), the kernel writes the tile's activity word, and an
// inactive tile writes only its identity cells.  The frontier's tile
// activity then costs the source index and mask of the non-empty tiles'
// slots and the frontier words they name, not a gather over the whole
// rectangle; the other per-edge inputs are read only in the tiles that
// run.
//
// Batched queries.  Every kernel takes a slot axis (struct Slots): one
// launch sweeps B queries over the one shared layout, each slot with its
// own states, frontier, tile activity and outputs at a per-slot stride.
// The batched walk deals (tile, slot) items (walk_items_if): tile-major,
// so the B slots of a tile run in neighbouring blocks and its layout
// bytes come from device memory once and from L2 for the other slots, or
// slot-major where the slots' gathered words would not fit in L2 together
// (the caller picks).  Inside a visit nothing depends on the slot but the
// addresses: the same loads, the same lex chain, the same order, so each
// slot's outputs are the bits of its solo launch.  A one-slot launch runs
// the solo instantiation (BATCHED = false), the single-query code with no
// slot arithmetic.
//
// What bounds them on an H100: bytes.  Each processed slot reads its mask
// and (pull) its source index; of the weight, the capacity, (push) the
// destination index and the source's degrees it reads only what the
// round's P reads; then the gathered state words.  It does a handful of
// operations, far below the 295 operations per byte at which the card's
// arithmetic would become the limit.  The design keeps the reference's
// frontier-proportional tile skip and coalesced 16-byte loads, and keeps
// every step's bytes proportional to its live tiles: the push sweep
// writes candidates only into the tiles it runs (a skipped tile's
// candidates are left undefined), and the resolve kernel reads a
// candidate only where the push activity of the out-tile holding it says
// that tile ran (the identity elsewhere, which is what the reference's
// identity-filled skipped tile would have given it).  The pull and resolve
// kernels write identities into every skipped tile's cells (condition C6
// bit for bit).
//
// Reduction order (the plain versions in kernels/edge_reduce.py repeat it):
// each lane folds its four slots in order, ((v0 ∘ v1) ∘ v2) ∘ v3, then a
// __shfl_down_sync halving tree over offsets 16, 8, 4, 2, 1 combines
// lane i with lane i + offset (own value first), and lane 0's value is
// broadcast to the warp.  Built with --fmad=false, the kernels and the plain
// versions agree bitwise on the card, float sums included.  The pull and
// resolve kernels share one lex-chain routine, so push(sorted) ≡ pull
// bitwise.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace grafs {

constexpr int BLOCK_V = 8;
constexpr int BLOCK_E = 128;
constexpr int SLOTS = 4;                 // slots per lane
constexpr int THREADS = BLOCK_V * 32;
// Pointers in one Ptrs argument: 16 unless the round unit defines more
// before including this header (a round of more levels and components, such
// as the service's fused scalar rounds).
#ifndef GRAFS_MAX_PTRS
#define GRAFS_MAX_PTRS 16
#endif
constexpr int MAX_PTRS = GRAFS_MAX_PTRS;

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2, OP_PROD = 3 };

struct Ptrs {
  void* p[MAX_PTRS];
};

// The P environment of one edge (the reference kernels' env dict).
struct Env {
  float w, c;
  int esrc, edst;
  float outdeg, wdeg, nv;
};

// int32 arithmetic wraps, as XLA's does.
__device__ __forceinline__ int iadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int isub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int imul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
// NaN-propagating, like jnp.minimum / torch.minimum.
__device__ __forceinline__ float fmin_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float fmax_nan(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float as_f(uint32_t u) { return __uint_as_float(u); }
__device__ __forceinline__ int as_i(uint32_t u) { return (int)u; }
__device__ __forceinline__ uint32_t w_of(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t w_of(int x) { return (uint32_t)x; }

// One lane's four contiguous slots of a rectangle, as one 16-byte (values)
// or 4-byte (mask) load.
template <class V, class T>
__device__ __forceinline__ void load4(const T* p, T out[SLOTS]) {
  const V v = *reinterpret_cast<const V*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_mask4(const unsigned char* p,
                                           bool out[SLOTS]) {
  const uchar4 m = *reinterpret_cast<const uchar4*>(p);
  out[0] = m.x != 0; out[1] = m.y != 0; out[2] = m.z != 0; out[3] = m.w != 0;
}

// Typed equality of two 32-bit words (float: IEEE, so NaN != NaN).
__device__ __forceinline__ bool weq(uint32_t a, uint32_t b, bool is_float) {
  return is_float ? (as_f(a) == as_f(b)) : (a == b);
}

template <int OP, bool F>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  if (F) {
    const float x = as_f(a), y = as_f(b);
    if (OP == OP_MIN) return w_of(fmin_nan(x, y));
    if (OP == OP_MAX) return w_of(fmax_nan(x, y));
    if (OP == OP_SUM) return w_of(x + y);
    return w_of(x * y);
  } else {
    const int x = as_i(a), y = as_i(b);
    if (OP == OP_MIN) return w_of(imin(x, y));
    if (OP == OP_MAX) return w_of(imax(x, y));
    if (OP == OP_SUM) return w_of(iadd(x, y));
    return w_of(imul(x, y));
  }
}

// Row reduction of one warp's 128 slots in the fixed order described above;
// every lane returns lane 0's result.
template <int OP, bool F>
__device__ __forceinline__ uint32_t warp_reduce(const uint32_t v[SLOTS]) {
  uint32_t acc = v[0];
#pragma unroll
  for (int s = 1; s < SLOTS; ++s) acc = combine<OP, F>(acc, v[s]);
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const uint32_t o = __shfl_down_sync(0xffffffffu, acc, off);
    acc = combine<OP, F>(acc, o);
  }
  return __shfl_sync(0xffffffffu, acc, 0);
}

__device__ __forceinline__ uint32_t reduce_dispatch(int op, bool is_float,
                                                    const uint32_t v[SLOTS]) {
  if (is_float) {
    switch (op) {
      case OP_MIN: return warp_reduce<OP_MIN, true>(v);
      case OP_MAX: return warp_reduce<OP_MAX, true>(v);
      case OP_SUM: return warp_reduce<OP_SUM, true>(v);
      default: return warp_reduce<OP_PROD, true>(v);
    }
  }
  switch (op) {
    case OP_MIN: return warp_reduce<OP_MIN, false>(v);
    case OP_MAX: return warp_reduce<OP_MAX, false>(v);
    case OP_SUM: return warp_reduce<OP_SUM, false>(v);
    default: return warp_reduce<OP_PROD, false>(v);
  }
}

// THE lex chain, shared by the pull and resolve kernels: for every plan,
// tie starts at `mask`; each level reduces its component's values over the
// tied slots (identity elsewhere) and narrows tie to the slots equal to the
// level's best.  best[l] is valid in every lane.
template <class R>
__device__ __forceinline__ void lex_chain(const uint32_t vals[R::NC][SLOTS],
                                          const bool mask[SLOTS],
                                          uint32_t best[R::NLEV]) {
  bool tie[SLOTS];
#pragma unroll
  for (int l = 0; l < R::NLEV; ++l) {
    const int pos = R::lev_pos(l);
    const bool f = R::comp_float(pos);
    const uint32_t id = R::ident(pos);
    if (R::lev_first(l)) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) tie[s] = mask[s];
    }
    uint32_t v[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) v[s] = tie[s] ? vals[pos][s] : id;
    best[l] = reduce_dispatch(R::lev_op(l), f, v);
    if (!R::lev_last(l)) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        tie[s] = tie[s] && weq(vals[pos][s], best[l], f);
    }
  }
}

template <class R>
__device__ __forceinline__ void write_identities(Ptrs outs, long long cell) {
#pragma unroll
  for (int l = 0; l < R::NLEV; ++l)
    static_cast<uint32_t*>(outs.p[l])[cell] = R::ident(R::lev_pos(l));
}

// The slot axis of a batched launch: `n` queries over one shared layout.
// Each per-slot array holds slot s at s × its stride (in elements); a
// stride of 0 shares one array among the slots.  The layout arrays (srcs
// or dsts, weight, capacity, mask, in2out, valid) and the degree vectors
// are always shared.
struct Slots {
  int n;
  int slot_major;        // item order: 0 tile-major, 1 slot-major
  long long tiles;       // the walked tile activity (pull given, push, resolve)
  long long act_out;     // the pull kernel's derived activity
  long long active;      // the frontier
  long long state;       // each component's state
  long long out;         // each output array (pull/resolve cells, push cands)
  long long push_act;    // resolve: the push sweep's tile activity
  long long cand;        // resolve: each candidate array
};

// The walk over a tile list.  Tiles are dealt to blocks in turn, tile t
// to block t mod gridDim.x, so that a run of live tiles (rmat's hub rows
// fill whole row tiles) spreads over the grid instead of queueing on one
// block.  At each step thread k of block b asks busy() of tile
// (c + k)·gridDim.x + b, each warp's ballot goes to shared memory, and
// every warp then runs visit(tile) for each tile of the step that is busy,
// in order, so all 32 lanes of every warp, and all warps of the block, are
// in each visit (the row reductions shuffle over the whole warp; the pull
// kernel's derived activity votes over the whole block).
template <class Busy, class Visit>
__device__ __forceinline__ void walk_tiles_if(long long n_tiles, Busy busy,
                                              Visit visit) {
  constexpr int WARPS = THREADS / 32;
  __shared__ uint32_t busy_w[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long grid = gridDim.x, b = blockIdx.x;
  for (long long c = 0; c * grid + b < n_tiles; c += THREADS) {
    const long long t = (c + threadIdx.x) * grid + b;
    const bool act = t < n_tiles && busy(t);
    const uint32_t m = __ballot_sync(0xffffffffu, act);
    if (lane == 0) busy_w[warp] = m;
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < WARPS; ++w)
      for (uint32_t todo = busy_w[w]; todo; todo &= todo - 1)
        visit((c + w * 32 + (__ffs(todo) - 1)) * grid + b);
    __syncthreads();                      // busy_w[] is rewritten next step
  }
}

// The same walk over a batch's (tile, slot) items, dealt to the blocks as
// tiles are.  Tile-major items (the slots of one tile are neighbouring
// items, so they run in neighbouring blocks and the layout tile comes from
// device memory once and from L2 for the other slots) suit slots whose
// gathered words fit in L2 together; slot-major items (one slot's tiles
// after another's) keep one slot's gathered words in L2 at a time when
// they do not.  Each thread decodes its own item once (in 32 bits where
// the items allow: with the 64-bit division the weighted-PageRank round's
// derived pull took 1.3 to 1.4 times as long), and the visits read the
// decoded (tile, slot) from shared memory.
template <class Busy, class Visit>
__device__ __forceinline__ void walk_items_if(long long n_tiles,
                                              const Slots& sl, Busy busy,
                                              Visit visit) {
  constexpr int WARPS = THREADS / 32;
  __shared__ uint32_t busy_w[WARPS];
  __shared__ int tile_of[THREADS], slot_of[THREADS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long grid = gridDim.x, b = blockIdx.x;
  const long long n_items = n_tiles * sl.n;
  for (long long c = 0; c * grid + b < n_items; c += THREADS) {
    const long long item = (c + threadIdx.x) * grid + b;
    bool act = false;
    if (item < n_items) {
      long long tile;
      int s;
      if (n_items <= 0xffffffffll) {        // a 32-bit division
        const unsigned u = (unsigned)item;
        const unsigned r = sl.slot_major ? (unsigned)n_tiles
                                         : (unsigned)sl.n;
        const unsigned hi = u / r, lo = u - hi * r;
        tile = sl.slot_major ? lo : hi;
        s = (int)(sl.slot_major ? hi : lo);
      } else if (sl.slot_major) {
        s = (int)(item / n_tiles);
        tile = item - s * n_tiles;
      } else {
        tile = item / sl.n;
        s = (int)(item - tile * sl.n);
      }
      tile_of[threadIdx.x] = (int)tile;   // < 2^21 tiles
      slot_of[threadIdx.x] = s;
      act = busy(tile, s);
    }
    const uint32_t m = __ballot_sync(0xffffffffu, act);
    if (lane == 0) busy_w[warp] = m;
    __syncthreads();
#pragma unroll 1
    for (int w = 0; w < WARPS; ++w)
      for (uint32_t todo = busy_w[w]; todo; todo &= todo - 1) {
        const int k = w * 32 + (__ffs(todo) - 1);
        visit((long long)tile_of[k], slot_of[k]);
      }
    __syncthreads();            // busy_w[], tile_of[], slot_of[] are reused
  }
}

// The walk over the tiles (BATCHED: the (tile, slot) items) whose word in
// tile_act (slot s at s × sl.tiles) is set; visit(tile, slot).  The solo
// instantiation is the one-slot walk over tiles, with slot 0.
template <bool BATCHED, class Visit>
__device__ __forceinline__ void walk_tiles(const int* __restrict__ tile_act,
                                           long long n_tiles, const Slots& sl,
                                           Visit visit) {
  if constexpr (BATCHED)
    walk_items_if(
        n_tiles, sl,
        [&](long long tile, int s) {
          return tile_act[s * sl.tiles + tile] != 0;
        },
        visit);
  else
    walk_tiles_if(
        n_tiles, [&](long long t) { return tile_act[t] != 0; },
        [&](long long t) { visit(t, 0); });
}

// The cells of the tiles whose word in tile_act is 0 get the identities
// (has-pred 0) in one grid-stride pass per slot over its [n_pad, n_j]
// cells, coalesced; with act_out, such a tile's activity word is 0 too.
// The walk over tile_act writes every other cell, so the two write
// disjoint cells.
template <class R, bool BATCHED>
__device__ __forceinline__ void fill_skipped(const int* __restrict__ tile_act,
                                             long long n_tiles, int n_j,
                                             Ptrs outs, int need_hp,
                                             int* __restrict__ act_out,
                                             const Slots& sl) {
  const int n_cells = (int)n_tiles * BLOCK_V;             // < 2^24 cells
  const int n_slots = BATCHED ? sl.n : 1;
  for (int s = 0; s < n_slots; ++s) {
    const int* act = BATCHED ? tile_act + s * sl.tiles : tile_act;
    const long long o = BATCHED ? s * sl.out : 0;
    for (int q = blockIdx.x * THREADS + threadIdx.x; q < n_cells;
         q += gridDim.x * THREADS) {
      const int row = q / n_j, j = q - row * n_j;
      const int t = (row / BLOCK_V) * n_j + j;
      if (act[t] == 0) {
        write_identities<R>(outs, o + q);
        if (need_hp)
          for (int k = 0; k < R::NC; ++k)
            static_cast<int*>(outs.p[R::NLEV + k])[o + q] = 0;
        if (act_out != nullptr && row % BLOCK_V == 0)
          act_out[(BATCHED ? s * sl.act_out : 0) + t] = 0;
      }
    }
  }
}

// A slot's offset into a per-slot array: 0 in the solo instantiation.
template <bool BATCHED>
__device__ __forceinline__ long long at(int slot, long long stride) {
  if constexpr (BATCHED)
    return slot * stride;
  else
    return 0;
}

// Pull sweep (<- _fused_kernel) on the walk.  outs.p = one [n_pad, n_j]
// candidate array per lex level, then (need_hp) one int32 [n_pad, n_j]
// has-pred array per component, each per slot.  DERIVE = false: tile_act
// is the frontier's tile activity and every walked tile runs.  DERIVE =
// true: tile_act is the layout's static non-empty tiles (shared by the
// slots); the block votes whether any slot of the tile is real with an
// active source, writes the vote to act_out[slot][tile] ([n_i, n_j] int32
// per slot), and an inactive tile writes only its identity cells (has-pred
// 0).  A tile that runs computes the same in both modes and in every slot:
// the same loads, the same lex chain, the same order.
template <class R, bool DERIVE, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
pull_kernel(const int* __restrict__ tile_act, long long n_tiles,
            int* __restrict__ act_out, const int* __restrict__ srcs,
            const float* __restrict__ weight,
            const float* __restrict__ capacity,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ active, const float* __restrict__ outdeg,
            const float* __restrict__ wdeg, Ptrs states, Ptrs outs, int n_j,
            int width, float nv, int need_hp, Slots sl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto visit = [&](long long tile, int slot) {
    const int i = (int)tile / n_j, j = (int)tile - i * n_j;  // < 2^21 tiles
    const long long row = (long long)i * BLOCK_V + warp;
    const long long cell = at<BATCHED>(slot, sl.out) + row * n_j + j;
    const long long base = row * width + j * BLOCK_E + lane * SLOTS;
    const int* act_s = active + at<BATCHED>(slot, sl.active);
    int sv[SLOTS];
    bool raw[SLOTS], act[SLOTS];
    load4<int4>(srcs + base, sv);
    load_mask4(mask + base, raw);
    bool any = false;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      act[s] = raw[s] && act_s[sv[s]] != 0;
      any = any || act[s];
    }
    if constexpr (DERIVE) {               // one decision per tile
      const bool live = __syncthreads_or(any) != 0;
      if (threadIdx.x == 0)
        act_out[at<BATCHED>(slot, sl.act_out) + tile] = live ? 1 : 0;
      if (!live) {
        if (lane == 0) {
          write_identities<R>(outs, cell);
          if (need_hp)
            for (int k = 0; k < R::NC; ++k)
              static_cast<int*>(outs.p[R::NLEV + k])[cell] = 0;
        }
        return;
      }
    }
    float wv[SLOTS] = {}, cv[SLOTS] = {};
    if constexpr (R::READS_W) load4<float4>(weight + base, wv);
    if constexpr (R::READS_C) load4<float4>(capacity + base, cv);
    float od[SLOTS] = {}, wd[SLOTS] = {};
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      if constexpr (R::READS_OUTDEG) od[s] = outdeg[sv[s]];
      if constexpr (R::READS_WDEG) wd[s] = wdeg[sv[s]];
    }
    uint32_t gathered[R::NC][SLOTS], props[R::NC][SLOTS];
#pragma unroll
    for (int k = 0; k < R::NC; ++k) {       // ONE gather per component
      const uint32_t* st = static_cast<const uint32_t*>(states.p[k]) +
                           at<BATCHED>(slot, sl.state);
      const uint32_t id = R::ident(k);
      const bool f = R::comp_float(k);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const uint32_t nw = st[sv[s]];
        const Env e{wv[s], cv[s], sv[s], (int)row, od[s], wd[s], nv};
        const uint32_t p = R::P(k, e, nw);
        gathered[k][s] = nw;
        props[k][s] = weq(nw, id, f) ? id : p;   // C3: ⊥ stays ⊥
      }
    }
    uint32_t best[R::NLEV];
    lex_chain<R>(props, act, best);
    bool nb[R::NC];
    if (need_hp) {                          // fused has-pred probe (raw mask)
#pragma unroll
      for (int k = 0; k < R::NC; ++k) {
        bool hit = false;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          hit = hit || (raw[s] && !weq(gathered[k][s], R::ident(k),
                                       R::comp_float(k)));
        nb[k] = __any_sync(0xffffffffu, hit);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int l = 0; l < R::NLEV; ++l)
        static_cast<uint32_t*>(outs.p[l])[cell] = best[l];
      if (need_hp)
        for (int k = 0; k < R::NC; ++k)
          static_cast<int*>(outs.p[R::NLEV + k])[cell] = nb[k] ? 1 : 0;
    }
  };
  fill_skipped<R, BATCHED>(tile_act, n_tiles, n_j, outs, need_hp,
                           DERIVE ? act_out : nullptr, sl);
  walk_tiles<BATCHED>(tile_act, n_tiles, sl, visit);
}

// Push sweep (<- _push_kernel) over the out-layout: rows are sources, state
// is read per row.  outs.p = one [n_pad, width] per-edge candidate array per
// component, each per slot.  Only active tiles are written: there, a
// padding slot or an inactive row gets the identity and every other slot
// its P value, bit for bit the reference's; a skipped tile's slots are
// left as they were.
template <class R, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
push_kernel(const int* __restrict__ tile_act, long long n_tiles,
            const int* __restrict__ dsts, const float* __restrict__ weight,
            const float* __restrict__ capacity,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ active, const float* __restrict__ outdeg,
            const float* __restrict__ wdeg, Ptrs states, Ptrs outs, int n_j,
            int width, float nv, Slots sl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  auto visit = [&](long long tile, int slot) {
    const int i = (int)tile / n_j, j = (int)tile - i * n_j;  // < 2^21 tiles
    const long long row = (long long)i * BLOCK_V + warp;
    const long long base = row * width + j * BLOCK_E + lane * SLOTS;
    int dv[SLOTS] = {};
    float wv[SLOTS] = {}, cv[SLOTS] = {};
    bool live[SLOTS];
    if constexpr (R::READS_EDST) load4<int4>(dsts + base, dv);
    if constexpr (R::READS_W) load4<float4>(weight + base, wv);
    if constexpr (R::READS_C) load4<float4>(capacity + base, cv);
    load_mask4(mask + base, live);
    const bool row_act = active[at<BATCHED>(slot, sl.active) + row] != 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) live[s] = live[s] && row_act;
    float od = 0.f, wd = 0.f;
    if constexpr (R::READS_OUTDEG) od = outdeg[row];
    if constexpr (R::READS_WDEG) wd = wdeg[row];
#pragma unroll
    for (int k = 0; k < R::NC; ++k) {
      const uint32_t id = R::ident(k);
      const uint32_t nw = static_cast<const uint32_t*>(
          states.p[k])[at<BATCHED>(slot, sl.state) + row];
      const bool bot = weq(nw, id, R::comp_float(k));
      uint32_t o[SLOTS];
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const Env e{wv[s], cv[s], (int)row, dv[s], od, wd, nv};
        const uint32_t p = bot ? id : R::P(k, e, nw);   // C3: ⊥ stays ⊥
        o[s] = live[s] ? p : id;
      }
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(outs.p[k]) +
                                at<BATCHED>(slot, sl.out) + base) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  };
  walk_tiles<BATCHED>(tile_act, n_tiles, sl, visit);
}

// Dst-sorted push resolution (<- _resolve_kernel) over the dst-major
// rectangle.  Each valid slot of an active tile names its candidate's flat
// out-layout index x = in2out: out-row x / width_out, out-tile (row / 8,
// (x mod width_out) / 128).  The candidate is read only where push_act says
// that out-tile ran (the push sweep left every other tile undefined); the
// identity stands in elsewhere.  Then the pull kernel's lex chain.  With
// need_hp, the pull kernel's fused has-pred probe (Def. 4's CPreds ≠ ∅):
// per component, whether a valid slot's source row x / width_out holds a
// non-⊥ state.  outs.p = one [n_pad, n_j] array per lex level, then (need_hp)
// one int32 [n_pad, n_j] has-pred array per component; a skipped tile's
// cells hold the identities (has-pred 0).  Every query slot reads its own
// push activity, candidates and states (sl.push_act, sl.cand, sl.state).
template <class R, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(const int* __restrict__ tile_act, long long n_tiles,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ in2out,
               const int* __restrict__ push_act, Ptrs cands, Ptrs states,
               Ptrs outs, int n_j, int width, int width_out, int need_hp,
               Slots sl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_j_out = width_out / BLOCK_E;
  auto visit = [&](long long tile, int slot) {
    const int i = (int)tile / n_j, j = (int)tile - i * n_j;
    const long long row = (long long)i * BLOCK_V + warp;
    const long long cell = at<BATCHED>(slot, sl.out) + row * n_j + j;
    const long long base = row * width + j * BLOCK_E + lane * SLOTS;
    const int* pact = push_act + at<BATCHED>(slot, sl.push_act);
    int xv[SLOTS], src[SLOTS];
    bool ok[SLOTS], ran[SLOTS];
    load4<int4>(in2out + base, xv);
    load_mask4(valid + base, ok);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      src[s] = xv[s] / width_out;
      const int col = xv[s] - src[s] * width_out;
      ran[s] = ok[s] && pact[(long long)(src[s] / BLOCK_V) * n_j_out +
                             col / BLOCK_E] != 0;
    }
    uint32_t vals[R::NC][SLOTS];
#pragma unroll
    for (int k = 0; k < R::NC; ++k) {
      const uint32_t* cand = static_cast<const uint32_t*>(cands.p[k]) +
                             at<BATCHED>(slot, sl.cand);
      const uint32_t id = R::ident(k);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        vals[k][s] = ran[s] ? cand[(long long)xv[s]] : id;
    }
    uint32_t best[R::NLEV];
    lex_chain<R>(vals, ok, best);
    bool nb[R::NC];
    if (need_hp) {                          // fused has-pred probe
#pragma unroll
      for (int k = 0; k < R::NC; ++k) {
        const uint32_t* st = static_cast<const uint32_t*>(states.p[k]) +
                             at<BATCHED>(slot, sl.state);
        bool any = false;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s)
          any = any || (ok[s] && !weq(st[src[s]], R::ident(k),
                                      R::comp_float(k)));
        nb[k] = __any_sync(0xffffffffu, any);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int l = 0; l < R::NLEV; ++l)
        static_cast<uint32_t*>(outs.p[l])[cell] = best[l];
      if (need_hp)
        for (int k = 0; k < R::NC; ++k)
          static_cast<int*>(outs.p[R::NLEV + k])[cell] = nb[k] ? 1 : 0;
    }
  };
  fill_skipped<R, BATCHED>(tile_act, n_tiles, n_j, outs, need_hp, nullptr,
                           sl);
  walk_tiles<BATCHED>(tile_act, n_tiles, sl, visit);
}

// The walking kernels' grid: as many blocks as the card holds at once
// (SMs × resident blocks of `kernel`, asked once per kernel and cached by
// the entry point), never more than the steps of THREADS items need.
template <class K>
inline int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

inline int walk_grid(int resident, long long n_tiles) {
  const long long chunks = (n_tiles + THREADS - 1) / THREADS;
  return (int)(chunks < 1 ? 1 : (chunks < resident ? chunks : resident));
}

inline Ptrs pack(void* const* p, int n) {
  Ptrs out{};
  for (int k = 0; k < n && k < MAX_PTRS; ++k) out.p[k] = p[k];
  return out;
}

// The slot axis from an entry point's arguments: the slot count, the item
// order and the per-slot strides in the order of struct Slots.
inline Slots slots_of(int n_slots, int slot_major, const long long* strides) {
  return Slots{n_slots,    slot_major, strides[0], strides[1], strides[2],
               strides[3], strides[4], strides[5], strides[6]};
}

// One launch of the pull kernel in either mode, on the walk's grid.
template <class R, bool DERIVE, bool BATCHED>
inline int launch_pull(const void* tile_act, void* act_out, const void* srcs,
                       const void* weight, const void* capacity,
                       const void* mask, const void* active,
                       const void* outdeg, const void* wdeg,
                       void* const* states, void* const* outs, int n_tiles,
                       int n_j, int width, float nv, int need_hp, Slots sl,
                       void* stream) {
  static int resident = 0;
  if (!resident) resident = resident_blocks(pull_kernel<R, DERIVE, BATCHED>);
  pull_kernel<R, DERIVE, BATCHED>
      <<<walk_grid(resident, (long long)n_tiles * sl.n), THREADS, 0,
         (cudaStream_t)stream>>>(
          (const int*)tile_act, n_tiles, (int*)act_out, (const int*)srcs,
          (const float*)weight, (const float*)capacity,
          (const unsigned char*)mask, (const int*)active,
          (const float*)outdeg, (const float*)wdeg, pack(states, R::NC),
          pack(outs, R::NLEV + (need_hp ? R::NC : 0)), n_j, width, nv,
          need_hp, sl);
  return (int)cudaGetLastError();
}

template <class R, bool BATCHED>
inline int launch_push(const void* tile_act, const void* dsts,
                       const void* weight, const void* capacity,
                       const void* mask, const void* active,
                       const void* outdeg, const void* wdeg,
                       void* const* states, void* const* outs, int n_tiles,
                       int n_j, int width, float nv, Slots sl, void* stream) {
  static int resident = 0;
  if (!resident) resident = resident_blocks(push_kernel<R, BATCHED>);
  push_kernel<R, BATCHED><<<walk_grid(resident, (long long)n_tiles * sl.n),
                            THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)tile_act, n_tiles, (const int*)dsts, (const float*)weight,
      (const float*)capacity, (const unsigned char*)mask, (const int*)active,
      (const float*)outdeg, (const float*)wdeg, pack(states, R::NC),
      pack(outs, R::NC), n_j, width, nv, sl);
  return (int)cudaGetLastError();
}

template <class R, bool BATCHED>
inline int launch_resolve(const void* tile_act, const void* valid,
                          const void* in2out, const void* push_act,
                          void* const* cands, void* const* states,
                          void* const* outs, int n_tiles, int n_j, int width,
                          int width_out, int need_hp, Slots sl,
                          void* stream) {
  static int resident = 0;
  if (!resident) resident = resident_blocks(resolve_kernel<R, BATCHED>);
  resolve_kernel<R, BATCHED>
      <<<walk_grid(resident, (long long)n_tiles * sl.n), THREADS, 0,
         (cudaStream_t)stream>>>(
          (const int*)tile_act, n_tiles, (const unsigned char*)valid,
          (const int*)in2out, (const int*)push_act, pack(cands, R::NC),
          pack(states, need_hp ? R::NC : 0),
          pack(outs, R::NLEV + (need_hp ? R::NC : 0)), n_j, width,
          width_out, need_hp, sl);
  return (int)cudaGetLastError();
}

template <class K>
inline void walk_attributes(K kernel, int* out) {
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = resident_blocks(kernel);
}

}  // namespace grafs

// Plain C entry points of one round's library; each returns the
// cudaGetLastError() of its launch (0 = launched).  Each sweep takes the
// slot count of its launch, its item order (slot_major) and the seven
// per-slot strides of struct Slots (a host array; 0 shares an array among
// the slots): one slot runs the solo instantiation, more the batched one.
// grafs_pull runs the pull kernel with the given activity when act_out is
// null, else with the activity derived from the static tiles in tile_act
// (written to act_out).  grafs_walk_attributes writes the walking kernels'
// registers per thread and grids: push, resolve, pull (given), pull
// (derived), a pair each, solo then batched.
#define GRAFS_DEFINE_ENTRY_POINTS(R)                                          \
  extern "C" int grafs_pull(const void* tile_act, void* act_out,             \
                            const void* srcs, const void* weight,            \
                            const void* capacity, const void* mask,          \
                            const void* active, const void* outdeg,          \
                            const void* wdeg, void* const* states,           \
                            void* const* outs, int n_tiles, int n_j,         \
                            int width, float nv, int need_hp, int n_slots,   \
                            int slot_major, const long long* strides,        \
                            void* stream) {                                  \
    const grafs::Slots sl = grafs::slots_of(n_slots, slot_major, strides);   \
    auto* const launch =                                                     \
        act_out == nullptr                                                   \
            ? (n_slots == 1 ? grafs::launch_pull<R, false, false>            \
                            : grafs::launch_pull<R, false, true>)            \
            : (n_slots == 1 ? grafs::launch_pull<R, true, false>             \
                            : grafs::launch_pull<R, true, true>);            \
    return launch(tile_act, act_out, srcs, weight, capacity, mask, active,   \
                  outdeg, wdeg, states, outs, n_tiles, n_j, width, nv,       \
                  need_hp, sl, stream);                                      \
  }                                                                          \
  extern "C" int grafs_push(const void* tile_act, const void* dsts,          \
                            const void* weight, const void* capacity,        \
                            const void* mask, const void* active,            \
                            const void* outdeg, const void* wdeg,            \
                            void* const* states, void* const* outs,          \
                            int n_tiles, int n_j, int width, float nv,       \
                            int n_slots, int slot_major,                     \
                            const long long* strides, void* stream) {        \
    const grafs::Slots sl = grafs::slots_of(n_slots, slot_major, strides);   \
    auto* const launch = n_slots == 1 ? grafs::launch_push<R, false>         \
                                      : grafs::launch_push<R, true>;         \
    return launch(tile_act, dsts, weight, capacity, mask, active, outdeg,    \
                  wdeg, states, outs, n_tiles, n_j, width, nv, sl, stream);  \
  }                                                                          \
  extern "C" int grafs_resolve(const void* tile_act, const void* valid,      \
                               const void* in2out, const void* push_act,     \
                               void* const* cands, void* const* states,      \
                               void* const* outs, int n_tiles, int n_j,      \
                               int width, int width_out, int need_hp,        \
                               int n_slots, int slot_major,                  \
                               const long long* strides, void* stream) {     \
    const grafs::Slots sl = grafs::slots_of(n_slots, slot_major, strides);   \
    auto* const launch = n_slots == 1 ? grafs::launch_resolve<R, false>      \
                                      : grafs::launch_resolve<R, true>;      \
    return launch(tile_act, valid, in2out, push_act, cands, states, outs,    \
                  n_tiles, n_j, width, width_out, need_hp, sl, stream);      \
  }                                                                          \
  extern "C" int grafs_walk_attributes(int* out) {                           \
    grafs::walk_attributes(grafs::push_kernel<R, false>, out);               \
    grafs::walk_attributes(grafs::resolve_kernel<R, false>, out + 2);        \
    grafs::walk_attributes(grafs::pull_kernel<R, false, false>, out + 4);    \
    grafs::walk_attributes(grafs::pull_kernel<R, true, false>, out + 6);     \
    grafs::walk_attributes(grafs::push_kernel<R, true>, out + 8);            \
    grafs::walk_attributes(grafs::resolve_kernel<R, true>, out + 10);        \
    grafs::walk_attributes(grafs::pull_kernel<R, false, true>, out + 12);    \
    grafs::walk_attributes(grafs::pull_kernel<R, true, true>, out + 14);     \
    return (int)cudaGetLastError();                                          \
  }
