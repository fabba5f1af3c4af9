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
// Geometry: one 256-thread block per (8 rows × 128 slots) tile, the tile
// index flattened onto blockIdx.x (the uniform graphs have more than 65,535
// row tiles, so nothing goes on gridDim.y).  Warp r owns row r of the tile;
// lane l owns the four contiguous slots 4l..4l+3, loaded as one 16-byte
// vector per array.  Addresses are computed in 64 bits.
//
// What bounds them on an H100: bytes.  Each processed slot reads its mask
// and (pull) its source index; of the weight, the capacity, (push) the
// destination index and the source's degrees it reads only what the
// round's P reads; then the gathered state words.  It does a handful of
// operations, far below the 295 operations per byte at which the card's
// arithmetic would become the limit.  The design keeps the
// reference's frontier-proportional tile skip (a tile whose activity bit is
// 0 reads nothing but that bit and writes only identities, condition C6 bit
// for bit) and coalesced 16-byte loads; it does not yet keep the
// candidates out of device memory (the push sweep writes its whole
// out-rectangle, as the reference does).
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
constexpr int MAX_PTRS = 16;

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

// Pull sweep (<- _fused_kernel).  outs.p = one [n_pad, n_j] candidate array
// per lex level, then (need_hp) one int32 [n_pad, n_j] has-pred array per
// component.
template <class R>
__global__ void __launch_bounds__(THREADS)
pull_kernel(const int* __restrict__ tile_act, const int* __restrict__ srcs,
            const float* __restrict__ weight,
            const float* __restrict__ capacity,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ active, const float* __restrict__ outdeg,
            const float* __restrict__ wdeg, Ptrs states, Ptrs outs, int n_j,
            int width, float nv, int need_hp) {
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = tile / n_j, j = tile % n_j;
  const long long row = i * BLOCK_V + warp;
  const long long cell = row * n_j + j;
  if (tile_act[tile] == 0) {
    if (lane == 0) {
      write_identities<R>(outs, cell);
      if (need_hp)
        for (int k = 0; k < R::NC; ++k)
          static_cast<int*>(outs.p[R::NLEV + k])[cell] = 0;
    }
    return;
  }
  const long long base = row * width + j * BLOCK_E + lane * SLOTS;
  int sv[SLOTS];
  float wv[SLOTS] = {}, cv[SLOTS] = {};
  bool raw[SLOTS];
  load4<int4>(srcs + base, sv);
  if constexpr (R::READS_W) load4<float4>(weight + base, wv);
  if constexpr (R::READS_C) load4<float4>(capacity + base, cv);
  load_mask4(mask + base, raw);
  bool act[SLOTS];
  float od[SLOTS] = {}, wd[SLOTS] = {};
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    act[s] = raw[s] && active[sv[s]] != 0;
    if constexpr (R::READS_OUTDEG) od[s] = outdeg[sv[s]];
    if constexpr (R::READS_WDEG) wd[s] = wdeg[sv[s]];
  }
  uint32_t gathered[R::NC][SLOTS], props[R::NC][SLOTS];
#pragma unroll
  for (int k = 0; k < R::NC; ++k) {         // ONE gather per component
    const uint32_t* st = static_cast<const uint32_t*>(states.p[k]);
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
  if (need_hp) {                            // fused has-pred probe (raw mask)
#pragma unroll
    for (int k = 0; k < R::NC; ++k) {
      bool any = false;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        any = any || (raw[s] && !weq(gathered[k][s], R::ident(k),
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
}

// Push sweep (<- _push_kernel) over the out-layout: rows are sources, state
// is read per row.  outs.p = one [n_pad, width] per-edge candidate array per
// component, identity wherever the slot is padding or the row inactive.
template <class R>
__global__ void __launch_bounds__(THREADS)
push_kernel(const int* __restrict__ tile_act, const int* __restrict__ dsts,
            const float* __restrict__ weight,
            const float* __restrict__ capacity,
            const unsigned char* __restrict__ mask,
            const int* __restrict__ active, const float* __restrict__ outdeg,
            const float* __restrict__ wdeg, Ptrs states, Ptrs outs, int n_j,
            int width, float nv) {
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = tile / n_j, j = tile % n_j;
  const long long row = i * BLOCK_V + warp;
  const long long base = row * width + j * BLOCK_E + lane * SLOTS;
  if (tile_act[tile] == 0) {
#pragma unroll
    for (int k = 0; k < R::NC; ++k) {
      const uint32_t id = R::ident(k);
      *reinterpret_cast<uint4*>(static_cast<uint32_t*>(outs.p[k]) + base) =
          make_uint4(id, id, id, id);
    }
    return;
  }
  int dv[SLOTS] = {};
  float wv[SLOTS] = {}, cv[SLOTS] = {};
  bool live[SLOTS];
  if constexpr (R::READS_EDST) load4<int4>(dsts + base, dv);
  if constexpr (R::READS_W) load4<float4>(weight + base, wv);
  if constexpr (R::READS_C) load4<float4>(capacity + base, cv);
  load_mask4(mask + base, live);
  const bool row_act = active[row] != 0;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) live[s] = live[s] && row_act;
  float od = 0.f, wd = 0.f;
  if constexpr (R::READS_OUTDEG) od = outdeg[row];
  if constexpr (R::READS_WDEG) wd = wdeg[row];
#pragma unroll
  for (int k = 0; k < R::NC; ++k) {
    const uint32_t id = R::ident(k);
    const uint32_t nw = static_cast<const uint32_t*>(states.p[k])[row];
    const bool bot = weq(nw, id, R::comp_float(k));
    uint32_t o[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const Env e{wv[s], cv[s], (int)row, dv[s], od, wd, nv};
      const uint32_t p = bot ? id : R::P(k, e, nw);   // C3: ⊥ stays ⊥
      o[s] = live[s] ? p : id;
    }
    *reinterpret_cast<uint4*>(static_cast<uint32_t*>(outs.p[k]) + base) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Dst-sorted push resolution (<- _resolve_kernel): each active tile
// gathers its candidates out of the push sweep's out-rectangles through
// in2out (inside the tile skip, so skipped tiles read no candidate), then
// runs the pull kernel's lex chain.  outs.p as the pull kernel's levels.
template <class R>
__global__ void __launch_bounds__(THREADS)
resolve_kernel(const int* __restrict__ tile_act,
               const unsigned char* __restrict__ valid,
               const int* __restrict__ in2out, Ptrs cands, Ptrs outs,
               int n_j, int width) {
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = tile / n_j, j = tile % n_j;
  const long long row = i * BLOCK_V + warp;
  const long long cell = row * n_j + j;
  if (tile_act[tile] == 0) {
    if (lane == 0) write_identities<R>(outs, cell);
    return;
  }
  const long long base = row * width + j * BLOCK_E + lane * SLOTS;
  int xv[SLOTS];
  bool ok[SLOTS];
  load4<int4>(in2out + base, xv);
  load_mask4(valid + base, ok);
  uint32_t vals[R::NC][SLOTS];
#pragma unroll
  for (int k = 0; k < R::NC; ++k) {
    const uint32_t* cand = static_cast<const uint32_t*>(cands.p[k]);
    const uint32_t id = R::ident(k);
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      vals[k][s] = ok[s] ? cand[(long long)xv[s]] : id;
  }
  uint32_t best[R::NLEV];
  lex_chain<R>(vals, ok, best);
  if (lane == 0) {
#pragma unroll
    for (int l = 0; l < R::NLEV; ++l)
      static_cast<uint32_t*>(outs.p[l])[cell] = best[l];
  }
}

inline Ptrs pack(void* const* p, int n) {
  Ptrs out{};
  for (int k = 0; k < n && k < MAX_PTRS; ++k) out.p[k] = p[k];
  return out;
}

}  // namespace grafs

// Plain C entry points of one round's library; each returns the
// cudaGetLastError() of its launch (0 = launched).
#define GRAFS_DEFINE_ENTRY_POINTS(R)                                          \
  extern "C" int grafs_pull(const void* tile_act, const void* srcs,          \
                            const void* weight, const void* capacity,        \
                            const void* mask, const void* active,            \
                            const void* outdeg, const void* wdeg,            \
                            void* const* states, void* const* outs,          \
                            int n_tiles, int n_j, int width, float nv,       \
                            int need_hp, void* stream) {                     \
    grafs::pull_kernel<R><<<n_tiles, grafs::THREADS, 0,                      \
                            (cudaStream_t)stream>>>(                         \
        (const int*)tile_act, (const int*)srcs, (const float*)weight,        \
        (const float*)capacity, (const unsigned char*)mask,                  \
        (const int*)active, (const float*)outdeg, (const float*)wdeg,        \
        grafs::pack(states, R::NC),                                          \
        grafs::pack(outs, R::NLEV + (need_hp ? R::NC : 0)), n_j, width, nv,  \
        need_hp);                                                            \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int grafs_push(const void* tile_act, const void* dsts,          \
                            const void* weight, const void* capacity,        \
                            const void* mask, const void* active,            \
                            const void* outdeg, const void* wdeg,            \
                            void* const* states, void* const* outs,          \
                            int n_tiles, int n_j, int width, float nv,       \
                            void* stream) {                                  \
    grafs::push_kernel<R><<<n_tiles, grafs::THREADS, 0,                      \
                            (cudaStream_t)stream>>>(                         \
        (const int*)tile_act, (const int*)dsts, (const float*)weight,        \
        (const float*)capacity, (const unsigned char*)mask,                  \
        (const int*)active, (const float*)outdeg, (const float*)wdeg,        \
        grafs::pack(states, R::NC), grafs::pack(outs, R::NC), n_j, width,    \
        nv);                                                                 \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int grafs_resolve(const void* tile_act, const void* valid,      \
                               const void* in2out, void* const* cands,       \
                               void* const* outs, int n_tiles, int n_j,      \
                               int width, void* stream) {                    \
    grafs::resolve_kernel<R><<<n_tiles, grafs::THREADS, 0,                   \
                               (cudaStream_t)stream>>>(                      \
        (const int*)tile_act, (const unsigned char*)valid,                   \
        (const int*)in2out, grafs::pack(cands, R::NC),                       \
        grafs::pack(outs, R::NLEV), n_j, width);                             \
    return (int)cudaGetLastError();                                          \
  }
