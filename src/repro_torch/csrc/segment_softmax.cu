// Masked row softmax over the blocked-ELL slot axis (GAT edge attention),
// for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of src/repro/kernels/segment_softmax.py
// (launched by ell_softmax): _stats_kernel, the online row max and
// sum-exp across slot tiles, and _norm_kernel, the normalising pass.
//
// One warp per row, SOFTMAX_ROWS rows per block, rows flattened onto
// blockIdx.x.  A loop inside the warp over the row's slots takes the place
// of the Pallas grid's sequential slot axis.  Pass 1 keeps each lane's
// running (max m, sum s) over its real slots, starting from (-1e30, 0) as
// the reference does (s compensated, Kahan), then merges the 32 pairs: the
// row's max m by a butterfly, each lane's s·e^(m_lane − m), summed by a
// butterfly (every lane ends with the same pair).  Pass 2 writes
// exp(score − m) / max(s, 1e-30) on real slots; a masked slot is set to 0
// by select, never by multiplying by the mask, because the raw score of a
// masked slot may be inf or NaN.  An empty row comes out all zeros.
// Arithmetic is float32 for float32 and bfloat16 scores; the output has
// the scores' type.
//
// What bounds it on an H100: bytes.  The work needs each slot's mask byte
// and output once and the score of each real slot only: a masked slot's
// output is 0 whatever its score.  On a sparse layout (the rmat16
// in-layout: 0.23 % of its slots real) that is mostly the output's write
// and the mask's read.  The design moves about those bytes.  Where the row
// width is a multiple of a 16-byte chunk's slots (4 float32, 8 bfloat16),
// lane l takes the row's chunks l, l + 32, … in both passes, so each load
// and store of the warp covers neighbouring chunks:
// - pass 1 reads each chunk's mask bytes as one word (SOFTMAX_UNROLL in
//   flight a lane) and the chunk's scores only where a word is not zero;
//   the chunk's max over its real slots updates the running pair once;
// - pass 1 also keeps a bit a chunk (its first 64 chunks a lane) of
//   which chunks hold a real slot, so pass 2 reads the mask again (from L1
//   or L2, just after pass 1 read it) only for those chunks, writes every
//   other chunk as zeros without reading its mask or scores, and stores 16
//   bytes a lane with streaming stores (st.global.cs), so that the output
//   does not evict the mask from L2;
// - a row with s = 0 (no real slot, or only real slots whose exp
//   underflows, whose weights are then 0 / 1e-30 = 0) is a zero fill that
//   reads nothing;
// - a row of at most 32 chunks runs the narrow instantiation: a chunk a
//   lane, whose mask word and scores stay in registers from pass 1 to
//   pass 2, and fewer registers a thread, so more rows in flight (each row
//   is a short chain of dependent loads).
// Other widths take a scalar path in this kernel with the same
// arithmetic: a slot a lane, the score read only on a real slot.
#include <math.h>

#include "dtypes.cuh"

namespace grafs {

constexpr float SOFTMAX_NEG = -1e30f;
constexpr int SOFTMAX_ROWS = 8;     // rows (one warp each) per block
constexpr int SOFTMAX_UNROLL = 4;   // chunks' mask loads in flight a lane
// Warps an SM should hold, which caps the registers a thread: rows wider
// than 32 chunks run the unrolled kernel, narrower rows (and the scalar
// path) the kernel without unrolling, whose rows are short chains of
// dependent loads and gain most from more warps in flight.
constexpr int SOFTMAX_WARPS_PER_SM = 32;
constexpr int SOFTMAX_NARROW_WARPS_PER_SM = 64;

// A 16-byte chunk of scores as floats: 4 float32 or 8 bfloat16 slots (a
// bfloat16's float is its bits shifted up 16, exactly __bfloat162float).
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// Streaming 16-byte stores of a chunk's weights.
__device__ __forceinline__ void store16(float* p, const float (&w)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(w[0], w[1], w[2], w[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&w)[8]) {
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = (unsigned)__bfloat16_as_ushort(from_f<__nv_bfloat16>(w[2 * k])) |
           ((unsigned)__bfloat16_as_ushort(
                from_f<__nv_bfloat16>(w[2 * k + 1])) << 16);
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
}
template <class T>
__device__ __forceinline__ void store16_zero(T* p) {
  __stcs(reinterpret_cast<uint4*>(p), make_uint4(0u, 0u, 0u, 0u));
}

// The mask bytes of one 16-byte score chunk: 4 (float32) or 8 (bfloat16).
template <class T>
struct ChunkMask {
  using type = unsigned;
};
template <>
struct ChunkMask<__nv_bfloat16> {
  using type = unsigned long long;
};

// A lane's running pair over its real slots: the max m (from -1e30, as
// the reference starts) and the sum of exp(x - m), kept compensated
// (Kahan: ``comp`` carries what each add rounded away), so a lane that
// adds many terms loses no more than one that adds few.
struct RowStats {
  float m = SOFTMAX_NEG, sum = 0.f, comp = 0.f;

  // the max rises to ``cm``: rescale the sum to it
  __device__ __forceinline__ void raise(float cm) {
    if (cm > m) {
      const float r = expf(m - cm);
      sum = sum * r;
      comp = comp * r;
      m = cm;
    }
  }
  __device__ __forceinline__ void add(float e) {
    const float y = e - comp;
    const float t = sum + y;
    comp = (t - sum) - y;
    sum = t;
  }
  // Merges the 32 lanes' pairs: the row's max first, each lane's sum
  // rescaled to it, then the sums added in a butterfly.  Every lane ends
  // with the same pair (each step's two sides add the same two terms).
  __device__ __forceinline__ void warp_merge() {
    float mr = m;
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    sum = (sum - comp) * expf(m - mr);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum = sum + __shfl_xor_sync(0xffffffffu, sum, off);
    m = mr;
  }
};

// Pass 1 over one 16-byte chunk: its mask bytes ``bits`` and scores ``v``
// (a chunk with a real slot).  The chunk's max over its real slots raises
// the lane's max once, then the real slots' exps, summed in slot order,
// are added: the online recurrence a chunk at a time.
template <class MaskWord, int N>
__device__ __forceinline__ void stats_chunk(MaskWord bits,
                                            const float (&v)[N],
                                            RowStats& st) {
  float cm = st.m;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (((bits >> (8 * j)) & 0xffu) && v[j] > cm) cm = v[j];
  st.raise(cm);
  float e = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if ((bits >> (8 * j)) & 0xffu) e = e + expf(v[j] - st.m);
  st.add(e);
}

// Pass 2 over one chunk with a real slot: its weights, 0 by select on a
// masked slot, stored.
template <class T, class MaskWord, int N>
__device__ __forceinline__ void store_weights(MaskWord bits,
                                              const float (&v)[N], float m,
                                              float denom, T* p) {
  float w[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    w[j] = (bits >> (8 * j)) & 0xffu ? expf(v[j] - m) / denom : 0.f;
  store16(p, w);
}

// UNROLL == 1 is the narrow kernel: the scalar path, or at most 32 chunks
// a row (the launcher's choice), one a lane, whose mask word and scores
// stay in registers from pass 1 to pass 2.  UNROLL > 1: wider rows.
template <class T, int UNROLL>
__global__ void __launch_bounds__(
    32 * SOFTMAX_ROWS, (UNROLL == 1 ? SOFTMAX_NARROW_WARPS_PER_SM
                                    : SOFTMAX_WARPS_PER_SM) / SOFTMAX_ROWS)
ell_softmax_kernel(const T* __restrict__ scores,
                   const unsigned char* __restrict__ mask,
                   T* __restrict__ out, long long n_rows, int width) {
  constexpr int N = 16 / sizeof(T);
  using MaskWord = typename ChunkMask<T>::type;
  const long long row =
      (long long)blockIdx.x * SOFTMAX_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;                  // whole warps leave together
  const T* s = scores + row * width;
  const unsigned char* mk = mask + row * width;
  T* o = out + row * width;
  RowStats st;
  if (width % N != 0) {
    // the scalar path: a slot a lane
    for (int c = lane; c < width; c += 32)
      if (mk[c]) {
        const float x = to_f(s[c]);
        st.raise(x);
        st.add(expf(x - st.m));
      }
    st.warp_merge();
    const float denom = fmaxf(st.sum, 1e-30f);
    for (int c = lane; c < width; c += 32)
      o[c] = mk[c] && st.sum != 0.f
                 ? from_f<T>(expf(to_f(s[c]) - st.m) / denom)
                 : from_f<T>(0.f);
    return;
  }
  // The 16-byte path: the row's scores and output start 16-byte aligned,
  // its mask N-byte aligned (the wrapper checks the bases).
  const int nc = width / N;                   // 16-byte chunks of the row
  const MaskWord* mw = reinterpret_cast<const MaskWord*>(mk);
  if constexpr (UNROLL == 1) {
    const MaskWord bits = lane < nc ? __ldg(mw + lane) : MaskWord(0);
    float v[N];
    if (bits != 0) {
      load16(s + lane * N, v);
      stats_chunk(bits, v, st);
    }
    st.warp_merge();
    if (lane >= nc) return;
    if (bits == 0 || st.sum == 0.f)
      store16_zero(o + lane * N);
    else
      store_weights(bits, v, st.m, fmaxf(st.sum, 1e-30f), o + lane * N);
    return;
  }
  // bit k: the lane's chunk lane + 32k has a real slot (k < 64; pass 2
  // reads the mask again only there, and for every chunk from k = 64 on)
  unsigned long long live = 0;
  for (int c0 = lane, k0 = 0; c0 < nc;
       c0 += 32 * UNROLL, k0 += UNROLL) {
    MaskWord bits[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + 32 * u;
      bits[u] = c < nc ? __ldg(mw + c) : MaskWord(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (bits[u] == 0) continue;
      if (k0 + u < 64) live |= 1ull << (k0 + u);
      float v[N];
      load16(s + (c0 + 32 * u) * N, v);
      stats_chunk(bits[u], v, st);
    }
  }
  st.warp_merge();
  const float m = st.m, sum = st.sum;
  if (sum == 0.f) {
    for (int c = lane; c < nc; c += 32) store16_zero(o + c * N);
    return;
  }
  const float denom = fmaxf(sum, 1e-30f);
  for (int c0 = lane, k0 = 0; c0 < nc;
       c0 += 32 * UNROLL, k0 += UNROLL) {
    MaskWord bits[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + 32 * u, k = k0 + u;
      const bool read = c < nc && (k >= 64 || ((live >> k) & 1));
      bits[u] = read ? __ldg(mw + c) : MaskWord(0);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int c = c0 + 32 * u;
      if (c >= nc) break;
      if (bits[u] == 0) {
        store16_zero(o + c * N);
        continue;
      }
      float v[N];
      load16(s + c * N, v);
      store_weights(bits[u], v, m, denom, o + c * N);
    }
  }
}


// Rows of at most 32 chunks (one a lane) take the kernel without unrolling.
template <class T>
bool narrow(long long width) {
  constexpr int N = 16 / sizeof(T);
  return width % N != 0 || width / N <= 32;
}

template <class T>
int launch(const void* scores, const void* mask, void* out,
           long long n_rows, long long width, cudaStream_t st) {
  const long long blocks = (n_rows + SOFTMAX_ROWS - 1) / SOFTMAX_ROWS;
  const int threads = 32 * SOFTMAX_ROWS;
  const T* s = static_cast<const T*>(scores);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  T* o = static_cast<T*>(out);
  if (narrow<T>(width))
    ell_softmax_kernel<T, 1><<<blocks, threads, 0, st>>>(s, m, o, n_rows,
                                                         (int)width);
  else
    ell_softmax_kernel<T, SOFTMAX_UNROLL><<<blocks, threads, 0, st>>>(
        s, m, o, n_rows, (int)width);
  return (int)cudaGetLastError();
}

template <class T>
int attributes(int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(
      &fa, ell_softmax_kernel<T, SOFTMAX_UNROLL>);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.localSizeBytes;
  err = cudaFuncGetAttributes(&fa, ell_softmax_kernel<T, 1>);
  if (err != cudaSuccess) return (int)err;
  attrs[2] = fa.numRegs;
  attrs[3] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace grafs

// scores/out [n_rows, width] of dtype grafs::DT_F32 or DT_BF16, mask bool
// [n_rows, width] (width at most 2^30), each 16-byte aligned.  Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int grafs_ell_softmax(const void* scores, const void* mask,
                                 void* out, long long n_rows, long long width,
                                 int dtype, void* stream) {
  if (n_rows == 0 || width == 0) return 0;
  if (width > (1LL << 30)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return dtype == grafs::DT_BF16
             ? grafs::launch<__nv_bfloat16>(scores, mask, out, n_rows, width,
                                            st)
             : grafs::launch<float>(scores, mask, out, n_rows, width, st);
}

// The compiled kernels of ``dtype``: registers and local (spill) bytes per
// thread of the unrolled kernel (rows wider than 32 chunks), then of the
// narrow one, into attrs[4].
extern "C" int grafs_ell_softmax_attributes(int dtype, int* attrs) {
  return dtype == grafs::DT_BF16 ? grafs::attributes<__nv_bfloat16>(attrs)
                                 : grafs::attributes<float>(attrs);
}
