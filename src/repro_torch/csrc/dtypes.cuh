// Element types of the embedding bag and the ELL softmax: float32 and
// bfloat16 storage, float32 arithmetic.  The conversions round to nearest
// even, as torch's .to(torch.bfloat16) does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace grafs {

enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <class T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace grafs
