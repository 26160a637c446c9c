// Helpers shared by the row kernels in this directory: float32 <->
// storage-type conversion, warp and row sums and maxima, the running
// (max, sum of exp) pair of a streamed softmax row, and the error string
// that every library exports for its Python wrapper.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mx {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum over the threads of one row.  With a whole block per row the
// warps' partials meet in `red` (32 floats), and every warp then sums
// all of them, so every thread gets the total.  The first barrier keeps
// a previous call's readers of `red` ahead of this call's writers.  The
// block size is a multiple of 32.
__device__ __forceinline__ float row_sum(float v, float* red,
                                         bool whole_block) {
  v = warp_sum(v);
  if (!whole_block) return v;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

// Adds value v to a running (max m, sum s of exp(x - m)).  A -inf logit
// adds nothing; a NaN makes the sum NaN.
__device__ __forceinline__ void ms_add(float& m, float& s, float v) {
  if (v == -INFINITY) return;
  if (v > m) {
    s = s * expf(m - v) + 1.f;  // m = -inf at first: s is 0, expf gives 0
    m = v;
  } else {
    s += expf(v - m);
  }
}

// Merges the pair (m2, s2) into (m, s).
__device__ __forceinline__ void ms_merge(float& m, float& s, float m2,
                                         float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// Merges the pairs of all threads of a row; every thread gets the
// result.  `red` holds 64 floats.  See row_sum for the barriers.
__device__ __forceinline__ void row_ms(float& m, float& s, float* red,
                                       bool whole_block) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    ms_merge(m, s, m2, s2);
  }
  if (!whole_block) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) {
    red[warp] = m;
    red[32 + warp] = s;
  }
  __syncthreads();
  const bool live = lane < static_cast<int>(blockDim.x >> 5);
  m = live ? red[lane] : -INFINITY;
  s = live ? red[32 + lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    ms_merge(m, s, m2, s2);
  }
}

// Values a lane holds when one warp takes a row of `cols` values in
// registers: the least power of two N with 32 * N >= cols.
inline int lane_values(int cols) {
  int n = 1;
  while (32 * n < cols) n <<= 1;
  return n;
}

}  // namespace mx

// The text of a cudaError_t, for the wrapper's KernelError.  Each
// library is built from one .cu file, so each holds one definition.
extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
