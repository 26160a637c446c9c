// Helpers shared by the row kernels in this directory: float32 <->
// storage-type conversion, warp and row sums, and the error string that
// every library exports for its Python wrapper.
#pragma once

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

}  // namespace mx

// The text of a cudaError_t, for the wrapper's KernelError.  Each
// library is built from one .cu file, so each holds one definition.
extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
