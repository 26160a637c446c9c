// Helpers shared by the row kernels in this directory: float32 <->
// storage-type conversion, 16-byte loads and stores of a row's chunks,
// warp and row sums and maxima, the running (max, sum of exp) pair of a
// streamed softmax row, the fixed-order sums of a backward's partial
// rows, and the error string that every library exports for its Python
// wrapper.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>
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

// A parameter vector's value i, stored as P (float32, or x's type T)
// and rounded to T: the wrappers' cast of gamma (and beta) to x's type,
// done in registers.
template <typename T, typename P>
__device__ __forceinline__ float param_as(const P* p, int64_t i) {
  return to_float(from_float<T>(to_float(__ldg(p + i))));
}

// 16 bytes as held in registers (4 float32 or 8 bf16 values), as floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& v, float* out);

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& v, float* out) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& v,
                                                        float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// 16 bytes of float32 or bf16 values as floats, and back.  p is 16-byte
// aligned.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  unpack16<__nv_bfloat16>(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

__device__ __forceinline__ void store16(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* in) {
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // round to nearest even, as from_float
    const __nv_bfloat162 h = __floats2bfloat162_rn(in[2 * j], in[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Values e < E of a parameter vector of type P (float32, or x's type T)
// from index i, as floats rounded to T.  With E > 1 (E = 16 / sizeof(T))
// the vector starts on 16 bytes and i is a multiple of E.
template <typename T, typename P, int E>
__device__ __forceinline__ void load_params(const P* p, int64_t i,
                                            float* out) {
  if constexpr (E > 1 && std::is_same_v<P, float>) {
#pragma unroll
    for (int q = 0; q < E; q += 4) load16(p + i + q, out + q);
#pragma unroll
    for (int e = 0; e < E; ++e) out[e] = to_float(from_float<T>(out[e]));
  } else if constexpr (E > 1) {  // P = T = bf16: nothing to round
    load16(p + i, out);
  } else {
    out[0] = param_as<T, P>(p, i);
  }
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

// Adds the W warps' column sums `acc` in warp order and writes them to
// `part`.  Lane l of each warp holds columns (l + 32 j) * E + e, j < NC,
// e < E; `sums` is shared memory of W * cols floats; the block is W
// warps.
template <int W, int NC, int E>
__device__ __forceinline__ void block_column_sums(const float (&acc)[NC * E],
                                                  float* sums, float* part,
                                                  int cols) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = (lane + 32 * j) * E + e;
      if (c < cols) sums[warp * cols + c] = acc[j * E + e];
    }
  __syncthreads();
  for (int i = threadIdx.x; i < cols; i += 32 * W) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) t += sums[w * cols + i];
    part[i] = t;
  }
  __syncthreads();  // `sums` is free again
}

// The column sums of `blocks` float32 partial rows of `cols` values at
// p, in a fixed order, written to out in O's type (rounded once).  A
// block of 32 * kSumWarps threads takes columns [32 blockIdx.x, 32
// blockIdx.x + 32); warp w adds partial rows w, w + kSumWarps, ... in
// that order, eight loads in flight at a time, and warp 0 then adds the
// warps' sums in warp order.  `red` is shared memory of kSumWarps * 32
// floats.
constexpr int kSumWarps = 32;

template <typename O>
__device__ __forceinline__ void partial_rows_sum(const float* p, O* out,
                                                 int blocks, int cols,
                                                 float (*red)[32]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < cols) {
    for (int b0 = warp; b0 < blocks; b0 += 8 * kSumWarps) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b = b0 + k * kSumWarps;
        v[k] = b < blocks ? p[static_cast<int64_t>(b) * cols + c] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) s += v[k];
    }
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float t = 0.f;
    for (int w = 0; w < kSumWarps; ++w) t += red[w][lane];
    out[c] = from_float<O>(t);
  }
}

// Values a lane holds when one warp takes a row of `cols` values in
// registers: the least power of two N with 32 * N >= cols.
inline int lane_values(int cols) {
  int n = 1;
  while (32 * n < cols) n <<= 1;
  return n;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace mx

// The text of a cudaError_t, for the wrapper's KernelError.  Each
// library is built from one .cu file, so each holds one definition.
extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
