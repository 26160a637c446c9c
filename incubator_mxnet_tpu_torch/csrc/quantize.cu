// float32 <-> int8 codes for the int8 path, written for Hopper (sm_90a):
// quantize (in the tensor's own layout, or channels-last for the int8
// convolution), the min/max reduction quantize takes where no range is
// given, and dequantize.
//
// Replaces no Pallas kernel.  It is the card's counterpart of the JAX
// package's elementwise XLA ops in ops/quantization_ops.py: quantize
// (:34-48) and dequantize (:51-61), with their arithmetic in float32:
//
//   scale = max(max(|lo|, |hi|), 1e-12) / qrange
//   quantize:   q = clip(rint(x / scale), -127, 127)     (int8)
//   dequantize: y = float(q) * scale                     (float32)
//
// qrange is 127 for int8 codes and float32(2^31 - 1) = 2^31 for int32
// sums.  Every operation is an explicitly rounded intrinsic (__fdiv_rn,
// __fmul_rn) or exact (fabsf, fmaxf, rintf: round half to even, as
// jnp.round), so the codes are the JAX op's, bit for bit: the eager op
// divides (under jax.jit XLA's CPU code multiplies by the reciprocal,
// which moves a code now and then).  The range comes as two floats or
// as two device pointers (a range the reduction computed, or one a
// caller holds on the card), so no call copies from the host.
//
// One thread four values: 16-byte loads of float32 or int32, 4-byte
// loads of int8, where the pointers allow; the tail and unaligned
// tensors one value at a time.  Grid-stride loops, 64-bit offsets.
//
// Bound: bytes (each input read once, each output written once).

#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 1024;

__device__ __forceinline__ float range_scale(const float* lo_p,
                                             const float* hi_p, float lo,
                                             float hi, float qrange) {
  if (lo_p != nullptr) lo = *lo_p;
  if (hi_p != nullptr) hi = *hi_p;
  const float amax = fmaxf(fabsf(lo), fabsf(hi));
  return __fdiv_rn(fmaxf(amax, 1e-12f), qrange);
}

__device__ __forceinline__ int8_t code(float v, float scale) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                int64_t n, bool vec, const float* lo_p, const float* hi_p,
                float lo, float hi) {
  const float scale = range_scale(lo_p, hi_p, lo, hi, 127.f);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    reinterpret_cast<char4*>(q)[i] =
        make_char4(code(v.x, scale), code(v.y, scale), code(v.z, scale),
                   code(v.w, scale));
  }
  for (int64_t i = n4 * 4 + first; i < n; i += stride)
    q[i] = code(__ldg(x + i), scale);
}

// The same codes written channels-last: x is (N, C, HW) float32, q the
// same tensor's codes as (N, HW, C) int8, the layout the int8
// convolution reads.  A block takes 32 channels x 128 pixels of one
// image: each warp reads four channel rows 128 floats at a time
// (coalesced), the codes go through shared memory (rows of 36 bytes: the
// byte stores of a warp hit 32 banks), and each thread writes 16
// channels of one pixel, as one 16-byte store where C is a multiple of
// 16.  Ragged pixel and channel edges are masked.
constexpr int kTileC = 32, kTileP = 128, kTileLd = kTileC + 4;

__global__ void __launch_bounds__(kThreads)
quantize_nhwc_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     int c, int64_t hw, const float* lo_p, const float* hi_p,
                     float lo, float hi) {
  __shared__ __align__(16) int8_t tile[kTileP * kTileLd];
  const float scale = range_scale(lo_p, hi_p, lo, hi, 127.f);
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kTileP;
  const int c0 = blockIdx.y * kTileC;
  const int64_t img = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cl = warp * 4 + j;
    const float* row = x + (img * c + c0 + cl) * hw + p0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pl = lane + 32 * i;
      int8_t v = 0;
      if (c0 + cl < c && p0 + pl < hw) v = code(__ldg(row + pl), scale);
      tile[pl * kTileLd + cl] = v;
    }
  }
  __syncthreads();
  const int pl = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int64_t p = p0 + pl;
  const int cb = c0 + half * 16;
  if (p >= hw || cb >= c) return;
  const int8_t* src = tile + pl * kTileLd + half * 16;
  int8_t* dst = q + (img * hw + p) * c + cb;
  if (c % 16 == 0) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(src);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int k = 0; k < 16 && cb + k < c; ++k) dst[k] = src[k];
  }
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// the block's (min, max) into out[0], out[1]; blockDim.x a multiple of 32
__device__ void block_minmax(float lo, float hi, float* out) {
  __shared__ float slo[32], shi[32];
  warp_minmax(lo, hi);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    lo = lane < nw ? slo[lane] : INFINITY;
    hi = lane < nw ? shi[lane] : -INFINITY;
    warp_minmax(lo, hi);
    if (lane == 0) {
      out[0] = lo;
      out[1] = hi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
minmax_partial(const float* __restrict__ x, int64_t n, bool vec,
               float* __restrict__ parts) {
  float lo = INFINITY, hi = -INFINITY;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(x) + i);
    lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
    hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
  }
  for (int64_t i = n4 * 4 + first; i < n; i += stride) {
    const float v = __ldg(x + i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  block_minmax(lo, hi, parts + 2 * blockIdx.x);
}

__global__ void __launch_bounds__(kMaxParts)
minmax_final(const float* __restrict__ parts, int nparts,
             float* __restrict__ range) {
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) {
    lo = fminf(lo, parts[2 * i]);
    hi = fmaxf(hi, parts[2 * i + 1]);
  }
  block_minmax(lo, hi, range);
}

template <typename T>
__device__ __forceinline__ float widen(T v) {
  return static_cast<float>(v);   // int32 -> float32 rounds to nearest even
}

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const T* __restrict__ q, float* __restrict__ out, int64_t n,
                  bool vec, const float* lo_p, const float* hi_p, float lo,
                  float hi, float qrange) {
  const float scale = range_scale(lo_p, hi_p, lo, hi, qrange);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const int64_t n4 = vec ? n / 4 : 0;
  for (int64_t i = first; i < n4; i += stride) {
    const V v = reinterpret_cast<const V*>(q)[i];
    reinterpret_cast<float4*>(out)[i] = make_float4(
        __fmul_rn(widen(v.x), scale), __fmul_rn(widen(v.y), scale),
        __fmul_rn(widen(v.z), scale), __fmul_rn(widen(v.w), scale));
  }
  for (int64_t i = n4 * 4 + first; i < n; i += stride)
    out[i] = __fmul_rn(widen(q[i]), scale);
}

int blocks_for(int64_t n, int64_t cap) {
  const int64_t groups = (n + 3) / 4;
  const int64_t b = (groups + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace

// q = codes of x (n float32 values); the range is (*lo_p, *hi_p) where
// a pointer is given, else (lo, hi).  vec = 1 where x starts on 16 bytes
// and q on 4.
extern "C" int mx_quantize_int8(int device, const void* x, void* q, int64_t n,
                                int vec, const void* lo_p, const void* hi_p,
                                float lo, float hi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  quantize_kernel<<<blocks_for(n, 8192), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), n, vec != 0,
      static_cast<const float*>(lo_p), static_cast<const float*>(hi_p), lo,
      hi);
  return cudaGetLastError();
}

// q = codes of x (n, c, hw) float32, written as (n, hw, c): the
// channels-last layout the int8 convolution reads.  The range as above.
extern "C" int mx_quantize_int8_nhwc(int device, const void* x, void* q,
                                     int n, int c, int64_t hw,
                                     const void* lo_p, const void* hi_p,
                                     float lo, float hi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0 || c == 0 || hw == 0) return cudaSuccess;
  const int64_t bx = (hw + kTileP - 1) / kTileP;
  const int64_t by = (c + kTileC - 1) / kTileC;
  if (bx > 0x7fffffff || by > 65535 || n > 65535)
    return cudaErrorInvalidConfiguration;
  quantize_nhwc_kernel<<<dim3(static_cast<unsigned>(bx),
                              static_cast<unsigned>(by), n),
                         kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q), c, hw,
      static_cast<const float*>(lo_p), static_cast<const float*>(hi_p), lo,
      hi);
  return cudaGetLastError();
}

// range[0], range[1] = min and max of n > 0 float32 values, through
// `parts` (room for 2 * 1024 floats): one pass over x, then one block
// over the blocks' partial results.
extern "C" int mx_minmax(int device, const void* x, int64_t n, int vec,
                         void* parts, void* range, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nb = blocks_for(n, kMaxParts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  minmax_partial<<<nb, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                         vec != 0, static_cast<float*>(parts));
  minmax_final<<<1, kMaxParts, 0, s>>>(static_cast<const float*>(parts), nb,
                                       static_cast<float*>(range));
  return cudaGetLastError();
}

// out = float32 values of n codes: int8 (bits 8, qrange 127) or int32
// (bits 32, qrange 2^31).  vec = 1 where q starts on 16 bytes (4 for
// int8) and out on 16.
extern "C" int mx_dequantize(int device, const void* q, int bits, void* out,
                             int64_t n, int vec, const void* lo_p,
                             const void* hi_p, float lo, float hi,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(lo_p);
  const float* hp = static_cast<const float*>(hi_p);
  if (bits == 8) {
    dequantize_kernel<int8_t, char4><<<blocks_for(n, 8192), kThreads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<float*>(out), n, vec != 0,
        lp, hp, lo, hi, 127.f);
  } else if (bits == 32) {
    dequantize_kernel<int32_t, int4><<<blocks_for(n, 8192), kThreads, 0, s>>>(
        static_cast<const int32_t*>(q), static_cast<float*>(out), n, vec != 0,
        lp, hp, lo, hi, 2147483648.f);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
