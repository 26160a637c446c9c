// Softmax over the last axis, forward and backward, written for Hopper
// (sm_90a).
//
// Forward.  Replaces the Pallas TPU kernel `_softmax_fwd_kernel`,
// launched by `_rowwise_call` from `_fused_softmax_impl`
// (incubator_mxnet_tpu/ops/pallas_kernels.py).  Per row of width C, in
// float32:
//
//   m = max(x),  e = exp(x - m),  s = sum(e),  y = e / s
//
// and y is written in x's type.
//
// Backward.  Replaces `_softmax_bwd_kernel` (same launcher, from
// `_fused_softmax_bwd`).  Per row, from the forward's output y as it
// was stored and the incoming gradient g (both in y's type):
//
//   dx = y * (g - sum(y * g))        (float32, written in y's type)
//
// Bound: memory traffic.  The forward reads x once and writes y once
// with about five operations an element; the backward reads y and g once
// and writes dx once.  So each design keeps a row's values on chip
// between its passes where it can.
//
// Layout: a row of at most 1024 values gets one warp (eight rows to a
// block of 256 threads) and stays in registers, at most 32 values a
// lane: the forward takes the max, then the exps and their sum, then y,
// from registers, so it reads x once, in the plain version's order of
// operations.  A wider row gets a block of 512 threads: the forward
// streams it once keeping a running (max, sum of exp) pair per thread
// (mx::ms_add), then reads it again to write y; the backward reads y and
// g once for the sum and again for dx.  The second read of a row of up
// to a few MB comes from L2.  The TPU kernel takes rows of at most 16384
// values (its on-chip memory); the JAX package computes wider rows with
// jax.nn.softmax, the same function, so every width goes through these
// kernels.  Threads stride over the row, so neighbouring threads touch
// neighbouring addresses, and every ragged edge is masked by its index.

#include <math.h>

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int kSmallRow = 1024;       // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kWideBlock = 512;       // block size for a wider row

// One warp per row; each lane holds the row's values lane, lane + 32,
// ..., N of them (32 * N >= cols).
template <typename T, int N>
__global__ void __launch_bounds__(kWarpRowsBlock)
softmax_fwd_warp(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                 int cols) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kWarpRowsBlock / 32) +
      (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only; no block barrier here
  const T* xr = x + row * cols;
  float v[N];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < cols ? to_float(xr[i]) : -INFINITY;
    m = fmaxf(m, v[k]);
  }
  m = mx::warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = expf(v[k] - m);  // a masked slot: exp(-inf) = 0
    s += v[k];
  }
  s = mx::warp_sum(s);
  T* yr = y + row * cols;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    if (i < cols) yr[i] = from_float<T>(v[k] / s);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kWarpRowsBlock)
softmax_bwd_warp(const T* __restrict__ y, const T* __restrict__ g,
                 T* __restrict__ dx, int64_t rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kWarpRowsBlock / 32) +
      (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* yr = y + row * cols;
  const T* gr = g + row * cols;
  float yv[N], gv[N];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    yv[k] = i < cols ? to_float(yr[i]) : 0.f;
    gv[k] = i < cols ? to_float(gr[i]) : 0.f;
    s += yv[k] * gv[k];
  }
  s = mx::warp_sum(s);
  T* dxr = dx + row * cols;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    if (i < cols) dxr[i] = from_float<T>(yv[k] * (gv[k] - s));
  }
}

// One block of kWideBlock threads per row.
template <typename T>
__global__ void __launch_bounds__(kWideBlock)
softmax_fwd_wide(const T* __restrict__ x, T* __restrict__ y, int cols) {
  __shared__ float red[64];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  float m = -INFINITY, s = 0.f;
  for (int i = threadIdx.x; i < cols; i += kWideBlock)
    mx::ms_add(m, s, to_float(xr[i]));
  mx::row_ms(m, s, red, true);
  T* yr = y + row * cols;
  for (int i = threadIdx.x; i < cols; i += kWideBlock)
    yr[i] = from_float<T>(expf(to_float(xr[i]) - m) / s);
}

template <typename T>
__global__ void __launch_bounds__(kWideBlock)
softmax_bwd_wide(const T* __restrict__ y, const T* __restrict__ g,
                 T* __restrict__ dx, int cols) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* yr = y + row * cols;
  const T* gr = g + row * cols;
  float s = 0.f;
  for (int i = threadIdx.x; i < cols; i += kWideBlock)
    s += to_float(yr[i]) * to_float(gr[i]);
  s = mx::row_sum(s, red, true);
  T* dxr = dx + row * cols;
  for (int i = threadIdx.x; i < cols; i += kWideBlock)
    dxr[i] = from_float<T>(to_float(yr[i]) * (to_float(gr[i]) - s));
}

template <typename T, int N>
cudaError_t fwd_warp(const void* x, void* y, int64_t rows, int cols,
                     cudaStream_t stream) {
  constexpr int kRows = kWarpRowsBlock / 32;
  const int64_t grid = (rows + kRows - 1) / kRows;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  softmax_fwd_warp<T, N>
      <<<static_cast<unsigned>(grid), kWarpRowsBlock, 0, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y), rows, cols);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t bwd_warp(const void* y, const void* g, void* dx, int64_t rows,
                     int cols, cudaStream_t stream) {
  constexpr int kRows = kWarpRowsBlock / 32;
  const int64_t grid = (rows + kRows - 1) / kRows;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  softmax_bwd_warp<T, N>
      <<<static_cast<unsigned>(grid), kWarpRowsBlock, 0, stream>>>(
          static_cast<const T*>(y), static_cast<const T*>(g),
          static_cast<T*>(dx), rows, cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, void* y, int64_t rows, int cols,
                       cudaStream_t stream) {
  if (cols > kSmallRow) {
    if (rows > 0x7fffffff) return cudaErrorInvalidValue;
    softmax_fwd_wide<T><<<static_cast<unsigned>(rows), kWideBlock, 0,
                          stream>>>(static_cast<const T*>(x),
                                    static_cast<T*>(y), cols);
    return cudaGetLastError();
  }
  switch (mx::lane_values(cols)) {
    case 1: return fwd_warp<T, 1>(x, y, rows, cols, stream);
    case 2: return fwd_warp<T, 2>(x, y, rows, cols, stream);
    case 4: return fwd_warp<T, 4>(x, y, rows, cols, stream);
    case 8: return fwd_warp<T, 8>(x, y, rows, cols, stream);
    case 16: return fwd_warp<T, 16>(x, y, rows, cols, stream);
    default: return fwd_warp<T, 32>(x, y, rows, cols, stream);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* y, const void* g, void* dx, int64_t rows,
                       int cols, cudaStream_t stream) {
  if (cols > kSmallRow) {
    if (rows > 0x7fffffff) return cudaErrorInvalidValue;
    softmax_bwd_wide<T><<<static_cast<unsigned>(rows), kWideBlock, 0,
                          stream>>>(static_cast<const T*>(y),
                                    static_cast<const T*>(g),
                                    static_cast<T*>(dx), cols);
    return cudaGetLastError();
  }
  switch (mx::lane_values(cols)) {
    case 1: return bwd_warp<T, 1>(y, g, dx, rows, cols, stream);
    case 2: return bwd_warp<T, 2>(y, g, dx, rows, cols, stream);
    case 4: return bwd_warp<T, 4>(y, g, dx, rows, cols, stream);
    case 8: return bwd_warp<T, 8>(y, g, dx, rows, cols, stream);
    case 16: return bwd_warp<T, 16>(y, g, dx, rows, cols, stream);
    default: return bwd_warp<T, 32>(y, g, dx, rows, cols, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (rows, cols), row-major
// and contiguous, in that type.  Launches on `stream` without
// synchronising and returns the cudaError_t of the launch.
extern "C" int mx_softmax_fwd(int dtype, int device, const void* x, void* y,
                              long long rows, int cols, void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_fwd<float>(x, y, rows, cols, s));
    case 1:
      return static_cast<int>(launch_fwd<__nv_bfloat16>(x, y, rows, cols, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  y (the forward's output), g and dx are (rows, cols) in
// that type, contiguous.
extern "C" int mx_softmax_bwd(int dtype, int device, const void* y,
                              const void* g, void* dx, long long rows,
                              int cols, void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(y, g, dx, rows, cols, s));
    case 1:
      return static_cast<int>(
          launch_bwd<__nv_bfloat16>(y, g, dx, rows, cols, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
