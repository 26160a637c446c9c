// RMSNorm over the last axis, forward and backward, written for Hopper
// (sm_90a).
//
// Forward.  Replaces the Pallas TPU kernel `_rms_fwd_kernel`, launched
// by `_rms_fwd` (incubator_mxnet_tpu/ops/pallas_kernels.py).  Per row of
// width D, in float32:
//
//   rrms = 1 / sqrt(sum(x^2) / D + eps)
//   y    = x * rrms * gamma              (written in x's type)
//
// and rrms is written in float32, one per row.  gamma arrives in x's
// type: the wrapper casts it first, as the TPU wrapper does.
//
// Backward.  Replaces `_rms_bwd_kernel`, launched by `_rms_vjp_bwd`.  Per
// row, with gg = g * gamma (float32; g and gamma arrive in x's type):
//
//   s  = sum(gg * x)
//   dx = rrms * (gg - x * rrms^2 * s / D)         (written in x's type)
//
// and, as on the TPU, each block writes one float32 partial row of
// dgamma = sum(g * x * rrms) over its rows, giving (blocks, D) partials
// that the wrapper sums in a fixed order.  No atomics, so the result is
// the same from run to run.
//
// Bound: memory traffic.  The forward reads x once and writes y once
// (about four operations an element), the backward reads x and g once and
// writes dx once (about eight), far below the card's ratio of operations
// to bytes.  So every value of a row is read from device memory once.
//
// Layout: a row of at most 1024 values gets one warp and stays in its
// registers, at most 32 values a lane, and is reduced with warp shuffles
// alone.  In the forward a block of 256 threads takes eight rows.  In the
// backward a block of eight warps takes a run of rows, its warps taking
// every eighth row; each lane keeps the dgamma sums of its own columns in
// registers over the run, and at the end the eight warps' sums meet in
// shared memory and are added in warp order into the block's partial
// row.  A wider row gets a whole block of 512 threads, reduced through
// shared memory; it reads its row a second time (from L2) for the
// output, and in the backward each thread keeps the dgamma sums of its
// columns in the block's partial row in device memory, which no other
// thread touches.  Threads stride over the row, so neighbouring threads
// touch neighbouring addresses; the last stride is masked by its index.

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int kSmallRow = 1024;       // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kWarps = kWarpRowsBlock / 32;
constexpr int kWideBlock = 512;       // block size for a wider row

template <typename T, int N>
__global__ void __launch_bounds__(kWarpRowsBlock)
rms_fwd_warp(const T* __restrict__ x, const T* __restrict__ gamma,
             T* __restrict__ y, float* __restrict__ rrms, int64_t rows,
             int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only; no block barrier here
  const T* xr = x + row * cols;
  float v[N];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < cols ? to_float(xr[i]) : 0.f;
    ss += v[k] * v[k];
  }
  ss = mx::warp_sum(ss);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(cols) + eps);
  T* yr = y + row * cols;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    if (i < cols) yr[i] = from_float<T>(v[k] * r * to_float(gamma[i]));
  }
  if (lane == 0) rrms[row] = r;
}

template <typename T>
__global__ void __launch_bounds__(kWideBlock)
rms_fwd_wide(const T* __restrict__ x, const T* __restrict__ gamma,
             T* __restrict__ y, float* __restrict__ rrms, int cols,
             float eps) {
  __shared__ float red[32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  float ss = 0.f;
  for (int i = threadIdx.x; i < cols; i += kWideBlock) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  ss = mx::row_sum(ss, red, true);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(cols) + eps);
  T* yr = y + row * cols;
  for (int i = threadIdx.x; i < cols; i += kWideBlock)
    yr[i] = from_float<T>(to_float(xr[i]) * r * to_float(gamma[i]));
  if (threadIdx.x == 0) rrms[row] = r;
}

// A block of kWarps warps takes rows [blockIdx.x * rows_per_block, ...);
// warp w takes every kWarps-th of them from the w-th.  Shared memory:
// kWarps * cols floats for the warps' dgamma sums.
template <typename T, int N>
__global__ void __launch_bounds__(kWarpRowsBlock)
rms_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
             const T* __restrict__ gamma, const float* __restrict__ rrms,
             T* __restrict__ dx, float* __restrict__ dgamma_part,
             int64_t rows, int cols, int rows_per_block) {
  extern __shared__ float sums[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float n = static_cast<float>(cols);
  float gam[N], acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    gam[k] = i < cols ? to_float(gamma[i]) : 0.f;
    acc[k] = 0.f;
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t last =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  for (int64_t row = first + warp; row < last; row += kWarps) {
    const T* xr = x + row * cols;
    const T* gr = g + row * cols;
    const float r = rrms[row];
    float xv[N], gv[N];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = lane + 32 * k;
      xv[k] = i < cols ? to_float(xr[i]) : 0.f;
      gv[k] = i < cols ? to_float(gr[i]) : 0.f;
      s += gv[k] * gam[k] * xv[k];
    }
    s = mx::warp_sum(s);
    T* dxr = dx + row * cols;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = lane + 32 * k;
      const float gg = gv[k] * gam[k];
      if (i < cols)
        dxr[i] = from_float<T>(r * (gg - xv[k] * (r * r) * s / n));
      acc[k] += gv[k] * xv[k] * r;
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = lane + 32 * k;
    if (i < cols) sums[warp * cols + i] = acc[k];
  }
  __syncthreads();
  float* part = dgamma_part + static_cast<int64_t>(blockIdx.x) * cols;
  for (int i = threadIdx.x; i < cols; i += kWarpRowsBlock) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sums[w * cols + i];
    part[i] = t;
  }
}

// A block of kWideBlock threads takes a run of rows; thread t owns
// columns t, t + kWideBlock, ... of every row and of the partial row.
template <typename T>
__global__ void __launch_bounds__(kWideBlock)
rms_bwd_wide(const T* __restrict__ x, const T* __restrict__ g,
             const T* __restrict__ gamma, const float* __restrict__ rrms,
             T* __restrict__ dx, float* __restrict__ dgamma_part,
             int64_t rows, int cols, int rows_per_block) {
  __shared__ float red[32];
  const float n = static_cast<float>(cols);
  float* part = dgamma_part + static_cast<int64_t>(blockIdx.x) * cols;
  for (int i = threadIdx.x; i < cols; i += kWideBlock) part[i] = 0.f;
  // Every row of the run exists and the bounds are the same for the
  // whole block, so all threads meet every barrier in row_sum.
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t last =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  for (int64_t row = first; row < last; ++row) {
    const T* xr = x + row * cols;
    const T* gr = g + row * cols;
    const float r = rrms[row];
    float s = 0.f;
    for (int i = threadIdx.x; i < cols; i += kWideBlock)
      s += to_float(gr[i]) * to_float(gamma[i]) * to_float(xr[i]);
    s = mx::row_sum(s, red, true);
    T* dxr = dx + row * cols;
    for (int i = threadIdx.x; i < cols; i += kWideBlock) {
      const float xv = to_float(xr[i]);
      const float gv = to_float(gr[i]);
      const float gg = gv * to_float(gamma[i]);
      dxr[i] = from_float<T>(r * (gg - xv * (r * r) * s / n));
      part[i] += gv * xv * r;
    }
  }
}

template <typename T, int N>
cudaError_t fwd_warp(const T* x, const T* gamma, T* y, float* rrms,
                     int64_t rows, int cols, float eps, cudaStream_t stream) {
  const int64_t grid = (rows + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  rms_fwd_warp<T, N><<<static_cast<unsigned>(grid), kWarpRowsBlock, 0,
                       stream>>>(x, gamma, y, rrms, rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* gamma, void* y,
                       void* rrms, int64_t rows, int cols, float eps,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* yp = static_cast<T*>(y);
  float* rp = static_cast<float*>(rrms);
  if (cols > kSmallRow) {
    if (rows > 0x7fffffff) return cudaErrorInvalidValue;
    rms_fwd_wide<T><<<static_cast<unsigned>(rows), kWideBlock, 0, stream>>>(
        xp, gp, yp, rp, cols, eps);
    return cudaGetLastError();
  }
  switch (mx::lane_values(cols)) {
    case 1: return fwd_warp<T, 1>(xp, gp, yp, rp, rows, cols, eps, stream);
    case 2: return fwd_warp<T, 2>(xp, gp, yp, rp, rows, cols, eps, stream);
    case 4: return fwd_warp<T, 4>(xp, gp, yp, rp, rows, cols, eps, stream);
    case 8: return fwd_warp<T, 8>(xp, gp, yp, rp, rows, cols, eps, stream);
    case 16: return fwd_warp<T, 16>(xp, gp, yp, rp, rows, cols, eps, stream);
    default: return fwd_warp<T, 32>(xp, gp, yp, rp, rows, cols, eps, stream);
  }
}

template <typename T, int N>
cudaError_t bwd_warp(const T* x, const T* g, const T* gamma,
                     const float* rrms, T* dx, float* part, int64_t rows,
                     int cols, int rows_per_block, unsigned grid,
                     cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * cols * sizeof(float);
  rms_bwd_warp<T, N><<<grid, kWarpRowsBlock, smem, stream>>>(
      x, g, gamma, rrms, dx, part, rows, cols, rows_per_block);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const void* gamma,
                       const void* rrms, void* dx, void* dgamma_part,
                       int64_t rows, int cols, int rows_per_block,
                       cudaStream_t stream) {
  if (rows_per_block <= 0) return cudaErrorInvalidValue;
  const int64_t blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const T* gam = static_cast<const T*>(gamma);
  const float* rp = static_cast<const float*>(rrms);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(dgamma_part);
  if (cols > kSmallRow) {
    rms_bwd_wide<T><<<grid, kWideBlock, 0, stream>>>(
        xp, gp, gam, rp, dxp, pp, rows, cols, rows_per_block);
    return cudaGetLastError();
  }
  const int rpb = rows_per_block;
  switch (mx::lane_values(cols)) {
    case 1:
      return bwd_warp<T, 1>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                            stream);
    case 2:
      return bwd_warp<T, 2>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                            stream);
    case 4:
      return bwd_warp<T, 4>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                            stream);
    case 8:
      return bwd_warp<T, 8>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                            stream);
    case 16:
      return bwd_warp<T, 16>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                             stream);
    default:
      return bwd_warp<T, 32>(xp, gp, gam, rp, dxp, pp, rows, cols, rpb, grid,
                             stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (rows, cols), row-major
// and contiguous; gamma is (cols,) in x's type; rrms is (rows,) float32.
// Launches on `stream` without synchronising and returns the
// cudaError_t of the launch.
extern "C" int mx_rms_norm_fwd(int dtype, int device, const void* x,
                               const void* gamma, void* y, void* rrms,
                               long long rows, int cols, float eps,
                               void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_fwd<float>(x, gamma, y, rrms, rows, cols, eps, s));
    case 1:
      return static_cast<int>(
          launch_fwd<__nv_bfloat16>(x, gamma, y, rrms, rows, cols, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  x, g and dx are (rows, cols) in x's type, contiguous;
// gamma is (cols,) in x's type; rrms is (rows,) float32 from the forward;
// dgamma_part is (ceil(rows / rows_per_block), cols) float32, one row per
// block, every element written.  Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int mx_rms_norm_bwd(int dtype, int device, const void* x,
                               const void* g, const void* gamma,
                               const void* rrms, void* dx, void* dgamma_part,
                               long long rows, int cols, int rows_per_block,
                               void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(
          x, g, gamma, rrms, dx, dgamma_part, rows, cols, rows_per_block, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          x, g, gamma, rrms, dx, dgamma_part, rows, cols, rows_per_block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
