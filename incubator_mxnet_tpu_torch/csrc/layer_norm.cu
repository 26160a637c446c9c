// LayerNorm forward over the last axis, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ln_fwd_kernel`, launched by `_ln_fwd`
// (incubator_mxnet_tpu/ops/pallas_kernels.py).  Per row of width D:
//
//   mean = sum(x) / D                       (float32)
//   var  = sum((x - mean)^2) / D            (float32, second pass)
//   rstd = 1 / sqrt(var + eps)
//   y    = (x - mean) * rstd * gamma + beta (written in x's type)
//
// and mean and rstd are written in float32, one per row.  gamma and
// beta arrive in x's type: the wrapper casts them first, as the TPU
// wrapper does.
//
// Bound: memory traffic.  Each element costs about seven float
// operations against rows*D*(bytes in + bytes out) moved, plus gamma
// and beta once (they stay in L2), far below the card's ratio of
// operations to bytes.  So the design moves each byte once: every
// element of x is read from device memory once and every element of y
// written once.  The first pass stages the row as float32 in shared
// memory; the variance and output passes read it from there.  A row too
// wide for shared memory (more than about 57k values) re-reads x
// instead, which L2 then serves.
//
// Layout: a row of at most 512 values gets one warp (eight rows to a
// block of 256 threads), reduced with warp shuffles alone.  A wider row
// gets a whole block of up to 1024 threads, reduced with warp shuffles
// and then across warps through shared memory.  Threads stride over the
// row, so neighbouring threads touch neighbouring addresses; the last
// stride is masked by the loop bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSmallRow = 512;        // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode

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
// warps' partials meet in `red`, and every warp then sums all of them,
// so every thread gets the total.  The first barrier keeps a previous
// call's readers of `red` ahead of this call's writers.
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

template <typename T, bool kCache>
__global__ void __launch_bounds__(1024)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int64_t rows, int cols,
                      float eps, int threads_per_row) {
  extern __shared__ float smem[];
  float* red = smem;  // 32 partial sums, one per warp
  const bool whole_block = threads_per_row > 32;
  const int slot = threadIdx.x / threads_per_row;  // row within the block
  const int t = threadIdx.x % threads_per_row;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / threads_per_row) +
      slot;
  // Only whole warps leave here (one warp per row), and that mode has no
  // block barrier; with a block per row every row exists.
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  float* cache = smem + 32 + static_cast<int64_t>(slot) * cols;

  float s = 0.f;
  for (int i = t; i < cols; i += threads_per_row) {
    const float v = to_float(xr[i]);
    if (kCache) cache[i] = v;
    s += v;
  }
  const float mean = row_sum(s, red, whole_block) / cols;

  float ss = 0.f;
  for (int i = t; i < cols; i += threads_per_row) {
    const float d = (kCache ? cache[i] : to_float(xr[i])) - mean;
    ss += d * d;
  }
  const float var = row_sum(ss, red, whole_block) / cols;
  const float rstd = 1.0f / sqrtf(var + eps);

  for (int i = t; i < cols; i += threads_per_row) {
    const float d = (kCache ? cache[i] : to_float(xr[i])) - mean;
    yr[i] = from_float<T>(d * rstd * to_float(gamma[i]) + to_float(beta[i]));
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <typename T>
cudaError_t launch(int device, const void* x, const void* gamma,
                   const void* beta, void* y, void* mean, void* rstd,
                   int64_t rows, int cols, float eps, cudaStream_t stream) {
  int threads_per_row, block;
  if (cols <= kSmallRow) {
    threads_per_row = 32;
    block = kWarpRowsBlock;
  } else {
    const int want = ((cols + 3) / 4 + 31) / 32 * 32;  // ~4 values a thread
    threads_per_row = want < 1024 ? want : 1024;
    block = threads_per_row;
  }
  const int rows_per_block = block / threads_per_row;
  const int64_t grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int smem_optin = 0;
  err = cudaDeviceGetAttribute(&smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;

  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  const size_t cached =
      (32 + static_cast<size_t>(rows_per_block) * cols) * sizeof(float);
  if (cached <= static_cast<size_t>(smem_optin)) {
    if (cached > 48 * 1024) {
      err = cudaFuncSetAttribute(layer_norm_fwd_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(cached));
      if (err != cudaSuccess) return err;
    }
    layer_norm_fwd_kernel<T, true>
        <<<static_cast<unsigned>(grid), block, cached, stream>>>(
            xp, gp, bp, yp, mp, rp, rows, cols, eps, threads_per_row);
  } else {
    layer_norm_fwd_kernel<T, false>
        <<<static_cast<unsigned>(grid), block, 32 * sizeof(float), stream>>>(
            xp, gp, bp, yp, mp, rp, rows, cols, eps, threads_per_row);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x and y are (rows, cols), row-major
// and contiguous; gamma and beta are (cols,) in x's type; mean and rstd
// are (rows,) float32.  Launches on `stream` without synchronising and
// returns the cudaError_t of the launch.
extern "C" int mx_layer_norm_fwd(int dtype, int device, const void* x,
                                 const void* gamma, const void* beta,
                                 void* y, void* mean, void* rstd,
                                 long long rows, int cols, float eps,
                                 void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(device, x, gamma, beta, y, mean,
                                            rstd, rows, cols, eps, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          device, x, gamma, beta, y, mean, rstd, rows, cols, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mx_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
