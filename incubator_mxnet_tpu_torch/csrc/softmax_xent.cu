// Softmax cross-entropy over the last axis, forward and backward,
// written for Hopper (sm_90a).
//
// Forward.  Replaces the Pallas TPU kernel `_xent_fwd_kernel`, launched
// by `_xent_call` from `_xent_fwd` (incubator_mxnet_tpu/ops/
// pallas_kernels.py).  Per row of C logits x and a label l:
//
//   lse  = log(sum(exp(x))), computed stably     (float32)
//   loss = lse - x[clip(l, 0, C - 1)]            (float32)
//
// and lse is written too, one float32 per row, for the backward.
//
// Backward.  Replaces `_xent_bwd_kernel` (same launcher, from
// `_xent_vjp_bwd`).  Per row, with the incoming float32 gradient gr of
// the row's loss:
//
//   dx[i] = (exp(x[i] - lse) - (i == clip(l) ? 1 : 0)) * gr   (x's type)
//
// The TPU kernel recomputes the row's max and sum; reusing the
// forward's lse saves that pass and gives the same function.
//
// Bound: memory traffic.  The forward reads each logit once and does
// one exp a logit (about 10 operations); the backward reads each once
// and writes dx once.  Both stream the row once: the forward keeps a
// running (max, sum) pair per thread, rescaling the sum when the max
// grows, so no second pass and no staging is needed, and a row of any
// width fits (the TPU kernel is limited to 16384 columns by its on-chip
// memory; the JAX package computes wider rows by composition, which is
// the same function).  The label's logit is read once, by thread 0.
//
// Layout: a row of at most 1024 values gets one warp (eight rows to a
// block of 256 threads); a wider row gets a block of 512 threads.
// Threads stride over the row, so neighbouring threads touch
// neighbouring addresses; the forward issues four loads before it uses
// any, to keep more bytes in flight.

#include <math.h>

#include "common.cuh"

namespace {

using mx::from_float;
using mx::ms_add;
using mx::row_ms;
using mx::to_float;

constexpr int kSmallRow = 1024;       // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kWideBlock = 512;       // block size for a wider row

__device__ __forceinline__ int clip_label(int l, int cols) {
  return l < 0 ? 0 : (l >= cols ? cols - 1 : l);
}

template <typename T>
__global__ void __launch_bounds__(kWideBlock)
softmax_xent_fwd_kernel(const T* __restrict__ x,
                        const int* __restrict__ labels,
                        float* __restrict__ loss, float* __restrict__ lse,
                        int64_t rows, int cols, int threads_per_row) {
  __shared__ float red[64];
  const bool whole_block = threads_per_row > 32;
  const int slot = threadIdx.x / threads_per_row;
  const int t = threadIdx.x % threads_per_row;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / threads_per_row) +
      slot;
  // Only whole warps leave here (one warp per row, no block barrier);
  // with a block per row every row exists.
  if (row >= rows) return;
  const T* xr = x + row * cols;
  const int tpr = threads_per_row;

  float m = -INFINITY, s = 0.f;
  int i = t;
  for (; i + 3 * tpr < cols; i += 4 * tpr) {
    const float v0 = to_float(xr[i]);
    const float v1 = to_float(xr[i + tpr]);
    const float v2 = to_float(xr[i + 2 * tpr]);
    const float v3 = to_float(xr[i + 3 * tpr]);
    ms_add(m, s, v0);
    ms_add(m, s, v1);
    ms_add(m, s, v2);
    ms_add(m, s, v3);
  }
  for (; i < cols; i += tpr) ms_add(m, s, to_float(xr[i]));
  row_ms(m, s, red, whole_block);
  if (t == 0) {
    const float l = m + logf(s);
    lse[row] = l;
    loss[row] = l - to_float(xr[clip_label(labels[row], cols)]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideBlock)
softmax_xent_bwd_kernel(const T* __restrict__ x,
                        const int* __restrict__ labels,
                        const float* __restrict__ lse,
                        const float* __restrict__ g, T* __restrict__ dx,
                        int64_t rows, int cols, int threads_per_row) {
  const int slot = threadIdx.x / threads_per_row;
  const int t = threadIdx.x % threads_per_row;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / threads_per_row) +
      slot;
  if (row >= rows) return;
  const T* xr = x + row * cols;
  T* dxr = dx + row * cols;
  const float l = lse[row];
  const float gr = g[row];
  const int label = clip_label(labels[row], cols);
#pragma unroll 4
  for (int i = t; i < cols; i += threads_per_row) {
    const float p = expf(to_float(xr[i]) - l);
    dxr[i] = from_float<T>((p - (i == label ? 1.f : 0.f)) * gr);
  }
}

struct Geometry {
  int threads_per_row, block;
  unsigned grid;
};

cudaError_t geometry(int64_t rows, int cols, Geometry* out) {
  if (cols <= kSmallRow) {
    out->threads_per_row = 32;
    out->block = kWarpRowsBlock;
  } else {
    out->threads_per_row = kWideBlock;
    out->block = kWideBlock;
  }
  const int rows_per_block = out->block / out->threads_per_row;
  const int64_t grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  out->grid = static_cast<unsigned>(grid);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int* labels, float* loss,
                       float* lse, int64_t rows, int cols,
                       cudaStream_t stream) {
  Geometry geo;
  cudaError_t err = geometry(rows, cols, &geo);
  if (err != cudaSuccess) return err;
  softmax_xent_fwd_kernel<T><<<geo.grid, geo.block, 0, stream>>>(
      static_cast<const T*>(x), labels, loss, lse, rows, cols,
      geo.threads_per_row);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int* labels, const float* lse,
                       const float* g, void* dx, int64_t rows, int cols,
                       cudaStream_t stream) {
  Geometry geo;
  cudaError_t err = geometry(rows, cols, &geo);
  if (err != cudaSuccess) return err;
  softmax_xent_bwd_kernel<T><<<geo.grid, geo.block, 0, stream>>>(
      static_cast<const T*>(x), labels, lse, g, static_cast<T*>(dx), rows,
      cols, geo.threads_per_row);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x is (rows, cols), row-major and
// contiguous; labels (rows,) int32; loss and lse (rows,) float32.
// Launches on `stream` without synchronising and returns the
// cudaError_t of the launch.
extern "C" int mx_softmax_xent_fwd(int dtype, int device, const void* x,
                                   const void* labels, void* loss, void* lse,
                                   long long rows, int cols, void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_fwd<float>(x, lp, lo, ls, rows, cols, s));
    case 1:
      return static_cast<int>(
          launch_fwd<__nv_bfloat16>(x, lp, lo, ls, rows, cols, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  x and dx are (rows, cols) in x's type, contiguous;
// labels (rows,) int32; lse (rows,) float32 from the forward; g (rows,)
// float32, the gradient of each row's loss.
extern "C" int mx_softmax_xent_bwd(int dtype, int device, const void* x,
                                   const void* labels, const void* lse,
                                   const void* g, void* dx, long long rows,
                                   int cols, void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lp = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch_bwd<float>(x, lp, ls, gp, dx, rows, cols, s));
    case 1:
      return static_cast<int>(
          launch_bwd<__nv_bfloat16>(x, lp, ls, gp, dx, rows, cols, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
