// LayerNorm over the last axis, forward and backward, written for
// Hopper (sm_90a).
//
// Forward.  Replaces the Pallas TPU kernel `_ln_fwd_kernel`, launched by
// `_ln_fwd` (incubator_mxnet_tpu/ops/pallas_kernels.py).  Per row of
// width D:
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
//
// Backward.  Replaces `_ln_bwd_kernel`, launched by `_fused_ln_bwd`
// (pallas_kernels.py).  Per row, with xhat = (x - mean) * rstd and
// gg = g * gamma (float32):
//
//   m1 = sum(gg) / D,  m2 = sum(gg * xhat) / D
//   dx = (gg - m1 - xhat * m2) * rstd          (written in x's type)
//
// and, as on the TPU, each block writes one float32 partial row of
// dgamma = sum(g * xhat) and dbeta = sum(g) over its rows, giving
// (blocks, D) partials that the wrapper sums (the TPU wrapper sums its
// per-row-block partials the same way, outside the kernel).  No atomics,
// so the result is the same from run to run.
//
// Bound: memory traffic again (x, g read once, dx written once; about
// ten float operations an element).  A block takes a run of rows; its
// threads stride over the columns, so each thread owns the same columns
// in every row and keeps their dgamma/dbeta sums without sharing them.
// The first pass stages xhat and g in shared memory beside those sums;
// a row too wide for that (more than about 14k values) re-reads x and g
// and keeps the sums in the partial row in device memory instead.

#include "common.cuh"

namespace {

using mx::from_float;
using mx::row_sum;
using mx::to_float;

constexpr int kSmallRow = 512;        // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode

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

// One block per run of `rows_per_block` rows; see the note at the top.
// Shared memory: 64 floats for the two row sums, then (kCache) the
// dgamma and dbeta sums and the staged xhat and g, D floats each.
template <typename T, bool kCache>
__global__ void __launch_bounds__(1024)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd, T* __restrict__ dx,
                      float* __restrict__ dgamma_part,
                      float* __restrict__ dbeta_part, int64_t rows, int cols,
                      int rows_per_block) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const bool whole_block = nt > 32;
  float* part_g = dgamma_part + static_cast<int64_t>(blockIdx.x) * cols;
  float* part_b = dbeta_part + static_cast<int64_t>(blockIdx.x) * cols;
  float* acc_g = kCache ? smem + 64 : part_g;
  float* acc_b = kCache ? smem + 64 + cols : part_b;
  float* xhat_c = smem + 64 + 2 * cols;
  float* g_c = smem + 64 + 3 * cols;
  for (int i = t; i < cols; i += nt) {
    acc_g[i] = 0.f;
    acc_b[i] = 0.f;
  }
  // Every row of the run exists (the wrapper sizes the grid so), and the
  // bounds are the same for the whole block, so all threads meet every
  // barrier.  Column i belongs to thread i % nt in every loop below, so
  // the staged values and the sums need no barrier of their own.
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t last =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  for (int64_t row = first; row < last; ++row) {
    const T* xr = x + row * cols;
    const T* gr = g + row * cols;
    T* dxr = dx + row * cols;
    const float mu = mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int i = t; i < cols; i += nt) {
      const float xh = (to_float(xr[i]) - mu) * rs;
      const float gv = to_float(gr[i]);
      const float gg = gv * gamma[i];
      if (kCache) {
        xhat_c[i] = xh;
        g_c[i] = gv;
      }
      s1 += gg;
      s2 += gg * xh;
    }
    const float m1 = row_sum(s1, smem, whole_block) / cols;
    const float m2 = row_sum(s2, smem + 32, whole_block) / cols;
    for (int i = t; i < cols; i += nt) {
      const float xh = kCache ? xhat_c[i] : (to_float(xr[i]) - mu) * rs;
      const float gv = kCache ? g_c[i] : to_float(gr[i]);
      const float gg = gv * gamma[i];
      dxr[i] = from_float<T>((gg - m1 - xh * m2) * rs);
      acc_g[i] += gv * xh;
      acc_b[i] += gv;
    }
  }
  if (kCache) {
    for (int i = t; i < cols; i += nt) {
      part_g[i] = acc_g[i];
      part_b[i] = acc_b[i];
    }
  }
}

cudaError_t smem_optin(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

template <typename T>
cudaError_t launch_fwd(int device, const void* x, const void* gamma,
                       const void* beta, void* y, void* mean, void* rstd,
                       int64_t rows, int cols, float eps,
                       cudaStream_t stream) {
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

  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;

  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* bp = static_cast<const T*>(beta);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  const size_t cached =
      (32 + static_cast<size_t>(rows_per_block) * cols) * sizeof(float);
  if (cached <= static_cast<size_t>(optin)) {
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

template <typename T>
cudaError_t launch_bwd(int device, const void* x, const void* g,
                       const void* gamma, const void* mean, const void* rstd,
                       void* dx, void* dgamma_part, void* dbeta_part,
                       int64_t rows, int cols, int rows_per_block,
                       cudaStream_t stream) {
  if (rows_per_block <= 0) return cudaErrorInvalidValue;
  const int64_t grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  // about two values of a row a thread, whole warps, at most 1024
  const int want = ((cols + 1) / 2 + 31) / 32 * 32;
  const int block = want < 1024 ? want : 1024;

  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;

  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const float* gam = static_cast<const float*>(gamma);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* pg = static_cast<float*>(dgamma_part);
  float* pb = static_cast<float*>(dbeta_part);
  const size_t cached = (64 + 4 * static_cast<size_t>(cols)) * sizeof(float);
  if (cached <= static_cast<size_t>(optin)) {
    if (cached > 48 * 1024) {
      err = cudaFuncSetAttribute(layer_norm_bwd_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(cached));
      if (err != cudaSuccess) return err;
    }
    layer_norm_bwd_kernel<T, true>
        <<<static_cast<unsigned>(grid), block, cached, stream>>>(
            xp, gp, gam, mp, rp, dxp, pg, pb, rows, cols, rows_per_block);
  } else {
    layer_norm_bwd_kernel<T, false>
        <<<static_cast<unsigned>(grid), block, 64 * sizeof(float), stream>>>(
            xp, gp, gam, mp, rp, dxp, pg, pb, rows, cols, rows_per_block);
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
      return static_cast<int>(launch_fwd<float>(device, x, gamma, beta, y,
                                                mean, rstd, rows, cols, eps,
                                                s));
    case 1:
      return static_cast<int>(launch_fwd<__nv_bfloat16>(
          device, x, gamma, beta, y, mean, rstd, rows, cols, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dtype as above.  x, g and dx are (rows, cols) in x's type, contiguous;
// gamma is (cols,) float32; mean and rstd are (rows,) float32 from the
// forward; dgamma_part and dbeta_part are (ceil(rows / rows_per_block),
// cols) float32, one row per block, every element written.  Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int mx_layer_norm_bwd(int dtype, int device, const void* x,
                                 const void* g, const void* gamma,
                                 const void* mean, const void* rstd,
                                 void* dx, void* dgamma_part,
                                 void* dbeta_part, long long rows, int cols,
                                 int rows_per_block, void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(
          device, x, g, gamma, mean, rstd, dx, dgamma_part, dbeta_part, rows,
          cols, rows_per_block, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          device, x, g, gamma, mean, rstd, dx, dgamma_part, dbeta_part, rows,
          cols, rows_per_block, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
