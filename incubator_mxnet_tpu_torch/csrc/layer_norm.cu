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
// and across rows dgamma = sum(g * xhat) and dbeta = sum(g), float32.
//
// Bound: memory traffic again (x, g read once, dx written once; about
// ten float operations an element).  What costs time besides the bytes
// is waiting: on barriers, on loads made one element at a time, on
// partial sums written and read back, on a second pass over the row.
//
// Layout: a row of at most 1024 values gets one warp and stays in its
// registers.  Lane l holds chunks l, l + 32, ... of the row, 16 bytes
// each (4 float32 or 8 bf16 values) where x, g and dx start on 16 bytes
// and D is a multiple of a chunk, else single values l, l + 32, ....
// The row's two sums are warp shuffles alone: no barrier.  A block of
// eight warps takes a run of rows, warp w every eighth from the w-th;
// each lane keeps the dgamma and dbeta sums of its own columns in
// registers across its rows, and at the end the eight warps' sums meet
// in shared memory and are added in warp order into the block's
// partial rows.  The wrapper gives about two blocks to each SM, so the
// partials are at most (2 * SMs, D) for each of dgamma and dbeta.
// A wider row gets a whole block that strides over the columns, so each
// thread owns the same columns in every row and keeps their sums
// without sharing them; it stages xhat and g in shared memory beside
// those sums, and a row too wide for that (more than about 14k values)
// re-reads x and g and keeps the sums in the partial row in device
// memory instead.
//
// The partial rows are summed by a second kernel of this file,
// layer_norm_bwd_sum, column by column in a fixed order.  No atomics,
// so the result is the same from run to run.

#include <atomic>

#include "common.cuh"

namespace {

using mx::from_float;
using mx::row_sum;
using mx::to_float;

constexpr int kSmallRow = 512;        // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kBwdWarpRow = 1024;     // widest row a backward warp takes
constexpr int kBwdWarps = 8;          // warps of a one-warp-a-row block
constexpr int kBwdBlock = 32 * kBwdWarps;
constexpr int kSumWarps = 32;         // warps of a block of the partials' sum
constexpr int kMaxDevices = 64;       // devices whose attributes are kept

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

// A wider row: one block per run of `rows_per_block` rows; see the note
// at the top.
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

// x (float32 or bf16) as 16-byte chunks of float values, and back
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
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

// Adds the kBwdWarps warps' column sums `acc` (lane values as in
// layer_norm_bwd_warp) in warp order and writes them to `part`.
template <int NC, int E>
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
  for (int i = threadIdx.x; i < cols; i += kBwdBlock) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) t += sums[w * cols + i];
    part[i] = t;
  }
  __syncthreads();  // `sums` is free again
}

// A row of at most kBwdWarpRow values: one warp a row; see the note at
// the top.  A block of kBwdWarps warps takes rows [blockIdx.x *
// rows_per_block, ...); warp w takes every kBwdWarps-th of them from the
// w-th.  Lane l holds values (l + 32 j) * E + e, j < NC, e < E, of a
// row: E = 16 / sizeof(T) with 16-byte loads (kVec), else E = 1.
template <typename T, int NC, bool kVec>
__global__ void __launch_bounds__(kBwdBlock)
layer_norm_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd, T* __restrict__ dx,
                    float* __restrict__ dgamma_part,
                    float* __restrict__ dbeta_part, int64_t rows, int cols,
                    int rows_per_block) {
  constexpr int E = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int V = NC * E;
  __shared__ __align__(16) float gam_s[kBwdWarpRow];  // 0 past cols
  __shared__ float sums[kBwdWarps * kBwdWarpRow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kBwdWarpRow; i += kBwdBlock)
    gam_s[i] = i < cols ? gamma[i] : 0.f;
  __syncthreads();

  float acc_g[V], acc_b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc_g[k] = acc_b[k] = 0.f;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t last =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  for (int64_t row = first + warp; row < last; row += kBwdWarps) {
    const T* xr = x + row * cols;
    const T* gr = g + row * cols;
    const float mu = mean[row];
    const float rs = rstd[row];
    float xh[V], gv[V];  // xhat and g; 0 past the row
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c0 = (lane + 32 * j) * E;
      if (c0 >= cols) {  // D is a multiple of E: a chunk is whole or out
#pragma unroll
        for (int e = 0; e < E; ++e) xh[j * E + e] = gv[j * E + e] = 0.f;
      } else if constexpr (kVec) {
        load16(xr + c0, xh + j * E);
        load16(gr + c0, gv + j * E);
      } else {
        xh[j] = to_float(__ldg(xr + c0));
        gv[j] = to_float(__ldg(gr + c0));
      }
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c0 = (lane + 32 * j) * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = j * E + e;
        xh[k] = c0 + e < cols ? (xh[k] - mu) * rs : 0.f;
        const float gg = gv[k] * gam_s[c0 + e];
        s1 += gg;
        s2 += gg * xh[k];
      }
    }
    const float m1 = mx::warp_sum(s1) / cols;
    const float m2 = mx::warp_sum(s2) / cols;
    T* dxr = dx + row * cols;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c0 = (lane + 32 * j) * E;
      float out[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = j * E + e;
        const float gg = gv[k] * gam_s[c0 + e];
        out[e] = (gg - m1 - xh[k] * m2) * rs;
        acc_g[k] += gv[k] * xh[k];
        acc_b[k] += gv[k];
      }
      if (c0 < cols) {
        if constexpr (kVec)
          store16(dxr + c0, out);
        else
          dxr[c0] = from_float<T>(out[0]);
      }
    }
  }
  block_column_sums<NC, E>(
      acc_g, sums, dgamma_part + static_cast<int64_t>(blockIdx.x) * cols,
      cols);
  block_column_sums<NC, E>(
      acc_b, sums, dbeta_part + static_cast<int64_t>(blockIdx.x) * cols,
      cols);
}


// dgamma and dbeta: the column sums of the (blocks, cols) partial rows
// of each, in a fixed order.  Block (bx, p) takes columns [32 bx, 32 bx
// + 32) of part p (0 dgamma, 1 dbeta); warp w adds partial rows w, w +
// kSumWarps, ... in that order, eight loads in flight at a time, and
// warp 0 then adds the warps' sums in warp order.
__global__ void __launch_bounds__(32 * kSumWarps)
layer_norm_bwd_sum(const float* __restrict__ parts, float* __restrict__ out,
                   int blocks, int cols) {
  __shared__ float red[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* p = parts + static_cast<int64_t>(blockIdx.y) * blocks * cols;
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
    out[static_cast<int64_t>(blockIdx.y) * cols + c] = t;
  }
}

// The shared memory a block may opt in to on `device`, queried once per
// device (the wrapper has made `device` current).
cudaError_t smem_optin(int device, int* out) {
  static std::atomic<int> known[kMaxDevices];
  if (device >= 0 && device < kMaxDevices) {
    *out = known[device].load(std::memory_order_relaxed);
    if (*out > 0) return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices)
    known[device].store(*out, std::memory_order_relaxed);
  return err;
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
struct BwdArgs {
  const T* x;
  const T* g;
  const float* gamma;
  const float* mean;
  const float* rstd;
  T* dx;
  float* part_g;
  float* part_b;
  int64_t rows;
  int cols;
  int rows_per_block;
};

template <typename T, int NC, bool kVec>
cudaError_t bwd_warp(const BwdArgs<T>& a, unsigned grid,
                     cudaStream_t stream) {
  layer_norm_bwd_warp<T, NC, kVec><<<grid, kBwdBlock, 0, stream>>>(
      a.x, a.g, a.gamma, a.mean, a.rstd, a.dx, a.part_g, a.part_b, a.rows,
      a.cols, a.rows_per_block);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One warp a row: 16-byte chunks where every row of x, g and dx starts
// on 16 bytes (NC chunks a lane, 1-8), else single values (NC a power
// of two, 1-32).
template <typename T>
cudaError_t launch_bwd_warp(const BwdArgs<T>& a, unsigned grid,
                            cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  if (a.cols % E == 0 && aligned16(a.x) && aligned16(a.g) &&
      aligned16(a.dx)) {
    const int nc = (a.cols + 32 * E - 1) / (32 * E);
    switch (nc) {
      case 1: return bwd_warp<T, 1, true>(a, grid, s);
      case 2: return bwd_warp<T, 2, true>(a, grid, s);
      case 3: return bwd_warp<T, 3, true>(a, grid, s);
      case 4: return bwd_warp<T, 4, true>(a, grid, s);
    }
    if constexpr (E == 4) {  // float32 rows take up to 8 chunks of 4
      switch (nc) {
        case 5: return bwd_warp<T, 5, true>(a, grid, s);
        case 6: return bwd_warp<T, 6, true>(a, grid, s);
        case 7: return bwd_warp<T, 7, true>(a, grid, s);
        case 8: return bwd_warp<T, 8, true>(a, grid, s);
      }
    }
    return cudaErrorInvalidValue;  // wider than kBwdWarpRow
  }
  switch (mx::lane_values(a.cols)) {
    case 1: return bwd_warp<T, 1, false>(a, grid, s);
    case 2: return bwd_warp<T, 2, false>(a, grid, s);
    case 4: return bwd_warp<T, 4, false>(a, grid, s);
    case 8: return bwd_warp<T, 8, false>(a, grid, s);
    case 16: return bwd_warp<T, 16, false>(a, grid, s);
    default: return bwd_warp<T, 32, false>(a, grid, s);
  }
}

// A whole block a row: about two values of a row a thread, whole warps,
// at most 1024.
template <typename T>
cudaError_t launch_bwd_wide(int device, const BwdArgs<T>& a, unsigned grid,
                            cudaStream_t stream) {
  const int want = ((a.cols + 1) / 2 + 31) / 32 * 32;
  const int block = want < 1024 ? want : 1024;
  int optin = 0;
  cudaError_t err = smem_optin(device, &optin);
  if (err != cudaSuccess) return err;
  const size_t cached = (64 + 4 * static_cast<size_t>(a.cols)) * sizeof(float);
  if (cached <= static_cast<size_t>(optin)) {
    if (cached > 48 * 1024) {
      err = cudaFuncSetAttribute(layer_norm_bwd_kernel<T, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(cached));
      if (err != cudaSuccess) return err;
    }
    layer_norm_bwd_kernel<T, true><<<grid, block, cached, stream>>>(
        a.x, a.g, a.gamma, a.mean, a.rstd, a.dx, a.part_g, a.part_b, a.rows,
        a.cols, a.rows_per_block);
  } else {
    layer_norm_bwd_kernel<T, false>
        <<<grid, block, 64 * sizeof(float), stream>>>(
            a.x, a.g, a.gamma, a.mean, a.rstd, a.dx, a.part_g, a.part_b,
            a.rows, a.cols, a.rows_per_block);
  }
  return cudaGetLastError();
}

// The rows' kernel into `blocks` partial rows of dgamma and of dbeta,
// then their fixed-order sum into `out` (2, cols).
template <typename T>
cudaError_t launch_bwd(int device, const void* x, const void* g,
                       const void* gamma, const void* mean, const void* rstd,
                       void* dx, void* parts, void* out, int64_t rows,
                       int cols, int rows_per_block, int blocks,
                       cudaStream_t stream) {
  if (rows_per_block <= 0 || blocks <= 0 ||
      blocks != (rows + rows_per_block - 1) / rows_per_block)
    return cudaErrorInvalidValue;
  float* pg = static_cast<float*>(parts);
  const BwdArgs<T> a{static_cast<const T*>(x),
                     static_cast<const T*>(g),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(mean),
                     static_cast<const float*>(rstd),
                     static_cast<T*>(dx),
                     pg,
                     pg + static_cast<int64_t>(blocks) * cols,
                     rows,
                     cols,
                     rows_per_block};
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t err = cols <= kBwdWarpRow
                        ? launch_bwd_warp(a, grid, stream)
                        : launch_bwd_wide(device, a, grid, stream);
  if (err != cudaSuccess) return err;
  const dim3 sum_grid((cols + 31) / 32, 2);
  layer_norm_bwd_sum<<<sum_grid, 32 * kSumWarps, 0, stream>>>(
      pg, static_cast<float*>(out), blocks, cols);
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
// forward.  parts is (2, blocks, cols) float32 scratch, blocks =
// ceil(rows / rows_per_block), one partial row of dgamma and of dbeta
// per block; out is (2, cols) float32: dgamma, then dbeta.  Launches the
// rows' kernel and the partials' sum on `stream` and returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int mx_layer_norm_bwd(int dtype, int device, const void* x,
                                 const void* g, const void* gamma,
                                 const void* mean, const void* rstd,
                                 void* dx, void* parts, void* out,
                                 long long rows, int cols,
                                 int rows_per_block, int blocks,
                                 void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(
          device, x, g, gamma, mean, rstd, dx, parts, out, rows, cols,
          rows_per_block, blocks, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(
          device, x, g, gamma, mean, rstd, dx, parts, out, rows, cols,
          rows_per_block, blocks, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
