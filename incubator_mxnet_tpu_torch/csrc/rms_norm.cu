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
// row, with gg = g * gamma (float32; g arrives in x's type, gamma in
// float32 or in x's type and is rounded to x's type in registers, as
// the TPU wrapper casts it):
//
//   s  = sum(gg * x)
//   dx = rrms * (gg - x * rrms^2 * s / D)         (written in x's type)
//
// and, as on the TPU, each block writes one float32 partial row of
// dgamma = sum(g * x * rrms) over its rows, giving (blocks, D) partials.
// A second kernel of this file, rms_bwd_sum, adds them column by column
// in a fixed order and writes dgamma in gamma's type, rounded once.  No
// atomics, so the result is the same from run to run.
//
// Bound: memory traffic.  The forward reads x once and writes y once
// (about four operations an element), the backward reads x and g once and
// writes dx once (about eight), far below the card's ratio of operations
// to bytes.  So every value of a row is read from device memory once.
//
// Forward layout: a row of at most 1024 values gets one warp and stays
// in its registers, at most 32 values a lane, reduced with warp shuffles
// alone; a block of 256 threads takes eight rows.  A wider row gets a
// whole block of 512 threads, reduced through shared memory; it reads
// its row a second time (from L2) for the output.  Threads stride over
// the row, so neighbouring threads touch neighbouring addresses.
//
// Backward layout, a row of at most 1024 values: one warp a row, and a
// block of eight warps takes a run of rows, warp w every eighth from the
// w-th.  Lane l holds chunks l, l + 32, ... of the row, 16 bytes each (4
// float32 or 8 bf16 values) where x, g and dx start on 16 bytes and D is
// a multiple of a chunk, else single values l, l + 32, ....  gamma is
// read once a block into shared memory.  While a warp reduces and
// stores one row, the loads of its next row (x, g, rrms) are in flight:
// the raw 16-byte chunks wait in registers and are unpacked to float
// when used (single values 32 a lane take a row at a time: two such
// rows, unpacked, would not fit).  Each lane keeps the dgamma sums of
// its own columns in registers across its rows; at the end the eight
// warps' sums meet in shared memory and are added in warp order into
// the block's partial row.  The wrapper gives each SM at most the
// blocks that stay resident, two for rows of at most 512 values
// (__launch_bounds__ caps a thread at 128 registers), one above (up to
// 255 registers, so that two rows of 1024 values fit without a spill),
// and at most one block for every eight rows.  A wider row gets a
// whole block of 512 threads, reduced through shared memory; each thread
// keeps the dgamma sums of its columns in the block's partial row in
// device memory, which no other thread touches.

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int kSmallRow = 1024;       // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kWarps = kWarpRowsBlock / 32;
constexpr int kWideBlock = 512;       // block size for a wider row
constexpr int kTwoBlockValues = 16;   // see rms_bwd_warp's launch bounds

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

// A row's chunk as it waits in registers: 16 bytes (kVec) or one value.
template <typename T, bool kVec>
struct Chunk {
  using type = T;
};
template <typename T>
struct Chunk<T, true> {
  using type = uint4;
};

// Lane `lane`'s chunks of row `row` of x and g, and its rrms; a chunk
// past the row is 0.  Only starts the loads: nothing here reads them.
template <typename T, int NC, bool kVec, typename C>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ g,
                                         const float* __restrict__ rrms,
                                         int64_t row, int cols, int lane,
                                         C (&xc)[NC], C (&gc)[NC], float& r) {
  constexpr int E = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  const T* xr = x + row * cols;
  const T* gr = g + row * cols;
  r = __ldg(rrms + row);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c0 = (lane + 32 * j) * E;
    if (c0 >= cols) {  // D is a multiple of E: a chunk is whole or out
      xc[j] = gc[j] = C{};
    } else if constexpr (kVec) {
      xc[j] = __ldg(reinterpret_cast<const uint4*>(xr + c0));
      gc[j] = __ldg(reinterpret_cast<const uint4*>(gr + c0));
    } else {
      xc[j] = __ldg(xr + c0);
      gc[j] = __ldg(gr + c0);
    }
  }
}

template <typename T, bool kVec, typename C>
__device__ __forceinline__ void unpack(const C& c, float* out) {
  if constexpr (kVec)
    mx::unpack16<T>(c, out);
  else
    out[0] = to_float(c);
}

// gamma's values c0, c0 + 1, ..., c0 + E - 1 from shared memory
template <int E>
__device__ __forceinline__ void gamma_chunk(const float* gam_s, int c0,
                                            float* out) {
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int q = 0; q < E; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(gam_s + c0 + q);
      out[q] = v.x;
      out[q + 1] = v.y;
      out[q + 2] = v.z;
      out[q + 3] = v.w;
    }
  } else {
    out[0] = gam_s[c0];
  }
}

// A row of at most kSmallRow values; see the note at the top.  A block
// of kWarps warps takes rows [blockIdx.x * rows_per_block, ...); warp w
// takes every kWarps-th of them from the w-th.  Lane l holds values
// (l + 32 j) * E + e, j < NC, e < E, of a row: E = 16 / sizeof(T) with
// 16-byte loads (kVec), else E = 1.  gamma is G: float32, or T.
//
// Two blocks stay resident on an SM where a lane holds at most
// kTwoBlockValues values of a row (rows of at most 512 values), so at most
// 128 registers a thread; one block, with up to 255, past that.
template <typename T, typename G, int NC, bool kVec>
__global__ void __launch_bounds__(
    kWarpRowsBlock,
    NC * (kVec ? 16 / static_cast<int>(sizeof(T)) : 1) <= kTwoBlockValues
        ? 2
        : 1)
rms_bwd_warp(const T* __restrict__ x, const T* __restrict__ g,
             const G* __restrict__ gamma, const float* __restrict__ rrms,
             T* __restrict__ dx, float* __restrict__ dgamma_part,
             int64_t rows, int cols, int rows_per_block) {
  constexpr int E = kVec ? 16 / static_cast<int>(sizeof(T)) : 1;
  constexpr int V = NC * E;
  using C = typename Chunk<T, kVec>::type;
  // the next row's loads start ahead, except with 32 single values
  // a lane: two such rows of bf16 values, unpacked, would not fit
  constexpr bool kAhead = kVec || V <= kTwoBlockValues;
  __shared__ __align__(16) float gam_s[kSmallRow];  // 0 past cols
  __shared__ float sums[kWarps * kSmallRow];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kSmallRow; i += kWarpRowsBlock)
    gam_s[i] = i < cols ? mx::param_as<T, G>(gamma, i) : 0.f;
  __syncthreads();

  const float n = static_cast<float>(cols);
  float acc[V];
#pragma unroll
  for (int k = 0; k < V; ++k) acc[k] = 0.f;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t last =
      first + rows_per_block < rows ? first + rows_per_block : rows;
  C cx[NC], cg[NC];  // this row's chunks
  float r = 0.f;
  int64_t row = first + warp;
  if (kAhead && row < last)
    load_row<T, NC, kVec>(x, g, rrms, row, cols, lane, cx, cg, r);
  for (; row < last; row += kWarps) {
    [[maybe_unused]] C nx[NC], ng[NC];  // the next row's, while this one
    [[maybe_unused]] float nr;          // is reduced
    const bool more = row + kWarps < last;
    if constexpr (kAhead) {
      if (more)
        load_row<T, NC, kVec>(x, g, rrms, row + kWarps, cols, lane, nx, ng,
                              nr);
    } else {
      load_row<T, NC, kVec>(x, g, rrms, row, cols, lane, cx, cg, r);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float xv[E], gv[E], gm[E];
      unpack<T, kVec>(cx[j], xv);
      unpack<T, kVec>(cg[j], gv);
      gamma_chunk<E>(gam_s, (lane + 32 * j) * E, gm);
#pragma unroll
      for (int e = 0; e < E; ++e) s += gv[e] * gm[e] * xv[e];
    }
    s = mx::warp_sum(s);
    T* dxr = dx + row * cols;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c0 = (lane + 32 * j) * E;
      float xv[E], gv[E], gm[E], out[E];
      unpack<T, kVec>(cx[j], xv);
      unpack<T, kVec>(cg[j], gv);
      gamma_chunk<E>(gam_s, c0, gm);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float gg = gv[e] * gm[e];
        out[e] = r * (gg - xv[e] * (r * r) * s / n);
        acc[j * E + e] += gv[e] * xv[e] * r;
      }
      if (c0 < cols) {
        if constexpr (kVec)
          mx::store16(dxr + c0, out);
        else
          dxr[c0] = from_float<T>(out[0]);
      }
    }
    if constexpr (kAhead) {
      if (more) {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          cx[j] = nx[j];
          cg[j] = ng[j];
        }
        r = nr;
      }
    }
  }
  mx::block_column_sums<kWarps, NC, E>(
      acc, sums, dgamma_part + static_cast<int64_t>(blockIdx.x) * cols,
      cols);
}

// A block of kWideBlock threads takes a run of rows; thread t owns
// columns t, t + kWideBlock, ... of every row and of the partial row.
// gamma is G: float32, or T.
template <typename T, typename G>
__global__ void __launch_bounds__(kWideBlock)
rms_bwd_wide(const T* __restrict__ x, const T* __restrict__ g,
             const G* __restrict__ gamma, const float* __restrict__ rrms,
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
      s += to_float(gr[i]) * mx::param_as<T, G>(gamma, i) * to_float(xr[i]);
    s = mx::row_sum(s, red, true);
    T* dxr = dx + row * cols;
    for (int i = threadIdx.x; i < cols; i += kWideBlock) {
      const float xv = to_float(xr[i]);
      const float gv = to_float(gr[i]);
      const float gg = gv * mx::param_as<T, G>(gamma, i);
      dxr[i] = from_float<T>(r * (gg - xv * (r * r) * s / n));
      part[i] += gv * xv * r;
    }
  }
}

// dgamma: the column sums of the (blocks, cols) partial rows in a fixed
// order (mx::partial_rows_sum), rounded once to gamma's type O.
template <typename O>
__global__ void __launch_bounds__(32 * mx::kSumWarps)
rms_bwd_sum(const float* __restrict__ parts, O* __restrict__ out,
            int blocks, int cols) {
  __shared__ float red[mx::kSumWarps][32];
  mx::partial_rows_sum(parts, out, blocks, cols, red);
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

template <typename T, typename G>
struct BwdArgs {
  const T* x;
  const T* g;
  const G* gamma;
  const float* rrms;
  T* dx;
  float* parts;
  int64_t rows;
  int cols;
  int rows_per_block;
};

template <typename T, typename G, int NC, bool kVec>
cudaError_t bwd_warp(const BwdArgs<T, G>& a, unsigned grid,
                     cudaStream_t stream) {
  rms_bwd_warp<T, G, NC, kVec><<<grid, kWarpRowsBlock, 0, stream>>>(
      a.x, a.g, a.gamma, a.rrms, a.dx, a.parts, a.rows, a.cols,
      a.rows_per_block);
  return cudaGetLastError();
}

// One warp a row: 16-byte chunks where every row of x, g and dx starts
// on 16 bytes (NC chunks a lane, 1-8), else single values (NC a power
// of two, 1-32).
template <typename T, typename G>
cudaError_t launch_bwd_warp(const BwdArgs<T, G>& a, unsigned grid,
                            cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  if (a.cols % E == 0 && mx::aligned16(a.x) && mx::aligned16(a.g) &&
      mx::aligned16(a.dx)) {
    switch ((a.cols + 32 * E - 1) / (32 * E)) {
      case 1: return bwd_warp<T, G, 1, true>(a, grid, s);
      case 2: return bwd_warp<T, G, 2, true>(a, grid, s);
      case 3: return bwd_warp<T, G, 3, true>(a, grid, s);
      case 4: return bwd_warp<T, G, 4, true>(a, grid, s);
    }
    if constexpr (E == 4) {  // float32 rows take up to 8 chunks of 4
      switch ((a.cols + 127) / 128) {
        case 5: return bwd_warp<T, G, 5, true>(a, grid, s);
        case 6: return bwd_warp<T, G, 6, true>(a, grid, s);
        case 7: return bwd_warp<T, G, 7, true>(a, grid, s);
        case 8: return bwd_warp<T, G, 8, true>(a, grid, s);
      }
    }
    return cudaErrorInvalidValue;  // wider than kSmallRow
  }
  switch (mx::lane_values(a.cols)) {
    case 1: return bwd_warp<T, G, 1, false>(a, grid, s);
    case 2: return bwd_warp<T, G, 2, false>(a, grid, s);
    case 4: return bwd_warp<T, G, 4, false>(a, grid, s);
    case 8: return bwd_warp<T, G, 8, false>(a, grid, s);
    case 16: return bwd_warp<T, G, 16, false>(a, grid, s);
    default: return bwd_warp<T, G, 32, false>(a, grid, s);
  }
}

// The rows' kernel into `blocks` partial rows of dgamma, then their
// fixed-order sum into `dgamma` in gamma's type G.
template <typename T, typename G>
cudaError_t launch_bwd(const void* x, const void* g, const void* gamma,
                       const void* rrms, void* dx, void* parts, void* dgamma,
                       int64_t rows, int cols, int rows_per_block, int blocks,
                       cudaStream_t stream) {
  if (rows_per_block <= 0 || blocks <= 0 ||
      blocks != (rows + rows_per_block - 1) / rows_per_block)
    return cudaErrorInvalidValue;
  const BwdArgs<T, G> a{static_cast<const T*>(x),
                        static_cast<const T*>(g),
                        static_cast<const G*>(gamma),
                        static_cast<const float*>(rrms),
                        static_cast<T*>(dx),
                        static_cast<float*>(parts),
                        rows,
                        cols,
                        rows_per_block};
  const unsigned grid = static_cast<unsigned>(blocks);
  cudaError_t err;
  if (cols > kSmallRow) {
    rms_bwd_wide<T, G><<<grid, kWideBlock, 0, stream>>>(
        a.x, a.g, a.gamma, a.rrms, a.dx, a.parts, rows, cols,
        rows_per_block);
    err = cudaGetLastError();
  } else {
    err = launch_bwd_warp(a, grid, stream);
  }
  if (err != cudaSuccess) return err;
  const unsigned sum_grid = static_cast<unsigned>((cols + 31) / 32);
  rms_bwd_sum<G><<<sum_grid, 32 * mx::kSumWarps, 0, stream>>>(
      a.parts, static_cast<G*>(dgamma), blocks, cols);
  return cudaGetLastError();
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

// dtype as above, gdtype gamma's: float32 (0) or x's.  x, g and dx are
// (rows, cols) in x's type, contiguous; gamma is (cols,) and is rounded
// to x's type as it is read; rrms is (rows,) float32 from the forward.
// parts is (blocks, cols) float32 scratch, blocks = ceil(rows /
// rows_per_block), one partial row per block; dgamma is (cols,) in
// gamma's type.  Launches the rows' kernel and the partials' sum on
// `stream` and returns the first cudaError_t that is not cudaSuccess.
extern "C" int mx_rms_norm_bwd(int dtype, int gdtype, int device,
                               const void* x, const void* g,
                               const void* gamma, const void* rrms, void* dx,
                               void* parts, void* dgamma, long long rows,
                               int cols, int rows_per_block, int blocks,
                               void* stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0)
    return static_cast<int>(launch_bwd<float, float>(
        x, g, gamma, rrms, dx, parts, dgamma, rows, cols, rows_per_block,
        blocks, s));
  if (dtype == 1 && gdtype == 0)
    return static_cast<int>(launch_bwd<__nv_bfloat16, float>(
        x, g, gamma, rrms, dx, parts, dgamma, rows, cols, rows_per_block,
        blocks, s));
  if (dtype == 1 && gdtype == 1)
    return static_cast<int>(launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, g, gamma, rrms, dx, parts, dgamma, rows, cols, rows_per_block,
        blocks, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
