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
// between its passes where it can.  At SSD's class rows, (3816832, 21)
// float32, the forward's bound is 641 MB at 3.35 TB/s, 0.191 ms; at the
// attention rows, (262144, 1024) float32, 2.1 GB, 0.641 ms.
//
// Dispatch by the row's width C:
//
//   C <= 32      softmax_fwd_narrow (the forward only)
//   C <= 1024    softmax_fwd_warp / softmax_bwd_warp (the backward from
//                C = 1)
//   C > 1024     softmax_fwd_wide / softmax_bwd_wide
//
// Narrow rows (softmax_fwd_narrow).  One warp a row, as below, would
// leave 32 - C lanes idle, give each lane one 4-byte load in flight, and
// spend two 5-step shuffle reductions on a few values; rows of 84 bytes
// start on 4 bytes only, so no access could be wider (SSD's rows ran at
// 36 % of the bound that way).  Instead a block's rows are one
// contiguous span of memory: a tile of 256 rows, one thread a row.  The
// block is persistent (as many as stay resident on each SM) and walks
// its tiles through a ring of 3 stages in shared memory.  One thread
// copies each tile in with Hopper's bulk copy (cp.async.bulk, completing
// on the stage's mbarrier) as whole 16-byte pieces, the next tiles'
// copies in flight while this one is computed; the at most 15 bytes
// before the first and after the last 16-byte boundary of the tile are
// loaded by single threads, so any base address and a ragged last tile
// take the same path.  Each thread then reads its row from shared memory
// into registers (C rounded up to a multiple of 4 slots, the kernel's
// template width), computes the max, exp(x - m), their sum and the true
// division e / s, as the plain version does, and writes y into the tile
// in place; the tile goes out by a bulk store, 16-byte pieces again, with
// a masked head and tail.  Rows sit C values apart: for an odd C the 32
// threads of a warp read 32 different banks (two threads a bank in
// bf16), for an even C each thread starts its row at column lane * C / 32
// and wraps around (at most two threads a bank).  Where x and y start at
// different offsets from 16 bytes, y is staged at y's offset, after
// every thread has read its row.
//
// Rows of at most 1024 values (softmax_fwd_warp, softmax_bwd_warp): one
// warp (eight rows to a block of 256 threads), the row in registers, at
// most 32 values a lane: the forward takes the max, then the exps and
// their sum, then y, from registers, so it reads x once, in the plain
// version's order of operations.  A wider row gets a block of 512
// threads: the forward streams it once keeping a running (max, sum of
// exp) pair per thread (mx::ms_add), then reads it again to write y; the
// backward reads y and g once for the sum and again for dx.  The second
// read of a row of up to a few MB comes from L2.  The TPU kernel takes
// rows of at most 16384 values (its on-chip memory); the JAX package
// computes wider rows with jax.nn.softmax, the same function, so every
// width goes through these kernels.  Threads stride over the row, so
// neighbouring threads touch neighbouring addresses, and every ragged
// edge is masked by its index.

#include <math.h>

#include <algorithm>

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int kNarrowRow = 32;        // widest row of softmax_fwd_narrow
constexpr int kTileRows = 256;        // its rows a tile = threads a block
constexpr int kStages = 3;            // its ring of tiles
constexpr int kSmallRow = 1024;       // widest row that gets one warp
constexpr int kWarpRowsBlock = 256;   // block size in one-warp-per-row mode
constexpr int kWideBlock = 512;       // block size for a wider row

// Hopper's bulk copies (cp.async.bulk) and mbarriers, as PTX.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1)
               : "memory");
}

// One arrival that also expects `bytes` more of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16; both addresses on 16 bytes) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bytes from shared to global memory, as one bulk group of its own.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::
                   "l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until every bulk store of this thread has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's writes to shared memory before later bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Elements of a span of n that precede its first 16-byte boundary (the
// head; at most n) and the end of its last whole 16-byte piece (at least
// the head): [head, end) goes by bulk copy, the rest element by element.
template <typename T>
struct Span16 {
  int head, end;
  __device__ __forceinline__ Span16(const T* p, int n) {
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    head = min(n, ((16 - off) & 15) / static_cast<int>(sizeof(T)));
    const int tail = static_cast<int>(
        (reinterpret_cast<uintptr_t>(p + n) & 15) / sizeof(T));
    end = max(head, n - tail);
  }
};

// Offset of p from 16 bytes, in elements: where element 0 of a span
// starting at p is staged in a stage buffer (which starts on 16 bytes),
// so that the span's 16-byte pieces land on 16 bytes there too.
template <typename T>
__device__ __forceinline__ int stage_shift(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

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

// Rows of at most N <= 32 values; see the head of this file.  Skew:
// cols is even, and each thread's row starts at its own column.  Dynamic
// shared memory: kStages mbarriers in the first 64 bytes, then kStages
// buffers of `stage` bytes (kTileRows * cols values and 16 bytes for the
// staging offset).
template <typename T, int N, bool Skew>
__global__ void __launch_bounds__(kTileRows)
softmax_fwd_narrow(const T* __restrict__ x, T* __restrict__ y, int64_t rows,
                   int cols, int64_t tiles, int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int t = threadIdx.x;
  auto buffer = [&](int64_t k) {
    return reinterpret_cast<T*>(smem + 64 + (k % kStages) * stage);
  };
  auto tile_rows = [&](int64_t tile) {
    const int64_t left = rows - tile * kTileRows;
    return left < kTileRows ? static_cast<int>(left) : kTileRows;
  };
  // the k-th tile of this block into its stage (thread 0 only)
  auto issue = [&](int64_t k) {
    const int64_t tile = blockIdx.x + k * gridDim.x;
    if (tile >= tiles) return;
    const T* src = x + tile * kTileRows * cols;
    const Span16<T> sp(src, tile_rows(tile) * cols);
    const uint32_t bytes = (sp.end - sp.head) * sizeof(T);
    uint64_t* bar = bars + k % kStages;
    mbar_expect(bar, bytes);
    if (bytes)
      bulk_load(buffer(k) + stage_shift(src) + sp.head, src + sp.head, bytes,
                bar);
  };
  if (t == 0) {
    for (int k = 0; k < kStages; ++k) mbar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < kStages - 1; ++k) issue(k);
  }
  __syncthreads();

  // this thread's row starts at column rot and wraps around
  const int rot = Skew ? (t & 31) * cols >> 5 : 0;
  for (int64_t k = 0;; ++k) {
    const int64_t tile = blockIdx.x + k * gridDim.x;
    if (tile >= tiles) break;
    const int nrows = tile_rows(tile), n = nrows * cols;
    const T* src = x + tile * kTileRows * cols;
    T* dst = y + tile * kTileRows * cols;
    T* buf = buffer(k);
    const int sx = stage_shift(src), sy = stage_shift(dst);
    const Span16<T> in(src, n);
    mbar_wait(bars + k % kStages, static_cast<uint32_t>(k / kStages) & 1);
    for (int i = t; i < in.head; i += kTileRows) buf[sx + i] = src[i];
    for (int i = in.end + t; i < n; i += kTileRows) buf[sx + i] = src[i];
    __syncthreads();

    float v[N];
    float m = -INFINITY, s = 0.f;
    if (t < nrows) {
      const T* row = buf + sx + t * cols;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < cols) {
          const int c = !Skew || j + rot < cols ? j + rot : j + rot - cols;
          v[j] = to_float(row[c]);
          m = fmaxf(m, v[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < cols) {
          v[j] = expf(v[j] - m);
          s += v[j];
        }
      }
    }
    if (sx != sy) __syncthreads();  // every row read before y moves over it
    if (t < nrows) {
      T* row = buf + sy + t * cols;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < cols) {
          const int c = !Skew || j + rot < cols ? j + rot : j + rot - cols;
          row[c] = from_float<T>(v[j] / s);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    const Span16<T> out(dst, n);
    if (t == 0) {
      // the previous tile's store has read its stage: refill that stage,
      // then store this tile
      bulk_wait_read();
      issue(k + kStages - 1);
      const uint32_t bytes = (out.end - out.head) * sizeof(T);
      if (bytes) bulk_store(dst + out.head, buf + sy + out.head, bytes);
    }
    for (int i = t; i < out.head; i += kTileRows) dst[i] = buf[sy + i];
    for (int i = out.end + t; i < n; i += kTileRows) dst[i] = buf[sy + i];
  }
  if (t == 0) bulk_wait_all();
}

template <typename T, int N>
cudaError_t fwd_narrow(const void* x, void* y, int64_t rows, int cols,
                       int device, cudaStream_t stream) {
  const auto kernel = cols % 2 ? softmax_fwd_narrow<T, N, false>
                               : softmax_fwd_narrow<T, N, true>;
  const int stage = kTileRows * cols * static_cast<int>(sizeof(T)) + 16;
  const int smem = 64 + kStages * stage;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kTileRows, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (rows + kTileRows - 1) / kTileRows;
  const int64_t grid =
      std::min<int64_t>(tiles, static_cast<int64_t>(sms) * std::max(per_sm, 1));
  kernel<<<static_cast<unsigned>(grid), kTileRows, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, cols, tiles, stage);
  return cudaGetLastError();
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
                       int device, cudaStream_t stream) {
  if (cols <= kNarrowRow) {
    // a thread's values: cols up to a multiple of 4 (so that masked
    // slots cost little)
    switch ((cols + 3) / 4) {
      case 1: return fwd_narrow<T, 4>(x, y, rows, cols, device, stream);
      case 2: return fwd_narrow<T, 8>(x, y, rows, cols, device, stream);
      case 3: return fwd_narrow<T, 12>(x, y, rows, cols, device, stream);
      case 4: return fwd_narrow<T, 16>(x, y, rows, cols, device, stream);
      case 5: return fwd_narrow<T, 20>(x, y, rows, cols, device, stream);
      case 6: return fwd_narrow<T, 24>(x, y, rows, cols, device, stream);
      case 7: return fwd_narrow<T, 28>(x, y, rows, cols, device, stream);
      default: return fwd_narrow<T, 32>(x, y, rows, cols, device, stream);
    }
  }
  if (cols > kSmallRow) {
    if (rows > 0x7fffffff) return cudaErrorInvalidValue;
    softmax_fwd_wide<T><<<static_cast<unsigned>(rows), kWideBlock, 0,
                          stream>>>(static_cast<const T*>(x),
                                    static_cast<T*>(y), cols);
    return cudaGetLastError();
  }
  switch (mx::lane_values(cols)) {  // 33 <= cols <= 1024
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
      return static_cast<int>(launch_fwd<float>(x, y, rows, cols, device, s));
    case 1:
      return static_cast<int>(
          launch_fwd<__nv_bfloat16>(x, y, rows, cols, device, s));
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
