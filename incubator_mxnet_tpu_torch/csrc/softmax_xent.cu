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
// and writes dx once.  Both stream the row once, keeping a running
// (max, sum) pair per thread and rescaling the sum when the max grows,
// so no second pass and no staging is needed and a row of any width
// fits (the TPU kernel is limited to 16384 columns by its on-chip
// memory; the JAX package computes wider rows by composition, which is
// the same function).  The forward's bound at the LSTM LM's (1120,
// 10000) float32 is 44.8 MB at 3.35 TB/s, 0.0134 ms; at BERT's (2048,
// 30522) 250 MB, 0.0746 ms.
//
// Forward dispatch by the row's width C:
//
//   C <= 1024    softmax_xent_fwd_warp: one warp a row (eight rows to a
//                block of 256 threads), loads strided over the row, four
//                in flight a lane; the label's logit read by lane 0.
//   C > 1024     softmax_xent_fwd_wide: one CTA of 128 threads a row.
//
// What held the old wide path back: a block of 512 threads a row, scalar
// 4-byte loads and a branchy expf a logit (mx::ms_add) gave the LSTM
// LM's 1120 rows 1120 blocks, 4 resident on each of 132 SMs: 2.12 waves,
// the third 64 blocks on 64 SMs with 8 KB in flight each (46 % of the
// bound overall).  The wide kernel loads 16-byte chunks (4 float32 or 8
// bf16 values), 32 values a thread at a time, and folds each round into
// its running pair with one rescale for the round's max and, per value,
// one subtraction, one multiply, one ex2.approx and one add (exp(v - m)
// = 2^((v - m) log2 e); about 2 ulp, against the 20-odd instructions of
// expf).  With 128 threads a CTA every one of the LSTM LM's 1120 rows is
// resident at once, so there is no second wave; measured on the card,
// that and the cheaper exp decided it.  The row is cut on 16-byte
// boundaries inside it, so any row start takes the same path: the
// values before its first boundary and after its last whole chunk are
// read one a thread.  The block's pairs merge in a fixed order
// (mx::row_ms), so two runs give the same bits.  Splitting a row over a
// thread-block cluster lost on the card at every shape a ported path
// runs (PERF.md, Findings) and is not built.

// Backward layout: a row of at most 1024 values gets one warp (eight
// rows to a block of 256 threads); a wider row gets a block of 512
// threads.  Threads stride over the row, so neighbouring threads touch
// neighbouring addresses.

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
constexpr int kRowBlock = 128;        // the wide forward's CTA

__device__ __forceinline__ int clip_label(int l, int cols) {
  return l < 0 ? 0 : (l >= cols ? cols - 1 : l);
}

// One warp a row, eight rows a block.
template <typename T>
__global__ void __launch_bounds__(kWarpRowsBlock)
softmax_xent_fwd_warp(const T* __restrict__ x, const int* __restrict__ labels,
                      float* __restrict__ loss, float* __restrict__ lse,
                      int64_t rows, int cols) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kWarpRowsBlock / 32) +
      (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only; no block barrier here
  const T* xr = x + row * cols;
  float m = -INFINITY, s = 0.f;
  int i = lane;
  for (; i + 3 * 32 < cols; i += 4 * 32) {
    const float v0 = to_float(xr[i]);
    const float v1 = to_float(xr[i + 32]);
    const float v2 = to_float(xr[i + 2 * 32]);
    const float v3 = to_float(xr[i + 3 * 32]);
    ms_add(m, s, v0);
    ms_add(m, s, v1);
    ms_add(m, s, v2);
    ms_add(m, s, v3);
  }
  for (; i < cols; i += 32) ms_add(m, s, to_float(xr[i]));
  row_ms(m, s, nullptr, false);
  if (lane == 0) {
    const float l = m + logf(s);
    lse[row] = l;
    loss[row] = l - to_float(xr[clip_label(labels[row], cols)]);
  }
}

// 2^x by the SFU (ex2.approx, about 2 ulp; results below 2^-126 flush
// to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The running pair of the wide kernel: m, the max so far, and s, the
// sum of exp(x - shift(m)), where shift(m) is m where finite and 0 else
// (so that a row of -inf sums to 0 and a NaN or +inf logit carries
// through to lse).
__device__ __forceinline__ float shift(float m) {
  return isfinite(m) ? m : 0.f;
}

// Folds K values into (m, s), rescaling s once for their max.  While m
// is -inf, s holds only terms of -inf (0, or NaN to carry) and is not
// rescaled: exp(-inf - cm) would be 0, and for cm below about -88 the
// ex2 of shift(-inf) - cm overflows, giving 0 * inf.
template <int K>
__device__ __forceinline__ void fold(float& m, float& s, const float* v) {
  float cm = v[0];
#pragma unroll
  for (int k = 1; k < K; ++k) cm = fmaxf(cm, v[k]);
  if (cm > m) {
    if (m != -INFINITY) s *= exp2_approx((m - shift(cm)) * kLog2e);
    m = cm;
  }
  const float sm = shift(m);
#pragma unroll
  for (int k = 0; k < K; ++k) s += exp2_approx((v[k] - sm) * kLog2e);
}

// One CTA of kRowBlock threads a row, each thread with K 16-byte chunks
// in flight at a time; see the head of this file.
template <typename T>
__global__ void __launch_bounds__(kRowBlock)
softmax_xent_fwd_wide(const T* __restrict__ x, const int* __restrict__ labels,
                      float* __restrict__ loss, float* __restrict__ lse,
                      int cols) {
  constexpr int E = 16 / sizeof(T);  // values a chunk
  constexpr int K = 32 / E;          // chunks a round: 32 values a thread
  __shared__ float red[64];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * cols;
  const int t = threadIdx.x;

  // the row's 16-byte chunks, from the first 16-byte boundary in the row
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(xr) & 15);
  const int head = min(cols, ((16 - off) & 15) / static_cast<int>(sizeof(T)));
  const int chunks = (cols - head) / E;
  const int tail = head + chunks * E;
  const T* xa = xr + head;
  // in flight with the first round: the label's logit and the values
  // before the first boundary and after the last whole chunk, one a
  // thread
  float picked = 0.f, ends[2] = {-INFINITY, -INFINITY};
  if (t == 0) picked = to_float(xr[clip_label(labels[row], cols)]);
  if (t < head) ends[0] = to_float(xr[t]);
  if (t < cols - tail) ends[1] = to_float(xr[tail + t]);

  float m = -INFINITY, s = 0.f;
  for (int c = t; c < chunks; c += K * kRowBlock) {
    float v[K * E];
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int chunk = c + u * kRowBlock;
      if (chunk < chunks) {
        mx::load16(xa + static_cast<int64_t>(chunk) * E, v + u * E);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) v[u * E + e] = -INFINITY;  // adds 0
      }
    }
    fold<K * E>(m, s, v);
  }
  fold<2>(m, s, ends);
  row_ms(m, s, red, true);
  if (t == 0) {
    const float l = m + logf(s);
    lse[row] = l;
    loss[row] = l - picked;
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
  if (cols > kSmallRow) {
    if (rows > 0x7fffffff) return cudaErrorInvalidValue;
    softmax_xent_fwd_wide<T>
        <<<static_cast<unsigned>(rows), kRowBlock, 0, stream>>>(
            static_cast<const T*>(x), labels, loss, lse, cols);
    return cudaGetLastError();
  }
  constexpr int kRows = kWarpRowsBlock / 32;
  const int64_t grid = (rows + kRows - 1) / kRows;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  softmax_xent_fwd_warp<T>
      <<<static_cast<unsigned>(grid), kWarpRowsBlock, 0, stream>>>(
          static_cast<const T*>(x), labels, loss, lse, rows, cols);
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
      return static_cast<int>(
          launch_fwd<float>(x, lp, lo, ls, rows, cols, s));
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
