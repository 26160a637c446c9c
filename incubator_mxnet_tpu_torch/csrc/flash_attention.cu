// Flash attention, forward and backward, written for Hopper (sm_90a).
//
// Forward.  Replaces the Pallas TPU kernel `_flash_fwd_kernel`, launched
// by `_flash_fwd_impl` from `flash_attention`
// (incubator_mxnet_tpu/ops/pallas_kernels.py).  For each (batch, head)
// and each query row, in float32:
//
//   s = (q * scale) . k^T      (q widened to float32, then scaled)
//   s = -1e30 where col >= Tk or (causal and col > row)
//   o = sum_col exp(s - m) v / max(sum_col exp(s - m), 1e-30)
//
// by an online (max m, sum l) over 64-wide KV tiles, o written in the
// output type and lse = m + log(max(l, 1e-30)) in float32 for the
// backward.  Causal masking is aligned top-left (col <= row), so Tq and
// Tk may differ; KV tiles past the diagonal are skipped, as the TPU
// kernel's `n_live` skips its blocks.
//
// Backward.  The JAX package has no Pallas backward:
// `_attn_bwd_reference` (same file) recomputes the row statistics, the
// float32 output O and delta = rowsum(dO * O) in XLA scans, then dq, dk
// and dv.  Here delta comes from the wrapper (a torch expression over
// the forward's float32 output, as XLA computes it), p is recomputed from
// the saved lse, and two kernels compute
//
//   s  = (q . k^T) * scale,   p = exp(s - lse)   (0 where masked)
//   dp = dO . v^T,            ds = p * (dp - delta) * scale
//   dv = p^T . dO,  dk = ds^T . q     (kernel dkdv: one block per KV tile)
//   dq = ds . k                       (kernel dq: one block per q tile)
//
// dq has a kernel of its own so that no gradient is summed with atomics:
// each output element is written once by one block, and the result does
// not depend on the order in which blocks run.
//
// Numbers: every product accumulates in float32 FMA, and p and ds stay
// float32, as in the JAX functions; no tensor core and no TF32 rounding.
//
// Bound.  At the TransformerLM's shape (B*H = 256, T = 1024, D = 64,
// causal) the forward does 34 GFLOP on 161 MiB of q, k, v (bf16), o
// (float32, kept for the backward) and lse, and the backward 86 GFLOP
// (five products): far above the card's ratio of operations to bytes,
// so the kernels are bound by arithmetic.  In float32 FMA (67 TFLOP/s)
// the forward needs at least 0.51 ms and the backward 1.28 ms.  The
// design keeps every (q, kv) tile of s, p and ds in registers and shared
// memory and never writes one to device memory, so bytes stay at the
// inputs and outputs.  Products use a 4 x 4 register tile a thread over
// shared memory; wgmma with bf16 operands is the later lever.
//
// Layout: a block of 256 threads takes a 64-row q tile (forward, dq) or
// a 64-row KV tile (dkdv).  Thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16 i and columns tx + 16 j of a (64, 64) score tile and
// columns tx + 16 c of a (64, D) accumulator.  Tiles sit in shared memory
// as float32 rows of D rounded up to 16, 32, 64 or 128, with one float of
// padding so that a row stride is odd: neighbouring lanes reading one
// column of neighbouring rows, or one row along d, hit distinct banks.
// Each tile is read from device memory once per use, along d, and
// widened to float32 as it is stored; every ragged edge (rows past Tq or
// Tk, columns past D) is zero-filled on load and masked on store, with
// 64-bit offsets.  q, k, v, o, dO and the gradients are strided views
// (the model's heads are transposes of one (B, T, 3, H, D) product):
// the kernels take each tensor's batch, head and row strides, so the
// wrapper copies nothing.

#include <math.h>

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int kTile = 64;        // rows of a q tile and of a KV tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPLd = kTile + 1;  // row stride of a (q, kv) tile in smem
constexpr float kNegInf = -1e30f;

struct View {  // element strides of a (B, H, T, D) tensor; d stride is 1
  long long b, h, t;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* g;        // dO
  void* o;              // forward output
  void* dq;
  void* dk;
  void* dv;
  const float* lse;     // (B, H, Tq) contiguous, from the forward
  const float* delta;   // (B, H, Tq) contiguous, rowsum(dO * O)
  float* lse_out;
  View qs, ks, vs, gs, os, dqs, dks, dvs;
  int H, Tq, Tk, D, causal;
  float scale;
};

template <int NO>
struct Geom {
  static constexpr int kDp = 16 * NO;        // D rounded up
  static constexpr int kLd = kDp + 1;        // row stride of a (row, d) tile
  static constexpr int kFloats = kTile * kLd;
};

// Rows [r0, r0 + 64) of a (rows, D) matrix with row stride st, as float32
// times mul, into dst[row][d]; zero where the row or d is out of range.
template <typename T, int NO>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int r0, int rows,
                                          int D, float mul) {
  constexpr int kDp = Geom<NO>::kDp, kLd = Geom<NO>::kLd;
  for (int i = threadIdx.x; i < kTile * kDp; i += kThreads) {
    const int r = i / kDp, d = i % kDp;
    float val = 0.f;
    if (r0 + r < rows && d < D)
      val = to_float(src[static_cast<long long>(r0 + r) * st + d]) * mul;
    dst[r * kLd + d] = val;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two (64, D)
// tiles.
template <int NO>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b) {
  constexpr int kLd = Geom<NO>::kLd;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < Geom<NO>::kDp; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum_r p[ty + 16 i][r] * m[r][tx + 16 c], with p a (64, 64)
// tile of stride kPLd and m a (64, D) tile.
template <int NO>
__device__ __forceinline__ void tile_acc(float (&acc)[4][NO], const float* p,
                                         const float* m) {
  constexpr int kLd = Geom<NO>::kLd;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[4], mv[NO];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPLd + r];
#pragma unroll
    for (int c = 0; c < NO; ++c) mv[c] = m[r * kLd + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] = fmaf(pv[i], mv[c], acc[i][c]);
  }
}

// Max and sum over the 16 lanes (tx) that share a row: one half-warp.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The KV tiles a q tile at q0 reads: up to Tk, and in causal mode up to
// its last real row (col <= row).
__device__ __forceinline__ int live_kv_tiles(const Params& p, int q0) {
  int end = p.Tk;
  if (p.causal) end = min(end, min(q0 + kTile, p.Tq));
  return (end + kTile - 1) / kTile;
}

__device__ __forceinline__ bool live(const Params& p, int row, int col) {
  return row < p.Tq && col < p.Tk && (!p.causal || col <= row);
}

// Grid (B*H, q tiles), the longest causal tiles first.
template <typename T, typename TO, int NO>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  extern __shared__ float smem[];
  constexpr int kF = Geom<NO>::kFloats;
  float* qt = smem;
  float* kt = qt + kF;
  float* vt = kt + kF;
  float* pt = vt + kF;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;
  load_tile<T, NO>(qt, q, p.qs.t, q0, p.Tq, p.D, p.scale);

  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }
  const int nkv = live_kv_tiles(p, q0);
  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, NO>(kt, k, p.ks.t, k0, p.Tk, p.D, 1.f);
    load_tile<T, NO>(vt, v, p.vs.t, k0, p.Tk, p.D, 1.f);
    __syncthreads();
    float s[4][4];
    tile_dot<NO>(s, qt, kt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= p.Tk || (p.causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        pt[(ty + 16 * i) * kPLd + tx + 16 * j] = e;
        sum += e;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_acc<NO>(acc, pt, vt);
  }

  TO* o = static_cast<TO*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    TO* orow = o + row * p.os.t;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) orow[col] = from_float<TO>(acc[i][c] / den);
    }
    if (tx == 0)
      p.lse_out[static_cast<long long>(bh) * p.Tq + row] = m[i] + logf(den);
  }
}

// Grid (B*H, q tiles), the longest causal tiles first.
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  extern __shared__ float smem[];
  constexpr int kF = Geom<NO>::kFloats;
  float* qt = smem;
  float* gt = qt + kF;
  float* kt = gt + kF;
  float* vt = kt + kF;
  float* dst = vt + kF;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* g = static_cast<const T*>(p.g) + b * p.gs.b + h * p.gs.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;
  load_tile<T, NO>(qt, q, p.qs.t, q0, p.Tq, p.D, 1.f);
  load_tile<T, NO>(gt, g, p.gs.t, q0, p.Tq, p.D, 1.f);
  const long long row_base = static_cast<long long>(bh) * p.Tq;
  float lse[4], delta[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lse[i] = row < p.Tq ? p.lse[row_base + row] : 0.f;
    delta[i] = row < p.Tq ? p.delta[row_base + row] : 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }
  const int nkv = live_kv_tiles(p, q0);
  for (int t = 0; t < nkv; ++t) {
    const int k0 = t * kTile;
    __syncthreads();
    load_tile<T, NO>(kt, k, p.ks.t, k0, p.Tk, p.D, 1.f);
    load_tile<T, NO>(vt, v, p.vs.t, k0, p.Tk, p.D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<NO>(s, qt, kt);
    tile_dot<NO>(dp, gt, vt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float ds = 0.f;
        if (live(p, row, col)) {
          const float pr = expf(s[i][j] * p.scale - lse[i]);
          ds = pr * (dp[i][j] - delta[i]) * p.scale;
        }
        dst[(ty + 16 * i) * kPLd + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_acc<NO>(acc, dst, kt);
  }

  T* dq = static_cast<T*>(p.dq) + b * p.dqs.b + h * p.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) dq[row * p.dqs.t + col] = from_float<T>(acc[i][c]);
    }
  }
}

// Grid (B*H, KV tiles), the longest causal tiles (the first) first.
// Thread rows here are KV rows and thread columns q rows.
template <typename T, int NO>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Params p) {
  extern __shared__ float smem[];
  constexpr int kF = Geom<NO>::kFloats;
  float* kt = smem;
  float* vt = kt + kF;
  float* qt = vt + kF;
  float* gt = qt + kF;
  float* pt = gt + kF;
  float* dst = pt + kTile * kPLd;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kv_tile = blockIdx.y;
  const int k0 = kv_tile * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h;
  const T* g = static_cast<const T*>(p.g) + b * p.gs.b + h * p.gs.h;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;
  load_tile<T, NO>(kt, k, p.ks.t, k0, p.Tk, p.D, 1.f);
  load_tile<T, NO>(vt, v, p.vs.t, k0, p.Tk, p.D, 1.f);
  const long long row_base = static_cast<long long>(bh) * p.Tq;
  float dk[4][NO], dv[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NO; ++c) dk[i][c] = dv[i][c] = 0.f;
  // causal: rows below k0 see none of this tile (tiles of q and KV align)
  const int nq = (p.Tq + kTile - 1) / kTile;
  for (int t = p.causal ? kv_tile : 0; t < nq; ++t) {
    const int q0 = t * kTile;
    __syncthreads();
    load_tile<T, NO>(qt, q, p.qs.t, q0, p.Tq, p.D, 1.f);
    load_tile<T, NO>(gt, g, p.gs.t, q0, p.Tq, p.D, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<NO>(s, kt, qt);
    tile_dot<NO>(dp, vt, gt);
    float lse[4], delta[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx + 16 * j;
      lse[j] = row < p.Tq ? p.lse[row_base + row] : 0.f;
      delta[j] = row < p.Tq ? p.delta[row_base + row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        float pr = 0.f, ds = 0.f;
        if (live(p, row, col)) {
          pr = expf(s[i][j] * p.scale - lse[j]);
          ds = pr * (dp[i][j] - delta[j]) * p.scale;
        }
        pt[(ty + 16 * i) * kPLd + tx + 16 * j] = pr;
        dst[(ty + 16 * i) * kPLd + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    tile_acc<NO>(dv, pt, gt);
    tile_acc<NO>(dk, dst, qt);
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dks.b + h * p.dks.h;
  T* dvp = static_cast<T*>(p.dv) + b * p.dvs.b + h * p.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const int col = tx + 16 * c;
      if (col < p.D) {
        dkp[row * p.dks.t + col] = from_float<T>(dk[i][c]);
        dvp[row * p.dvs.t + col] = from_float<T>(dv[i][c]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, int bh, int tiles,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NO>
constexpr size_t smem_bytes(int tiles, int ptiles) {
  return (tiles * Geom<NO>::kFloats + ptiles * kTile * kPLd) * sizeof(float);
}

// which: 0 forward, 1 dkdv, 2 dq.
template <typename T, typename TO, int NO>
cudaError_t dispatch(int which, const Params& p, int bh, int nq, int nkv,
                     cudaStream_t s) {
  switch (which) {
    case 0:
      return launch(flash_fwd<T, TO, NO>, p, bh, nq, smem_bytes<NO>(3, 1), s);
    case 1:
      return launch(flash_bwd_dkdv<T, NO>, p, bh, nkv, smem_bytes<NO>(4, 2),
                    s);
    default:
      return launch(flash_bwd_dq<T, NO>, p, bh, nq, smem_bytes<NO>(4, 1), s);
  }
}

template <typename T, typename TO>
cudaError_t dispatch_d(int which, const Params& p, int bh, int nq, int nkv,
                       cudaStream_t s) {
  if (p.D <= 16) return dispatch<T, TO, 1>(which, p, bh, nq, nkv, s);
  if (p.D <= 32) return dispatch<T, TO, 2>(which, p, bh, nq, nkv, s);
  if (p.D <= 64) return dispatch<T, TO, 4>(which, p, bh, nq, nkv, s);
  return dispatch<T, TO, 8>(which, p, bh, nq, nkv, s);
}

// shape = {B, H, Tq, Tk, D, causal}; strides: three (b, h, t) element
// strides for each of q, k, v, g, o, dq, dk, dv (unused ones ignored).
int run(int which, int dtype, int out_f32, int device, const long long* shape,
        const long long* strides, float scale, Params p, void* stream) {
  const long long B = shape[0], H = shape[1], Tq = shape[2], Tk = shape[3],
                  D = shape[4];
  if (B < 0 || H < 1 || Tq < 0 || Tk < 1 || D < 1 || D > 128 ||
      B * H > 0x7fffffffLL || Tq > 0x7fffffffLL || Tk > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nq = (Tq + kTile - 1) / kTile;
  const long long nkv = (Tk + kTile - 1) / kTile;
  if (nq > 65535 || nkv > 65535)  // grid.y
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Tq == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  View* views[8] = {&p.qs, &p.ks, &p.vs, &p.gs, &p.os, &p.dqs, &p.dks, &p.dvs};
  for (int i = 0; i < 8; ++i)
    *views[i] = View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  p.H = static_cast<int>(H);
  p.Tq = static_cast<int>(Tq);
  p.Tk = static_cast<int>(Tk);
  p.D = static_cast<int>(D);
  p.causal = shape[5] != 0;
  p.scale = scale;
  const int bh = static_cast<int>(B * H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        dispatch_d<float, float>(which, p, bh, nq, nkv, s));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_f32)
    return static_cast<int>(
        dispatch_d<__nv_bfloat16, float>(which, p, bh, nq, nkv, s));
  return static_cast<int>(
      dispatch_d<__nv_bfloat16, __nv_bfloat16>(which, p, bh, nq, nkv, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of q, k and v.  o is written
// in that type, or in float32 when out_f32 is set; lse (B, H, Tq) float32
// contiguous.  All launches go on `stream`, without synchronising, and
// return the cudaError_t of the launch.
extern "C" int mx_flash_fwd(int dtype, int out_f32, int device,
                            const long long* shape, const long long* strides,
                            float scale, const void* q, const void* k,
                            const void* v, void* o, float* lse,
                            void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse_out = lse;
  return run(0, dtype, out_f32, device, shape, strides, scale, p, stream);
}

// dk and dv from q, k, v, dO (g) in the type `dtype`, and the forward's
// lse and delta = rowsum(dO * O), (B, H, Tq) float32 contiguous.
extern "C" int mx_flash_bwd_dkdv(int dtype, int device, const long long* shape,
                                 const long long* strides, float scale,
                                 const void* q, const void* k, const void* v,
                                 const void* g, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return run(1, dtype, 0, device, shape, strides, scale, p, stream);
}

// dq, from the same inputs.
extern "C" int mx_flash_bwd_dq(int dtype, int device, const long long* shape,
                               const long long* strides, float scale,
                               const void* q, const void* k, const void* v,
                               const void* g, const float* lse,
                               const float* delta, void* dq, void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return run(2, dtype, 0, device, shape, strides, scale, p, stream);
}
