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
// not depend on the order in which blocks run (two runs agree bit for
// bit; so do two forward runs).
//
// Two routes by the inputs' dtype, for the forward and the backward.
//
// float32 (flash_fwd, flash_bwd_dkdv, flash_bwd_dq): every product
// accumulates in float32 FMA, a 4 x 4 register tile a thread over float32
// tiles in shared memory (the layout below); no tensor core and no TF32
// rounding.
//
// bfloat16 (flash_fwd_mma, flash_bwd_dkdv_mma, flash_bwd_dq_mma): the
// products run on the tensor cores, mma.sync m16n8k16 with bf16 operands
// and float32 sums, as the JAX function's float32 numbers allow:
//   - s = q.k^T and dp = dO.v^T have bf16 operands only; their products
//     are exact in float32, so the tensor cores change only the order of
//     the sum.  The scale is applied to s in float32 after the product
//     (for D = 64, scale = 1/8 and this is JAX's (q * scale).k^T exactly;
//     for other D it moves s by one float32 rounding).
//   - o = p.v, dv = p^T.dO, dk = ds^T.q and dq = ds.k have one float32
//     operand.  Each p or ds value enters as hi = bf16(x) and lo = bf16(x
//     - hi), two mma into one float32 sum: hi + lo is x to 2^-17 of it.
//     In the CPU emulations of tests/test_torch_flash_attention.py
//     (`_kernel_fwd`, `_kernel_bwd`) that puts o 0.95e-6 to 3.2e-6 of its
//     largest value from the Pallas kernel's float32 output, and dq, dk,
//     dv 1.7e-6 to 3.2e-6 from the JAX function's float32 backward,
//     inside the 1e-5 that the kernels are held to; one bf16 rounding of
//     p would put o 7.9e-4 away, and of p and ds the gradients 1.2e-3 to
//     2.4e-3.
//   - The online max and sum, exp, the rescale alpha, the -1e30 mask,
//     max(l, 1e-30), lse, p = exp(s * scale - lse) and ds = p (dp -
//     delta) scale stay float32, as in the JAX function.
//
// Bound.  At the TransformerLM's shape (B*H = 256, T = 1024, D = 64,
// causal) the forward does 34 GFLOP of products (52 with the split's
// second products) on 161 MiB of q, k, v (bf16), o (float32, kept for the
// backward) and lse: 204 FLOP a byte, under the card's 295, so it is
// bound by bytes (0.050 ms at 3.35 TB/s; 0.035 ms of products at the bf16
// tensor-core peak, 989 TFLOP/s).  dkdv does 69 GFLOP (103) on 194 MiB
// and dq 52 (69) on 162 MiB, bound by arithmetic (0.070 and 0.052 ms).
// Every (q, kv) tile of s, p and ds stays in registers and shared
// memory, never in device memory.
//
// Design of the bf16 kernels.  A block of 4 warps takes 64 q rows
// (forward, dq) or 64 KV rows (dkdv); each warp owns 16 of them and walks
// the other side's 64-row tiles.
//   - The forward holds Q as A fragments for the whole loop (re-read from
//     shared memory at D = 128) and takes each KV tile whole: S = Q.K^T
//     in 8 n8 tiles, the row max and sum in the accumulator layout (a
//     row's values sit in the 4 lanes of a quad), then O += P.V with P
//     from registers and V as B through ldmatrix.trans.
//   - dkdv computes the transposes S^T = K.Q^T and dP^T = V.dO^T in
//     16-row chunks, with K and V as A (held in registers for D <= 64)
//     and Q, dO as B.  P^T and dS^T then sit in the accumulator layout of
//     two n8 tiles, which is the A layout of one k16 step
//     (FlashAttention-2's register reuse): dV += P^T.dO and dK += dS^T.Q
//     take them from registers, with dO and Q as B through
//     ldmatrix.trans.  lse and delta belong to the q columns and come
//     with each Q tile.
//   - dq holds Q and dO as A fragments for the whole loop: S = Q.K^T,
//     dP = dO.V^T, then dQ += dS.K with K as B through ldmatrix.trans.
//   - Tiles sit in shared memory as bf16 rows of D rounded up to 16, 32,
//     64 or 128 (zeros past D), with 16 bytes of padding a row, so that
//     every ldmatrix row address is 16-byte aligned and the 8 rows of one
//     8x8 matrix fall in distinct banks.
//   - The streamed tiles (K, V for the forward and dq; Q, dO, lse, delta
//     for dkdv) load by cp.async into a ring of 2 stages: the next tile's
//     copies are in flight while this one multiplies.  16-byte copies
//     where the wrapper found every row start 16-byte aligned (vec16);
//     else element loads into the same ring.  Rows past Tq or Tk are
//     zero-filled.
//   - Causal: the forward and dq stop at live_kv_tiles, dkdv starts at the
//     diagonal tile; only a tile that holds a masked pair is masked, and a
//     warp skips a 16-wide chunk whose every pair is masked.
// ptxas (-Xptxas=-v, sm_90a, CUDA 12.8), no spills in any instance:
//   D <= 16, 32:  forward 128, 86 registers; dkdv 88, 137; dq 94, 104
//   D <= 64:      forward 128 registers, 46,080 B of shared memory: 4
//                 blocks (16 warps) an SM; dkdv 168, 56,320 B; dq 168,
//                 55,296 B: 3 blocks (12 warps) an SM, by registers
//   D <= 128:     forward 168, 87,040 B; dkdv 250, 105,472 B; dq 248,
//                 104,448 B: 2 blocks an SM
// (32, 8, 1024, 64) causal on an H100 80GB HBM3 at 700 W: forward 0.33
// ms, 105 TFLOP/s of products; dkdv 0.61 ms, dq 0.46 ms, 112-113 TFLOP/s
// (PERF.md, rows 5-5c).  The lever left is wgmma on warpgroups fed by
// TMA.
//
// Layout of the float32 kernels: a block of 256 threads
// takes a 64-row q tile (forward, dq) or a 64-row KV tile (dkdv).  Thread
// (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 i and columns tx + 16
// j of a (64, 64) score tile and columns tx + 16 c of a (64, D)
// accumulator.  Tiles sit in shared memory as float32 rows of D rounded
// up to 16, 32, 64 or 128, with one float of padding so that a row stride
// is odd: neighbouring lanes reading one column of neighbouring rows, or
// one row along d, hit distinct banks.  Each tile is read from device
// memory once per use, along d, and widened to float32 as it is stored;
// every ragged edge (rows past Tq or Tk, columns past D) is zero-filled on
// load and masked on store, with 64-bit offsets.  q, k, v, o, dO and the
// gradients are strided views (the model's heads are transposes of one
// (B, T, 3, H, D) product): the kernels take each tensor's batch, head
// and row strides, so the wrapper copies nothing.

#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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
  int vec;              // bf16 kernels: 16-byte copies (see load_tile_tc)
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

// ---------------------------------------------------------------------
// bf16 kernels on the tensor cores (dtype 1).  See the note at the top.

using mx::a_ptr;
using mx::b_ptr;
using mx::bf16;
using mx::bits;
using mx::cp_async16;
using mx::cp_async_commit;
using mx::cp_async_wait;
using mx::ldsm_x4;
using mx::ldsm_x4_t;
using mx::mma;
using mx::smem_u32;

constexpr int kWarpsTc = 4;               // each warp owns 16 rows of 64
constexpr int kThreadsTc = 32 * kWarpsTc;
constexpr int kStages = 2;                // ring of streamed tiles
static_assert(kThreadsTc == 2 * kTile, "load_stats: one value a thread");

template <int NO>
struct TcGeom {
  static constexpr int kDp = 16 * NO;     // D rounded up
  static constexpr int kLd = kDp + 8;     // bf16 a smem row: 16 bytes pad
  static constexpr int kElems = kTile * kLd;
  static constexpr size_t kTileBytes = kElems * sizeof(bf16);
  // dkdv: K, V, then a ring of (Q, dO) and of (lse, delta)
  static constexpr size_t kDkdvSmem =
      (2 + 2 * kStages) * kTileBytes + 2 * kStages * kTile * sizeof(float);
  // dq: Q, dO, then a ring of (K, V)
  static constexpr size_t kDqSmem = (2 + 2 * kStages) * kTileBytes;
  // forward: Q, then a ring of (K, V)
  static constexpr size_t kFwdSmem = (1 + 2 * kStages) * kTileBytes;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

// x = (x0, x1) as hi = bf16(x) and lo = bf16(x - hi); x - hi is exact in
// float32, so hi + lo is x to 2^-17 of it.
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The accumulator (C) layout of two adjacent n8 tiles, c[j][e] at row
// g + 8 (e / 2), column 8 j + 2 t + e % 2, is the A layout of one k16
// step: hi and lo A fragments of its values.
__device__ __forceinline__ void split_a(const float (&c)[2][4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(c[0][0], c[0][1], hi[0], lo[0]);
  split(c[0][2], c[0][3], hi[1], lo[1]);
  split(c[1][0], c[1][1], hi[2], lo[2]);
  split(c[1][2], c[1][3], hi[3], lo[3]);
}

// Rows [r0, r0 + 64) of a (rows, D) matrix with row stride st into
// dst[row][d]; zero where the row or d is out of range.  vec: 16-byte
// asynchronous copies (the wrapper found src, every stride and D
// multiples of 16 bytes); else element loads, stored before return.
template <int NO>
__device__ __forceinline__ void load_tile_tc(bf16* dst, const bf16* src,
                                             long long st, int r0, int rows,
                                             int D, bool vec) {
  constexpr int kDp = TcGeom<NO>::kDp, kLd = TcGeom<NO>::kLd;
  if (vec) {
    constexpr int kChunks = kDp / 8;
    for (int i = threadIdx.x; i < kTile * kChunks; i += kThreadsTc) {
      const int r = i / kChunks, d = (i % kChunks) * 8;
      bf16* out = dst + r * kLd + d;
      if (d < D) {
        const bool in = r0 + r < rows;
        cp_async16(out, in ? src + static_cast<long long>(r0 + r) * st + d
                           : src, in);
      } else {
        *reinterpret_cast<uint4*>(out) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kDp; i += kThreadsTc) {
      const int r = i / kDp, d = i % kDp;
      bf16 val = __float2bfloat16(0.f);
      if (r0 + r < rows && d < D)
        val = src[static_cast<long long>(r0 + r) * st + d];
      dst[r * kLd + d] = val;
    }
  }
}

// lse and delta of q rows [q0, q0 + 64) into ls[64] and ds[64] (0 past
// Tq), one float a thread.
__device__ __forceinline__ void load_stats(float* ls, float* ds,
                                           const Params& p,
                                           long long row_base, int q0) {
  const int r = threadIdx.x & 63;
  const bool in = q0 + r < p.Tq;
  const float* src = threadIdx.x < 64 ? p.lse : p.delta;
  cp_async4((threadIdx.x < 64 ? ls : ds) + r,
            src + row_base + (in ? q0 + r : 0), in);
}

// A warp's 16 rows of accumulators (2 NO n8 tiles) into rows [row0, row0
// + 16) of a (rows, D) matrix with row stride st, in the type TO.
template <int NO, typename TO>
__device__ __forceinline__ void store_rows(TO* out, long long st,
                                           const float (&acc)[2 * NO][4],
                                           int row0, int rows, int D) {
  const int g = (threadIdx.x & 31) >> 2, t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e >> 1), col = 8 * n + 2 * t4 + (e & 1);
      if (row < rows && col < D)
        out[static_cast<long long>(row) * st + col] =
            from_float<TO>(acc[n][e]);
    }
}

// The forward.  Grid (B*H, q tiles), the longest causal tiles first.  Warp
// w owns q rows q0 + 16 w .. + 15, with the A fragments of Q in registers
// for the whole loop (D <= 64; re-read from shared memory at D = 128),
// and takes each 64-row KV tile whole: S = Q.K^T (K as B) into 8 n8
// tiles, scaled and masked in float32; the online max and sum over the
// accumulator layout, where a row's 64 values sit in the 4 lanes of a
// quad; then O += P.V with P from registers as hi + lo A fragments and V
// as B through ldmatrix.trans.  Each lane keeps a partial sum l of its
// own columns (every lane of a quad rescales by the same alpha); the
// quad's partials meet once, at the end.
template <int NO, typename TO>
__global__ void __launch_bounds__(kThreadsTc) flash_fwd_mma(Params p) {
  using G = TcGeom<NO>;
  constexpr int kLd = G::kLd;
  constexpr bool kHold = NO <= 4;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qt = reinterpret_cast<bf16*>(smem_tc);
  bf16* kt = qt + G::kElems;             // [kStages] tiles
  bf16* vt = kt + kStages * G::kElems;   // [kStages] tiles
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_row0 = q0 + 16 * warp;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const bool vec = p.vec;
  const int nkv = live_kv_tiles(p, q0);

  load_tile_tc<NO>(qt, q, p.qs.t, q0, p.Tq, p.D, vec);
  cp_async_commit();
  load_tile_tc<NO>(kt, k, p.ks.t, 0, p.Tk, p.D, vec);
  load_tile_tc<NO>(vt, v, p.vs.t, 0, p.Tk, p.D, vec);
  cp_async_commit();
  cp_async_wait<1>();  // Q
  __syncthreads();
  uint32_t qf[kHold ? NO : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < NO; ++kk)
      ldsm_x4(qf[kk], a_ptr<kLd>(qt, 16 * warp, 16 * kk));
  }
  float o[2 * NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int t = 0; t < nkv; ++t) {
    const int stage = t & 1;
    if (t + 1 < nkv) {  // the next tile loads while this one multiplies
      const int nxt = stage ^ 1;
      load_tile_tc<NO>(kt + nxt * G::kElems, k, p.ks.t, (t + 1) * kTile,
                       p.Tk, p.D, vec);
      load_tile_tc<NO>(vt + nxt * G::kElems, v, p.vs.t, (t + 1) * kTile,
                       p.Tk, p.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kTile;
    const bf16* ks = kt + stage * G::kElems;
    const bf16* vs = vt + stage * G::kElems;
    // warp-uniform: chunks [0, nc) of 16 keys hold every live key of the
    // warp's rows (causal: none past its last row); 0 for a warp past Tq
    int end = min(p.Tk, k0 + kTile);
    if (p.causal) end = min(end, q_row0 + 16);
    const int nc = q_row0 < p.Tq ? max(0, (end - k0 + 15) >> 4) : 0;
    if (nc > 0) {
      float s[4][2][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[c][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NO; ++kk) {
        uint32_t a[4];
        if constexpr (kHold) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qf[kk][r];
        } else {
          ldsm_x4(a, a_ptr<kLd>(qt, 16 * warp, 16 * kk));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < nc) {
            uint32_t bk[4];
            ldsm_x4(bk, b_ptr<kLd>(ks, 16 * c, 16 * kk));
            mma(s[c][0], a, bk[0], bk[1]);
            mma(s[c][1], a, bk[2], bk[3]);
          }
        }
      }
      // s = (q.k^T) * scale, -1e30 where masked; only a tile that holds
      // a key past Tk or (causal) past the warp's first row needs the mask
      const bool edge =
          k0 + kTile > p.Tk || (p.causal && k0 + kTile - 1 > q_row0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[c][j][e] * p.scale;
            if (c >= nc) {
              x = kNegInf;
            } else if (edge) {
              const int col = k0 + 16 * c + 8 * j + 2 * t4 + (e & 1);
              const int row = q_row0 + g + 8 * (e >> 1);
              if (col >= p.Tk || (p.causal && col > row)) x = kNegInf;
            }
            s[c][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < nc) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float pr = expf(s[c][j][e] - m[e >> 1]);
              s[c][j][e] = pr;
              l[e >> 1] += pr;
            }
          uint32_t ph[4], pl[4];
          split_a(s[c], ph, pl);
#pragma unroll
          for (int n = 0; n < NO; ++n) {
            uint32_t bv[4];
            ldsm_x4_t(bv, a_ptr<kLd>(vs, 16 * c, 16 * n));
            mma(o[2 * n], ph, bv[0], bv[1]);
            mma(o[2 * n], pl, bv[0], bv[1]);
            mma(o[2 * n + 1], ph, bv[2], bv[3]);
            mma(o[2 * n + 1], pl, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] /= den[e >> 1];
  store_rows<NO>(static_cast<TO*>(p.o) + b * p.os.b + h * p.os.h, p.os.t, o,
                 q_row0, p.Tq, p.D);
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q_row0 + g + 8 * i;
      if (row < p.Tq)
        p.lse_out[static_cast<long long>(bh) * p.Tq + row] =
            m[i] + logf(den[i]);
    }
  }
}

// dk and dv.  Grid (B*H, KV tiles), the longest causal tiles (the first)
// first.  Warp w owns KV rows k0 + 16 w .. + 15 and takes each 64-row q
// tile in four 16-row chunks: S^T = K.Q^T and dP^T = V.dO^T (K, V as A,
// Q, dO as B), then P^T, dS^T from registers as A for dV += P^T.dO and
// dK += dS^T.Q (dO, Q as B through ldmatrix.trans).  For D <= 64 the A
// fragments of K and V stay in registers for the whole loop.
template <int NO>
__global__ void __launch_bounds__(kThreadsTc) flash_bwd_dkdv_mma(Params p) {
  using G = TcGeom<NO>;
  constexpr int kLd = G::kLd;
  constexpr bool kHold = NO <= 4;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* kt = reinterpret_cast<bf16*>(smem_tc);
  bf16* vt = kt + G::kElems;
  bf16* qt = vt + G::kElems;             // [kStages] tiles
  bf16* gt = qt + kStages * G::kElems;   // [kStages] tiles
  float* lse_s = reinterpret_cast<float*>(gt + kStages * G::kElems);
  float* delta_s = lse_s + kStages * kTile;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kv_tile = blockIdx.y, k0 = kv_tile * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv_row0 = k0 + 16 * warp;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* dO = static_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const long long row_base = static_cast<long long>(bh) * p.Tq;
  const bool vec = p.vec;
  const int nq = (p.Tq + kTile - 1) / kTile;
  // causal: rows below k0 see none of this tile (tiles of q and KV align)
  const int t0 = p.causal ? kv_tile : 0;

  load_tile_tc<NO>(kt, k, p.ks.t, k0, p.Tk, p.D, vec);
  load_tile_tc<NO>(vt, v, p.vs.t, k0, p.Tk, p.D, vec);
  cp_async_commit();
  if (t0 < nq) {
    load_tile_tc<NO>(qt, q, p.qs.t, t0 * kTile, p.Tq, p.D, vec);
    load_tile_tc<NO>(gt, dO, p.gs.t, t0 * kTile, p.Tq, p.D, vec);
    load_stats(lse_s, delta_s, p, row_base, t0 * kTile);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K and V
  __syncthreads();
  uint32_t kf[kHold ? NO : 1][4], vf[kHold ? NO : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < NO; ++kk) {
      ldsm_x4(kf[kk], a_ptr<kLd>(kt, 16 * warp, 16 * kk));
      ldsm_x4(vf[kk], a_ptr<kLd>(vt, 16 * warp, 16 * kk));
    }
  }

  float dk[2 * NO][4], dv[2 * NO][4];
#pragma unroll
  for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t = t0; t < nq; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < nq) {  // the next tile loads while this one multiplies
      const int nxt = stage ^ 1;
      load_tile_tc<NO>(qt + nxt * G::kElems, q, p.qs.t, (t + 1) * kTile,
                       p.Tq, p.D, vec);
      load_tile_tc<NO>(gt + nxt * G::kElems, dO, p.gs.t, (t + 1) * kTile,
                       p.Tq, p.D, vec);
      load_stats(lse_s + nxt * kTile, delta_s + nxt * kTile, p, row_base,
                 (t + 1) * kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = t * kTile;
    const bf16* qs = qt + stage * G::kElems;
    const bf16* gs = gt + stage * G::kElems;
    const float* ls = lse_s + stage * kTile;
    const float* dls = delta_s + stage * kTile;
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const int qc0 = q0 + 16 * c;
      // warp-uniform: the chunk holds no q row, or (causal) every q row
      // of it lies above every KV row of the warp
      if (kv_row0 >= p.Tk || qc0 >= p.Tq) break;
      if (p.causal && qc0 + 15 < kv_row0) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NO; ++kk) {
        uint32_t bq[4], bg[4];
        ldsm_x4(bq, b_ptr<kLd>(qs, 16 * c, 16 * kk));
        ldsm_x4(bg, b_ptr<kLd>(gs, 16 * c, 16 * kk));
        if constexpr (kHold) {
          mma(s[0], kf[kk], bq[0], bq[1]);
          mma(s[1], kf[kk], bq[2], bq[3]);
          mma(dp[0], vf[kk], bg[0], bg[1]);
          mma(dp[1], vf[kk], bg[2], bg[3]);
        } else {
          uint32_t a[4];
          ldsm_x4(a, a_ptr<kLd>(kt, 16 * warp, 16 * kk));
          mma(s[0], a, bq[0], bq[1]);
          mma(s[1], a, bq[2], bq[3]);
          ldsm_x4(a, a_ptr<kLd>(vt, 16 * warp, 16 * kk));
          mma(dp[0], a, bg[0], bg[1]);
          mma(dp[1], a, bg[2], bg[3]);
        }
      }
      // s, dp hold S^T, dP^T: row = KV row, column = q row
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 16 * c + 8 * j + 2 * t4 + (e & 1);
          float pr = 0.f, ds = 0.f;
          if (live(p, q0 + qc, kv_row0 + g + 8 * (e >> 1))) {
            pr = expf(s[j][e] * p.scale - ls[qc]);
            ds = pr * (dp[j][e] - dls[qc]) * p.scale;
          }
          s[j][e] = pr;
          dp[j][e] = ds;
        }
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_a(s, ph, pl);
      split_a(dp, dh, dl);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bo[4];
        ldsm_x4_t(bo, a_ptr<kLd>(gs, 16 * c, 16 * n));
        mma(dv[2 * n], ph, bo[0], bo[1]);
        mma(dv[2 * n], pl, bo[0], bo[1]);
        mma(dv[2 * n + 1], ph, bo[2], bo[3]);
        mma(dv[2 * n + 1], pl, bo[2], bo[3]);
        ldsm_x4_t(bo, a_ptr<kLd>(qs, 16 * c, 16 * n));
        mma(dk[2 * n], dh, bo[0], bo[1]);
        mma(dk[2 * n], dl, bo[0], bo[1]);
        mma(dk[2 * n + 1], dh, bo[2], bo[3]);
        mma(dk[2 * n + 1], dl, bo[2], bo[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

  store_rows<NO>(static_cast<bf16*>(p.dk) + b * p.dks.b + h * p.dks.h,
                 p.dks.t, dk, kv_row0, p.Tk, p.D);
  store_rows<NO>(static_cast<bf16*>(p.dv) + b * p.dvs.b + h * p.dvs.h,
                 p.dvs.t, dv, kv_row0, p.Tk, p.D);
}

// dq.  Grid (B*H, q tiles), the longest causal tiles first.  Warp w owns
// q rows q0 + 16 w .. + 15, with its A fragments of Q and dO in registers
// for the whole loop, and takes each 64-row KV tile in four 16-row
// chunks: S = Q.K^T and dP = dO.V^T (K, V as B), then dS from registers
// as A for dQ += dS.K (K as B through ldmatrix.trans).
template <int NO>
__global__ void __launch_bounds__(kThreadsTc) flash_bwd_dq_mma(Params p) {
  using G = TcGeom<NO>;
  constexpr int kLd = G::kLd;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* qt = reinterpret_cast<bf16*>(smem_tc);
  bf16* gt = qt + G::kElems;
  bf16* kt = gt + G::kElems;             // [kStages] tiles
  bf16* vt = kt + kStages * G::kElems;   // [kStages] tiles
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int nq = (p.Tq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q_row0 = q0 + 16 * warp;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* dO = static_cast<const bf16*>(p.g) + b * p.gs.b + h * p.gs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + h * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + h * p.vs.h;
  const bool vec = p.vec;
  const int nkv = live_kv_tiles(p, q0);

  load_tile_tc<NO>(qt, q, p.qs.t, q0, p.Tq, p.D, vec);
  load_tile_tc<NO>(gt, dO, p.gs.t, q0, p.Tq, p.D, vec);
  cp_async_commit();
  load_tile_tc<NO>(kt, k, p.ks.t, 0, p.Tk, p.D, vec);
  load_tile_tc<NO>(vt, v, p.vs.t, 0, p.Tk, p.D, vec);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  uint32_t qf[NO][4], gf[NO][4];
#pragma unroll
  for (int kk = 0; kk < NO; ++kk) {
    ldsm_x4(qf[kk], a_ptr<kLd>(qt, 16 * warp, 16 * kk));
    ldsm_x4(gf[kk], a_ptr<kLd>(gt, 16 * warp, 16 * kk));
  }
  const long long row_base = static_cast<long long>(bh) * p.Tq;
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q_row0 + g + 8 * i;
    lse[i] = row < p.Tq ? p.lse[row_base + row] : 0.f;
    delta[i] = row < p.Tq ? p.delta[row_base + row] : 0.f;
  }
  float dq[2 * NO][4];
#pragma unroll
  for (int n = 0; n < 2 * NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int t = 0; t < nkv; ++t) {
    const int stage = t & 1;
    if (t + 1 < nkv) {  // the next tile loads while this one multiplies
      const int nxt = stage ^ 1;
      load_tile_tc<NO>(kt + nxt * G::kElems, k, p.ks.t, (t + 1) * kTile,
                       p.Tk, p.D, vec);
      load_tile_tc<NO>(vt + nxt * G::kElems, v, p.vs.t, (t + 1) * kTile,
                       p.Tk, p.D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kTile;
    const bf16* ks = kt + stage * G::kElems;
    const bf16* vs = vt + stage * G::kElems;
#pragma unroll 1
    for (int c = 0; c < 4; ++c) {
      const int kc0 = k0 + 16 * c;
      // warp-uniform: the chunk holds no key, or (causal) every key of
      // it lies past every q row of the warp, and so do the next chunks
      if (q_row0 >= p.Tq || kc0 >= p.Tk) break;
      if (p.causal && kc0 > q_row0 + 15) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NO; ++kk) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_ptr<kLd>(ks, 16 * c, 16 * kk));
        ldsm_x4(bv, b_ptr<kLd>(vs, 16 * c, 16 * kk));
        mma(s[0], qf[kk], bk[0], bk[1]);
        mma(s[1], qf[kk], bk[2], bk[3]);
        mma(dp[0], gf[kk], bv[0], bv[1]);
        mma(dp[1], gf[kk], bv[2], bv[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float ds = 0.f;
          if (live(p, q_row0 + g + 8 * i, kc0 + 8 * j + 2 * t4 + (e & 1))) {
            const float pr = expf(s[j][e] * p.scale - lse[i]);
            ds = pr * (dp[j][e] - delta[i]) * p.scale;
          }
          dp[j][e] = ds;
        }
      uint32_t dh[4], dl[4];
      split_a(dp, dh, dl);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bk[4];
        ldsm_x4_t(bk, a_ptr<kLd>(ks, 16 * c, 16 * n));
        mma(dq[2 * n], dh, bk[0], bk[1]);
        mma(dq[2 * n], dl, bk[0], bk[1]);
        mma(dq[2 * n + 1], dh, bk[2], bk[3]);
        mma(dq[2 * n + 1], dl, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it reloads
  }

  store_rows<NO>(static_cast<bf16*>(p.dq) + b * p.dqs.b + h * p.dqs.h,
                 p.dqs.t, dq, q_row0, p.Tq, p.D);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NO>
constexpr size_t smem_bytes(int tiles, int ptiles) {
  return (tiles * Geom<NO>::kFloats + ptiles * kTile * kPLd) * sizeof(float);
}

// f(std::integral_constant<int, NO>()) for the least NO in {1, 2, 4, 8}
// with 16 NO >= D.
template <typename F>
cudaError_t by_width(int D, F f) {
  if (D <= 16) return f(std::integral_constant<int, 1>());
  if (D <= 32) return f(std::integral_constant<int, 2>());
  if (D <= 64) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

// which: 0 forward, 1 dkdv, 2 dq.  float32 inputs run the FMA kernels,
// bfloat16 inputs the tensor-core kernels.
template <typename T, typename TO>
cudaError_t dispatch(int which, const Params& p, int bh, int nq, int nkv,
                     cudaStream_t s) {
  return by_width(p.D, [&](auto no) {
    constexpr int NO = decltype(no)::value;
    if constexpr (std::is_same<T, float>::value) {
      if (which == 0)
        return launch(flash_fwd<float, float, NO>, p, dim3(bh, nq), kThreads,
                      smem_bytes<NO>(3, 1), s);
      if (which == 1)
        return launch(flash_bwd_dkdv<float, NO>, p, dim3(bh, nkv), kThreads,
                      smem_bytes<NO>(4, 2), s);
      return launch(flash_bwd_dq<float, NO>, p, dim3(bh, nq), kThreads,
                    smem_bytes<NO>(4, 1), s);
    } else {
      if (which == 0)
        return launch(flash_fwd_mma<NO, TO>, p, dim3(bh, nq), kThreadsTc,
                      TcGeom<NO>::kFwdSmem, s);
      if (which == 1)
        return launch(flash_bwd_dkdv_mma<NO>, p, dim3(bh, nkv), kThreadsTc,
                      TcGeom<NO>::kDkdvSmem, s);
      return launch(flash_bwd_dq_mma<NO>, p, dim3(bh, nq), kThreadsTc,
                    TcGeom<NO>::kDqSmem, s);
    }
  });
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
        dispatch<float, float>(which, p, bh, nq, nkv, s));
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (out_f32)
    return static_cast<int>(
        dispatch<__nv_bfloat16, float>(which, p, bh, nq, nkv, s));
  return static_cast<int>(
      dispatch<__nv_bfloat16, __nv_bfloat16>(which, p, bh, nq, nkv, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, the type of q, k and v.  o is written
// in that type, or in float32 when out_f32 is set; lse (B, H, Tq) float32
// contiguous.  vec16: q, k and v each start on 16 bytes and have (b, h, t)
// strides and D that are multiples of 8 elements, so the bfloat16 kernels
// copy rows 16 bytes at a time; float32 ignores it.  All launches go on
// `stream`, without synchronising, and return the cudaError_t of the
// launch.
extern "C" int mx_flash_fwd(int dtype, int out_f32, int vec16, int device,
                            const long long* shape, const long long* strides,
                            float scale, const void* q, const void* k,
                            const void* v, void* o, float* lse,
                            void* stream) {
  Params p{};
  p.vec = vec16;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse_out = lse;
  return run(0, dtype, out_f32, device, shape, strides, scale, p, stream);
}

// dk and dv from q, k, v, dO (g) in the type `dtype`, and the forward's
// lse and delta = rowsum(dO * O), (B, H, Tq) float32 contiguous.  vec16
// as for the forward, over q, k, v and g.
extern "C" int mx_flash_bwd_dkdv(int dtype, int vec16, int device,
                                 const long long* shape,
                                 const long long* strides, float scale,
                                 const void* q, const void* k, const void* v,
                                 const void* g, const float* lse,
                                 const float* delta, void* dk, void* dv,
                                 void* stream) {
  Params p{};
  p.vec = vec16;
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
extern "C" int mx_flash_bwd_dq(int dtype, int vec16, int device,
                               const long long* shape,
                               const long long* strides, float scale,
                               const void* q, const void* k, const void* v,
                               const void* g, const float* lse,
                               const float* delta, void* dq, void* stream) {
  Params p{};
  p.vec = vec16;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return run(2, dtype, 0, device, shape, strides, scale, p, stream);
}
