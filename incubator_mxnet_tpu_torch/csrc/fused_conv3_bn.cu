// Fused 3x3 convolution (stride 1, pad 1, NHWC) with BatchNorm, written
// for Hopper (sm_90a): forward, dx and dw.
//
// Replaces the four Pallas TPU kernels of
// incubator_mxnet_tpu/ops/fused_conv.py:
//
//   forward  `_fwd_kernel` (:139), launched by `_fwd_impl` (:350):
//       xn = [relu(x*scale + bias)]              float32, rounded to T
//       y[r, o] = sum_t sum_c valid_t(r) * xn[r + off_t, c] * W[t, c, o]
//       s1 = sum_M y,  s2 = sum_M y^2            float32, from y rounded
//   dx       `_bwd_dx_kernel` (:217), launched by `_bwd_impl` (:399), and
//            `_bwd_dx_kernel_nb` (:180), its split over C_out (:426):
//       dyt = dy + ds1 + 2*y*ds2                 float32, rounded to T
//       dxn[r, c] = sum_t sum_o valid_t(r - off_t) * dyt[r - off_t, o]
//                   * W[t, c, o]
//       with the prologue: z = x*scale + bias, dz = dxn * [z > 0],
//       dx = dz*scale, dscale = sum_M dz*x, dbias = sum_M dz;
//       without it dx = dxn
//   dw       `_bwd_dw_kernel` (:244), launched by `_bwd_impl` (:445):
//       dw[t, c, o] = sum_r valid_t(r) * xn[r + off_t, c] * dyt[r, o]
//
// Rows r run over the flattened N*H*W pixels, x is (M, C), W the HWIO
// kernel (3, 3, C, C_out) read as (9, C, C_out), and tap t = 3*(dh+1) +
// (dw+1) for dh, dw in {-1, 0, 1}, off_t = dh*W + dw.  valid_t(r) says
// that pixel r's neighbour (h + dh, w + dw) lies in r's own image; it is
// computed from each row's own (h, w), never from flat-row neighbours
// (the row after an image's last pixel is the next image's first).  An
// out-of-image neighbour contributes 0: the mask applies after the
// prologue, as the TPU kernel masks the prologue's output, so the zero
// padding is of the normalized input, not relu(bias).
//
// Numerics follow the TPU kernels and csrc/fused_matmul_bn.cu: operands
// in the input type T (float32 or bfloat16), the prologue and dyt
// computed in float32 with __fmul_rn/__fadd_rn (no FMA contraction, so
// they round as PyTorch's two ops do) and rounded to T before the
// product, products accumulated in float32, statistics from y after it
// is rounded to T.  Every load and store masks its ragged edge; no
// padded copy of any operand exists in device memory.
//
// The float32 forward and dx are implicit matrix products over the
// shifted taps,
//   forward  C (M, C_out)   = A (M, 9*C)     @ B (9*C, C_out)
//   dx       C (M, C)       = A (M, 9*C_out) @ B (9*C_out, C)
// with the shift, the image mask, the prologue and dyt applied as A and
// B are staged.  The tile loop is the one of csrc/fused_matmul_bn.cu: a
// block of 256 threads owns a 128x128 tile of C, each thread an 8x8
// sub-tile in registers, the depth staged through shared memory 8 at a
// time with the next slice's loads in flight.  dx sums over all 9*C_out
// taps and channels in one block, so the ReLU/normalize backward sees the
// total dxn: the TPU kernel's split over C_out (kernel 15, a VMEM limit)
// has no counterpart.
//
// Sums across M.  Blocks run in no order, so the forward and dx write one
// float32 partial row per block of 128 rows (s1/s2, dscale/dbias), and dw
// (both dtypes, below) splits the pixels into runs that each write a
// float32 partial of the whole (9*C, C_out) gradient; the wrapper sums
// them in a fixed order.  No atomics: the result is the same from run to
// run.
//
// Bound.  Each kernel does 2*M*9*C*C_out operations.  At ResNet-50's
// 3x3 shapes at B=128 (M = 401,408 rows at 64 channels down to 6,272 at
// 512) that is 29.6 GFLOP a launch, 0.44 ms at the card's 67 TFLOP/s of
// float32 FMA outside the tensor cores, while the bytes (x, y, dy, the
// 73 KB to 9.4 MB kernel) take at most 0.12 ms at 3.35 TB/s: in float32
// on the FMA units every launch is bound by operations.  The float32 dw
// runs on the tensor cores in three tf32 products (below): 3 x 29.6
// GFLOP, 0.179 ms at 495 TFLOP/s, still above its bytes (0.092 ms at
// stage 1).  In bfloat16 the tensor cores' 989 TFLOP/s bound it by bytes
// at stage 1 (dw: 154 MB, 0.046 ms, against 0.030 ms of operations) and
// by operations at stages 2-4; the FMA loop reaches neither.  Only the
// float32 forward and dx run it; implicit GEMM on wgmma with TMA-fed
// halo tiles is later work for them.  Every bfloat16 kernel runs on the
// tensor cores (below).
//
// The bf16 dw (fused_conv3_bn_dw_mma) replaces the same TPU kernel,
// `_bwd_dw_kernel` (:244), on the tensor cores.  The TPU kernel rounds
// both operands to the input type before its product (the prologue's
// relu(x*scale + bias) and dyt), and the product of two bf16 values is
// exact in float32, so mma.sync.m16n8k16 on bf16 with float32 sums gives
// the FMA tile's numbers up to the order of the sums.  The design takes
// the 3x3 geometry out of the inner loop, where the FMA tile spends
// integer divisions and a masked scalar load on each of A's elements,
// nine times for each x value:
//   - A block owns the float32 sums of the three taps (dw = -1, 0, 1) of
//     one kernel row dh for a 64 x 64 tile of (c, o); 8 warps, each 16 c
//     x 32 o x 3 taps.  The grid is (3 * tiles of (c, o), runs of
//     stages), the three dh of a tile side by side, so that they read
//     the same rows of y and dy while L2 holds them.
//   - The pixels are walked in segments of an image row, at most 62
//     wide (a whole row up to W = 62), and a stage holds as many
//     segments as fit in 64 positions, each segment as its pixels with
//     one halo position on either side.  dyt is staged at a segment's
//     pixels and 0 at its halo positions; xn, of image row h + dh, at
//     every position (0 outside the image).  So the three taps are three
//     row offsets into one xn tile, and a tap's product over a
//     segment's positions sums exactly the pixels whose neighbour lies
//     in the image: no mask and no index arithmetic per element.
//   - The raw rows of x, y and dy go by cp.async (16 bytes a copy,
//     zeros where a chunk lies outside) into a ring of three raw stages,
//     two stages ahead of the product, so that loads stay in flight
//     without holding registers (126 a thread: two blocks an SM).  Each
//     thread stages the chunks it copied: the prologue and dyt applied
//     in float32 with __fmul_rn/__fadd_rn, rounded to bf16 and stored as
//     [position][channel] tiles whose rows are padded by 16 bytes, so
//     that ldmatrix rows fall on distinct banks.  Both operands come
//     from their tiles by ldmatrix.trans; dyt's fragments are shared by
//     the three taps.  Where a start is not 16-byte aligned or C (C_out)
//     is not a multiple of 8, the rows of x (y and dy) load element by
//     element.
//   - Each run writes its float32 (9*C, C_out) partial; the wrapper sums
//     the runs in a fixed order.  No atomics: the same bits every run.
//
// The float32 dw (fused_conv3_bn_dw_tf32) replaces the same TPU kernel
// on the tensor cores, on the bf16 tile's walk, grid and runs, keeping
// float32 numbers.  The TPU kernel multiplies float32 operands
// unrounded, and one tf32 or bf16 pass keeps about three digits, so
// each operand is split into tf32 hi = rna(v) and lo = rna(v - hi)
// (mma.cuh: split_tf32), and three mma.sync.m16n8k8 tf32 products,
// lo.hi + hi.lo + hi.hi, go into float32 sums: about 2^-21 of each
// product.  The tensor core truncates each sum it returns, so a tap's
// products go into a part that starts at 0 each stage (24 products a
// chain), added to the run's sum rounded to nearest: one register for
// all of a run's products drifted past the float32 tolerance at
// ResNet-50's shapes (phase 3 of chip_smoke.py compares them).  The FMA
// tile it replaces
// spent an integer division and a masked scalar load on each of A's
// elements and ran 2.1x slower than its plain version.
//   - The raw rows of x, y and dy go by cp.async (16 bytes, zeros
//     outside; element loads where a start is unaligned or C (C_out) is
//     not a multiple of 4) straight into a ring slot laid out as the
//     operand tiles: x one row below its position (a zero guard row
//     either side), y and dy at their position.  Each thread applies the
//     prologue in place to the x chunks it copied (0 outside the image)
//     and turns its y and dy chunks into dyt (0 at the halo), in float32
//     with __fmul_rn/__fadd_rn, split into tf32 hi and lo in place of dy
//     and y; one barrier a stage publishes the slot.  So shared memory
//     holds one float32 tile per operand a stage and no separate operand
//     buffers: 55,872 bytes a slot; a ring of two, one stage loading
//     while one multiplies, at two blocks an SM (112,768 bytes a block).
//   - The tiles' row strides are 8 mod 32 floats, so the 32-bit fragment
//     loads (a lane reads row t, column g) fall on 32 distinct banks; the
//     three taps read the x tile at row offsets 0, 1, 2 as in bf16,
//     splitting x as its fragment is loaded, and read dyt's parts as
//     they lie (one split for the three taps).
//
// The bf16 forward (fused_conv3_bn_fwd_mma) replaces `_fwd_kernel`
// (:139) on the tensor cores, on the same walk of the pixels, with the
// product turned around: the FMA tile loaded, masked, normalised and
// rounded each x value nine times, with a division for tap and channel
// on each.  Each launch is 29.6 GFLOP at ResNet-50's shapes (0.030 ms at
// 989 TFLOP/s, about what x, W and y take at 3.35 TB/s at stage 1).
//   - A block owns 64 positions (one stage) x 64 output channels (128
//     where C_out > 64) and walks a run of stages; 8 warps, each 16 or
//     32 positions x 32 channels.  A stage's depth runs in steps (dh,
//     chunk of channels): xn of image row h + dh is staged as a bf16
//     [position][channel] tile one row below its position (a zero guard
//     row either side; 0 outside the image, the halo holding the real
//     neighbour where a row takes several segments), so that the three
//     taps dw = -1, 0, 1 are A at row offsets 0, 1, 2 by ldmatrix, and B
//     is W[3 (dh + 1) + dw]'s [c][o] chunk by ldmatrix.trans.  No mask
//     and no index arithmetic per element.
//   - Raw x rows go by cp.async (16 bytes, zeros outside; element loads
//     where a start is unaligned or C is not a multiple of 8) into a ring
//     of three steps, two ahead of the product; each thread applies the
//     prologue in place to the chunks it copied, once for each copy, and
//     one barrier a step publishes the tile.  Where C <= 64 the block's
//     whole W slice (3 x 3 x 64 x 64 bf16, 74 KB padded to 83) stays in
//     shared memory for its run; else W streams with x by chunks of 32
//     channels (C > 64 means every kernel row reads W anew from L2 a
//     stage: about as many bytes as x).
//   - The epilogue rounds y to bf16, stores it at the segments' own
//     pixels (a halo position's result and those past the segments are
//     dropped) and adds the rounded values to float32 column sums held in
//     registers for the run; these are reduced by shuffles, then across
//     the warps in order, into one partial row of s1 and s2 a run, which
//     the wrapper sums in a fixed order.  No atomics.
//
// The bf16 dx (fused_conv3_bn_dx_mma) replaces `_bwd_dx_kernel` (:217)
// and its split over C_out `_bwd_dx_kernel_nb` (:180) on the tensor
// cores, on the forward's walk with the product turned around: the FMA
// tile divided for tap and channel, masked and turned each dy/y value
// into dyt at each of its nine reads.  Each launch is 29.6 GFLOP at
// ResNet-50's shapes; stage 1 must move x, y, dy and dx (0.061 ms at
// 3.35 TB/s).
//   - A block owns 64 positions (one stage) x 64 input channels c (128
//     where C > 64) and walks a run of stages; 8 warps, each 16 or 32
//     positions x 32 channels.  A stage's depth runs in steps (dh, chunk
//     of output channels o: all of them where C and Co <= 64, else 32):
//     dyt of image row h - dh is staged as a
//     bf16 [position][o] tile one row below its position (a zero guard
//     row either side; 0 outside the image, the halo holding the real
//     neighbour where a row takes several segments), so that tap dw,
//     which reads dyt at w - dw, is A at row offset 1 - dw (2, 1, 0 for
//     dw = -1, 0, 1) by ldmatrix; B is W[3 (dh + 1) + dw + 1]'s [c][o]
//     chunk, which is B's (n, k) layout as W lies: ldmatrix without
//     .trans.
//   - y and dy go by cp.async (16 bytes, zeros outside; element loads
//     where a start is unaligned or Co is not a multiple of 8) into a
//     ring of steps: dy into the dyt tile, y into a raw tile beside it;
//     each thread turns the chunks it copied into dyt in place (dyt8; 0
//     outside the image, where it would be ds1), and one barrier a step
//     publishes the tile.  Where C and Co <= 64 the block's whole W slice
//     (3 x 3 x 64 x 64 bf16) stays in shared memory for its run and the
//     ring holds two steps, one ahead (111,680 bytes: two blocks an SM;
//     three steps leave one, which ran 1.5x slower on an H100 SXM);
//     else W streams through a ring of three steps, two ahead, 32 o a
//     step (104,928 bytes at 128 channels, 67,552 at 64).  W's tiles are
//     swizzled rather than padded (w_at), which is what lets both fit
//     two blocks an SM beside y's raw tiles.
//   - Every chunk of C_out sums into the same registers, so the ReLU /
//     normalize backward sees the total dxn: the TPU's split over C_out
//     (kernel 15, a VMEM limit) needs no counterpart.  The epilogue works
//     in the accumulator layout at the segments' own pixels: x pairs are
//     loaded there, z = x*scale + bias, dz = dxn where z > 0, dx =
//     dz*scale rounded to bf16 in pairs; the column sums of dz*x and dz
//     stay in registers for the run and are reduced by shuffles, then
//     across the warps in order, into one float32 partial row a run.  No
//     atomics.

#include "common.cuh"
#include "mma.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int BI = 128;       // rows of C a block owns
constexpr int BJ = 128;       // columns of C a block owns
constexpr int BR = 8;         // depth staged through shared memory at once
constexpr int THREADS = 256;  // 16 x 16 threads, an 8x8 sub-tile each
constexpr int LOADS = BI * BR / THREADS;  // A (and B) elements a thread stages

enum Mode { kFwd = 0, kDx = 1 };

template <typename T>
struct Args {
  const T* x;           // (M, C)
  const T* w;           // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const T* y;           // (M, Co), the forward's output (dx, dw)
  const T* dy;          // (M, Co) (dx, dw)
  const float* ds1;     // (Co,) (dx, dw)
  const float* ds2;     // (Co,)
  T* out;               // forward: y (M, Co); dx: dx (M, C)
  float* part0;         // forward: s1 rows; dx: dscale rows
  float* part1;         // forward: s2 rows; dx: dbias rows
  int M;                // N*H*W rows
  int H;
  int W;
  int C;
  int Co;
  int prologue;
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// relu(x*scale + bias) rounded to T, or x itself, at (row m, channel c)
template <typename T>
__device__ __forceinline__ float prologue_at(const Args<T>& a, int m, int c) {
  const float v = to_float(a.x[static_cast<int64_t>(m) * a.C + c]);
  if (!a.prologue) return v;
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v, a.scale[c]), a.bias[c]),
                           0.f));
}

// dyt = dy + ds1 + 2*y*ds2 rounded to T, at (row m, channel o)
template <typename T>
__device__ __forceinline__ float dyt_at(const Args<T>& a, int m, int o) {
  const int64_t at = static_cast<int64_t>(m) * a.Co + o;
  const float v = __fadd_rn(
      __fadd_rn(to_float(a.dy[at]), a.ds1[o]),
      __fmul_rn(__fmul_rn(2.f, to_float(a.y[at])), a.ds2[o]));
  return round_to<T>(v);
}

// Tap t's displacement (dh, dw), each in {-1, 0, 1}.
__device__ __forceinline__ void tap(int t, int* dh, int* dw) {
  const int kh = t / 3;
  *dh = kh - 1;
  *dw = t - 3 * kh - 1;
}

__device__ __forceinline__ bool inside(int h, int w, int H, int W) {
  return h >= 0 && h < H && w >= 0 && w < W;
}

// Row (or column) of C that sub-tile slot q (0..7) of thread t (0..15)
// owns: two quads, 64 apart.
__device__ __forceinline__ int slot(int t, int q) {
  return (q < 4 ? 0 : 64) + t * 4 + (q & 3);
}

// Sum a per-thread column partial over the 16 thread rows of the block,
// in a fixed order, and write it for columns j0 .. j0 + 127.
__device__ __forceinline__ void column_partials(
    const float (&v0)[8], const float (&v1)[8], float (*red0)[BJ],
    float (*red1)[BJ], int tx, int ty, int j0, int J, float* dst0,
    float* dst1) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    red0[ty][slot(tx, q)] = v0[q];
    red1[ty][slot(tx, q)] = v1[q];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < BJ && j0 + t < J) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 16; ++k) {
      s0 += red0[k][t];
      s1 += red1[k][t];
    }
    dst0[j0 + t] = s0;
    dst1[j0 + t] = s1;
  }
}

// What one thread stages of one slice of depth [r0, r0 + BR).  Element
// l of A goes to As[ar][ai + l * a_step_i] ... as laid out below; the
// coordinates that do not change from slice to slice are computed once.
//
//   A row i = tid / 8 + 32 l (a pixel), depth tid % 8;
//   forward: B depth tid / 128 + 2 l, column tid % 128;
//   dx:      B depth tid % 8, column tid / 8 + 32 l.
template <int MODE, typename T>
struct Stager {
  const Args<T>& a;
  int tid;
  int r_end;
  // the pixel of each A row, its (h, w), and whether it exists
  int row[LOADS];
  int ph[LOADS];
  int pw[LOADS];
  bool ok[LOADS];

  __device__ __forceinline__ Stager(const Args<T>& args, int i0, int end)
      : a(args), tid(threadIdx.x), r_end(end) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int m = i0 + tid / BR + (THREADS / BR) * l;
      ok[l] = m < a.M;
      row[l] = m;
      pw[l] = m % a.W;
      ph[l] = (m / a.W) % a.H;
    }
  }

  __device__ __forceinline__ float fetch_a(int l, int r0) const {
    const int k = r0 + tid % BR;
    if (!ok[l] || k >= r_end) return 0.f;
    const int width = MODE == kFwd ? a.C : a.Co;
    const int t = k / width, ch = k - t * width;
    int dh, dw;
    tap(t, &dh, &dw);
    if (MODE == kFwd) {  // the neighbour this pixel reads
      if (!inside(ph[l] + dh, pw[l] + dw, a.H, a.W)) return 0.f;
      return prologue_at(a, row[l] + dh * a.W + dw, ch);
    }
    // dx: the output pixel that read this one through tap t
    if (!inside(ph[l] - dh, pw[l] - dw, a.H, a.W)) return 0.f;
    return dyt_at(a, row[l] - dh * a.W - dw, ch);
  }

  __device__ __forceinline__ float fetch_b(int l, int r0, int j0) const {
    if (MODE == kDx) {  // B[t*Co + o][c] = W[t, c, o], along o
      const int k = r0 + tid % BR;
      const int c = j0 + tid / BR + (THREADS / BR) * l;
      if (k >= r_end || c >= a.C) return 0.f;
      const int t = k / a.Co, o = k - t * a.Co;
      return to_float(a.w[(static_cast<int64_t>(t) * a.C + c) * a.Co + o]);
    }
    const int k = r0 + tid / BJ + (THREADS / BJ) * l;
    const int o = j0 + tid % BJ;
    if (k >= r_end || o >= a.Co) return 0.f;
    // forward: B[t*C + c][o] = W[t, c, o]
    return to_float(a.w[static_cast<int64_t>(k) * a.Co + o]);
  }

  // shared-memory places of element l of A and B
  __device__ __forceinline__ void a_place(int l, int* r, int* i) const {
    *r = tid % BR;
    *i = tid / BR + (THREADS / BR) * l;
  }
  __device__ __forceinline__ void b_place(int l, int* r, int* j) const {
    if (MODE == kDx) {
      *r = tid % BR;
      *j = tid / BR + (THREADS / BR) * l;
    } else {
      *r = tid / BJ + (THREADS / BJ) * l;
      *j = tid % BJ;
    }
  }
};

template <int MODE, typename T>
__device__ __forceinline__ void fused_conv(const Args<T>& a) {
  // rows padded by 4 floats: the staging stores of a warp spread over
  // the banks, and every row stays 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As[BR][BI + 4];
  __shared__ __align__(16) float Bs[BR][BJ + 4];
  __shared__ float red0[THREADS / 16][BJ];
  __shared__ float red1[THREADS / 16][BJ];

  // C is (M, C_out) in the forward, (M, C) in dx; the depth 9 C or 9 C_out
  const int I = a.M;
  const int J = MODE == kDx ? a.C : a.Co;
  const int i0 = blockIdx.x * BI;
  const int j0 = blockIdx.y * BJ;
  const int r_begin = 0, r_end = MODE == kFwd ? 9 * a.C : 9 * a.Co;
  const Stager<MODE, T> st(a, i0, r_end);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  float va[LOADS], vb[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    va[l] = st.fetch_a(l, r_begin);
    vb[l] = st.fetch_b(l, r_begin, j0);
  }
  for (int r0 = r_begin; r0 < r_end; r0 += BR) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      int r, i;
      st.a_place(l, &r, &i);
      As[r][i] = va[l];
      st.b_place(l, &r, &i);
      Bs[r][i] = vb[l];
    }
    __syncthreads();
    if (r0 + BR < r_end) {  // the next slice's loads overlap this product
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        va[l] = st.fetch_a(l, r0 + BR);
        vb[l] = st.fetch_b(l, r0 + BR, j0);
      }
    }
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[r][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[r][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[r][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

  float c0[8], c1[8];  // per-column sums over this thread's rows
#pragma unroll
  for (int q = 0; q < 8; ++q) c0[q] = c1[q] = 0.f;
  if (MODE == kFwd) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int m = i0 + slot(ty, p);
      if (m >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int o = j0 + slot(tx, q);
        if (o >= J) continue;
        const T yv = from_float<T>(acc[p][q]);
        a.out[static_cast<int64_t>(m) * a.Co + o] = yv;
        const float f = to_float(yv);
        c0[q] += f;
        c1[q] += f * f;
      }
    }
  } else {  // dx
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int m = i0 + slot(ty, p);
      if (m >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int c = j0 + slot(tx, q);
        if (c >= J) continue;
        const int64_t at = static_cast<int64_t>(m) * a.C + c;
        const float d = acc[p][q];
        if (a.prologue) {
          const float xv = to_float(a.x[at]);
          const float sc = a.scale[c];
          const float z = __fadd_rn(__fmul_rn(xv, sc), a.bias[c]);
          const float dz = z > 0.f ? d : 0.f;
          a.out[at] = from_float<T>(__fmul_rn(dz, sc));
          c0[q] += dz * xv;
          c1[q] += dz;
        } else {
          a.out[at] = from_float<T>(d);
        }
      }
    }
    if (!a.prologue) return;  // uniform across the block
  }
  const int64_t prow = static_cast<int64_t>(blockIdx.x) * J;
  column_partials(c0, c1, red0, red1, tx, ty, j0, J, a.part0 + prow,
                  a.part1 + prow);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_conv3_bn_fwd_kernel(Args<T> a) {
  fused_conv<kFwd>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_conv3_bn_dx_kernel(Args<T> a) {
  fused_conv<kDx>(a);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The FMA tile, float32 forward and dx only: bfloat16's forward, dx and
// dw and float32's dw are the tensor-core tiles below.
cudaError_t launch(int mode, const Args<float>& a, cudaStream_t stream) {
  const int64_t gi = ceil_div(a.M, BI);
  const int64_t gj = ceil_div(mode == kFwd ? a.Co : a.C, BJ);
  if (gj > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj));
  if (mode == kDx)
    fused_conv3_bn_dx_kernel<float><<<grid, THREADS, 0, stream>>>(a);
  else
    fused_conv3_bn_fwd_kernel<float><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// Shapes the kernels take: every size positive, M = N*H*W and every
// flat index (9*C, 9*C_out) in 32 bits.
bool shape_ok(long long N, int H, int W, int C, int Co) {
  if (N < 0 || H <= 0 || W <= 0 || C <= 0 || Co <= 0) return false;
  const long long lim = 0x7fffffffLL - BI;
  return N * H * W <= lim && 9LL * C <= lim && 9LL * Co <= lim;
}

template <typename T>
Args<T> make_args(const void* x, const void* w, const void* scale,
                  const void* bias, const void* y, const void* dy,
                  const void* ds1, const void* ds2, void* out, void* part0,
                  void* part1, long long N, int H, int W, int C, int Co,
                  int prologue) {
  Args<T> a;
  a.x = static_cast<const T*>(x);
  a.w = static_cast<const T*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<const T*>(y);
  a.dy = static_cast<const T*>(dy);
  a.ds1 = static_cast<const float*>(ds1);
  a.ds2 = static_cast<const float*>(ds2);
  a.out = static_cast<T*>(out);
  a.part0 = static_cast<float*>(part0);
  a.part1 = static_cast<float*>(part1);
  a.M = static_cast<int>(N * H * W);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.prologue = prologue;
  return a;
}

int dispatch(int dtype, int mode, const void* x, const void* w,
             const void* scale, const void* bias, const void* y,
             const void* dy, const void* ds1, const void* ds2, void* out,
             void* part0, void* part1, long long N, int H, int W, int C,
             int Co, int prologue, void* stream) {
  if (dtype != 0 || !shape_ok(N, H, W, C, Co))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(launch(
      mode, make_args<float>(x, w, scale, bias, y, dy, ds1, ds2, out, part0,
                             part1, N, H, W, C, Co, prologue),
      static_cast<cudaStream_t>(stream)));
}

// ---------------------------------------------------------------------
// dw in bfloat16 on the tensor cores.  See the note at the top.

using mx::a_ptr;
using mx::b_ptr;
using mx::bf16;
using mx::cp_async16;
using mx::cp_async_commit;
using mx::cp_async_wait;
using mx::dyt8;
using mx::ldsm_x4_t;
using mx::load8;
using mx::mma;
using mx::prologue8;

constexpr int kTcTile = 64;      // c and o of dw a block owns
constexpr int kTcPos = 64;       // positions a stage holds
constexpr int kTcMaxSeg = kTcPos - 2;  // widest segment: two halo positions
constexpr int kTcThreads = 256;  // 8 warps: 4 over c x 2 over o
constexpr int kTcLd = kTcTile + 8;     // bf16 row stride: 16 bytes pad
constexpr int kTcXRows = kTcPos + 2;   // xn rows: a zero guard either side
constexpr int kTcChunks = kTcPos * (kTcTile / 8) / kTcThreads;  // 2
constexpr int kTcRing = 3;       // raw stages: two load while one is staged

// The arguments of the dw tiles: T = bf16 (fused_conv3_bn_dw_mma) or
// float (fused_conv3_bn_dw_tf32).
template <typename T>
struct DwArgs {
  const T* x;           // (M, C)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const T* y;           // (M, Co)
  const T* dy;          // (M, Co)
  const float* ds1;     // (Co,)
  const float* ds2;     // (Co,)
  float* part;          // (runs, 9*C, Co)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads 16 bytes; bit 1: y and dy do
  int seg_w;            // pixels of a segment (the last of a row: fewer)
  int stage_segs;       // segments a stage holds
  int row_segs;         // segments of an image row
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};
using TcArgs = DwArgs<bf16>;

// The walk of the pixels for an image width W: segments of seg_w
// pixels, stage_segs of them to a stage (64 positions at most, a
// segment taking seg_w + 2), row_segs to an image row.  A row wider than
// kTcMaxSeg takes several segments, one a stage.
void tc_geometry(int W, int* seg_w, int* stage_segs, int* row_segs) {
  *seg_w = W < kTcMaxSeg ? W : kTcMaxSeg;
  *stage_segs = kTcPos / (*seg_w + 2);
  *row_segs = (W + *seg_w - 1) / *seg_w;
}

// Dynamic shared memory of fused_conv3_bn_dw_mma, in order: the ring of
// raw stages (x, y, dy: kTcRaw bf16 values each, [position][channel]),
// the two operand buffers (xn: kTcXRows rows, then dyt: kTcPos rows, of
// kTcLd), the per-channel constants (4 x kTcTile floats).
constexpr int kTcRaw = kTcPos * kTcTile;
constexpr int kTcOps = (kTcXRows + kTcPos) * kTcLd;
constexpr size_t kTcSmem =
    (kTcRing * 3 * kTcRaw + 2 * kTcOps) * sizeof(bf16) +
    4 * kTcTile * sizeof(float);

// Grid (3 * ceil(C / 64) * ceil(Co / 64), runs): block (t, r) takes
// kernel row dh = t % 3 - 1 and tile t / 3 of (c, o) over run r of the
// stages, and writes its three taps' float32 sums to part[r].
__global__ void __launch_bounds__(kTcThreads, 2)
    fused_conv3_bn_dw_mma(TcArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);
  bf16* ops = raw + kTcRing * 3 * kTcRaw;
  float* sc_s = reinterpret_cast<float*>(ops + 2 * kTcOps);
  float* bi_s = sc_s + kTcTile;
  float* d1_s = bi_s + kTcTile;
  float* d2_s = d1_s + kTcTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp & 3, wo = warp >> 2;  // the warp's 16 x 32 tile
  const int tiles_c = (a.C + kTcTile - 1) / kTcTile;
  const int dh = static_cast<int>(blockIdx.x % 3) - 1;
  const int tile = static_cast<int>(blockIdx.x / 3);
  const int c0 = (tile % tiles_c) * kTcTile, o0 = (tile / tiles_c) * kTcTile;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2;

  // Both operand buffers start at 0: the guard rows, the positions past
  // a stage's segments and past its last step of 16 are never written
  // again.
  {
    uint4* z = reinterpret_cast<uint4*>(ops);
    for (int i = tid; i < 2 * kTcOps / 8; i += kTcThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  // per-channel constants, 0 past C and Co (a zero channel stays zero)
  for (int i = tid; i < kTcTile; i += kTcThreads) {
    const bool in_c = a.prologue && c0 + i < a.C;
    sc_s[i] = in_c ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in_c ? a.bias[c0 + i] : 0.f;
    const bool in_o = o0 + i < a.Co;
    d1_s[i] = in_o ? a.ds1[o0 + i] : 0.f;
    d2_s[i] = in_o ? a.ds2[o0 + i] : 0.f;
  }

  // This thread's chunks: positions tid / 8 + 32 i of a stage, channels
  // cc .. cc + 7 of the tile, for x and for dyt; the thread loads them
  // and stages them itself, so the raw ring needs no barrier.  A
  // position is fixed for the whole run: segment sg of the stage, place
  // p in it (0 and seg_w + 1 are the halo).  The segment's image row
  // (n * H + h), its h and its index in the row advance by stage_segs
  // segments a stage, as the loads run ahead.
  const int cc = (tid & 7) * 8;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses
  int pos[kTcChunks], place[kTcChunks], seg[kTcChunks];
  int img_row[kTcChunks], h[kTcChunks], sr[kTcChunks];
#pragma unroll
  for (int i = 0; i < kTcChunks; ++i) {
    pos[i] = (tid >> 3) + (kTcThreads / 8) * i;
    const int sg = pos[i] / pitch;
    place[i] = pos[i] - sg * pitch;
    seg[i] = st_begin * a.stage_segs + sg;
    img_row[i] = seg[i] / a.row_segs;
    sr[i] = seg[i] - img_row[i] * a.row_segs;
    h[i] = img_row[i] % a.H;
  }

  // Loads the stage the positions point at into raw slot `slot` (cp.async
  // of 16 bytes, zeros where a chunk lies outside; element loads where
  // a start or width does not allow 16 bytes), moves the positions on
  // by a stage, and returns the stage's flags: bit 2i, chunk i's x lies
  // in the image; bit 2i + 1, its dyt is a segment's own pixel.
  auto fetch = [&](int slot) {
    unsigned flags = 0;
    bf16* rx = raw + slot * 3 * kTcRaw;
    bf16* ry = rx + kTcRaw;
    bf16* rd = ry + kTcRaw;
#pragma unroll
    for (int i = 0; i < kTcChunks; ++i) {
      if (pos[i] < npos) {
        const bool live = seg[i] < a.segs;
        const int p = place[i];
        const int w = sr[i] * a.seg_w + p - 1;  // this position's pixel
        // x at (n, h + dh, w); dyt at (n, h, w) for a segment's own pixels
        const bool xin = live && h[i] + dh >= 0 && h[i] + dh < a.H &&
                         w >= 0 && w < a.W;
        const bool din = live && p >= 1 && p <= a.seg_w && w < a.W;
        flags |= (xin ? 1u : 0u) << (2 * i) | (din ? 2u : 0u) << (2 * i);
        const int at = pos[i] * kTcTile + cc;
        const bf16* xr =
            a.x + (xin ? static_cast<int64_t>(img_row[i] + dh) * a.W + w
                       : 0) * a.C;
        const int64_t dpix =
            din ? static_cast<int64_t>(img_row[i]) * a.W + w : 0;
        const bf16* yr = a.y + dpix * a.Co;
        const bf16* gr = a.dy + dpix * a.Co;
        if (vec_x) {
          const bool full = xin && c0 + cc < a.C;
          cp_async16(rx + at, full ? xr + c0 + cc : a.x, full);
        } else {
          *reinterpret_cast<uint4*>(rx + at) =
              load8(xr, c0 + cc, a.C, xin, false);
        }
        if (vec_y) {
          const bool full = din && o0 + cc < a.Co;
          cp_async16(ry + at, full ? yr + o0 + cc : a.y, full);
          cp_async16(rd + at, full ? gr + o0 + cc : a.dy, full);
        } else {
          *reinterpret_cast<uint4*>(ry + at) =
              load8(yr, o0 + cc, a.Co, din, false);
          *reinterpret_cast<uint4*>(rd + at) =
              load8(gr, o0 + cc, a.Co, din, false);
        }
      }
      seg[i] += a.stage_segs;
      if (a.row_segs == 1) {
        img_row[i] += a.stage_segs;
        h[i] += a.stage_segs;
        while (h[i] >= a.H) h[i] -= a.H;
      } else if (++sr[i] == a.row_segs) {  // one segment a stage
        sr[i] = 0;
        ++img_row[i];
        if (++h[i] == a.H) h[i] = 0;
      }
    }
    return flags;
  };

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  // the first kTcRing - 1 stages in flight; one group a stage, empty past
  // the run, so that a wait counts stages
  unsigned ring_flags = 0;  // 4 bits a slot
#pragma unroll
  for (int k = 0; k < kTcRing - 1; ++k) {
    if (st_begin + k < st_end) ring_flags |= fetch(k) << (4 * k);
    cp_async_commit();
  }
  const int ksteps = (npos + 15) / 16;
  __syncthreads();  // the zeroed buffers and the constants
  int buf = 0, slot = 0;
  for (int st = st_begin; st < st_end; ++st, buf ^= 1) {
    bf16* xs = ops + buf * kTcOps;
    bf16* ds = xs + kTcXRows * kTcLd;
    cp_async_wait<kTcRing - 2>();  // this thread's chunks of stage st
    // stage: xn (prologue rounded to bf16, 0 outside the image) one row
    // below its position (the guard), dyt (rounded to bf16) at the
    // segments' pixels and 0 at their halo
    {
      const unsigned flags = ring_flags >> (4 * slot);
      const bf16* rx = raw + slot * 3 * kTcRaw;
      float sc[8], bi[8], d1[8], d2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = sc_s[cc + j];
        bi[j] = bi_s[cc + j];
        d1[j] = d1_s[cc + j];
        d2[j] = d2_s[cc + j];
      }
#pragma unroll
      for (int i = 0; i < kTcChunks; ++i) {
        if (pos[i] >= npos) continue;
        const int at = pos[i] * kTcTile + cc;
        uint4 v = *reinterpret_cast<const uint4*>(rx + at);
        if (a.prologue)  // x is 0 outside the image and past C already
          v = flags >> (2 * i) & 1 ? prologue8(v, sc, bi)
                                   : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(xs + (pos[i] + 1) * kTcLd + cc) = v;
        *reinterpret_cast<uint4*>(ds + pos[i] * kTcLd + cc) =
            flags >> (2 * i) & 2
                ? dyt8(*reinterpret_cast<const uint4*>(rx + kTcRaw + at),
                       *reinterpret_cast<const uint4*>(rx + 2 * kTcRaw + at),
                       d1, d2)
                : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // stage st + kTcRing - 1 into the slot that stage st - 1 left (this
    // thread's own chunks, staged already); the other operand buffer is
    // free: every warp left its product at the barrier
    const int next = slot == 0 ? kTcRing - 1 : slot - 1;
    if (st + kTcRing - 1 < st_end)
      ring_flags = (ring_flags & ~(0xfu << (4 * next))) |
                   fetch(next) << (4 * next);
    cp_async_commit();
    slot = slot + 1 == kTcRing ? 0 : slot + 1;
#pragma unroll
    for (int kk = 0; kk < kTcPos / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t bf[2][4];  // B = dyt: depth positions, columns o
#pragma unroll
      for (int q = 0; q < 2; ++q)
        ldsm_x4_t(bf[q], a_ptr<kTcLd>(ds, 16 * kk, 32 * wo + 16 * q));
#pragma unroll
      for (int t = 0; t < 3; ++t) {  // A = xn^T at tap offset t: rows c
        uint32_t af[4];
        ldsm_x4_t(af, b_ptr<kTcLd>(xs, 16 * kk + t, 16 * wc));
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          mma(acc[t][2 * q], af, bf[q][0], bf[q][1]);
          mma(acc[t][2 * q + 1], af, bf[q][2], bf[q][3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // the ring's empty groups

  // this run's float32 partial: acc[t][j][e] is tap 3 (dh + 1) + t at
  // c = 16 wc + g + 8 (e / 2), o = 32 wo + 8 j + 2 t4 + e % 2 of the tile
  float* dst = a.part + static_cast<int64_t>(blockIdx.y) * 9 * a.C * a.Co;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (a.Co & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + 16 * wc + g + 8 * hf;
      if (c >= a.C) continue;
      float* out =
          dst + (static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c) * a.Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 32 * wo + 8 * j + 2 * t4;
        const float v0 = acc[t][j][2 * hf], v1 = acc[t][j][2 * hf + 1];
        if (pairs && o + 1 < a.Co) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          if (o < a.Co) out[o] = v0;
          if (o + 1 < a.Co) out[o + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------
// dw in float32 on the tensor cores (3xTF32).  See the note at the top.

using mx::dyt4;
using mx::load4;
using mx::mma_3xtf32;
using mx::prologue4;
using mx::split_tf32;

constexpr int kTfLd = kTcTile + 8;   // float row stride: 8 mod 32 banks
constexpr int kTfRowChunks = kTcTile / 4;                // float4 a row
constexpr int kTfRowStep = kTcThreads / kTfRowChunks;    // a thread's
constexpr int kTfChunks = kTcPos / kTfRowStep;           // positions apart
constexpr int kTfRing = 2;           // stages: one loads while one multiplies

// A ring slot holds a stage: x, turned into xn in place (kTcXRows rows of
// kTfLd: position p at row p + 1, a zero guard row either side), y and
// dy (kTcPos rows of kTfLd each), turned in place into dyt's tf32 lo and
// hi parts; after the ring, the per-channel constants (4 x kTcTile
// floats).  The padded strides are 8 mod 32 floats, so the 32 lanes of
// a fragment load, at rows t4 and columns g, read 32 distinct banks.
template <int RING>
struct DwTf {
  static constexpr int kX = kTcXRows * kTfLd;
  static constexpr int kY = kTcPos * kTfLd;
  static constexpr int kSlot = kX + 2 * kY;  // floats
  static constexpr size_t kSmem =
      (RING * kSlot + 4 * kTcTile) * sizeof(float);
};

// Grid (3 * ceil(C / 64) * ceil(Co / 64), runs), as fused_conv3_bn_dw_mma:
// block (t, r) takes kernel row dh = t % 3 - 1 and tile t / 3 of (c, o)
// over run r of the stages, and writes its three taps' float32 sums to
// part[r].
template <int RING>
__global__ void __launch_bounds__(kTcThreads, RING == 2 ? 2 : 1)
    fused_conv3_bn_dw_tf32(DwArgs<float> a) {
  using G = DwTf<RING>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sc_s = ring + RING * G::kSlot;
  float* bi_s = sc_s + kTcTile;
  float* d1_s = bi_s + kTcTile;
  float* d2_s = d1_s + kTcTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wc = warp & 3, wo = warp >> 2;  // the warp's 16 x 32 tile
  const int g = lane >> 2, t4 = lane & 3;
  const int tiles_c = (a.C + kTcTile - 1) / kTcTile;
  const int dh = static_cast<int>(blockIdx.x % 3) - 1;
  const int tile = static_cast<int>(blockIdx.x / 3);
  const int c0 = (tile % tiles_c) * kTcTile, o0 = (tile / tiles_c) * kTcTile;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2;

  // The ring starts at 0: the guard rows and the positions past a
  // stage's segments are never written again.
  {
    float4* z = reinterpret_cast<float4*>(ring);
    for (int i = tid; i < RING * G::kSlot / 4; i += kTcThreads)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // per-channel constants, 0 past C and Co (a zero channel stays zero)
  for (int i = tid; i < kTcTile; i += kTcThreads) {
    const bool in_c = a.prologue && c0 + i < a.C;
    sc_s[i] = in_c ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in_c ? a.bias[c0 + i] : 0.f;
    const bool in_o = o0 + i < a.Co;
    d1_s[i] = in_o ? a.ds1[o0 + i] : 0.f;
    d2_s[i] = in_o ? a.ds2[o0 + i] : 0.f;
  }

  // This thread's chunks: positions (tid >> 4) + 16 i of a stage,
  // channels cc .. cc + 3 of the tile, for x, y and dy; the thread
  // copies them and stages them itself.  Position i is place[i] of the
  // stage's segment sg[i] (places 0 and seg_w + 1 are the halo).
  const int cc = (tid & 15) * 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses
  int sg[kTfChunks], place[kTfChunks];
#pragma unroll
  for (int i = 0; i < kTfChunks; ++i) {
    const int p = (tid >> 4) + kTfRowStep * i;
    sg[i] = p / pitch;
    place[i] = p - sg[i] * pitch;
  }

  // Loads stage st into ring slot `slot` (cp.async of 16 bytes, zeros
  // where a chunk lies outside; element loads where a start or width
  // does not allow 16 bytes) and returns its flags: bit 2i, chunk i's x
  // lies in the image; bit 2i + 1, its dyt is a segment's own pixel.
  // Where an image row takes several segments, a stage holds one.
  auto fetch = [&](int st, int slot) {
    unsigned flags = 0;
    float* rx = ring + slot * G::kSlot;
    float* ry = rx + G::kX;
    float* rd = ry + G::kY;
    const int seg0 = st * a.stage_segs;
    const int img0 = seg0 / a.row_segs, sr = seg0 - img0 * a.row_segs;
#pragma unroll
    for (int i = 0; i < kTfChunks; ++i) {
      const int p = (tid >> 4) + kTfRowStep * i;
      if (p < npos) {
        const bool live = seg0 + sg[i] < a.segs;
        const int img_row = img0 + sg[i];  // sg[i] is 0 where row_segs > 1
        const int h = img_row % a.H;
        const int w = sr * a.seg_w + place[i] - 1;  // this position's pixel
        // x at (n, h + dh, w); dyt at (n, h, w) for a segment's own pixels
        const bool xin = live && h + dh >= 0 && h + dh < a.H && w >= 0 &&
                         w < a.W;
        const bool din = live && place[i] >= 1 && place[i] <= a.seg_w &&
                         w < a.W;
        flags |= (xin ? 1u : 0u) << (2 * i) | (din ? 2u : 0u) << (2 * i);
        const float* xr =
            a.x + (xin ? static_cast<int64_t>(img_row + dh) * a.W + w : 0) *
                      a.C;
        const int64_t dpix =
            (din ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.Co;
        float* xd = rx + (p + 1) * kTfLd + cc;
        float* yd = ry + p * kTfLd + cc;
        float* dd = rd + p * kTfLd + cc;
        if (vec_x) {
          const bool full = xin && c0 + cc < a.C;
          cp_async16(xd, full ? xr + c0 + cc : a.x, full);
        } else {
          *reinterpret_cast<float4*>(xd) = load4(xr, c0 + cc, a.C, xin);
        }
        if (vec_y) {
          const bool full = din && o0 + cc < a.Co;
          cp_async16(yd, full ? a.y + dpix + o0 + cc : a.y, full);
          cp_async16(dd, full ? a.dy + dpix + o0 + cc : a.dy, full);
        } else {
          *reinterpret_cast<float4*>(yd) =
              load4(a.y + dpix, o0 + cc, a.Co, din);
          *reinterpret_cast<float4*>(dd) =
              load4(a.dy + dpix, o0 + cc, a.Co, din);
        }
      }
    }
    return flags;
  };

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0.f;

  __syncthreads();  // the zeroed ring and the constants
  // the first RING - 1 stages in flight; one group a stage, empty past
  // the run, so that a wait counts stages
  constexpr int kBits = 2 * kTfChunks;  // flags a slot
  unsigned ring_flags = 0;
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (st_begin + k < st_end)
      ring_flags |= fetch(st_begin + k, k) << (kBits * k);
    cp_async_commit();
  }
  const int ksteps = (npos + 7) / 8;
  int slot = 0;
  for (int st = st_begin; st < st_end; ++st) {
    float* rx = ring + slot * G::kSlot;
    float* ry = rx + G::kX;
    float* rd = ry + G::kY;
    cp_async_wait<RING - 2>();  // this thread's chunks of stage st
    {  // xn (the prologue, 0 outside the image) in place, in float32; dyt
       // (0 at the halo) in float32, split into tf32 hi in place of dy
       // and lo in place of y
      const unsigned flags = ring_flags >> (kBits * slot);
      float sc[4], bi[4], d1[4], d2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = sc_s[cc + j];
        bi[j] = bi_s[cc + j];
        d1[j] = d1_s[cc + j];
        d2[j] = d2_s[cc + j];
      }
#pragma unroll
      for (int i = 0; i < kTfChunks; ++i) {
        const int p = (tid >> 4) + kTfRowStep * i;
        if (p >= npos) continue;
        if (a.prologue) {  // x is 0 outside the image and past C already
          float4* q = reinterpret_cast<float4*>(rx + (p + 1) * kTfLd + cc);
          *q = flags >> (2 * i) & 1 ? prologue4(*q, sc, bi)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        float4* d = reinterpret_cast<float4*>(rd + p * kTfLd + cc);
        float4* yl = reinterpret_cast<float4*>(ry + p * kTfLd + cc);
        const float4 v = flags >> (2 * i) & 2
                             ? dyt4(*yl, *d, d1, d2)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        uint4 hi, lo;
        split_tf32(v.x, hi.x, lo.x);
        split_tf32(v.y, hi.y, lo.y);
        split_tf32(v.z, hi.z, lo.z);
        split_tf32(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(d) = hi;
        *reinterpret_cast<uint4*>(yl) = lo;
      }
    }
    __syncthreads();
    // stage st + RING - 1 into the slot that stage st - 1 left: every
    // warp left its product at the barrier
    const int next = slot == 0 ? RING - 1 : slot - 1;
    if (st + RING - 1 < st_end)
      ring_flags = (ring_flags & ~(((1u << kBits) - 1) << (kBits * next))) |
                   fetch(st + RING - 1, next) << (kBits * next);
    cp_async_commit();
    // Each tap's products over the stage go into a part that starts at
    // 0, and the part into acc, rounded to nearest: the tensor core
    // truncates each sum, and a chain of every product of a run in one
    // register drifts by as many ulps, past the float32 tolerance at
    // ResNet-50's shapes; 24 products a chain keep the drift of each
    // part far below its rounding.
    const uint32_t* bhi = reinterpret_cast<const uint32_t*>(rd);
    const uint32_t* blo = reinterpret_cast<const uint32_t*>(ry);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      float part[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTcPos / 8; ++kk) {
        if (kk >= ksteps) break;
        // A = xn^T at tap offset t: rows c, depth positions, split into
        // tf32 hi + lo as loaded
        const float* q = rx + (8 * kk + t4 + t) * kTfLd + 16 * wc + g;
        uint32_t ah[4], al[4];
        split_tf32(q[0], ah[0], al[0]);
        split_tf32(q[8], ah[1], al[1]);
        split_tf32(q[4 * kTfLd], ah[2], al[2]);
        split_tf32(q[4 * kTfLd + 8], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // B = dyt: depth positions, cols o
          const int at = (8 * kk + t4) * kTfLd + 32 * wo + 8 * j + g;
          const uint32_t bh[2] = {bhi[at], bhi[at + 4 * kTfLd]};
          const uint32_t bl[2] = {blo[at], blo[at + 4 * kTfLd]};
          mma_3xtf32(part[j], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][j][e] = __fadd_rn(acc[t][j][e], part[j][e]);
    }
    slot = slot + 1 == RING ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // the ring's empty groups

  // this run's float32 partial: acc[t][j][e] is tap 3 (dh + 1) + t at
  // c = 16 wc + g + 8 (e / 2), o = 32 wo + 8 j + 2 t4 + e % 2 of the tile
  float* dst = a.part + static_cast<int64_t>(blockIdx.y) * 9 * a.C * a.Co;
  const bool pairs = (a.Co & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int c = c0 + 16 * wc + g + 8 * hf;
      if (c >= a.C) continue;
      float* out =
          dst + (static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c) * a.Co;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 32 * wo + 8 * j + 2 * t4;
        const float v0 = acc[t][j][2 * hf], v1 = acc[t][j][2 * hf + 1];
        if (pairs && o + 1 < a.Co) {
          *reinterpret_cast<float2*>(out + o) = make_float2(v0, v1);
        } else {
          if (o < a.Co) out[o] = v0;
          if (o + 1 < a.Co) out[o + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------
// The forward in bfloat16 on the tensor cores.  See the note at the top.

using mx::ldsm_x4;

constexpr int kFwThreads = 256;  // 8 warps over 64 positions x BN channels
constexpr int kFwRing = 3;       // operand steps: two load while one multiplies

// fused_conv3_bn_fwd_mma's tile: BN output channels a block (64, or 128
// where C_out > 64), KC input channels a step.  RES (C <= KC = 64): the
// block's whole W slice stays in shared memory for its run; else KC = 32
// and W streams through the ring with x, a chunk a step.
template <int BN, int KC, bool RES>
struct FwTc {
  static constexpr int kWarpsN = BN / 32;          // 32 channels a warp
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMw = kTcPos / kWarpsM;     // positions a warp
  static constexpr int kMI = kMw / 16;             // its m16 tiles
  static constexpr int kXLd = KC + 8;              // bf16 row strides: 16
  static constexpr int kWLd = BN + 8;              // bytes of pad
  static constexpr int kXTile = kTcXRows * kXLd;   // xn of one step
  static constexpr int kWTile = 3 * KC * kWLd;     // W[3 (dh + 1) + t][c][o]
  static constexpr int kRowChunks = KC / 8;        // uint4 of an x position
  static constexpr int kXChunks = kTcPos * kRowChunks / kFwThreads;
  static constexpr int kWChunks = 3 * KC * (BN / 8) / kFwThreads;
  static constexpr int kWTiles = RES ? 3 : kFwRing;  // one a dh, or a step
  static constexpr size_t kSmem =
      (kFwRing * kXTile + kWTiles * kWTile) * sizeof(bf16) +
      2 * kWarpsM * BN * sizeof(float);
};

struct FwArgs {
  const bf16* x;        // (M, C)
  const bf16* w;        // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  bf16* y;              // (M, Co)
  float* s1;            // (runs, Co)
  float* s2;            // (runs, Co)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads 16 bytes; bit 1: w does
  int seg_w;            // the pixel walk of tc_geometry
  int stage_segs;
  int row_segs;
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};

// Grid (ceil(Co / BN), runs): block (j, r) computes output channels
// [j BN, (j + 1) BN) at every pixel of run r's stages, a stage at a
// time, and writes its float32 sums of y and y^2 to s1[r], s2[r].  A
// stage's depth runs in steps (dh, chunk of KC channels): xn of image
// row h + dh as a [position][channel] tile, one row below its position
// (a zero guard row), so that tap dw of the kernel row is the tile at
// row offset dw + 1; W[3 (dh + 1) + dw + 1] for that chunk.
template <int BN, int KC, bool RES>
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_fwd_mma(FwArgs a) {
  using G = FwTc<BN, KC, RES>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xring = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = xring + kFwRing * G::kXTile;
  float* red = reinterpret_cast<float*>(wbuf + G::kWTiles * G::kWTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.x * BN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.C + KC - 1) / KC;  // channel chunks: 1 where RES
  const int per_stage = 3 * nck;        // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_w = a.vec & 2;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The x ring starts at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The barrier keeps every
  // zero ahead of the copies that land in the ring.
  {
    uint4* z = reinterpret_cast<uint4*>(xring);
    for (int i = tid; i < kFwRing * G::kXTile / 8; i += kFwThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // This thread's x chunks: positions pos[i] of a stage, channels cc ..
  // cc + 7 of a step's chunk; it loads them and applies the prologue to
  // them itself, so no barrier separates the two.  A position's segment
  // and place in it are fixed; its pixel follows the stage (locate).
  const int cc = (tid % G::kRowChunks) * 8;
  int pos[G::kXChunks], sg[G::kXChunks], place[G::kXChunks];
  int64_t pix[G::kXChunks];  // its pixel (n, h, w) as a row of x, or -1
  int hrow[G::kXChunks];     // its h
#pragma unroll
  for (int i = 0; i < G::kXChunks; ++i) {
    pos[i] = tid / G::kRowChunks + (kFwThreads / G::kRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kXChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < KC, o < BN into a
  // [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](bf16* dst, int dh, int c0) {
    constexpr int kCols = BN / 8;
#pragma unroll
    for (int j = 0; j < G::kWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / kCols, col = (e - row * kCols) * 8;
      const int t = row / KC, c = c0 + row - t * KC;
      const bool in = c < a.C;
      const bf16* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      bf16* d = dst + row * G::kWLd + col;
      if (vec_w) {
        const bool full = in && o0 + col < a.Co;
        cp_async16(d, full ? src + o0 + col : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(src, o0 + col, a.Co, in, false);
      }
    }
  };

  // Loads step k of the run into ring slot `slot` (cp.async of 16
  // bytes, zeros where a chunk lies outside; element loads where a start
  // or C does not allow 16 bytes) and returns its flags: bit i, chunk
  // i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, c0 = (r % nck) * KC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    bf16* xs = xring + slot * G::kXTile;
#pragma unroll
    for (int i = 0; i < G::kXChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] + dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const bf16* row =
          a.x + (in ? pix[i] + static_cast<int64_t>(dh) * a.W : 0) * a.C;
      bf16* d = xs + (pos[i] + 1) * G::kXLd + cc;
      if (vec_x) {
        const bool full = in && c0 + cc < a.C;
        cp_async16(d, full ? row + c0 + cc : a.x, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(row, c0 + cc, a.C, in, false);
      }
    }
    if (!RES) load_w(wbuf + slot * G::kWTile, dh, c0);
    return flags;
  };

  float acc[G::kMI][4][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float s1[4][2], s2[4][2];  // this thread's column sums of y, y^2
#pragma unroll
  for (int j = 0; j < 4; ++j) s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;

  // Rounds stage st's sums to bf16, stores them at its segments' pixels
  // (a halo position's and those past the segments are dropped), adds
  // the rounded values to the column sums, and clears the sums.
  const bool pairs = (a.Co & 1) == 0;  // bf16 pairs stay 4-byte aligned
  auto epilogue = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = G::kMw * wm + 16 * i + g + 8 * hf;
        const int sgq = q / pitch, p = q - sgq * pitch;
        const int seg = st * a.stage_segs + sgq;
        const int img_row = seg / a.row_segs;
        const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
        const bool keep =
            q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
        bf16* yr =
            a.y + (keep ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.Co;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + 32 * wn + 8 * j + 2 * t4;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
          acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.f;
          if (!keep) continue;
          const float2 f = __bfloat1622float2(v);
          if (pairs && o + 1 < a.Co) {
            *reinterpret_cast<__nv_bfloat162*>(yr + o) = v;
          } else {
            if (o < a.Co) yr[o] = v.x;
            if (o + 1 < a.Co) yr[o + 1] = v.y;
          }
          if (o < a.Co) {
            s1[j][0] += f.x;
            s2[j][0] += f.x * f.x;
          }
          if (o + 1 < a.Co) {
            s1[j][1] += f.y;
            s2[j][1] += f.y * f.y;
          }
        }
      }
  };

  // the resident W joins step 0's group; then the first kFwRing - 1
  // steps in flight, one group a step (empty past the run), so that a
  // wait counts steps
  if (RES) {
#pragma unroll
    for (int dh = -1; dh <= 1; ++dh) load_w(wbuf + (dh + 1) * G::kWTile, dh, 0);
  }
  constexpr unsigned kMask = (1u << G::kXChunks) - 1;
  unsigned ring_flags = 0;  // G::kXChunks bits a slot
#pragma unroll
  for (int k = 0; k < kFwRing - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (G::kXChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int dh = r_c / nck - 1, c0 = (r_c % nck) * KC;
    bf16* xs = xring + slot * G::kXTile;
    cp_async_wait<kFwRing - 2>();  // this thread's chunks of step s
    if (a.prologue) {  // in place: relu(x*scale + bias) rounded, 0 outside
      float sc[8], bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + cc + j;
        sc[j] = c < a.C ? __ldg(a.scale + c) : 0.f;
        bi[j] = c < a.C ? __ldg(a.bias + c) : 0.f;
      }
      const unsigned flags = ring_flags >> (G::kXChunks * slot);
#pragma unroll
      for (int i = 0; i < G::kXChunks; ++i) {
        if (pos[i] >= npos) continue;
        uint4* p = reinterpret_cast<uint4*>(xs + (pos[i] + 1) * G::kXLd + cc);
        *p = flags >> i & 1 ? prologue8(*p, sc, bi) : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // step s + kFwRing - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? kFwRing - 1 : slot - 1;
    if (s + kFwRing - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (G::kXChunks * next))) |
                   load_step(s + kFwRing - 1, next)
                       << (G::kXChunks * next);
    cp_async_commit();
    const bf16* wt = wbuf + (RES ? dh + 1 : slot) * G::kWTile;
    const int ksteps = ((a.C - c0 < KC ? a.C - c0 : KC) + 15) / 16;
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset t
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk >= ksteps) break;
        uint32_t af[G::kMI][4];  // A = xn: rows positions, depth c
#pragma unroll
        for (int i = 0; i < G::kMI; ++i)
          ldsm_x4(af[i], a_ptr<G::kXLd>(xs, G::kMw * wm + 16 * i + t, 16 * kk));
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // B = W[t]: depth c, columns o
          uint32_t bf[4];
          ldsm_x4_t(bf, a_ptr<G::kWLd>(wt + t * KC * G::kWLd, 16 * kk,
                                       32 * wn + 16 * q));
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma(acc[i][2 * q], af[i], bf[0], bf[1]);
            mma(acc[i][2 * q + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    slot = slot + 1 == kFwRing ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = s1[j][e], v2 = s2[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = 32 * wn + 8 * j + 2 * t4 + e;
        red[wm * BN + col] = v1;
        red[(G::kWarpsM + wm) * BN + col] = v2;
      }
    }
  __syncthreads();
  if (tid < BN && o0 + tid < a.Co) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < G::kWarpsM; ++k) {
      v1 += red[k * BN + tid];
      v2 += red[(G::kWarpsM + k) * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.Co + o0 + tid;
    a.s1[at] = v1;
    a.s2[at] = v2;
  }
}

template <int BN, int KC, bool RES>
cudaError_t launch_fwd_mma(const FwArgs& a, unsigned tiles, unsigned runs,
                           cudaStream_t stream) {
  constexpr size_t smem = FwTc<BN, KC, RES>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_fwd_mma<BN, KC, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_conv3_bn_fwd_mma<BN, KC, RES>
      <<<dim3(tiles, runs), kFwThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// dx in bfloat16 on the tensor cores.  See the note at the top.

using mx::unpack;

// fused_conv3_bn_dx_mma's tile: BN input channels c a block (64, or 128
// where C > 64), KC output channels o a step, a ring of RING steps.  A
// ring slot holds one step's operands: the dyt tile ([position][o], one
// row below its position, a zero guard row either side; rows padded by
// 16 bytes), the step's raw y rows (read back only by the thread that
// copied them) and, unless RES, W's three taps of the step's kernel row
// as [t][c][o] tiles.  RES (C and Co <= KC = 64): the block's whole W
// slice stays in shared memory for its run, and a ring of two steps
// leaves room for it at two blocks an SM.  W's rows are swizzled rather
// than padded (w_at), so that ldmatrix's eight rows fall on distinct
// banks.
template <int BN, int KC, bool RES, int RING>
struct DxTc {
  static constexpr int kWarpsN = BN / 32;          // 32 channels a warp
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMw = kTcPos / kWarpsM;     // positions a warp
  static constexpr int kMI = kMw / 16;             // its m16 tiles
  static constexpr int kDLd = KC + 8;              // dyt row stride
  static constexpr int kDTile = kTcXRows * kDLd;
  static constexpr int kYTile = kTcPos * KC;
  static constexpr int kWTile = 3 * BN * KC;       // a kernel row's taps
  static constexpr int kSlot = kDTile + kYTile + (RES ? 0 : kWTile);
  static constexpr int kRowChunks = KC / 8;        // uint4 of a position
  static constexpr int kChunks = kTcPos * kRowChunks / kFwThreads;
  static constexpr int kWChunks = 3 * BN * kRowChunks / kFwThreads;
  static constexpr size_t kSmem =
      (RING * kSlot + (RES ? 3 * kWTile : 0)) * sizeof(bf16) +
      (2 + 2 * kWarpsM) * BN * sizeof(float);
};

// Element (row, 8 * chunk) of a swizzled W tile of KC-value rows: chunk
// k of row r is stored at chunk k ^ (r % 8) (KC = 64, 128-byte rows), k
// ^ (r / 2 % 4) (KC = 32, 64-byte rows).
template <int KC>
__device__ __forceinline__ int w_at(int row, int chunk) {
  return row * KC + ((chunk ^ (KC == 64 ? row & 7 : row >> 1 & 3)) << 3);
}

struct DxArgs {
  const bf16* x;        // (M, C)
  const bf16* w;        // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const bf16* y;        // (M, Co)
  const bf16* dy;       // (M, Co)
  const float* ds1;     // (Co,)
  const float* ds2;     // (Co,)
  bf16* dx;             // (M, C)
  float* dscale;        // (runs, C), written only with the prologue
  float* dbias;         // (runs, C)
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int vec;              // bit 0: x loads 4 bytes a pair; bit 1: y and dy
                        // load 16 bytes; bit 2: w does
  int seg_w;            // the pixel walk of tc_geometry
  int stage_segs;
  int row_segs;
  int segs;             // N * H * row_segs
  int stages;           // ceil(segs / stage_segs)
  int run_stages;       // stages of a run (the last run: fewer)
};

// Grid (ceil(C / BN), runs): block (j, r) computes dx at input channels
// [j BN, (j + 1) BN) for every pixel of run r's stages, a stage at a
// time, and with the prologue writes its float32 sums of dz*x and dz to
// dscale[r], dbias[r].  A stage's depth runs in steps (dh, chunk of KC
// output channels): dyt of image row h - dh as a [position][o] tile one
// row below its position, so that tap dw of the kernel row (which reads
// dyt at w - dw) is the tile at row offset 1 - dw; W[3 (dh + 1) + dw +
// 1]'s [c][o] chunk is B as it lies.
template <int BN, int KC, bool RES, int RING>
__global__ void __launch_bounds__(kFwThreads, 2)
    fused_conv3_bn_dx_mma(DxArgs a) {
  using G = DxTc<BN, KC, RES, RING>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* wres = ring + RING * G::kSlot;  // RES: W[3 (dh + 1) + t][c][o]
  float* sc_s = reinterpret_cast<float*>(wres + (RES ? 3 * G::kWTile : 0));
  float* bi_s = sc_s + BN;
  float* red = bi_s + BN;  // [dscale, dbias][position warp][column]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.x * BN;
  const int st_begin = blockIdx.y * a.run_stages;
  const int st_end =
      a.stages - st_begin > a.run_stages ? st_begin + a.run_stages : a.stages;
  const int nck = (a.Co + KC - 1) / KC;  // output-channel chunks: 1 if RES
  const int per_stage = 3 * nck;               // steps a stage
  const int nsteps = (st_end - st_begin) * per_stage;
  const bool vec_x = a.vec & 1, vec_y = a.vec & 2, vec_w = a.vec & 4;
  const int pitch = a.seg_w + 2;
  const int npos = a.stage_segs * pitch;  // positions a stage uses

  // The dyt tiles start at 0: the guard rows and the positions past a
  // stage's segments are never written again.  The per-channel
  // constants are 0 past C (a zero channel stays zero).  The barrier
  // keeps both ahead of the copies and of their readers.
  for (int s = 0; s < RING; ++s) {
    uint4* z = reinterpret_cast<uint4*>(ring + s * G::kSlot);
    for (int i = tid; i < G::kDTile / 8; i += kFwThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < BN; i += kFwThreads) {
    const bool in = a.prologue && c0 + i < a.C;
    sc_s[i] = in ? a.scale[c0 + i] : 0.f;
    bi_s[i] = in ? a.bias[c0 + i] : 0.f;
  }
  __syncthreads();

  // This thread's chunks: positions pos[i] of a stage, output channels
  // cc .. cc + 7 of a step's chunk; it loads y and dy there and turns
  // them into dyt itself, so no barrier separates the two.  A
  // position's segment and place in it are fixed; its pixel follows the
  // stage (locate), as in the forward.
  const int cc = (tid % G::kRowChunks) * 8;
  int pos[G::kChunks], sg[G::kChunks], place[G::kChunks];
  int64_t pix[G::kChunks];  // its pixel (n, h, w) as a row of dy, or -1
  int hrow[G::kChunks];     // its h
#pragma unroll
  for (int i = 0; i < G::kChunks; ++i) {
    pos[i] = tid / G::kRowChunks + (kFwThreads / G::kRowChunks) * i;
    sg[i] = pos[i] / pitch;
    place[i] = pos[i] - sg[i] * pitch;
  }
  int ld_stage = -1;
  auto locate = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int seg = st * a.stage_segs + sg[i];
      const int img_row = seg / a.row_segs;
      const int w = (seg - img_row * a.row_segs) * a.seg_w + place[i] - 1;
      const bool ok = pos[i] < npos && seg < a.segs && w >= 0 && w < a.W;
      pix[i] = ok ? static_cast<int64_t>(img_row) * a.W + w : -1;
      hrow[i] = img_row % a.H;
    }
  };

  // W[3 (dh + 1) + t][c0 + c][o0 + o] for t < 3, c < BN, o < KC into a
  // swizzled [t][c][o] tile; 0 past C and Co.
  auto load_w = [&](bf16* dst, int dh, int o0) {
#pragma unroll
    for (int j = 0; j < G::kWChunks; ++j) {
      const int e = tid + kFwThreads * j;
      const int row = e / G::kRowChunks, ch = e - row * G::kRowChunks;
      const int t = row / BN, c = c0 + row - t * BN;
      const bool in = c < a.C;
      const bf16* src =
          a.w + (in ? static_cast<int64_t>(3 * (dh + 1) + t) * a.C + c : 0) *
                    a.Co;
      bf16* d = dst + w_at<KC>(row, ch);
      if (vec_w) {
        const bool full = in && o0 + 8 * ch < a.Co;
        cp_async16(d, full ? src + o0 + 8 * ch : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(d) =
            load8(src, o0 + 8 * ch, a.Co, in, false);
      }
    }
  };

  // Loads step k of the run into ring slot `slot`: y and dy of image row
  // h - dh at every position (cp.async of 16 bytes, zeros where a chunk
  // lies outside; element loads where a start or Co does not allow 16
  // bytes), dy into the dyt tile, and W's chunk; returns the flags: bit
  // i, chunk i's pixel lies in the image.
  auto load_step = [&](int k, int slot) {
    const int sl = k / per_stage, r = k - sl * per_stage;
    const int dh = r / nck - 1, o0 = (r % nck) * KC;
    if (sl != ld_stage) {
      locate(st_begin + sl);
      ld_stage = sl;
    }
    unsigned flags = 0;
    bf16* ds = ring + slot * G::kSlot;
    bf16* ys = ds + G::kDTile;
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      if (pos[i] >= npos) continue;
      const int hh = hrow[i] - dh;
      const bool in = pix[i] >= 0 && hh >= 0 && hh < a.H;
      flags |= (in ? 1u : 0u) << i;
      const int64_t row =
          (in ? pix[i] - static_cast<int64_t>(dh) * a.W : 0) * a.Co;
      bf16* dd = ds + (pos[i] + 1) * G::kDLd + cc;
      bf16* yd = ys + pos[i] * KC + cc;
      if (vec_y) {
        const bool full = in && o0 + cc < a.Co;
        cp_async16(yd, full ? a.y + row + o0 + cc : a.y, full);
        cp_async16(dd, full ? a.dy + row + o0 + cc : a.dy, full);
      } else {
        *reinterpret_cast<uint4*>(yd) =
            load8(a.y + row, o0 + cc, a.Co, in, false);
        *reinterpret_cast<uint4*>(dd) =
            load8(a.dy + row, o0 + cc, a.Co, in, false);
      }
    }
    if (!RES) load_w(ys + G::kYTile, dh, o0);
    return flags;
  };

  // x[m, c] and x[m, c + 1] as a bf16 pair, 0 past C; `at` is m * C
  auto x_pair = [&](int64_t at, int c) -> uint32_t {
    if (c >= a.C) return 0u;
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(a.x + at + c);
    if (vec_x) return __ldg(reinterpret_cast<const unsigned int*>(p));
    return static_cast<uint32_t>(p[0]) |
           (c + 1 < a.C ? static_cast<uint32_t>(p[1]) << 16 : 0u);
  };

  float acc[G::kMI][4][4];
#pragma unroll
  for (int i = 0; i < G::kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float dsc[4][2], dbi[4][2];  // this thread's column sums of dz*x, dz
#pragma unroll
  for (int j = 0; j < 4; ++j)
    dsc[j][0] = dsc[j][1] = dbi[j][0] = dbi[j][1] = 0.f;

  // Stage st's epilogue in the accumulator layout, at the segments' own
  // pixels (a halo position's sums and those past the segments are
  // dropped): with the prologue z = x*scale + bias, dz = dxn where z >
  // 0, dx = dz*scale, and dz*x and dz added to the column sums; dx
  // rounded to bf16 in pairs and stored; the sums cleared.
  const bool pairs = (a.C & 1) == 0;  // bf16 pairs stay 4-byte aligned
  auto epilogue = [&](int st) {
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int q = G::kMw * wm + 16 * i + g + 8 * hf;
        const int sgq = q / pitch, p = q - sgq * pitch;
        const int seg = st * a.stage_segs + sgq;
        const int img_row = seg / a.row_segs;
        const int w = (seg - img_row * a.row_segs) * a.seg_w + p - 1;
        const bool keep =
            q < npos && p >= 1 && p <= a.seg_w && seg < a.segs && w < a.W;
        const int64_t at =
            (keep ? static_cast<int64_t>(img_row) * a.W + w : 0) * a.C;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = 32 * wn + 8 * j + 2 * t4, c = c0 + cl;
          float v0 = acc[i][j][2 * hf], v1 = acc[i][j][2 * hf + 1];
          acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.f;
          if (!keep) continue;
          if (a.prologue) {
            const float2 xf = unpack(x_pair(at, c));
            const float sc0 = sc_s[cl], sc1 = sc_s[cl + 1];
            const float dz0 =
                __fadd_rn(__fmul_rn(xf.x, sc0), bi_s[cl]) > 0.f ? v0 : 0.f;
            const float dz1 =
                __fadd_rn(__fmul_rn(xf.y, sc1), bi_s[cl + 1]) > 0.f ? v1
                                                                     : 0.f;
            dsc[j][0] += dz0 * xf.x;
            dsc[j][1] += dz1 * xf.y;
            dbi[j][0] += dz0;
            dbi[j][1] += dz1;
            v0 = __fmul_rn(dz0, sc0);
            v1 = __fmul_rn(dz1, sc1);
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          bf16* out = a.dx + at + c;
          if (pairs && c + 1 < a.C) {
            *reinterpret_cast<__nv_bfloat162*>(out) = v;
          } else {
            if (c < a.C) out[0] = v.x;
            if (c + 1 < a.C) out[1] = v.y;
          }
        }
      }
  };

  // the resident W joins step 0's group; then the first RING - 1 steps
  // in flight, one group a step (empty past the run), so that a wait
  // counts steps
  if (RES) {
#pragma unroll
    for (int dh = -1; dh <= 1; ++dh)
      load_w(wres + (dh + 1) * G::kWTile, dh, 0);
  }
  constexpr unsigned kMask = (1u << G::kChunks) - 1;
  unsigned ring_flags = 0;  // G::kChunks bits a slot
#pragma unroll
  for (int k = 0; k < RING - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (G::kChunks * k);
    cp_async_commit();
  }
  int slot = 0, r_c = 0, sl_c = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int dh = r_c / nck - 1, o0 = (r_c % nck) * KC;
    bf16* ds = ring + slot * G::kSlot;
    const bf16* ys = ds + G::kDTile;
    const bf16* ws = RES ? wres + (dh + 1) * G::kWTile : ys + G::kYTile;
    cp_async_wait<RING - 2>();  // this thread's chunks of step s
    {  // dyt in place of dy, rounded to bf16; 0 outside the image
      float d1[8], d2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int o = o0 + cc + j;
        d1[j] = o < a.Co ? __ldg(a.ds1 + o) : 0.f;
        d2[j] = o < a.Co ? __ldg(a.ds2 + o) : 0.f;
      }
      const unsigned flags = ring_flags >> (G::kChunks * slot);
#pragma unroll
      for (int i = 0; i < G::kChunks; ++i) {
        if (pos[i] >= npos) continue;
        uint4* d = reinterpret_cast<uint4*>(ds + (pos[i] + 1) * G::kDLd + cc);
        *d = flags >> i & 1
                 ? dyt8(*reinterpret_cast<const uint4*>(ys + pos[i] * KC + cc),
                        *d, d1, d2)
                 : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // step s + RING - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? RING - 1 : slot - 1;
    if (s + RING - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (G::kChunks * next))) |
                   load_step(s + RING - 1, next) << (G::kChunks * next);
    cp_async_commit();
    const int ksteps = ((a.Co - o0 < KC ? a.Co - o0 : KC) + 15) / 16;
#pragma unroll
    for (int t = 0; t < 3; ++t) {  // tap dw = t - 1: row offset 2 - t
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        if (kk >= ksteps) break;
        uint32_t af[G::kMI][4];  // A = dyt: rows positions, depth o
#pragma unroll
        for (int i = 0; i < G::kMI; ++i)
          ldsm_x4(af[i], a_ptr<G::kDLd>(ds, G::kMw * wm + 16 * i + 2 - t,
                                        16 * kk));
#pragma unroll
        for (int q = 0; q < 2; ++q) {  // B = W[t]: rows c, depth o
          const int row = t * BN + 32 * wn + 16 * q + (lane & 7) +
                          ((lane >> 4) << 3);
          uint32_t bf[4];
          ldsm_x4(bf, ws + w_at<KC>(row, 2 * kk + (lane >> 3 & 1)));
#pragma unroll
          for (int i = 0; i < G::kMI; ++i) {
            mma(acc[i][2 * q], af[i], bf[0], bf[1]);
            mma(acc[i][2 * q + 1], af[i], bf[2], bf[3]);
          }
        }
      }
    }
    slot = slot + 1 == RING ? 0 : slot + 1;
    if (++r_c == per_stage) {
      epilogue(st_begin + sl_c);
      r_c = 0;
      ++sl_c;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups
  if (!a.prologue) return;  // uniform across the block

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the warps along the positions in order; the same bits
  // every run
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v1 = dsc[j][e], v2 = dbi[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
      if (g == 0) {
        const int col = 32 * wn + 8 * j + 2 * t4 + e;
        red[wm * BN + col] = v1;
        red[(G::kWarpsM + wm) * BN + col] = v2;
      }
    }
  __syncthreads();
  if (tid < BN && c0 + tid < a.C) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < G::kWarpsM; ++k) {
      v1 += red[k * BN + tid];
      v2 += red[(G::kWarpsM + k) * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.C + c0 + tid;
    a.dscale[at] = v1;
    a.dbias[at] = v2;
  }
}

template <int BN, int KC, bool RES, int RING>
cudaError_t launch_dx_mma(const DxArgs& a, unsigned tiles, unsigned runs,
                          cudaStream_t stream) {
  constexpr size_t smem = DxTc<BN, KC, RES, RING>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dx_mma<BN, KC, RES, RING>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_conv3_bn_dx_mma<BN, KC, RES, RING>
      <<<dim3(tiles, runs), kFwThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The caller sized the partial rows of the forward and dx for blocks of
// BI rows of M: refuse any other count rather than write past them.
bool part_rows_ok(long long part_rows, long long N, int H, int W) {
  return part_rows == ceil_div(N * H * W, BI);
}

// Fills the arguments of a dw tile and its grid (3 * tiles of (c, o),
// runs); false where the runs do not tile the walk's stages.
template <typename T>
bool dw_args(DwArgs<T>* a, const void* x, const void* scale,
             const void* bias, int prologue, const void* y, const void* dy,
             const void* ds1, const void* ds2, void* dw_part, long long N,
             int H, int W, int C, int Co, long long run_stages,
             long long runs, int vec, dim3* grid) {
  tc_geometry(W, &a->seg_w, &a->stage_segs, &a->row_segs);
  const long long segs = N * H * a->row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a->stage_segs);
  const long long tiles =
      3 * ceil_div(C, kTcTile) * ceil_div(Co, kTcTile);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      tiles > 0x7fffffffLL)
    return false;
  a->x = static_cast<const T*>(x);
  a->scale = static_cast<const float*>(scale);
  a->bias = static_cast<const float*>(bias);
  a->y = static_cast<const T*>(y);
  a->dy = static_cast<const T*>(dy);
  a->ds1 = static_cast<const float*>(ds1);
  a->ds2 = static_cast<const float*>(ds2);
  a->part = static_cast<float*>(dw_part);
  a->H = H;
  a->W = W;
  a->C = C;
  a->Co = Co;
  a->prologue = prologue;
  a->vec = vec;
  a->segs = static_cast<int>(segs);
  a->stages = static_cast<int>(stages);
  a->run_stages = static_cast<int>(run_stages);
  *grid = dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(runs));
  return true;
}

}  // namespace

// The float32 forward on the FMA tile: dtype must be 0 (bfloat16 runs
// mx_fused_conv3_bn_fwd_mma).  x (N, H, W, C), w (3, 3, C, Co) and y
// (N, H, W, Co) in that type, contiguous (NHWC, HWIO); scale and bias
// (C,) float32, read only when prologue is 1 (may be null otherwise);
// s1_part and s2_part (part_rows, Co) float32 with part_rows =
// ceil(N*H*W / 128), every element written.  Launches on `stream`
// without synchronising; returns the launch's cudaError_t.
extern "C" int mx_fused_conv3_bn_fwd(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     int prologue, void* y, void* s1_part,
                                     void* s2_part, long long part_rows,
                                     long long N, int H, int W, int C, int Co,
                                     void* stream) {
  if (!shape_ok(N, H, W, C, Co) || !part_rows_ok(part_rows, N, H, W))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kFwd, x, w, scale, bias, nullptr, nullptr, nullptr,
                  nullptr, y, s1_part, s2_part, N, H, W, C, Co, prologue,
                  stream);
}

// The float32 dx on the FMA tile: dtype must be 0 (bfloat16 runs
// mx_fused_conv3_bn_dx_mma).  x (N, H, W, C), w (3, 3, C, Co), y and dy
// (N, H, W, Co) in that type; ds1 and ds2 (Co,) float32; dx (N, H, W, C)
// in that type.  With the prologue, scale and bias (C,) float32 are read
// and dscale_part and dbias_part (part_rows, C) float32, part_rows =
// ceil(N*H*W / 128), written; without it they may be null.
extern "C" int mx_fused_conv3_bn_dx(int dtype, const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    int prologue, const void* y,
                                    const void* dy, const void* ds1,
                                    const void* ds2, void* dx,
                                    void* dscale_part, void* dbias_part,
                                    long long part_rows, long long N, int H,
                                    int W, int C, int Co, void* stream) {
  if (!shape_ok(N, H, W, C, Co) ||
      (prologue && !part_rows_ok(part_rows, N, H, W)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDx, x, w, scale, bias, y, dy, ds1, ds2, dx,
                  dscale_part, dbias_part, N, H, W, C, Co, prologue, stream);
}

// The bfloat16 dw on the tensor cores.  x (N, H, W, C), y and dy
// (N, H, W, Co) bfloat16, contiguous; scale and bias (C,) float32, read
// only when prologue is 1; ds1 and ds2 (Co,) float32.  The pixels are
// walked in segments of image rows (tc_geometry: segments of min(W, 62)
// pixels, 64 / (seg + 2) of them a stage); dw_part is (runs, 9*C, Co)
// float32, one partial of the (3, 3, C, Co) gradient for each run of
// run_stages stages (the last run may be shorter), with runs =
// ceil(stages / run_stages), every element written.  x loads 16 bytes at
// a time where bit 0 of vec is set (x 16-byte aligned, C a multiple of
// 8), y and dy where bit 1 is (both aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_dw_mma(const void* x, const void* scale,
                                        const void* bias, int prologue,
                                        const void* y, const void* dy,
                                        const void* ds1, const void* ds2,
                                        void* dw_part, long long N, int H,
                                        int W, int C, int Co,
                                        long long run_stages, long long runs,
                                        int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  TcArgs a;
  dim3 grid;
  if (!dw_args(&a, x, scale, bias, prologue, y, dy, ds1, ds2, dw_part, N, H,
               W, C, Co, run_stages, runs, vec, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dw_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_dw_mma<<<grid, kTcThreads, kTcSmem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The float32 dw on the tensor cores (3xTF32): as
// mx_fused_conv3_bn_dw_mma, with x, y and dy float32, on the same walk
// and runs; x loads 16 bytes at a time where bit 0 of vec is set (x
// 16-byte aligned, C a multiple of 4), y and dy where bit 1 is (both
// aligned, Co a multiple of 4).
extern "C" int mx_fused_conv3_bn_dw_tf32(const void* x, const void* scale,
                                         const void* bias, int prologue,
                                         const void* y, const void* dy,
                                         const void* ds1, const void* ds2,
                                         void* dw_part, long long N, int H,
                                         int W, int C, int Co,
                                         long long run_stages, long long runs,
                                         int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DwArgs<float> a;
  dim3 grid;
  if (!dw_args(&a, x, scale, bias, prologue, y, dy, ds1, ds2, dw_part, N, H,
               W, C, Co, run_stages, runs, vec, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = DwTf<kTfRing>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv3_bn_dw_tf32<kTfRing>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_conv3_bn_dw_tf32<kTfRing><<<grid, kTcThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 forward on the tensor cores.  x (N, H, W, C) and w (3, 3,
// C, Co) bfloat16, contiguous; scale and bias (C,) float32, read only
// when prologue is 1; y (N, H, W, Co) bfloat16.  The pixels are walked
// as the bf16 dw walks them (tc_geometry), in runs of run_stages stages
// (the last run may be shorter), runs = ceil(stages / run_stages);
// s1_part and s2_part are (runs, Co) float32, one row of sums of y and
// y^2 for each run, every element written.  x loads 16 bytes at a time
// where bit 0 of vec is set (x 16-byte aligned, C a multiple of 8), w
// where bit 1 is (w 16-byte aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_fwd_mma(const void* x, const void* w,
                                         const void* scale, const void* bias,
                                         int prologue, void* y, void* s1_part,
                                         void* s2_part, long long N, int H,
                                         int W, int C, int Co,
                                         long long run_stages, long long runs,
                                         int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  FwArgs a;
  tc_geometry(W, &a.seg_w, &a.stage_segs, &a.row_segs);
  const long long segs = N * H * a.row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a.stage_segs);
  const int bn = Co <= 64 ? 64 : 128;
  const long long tiles = ceil_div(Co, bn);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<bf16*>(y);
  a.s1 = static_cast<float*>(s1_part);
  a.s2 = static_cast<float*>(s2_part);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.prologue = prologue;
  a.vec = vec;
  a.segs = static_cast<int>(segs);
  a.stages = static_cast<int>(stages);
  a.run_stages = static_cast<int>(run_stages);
  const unsigned gt = static_cast<unsigned>(tiles);
  const unsigned gr = static_cast<unsigned>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 64)
    err = bn == 64 ? launch_fwd_mma<64, 64, true>(a, gt, gr, s)
                   : launch_fwd_mma<128, 64, true>(a, gt, gr, s);
  else
    err = bn == 64 ? launch_fwd_mma<64, 32, false>(a, gt, gr, s)
                   : launch_fwd_mma<128, 32, false>(a, gt, gr, s);
  return static_cast<int>(err);
}

// The bfloat16 dx on the tensor cores.  x (N, H, W, C), w (3, 3, C, Co),
// y and dy (N, H, W, Co) and dx (N, H, W, C) bfloat16, contiguous; ds1
// and ds2 (Co,) float32.  The pixels are walked as the bf16 forward
// walks them (tc_geometry), in runs of run_stages stages (the last run
// may be shorter), runs = ceil(stages / run_stages).  With the
// prologue, scale and bias (C,) float32 are read and dscale_part and
// dbias_part (runs, C) float32, one row of sums of dz*x and dz for each
// run, every element written; without it they may be null.  x pairs
// load 4 bytes at a time where bit 0 of vec is set (x 16-byte aligned, C
// a multiple of 8), y and dy 16 bytes where bit 1 is (both aligned, Co a
// multiple of 8), w where bit 2 is (w aligned, Co a multiple of 8).
extern "C" int mx_fused_conv3_bn_dx_mma(
    const void* x, const void* w, const void* scale, const void* bias,
    int prologue, const void* y, const void* dy, const void* ds1,
    const void* ds2, void* dx, void* dscale_part, void* dbias_part,
    long long N, int H, int W, int C, int Co, long long run_stages,
    long long runs, int vec, void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  DxArgs a;
  tc_geometry(W, &a.seg_w, &a.stage_segs, &a.row_segs);
  const long long segs = N * H * a.row_segs;   // at most N*H*W
  const long long stages = ceil_div(segs, a.stage_segs);
  const int bn = C <= 64 ? 64 : 128;
  const long long tiles = ceil_div(C, bn);
  if (run_stages <= 0 || run_stages > stages ||
      runs != ceil_div(stages, run_stages) || runs > 65535 ||
      tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<const bf16*>(y);
  a.dy = static_cast<const bf16*>(dy);
  a.ds1 = static_cast<const float*>(ds1);
  a.ds2 = static_cast<const float*>(ds2);
  a.dx = static_cast<bf16*>(dx);
  a.dscale = static_cast<float*>(dscale_part);
  a.dbias = static_cast<float*>(dbias_part);
  a.H = H;
  a.W = W;
  a.C = C;
  a.Co = Co;
  a.prologue = prologue;
  a.vec = vec;
  a.segs = static_cast<int>(segs);
  a.stages = static_cast<int>(stages);
  a.run_stages = static_cast<int>(run_stages);
  const unsigned gt = static_cast<unsigned>(tiles);
  const unsigned gr = static_cast<unsigned>(runs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (C <= 64 && Co <= 64)
    err = launch_dx_mma<64, 64, true, 2>(a, gt, gr, s);
  else if (C <= 64)
    err = launch_dx_mma<64, 32, false, 3>(a, gt, gr, s);
  else
    err = launch_dx_mma<128, 32, false, 3>(a, gt, gr, s);
  return static_cast<int>(err);
}
