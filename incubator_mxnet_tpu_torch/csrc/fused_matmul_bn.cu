// Fused 1x1 convolution (a matrix product over the flattened N*H*W rows)
// with BatchNorm, written for Hopper (sm_90a): forward, dx and dw.
//
// Replaces the three Pallas TPU kernels of
// incubator_mxnet_tpu/ops/fused_block.py:
//
//   forward  `_fwd_kernel` (:83), launched by `_fwd_impl` (:121):
//       y  = [relu(x*scale + bias)] @ w          x (M, K), w (K, N)
//       s1 = sum_M y,  s2 = sum_M y^2            float32, from y rounded
//   dx       `_bwd_dx_kernel` (:154), launched by `_bwd_impl` (:218):
//       dyt = dy + ds1 + 2*y*ds2                 float32, rounded to T
//       dxn = dyt @ w^T
//       with the prologue: z = x*scale + bias, dz = dxn * [z > 0],
//       dx = dz*scale, dscale = sum_M dz*x, dbias = sum_M dz;
//       without it dx = dxn
//   dw       `_bwd_dw_kernel` (:181), launched by `_bwd_impl` (:259):
//       dw = [relu(x*scale + bias)]^T @ dyt      float32 over M
//
// Numerics follow the TPU kernels: operands in the input type T (float32
// or bfloat16), the prologue and dyt computed in float32 and rounded to T
// before the product, products accumulated in float32, the statistics
// taken from y after it is rounded to T.  The prologue and dyt use
// __fmul_rn/__fadd_rn so that nvcc does not contract them into an FMA:
// they round exactly as the plain PyTorch version does.  Rows, columns
// and depth past the edges of M, K and N are masked here, in the loads
// and the stores; no padded copy of any operand exists in device memory.
//
// The column sums cross M.  The TPU grid walks M in order and carries
// them in VMEM; blocks on Hopper run in no order, so each block of 128
// rows (the bf16 forward: each run of row blocks) writes one float32
// partial row (s1/s2 in the forward, dscale/dbias in dx), and dw splits
// M into runs that each write a float32 partial of the whole (K, N)
// tile.  The wrapper sums the partials in a fixed order.  No atomics:
// the result is the same from run to run.
//
// Bound.  At ResNet-50's shapes (K and N from 64 to 2048, M up to
// 401,408 rows at B=128) each kernel does 2*M*K*N operations.  The
// forward moves (M*K + K*N + M*N) elements, dx and dw read both y and dy
// (two M*N tensors) besides x.  In float32, against the card's 67
// TFLOP/s of FMA outside the tensor cores and 3.35 TB/s (20 operations
// a byte), the forward is bound by operations except stage 1's 64-to-64
// launch (16 a byte); dx and dw are bound by bytes at most stage-1
// launches, where a side is 64 wide (c3: 0.31 and 0.28 ms of traffic
// against 0.20 ms of FMA), and by operations elsewhere.  The float32 dw
// runs on the tensor cores in three tf32 products (below): 3 x 2*M*K*N
// operations at 495 TFLOP/s, under its bytes at every ResNet-50 launch.
// In bfloat16 every launch is bound by bytes (tensor cores at 989
// TFLOP/s, 295 operations a byte); the FMA loop below does not reach that
// bound, and no bf16 kernel runs it (see below).
//
// Design of the float32 forward and dx: one tiled product, C (I, J) =
// A (I, R) @ B (R, J), shared by the two kernels, which differ only in
// how A and B are fetched and in the epilogue.  A block of 256
// threads owns a 128x128 tile of C; each thread keeps an 8x8 sub-tile in
// registers (two 4x4 quads per axis, so the shared-memory reads are
// float4 broadcasts), and the depth goes through shared memory 8 at a
// time, the next slice's global loads in flight while the current one is
// multiplied.  Each operand element is converted to float32 (and put
// through the prologue or dyt) once, as it is staged, so the inner loop
// is plain float32 FMA.  Global loads run along the operand's contiguous
// axis.  This is the simple, right first kernel; TMA, wgmma and a
// persistent schedule are later work.
//
// The bf16 dw (fused_matmul_bn_dw_mma) replaces the same TPU kernel,
// `_bwd_dw_kernel` (fused_block.py:181), on the tensor cores.  At the
// representative launch (401408, 64, 256) it must read 462 MB (x, y, dy
// once: 0.138 ms at 3.35 TB/s) for 13.2 GFLOP (0.013 ms at 989 TFLOP/s),
// so the design is about bytes: every row of x, y and dy is read with
// 16-byte loads, once per tile of the other side, and never widened in
// device memory.  The products of two bf16 values are exact in float32,
// and both operands are bf16 after their rounding (the prologue's
// relu(x*scale + bias) and dyt, as the TPU kernel rounds them), so one
// mma.sync.m16n8k16 with float32 sums gives the float32 numbers of the
// FMA tile; no hi + lo split.  A block of 4 warps owns a 64 x BN tile of
// dw (BN = 128, or 64 where N <= 64: ResNet-50's narrowest sides), each
// warp 32 x BN/2 as 2 x BN/16 m16n8 tiles, over one run of M; a run goes
// through shared memory in stages of 32 rows.  Each thread holds its
// share of the next stage's raw rows in registers (uint4 loads) while
// the warps multiply the current one; it then applies the prologue and
// dyt in float32 with __fmul_rn/__fadd_rn, rounds to bf16, zeroes rows
// past the run (dyt is ds1 there, not 0) and stores the stage as bf16
// [m][k] and [m][n] tiles with 16 bytes of row padding (ldmatrix rows on
// distinct banks).  The product runs along M, so both operands come from
// their [m][.] tiles by ldmatrix.trans.  Where a start or a row width
// does not allow 16 bytes (the wrapper's vec flags) the rows load element
// by element.  Each run writes its float32 (K, N) partial and the wrapper
// sums the runs in a fixed order: no atomics, the same bits every run.
//
// The float32 dw (fused_matmul_bn_dw_tf32) replaces the same TPU kernel
// on the tensor cores without giving up float32 numbers.  The TPU kernel
// multiplies float32 operands unrounded (the prologue's relu(x*scale +
// bias) and dyt stay float32), and one tf32 or bf16 pass keeps about
// three digits, so each operand is split as its fragment is loaded into
// tf32 hi = rna(v) and lo = rna(v - hi) (mma.cuh: split_tf32), and three
// mma.sync.m16n8k8 tf32 products, lo.hi + hi.lo + hi.hi, go into float32
// sums: about 2^-21 of each product.  The tensor core truncates each sum
// it returns, so a stage's products go into a part that starts at 0
// (six products a chain), added to the run's sum rounded to nearest:
// one register for all of a run's products drifted past the float32
// tolerance at ResNet-50's shapes.  At (401408, 64, 256) it must read
// 925 MB (x, y, dy once: 0.276 ms at 3.35 TB/s) for 3 x 13.2 GFLOP
// (0.080 ms at 495 TFLOP/s), so it is bound by bytes.  It walks M as the
// bf16 tile does: a block of 4 warps owns a 64 x BN tile of dw (BN =
// 128, or 64 where N <= 64), each warp 32 x BN/2, over one run of M (the
// bf16 tile's runs, dw_mma_split), in stages of 16 rows.  Raw rows of x,
// y and dy go by cp.async (16 bytes, zeros past the run and the tile;
// element loads where a start or a row width does not allow 16 bytes)
// into a ring of three stages, two ahead of the product (66,048 bytes
// of shared memory at BN = 128: three blocks an SM); each thread applies
// the prologue in place to the x chunks it copied and turns its dy
// chunks into dyt in place, in float32 with __fmul_rn/__fadd_rn, zeroing
// rows past the run, and one barrier a stage publishes the tiles.  The
// tiles' row strides are 8 mod 32 floats, so the 32-bit fragment loads
// (a lane reads row t, column g) fall on 32 distinct banks; no ldmatrix,
// which moves 16-bit elements.  Each run writes its float32 (K, N)
// partial, and the wrapper sums the runs in a fixed order: no atomics.
//
// The bf16 dx (fused_matmul_bn_dx_mma) replaces `_bwd_dx_kernel`
// (fused_block.py:154) on the tensor cores.  At (401408, 64, 256) with
// the prologue it must move 514 MB (y and dy read, x read, dx written:
// 0.153 ms at 3.35 TB/s) for 13.2 GFLOP, so it is bound by bytes.  A
// block of 8 warps owns 128 rows of M x a tile of BK columns of dx (64
// where K <= 64 or N <= 128, else 128; the grid puts a row block's
// column tiles side by side while L2 holds their y and dy), each warp 32
// x BK/2, and runs the product along N in stages of 32 columns: y and dy
// by cp.async (16 bytes, element loads where a start or N does not
// allow it) into a ring of three stages, two ahead; each thread turns
// the chunks it copied into dyt in place (dyt8: float32, rounded to
// bf16; 0 past M, where it would be ds1), and one barrier a stage
// publishes the tile, A by ldmatrix.  w (K, N) is row-major, so its rows
// are B's (n, k) layout: ldmatrix without .trans, by cp.async into the
// same ring.  The epilogue works in the accumulator layout: x is loaded
// (during the last stage's product where BK = 64), z = x*scale + bias,
// dz = dxn where z > 0, dx = dz*scale rounded to bf16 in pairs, and the
// column sums of dz*x and dz over the block's rows (shuffles, then the
// row warps in order) go to one float32 partial row a block, which the
// wrapper sums in a fixed order.  Where K > BK each column tile stages
// dyt again from L2.
//
// The bf16 forward (fused_matmul_bn_fwd_mma) replaces `_fwd_kernel`
// (fused_block.py:83) on the tensor cores.  At (401408, 64, 256) with the
// prologue it must move 257 MB (x read, y written: 0.077 ms at 3.35
// TB/s) for 13.2 GFLOP, so it is bound by bytes, most of them y's.  The
// FMA tile loaded x two bytes at a time and put each element through the
// prologue as it staged it, and wrote one partial row of s1 and s2 a
// block of 128 rows.  A block of 8 warps owns 128 rows of M x BN columns
// of y (64 where N <= 64, else 128), each warp 32 or 64 rows x 32
// columns, and walks a run of such row blocks (the grid puts a run's
// column tiles side by side while L2 holds its x).  A row block's depth
// runs in steps of 32 of K, or all of K where K <= 64, when the block's
// w slice stays in shared memory for the run: x by cp.async (16 bytes,
// element loads where a start or K does not allow it) into a ring of
// three steps, two ahead; each thread applies the prologue in place to
// the chunks it copied (prologue8: relu(x*scale + bias) in float32,
// rounded to bf16) and zeroes rows past M, where it would be
// relu(bias); one barrier a step publishes the tile, A by ldmatrix.  w
// (K, N) is row-major, B's (k, n) layout: ldmatrix.trans.  The epilogue
// rounds y to bf16 in pairs into a staging tile of the warp's own (no
// barrier) and stores the rows inside M from there, 16 bytes a lane, so
// that each store covers whole 32-byte sectors of y (pairs stored from
// the accumulators take four stores a sector, and ran 1.5x slower at the
// launch above on an H100 SXM); the column sums of the
// rounded y and y^2 stay in registers for the run and are reduced by
// shuffles, then across the row warps in order, into one float32
// partial row a run, which the wrapper sums in a fixed order.

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

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };  // kDw: the tensor-core tiles

template <typename T>
struct Args {
  const T* x;           // (M, K)
  const T* w;           // (K, N)
  const float* scale;   // (K,), read only with the prologue
  const float* bias;    // (K,)
  const T* y;           // (M, N), the forward's output (dx, dw)
  const T* dy;          // (M, N) (dx, dw)
  const float* ds1;     // (N,) (dx, dw)
  const float* ds2;     // (N,)
  T* out;               // forward: y (M, N); dx: dx (M, K)
  float* part0;         // forward: s1 rows; dx: dscale rows; dw: dw parts
  float* part1;         // forward: s2 rows; dx: dbias rows
  int64_t M;
  int K;
  int N;
  int prologue;
  int64_t split_rows;   // dw: rows of M each split takes; bf16 forward: a run
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// relu(x*scale + bias) rounded to T, or x itself, at (m, k)
template <typename T>
__device__ __forceinline__ float prologue_at(const Args<T>& a, int64_t m,
                                             int k) {
  const float v = to_float(a.x[m * a.K + k]);
  if (!a.prologue) return v;
  return round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v, a.scale[k]), a.bias[k]),
                           0.f));
}

// dyt = dy + ds1 + 2*y*ds2 rounded to T, at (m, n)
template <typename T>
__device__ __forceinline__ float dyt_at(const Args<T>& a, int64_t m, int n) {
  const int64_t at = m * a.N + n;
  const float v = __fadd_rn(
      __fadd_rn(to_float(a.dy[at]), a.ds1[n]),
      __fmul_rn(__fmul_rn(2.f, to_float(a.y[at])), a.ds2[n]));
  return round_to<T>(v);
}

// A[i][r] for i < I, r < r_end (else 0).  Element e of the staged slice
// maps to (i, r) along A's contiguous axis in device memory: forward, A
// = P(x) with r = k; dx, A = dyt with r = n.
template <int MODE, typename T>
__device__ __forceinline__ float fetch_a(const Args<T>& a, int e, int64_t i0,
                                         int64_t r0, int64_t I, int64_t r_end,
                                         int* si, int* sr) {
  const int r = e % BR, i = e / BR;
  *si = i;
  *sr = r;
  const int64_t gi = i0 + i, gr = r0 + r;
  if (gi >= I || gr >= r_end) return 0.f;
  if (MODE == kFwd) return prologue_at(a, gi, static_cast<int>(gr));
  return dyt_at(a, gi, static_cast<int>(gr));
}

// B[r][j] for r < r_end, j < J (else 0), along B's contiguous axis:
// forward, B = w (r = k); dx, B = w^T (r = n, j = k; w runs along n).
template <int MODE, typename T>
__device__ __forceinline__ float fetch_b(const Args<T>& a, int e, int64_t j0,
                                         int64_t r0, int64_t J, int64_t r_end,
                                         int* sj, int* sr) {
  int j, r;
  if (MODE == kDx) {
    r = e % BR;
    j = e / BR;
  } else {
    j = e % BJ;
    r = e / BJ;
  }
  *sj = j;
  *sr = r;
  const int64_t gj = j0 + j, gr = r0 + r;
  if (gj >= J || gr >= r_end) return 0.f;
  if (MODE == kFwd) return to_float(a.w[gr * a.N + gj]);
  return to_float(a.w[gj * a.N + gr]);
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
    float (*red1)[BJ], int tx, int ty, int64_t j0, int64_t J, float* dst0,
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

template <int MODE, typename T>
__device__ __forceinline__ void fused_mm_bn(const Args<T>& a) {
  // rows padded by 4 floats: the staging stores of a warp then hit 32
  // distinct banks, and every row stays 16-byte aligned for the float4
  // reads
  __shared__ __align__(16) float As[BR][BI + 4];
  __shared__ __align__(16) float Bs[BR][BJ + 4];
  __shared__ float red0[THREADS / 16][BJ];
  __shared__ float red1[THREADS / 16][BJ];

  // C is (M, N) in the forward, (M, K) in dx; the depth K or N
  const int64_t I = a.M, J = MODE == kFwd ? a.N : a.K;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BJ;
  const int64_t r_begin = 0, r_end = MODE == kFwd ? a.K : a.N;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  float va[LOADS], vb[LOADS];
  int ai[LOADS], ar[LOADS], bj[LOADS], br[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) {
    va[l] = fetch_a<MODE>(a, tid + l * THREADS, i0, r_begin, I, r_end,
                          &ai[l], &ar[l]);
    vb[l] = fetch_b<MODE>(a, tid + l * THREADS, j0, r_begin, J, r_end,
                          &bj[l], &br[l]);
  }
  for (int64_t r0 = r_begin; r0 < r_end; r0 += BR) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      As[ar[l]][ai[l]] = va[l];
      Bs[br[l]][bj[l]] = vb[l];
    }
    __syncthreads();
    if (r0 + BR < r_end) {  // the next slice's loads overlap this product
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        va[l] = fetch_a<MODE>(a, tid + l * THREADS, i0, r0 + BR, I, r_end,
                              &ai[l], &ar[l]);
        vb[l] = fetch_b<MODE>(a, tid + l * THREADS, j0, r0 + BR, J, r_end,
                              &bj[l], &br[l]);
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
      const int64_t m = i0 + slot(ty, p);
      if (m >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t n = j0 + slot(tx, q);
        if (n >= J) continue;
        const T yv = from_float<T>(acc[p][q]);
        a.out[m * a.N + n] = yv;
        const float f = to_float(yv);
        c0[q] += f;
        c1[q] += f * f;
      }
    }
  } else {  // dx
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t m = i0 + slot(ty, p);
      if (m >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t k = j0 + slot(tx, q);
        if (k >= J) continue;
        const float d = acc[p][q];
        if (a.prologue) {
          const float xv = to_float(a.x[m * a.K + k]);
          const float sc = a.scale[k];
          const float z = __fadd_rn(__fmul_rn(xv, sc), a.bias[k]);
          const float dz = z > 0.f ? d : 0.f;
          a.out[m * a.K + k] = from_float<T>(__fmul_rn(dz, sc));
          c0[q] += dz * xv;
          c1[q] += dz;
        } else {
          a.out[m * a.K + k] = from_float<T>(d);
        }
      }
    }
    if (!a.prologue) return;  // uniform across the block
  }
  const int64_t row = static_cast<int64_t>(blockIdx.x) * J;
  column_partials(c0, c1, red0, red1, tx, ty, j0, J, a.part0 + row,
                  a.part1 + row);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_matmul_bn_fwd_kernel(Args<T> a) {
  fused_mm_bn<kFwd>(a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_matmul_bn_dx_kernel(Args<T> a) {
  fused_mm_bn<kDx>(a);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------
// dw in bfloat16 on the tensor cores.  See the note at the top.

using mx::a_ptr;
using mx::b_ptr;
using mx::bf16;
using mx::dyt8;
using mx::ldsm_x4_t;
using mx::load8;
using mx::mma;
using mx::prologue8;

constexpr int kTcBK = 64;                   // rows of dw a block owns
constexpr int kTcBM = 32;                   // rows of M a stage holds
constexpr int kTcThreads = 128;             // 4 warps, 2 x 2 over the tile
constexpr int kTcXLd = kTcBK + 8;           // bf16 row stride: 16 bytes pad
constexpr int kTcXChunks = kTcBM * kTcBK / 8 / kTcThreads;  // uint4 a thread

template <int BN>
struct DwTc {
  static constexpr int kLd = BN + 8;                      // dyt row stride
  static constexpr int kChunks = kTcBM * BN / 8 / kTcThreads;  // uint4
  static constexpr int kRowChunks = BN / 8;               // uint4 a row
  static constexpr int kRowStep = kTcThreads / kRowChunks;  // rows apart
  static constexpr int kN8 = BN / 16;                     // n8 tiles a warp
};

// Grid (ceil(K / 64), ceil(N / BN), splits); block z takes rows
// [z * split_rows, min(M, (z + 1) * split_rows)) of M and writes its
// float32 partial of dw to part0[z].  vec bit 0: x loads 16 bytes at a
// time; bit 1: y and dy do.
template <int BN>
__global__ void __launch_bounds__(kTcThreads)
    fused_matmul_bn_dw_mma(Args<bf16> a, int vec) {
  using G = DwTc<BN>;
  __shared__ __align__(16) unsigned short xs_raw[2][kTcBM * kTcXLd];
  __shared__ __align__(16) unsigned short ds_raw[2][kTcBM * G::kLd];
  __shared__ __align__(16) float sc_s[kTcBK], bi_s[kTcBK];
  __shared__ __align__(16) float d1_s[BN], d2_s[BN];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wk = warp & 1, wn = warp >> 1;   // the warp's 32 x BN/2 tile
  const int k0 = blockIdx.x * kTcBK, n0 = blockIdx.y * BN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * a.split_rows;
  const int64_t r_end =
      r_begin + a.split_rows < a.M ? r_begin + a.split_rows : a.M;
  const bool vec_x = vec & 1, vec_y = vec & 2;

  // per-column constants, 0 past K and N (a zero column stays zero)
  for (int i = tid; i < kTcBK; i += kTcThreads) {
    const bool in = a.prologue && k0 + i < a.K;
    sc_s[i] = in ? a.scale[k0 + i] : 0.f;
    bi_s[i] = in ? a.bias[k0 + i] : 0.f;
  }
  for (int i = tid; i < BN; i += kTcThreads) {
    const bool in = n0 + i < a.N;
    d1_s[i] = in ? a.ds1[n0 + i] : 0.f;
    d2_s[i] = in ? a.ds2[n0 + i] : 0.f;
  }

  // this thread's chunks: x rows xr + 16 i at columns xc .. xc + 7 of
  // the tile; y and dy rows dr + kRowStep i at columns dc .. dc + 7
  const int xc = (tid % (kTcBK / 8)) * 8, xr = tid / (kTcBK / 8);
  const int dc = (tid % G::kRowChunks) * 8, dr = tid / G::kRowChunks;
  constexpr int kXStep = kTcThreads / (kTcBK / 8);
  uint4 xv[kTcXChunks], yv[G::kChunks], gv[G::kChunks];

  auto load_stage = [&](int64_t m0) {
#pragma unroll
    for (int i = 0; i < kTcXChunks; ++i) {
      const int64_t m = m0 + xr + kXStep * i;
      const bool in = m < r_end;
      xv[i] = load8(a.x + (in ? m : 0) * a.K, k0 + xc, a.K, in, vec_x);
    }
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int64_t m = m0 + dr + G::kRowStep * i;
      const bool in = m < r_end;
      const int64_t row = (in ? m : 0) * a.N;
      yv[i] = load8(a.y + row, n0 + dc, a.N, in, vec_y);
      gv[i] = load8(a.dy + row, n0 + dc, a.N, in, vec_y);
    }
  };

  float acc[2][G::kN8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < G::kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_stage(r_begin);
  __syncthreads();  // the constants
  int buf = 0;
  for (int64_t m0 = r_begin; m0 < r_end; m0 += kTcBM, buf ^= 1) {
    bf16* xs = reinterpret_cast<bf16*>(xs_raw[buf]);
    bf16* ds = reinterpret_cast<bf16*>(ds_raw[buf]);
    // stage the rows: prologue and dyt rounded to bf16, 0 past the run
    {
      float sc[8], bi[8], d1[8], d2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = sc_s[xc + j];
        bi[j] = bi_s[xc + j];
        d1[j] = d1_s[dc + j];
        d2[j] = d2_s[dc + j];
      }
#pragma unroll
      for (int i = 0; i < kTcXChunks; ++i) {
        const int r = xr + kXStep * i;
        uint4 v = xv[i];  // 0 past the run and past K already
        if (a.prologue)
          v = m0 + r < r_end ? prologue8(v, sc, bi) : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(xs + r * kTcXLd + xc) = v;
      }
#pragma unroll
      for (int i = 0; i < G::kChunks; ++i) {
        const int r = dr + G::kRowStep * i;
        *reinterpret_cast<uint4*>(ds + r * G::kLd + dc) =
            m0 + r < r_end ? dyt8(yv[i], gv[i], d1, d2)
                           : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // the next stage's loads are in flight while this one multiplies; the
    // other buffer is free: every warp left its product at the barrier
    if (m0 + kTcBM < r_end) load_stage(m0 + kTcBM);
#pragma unroll
    for (int kk = 0; kk < kTcBM / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)  // A = P(x)^T: rows k, depth m
        ldsm_x4_t(af[i], b_ptr<kTcXLd>(xs, 16 * kk, 32 * wk + 16 * i));
#pragma unroll
      for (int p = 0; p < G::kN8 / 2; ++p) {  // B = dyt: depth m, cols n
        uint32_t bf[4];
        ldsm_x4_t(bf, a_ptr<G::kLd>(ds, 16 * kk, (BN / 2) * wn + 16 * p));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * p], af[i], bf[0], bf[1]);
          mma(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  // this run's float32 partial: acc[i][j][e] at row 16 i + g + 8 (e / 2),
  // column 8 j + 2 t + e % 2 of the warp's tile
  float* dst = a.part0 + static_cast<int64_t>(blockIdx.z) * a.K * a.N;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (a.N & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 32 * wk + 16 * i + g + 8 * h;
      if (k >= a.K) continue;
      float* out = dst + static_cast<int64_t>(k) * a.N;
#pragma unroll
      for (int j = 0; j < G::kN8; ++j) {
        const int n = n0 + (BN / 2) * wn + 8 * j + 2 * t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && n + 1 < a.N) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else {
          if (n < a.N) out[n] = v0;
          if (n + 1 < a.N) out[n + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------
// dx in bfloat16 on the tensor cores.  See the note at the top.

using mx::cp_async16;
using mx::cp_async_commit;
using mx::cp_async_wait;
using mx::ldsm_x4;
using mx::unpack;

constexpr int kDxBM = BI;         // rows of M a block owns: a partial row
constexpr int kDxBN = 32;         // depth (columns of y and dy) a stage
constexpr int kDxThreads = 256;   // 8 warps: 4 over rows x 2 over columns
constexpr int kDxRing = 3;        // stages: two load while one multiplies
constexpr int kDxLd = kDxBN + 8;  // bf16 row stride: 16 bytes pad
constexpr int kDxRowChunks = kDxBN / 8;                // uint4 a stage row
constexpr int kDxRowStep = kDxThreads / kDxRowChunks;  // a thread's rows
constexpr int kDxYChunks = kDxBM / kDxRowStep;         // apart: 64

// BK columns of dx a block (64 or 128): each warp BK/2 of them.  Shared
// memory: the ring (a slot: y, dy and w rows, bf16), then float32
// scale and bias of the tile's columns, the epilogue's [2][4][BK] column
// sums, and a slot's ds1 and ds2 (kDxBN each) for each ring slot.
template <int BK>
struct DxTc {
  static constexpr int kNI = BK / 16;                // n8 tiles a warp
  static constexpr int kWChunks = BK / kDxRowStep;   // uint4 of w a thread
  static constexpr int kSlot = (2 * kDxBM + BK) * kDxLd;  // y, dy, w
  static constexpr size_t kSmem =
      kDxRing * kSlot * sizeof(bf16) +
      (2 * BK + 2 * 4 * BK + kDxRing * 2 * kDxBN) * sizeof(float);
};

// Grid (ceil(M / 128) * ceil(K / BK)): block b takes rows [128 m, 128 (m
// + 1)) of M and columns [BK k, BK (k + 1)) of dx, with m = b / ktiles
// and k = b % ktiles, so that the column tiles of the same rows run side
// by side while L2 holds their y and dy.  With the prologue it writes
// its float32 column sums of dz*x and dz to part0[m] and part1[m].  vec
// bit 0: x loads 4 bytes a pair; bit 1: y and dy load 16 bytes; bit 2:
// w does.
template <int BK>
__global__ void __launch_bounds__(kDxThreads, 2)
    fused_matmul_bn_dx_mma(Args<bf16> a, int vec) {
  using G = DxTc<BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sc_s = reinterpret_cast<float*>(ring + kDxRing * G::kSlot);
  float* bi_s = sc_s + BK;
  float* red = bi_s + BK;  // [dscale, dbias][row warp][column]
  float* dsl = red + 8 * BK;  // [slot][ds1, ds2][kDxBN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wk = warp >> 2;  // the warp's 32 x BK/2 tile
  const int g = lane >> 2, t4 = lane & 3;
  const int ktiles = (a.K + BK - 1) / BK;
  const int64_t mt = blockIdx.x / ktiles;
  const int k0 = static_cast<int>(blockIdx.x - mt * ktiles) * BK;
  const int64_t m0 = mt * kDxBM;
  const int stages = (a.N + kDxBN - 1) / kDxBN;
  const bool vec_x = vec & 1, vec_y = vec & 2, vec_w = vec & 4;

  // per-column constants, 0 past K (a zero column stays zero)
  for (int i = tid; i < BK; i += kDxThreads) {
    const bool in = a.prologue && k0 + i < a.K;
    sc_s[i] = in ? a.scale[k0 + i] : 0.f;
    bi_s[i] = in ? a.bias[k0 + i] : 0.f;
  }

  // This thread's chunks: rows r0 + 64 i of the stage's y and dy (and
  // of w), columns cc .. cc + 7 of its depth.  It loads them and turns
  // its y and dy into dyt itself, so no barrier separates the two.
  const int cc = (tid % kDxRowChunks) * 8, r0 = tid / kDxRowChunks;

  // Loads stage st (columns [32 st, 32 st + 32) of y, dy and w, and of
  // ds1 and ds2, 0 past N) into ring slot `slot` (cp.async of 16 bytes,
  // zeros where a chunk lies outside; element loads where a start or a
  // width does not allow 16 bytes) and returns its flags: bit i, chunk
  // i's row lies in M.  ds1 and ds2 wait in shared memory rather than in
  // registers while the product's sums are live.
  auto fetch_stage = [&](int st, int slot) {
    const int n0 = st * kDxBN;
    bf16* ys = ring + slot * G::kSlot;
    bf16* ds = ys + kDxBM * kDxLd;
    bf16* ws = ds + kDxBM * kDxLd;
    unsigned flags = 0;
    if (tid < kDxBN) {
      const int n = n0 + tid;
      dsl[slot * 2 * kDxBN + tid] = n < a.N ? a.ds1[n] : 0.f;
      dsl[(slot * 2 + 1) * kDxBN + tid] = n < a.N ? a.ds2[n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDxYChunks; ++i) {
      const int r = r0 + kDxRowStep * i;
      const int64_t m = m0 + r;
      const bool in = m < a.M;
      flags |= (in ? 1u : 0u) << i;
      const int64_t off = (in ? m : 0) * a.N;
      bf16* yd = ys + r * kDxLd + cc;
      bf16* dd = ds + r * kDxLd + cc;
      if (vec_y) {
        const bool full = in && n0 + cc < a.N;
        cp_async16(yd, full ? a.y + off + n0 + cc : a.y, full);
        cp_async16(dd, full ? a.dy + off + n0 + cc : a.dy, full);
      } else {
        *reinterpret_cast<uint4*>(yd) =
            load8(a.y + off, n0 + cc, a.N, in, false);
        *reinterpret_cast<uint4*>(dd) =
            load8(a.dy + off, n0 + cc, a.N, in, false);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kWChunks; ++i) {
      const int r = r0 + kDxRowStep * i;
      const bool in = k0 + r < a.K;
      const bf16* wr = a.w + (in ? static_cast<int64_t>(k0 + r) : 0) * a.N;
      bf16* wd = ws + r * kDxLd + cc;
      if (vec_w) {
        const bool full = in && n0 + cc < a.N;
        cp_async16(wd, full ? wr + n0 + cc : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(wd) = load8(wr, n0 + cc, a.N, in, false);
      }
    }
    return flags;
  };

  // x[m, k] and x[m, k + 1] as a bf16 pair, 0 past M and K
  auto x_pair = [&](int64_t m, int k) -> uint32_t {
    if (m >= a.M || k >= a.K) return 0u;
    const unsigned short* p =
        reinterpret_cast<const unsigned short*>(a.x + m * a.K + k);
    if (vec_x) return __ldg(reinterpret_cast<const unsigned int*>(p));
    return static_cast<uint32_t>(p[0]) |
           (k + 1 < a.K ? static_cast<uint32_t>(p[1]) << 16 : 0u);
  };

  float acc[2][G::kNI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < G::kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the first kDxRing - 1 stages in flight, one group a stage (empty
  // past the depth), so that a wait counts stages
  unsigned ring_flags = 0;  // kDxYChunks bits a slot
#pragma unroll
  for (int k = 0; k < kDxRing - 1; ++k) {
    if (k < stages) ring_flags |= fetch_stage(k, k) << (kDxYChunks * k);
    cp_async_commit();
  }
  __syncthreads();  // the first stages' ds1 and ds2, written by others
  // x at this thread's places of dx, loaded during the last stage's
  // product where the registers allow (BK = 64)
  uint32_t xv[2][2][BK == 64 ? G::kNI : 1];
  int slot = 0;
  for (int st = 0; st < stages; ++st) {
    bf16* ys = ring + slot * G::kSlot;
    bf16* ds = ys + kDxBM * kDxLd;
    const bf16* ws = ds + kDxBM * kDxLd;
    cp_async_wait<kDxRing - 2>();  // this thread's chunks of stage st
    {  // dyt in place of dy, rounded to bf16; 0 past M (it is ds1 there)
      const float* d1 = dsl + slot * 2 * kDxBN + cc;
      const float* d2 = d1 + kDxBN;
      const unsigned flags = ring_flags >> (kDxYChunks * slot);
#pragma unroll
      for (int i = 0; i < kDxYChunks; ++i) {
        const int r = r0 + kDxRowStep * i;
        uint4* d = reinterpret_cast<uint4*>(ds + r * kDxLd + cc);
        *d = flags >> i & 1
                 ? dyt8(*reinterpret_cast<const uint4*>(ys + r * kDxLd + cc),
                        *d, d1, d2)
                 : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // stage st + kDxRing - 1 into the slot that stage st - 1 left: every
    // warp left its product at the barrier
    const int next = slot == 0 ? kDxRing - 1 : slot - 1;
    if (st + kDxRing - 1 < stages)
      ring_flags =
          (ring_flags & ~(((1u << kDxYChunks) - 1) << (kDxYChunks * next))) |
          fetch_stage(st + kDxRing - 1, next) << (kDxYChunks * next);
    cp_async_commit();
    if constexpr (BK == 64) {
      if (st == stages - 1 && a.prologue) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < G::kNI; ++j)
              xv[i][h][j] = x_pair(m0 + 32 * wm + 16 * i + g + 8 * h,
                                   k0 + 32 * wk + 8 * j + 2 * t4);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDxBN / 16; ++kk) {
      uint32_t af[2][4];  // A = dyt: rows m, depth n
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(af[i], a_ptr<kDxLd>(ds, 32 * wm + 16 * i, 16 * kk));
#pragma unroll
      for (int p = 0; p < G::kNI / 2; ++p) {  // B = w^T: w's rows are (k, n)
        uint32_t bf[4];
        ldsm_x4(bf, b_ptr<kDxLd>(ws, (BK / 2) * wk + 16 * p, 16 * kk));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * p], af[i], bf[0], bf[1]);
          mma(acc[i][2 * p + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    slot = slot + 1 == kDxRing ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // the ring's empty groups

  // The epilogue in the accumulator layout: acc[i][j][e] is dxn at row
  // 32 wm + 16 i + g + 8 (e / 2), column (BK/2) wk + 8 j + 2 t4 + e % 2
  // of the tile.  With the prologue: z = x*scale + bias, dz = dxn where
  // z > 0, dx = dz*scale rounded to bf16, and the columns' sums of dz*x
  // and dz over the block's rows: over this thread's four rows, the 8
  // rows of each lane quad by shuffles, then the row warps in order.
  const bool pairs = (a.K & 1) == 0;  // bf16 pairs stay 4-byte aligned
#pragma unroll
  for (int j = 0; j < G::kNI; ++j) {
    const int kl = (BK / 2) * wk + 8 * j + 2 * t4;  // the tile's column
    const int k = k0 + kl;
    const float sc0 = sc_s[kl], sc1 = sc_s[kl + 1];
    const float bi0 = bi_s[kl], bi1 = bi_s[kl + 1];
    float dsc0 = 0.f, dsc1 = 0.f, dbi0 = 0.f, dbi1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + 32 * wm + 16 * i + g + 8 * h;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (a.prologue) {
          uint32_t xr;
          if constexpr (BK == 64)
            xr = xv[i][h][j];
          else
            xr = x_pair(m, k);
          const float2 xf = unpack(xr);
          const float dz0 =
              __fadd_rn(__fmul_rn(xf.x, sc0), bi0) > 0.f ? v0 : 0.f;
          const float dz1 =
              __fadd_rn(__fmul_rn(xf.y, sc1), bi1) > 0.f ? v1 : 0.f;
          dsc0 += dz0 * xf.x;
          dsc1 += dz1 * xf.y;
          dbi0 += dz0;
          dbi1 += dz1;
          v0 = __fmul_rn(dz0, sc0);
          v1 = __fmul_rn(dz1, sc1);
        }
        if (m >= a.M) continue;
        bf16* out = a.out + m * a.K + k;
        const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
        if (pairs && k + 1 < a.K) {
          *reinterpret_cast<__nv_bfloat162*>(out) = v;
        } else {
          if (k < a.K) out[0] = v.x;
          if (k + 1 < a.K) out[1] = v.y;
        }
      }
    if (a.prologue) {  // uniform across the block
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        dsc0 += __shfl_xor_sync(0xffffffffu, dsc0, off);
        dsc1 += __shfl_xor_sync(0xffffffffu, dsc1, off);
        dbi0 += __shfl_xor_sync(0xffffffffu, dbi0, off);
        dbi1 += __shfl_xor_sync(0xffffffffu, dbi1, off);
      }
      if (g == 0) {
        red[wm * BK + kl] = dsc0;
        red[wm * BK + kl + 1] = dsc1;
        red[(4 + wm) * BK + kl] = dbi0;
        red[(4 + wm) * BK + kl + 1] = dbi1;
      }
    }
  }
  if (!a.prologue) return;
  __syncthreads();
  if (tid < BK && k0 + tid < a.K) {
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      v0 += red[w * BK + tid];
      v1 += red[(4 + w) * BK + tid];
    }
    const int64_t at = mt * a.K + k0 + tid;
    a.part0[at] = v0;
    a.part1[at] = v1;
  }
}

template <int BK>
cudaError_t launch_dx_mma(const Args<bf16>& a, int vec, cudaStream_t stream) {
  const int64_t blocks = ceil_div(a.M, kDxBM) * ceil_div(a.K, BK);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr size_t smem = DxTc<BK>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_matmul_bn_dx_mma<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_matmul_bn_dx_mma<BK><<<static_cast<unsigned>(blocks), kDxThreads,
                               smem, stream>>>(a, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// dw in float32 on the tensor cores (3xTF32).  See the note at the top.

using mx::dyt4;
using mx::load4;
using mx::mma_3xtf32;
using mx::prologue4;
using mx::split_tf32;

constexpr int kTfBK = 64;          // rows of dw a block owns
constexpr int kTfBM = 16;          // rows of M a stage holds
constexpr int kTfSteps = kTfBM / 8;  // its k8 steps
constexpr int kTfThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kTfRing = 3;         // stages: two load while one multiplies
constexpr int kTfXLd = kTfBK + 8;  // float row stride: 8 mod 32 banks
constexpr int kTfXRowChunks = kTfBK / 4;              // float4 an x row
constexpr int kTfXStep = kTfThreads / kTfXRowChunks;  // a thread's x rows
constexpr int kTfXChunks = kTfBM / kTfXStep;          // apart: 8

// BN columns of dw a block (64 or 128), each warp BN/2 of them.  A ring
// slot holds a stage: x (kTfBM rows of kTfXLd floats), y (rows of BN)
// and dy, turned into dyt in place (rows of kLd); after the ring, the
// per-column constants.  The padded strides are 8 mod 32 floats, so the
// 32 lanes of a fragment load, at rows t4 and columns g, read 32
// distinct banks.
template <int BN>
struct DwTf {
  static constexpr int kLd = BN + 8;
  static constexpr int kXTile = kTfBM * kTfXLd;
  static constexpr int kYTile = kTfBM * BN;
  static constexpr int kSlot = kXTile + kYTile + kTfBM * kLd;  // floats
  static constexpr size_t kSmem =
      (kTfRing * kSlot + 2 * kTfBK + 2 * BN) * sizeof(float);
  static constexpr int kRowChunks = BN / 4;                 // float4 a row
  static constexpr int kRowStep = kTfThreads / kRowChunks;  // a thread's
  static constexpr int kChunks = kTfBM / kRowStep;          // rows apart
  static constexpr int kN8 = BN / 16;                       // n8 tiles a warp
};

// Grid (ceil(K / 64), ceil(N / BN), splits); block z takes rows
// [z * split_rows, min(M, (z + 1) * split_rows)) of M and writes its
// float32 partial of dw to part0[z].  vec bit 0: x loads 16 bytes at a
// time; bit 1: y and dy do.
template <int BN>
__global__ void __launch_bounds__(kTfThreads, 3)
    fused_matmul_bn_dw_tf32(Args<float> a, int vec) {
  using G = DwTf<BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* sc_s = ring + kTfRing * G::kSlot;
  float* bi_s = sc_s + kTfBK;
  float* d1_s = bi_s + kTfBK;
  float* d2_s = d1_s + BN;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wk = warp & 1, wn = warp >> 1;  // the warp's 32 x BN/2 tile
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kTfBK, n0 = blockIdx.y * BN;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * a.split_rows;
  const int64_t r_end =
      r_begin + a.split_rows < a.M ? r_begin + a.split_rows : a.M;
  const int64_t stages = (r_end - r_begin + kTfBM - 1) / kTfBM;
  const bool vec_x = vec & 1, vec_y = vec & 2;

  // This thread's chunks: x rows xr + 8 i at columns xc .. xc + 3 of the
  // tile, y and dy rows dr + kRowStep i at columns dc .. dc + 3.  It
  // copies them and stages them itself, so no barrier separates the two
  // (one barrier publishes the constants).
  const int xc = (tid % kTfXRowChunks) * 4, xr = tid / kTfXRowChunks;
  const int dc = (tid % G::kRowChunks) * 4, dr = tid / G::kRowChunks;
  // per-column constants, 0 past K and N (a zero column stays zero)
  for (int i = tid; i < kTfBK; i += kTfThreads) {
    const bool in = a.prologue && k0 + i < a.K;
    sc_s[i] = in ? a.scale[k0 + i] : 0.f;
    bi_s[i] = in ? a.bias[k0 + i] : 0.f;
  }
  for (int i = tid; i < BN; i += kTfThreads) {
    const bool in = n0 + i < a.N;
    d1_s[i] = in ? a.ds1[n0 + i] : 0.f;
    d2_s[i] = in ? a.ds2[n0 + i] : 0.f;
  }

  // Loads stage st into ring slot `slot`: cp.async of 16 bytes, zeros
  // where a chunk lies past the run or past K (N); element loads where a
  // start or a row width does not allow 16 bytes.
  auto fetch = [&](int64_t st, int slot) {
    const int64_t m0 = r_begin + st * kTfBM;
    float* xs = ring + slot * G::kSlot;
    float* ys = xs + G::kXTile;
    float* ds = ys + G::kYTile;
#pragma unroll
    for (int i = 0; i < kTfXChunks; ++i) {
      const int r = xr + kTfXStep * i;
      const int64_t m = m0 + r;
      const bool in = m < r_end;
      const float* src = a.x + (in ? m : 0) * a.K;
      float* d = xs + r * kTfXLd + xc;
      if (vec_x) {
        const bool full = in && k0 + xc < a.K;
        cp_async16(d, full ? src + k0 + xc : a.x, full);
      } else {
        *reinterpret_cast<float4*>(d) = load4(src, k0 + xc, a.K, in);
      }
    }
#pragma unroll
    for (int i = 0; i < G::kChunks; ++i) {
      const int r = dr + G::kRowStep * i;
      const int64_t m = m0 + r;
      const bool in = m < r_end;
      const int64_t off = (in ? m : 0) * a.N;
      float* yd = ys + r * BN + dc;
      float* dd = ds + r * G::kLd + dc;
      if (vec_y) {
        const bool full = in && n0 + dc < a.N;
        cp_async16(yd, full ? a.y + off + n0 + dc : a.y, full);
        cp_async16(dd, full ? a.dy + off + n0 + dc : a.dy, full);
      } else {
        *reinterpret_cast<float4*>(yd) = load4(a.y + off, n0 + dc, a.N, in);
        *reinterpret_cast<float4*>(dd) = load4(a.dy + off, n0 + dc, a.N, in);
      }
    }
  };

  float acc[2][G::kN8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < G::kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the first kTfRing - 1 stages in flight, one group a stage (empty
  // past the run), so that a wait counts stages
#pragma unroll
  for (int k = 0; k < kTfRing - 1; ++k) {
    if (k < stages) fetch(k, k);
    cp_async_commit();
  }
  __syncthreads();  // the constants
  int slot = 0;
  for (int64_t st = 0; st < stages; ++st) {
    float* xs = ring + slot * G::kSlot;
    const float* ys = xs + G::kXTile;
    float* ds = xs + G::kXTile + G::kYTile;
    cp_async_wait<kTfRing - 2>();  // this thread's chunks of stage st
    {  // the prologue in place of x and dyt in place of dy, in float32;
       // 0 past the run (relu(bias) and ds1 there)
      const int64_t m0 = r_begin + st * kTfBM;
      float sc[4], bi[4], d1[4], d2[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[j] = sc_s[xc + j];
        bi[j] = bi_s[xc + j];
        d1[j] = d1_s[dc + j];
        d2[j] = d2_s[dc + j];
      }
      if (a.prologue) {
#pragma unroll
        for (int i = 0; i < kTfXChunks; ++i) {
          const int r = xr + kTfXStep * i;
          float4* p = reinterpret_cast<float4*>(xs + r * kTfXLd + xc);
          *p = m0 + r < r_end ? prologue4(*p, sc, bi)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int i = 0; i < G::kChunks; ++i) {
        const int r = dr + G::kRowStep * i;
        float4* p = reinterpret_cast<float4*>(ds + r * G::kLd + dc);
        *p = m0 + r < r_end
                 ? dyt4(*reinterpret_cast<const float4*>(ys + r * BN + dc),
                        *p, d1, d2)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();
    // stage st + kTfRing - 1 into the slot that stage st - 1 left: every
    // warp left its product at the barrier
    const int next = slot == 0 ? kTfRing - 1 : slot - 1;
    if (st + kTfRing - 1 < stages) fetch(st + kTfRing - 1, next);
    cp_async_commit();
    // A = P(x)^T: rows k, depth m, both k8 steps of the stage, split
    // into tf32 hi + lo as loaded
    uint32_t ah[kTfSteps][2][4], al[kTfSteps][2][4];
#pragma unroll
    for (int kk = 0; kk < kTfSteps; ++kk)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = xs + (8 * kk + t4) * kTfXLd + 32 * wk + 16 * i + g;
        split_tf32(p[0], ah[kk][i][0], al[kk][i][0]);
        split_tf32(p[8], ah[kk][i][1], al[kk][i][1]);
        split_tf32(p[4 * kTfXLd], ah[kk][i][2], al[kk][i][2]);
        split_tf32(p[4 * kTfXLd + 8], ah[kk][i][3], al[kk][i][3]);
      }
    // B = dyt: depth m, columns n.  The stage's products go into a part
    // that starts at 0, and the part into acc, rounded to nearest: the
    // tensor core truncates each sum, and a chain of every product of a
    // run in one register drifts by as many ulps, past the float32
    // tolerance at ResNet-50's shapes; six products a chain keep the
    // drift of each part far below its rounding.
#pragma unroll
    for (int j = 0; j < G::kN8; ++j) {
      float part[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTfSteps; ++kk) {
        const float* q =
            ds + (8 * kk + t4) * G::kLd + (BN / 2) * wn + 8 * j + g;
        uint32_t bh[2], bl[2];
        split_tf32(q[0], bh[0], bl[0]);
        split_tf32(q[4 * G::kLd], bh[1], bl[1]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          mma_3xtf32(part[i], ah[kk][i], al[kk][i], bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][e]);
    }
    slot = slot + 1 == kTfRing ? 0 : slot + 1;
  }
  cp_async_wait<0>();  // the ring's empty groups

  // this run's float32 partial: acc[i][j][e] at row 16 i + g + 8 (e / 2),
  // column 8 j + 2 t4 + e % 2 of the warp's tile
  float* dst = a.part0 + static_cast<int64_t>(blockIdx.z) * a.K * a.N;
  const bool pairs = (a.N & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 32 * wk + 16 * i + g + 8 * h;
      if (k >= a.K) continue;
      float* out = dst + static_cast<int64_t>(k) * a.N;
#pragma unroll
      for (int j = 0; j < G::kN8; ++j) {
        const int n = n0 + (BN / 2) * wn + 8 * j + 2 * t4;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && n + 1 < a.N) {
          *reinterpret_cast<float2*>(out + n) = make_float2(v0, v1);
        } else {
          if (n < a.N) out[n] = v0;
          if (n + 1 < a.N) out[n + 1] = v1;
        }
      }
    }
}

template <int BN>
cudaError_t launch_dw_tf32(const Args<float>& a, int64_t splits, int vec,
                           cudaStream_t stream) {
  const int64_t gi = ceil_div(a.K, kTfBK), gj = ceil_div(a.N, BN);
  if (gi > 0x7fffffff || gj > 65535 || splits > 65535 || splits <= 0 ||
      a.split_rows % kTfBM != 0)
    return cudaErrorInvalidValue;
  constexpr size_t smem = DwTf<BN>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_matmul_bn_dw_tf32<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj),
            static_cast<unsigned>(splits));
  fused_matmul_bn_dw_tf32<BN><<<grid, kTfThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The forward in bfloat16 on the tensor cores.  See the note at the top.

constexpr int kFmBM = BI;        // rows of M a row block: 128
constexpr int kFmThreads = 256;  // 8 warps over 128 rows x BN columns
constexpr int kFmRing = 3;       // steps: two load while one multiplies

// fused_matmul_bn_fwd_mma's tile: BN columns of y a block (64, or 128
// where N > 64), KC of K a step.  RES (K <= KC = 64): the block's w
// slice stays in shared memory for its run; else KC = 32 and w streams
// through the ring with x, a chunk a step.  Shared memory: the x ring,
// w, each warp's staging tile of y (its rows x 32 columns, rows padded
// by 16 bytes), then the [s1, s2][row warp][column] sums of the
// epilogue.
template <int BN, int KC, bool RES>
struct FmTc {
  static constexpr int kWarpsN = BN / 32;          // 32 columns a warp
  static constexpr int kWarpsM = 8 / kWarpsN;
  static constexpr int kMw = kFmBM / kWarpsM;      // rows a warp
  static constexpr int kMI = kMw / 16;             // its m16 tiles
  static constexpr int kXLd = KC + 8;              // bf16 row strides: 16
  static constexpr int kWLd = BN + 8;              // bytes of pad
  static constexpr int kXTile = kFmBM * kXLd;
  static constexpr int kWTile = KC * kWLd;
  static constexpr int kRowChunks = KC / 8;        // uint4 of an x row
  static constexpr int kRowStep = kFmThreads / kRowChunks;  // a thread's
  static constexpr int kXChunks = kFmBM / kRowStep;         // rows apart
  static constexpr int kWChunks = KC * (BN / 8) / kFmThreads;
  static constexpr int kWTiles = RES ? 1 : kFmRing;
  static constexpr int kYLd = 32 + 8;
  static constexpr int kYTile = kMw * kYLd;        // a warp's y
  static constexpr size_t kSmem =
      (kFmRing * kXTile + kWTiles * kWTile + 8 * kYTile) * sizeof(bf16) +
      2 * kWarpsM * BN * sizeof(float);
};

// Grid (ceil(N / BN), runs): block (j, r) computes columns [j BN, (j + 1)
// BN) of y for the row blocks of run r (a.split_rows rows, the last run
// fewer), a row block at a time, and writes its float32 sums of y and
// y^2 to part0[r], part1[r].  A row block's depth runs in steps of KC of
// K.  vec bit 0: x loads 16 bytes at a time; bit 1: w does; bit 2: y
// stores 16 bytes at a time.
template <int BN, int KC, bool RES>
__global__ void __launch_bounds__(kFmThreads, 2)
    fused_matmul_bn_fwd_mma(Args<bf16> a, int vec) {
  using G = FmTc<BN, KC, RES>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xring = reinterpret_cast<bf16*>(smem);
  bf16* wbuf = xring + kFmRing * G::kXTile;
  bf16* ystage = wbuf + G::kWTiles * G::kWTile;
  float* red = reinterpret_cast<float*>(ystage + 8 * G::kYTile);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % G::kWarpsM, wn = warp / G::kWarpsM;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int64_t m_begin = static_cast<int64_t>(blockIdx.y) * a.split_rows;
  const int64_t m_end =
      a.M - m_begin > a.split_rows ? m_begin + a.split_rows : a.M;
  const int nrb = static_cast<int>((m_end - m_begin + kFmBM - 1) / kFmBM);
  const int nck = (a.K + KC - 1) / KC;  // steps a row block: 1 where RES
  const int nsteps = nrb * nck;
  const bool vec_x = vec & 1, vec_w = vec & 2, vec_y = vec & 4;

  // This thread's x chunks: rows r0 + kRowStep i of a row block, columns
  // cc .. cc + 7 of a step's depth; it loads them and applies the
  // prologue to them itself, so no barrier separates the two.
  const int cc = (tid % G::kRowChunks) * 8, r0 = tid / G::kRowChunks;

  // w[k0 + k][n0 + n] for k < KC, n < BN into a [k][n] tile; 0 past K
  // and N.
  auto load_w = [&](bf16* dst, int k0) {
    constexpr int kCols = BN / 8;
#pragma unroll
    for (int j = 0; j < G::kWChunks; ++j) {
      const int e = tid + kFmThreads * j;
      const int row = e / kCols, col = (e - row * kCols) * 8;
      const bool in = k0 + row < a.K;
      const bf16* src = a.w + (in ? static_cast<int64_t>(k0 + row) : 0) * a.N;
      bf16* d = dst + row * G::kWLd + col;
      if (vec_w) {
        const bool full = in && n0 + col < a.N;
        cp_async16(d, full ? src + n0 + col : a.w, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(src, n0 + col, a.N, in, false);
      }
    }
  };

  // Loads step k of the run into ring slot `slot` (cp.async of 16
  // bytes, zeros where a chunk lies outside; element loads where a start
  // or K does not allow 16 bytes) and returns its flags: bit i, chunk
  // i's row lies in M.
  auto load_step = [&](int k, int slot) {
    const int rb = k / nck, k0 = (k - rb * nck) * KC;
    const int64_t m0 = m_begin + static_cast<int64_t>(rb) * kFmBM;
    unsigned flags = 0;
    bf16* xs = xring + slot * G::kXTile;
#pragma unroll
    for (int i = 0; i < G::kXChunks; ++i) {
      const int r = r0 + G::kRowStep * i;
      const int64_t m = m0 + r;
      const bool in = m < m_end;
      flags |= (in ? 1u : 0u) << i;
      const bf16* src = a.x + (in ? m : 0) * a.K;
      bf16* d = xs + r * G::kXLd + cc;
      if (vec_x) {
        const bool full = in && k0 + cc < a.K;
        cp_async16(d, full ? src + k0 + cc : a.x, full);
      } else {
        *reinterpret_cast<uint4*>(d) = load8(src, k0 + cc, a.K, in, false);
      }
    }
    if (!RES) load_w(wbuf + slot * G::kWTile, k0);
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

  // Row block rb's epilogue: y rounded to bf16 in pairs into the warp's
  // staging tile, the rounded values at rows inside M added to the column
  // sums, the sums cleared; then the tile's rows inside M stored, 16
  // bytes a lane where vec_y allows (whole 32-byte sectors of a row).
  bf16* yst = ystage + warp * G::kYTile;
  auto epilogue = [&](int rb) {
    const int64_t m0 =
        m_begin + static_cast<int64_t>(rb) * kFmBM + G::kMw * wm;
#pragma unroll
    for (int i = 0; i < G::kMI; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * i + g + 8 * hf;
        const bool keep = m0 + r < m_end;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 32 * wn + 8 * j + 2 * t4;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
          acc[i][j][2 * hf] = acc[i][j][2 * hf + 1] = 0.f;
          *reinterpret_cast<__nv_bfloat162*>(yst + r * G::kYLd + 8 * j +
                                             2 * t4) = v;
          if (!keep) continue;
          const float2 f = __bfloat1622float2(v);
          if (n < a.N) {
            s1[j][0] += f.x;
            s2[j][0] += f.x * f.x;
          }
          if (n + 1 < a.N) {
            s1[j][1] += f.y;
            s2[j][1] += f.y * f.y;
          }
        }
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < G::kMw / 8; ++it) {
      const int r = 8 * it + (lane >> 2), n = n0 + 32 * wn + 8 * (lane & 3);
      const int64_t m = m0 + r;
      if (m >= m_end || n >= a.N) continue;
      const bf16* src = yst + r * G::kYLd + 8 * (lane & 3);
      bf16* dst = a.out + m * a.N + n;
      if (vec_y) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (n + e < a.N) dst[e] = src[e];
      }
    }
    __syncwarp();
  };

  // the resident w joins step 0's group; then the first kFmRing - 1
  // steps in flight, one group a step (empty past the run), so that a
  // wait counts steps
  if (RES) load_w(wbuf, 0);
  constexpr unsigned kMask = (1u << G::kXChunks) - 1;
  unsigned ring_flags = 0;  // G::kXChunks bits a slot
#pragma unroll
  for (int k = 0; k < kFmRing - 1; ++k) {
    if (k < nsteps) ring_flags |= load_step(k, k) << (G::kXChunks * k);
    cp_async_commit();
  }
  int slot = 0, kc = 0, rb = 0;  // the step multiplied: its slot, place
  for (int s = 0; s < nsteps; ++s) {
    const int k0 = kc * KC;
    bf16* xs = xring + slot * G::kXTile;
    cp_async_wait<kFmRing - 2>();  // this thread's chunks of step s
    if (a.prologue) {  // in place: relu(x*scale + bias) rounded, 0 past M
      float sc[8], bi[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + cc + j;
        sc[j] = k < a.K ? __ldg(a.scale + k) : 0.f;
        bi[j] = k < a.K ? __ldg(a.bias + k) : 0.f;
      }
      const unsigned flags = ring_flags >> (G::kXChunks * slot);
#pragma unroll
      for (int i = 0; i < G::kXChunks; ++i) {
        const int r = r0 + G::kRowStep * i;
        uint4* p = reinterpret_cast<uint4*>(xs + r * G::kXLd + cc);
        *p = flags >> i & 1 ? prologue8(*p, sc, bi) : make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();
    // step s + kFmRing - 1 into the slot that step s - 1 left: every warp
    // left its product at the barrier
    const int next = slot == 0 ? kFmRing - 1 : slot - 1;
    if (s + kFmRing - 1 < nsteps)
      ring_flags = (ring_flags & ~(kMask << (G::kXChunks * next))) |
                   load_step(s + kFmRing - 1, next) << (G::kXChunks * next);
    cp_async_commit();
    const bf16* wt = wbuf + (RES ? 0 : slot * G::kWTile);
    const int ksteps = ((a.K - k0 < KC ? a.K - k0 : KC) + 15) / 16;
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t af[G::kMI][4];  // A = xn: rows m, depth k
#pragma unroll
      for (int i = 0; i < G::kMI; ++i)
        ldsm_x4(af[i], a_ptr<G::kXLd>(xs, G::kMw * wm + 16 * i, 16 * kk));
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // B = w: depth k, columns n
        uint32_t bf[4];
        ldsm_x4_t(bf, a_ptr<G::kWLd>(wt, 16 * kk, 32 * wn + 16 * q));
#pragma unroll
        for (int i = 0; i < G::kMI; ++i) {
          mma(acc[i][2 * q], af[i], bf[0], bf[1]);
          mma(acc[i][2 * q + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    slot = slot + 1 == kFmRing ? 0 : slot + 1;
    if (++kc == nck) {
      epilogue(rb);
      kc = 0;
      ++rb;
    }
  }
  cp_async_wait<0>();  // the ring's empty groups

  // the run's column sums: over the 8 rows of each lane quad by shuffles,
  // then over the row warps in order; the same bits every run
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
  if (tid < BN && n0 + tid < a.N) {
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int k = 0; k < G::kWarpsM; ++k) {
      v1 += red[k * BN + tid];
      v2 += red[(G::kWarpsM + k) * BN + tid];
    }
    const int64_t at = static_cast<int64_t>(blockIdx.y) * a.N + n0 + tid;
    a.part0[at] = v1;
    a.part1[at] = v2;
  }
}

template <int BN, int KC, bool RES>
cudaError_t launch_fwd_mma(const Args<bf16>& a, int vec, cudaStream_t stream) {
  const int64_t tiles = ceil_div(a.N, BN), runs = ceil_div(a.M, a.split_rows);
  if (tiles > 0x7fffffff || runs > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = FmTc<BN, KC, RES>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fused_matmul_bn_fwd_mma<BN, KC, RES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_matmul_bn_fwd_mma<BN, KC, RES>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(runs)),
         kFmThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

// float32 forward: the FMA tile over blocks of 128 x 128 of y, one
// partial row a block (runs of 128 rows)
cudaError_t launch_fwd(const Args<float>& a, int, cudaStream_t stream) {
  const int64_t gi = ceil_div(a.M, BI), gj = ceil_div(a.N, BJ);
  if (a.split_rows != BI || gi > 0x7fffffff || gj > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj));
  fused_matmul_bn_fwd_kernel<float><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// bf16 forward: the tensor-core tile, w resident where K <= 64, over
// runs of split_rows rows of M
cudaError_t launch_fwd(const Args<bf16>& a, int vec, cudaStream_t stream) {
  const bool wide = a.N > 64;
  if (a.K <= 64)
    return wide ? launch_fwd_mma<128, 64, true>(a, vec, stream)
                : launch_fwd_mma<64, 64, true>(a, vec, stream);
  return wide ? launch_fwd_mma<128, 32, false>(a, vec, stream)
              : launch_fwd_mma<64, 32, false>(a, vec, stream);
}

// float32 dx: the FMA tile over blocks of 128 x 128 of dx
cudaError_t launch_dx(const Args<float>& a, int, cudaStream_t stream) {
  const int64_t gi = ceil_div(a.M, BI), gj = ceil_div(a.K, BJ);
  if (gi > 0x7fffffff || gj > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj));
  fused_matmul_bn_dx_kernel<float><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

// bf16 dx: the tensor-core tile in column tiles of 64 where K <= 64 or
// the depth N is at most 128 (a block's few stages then leave x's load
// and its latency exposed: the 64-wide tile loads x during the product
// and holds more blocks an SM), else of 128, which stage dyt half as
// often
cudaError_t launch_dx(const Args<bf16>& a, int vec, cudaStream_t stream) {
  return a.K <= 64 || a.N <= 128 ? launch_dx_mma<64>(a, vec, stream)
                                 : launch_dx_mma<128>(a, vec, stream);
}

// float32 dw: the 3xTF32 tile in column tiles of 64 where N <= 64,
// else of 128, over runs of split_rows rows, a multiple of its stage
cudaError_t launch_dw(const Args<float>& a, int64_t splits, int vec,
                      cudaStream_t stream) {
  return a.N <= 64 ? launch_dw_tf32<64>(a, splits, vec, stream)
                   : launch_dw_tf32<128>(a, splits, vec, stream);
}

// bf16 dw: the tensor-core tile; runs of split_rows, a multiple of the
// stage depth, so that no stage straddles two runs
cudaError_t launch_dw(const Args<bf16>& a, int64_t splits, int vec,
                      cudaStream_t stream) {
  const int bn = a.N <= 64 ? 64 : 128;
  const int64_t gi = ceil_div(a.K, kTcBK), gj = ceil_div(a.N, bn);
  if (gi > 0x7fffffff || gj > 65535 || splits > 65535 || splits <= 0 ||
      a.split_rows % kTcBM != 0)
    return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj),
            static_cast<unsigned>(splits));
  if (bn == 64)
    fused_matmul_bn_dw_mma<64><<<grid, kTcThreads, 0, stream>>>(a, vec);
  else
    fused_matmul_bn_dw_mma<128><<<grid, kTcThreads, 0, stream>>>(a, vec);
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* x, const void* w, const void* scale,
                  const void* bias, const void* y, const void* dy,
                  const void* ds1, const void* ds2, void* out, void* part0,
                  void* part1, int64_t M, int K, int N, int prologue,
                  int64_t split_rows) {
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
  a.M = M;
  a.K = K;
  a.N = N;
  a.prologue = prologue;
  a.split_rows = split_rows;
  return a;
}

template <typename T>
int run(int mode, const Args<T>& a, int64_t splits, int vec,
        cudaStream_t stream) {
  if (mode == kFwd) return static_cast<int>(launch_fwd(a, vec, stream));
  if (mode == kDx) return static_cast<int>(launch_dx(a, vec, stream));
  return static_cast<int>(launch_dw(a, splits, vec, stream));
}

int dispatch(int dtype, int mode, const void* x, const void* w,
             const void* scale, const void* bias, const void* y,
             const void* dy, const void* ds1, const void* ds2, void* out,
             void* part0, void* part1, long long M, int K, int N,
             int prologue, long long split_rows, long long splits, int vec,
             void* stream) {
  if (M < 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return run(mode,
                 make_args<float>(x, w, scale, bias, y, dy, ds1, ds2, out,
                                  part0, part1, M, K, N, prologue, split_rows),
                 splits, vec, s);
    case 1:
      return run(mode,
                 make_args<bf16>(x, w, scale, bias, y, dy, ds1, ds2, out,
                                 part0, part1, M, K, N, prologue, split_rows),
                 splits, vec, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The caller sized the partial rows of the forward and dx for blocks of
// BI rows of M: refuse any other count rather than write past them.
bool part_rows_ok(long long part_rows, long long M) {
  return part_rows == ceil_div(M, BI);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), w (K, N) and y (M, N) in
// that type, row-major and contiguous; scale and bias (K,) float32, read
// only when prologue is 1 (may be null otherwise); s1_part and s2_part
// (part_rows, N) float32, one row of sums of y and y^2 for each run of
// run_rows rows of M (the last run may be shorter), part_rows =
// ceil(M / run_rows), every element written.  float32 runs the FMA tile,
// whose runs are its blocks of 128 rows; bfloat16 the tensor-core tile,
// whose runs are a multiple of 128 rows and which reads x 16 bytes at a
// time where bit 0 of vec is set (x 16-byte aligned, K a multiple of 8),
// w where bit 1 is (w 16-byte aligned, N a multiple of 8), and writes y
// 16 bytes at a time where bit 2 is (y 16-byte aligned, N a multiple of
// 8).  Launches
// on `stream` without synchronising; returns the launch's cudaError_t.
extern "C" int mx_fused_matmul_bn_fwd(int dtype, const void* x,
                                      const void* w, const void* scale,
                                      const void* bias, int prologue,
                                      void* y, void* s1_part, void* s2_part,
                                      long long part_rows, long long M,
                                      int K, int N, long long run_rows,
                                      int vec, void* stream) {
  if (run_rows <= 0 || run_rows % BI != 0 ||
      part_rows != ceil_div(M, run_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kFwd, x, w, scale, bias, nullptr, nullptr, nullptr,
                  nullptr, y, s1_part, s2_part, M, K, N, prologue, run_rows,
                  0, vec, stream);
}

// dtype as above.  x (M, K), w (K, N), y and dy (M, N) in that type;
// ds1 and ds2 (N,) float32; dx (M, K) in that type.  With the prologue,
// scale and bias (K,) float32 and dscale_part and dbias_part
// (part_rows, K) float32, part_rows = ceil(M / 128), are read and
// written; without it they may be null.  float32 runs the FMA tile;
// bfloat16 the tensor-core tile, which reads x pairs 4 bytes at a time
// where bit 0 of vec is set (x 16-byte aligned, K a multiple of 8), y and
// dy 16 bytes at a time where bit 1 is (both 16-byte aligned, N a
// multiple of 8), and w where bit 2 is (w 16-byte aligned).
extern "C" int mx_fused_matmul_bn_dx(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     int prologue, const void* y,
                                     const void* dy, const void* ds1,
                                     const void* ds2, void* dx,
                                     void* dscale_part, void* dbias_part,
                                     long long part_rows, long long M, int K,
                                     int N, int vec, void* stream) {
  if (prologue && !part_rows_ok(part_rows, M))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDx, x, w, scale, bias, y, dy, ds1, ds2, dx,
                  dscale_part, dbias_part, M, K, N, prologue, 0, 0, vec,
                  stream);
}

// dtype and operands as for dx; dw_part is (splits, K, N) float32, one
// (K, N) partial for each run of split_rows rows of M (the last run may
// be shorter), every element written.  float32 runs the 3xTF32 tile,
// whose runs must be a multiple of its stage depth (16 rows); bfloat16
// the bf16 tensor-core tile, whose runs must be a multiple of its stage
// depth (32 rows).  Both read x 16 bytes at a time where bit 0 of vec is
// set (x 16-byte aligned, rows a multiple of 16 bytes), y and dy where
// bit 1 is (both 16-byte aligned, rows a multiple of 16 bytes).
extern "C" int mx_fused_matmul_bn_dw(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     int prologue, const void* y,
                                     const void* dy, const void* ds1,
                                     const void* ds2, void* dw_part,
                                     long long M, int K, int N,
                                     long long split_rows, long long splits,
                                     int vec, void* stream) {
  if (split_rows <= 0 || (splits - 1) * split_rows >= M ||
      splits * split_rows < M)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDw, x, w, scale, bias, y, dy, ds1, ds2, nullptr,
                  dw_part, nullptr, M, K, N, prologue, split_rows, splits,
                  vec, stream);
}
