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
// rows writes one float32 partial row (s1/s2 in the forward, dscale/
// dbias in dx), and dw splits M into runs that each write a float32
// partial of the whole (K, N) tile.  The wrapper sums the partials in a
// fixed order.  No atomics: the result is the same from run to run.
//
// Bound.  At ResNet-50's shapes (K and N from 64 to 2048, M up to
// 401,408 rows at B=128) each kernel does 2*M*K*N operations.  The
// forward moves (M*K + K*N + M*N) elements, dx and dw read both y and dy
// (two M*N tensors) besides x.  In float32, against the card's 67
// TFLOP/s of FMA outside the tensor cores and 3.35 TB/s (20 operations
// a byte), the forward is bound by operations except stage 1's 64-to-64
// launch (16 a byte); dx and dw are bound by bytes at most stage-1
// launches, where a side is 64 wide (c3: 0.31 and 0.28 ms of traffic
// against 0.20 ms of FMA), and by operations elsewhere.
// In bfloat16 every launch is bound by bytes (tensor cores at 989
// TFLOP/s); this FMA loop does not reach that bound.
//
// Design: one tiled product, C (I, J) = A (I, R) @ B (R, J), shared by
// the three kernels, which differ only in how A and B are fetched and in
// the epilogue.  A block of 256 threads owns a 128x128 tile of C; each
// thread keeps an 8x8 sub-tile in registers (two 4x4 quads per axis, so
// the shared-memory reads are float4 broadcasts), and the depth
// goes through shared memory 8 at a time, the next slice's global loads
// in flight while the current one is multiplied.  Each operand element
// is converted to float32 (and put through the prologue or dyt) once, as
// it is staged, so the inner loop is plain float32 FMA.  Global loads run
// along the operand's contiguous axis.  This is the simple, right first
// kernel; TMA, wgmma and a persistent schedule are later work.

#include "common.cuh"

namespace {

using mx::from_float;
using mx::to_float;

constexpr int BI = 128;       // rows of C a block owns
constexpr int BJ = 128;       // columns of C a block owns
constexpr int BR = 8;         // depth staged through shared memory at once
constexpr int THREADS = 256;  // 16 x 16 threads, an 8x8 sub-tile each
constexpr int LOADS = BI * BR / THREADS;  // A (and B) elements a thread stages

enum Mode { kFwd = 0, kDx = 1, kDw = 2 };

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
  int64_t split_rows;   // dw: rows of M each split takes
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

// Sizes of C and its depth for each mode.
template <int MODE, typename T>
__device__ __forceinline__ void dims(const Args<T>& a, int64_t* I, int64_t* J) {
  if (MODE == kFwd) {
    *I = a.M;
    *J = a.N;
  } else if (MODE == kDx) {
    *I = a.M;
    *J = a.K;
  } else {
    *I = a.K;
    *J = a.N;
  }
}

// A[i][r] for i < I, r < r_end (else 0).  Element e of the staged slice
// maps to (i, r) along A's contiguous axis in device memory.
template <int MODE, typename T>
__device__ __forceinline__ float fetch_a(const Args<T>& a, int e, int64_t i0,
                                         int64_t r0, int64_t I, int64_t r_end,
                                         int* si, int* sr) {
  int i, r;
  if (MODE == kDw) {  // A = P(x)^T: i = k, r = m; x runs along k
    i = e % BI;
    r = e / BI;
  } else {            // forward: A = P(x), r = k; dx: A = dyt, r = n
    r = e % BR;
    i = e / BR;
  }
  *si = i;
  *sr = r;
  const int64_t gi = i0 + i, gr = r0 + r;
  if (gi >= I || gr >= r_end) return 0.f;
  if (MODE == kFwd) return prologue_at(a, gi, static_cast<int>(gr));
  if (MODE == kDx) return dyt_at(a, gi, static_cast<int>(gr));
  return prologue_at(a, gr, static_cast<int>(gi));
}

// B[r][j] for r < r_end, j < J (else 0), along B's contiguous axis.
template <int MODE, typename T>
__device__ __forceinline__ float fetch_b(const Args<T>& a, int e, int64_t j0,
                                         int64_t r0, int64_t J, int64_t r_end,
                                         int* sj, int* sr) {
  int j, r;
  if (MODE == kDx) {  // B = w^T: r = n, j = k; w runs along n
    r = e % BR;
    j = e / BR;
  } else {            // forward: B = w (r = k); dw: B = dyt (r = m)
    j = e % BJ;
    r = e / BJ;
  }
  *sj = j;
  *sr = r;
  const int64_t gj = j0 + j, gr = r0 + r;
  if (gj >= J || gr >= r_end) return 0.f;
  if (MODE == kFwd) return to_float(a.w[gr * a.N + gj]);
  if (MODE == kDx) return to_float(a.w[gj * a.N + gr]);
  return dyt_at(a, gr, static_cast<int>(gj));
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

  int64_t I, J;
  dims<MODE>(a, &I, &J);
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * BI;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * BJ;
  int64_t r_begin = 0, r_end;
  if (MODE == kFwd) {
    r_end = a.K;
  } else if (MODE == kDx) {
    r_end = a.N;
  } else {
    r_begin = static_cast<int64_t>(blockIdx.z) * a.split_rows;
    r_end = r_begin + a.split_rows < a.M ? r_begin + a.split_rows : a.M;
  }

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

  if (MODE == kDw) {  // this split's float32 partial of dw
    float* dst = a.part0 + static_cast<int64_t>(blockIdx.z) * a.K * a.N;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t k = i0 + slot(ty, p);
      if (k >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int64_t n = j0 + slot(tx, q);
        if (n < J) dst[k * a.N + n] = acc[p][q];
      }
    }
    return;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_matmul_bn_dw_kernel(Args<T> a) {
  fused_mm_bn<kDw>(a);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch(int mode, const Args<T>& a, int64_t splits,
                   cudaStream_t stream) {
  dim3 block(THREADS);
  if (mode == kFwd || mode == kDx) {
    const int64_t gi = ceil_div(a.M, BI);
    const int64_t gj = ceil_div(mode == kFwd ? a.N : a.K, BJ);
    if (gi > 0x7fffffff || gj > 65535) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj));
    if (mode == kFwd)
      fused_matmul_bn_fwd_kernel<T><<<grid, block, 0, stream>>>(a);
    else
      fused_matmul_bn_dx_kernel<T><<<grid, block, 0, stream>>>(a);
  } else {
    const int64_t gi = ceil_div(a.K, BI), gj = ceil_div(a.N, BJ);
    if (gi > 0x7fffffff || gj > 65535 || splits > 65535 || splits <= 0)
      return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj),
              static_cast<unsigned>(splits));
    fused_matmul_bn_dw_kernel<T><<<grid, block, 0, stream>>>(a);
  }
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

int dispatch(int dtype, int mode, const void* x, const void* w,
             const void* scale, const void* bias, const void* y,
             const void* dy, const void* ds1, const void* ds2, void* out,
             void* part0, void* part1, long long M, int K, int N,
             int prologue, long long split_rows, long long splits,
             void* stream) {
  if (M < 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(
          mode, make_args<float>(x, w, scale, bias, y, dy, ds1, ds2, out,
                                 part0, part1, M, K, N, prologue, split_rows),
          splits, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          mode, make_args<__nv_bfloat16>(x, w, scale, bias, y, dy, ds1, ds2,
                                         out, part0, part1, M, K, N, prologue,
                                         split_rows),
          splits, s));
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
// (part_rows, N) float32 with part_rows = ceil(M / 128), every element
// written.  Launches on `stream` without synchronising; returns the
// launch's cudaError_t.
extern "C" int mx_fused_matmul_bn_fwd(int dtype, const void* x,
                                      const void* w, const void* scale,
                                      const void* bias, int prologue,
                                      void* y, void* s1_part, void* s2_part,
                                      long long part_rows, long long M,
                                      int K, int N, void* stream) {
  if (!part_rows_ok(part_rows, M))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kFwd, x, w, scale, bias, nullptr, nullptr, nullptr,
                  nullptr, y, s1_part, s2_part, M, K, N, prologue, 0, 0,
                  stream);
}

// dtype as above.  x (M, K), w (K, N), y and dy (M, N) in that type;
// ds1 and ds2 (N,) float32; dx (M, K) in that type.  With the prologue,
// scale and bias (K,) float32 and dscale_part and dbias_part
// (part_rows, K) float32, part_rows = ceil(M / 128), are read and
// written; without it they may be null.
extern "C" int mx_fused_matmul_bn_dx(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     int prologue, const void* y,
                                     const void* dy, const void* ds1,
                                     const void* ds2, void* dx,
                                     void* dscale_part, void* dbias_part,
                                     long long part_rows, long long M, int K,
                                     int N, void* stream) {
  if (prologue && !part_rows_ok(part_rows, M))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDx, x, w, scale, bias, y, dy, ds1, ds2, dx,
                  dscale_part, dbias_part, M, K, N, prologue, 0, 0, stream);
}

// dtype and operands as for dx; dw_part is (splits, K, N) float32, one
// (K, N) partial for each run of split_rows rows of M (the last run may
// be shorter), every element written.
extern "C" int mx_fused_matmul_bn_dw(int dtype, const void* x, const void* w,
                                     const void* scale, const void* bias,
                                     int prologue, const void* y,
                                     const void* dy, const void* ds1,
                                     const void* ds2, void* dw_part,
                                     long long M, int K, int N,
                                     long long split_rows, long long splits,
                                     void* stream) {
  if (split_rows <= 0 || (splits - 1) * split_rows >= M ||
      splits * split_rows < M)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDw, x, w, scale, bias, y, dy, ds1, ds2, nullptr,
                  dw_part, nullptr, M, K, N, prologue, split_rows, splits,
                  stream);
}
