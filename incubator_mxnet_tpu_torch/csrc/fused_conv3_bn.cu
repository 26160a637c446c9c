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
// Each kernel is an implicit matrix product over the shifted taps,
//   forward  C (M, C_out)   = A (M, 9*C)     @ B (9*C, C_out)
//   dx       C (M, C)       = A (M, 9*C_out) @ B (9*C_out, C)
//   dw       C (9*C, C_out) = A (9*C, M)     @ B (M, C_out)
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
// splits M into runs that each write a float32 partial of the whole
// (9*C, C_out) gradient; the wrapper sums them in a fixed order.  No
// atomics: the result is the same from run to run.
//
// Bound.  Each kernel does 2*M*9*C*C_out operations.  At ResNet-50's
// 3x3 shapes at B=128 (M = 401,408 rows at 64 channels down to 6,272 at
// 512) that is 29.6 GFLOP a launch, 0.44 ms at the card's 67 TFLOP/s of
// float32 FMA outside the tensor cores, while the bytes (x, y, dy, the
// 73 KB to 9.4 MB kernel) take at most 0.12 ms at 3.35 TB/s: in float32
// every launch is bound by operations.  In bfloat16 the tensor cores'
// 989 TFLOP/s bound it by bytes at stage 1 and by operations elsewhere;
// this FMA loop reaches neither.  Simple and right first: implicit GEMM
// on wgmma with TMA-fed halo tiles is later work.

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
  const T* x;           // (M, C)
  const T* w;           // (9, C, Co)
  const float* scale;   // (C,), read only with the prologue
  const float* bias;    // (C,)
  const T* y;           // (M, Co), the forward's output (dx, dw)
  const T* dy;          // (M, Co) (dx, dw)
  const float* ds1;     // (Co,) (dx, dw)
  const float* ds2;     // (Co,)
  T* out;               // forward: y (M, Co); dx: dx (M, C)
  float* part0;         // forward: s1 rows; dx: dscale rows; dw: dw parts
  float* part1;         // forward: s2 rows; dx: dbias rows
  int M;                // N*H*W rows
  int H;
  int W;
  int C;
  int Co;
  int prologue;
  int split_rows;       // dw: rows of M each split takes
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
//   forward, dx: A row i = tid / 8 + 32 l (a pixel), depth tid % 8;
//   forward:     B depth tid / 128 + 2 l, column tid % 128;
//   dx:          B depth tid % 8, column tid / 8 + 32 l;
//   dw:          A row i = tid % 128 (a tap and channel), depth
//                tid / 128 + 2 l (a pixel); B the same as the forward's.
template <int MODE, typename T>
struct Stager {
  const Args<T>& a;
  int tid;
  int r_end;
  // forward and dx: the pixel of each A row, its (h, w), and whether it
  // exists
  int row[LOADS];
  int ph[LOADS];
  int pw[LOADS];
  bool ok[LOADS];
  // dw: the tap and channel of this thread's A row
  int kdh, kdw, kc;
  bool kok;

  __device__ __forceinline__ Stager(const Args<T>& args, int i0, int end)
      : a(args), tid(threadIdx.x), r_end(end) {
    if (MODE == kDw) {
      const int k = i0 + (tid % BI);
      kok = k < 9 * a.C;
      const int t = kok ? k / a.C : 0;
      kc = k - t * a.C;
      tap(t, &kdh, &kdw);
    } else {
#pragma unroll
      for (int l = 0; l < LOADS; ++l) {
        const int m = i0 + tid / BR + (THREADS / BR) * l;
        ok[l] = m < a.M;
        row[l] = m;
        pw[l] = m % a.W;
        ph[l] = (m / a.W) % a.H;
      }
    }
  }

  __device__ __forceinline__ float fetch_a(int l, int r0) const {
    if (MODE == kDw) {
      const int m = r0 + tid / BI + (THREADS / BI) * l;
      if (!kok || m >= r_end) return 0.f;
      const int h = (m / a.W) % a.H + kdh, w = m % a.W + kdw;
      if (!inside(h, w, a.H, a.W)) return 0.f;
      return prologue_at(a, m + kdh * a.W + kdw, kc);
    }
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
    if (MODE == kFwd)  // B[t*C + c][o] = W[t, c, o]
      return to_float(a.w[static_cast<int64_t>(k) * a.Co + o]);
    return dyt_at(a, k, o);  // dw: B[m][o] = dyt[m, o]
  }

  // shared-memory places of element l of A and B
  __device__ __forceinline__ void a_place(int l, int* r, int* i) const {
    if (MODE == kDw) {
      *r = tid / BI + (THREADS / BI) * l;
      *i = tid % BI;
    } else {
      *r = tid % BR;
      *i = tid / BR + (THREADS / BR) * l;
    }
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

  const int I = MODE == kDw ? 9 * a.C : a.M;
  const int J = MODE == kDx ? a.C : a.Co;
  const int i0 = blockIdx.x * BI;
  const int j0 = blockIdx.y * BJ;
  int r_begin = 0, r_end;
  if (MODE == kFwd) {
    r_end = 9 * a.C;
  } else if (MODE == kDx) {
    r_end = 9 * a.Co;
  } else {
    r_begin = blockIdx.z * a.split_rows;
    r_end = a.M - r_begin > a.split_rows ? r_begin + a.split_rows : a.M;
  }
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

  if (MODE == kDw) {  // this split's float32 partial of dw (9*C, Co)
    float* dst = a.part0 + static_cast<int64_t>(blockIdx.z) * I * a.Co;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int k = i0 + slot(ty, p);
      if (k >= I) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int o = j0 + slot(tx, q);
        if (o < J) dst[static_cast<int64_t>(k) * a.Co + o] = acc[p][q];
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
    fused_conv3_bn_dw_kernel(Args<T> a) {
  fused_conv<kDw>(a);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

template <typename T>
cudaError_t launch(int mode, const Args<T>& a, long long splits,
                   cudaStream_t stream) {
  dim3 block(THREADS);
  if (mode == kFwd || mode == kDx) {
    const int64_t gi = ceil_div(a.M, BI);
    const int64_t gj = ceil_div(mode == kFwd ? a.Co : a.C, BJ);
    if (gj > 65535) return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj));
    if (mode == kFwd)
      fused_conv3_bn_fwd_kernel<T><<<grid, block, 0, stream>>>(a);
    else
      fused_conv3_bn_dx_kernel<T><<<grid, block, 0, stream>>>(a);
  } else {
    const int64_t gi = ceil_div(9LL * a.C, BI), gj = ceil_div(a.Co, BJ);
    if (gj > 65535 || splits > 65535 || splits <= 0)
      return cudaErrorInvalidValue;
    dim3 grid(static_cast<unsigned>(gi), static_cast<unsigned>(gj),
              static_cast<unsigned>(splits));
    fused_conv3_bn_dw_kernel<T><<<grid, block, 0, stream>>>(a);
  }
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
                  int prologue, long long split_rows) {
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
  a.split_rows = static_cast<int>(split_rows);
  return a;
}

int dispatch(int dtype, int mode, const void* x, const void* w,
             const void* scale, const void* bias, const void* y,
             const void* dy, const void* ds1, const void* ds2, void* out,
             void* part0, void* part1, long long N, int H, int W, int C,
             int Co, int prologue, long long split_rows, long long splits,
             void* stream) {
  if (!shape_ok(N, H, W, C, Co))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(
          mode, make_args<float>(x, w, scale, bias, y, dy, ds1, ds2, out,
                                 part0, part1, N, H, W, C, Co, prologue,
                                 split_rows),
          splits, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(
          mode, make_args<__nv_bfloat16>(x, w, scale, bias, y, dy, ds1, ds2,
                                         out, part0, part1, N, H, W, C, Co,
                                         prologue, split_rows),
          splits, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The caller sized the partial rows of the forward and dx for blocks of
// BI rows of M: refuse any other count rather than write past them.
bool part_rows_ok(long long part_rows, long long N, int H, int W) {
  return part_rows == ceil_div(N * H * W, BI);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (N, H, W, C), w (3, 3, C, Co) and
// y (N, H, W, Co) in that type, contiguous (NHWC, HWIO); scale and bias
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
                  nullptr, y, s1_part, s2_part, N, H, W, C, Co, prologue, 0,
                  0, stream);
}

// dtype as above.  x (N, H, W, C), w (3, 3, C, Co), y and dy
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
                  dscale_part, dbias_part, N, H, W, C, Co, prologue, 0, 0,
                  stream);
}

// dtype and operands as for dx (no kernel: dw does not read it); dw_part
// is (splits, 9*C, Co) float32, one partial of the (3, 3, C, Co) gradient
// for each run of split_rows rows of M = N*H*W (the last run may be
// shorter), every element written.
extern "C" int mx_fused_conv3_bn_dw(int dtype, const void* x,
                                    const void* scale, const void* bias,
                                    int prologue, const void* y,
                                    const void* dy, const void* ds1,
                                    const void* ds2, void* dw_part,
                                    long long N, int H, int W, int C, int Co,
                                    long long split_rows, long long splits,
                                    void* stream) {
  if (!shape_ok(N, H, W, C, Co)) return static_cast<int>(cudaErrorInvalidValue);
  const long long M = N * H * W;
  if (split_rows <= 0 || split_rows > 0x7fffffffLL ||
      (M > 0 && ((splits - 1) * split_rows >= M || splits * split_rows < M)))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, kDw, x, nullptr, scale, bias, y, dy, ds1, ds2,
                  nullptr, dw_part, nullptr, N, H, W, C, Co, prologue,
                  split_rows, splits, stream);
}
