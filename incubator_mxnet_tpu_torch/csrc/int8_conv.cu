// int8 convolution with int32 sums on Hopper's int8 tensor cores
// (sm_90a, mma.sync m16n8k32 s8 x s8 -> s32).
//
// Replaces no Pallas kernel.  It is the card's counterpart of the JAX
// package's int8 product, which XLA computes:
// lax.conv_general_dilated(int8, int8, preferred_element_type=int32)
// (ops/quantization_ops.py:116-122, quantized_conv2d) and
// lax.dot_general(int8, int8 -> int32) (:91-93, quantized_dense, run
// here as a 1x1 convolution of a 1x1 image).  PyTorch has no int8
// convolution on CUDA.
//
// Implicit GEMM: out[m, co] = sum_k A[m, k] * B[co, k] with m = (n, oh,
// ow) and k = (r, s, ci), K = kh*kw*C.  A is gathered from the codes in
// channels-last order, x[n, ih, iw, ci] with ih = oh*sh - ph + r*dh and
// iw = ow*sw - pw + s*dw, 0 outside the image; B is the weight in
// (co, r, s, ci) order, a row of K bytes per output channel.  The sums
// are int32 and wrap, as XLA's do; an optional int32 bias (one value an
// output channel) is added in the epilogue, wrapping too.  The output is
// int32 NCHW.
//
// Tiles: 128 rows of m by 64 output channels a block of 4 warps (2 x 2,
// 64 x 32 each), K in steps of 64 bytes, two stages in shared memory.
// Where C is a multiple of 16, 16 consecutive k lie at one (r, s) and
// are 16 contiguous bytes of x (and of a weight row), loaded with
// cp.async (zero-filled outside the image, past K and past the ragged M
// and C_out edges); otherwise (the stem, C = 3) each byte is loaded on
// its own.  Rows of 64 bytes are padded to 80, so the ldmatrix reads of
// 8 rows x 16 bytes hit 32 different banks.  Offsets are 64-bit.
//
// Bound: operations, 2*M*K*C_out int8 operations at the dense int8
// peak, or the bytes of x, the weight and the int32 output, whichever
// takes longer.

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;          // bytes of k a stage
constexpr int kLd = kBK + 16;    // padded row, bytes
constexpr int kThreads = 128;

struct Conv {
  int n, c, h, w;        // input, channels-last
  int co, kh, kw;        // weight (co, kh, kw, c)
  int oh, ow;
  int sh, sw, ph, pw, dh, dw;
  int k;                 // kh * kw * c
  int64_t m;             // n * oh * ow
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   mx::smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

union Bytes16 {
  uint4 u;
  int8_t b[16];
};

__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const int32_t* __restrict__ bias, int32_t* __restrict__ out,
                 Conv p, bool vec) {
  __shared__ __align__(16) int8_t sa[2][kBM * kLd];
  __shared__ __align__(16) int8_t sb[2][kBN * kLd];

  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int64_t plane = static_cast<int64_t>(p.oh) * p.ow;

  // the four A rows this thread loads: row (tid / 4) + 32 i, chunk tid % 4
  const int chunk = tid & 3;
  int64_t abase[4];
  int ih0[4], iw0[4];
  bool mok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + (tid >> 2) + 32 * i;
    mok[i] = m < p.m;
    const int64_t img = mok[i] ? m / plane : 0;
    const int64_t pix = mok[i] ? m - img * plane : 0;
    const int oy = static_cast<int>(pix / p.ow);
    const int ox = static_cast<int>(pix - static_cast<int64_t>(oy) * p.ow);
    abase[i] = img * p.h * p.w * p.c;
    ih0[i] = oy * p.sh - p.ph;
    iw0[i] = ox * p.sw - p.pw;
  }

  auto load_a = [&](int stage, int kt) {
    const int k0 = kt * kBK + chunk * 16;
    if (vec) {
      int r = 0, s = 0, ci = 0;
      if (k0 < p.k) {
        const int rs = k0 / p.c;
        ci = k0 - rs * p.c;
        r = rs / p.kw;
        s = rs - r * p.kw;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (tid >> 2) + 32 * i;
        const int ih = ih0[i] + r * p.dh, iw = iw0[i] + s * p.dw;
        const bool ok = mok[i] && k0 < p.k && ih >= 0 && ih < p.h &&
                        iw >= 0 && iw < p.w;
        const int8_t* src =
            ok ? x + abase[i] + (static_cast<int64_t>(ih) * p.w + iw) * p.c +
                     ci
               : x;
        cp_async16_zfill(&sa[stage][row * kLd + chunk * 16], src, ok);
      }
      return;
    }
#pragma unroll 1
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 2) + 32 * i;
      Bytes16 v;
      v.u = make_uint4(0, 0, 0, 0);
      if (mok[i] && k0 < p.k) {
        const int rs = k0 / p.c;
        int ci = k0 - rs * p.c;
        int r = rs / p.kw;
        int s = rs - r * p.kw;
        for (int j = 0; j < 16 && k0 + j < p.k; ++j) {
          const int ih = ih0[i] + r * p.dh, iw = iw0[i] + s * p.dw;
          if (ih >= 0 && ih < p.h && iw >= 0 && iw < p.w)
            v.b[j] = __ldg(x + abase[i] +
                           (static_cast<int64_t>(ih) * p.w + iw) * p.c + ci);
          if (++ci == p.c) {
            ci = 0;
            if (++s == p.kw) {
              s = 0;
              ++r;
            }
          }
        }
      }
      *reinterpret_cast<uint4*>(&sa[stage][row * kLd + chunk * 16]) = v.u;
    }
  };

  auto load_b = [&](int stage, int kt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + kThreads * i;
      const int row = id >> 2, ch = id & 3;
      const int co = n0 + row;
      const int k0 = kt * kBK + ch * 16;
      const int8_t* src = wt + static_cast<int64_t>(co) * p.k + k0;
      int8_t* dst = &sb[stage][row * kLd + ch * 16];
      if (vec) {
        const bool ok = co < p.co && k0 < p.k;
        cp_async16_zfill(dst, ok ? src : wt, ok);
      } else {
        Bytes16 v;
        v.u = make_uint4(0, 0, 0, 0);
        if (co < p.co)
          for (int j = 0; j < 16 && k0 + j < p.k; ++j) v.b[j] = __ldg(src + j);
        *reinterpret_cast<uint4*>(dst) = v.u;
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_n = (p.k + kBK - 1) / kBK;
  if (kt_n > 0) {
    load_a(0, 0);
    load_b(0, 0);
    mx::cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < kt_n) {
      load_a(cur ^ 1, kt + 1);
      load_b(cur ^ 1, kt + 1);
      mx::cp_async_commit();
      mx::cp_async_wait<1>();
    } else {
      mx::cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* as = sa[cur];
    const int8_t* bs = sb[cur];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mx::ldsm_x4(a[i], as + (wm * 64 + i * 16 + (lane & 15)) * kLd + ks +
                              (lane >> 4) * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        mx::ldsm_x4(b[jj], bs + (wn * 32 + jj * 16 + (lane & 7) +
                                 ((lane >> 4) << 3)) * kLd +
                               ks + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mx::mma_s8(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                     b[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // epilogue: lane 4g + t holds rows g and g + 8, columns 2t and 2t + 1
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * 64 + i * 16 + g + half * 8;
      if (m >= p.m) continue;
      const int64_t img = m / plane;
      int32_t* orow = out + img * p.co * plane + (m - img * plane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (co >= p.co) continue;
          uint32_t v = static_cast<uint32_t>(acc[i][j][half * 2 + e]);
          if (bias != nullptr) v += static_cast<uint32_t>(__ldg(bias + co));
          orow[static_cast<int64_t>(co) * plane] = static_cast<int32_t>(v);
        }
      }
    }
  }
}

}  // namespace

// x: int8 (n, h, w, c) contiguous; weight: int8 (co, kh, kw, c)
// contiguous; bias: int32 (co,) or null; out: int32 (n, co, oh, ow).
// vec = 1 only where c % 16 == 0 and x and weight start on 16 bytes.
extern "C" int mx_int8_conv(int device, const void* x, const void* weight,
                            const void* bias, void* out, int n, int c, int h,
                            int w, int co, int kh, int kw, int oh, int ow,
                            int sh, int sw, int ph, int pw, int dh, int dw,
                            int vec, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Conv p;
  p.n = n;
  p.c = c;
  p.h = h;
  p.w = w;
  p.co = co;
  p.kh = kh;
  p.kw = kw;
  p.oh = oh;
  p.ow = ow;
  p.sh = sh;
  p.sw = sw;
  p.ph = ph;
  p.pw = pw;
  p.dh = dh;
  p.dw = dw;
  p.k = kh * kw * c;
  p.m = static_cast<int64_t>(n) * oh * ow;
  if (p.m == 0 || co == 0) return cudaSuccess;
  const int64_t bx = (p.m + kBM - 1) / kBM;
  const int64_t by = (co + kBN - 1) / kBN;
  if (bx > 0x7fffffff || by > 65535) return cudaErrorInvalidConfiguration;
  int8_conv_kernel<<<dim3(static_cast<unsigned>(bx),
                          static_cast<unsigned>(by)),
                     kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(weight),
      static_cast<const int32_t*>(bias), static_cast<int32_t*>(out), p,
      vec != 0);
  return cudaGetLastError();
}
