// Tensor-core helpers shared by the kernels that multiply on Hopper's
// tensor cores with mma.sync (flash_attention.cu, and the forward, dx
// and dw of fused_matmul_bn.cu and of fused_conv3_bn.cu in both dtypes):
// ldmatrix from shared memory, the bf16 m16n8k16 product with float32
// sums, where each lane reads for ldmatrix, cp.async into shared
// memory, the staging of the fused kernels'
// operands (eight bf16 values at a time: the masked load, the BatchNorm
// prologue and the stats-adjusted cotangent dyt, each rounded to bf16),
// and the float32 route: a float32 value split into tf32 hi + lo parts,
// the tf32 m16n8k8 product with float32 sums, and the same staging four
// float32 values at a time, unrounded.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace mx {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and register i gets matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

// c += a . b over one m16n8k16 tile, bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Where lane reads for ldmatrix.x4 over the 16 x 16 block at (r0, c0) of
// a tile of row stride kLd.  a_ptr: the A operand of a row-major (m, k)
// tile, and with .trans the B operand of a row-major (k, n) tile, both
// for two n8 tiles (registers 0-1 the first, 2-3 the second).  b_ptr:
// the B operand of a row-major (n, k) tile (no .trans), and with .trans
// the A operand of a row-major (k, m) tile.
template <int kLd>
__device__ __forceinline__ const bf16* a_ptr(const bf16* tile, int r0,
                                             int c0) {
  const int lane = threadIdx.x & 31;
  return tile + (r0 + (lane & 15)) * kLd + c0 + (lane >> 4) * 8;
}

template <int kLd>
__device__ __forceinline__ const bf16* b_ptr(const bf16* tile, int r0,
                                             int c0) {
  const int lane = threadIdx.x & 31;
  return tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * kLd + c0 +
         ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from src to dst, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

union Pack8 {  // 8 bf16 values as one 16-byte load or store
  uint4 u;
  uint32_t w[4];
  unsigned short h[8];
};

// Elements [col, col + 8) of a row, 0 past `limit` or where !in_row;
// one 16-byte load where `vec` (the row start and col are 16-byte
// aligned and a chunk lies wholly inside or outside the row).
__device__ __forceinline__ uint4 load8(const bf16* row, int col, int limit,
                                       bool in_row, bool vec) {
  Pack8 p;
  p.u = make_uint4(0, 0, 0, 0);
  if (!in_row) return p.u;
  if (vec) {
    if (col < limit) p.u = __ldg(reinterpret_cast<const uint4*>(row + col));
    return p.u;
  }
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (col + j < limit) p.h[j] = r[col + j];
  return p.u;
}

__device__ __forceinline__ float2 unpack(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t pack(float a, float b) {
  return bits(__floats2bfloat162_rn(a, b));  // round to nearest even
}

// relu(x*scale + bias) of 8 values, rounded to bf16, as the kernels'
// prologue_at rounds one
__device__ __forceinline__ uint4 prologue8(uint4 raw, const float* sc,
                                           const float* bi) {
  Pack8 in, out;
  in.u = raw;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = unpack(in.w[j]);
    out.w[j] = pack(
        fmaxf(__fadd_rn(__fmul_rn(v.x, sc[2 * j]), bi[2 * j]), 0.f),
        fmaxf(__fadd_rn(__fmul_rn(v.y, sc[2 * j + 1]), bi[2 * j + 1]), 0.f));
  }
  return out.u;
}

// dy + ds1 + 2*y*ds2 of 8 values, rounded to bf16, as dyt_at rounds one
__device__ __forceinline__ uint4 dyt8(uint4 y_raw, uint4 dy_raw,
                                      const float* d1, const float* d2) {
  Pack8 y, dy, out;
  y.u = y_raw;
  dy.u = dy_raw;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 yv = unpack(y.w[j]), gv = unpack(dy.w[j]);
    out.w[j] = pack(
        __fadd_rn(__fadd_rn(gv.x, d1[2 * j]),
                  __fmul_rn(__fmul_rn(2.f, yv.x), d2[2 * j])),
        __fadd_rn(__fadd_rn(gv.y, d1[2 * j + 1]),
                  __fmul_rn(__fmul_rn(2.f, yv.y), d2[2 * j + 1])));
  }
  return out.u;
}

// ---------------------------------------------------------------------
// float32 on the tensor cores: three tf32 products ("3xTF32").  A tf32
// register holds a float32 whose low 13 bits the tensor core ignores, so
// v is rounded to tf32 first (to nearest, ties away from zero: .rna) and
// lo is the rounded rest, v = hi + lo + e with |e| <= 2^-22 |v|.  Then
// a . b = a_lo . b_hi + a_hi . b_lo + a_hi . b_hi up to about 2^-21 of
// each product; the three go into the same float32 sums, smallest first.

// v rounded to tf32 (.rna), as the bits of a float32
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo up to 2^-22 |v|, both tf32 (v - hi is exact in float32)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// c += a . b over one m16n8k8 tile, tf32 operands, float32 sums.  Lane
// l = 4 g + t holds A (row-major 16 x 8) at (g, t), (g + 8, t), (g, t +
// 4), (g + 8, t + 4), B (8 x 8, k by n) at (t, g) and (t + 4, g), and C
// as the bf16 product's: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t +
// 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32 from the split operands
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(c, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(c, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(c, a_hi, b_hi[0], b_hi[1]);
}

// 16 bytes of float32 from src to dst, or 16 zero bytes when !full.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// Elements [col, col + 4) of a float32 row, 0 past `limit` or where
// !in_row, loaded one at a time.
__device__ __forceinline__ float4 load4(const float* row, int col, int limit,
                                        bool in_row) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (in_row) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < limit) v[j] = __ldg(row + col + j);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// relu(x*scale + bias) of 4 float32 values, as the kernels' prologue
__device__ __forceinline__ float4 prologue4(float4 v, const float* sc,
                                            const float* bi) {
  return make_float4(fmaxf(__fadd_rn(__fmul_rn(v.x, sc[0]), bi[0]), 0.f),
                     fmaxf(__fadd_rn(__fmul_rn(v.y, sc[1]), bi[1]), 0.f),
                     fmaxf(__fadd_rn(__fmul_rn(v.z, sc[2]), bi[2]), 0.f),
                     fmaxf(__fadd_rn(__fmul_rn(v.w, sc[3]), bi[3]), 0.f));
}

__device__ __forceinline__ float dyt1(float y, float g, float d1, float d2) {
  return __fadd_rn(__fadd_rn(g, d1), __fmul_rn(__fmul_rn(2.f, y), d2));
}

// dy + ds1 + 2*y*ds2 of 4 float32 values, as the kernels' dyt
__device__ __forceinline__ float4 dyt4(float4 y, float4 g, const float* d1,
                                       const float* d2) {
  return make_float4(dyt1(y.x, g.x, d1[0], d2[0]),
                     dyt1(y.y, g.y, d1[1], d2[1]),
                     dyt1(y.z, g.z, d1[2], d2[2]),
                     dyt1(y.w, g.w, d1[3], d2[3]));
}

}  // namespace mx
