// bf16 tensor-core helpers shared by the kernels that multiply on
// Hopper's tensor cores with mma.sync (flash_attention.cu and the bf16 dw
// of fused_matmul_bn.cu): ldmatrix from shared memory, the m16n8k16
// product with float32 sums, and where each lane reads for ldmatrix.
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

}  // namespace mx
