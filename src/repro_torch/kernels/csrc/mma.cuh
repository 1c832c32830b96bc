// Tensor-core helpers shared by the bf16 attention kernels
// (flash_prefill.cu's `tc` route, decode_attention.cu's tensor-core route):
// `ldmatrix` fragment loads from shared memory, the bf16 `mma.sync`
// m16n8k16 with an f32 accumulator, and bf16 packing.
//
// Fragments of mma.m16n8k16 (lane = 4 * gr + tg): an accumulator tile
// [16 rows x 8 cols] gives a lane (row gr, cols 2tg, 2tg + 1) in d[0..1]
// and (row gr + 8, same cols) in d[2..3]; an A tile [16 x 16] holds those
// of its left 8 columns in a[0..1] and of its right 8 in a[2..3].
#pragma once
#include <cuda_bf16.h>
#include <cstdint>

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
