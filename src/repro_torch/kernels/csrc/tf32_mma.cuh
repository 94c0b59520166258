// Three-TF32 products on Hopper's tensor cores (mma.sync.m16n8k8), shared by
// flash_attention.cu and rwkv6_wkv.cu.
//
// An f32 product a*b runs as big(a)*big(b) + big(a)*small(b) + small(a)*big(b)
// with x = big + small; small*small (about 2^-22 |a b|) is dropped.
#pragma once

#include <stdint.h>

// x = big + small for the tensor cores. big is x rounded to TF32 (nearest,
// ties away from zero: the bits cvt.rna.tf32.f32 gives, for finite x) by two
// full-rate integer instructions, since the conversion unit runs at a quarter
// of the rate; small = x - big is exact in f32 and goes in as it is: the
// tensor core reads it as TF32, losing at most its low 13 bits (2^-21 |x|).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a * b on the tensor cores (TF32 operands, f32 accumulator)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
