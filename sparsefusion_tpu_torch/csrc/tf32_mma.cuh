// K2's TF32 tensor-core helpers (csrc/imagen_attention.cu): the
// mma.sync.m16n8k8 TF32 product, 16-byte cp.async, and the rounding to
// TF32 and 3xTF32 split of an f32 operand (K4, on wgmma, splits in
// integers: tf32_wgmma.cuh::split_int).
#pragma once

#include <stdint.h>

namespace {

// Round to TF32 (nearest, ties away, as cvt.rna); low 13 bits zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r & 0xffffe000u;
}

// x = big + small, both TF32: small carries what big drops.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
}

// d += a b: a is a 16x8 row-major A fragment, b an 8x8 B fragment.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace
