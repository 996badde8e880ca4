// 3xTF32 products on Hopper's warpgroup instructions, shared by K4
// (csrc/conv2d_splitk.cu) and K5 (csrc/linear_gemm.cu): the split of an
// f32 operand into two TF32 halves, the m64nNk8 TF32 wgmma with A in
// registers, and the 2-D TMA copy of an f32 matrix's 128-byte-wide tiles
// (sm_90a).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// x rounded to TF32 (nearest, ties away: the bits of |x| plus half a TF32
// ulp, the low 13 bits cleared) and the rest, x - big, with its low 13
// bits cleared (toward zero); the tensor cores read both as TF32.
__device__ __forceinline__ void split_int(float x, uint32_t& big,
                                          uint32_t& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// One 2-D TMA copy of the box at (c0 along the rows, c1 down them) into
// shared memory, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (m64 nN, f32) = (accumulate ? d : 0) + A B: A the m64k8 TF32 fragment
// in registers (a0 row g col t, a1 row g + 8 col t, a2 row g col t + 4, a3
// row g + 8 col t + 4 of the warp's 16 rows), B K-major TF32 in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
    if constexpr (N == 8) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3 "
            "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
            "}\n"
            : SF_F4(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(accumulate));
    } else if constexpr (N == 16) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7 "
            "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
            "}\n"
            : SF_F8(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(accumulate));
    } else if constexpr (N == 32) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15 "
            "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n"
            "}\n"
            : SF_F16(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(accumulate));
    } else if constexpr (N == 64) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
            "{"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31 "
            "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
            "}\n"
            : SF_F32(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(accumulate));
    }
}

// A 2-D map of a row-major f32 matrix [rows][cols] (cols contiguous, its
// rows 16-byte aligned), boxes of `box_rows` rows x `box_cols` (at most 32:
// one 128-byte row), 128-byte swizzle, zeros past either edge.
inline int encode_f32_map(CUtensorMap* map, const float* p, int rows,
                          int cols, int box_rows, int box_cols) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return kEncodeError;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                          const_cast<float*>(p), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

}  // namespace
