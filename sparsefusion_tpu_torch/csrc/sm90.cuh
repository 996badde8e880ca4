// Hopper's asynchronous machinery, shared by K2's bf16 wgmma body
// (csrc/imagen_attention.cu), K4 (csrc/conv2d_splitk.cu) and K5
// (csrc/linear_gemm.cu): mbarriers, wgmma's shared-memory descriptors,
// fences and waits, and the tensor maps that TMA copies read (sm_90a).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than 2^34 cycles (~9 s) traps: a deadlock becomes a launch error.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    long long t0 = 0;
    while (!mbar_try(bar, parity)) {
        if (t0 == 0) t0 = clock64();
        else if (clock64() - t0 > (1ll << 34)) __trap();
    }
}


__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), and the swizzle of `swizzle_bytes`
// rows (layout type 1 = 128 B, 2 = 64 B, 3 = 32 B).
template <int swizzle_bytes>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
    constexpr uint64_t type = swizzle_bytes == 128 ? 1
                              : swizzle_bytes == 64 ? 2 : 3;
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)(lbo >> 4) << 16)
           | ((uint64_t)(sbo >> 4) << 32) | (type << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this thread's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N)
                 : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

#define SF_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define SF_F8(a, i) SF_F4(a, i), SF_F4(a, i + 4)
#define SF_F16(a, i) SF_F8(a, i), SF_F8(a, i + 8)
#define SF_F32(a, i) SF_F16(a, i), SF_F16(a, i + 16)
#define SF_F64(a, i) SF_F32(a, i), SF_F32(a, i + 32)

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime so
// that the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t e = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// Returned when the tensor maps cannot be made: kEncodeError when
// libcuda has no cuTensorMapEncodeTiled, kEncodeError + its CUresult when
// it refuses a map.
constexpr int kEncodeError = 10000;


}  // namespace
