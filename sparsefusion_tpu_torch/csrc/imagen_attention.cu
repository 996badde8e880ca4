// Imagen-style attention with one key/value head shared by all query
// heads, for Hopper (sm_90a): out = softmax(q k^T) v, forward only, in two
// instances: f32 and bf16.
//
// Replaces the TPU kernel sparsefusion_tpu/kernels/attention.py::
// imagen_attention (body _attn_kernel).  q is (B, H, N, D), pre-scaled;
// k and v are (B, J, D) with the null key/value and any context tokens
// already prepended.  No mask.  The f32 instance keeps inputs, outputs and
// sums in f32.  The bf16 instance computes what the TPU kernel computes
// for bf16 inputs: logits with f32 accumulation, the softmax in f32, P
// rounded to bf16 before P V (f32 accumulation), the output in bf16.
//
// What bounds it: at the view-conditioned UNet's shapes (H*N = 8 x 16
// rows, J = 17 or 19, D = 64) the work is 0.6 MFLOP on 75 KB (f32) or
// 38 KB (bf16), so the launch and the latency of one block's chain of
// dependent steps bound it; at (2, 8, 1024, 64) with J = 1027 the 4.3
// GFLOP of the two products do: f32 FMA units (67 TFLOP/s) run at a third
// of the rate the tensor cores run TF32 (495 TFLOP/s), bf16 tensor cores
// at 989 TFLOP/s.
//
// Design (both instances):
// * Rows.  The (head, query) pairs of a batch are one axis of H*N rows
//   (q's layout makes them contiguous), so k and v are indexed by batch
//   and never repeated per head.  Each warp owns a 16-row m-tile; a block
//   holds 1, 2 or 4 warps, fewer when the grid would otherwise leave SMs
//   idle (the UNet's 128 rows run as 8 one-warp blocks, not one block).
//   Rows past H*N load zeros and store nothing.
// * k/v tiles stream into shared memory with 16-byte cp.async,
//   double-buffered; keys past J load as zeros and their logits are -inf.
// * Online softmax over the tiles (running max and sum per row, the
//   accumulator rescaled once per tile), so any J works.  The softmax runs
//   on S's accumulator fragment in registers; row max and sum reduce over
//   the 4 lanes of a quad.
//
// f32 instance:
// * Tiles of kJ keys (2048 / D: 32 at D = 64, 64 at D = 32, 128 at D =
//   16; capped at 128 at D = 8, where S's fragment of a 256-key tile would
//   take 128 registers a thread), 40 KB of shared memory at D = 16, the
//   most.  Rows are padded to D + 4 floats so that every fragment read
//   below hits 32 distinct banks (at D = 8, 16, 32 and 64).
// * Products on the tensor cores: S = Q K^T and O += P V are
//   mma.sync.m16n8k8 in TF32 with f32 accumulation, each operand split
//   as x = big + small (big = tf32(x), small = tf32(x - big)) and each
//   product taken as a_small b_big + a_big b_small + a_big b_big
//   ("3xTF32"): about f32 accuracy, where one TF32 pass keeps ~3 digits.
// * The keys of each 8-key step of P V are taken in the order (0, 2, 4,
//   6, 1, 3, 5, 7), which makes S's accumulator fragment P's A fragment
//   as it stands: no shuffle, no shared memory.
//
// bf16 instance:
// * Both products are mma.sync.m16n8k16 in bf16 with f32 accumulation,
//   one pass each (bf16 products are exact in f32).
// * D = 8: the reduction of S = Q K^T is padded to 16 with zeros in
//   registers (the upper half of Q's A fragment and of K's B fragment are
//   0), so both products stay m16n8k16.
// * P's A fragment: the f32 accumulators of S's key blocks 2s and 2s + 1,
//   (row g, keys 2t, 2t + 1) and (row g + 8, ...) of each, packed in
//   pairs by cvt.rn.bf16x2.f32, are the A fragment of the 16-key step s
//   (PTX's m16n8k16 fragment tables: a0a1 = row g, columns 2t, 2t + 1;
//   a2a3 = row g + 8; a4a5 and a6a7 the same at columns + 8).  P is the
//   unnormalised exp(s - running max), rounded to bf16; the row sum adds
//   the f32 values and divides at the end.
// * V's B fragment (keys 2t, 2t + 1 of column g) takes two 16-bit shared
//   loads a register, one per key row.
// * Tiles of 4096 / D keys capped at 128 (64 at D = 64, 128 below), rows
//   padded to D + 8 bf16 (24 at D = 8), 16-byte multiples that keep
//   cp.async aligned: K's 32-bit fragment reads then hit 32 distinct banks
//   and V's 16-bit reads 16 distinct words; 36-40 KB of shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
constexpr unsigned kFull = 0xffffffffu;

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

// d += a b in 3xTF32; the small products first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0, float b1) {
    uint32_t bb0, bs0, bb1, bs1;
    split(b0, bb0, bs0);
    split(b1, bb1, bs1);
    mma_tf32(d, a_small, bb0, bb1);
    mma_tf32(d, a_big, bs0, bs1);
    mma_tf32(d, a_big, bb0, bb1);
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

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
    return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(kFull, x, 1);
    return x + __shfl_xor_sync(kFull, x, 2);
}

template <int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
imagen_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int rows, int J) {
    static_assert(D % 8 == 0, "head dim must be a multiple of 8");
    constexpr int kJ = 2048 / D < 128 ? 2048 / D : 128;  // keys per tile
    constexpr int kLd = D + 4;    // shared row pitch, in floats
    constexpr int kDSteps = D / 8;
    constexpr int kJSteps = kJ / 8;
    constexpr int kVec = D / 4;
    __shared__ __align__(16) float ks[2][kJ * kLd];
    __shared__ __align__(16) float vs[2][kJ * kLd];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int t = lane & 3;   // fragment column pair
    const int b = blockIdx.y;
    const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
    const bool warp_live = row0 < rows;
    const int r0 = row0 + g;
    const int r1 = r0 + 8;
    const float* qb = q + (long long)b * rows * D;
    const float* kb = k + (long long)b * J * D;
    const float* vb = v + (long long)b * J * D;

    // Q as A fragments: a0 (r0, 8s + t), a1 (r1, 8s + t), a2 (r0, 8s + t
    // + 4), a3 (r1, 8s + t + 4), split once.
    uint32_t q_big[kDSteps][4], q_small[kDSteps][4];
#pragma unroll
    for (int s = 0; s < kDSteps; ++s) {
        const int c = 8 * s + t;
        const float a[4] = {
            r0 < rows ? qb[(long long)r0 * D + c] : 0.f,
            r1 < rows ? qb[(long long)r1 * D + c] : 0.f,
            r0 < rows ? qb[(long long)r0 * D + c + 4] : 0.f,
            r1 < rows ? qb[(long long)r1 * D + c + 4] : 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(a[i], q_big[s][i], q_small[s][i]);
    }

    // O's accumulator fragments: (r0, 8n + 2t + {0, 1}), (r1, ...).
    float o[kDSteps][4];
#pragma unroll
    for (int n = 0; n < kDSteps; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max
    float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sum

    auto load_tile = [&](int tile, int buf) {
        const int j0 = tile * kJ;
        for (int i = threadIdx.x; i < kJ * kVec; i += blockDim.x) {
            const int jj = i / kVec;
            const int c = 4 * (i % kVec);
            const bool valid = j0 + jj < J;
            const long long off = valid ? (long long)(j0 + jj) * D + c : 0;
            cp_async16(&ks[buf][jj * kLd + c], kb + off, valid);
            cp_async16(&vs[buf][jj * kLd + c], vb + off, valid);
        }
        cp_async_commit();
    };

    const int n_tiles = (J + kJ - 1) / kJ;
    load_tile(0, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < n_tiles) {
            load_tile(tile + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // tile `tile` is in shared memory for all warps

        if (warp_live) {
            const float* kt = ks[buf];
            const float* vt = vs[buf];
            const int nj = min(kJ, J - tile * kJ);

            // S = Q K^T: B fragment b0 = K[8n + g][8s + t], b1 = ...[+ 4]
            float s_acc[kJSteps][4];
#pragma unroll
            for (int n = 0; n < kJSteps; ++n)
                s_acc[n][0] = s_acc[n][1] = s_acc[n][2] = s_acc[n][3] = 0.f;
#pragma unroll
            for (int s = 0; s < kDSteps; ++s) {
#pragma unroll
                for (int n = 0; n < kJSteps; ++n) {
                    const float* kr = kt + (8 * n + g) * kLd + 8 * s + t;
                    mma_3xtf32(s_acc[n], q_big[s], q_small[s], kr[0], kr[4]);
                }
            }

            // online softmax on the fragment: keys past J are -inf
            float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < kJSteps; ++n) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (8 * n + 2 * t + e >= nj) {
                        s_acc[n][e] = -INFINITY;
                        s_acc[n][2 + e] = -INFINITY;
                    }
                    tmax0 = fmaxf(tmax0, s_acc[n][e]);
                    tmax1 = fmaxf(tmax1, s_acc[n][2 + e]);
                }
            }
            const float mn0 = fmaxf(m0, quad_max(tmax0));
            const float mn1 = fmaxf(m1, quad_max(tmax1));
            const float corr0 = expf(m0 - mn0);  // 0 on the first tile
            const float corr1 = expf(m1 - mn1);
            m0 = mn0;
            m1 = mn1;
            l0 *= corr0;
            l1 *= corr1;
#pragma unroll
            for (int n = 0; n < kDSteps; ++n) {
                o[n][0] *= corr0;
                o[n][1] *= corr0;
                o[n][2] *= corr1;
                o[n][3] *= corr1;
            }
#pragma unroll
            for (int n = 0; n < kJSteps; ++n) {
                s_acc[n][0] = expf(s_acc[n][0] - mn0);
                s_acc[n][1] = expf(s_acc[n][1] - mn0);
                s_acc[n][2] = expf(s_acc[n][2] - mn1);
                s_acc[n][3] = expf(s_acc[n][3] - mn1);
                l0 += s_acc[n][0] + s_acc[n][1];
                l1 += s_acc[n][2] + s_acc[n][3];
            }

            // O += P V over 8-key steps, keys in the order (0,2,4,6,1,3,5,
            // 7): A = (P[r0][2t], P[r1][2t], P[r0][2t+1], P[r1][2t+1]) is
            // S's fragment; B: b0 = V[8s + 2t][8n + g], b1 = V[8s + 2t + 1]
#pragma unroll
            for (int s = 0; s < kJSteps; ++s) {
                uint32_t p_big[4], p_small[4];
                split(s_acc[s][0], p_big[0], p_small[0]);
                split(s_acc[s][2], p_big[1], p_small[1]);
                split(s_acc[s][1], p_big[2], p_small[2]);
                split(s_acc[s][3], p_big[3], p_small[3]);
                const float* vr = vt + (8 * s + 2 * t) * kLd + g;
#pragma unroll
                for (int n = 0; n < kDSteps; ++n)
                    mma_3xtf32(o[n], p_big, p_small, vr[8 * n],
                               vr[kLd + 8 * n]);
            }
        }
        __syncthreads();  // all warps are done with buffer `buf`
    }

    if (!warp_live) return;
    const float inv0 = 1.f / quad_sum(l0);
    const float inv1 = 1.f / quad_sum(l1);
    float* ob = out + (long long)b * rows * D;
#pragma unroll
    for (int n = 0; n < kDSteps; ++n) {
        const int c = 8 * n + 2 * t;
        if (r0 < rows)
            *reinterpret_cast<float2*>(ob + (long long)r0 * D + c) =
                make_float2(o[n][0] * inv0, o[n][1] * inv0);
        if (r1 < rows)
            *reinterpret_cast<float2*>(ob + (long long)r1 * D + c) =
                make_float2(o[n][2] * inv1, o[n][3] * inv1);
    }
}

// d += a b on the bf16 tensor cores: a is a 16x16 row-major A fragment,
// b0 b1 a 16x8 B fragment; two bf16 a register, the lower index in the low
// half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) -> two bf16, rounded to nearest even, lo in the low half
// (cvt puts its first source in the upper half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    uint32_t r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(32 * kMaxWarps)
imagen_attention_bf16_fwd_kernel(const uint16_t* __restrict__ q,
                                 const uint16_t* __restrict__ k,
                                 const uint16_t* __restrict__ v,
                                 uint16_t* __restrict__ out, int rows,
                                 int J) {
    static_assert(D % 8 == 0, "head dim must be a multiple of 8");
    constexpr int kJ = 4096 / D < 128 ? 4096 / D : 128;  // keys per tile
    constexpr int kLd = D == 8 ? 24 : D + 8;  // shared row pitch, in bf16
    constexpr int kKSteps = (D + 15) / 16;    // k16 steps of Q K^T
    constexpr int kDBlocks = D / 8;           // n8 blocks of O
    constexpr int kJBlocks = kJ / 8;          // n8 blocks of S
    constexpr int kVec = D / 8;               // 16-byte chunks of a row
    __shared__ __align__(16) uint16_t ks[2][kJ * kLd];
    __shared__ __align__(16) uint16_t vs[2][kJ * kLd];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int t = lane & 3;   // fragment column pair
    const int b = blockIdx.y;
    const int row0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
    const bool warp_live = row0 < rows;
    const int r0 = row0 + g;
    const int r1 = r0 + 8;
    const uint16_t* qb = q + (long long)b * rows * D;
    const uint16_t* kb = k + (long long)b * J * D;
    const uint16_t* vb = v + (long long)b * J * D;

    // Q as A fragments: (r0, 16s + 2t, +1), (r1, ...), (r0, ... + 8),
    // (r1, ... + 8); columns past D are zero
    uint32_t qa[kKSteps][4];
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
        const int c = 16 * s + 2 * t;
        const bool hi = c + 8 < D;
        qa[s][0] = r0 < rows ? ld_u32(qb + (long long)r0 * D + c) : 0u;
        qa[s][1] = r1 < rows ? ld_u32(qb + (long long)r1 * D + c) : 0u;
        qa[s][2] = hi && r0 < rows ? ld_u32(qb + (long long)r0 * D + c + 8)
                                   : 0u;
        qa[s][3] = hi && r1 < rows ? ld_u32(qb + (long long)r1 * D + c + 8)
                                   : 0u;
    }

    // O's accumulator fragments: (r0, 8n + 2t + {0, 1}), (r1, ...).
    float o[kDBlocks][4];
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running row max
    float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sum

    auto load_tile = [&](int tile, int buf) {
        const int j0 = tile * kJ;
        for (int i = threadIdx.x; i < kJ * kVec; i += blockDim.x) {
            const int jj = i / kVec;
            const int c = 8 * (i % kVec);
            const bool valid = j0 + jj < J;
            const long long off = valid ? (long long)(j0 + jj) * D + c : 0;
            cp_async16(&ks[buf][jj * kLd + c], kb + off, valid);
            cp_async16(&vs[buf][jj * kLd + c], vb + off, valid);
        }
        cp_async_commit();
    };

    const int n_tiles = (J + kJ - 1) / kJ;
    load_tile(0, 0);
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int buf = tile & 1;
        if (tile + 1 < n_tiles) {
            load_tile(tile + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // tile `tile` is in shared memory for all warps

        if (warp_live) {
            const uint16_t* kt = ks[buf];
            const uint16_t* vt = vs[buf];
            const int nj = min(kJ, J - tile * kJ);

            // S = Q K^T: B fragment b0 = K[8n + g][16s + 2t, +1], b1 =
            // ...[+ 8] (0 past D)
            float s_acc[kJBlocks][4];
#pragma unroll
            for (int n = 0; n < kJBlocks; ++n)
                s_acc[n][0] = s_acc[n][1] = s_acc[n][2] = s_acc[n][3] = 0.f;
#pragma unroll
            for (int s = 0; s < kKSteps; ++s) {
#pragma unroll
                for (int n = 0; n < kJBlocks; ++n) {
                    const uint16_t* kr = kt + (8 * n + g) * kLd + 16 * s
                                         + 2 * t;
                    const uint32_t b1 = 16 * s + 2 * t + 8 < D
                                            ? ld_u32(kr + 8) : 0u;
                    mma_bf16(s_acc[n], qa[s], ld_u32(kr), b1);
                }
            }

            // online softmax on the fragment: keys past J are -inf
            float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < kJBlocks; ++n) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    if (8 * n + 2 * t + e >= nj) {
                        s_acc[n][e] = -INFINITY;
                        s_acc[n][2 + e] = -INFINITY;
                    }
                    tmax0 = fmaxf(tmax0, s_acc[n][e]);
                    tmax1 = fmaxf(tmax1, s_acc[n][2 + e]);
                }
            }
            const float mn0 = fmaxf(m0, quad_max(tmax0));
            const float mn1 = fmaxf(m1, quad_max(tmax1));
            const float corr0 = expf(m0 - mn0);  // 0 on the first tile
            const float corr1 = expf(m1 - mn1);
            m0 = mn0;
            m1 = mn1;
            l0 *= corr0;
            l1 *= corr1;
#pragma unroll
            for (int n = 0; n < kDBlocks; ++n) {
                o[n][0] *= corr0;
                o[n][1] *= corr0;
                o[n][2] *= corr1;
                o[n][3] *= corr1;
            }
#pragma unroll
            for (int n = 0; n < kJBlocks; ++n) {
                s_acc[n][0] = expf(s_acc[n][0] - mn0);
                s_acc[n][1] = expf(s_acc[n][1] - mn0);
                s_acc[n][2] = expf(s_acc[n][2] - mn1);
                s_acc[n][3] = expf(s_acc[n][3] - mn1);
                l0 += s_acc[n][0] + s_acc[n][1];
                l1 += s_acc[n][2] + s_acc[n][3];
            }

            // O += P V over 16-key steps: A = S's fragments of key blocks
            // 2s and 2s + 1 packed to bf16; B: b0 = (V[16s + 2t][8n + g],
            // V[16s + 2t + 1][8n + g]), b1 = keys 16s + 2t + 8 and + 9
#pragma unroll
            for (int s = 0; s < kJ / 16; ++s) {
                const uint32_t pa[4] = {
                    pack_bf16(s_acc[2 * s][0], s_acc[2 * s][1]),
                    pack_bf16(s_acc[2 * s][2], s_acc[2 * s][3]),
                    pack_bf16(s_acc[2 * s + 1][0], s_acc[2 * s + 1][1]),
                    pack_bf16(s_acc[2 * s + 1][2], s_acc[2 * s + 1][3])};
                const uint16_t* vr = vt + (16 * s + 2 * t) * kLd + g;
#pragma unroll
                for (int n = 0; n < kDBlocks; ++n) {
                    const uint32_t b0 =
                        vr[8 * n] | ((uint32_t)vr[kLd + 8 * n] << 16);
                    const uint32_t b1 =
                        vr[8 * kLd + 8 * n]
                        | ((uint32_t)vr[9 * kLd + 8 * n] << 16);
                    mma_bf16(o[n], pa, b0, b1);
                }
            }
        }
        __syncthreads();  // all warps are done with buffer `buf`
    }

    if (!warp_live) return;
    const float inv0 = 1.f / quad_sum(l0);
    const float inv1 = 1.f / quad_sum(l1);
    uint16_t* ob = out + (long long)b * rows * D;
#pragma unroll
    for (int n = 0; n < kDBlocks; ++n) {
        const int c = 8 * n + 2 * t;
        if (r0 < rows)
            *reinterpret_cast<uint32_t*>(ob + (long long)r0 * D + c) =
                pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
        if (r1 < rows)
            *reinterpret_cast<uint32_t*>(ob + (long long)r1 * D + c) =
                pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
                != cudaSuccess)
            n = 132;
    }
    return n;
}

// 4 warps a block, halved while the grid would not cover the SMs
dim3 grid_for(int batch, int rows, int& warps) {
    warps = kMaxWarps;
    while (warps > 1 &&
           (long long)batch * ((rows + 16 * warps - 1) / (16 * warps))
               < sm_count())
        warps /= 2;
    return dim3((rows + 16 * warps - 1) / (16 * warps), batch);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int batch, int rows, int J,
                   cudaStream_t stream) {
    int warps;
    const dim3 grid = grid_for(batch, rows, warps);
    imagen_attention_fwd_kernel<D><<<grid, 32 * warps, 0, stream>>>(
        q, k, v, out, rows, J);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, uint16_t* out, int batch,
                        int rows, int J, cudaStream_t stream) {
    int warps;
    const dim3 grid = grid_for(batch, rows, warps);
    imagen_attention_bf16_fwd_kernel<D><<<grid, 32 * warps, 0, stream>>>(
        q, k, v, out, rows, J);
    return cudaGetLastError();
}

}  // namespace

// q (batch, rows = H*N, D), k/v (batch, J, D), out like q; all f32,
// contiguous and 16-byte aligned (the wrapper checks).  Returns the CUDA
// error of the launch, or cudaErrorInvalidValue for a head dim without
// an instance.
extern "C" int sf_imagen_attention_fwd(const void* q, const void* k,
                                       const void* v, void* out, int batch,
                                       int rows, int J, int D,
                                       void* stream) {
    if (batch <= 0 || rows <= 0 || J <= 0) return (int)cudaErrorInvalidValue;
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch<8>(qf, kf, vf, of, batch, rows, J, s);
        case 16: return (int)launch<16>(qf, kf, vf, of, batch, rows, J, s);
        case 32: return (int)launch<32>(qf, kf, vf, of, batch, rows, J, s);
        case 64: return (int)launch<64>(qf, kf, vf, of, batch, rows, J, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The bf16 instance: as sf_imagen_attention_fwd with q, k, v and out in
// bf16 (the wrapper checks).
extern "C" int sf_imagen_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, void* out,
                                            int batch, int rows, int J,
                                            int D, void* stream) {
    if (batch <= 0 || rows <= 0 || J <= 0) return (int)cudaErrorInvalidValue;
    const uint16_t* qh = static_cast<const uint16_t*>(q);
    const uint16_t* kh = static_cast<const uint16_t*>(k);
    const uint16_t* vh = static_cast<const uint16_t*>(v);
    uint16_t* oh = static_cast<uint16_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 8: return (int)launch_bf16<8>(qh, kh, vh, oh, batch, rows, J, s);
        case 16:
            return (int)launch_bf16<16>(qh, kh, vh, oh, batch, rows, J, s);
        case 32:
            return (int)launch_bf16<32>(qh, kh, vh, oh, batch, rows, J, s);
        case 64:
            return (int)launch_bf16<64>(qh, kh, vh, oh, batch, rows, J, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
