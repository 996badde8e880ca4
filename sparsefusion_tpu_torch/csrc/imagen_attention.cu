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
// bf16 instance: two bodies; kernels/attention.py::bf16_plan picks one per
// call and the C entry runs that one or refuses the plan.
//
// mma_sync body (imagen_attention_bf16_fwd_kernel): every head dim, and
// any key count that fits one of the wgmma body's tiles (the UNet's 17-19
// keys, where a call is latency-bound: 3.3 us, no tensor maps to encode).
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
//   and V's 16-bit reads 16 distinct words; 24-40 KB of shared memory.
// * Over many keys it is bound by its structure, not by the card: 64 rows
//   at most share one K/V stream (at (2, 8, 1024, 64) with 1027 keys, 256
//   blocks each stream all keys, ~67 MB through shared memory for 4.5 MB
//   of input), mma.sync cannot reach the tensor cores' full rate, and a
//   two-stage cp.async ring with a block-wide barrier a tile overlaps
//   copies and products by one tile at most: 36 us there, 2.2x SDPA.
//
// wgmma body (imagen_attention_bf16_wgmma_fwd_kernel, below): D = 16, 32
// and 64 over more than 128 keys.  Its floors on this card are the
// tensor cores (4 B H N J D operations at 989 TFLOP/s) and the
// exponentials (B H N J at 16 a clock per SM), about equal at D = 64; the
// exponentials alone at D = 16 and 32.  What it does about them: 128 rows
// a CTA reuse each K/V tile 128 times (one wave of 128 CTAs at the long
// shape), TMA fills a 4-stage ring from one producer thread, both
// products are warpgroup wgmma (P from registers, V read transposed from
// shared memory, no 16-bit loads), exp is ex2.approx on s log2(e) - m
// log2(e), tile t's S = Q K^T is issued with tile t - 1's P V so that the
// softmax runs under P V, and the two consumer warpgroups take turns at
// issuing products so that one's softmax runs under the other's.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kMaxWarps = 4;
// the bf16 instance's two bodies (kernels/attention.py::BODIES)
constexpr int kBodyMmaSync = 0;
constexpr int kBodyWgmma = 1;
constexpr unsigned kFull = 0xffffffffu;

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

// ---------------------------------------------------------------------
// bf16 instance, long-key body: warpgroup products fed by TMA.
//
// One CTA takes kRows = 128 consecutive rows of one batch's H*N axis: two
// consumer warpgroups of 64 rows each, plus a producer warpgroup of which
// one thread issues every copy.  Q (128 x D) is loaded once by TMA; K and
// V stream through a ring of kStages tiles of kKeys = 128 keys, each stage
// with a "full" mbarrier (the copy's bytes arrived) and an "empty" one
// (all 8 consumer warps are done with it).  Every operand tile is
// addressed through a 3-D tensor map, (B, H*N, D) and (B, J, D), so that
// rows past H*N or keys past J of batch b arrive as zeros and never reach
// into batch b + 1, and the output store is clipped at H*N the same way.
// Tiles are swizzled as wgmma reads them: 128-byte rows at D = 64, 64 at
// D = 32, 32 at D = 16 (the swizzle spans one row of the tile).
//
// Per tile and warpgroup: S = Q K^T is wgmma m64n128k16 with both operands
// in shared memory (Q and K K-major, their natural layout); the online
// softmax runs on S's accumulator fragment (rows g and g + 8 of each warp's
// 16, the max and sum reduced over the 4 lanes of a quad), exponentials as
// ex2.approx of s log2(e) - m log2(e); P = exp(s - running max), packed to
// bf16 pairs, is the A operand of O += P V from registers (the m16n8k16 A
// fragment identity: key blocks 2s and 2s + 1 of S's fragment are the A
// fragment of the 16-key step s), and V is B from shared memory in its
// (keys, D) layout, MN-major (transposed).  O is normalised by the f32
// row sum at the end, rounded to bf16, staged in the warpgroup's Q rows
// and stored by TMA.
namespace wg {

constexpr int kRows = 128;       // rows of H*N per CTA: two warpgroups
constexpr int kKeys = 128;       // keys per K/V tile
constexpr int kStages = 4;       // K/V ring depth
constexpr int kThreads = 384;    // two consumer warpgroups + the producer's
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory: Q, the K ring, the V ring (every tile at a multiple of
// 1024 bytes, the swizzle's period), then the barriers; plus 1024 bytes to
// align the dynamic block's start.
template <int D>
struct Layout {
    static constexpr int kQBytes = kRows * D * 2;
    static constexpr int kTileBytes = kKeys * D * 2;
    static constexpr int kKOffset = kQBytes;
    static constexpr int kVOffset = kKOffset + kStages * kTileBytes;
    static constexpr int kBarOffset = kVOffset + kStages * kTileBytes;
    static constexpr int kBytes = kBarOffset + 8 * (2 * kStages + 1) + 1024;
    static constexpr int kSwizzle = 2 * D;   // bytes of one tile row
};

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group "
        "[%0, {%2, %3, %4}], [%1];\n"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
           "r"(c0), "r"(c1), "r"(c2) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// d (m64 n128, f32) = (accumulate ? d : 0) + A B, A and B K-major bf16 in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63 "
        "}, %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : SF_F64(d, 0)
        : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64 nD, f32) += A B: A = 4 registers of bf16 pairs (the m64k16 A
// fragment), B MN-major bf16 in shared memory (the transpose bit set).
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
    if constexpr (D == 16) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{"
        "%0, %1, %2, %3, %4, %5, %6, %7 "
            "}, {%8, %9, %10, %11}, %12, 1, 1, 1, 1;\n"
            : SF_F8(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    } else if constexpr (D == 32) {
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15 "
            "}, {%16, %17, %18, %19}, %20, 1, 1, 1, 1;\n"
            : SF_F16(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    } else {
        static_assert(D == 64, "wgmma body: head dim 16, 32 or 64");
        asm volatile(
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31 "
            "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
            : SF_F32(d, 0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

}  // namespace wg

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
imagen_attention_bf16_wgmma_fwd_kernel(
        const __grid_constant__ CUtensorMap q_map,
        const __grid_constant__ CUtensorMap k_map,
        const __grid_constant__ CUtensorMap v_map,
        const __grid_constant__ CUtensorMap out_map, int J) {
    using namespace wg;
    using L = Layout<D>;
    constexpr int kSw = L::kSwizzle;
    constexpr int kSbo = 8 * kSw;          // 8 rows of a swizzled tile
    constexpr int kOut = D / 2;            // O's accumulators a thread
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* qs = smem;
    uint8_t* ks = smem + L::kKOffset;
    uint8_t* vs = smem + L::kVOffset;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
    uint64_t* empty = full + kStages;
    uint64_t* q_full = empty + kStages;

    const int b = blockIdx.y;
    const int row0 = blockIdx.x * kRows;
    const int n_tiles = (J + kKeys - 1) / kKeys;
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);   // one arrival per consumer warp
        }
        mbar_init(q_full, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int group = threadIdx.x / 128;
    if (group == 2) {
        // producer: one thread keeps the ring full
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        if (threadIdx.x == 256) {
            mbar_expect_tx(q_full, L::kQBytes);
            tma_load(qs, &q_map, q_full, 0, row0, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % kStages;
                if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
                mbar_expect_tx(&full[s], 2 * L::kTileBytes);
                tma_load(ks + s * L::kTileBytes, &k_map, &full[s], 0,
                         t * kKeys, b);
                tma_load(vs + s * L::kTileBytes, &v_map, &full[s], 0,
                         t * kKeys, b);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32;
        const int lane = tid % 32;
        const int g = lane >> 2;   // fragment row (and row + 8) of the warp
        const int t4 = lane & 3;   // fragment column pair
        const uint32_t q_addr = smem_u32(qs + group * 64 * D * 2);

        float o[kOut];
#pragma unroll
        for (int i = 0; i < kOut; ++i) o[i] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY;  // running row max
        float l0 = 0.f, l1 = 0.f;  // this lane's share of the running sum

        float sc[64];               // S of one tile, then its exponentials
        uint32_t pa[kKeys / 16][4];  // P of one tile: A fragments in bf16
        float corr0, corr1;         // the rescale of one tile

        // S = Q K^T of the tile in stage s: k16 slices of D are 32-byte
        // steps inside the swizzled rows
        auto issue_s = [&](int s) {
            const uint32_t k_addr = smem_u32(ks + s * L::kTileBytes);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss_n128(sc, desc<kSw>(q_addr + 32 * kk, 16, kSbo),
                              desc<kSw>(k_addr + 32 * kk, 16, kSbo), kk > 0);
            wgmma_commit();
        };
        // O += P V over 16-key steps: key blocks 2j and 2j + 1 of S's
        // fragment, packed to bf16, are the A fragment of step j; V's 16 key
        // rows of step j start 16 * 2D bytes further
        auto issue_pv = [&](int s) {
            const uint32_t v_addr = smem_u32(vs + s * L::kTileBytes);
#pragma unroll
            for (int j = 0; j < kKeys / 16; ++j)
                wgmma_rs<D>(o, pa[j], desc<kSw>(v_addr + j * 16 * 2 * D,
                                                L::kTileBytes, kSbo));
            wgmma_commit();
        };
        // online softmax of tile t on the fragment: sc[4n + e] is (row g,
        // key 8n + 2 t4 + e), sc[4n + 2 + e] row g + 8; keys past J are
        // -inf (the last tile only)
        auto softmax = [&](int t) {
            const int nj = J - t * kKeys;
            if (nj < kKeys) {
#pragma unroll
                for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        if (8 * n + 2 * t4 + e >= nj) {
                            sc[4 * n + e] = -INFINITY;
                            sc[4 * n + 2 + e] = -INFINITY;
                        }
            }
            float tmax0 = -INFINITY, tmax1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < kKeys / 8; ++n) {
                tmax0 = fmaxf(tmax0, fmaxf(sc[4 * n], sc[4 * n + 1]));
                tmax1 = fmaxf(tmax1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
            }
            const float mn0 = fmaxf(m0, quad_max(tmax0));
            const float mn1 = fmaxf(m1, quad_max(tmax1));
            corr0 = ex2((m0 - mn0) * kLog2e);  // 0 on tile 0
            corr1 = ex2((m1 - mn1) * kLog2e);
            m0 = mn0;
            m1 = mn1;
            const float mb0 = mn0 * kLog2e;
            const float mb1 = mn1 * kLog2e;
            l0 *= corr0;
            l1 *= corr1;
#pragma unroll
            for (int n = 0; n < kKeys / 8; ++n) {
                sc[4 * n] = ex2(fmaf(sc[4 * n], kLog2e, -mb0));
                sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], kLog2e, -mb0));
                sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], kLog2e, -mb1));
                sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], kLog2e, -mb1));
                l0 += sc[4 * n] + sc[4 * n + 1];
                l1 += sc[4 * n + 2] + sc[4 * n + 3];
            }
        };
        // O *= the tile's rescale; P from the exponentials
        auto rescale_and_pack = [&]() {
#pragma unroll
            for (int n = 0; n < kOut / 4; ++n) {
                o[4 * n] *= corr0;
                o[4 * n + 1] *= corr0;
                o[4 * n + 2] *= corr1;
                o[4 * n + 3] *= corr1;
            }
#pragma unroll
            for (int j = 0; j < kKeys / 16; ++j) {
                pa[j][0] = pack_bf16(sc[8 * j], sc[8 * j + 1]);
                pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
                pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
                pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
            }
        };
        // P V's A registers stay untouched until its products complete
        auto fence_pa = [&]() {
#pragma unroll
            for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    asm volatile("" : "+r"(pa[j][i]) :: "memory");
        };

        // The two warpgroups take turns at issuing products (named
        // barriers 3 and 4, one per warpgroup's turn; warpgroup 0 first),
        // so that one's softmax runs under the other's products.
        auto wait_turn = [&]() {
            asm volatile("bar.sync %0, 256;\n" :: "r"(3 + group) : "memory");
        };
        auto pass_turn = [&]() {
            asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - group)
                         : "memory");
        };
        if (group == 1) pass_turn();

        // Tile t's S = Q K^T is issued together with tile t - 1's P V, so
        // tile t's softmax also runs while the tensor cores take P V.
        mbar_wait(q_full, 0);
        mbar_wait(&full[0], 0);
        wait_turn();
        wgmma_fence();
        issue_s(0);
        pass_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax(0);
        rescale_and_pack();
        for (int t = 1; t < n_tiles; ++t) {
            const int s = t % kStages;
            const int prev = (t - 1) % kStages;
            mbar_wait(&full[s], (t / kStages) & 1);
            fence_regs(o);
            wait_turn();
            wgmma_fence();
            issue_s(s);
            issue_pv(prev);
            pass_turn();
            wgmma_wait<1>();   // S of tile t
            fence_regs(sc);
            softmax(t);
            wgmma_wait<0>();   // P V of tile t - 1
            fence_regs(o);
            fence_pa();
            if (lane == 0) mbar_arrive(&empty[prev]);
            rescale_and_pack();
        }
        fence_regs(o);
        wait_turn();
        wgmma_fence();
        issue_pv((n_tiles - 1) % kStages);
        if (group == 0) pass_turn();   // warpgroup 1 takes the last turn
        wgmma_wait<0>();
        fence_regs(o);
        fence_pa();

        // normalise, round, stage in this warpgroup's Q rows (all of its
        // products have completed), store by TMA clipped at H*N
        const float inv0 = 1.f / quad_sum(l0);
        const float inv1 = 1.f / quad_sum(l1);
        uint16_t* os = reinterpret_cast<uint16_t*>(qs + group * 64 * D * 2);
        const int r0 = 16 * warp + g;
        fence_async_smem();
#pragma unroll
        for (int n = 0; n < kOut / 4; ++n) {
            const int c = 8 * n + 2 * t4;
            *reinterpret_cast<uint32_t*>(os + r0 * D + c) =
                pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
            *reinterpret_cast<uint32_t*>(os + (r0 + 8) * D + c) =
                pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
        }
        fence_async_smem();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + group) : "memory");
        if (tid == 0) tma_store(&out_map, os, 0, row0 + 64 * group, b);
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

// The mma_sync body's constants, as kernels/attention.py::bf16_plan states
// them: keys per tile, and its static shared memory (two buffers of K and
// V at the padded pitch).
constexpr int mma_sync_key_tile(int D) { return 4096 / D < 128 ? 4096 / D
                                                                : 128; }
constexpr int mma_sync_smem(int D) {
    return 2 * 2 * mma_sync_key_tile(D) * (D == 8 ? 24 : D + 8) * 2;
}

template <int D>
cudaError_t launch_bf16(const uint16_t* q, const uint16_t* k,
                        const uint16_t* v, uint16_t* out, int batch,
                        int rows, int J, int rows_per_cta,
                        cudaStream_t stream) {
    const int warps = rows_per_cta / 16;
    const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta, batch);
    imagen_attention_bf16_fwd_kernel<D><<<grid, 32 * warps, 0, stream>>>(
        q, k, v, out, rows, J);
    return cudaGetLastError();
}

int encode_3d(CUtensorMap* map, const void* base, int batch, int n, int D,
              int box_rows, CUtensorMapSwizzle swizzle) {
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return kEncodeError;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n,
                                (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)n * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(base), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int D>
int launch_bf16_wgmma(const uint16_t* q, const uint16_t* k,
                      const uint16_t* v, uint16_t* out, int batch, int rows,
                      int J, cudaStream_t stream) {
    using L = wg::Layout<D>;
    const CUtensorMapSwizzle swizzle =
        D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
    CUtensorMap qm, km, vm, om;
    int err;
    if ((err = encode_3d(&qm, q, batch, rows, D, wg::kRows, swizzle)) ||
        (err = encode_3d(&km, k, batch, J, D, wg::kKeys, swizzle)) ||
        (err = encode_3d(&vm, v, batch, J, D, wg::kKeys, swizzle)) ||
        (err = encode_3d(&om, out, batch, rows, D, wg::kRows / 2,
                         CU_TENSOR_MAP_SWIZZLE_NONE)))
        return err;
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            imagen_attention_bf16_wgmma_fwd_kernel<D>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    const dim3 grid((rows + wg::kRows - 1) / wg::kRows, batch);
    imagen_attention_bf16_wgmma_fwd_kernel<D>
        <<<grid, wg::kThreads, L::kBytes, stream>>>(qm, km, vm, om, J);
    return (int)cudaGetLastError();
}

// Whether (body, rows_per_cta, key_tile, stages, smem_bytes) is the plan
// this library's instance for D runs.
bool plan_matches(int D, int body, int rows_per_cta, int key_tile,
                  int stages, int smem_bytes) {
    if (body == kBodyMmaSync)
        return (rows_per_cta == 16 || rows_per_cta == 32 ||
                rows_per_cta == 64) &&
               key_tile == mma_sync_key_tile(D) && stages == 2 &&
               smem_bytes == mma_sync_smem(D);
    if (body != kBodyWgmma || rows_per_cta != wg::kRows ||
        key_tile != wg::kKeys || stages != wg::kStages)
        return false;
    switch (D) {
        case 16: return smem_bytes == wg::Layout<16>::kBytes;
        case 32: return smem_bytes == wg::Layout<32>::kBytes;
        case 64: return smem_bytes == wg::Layout<64>::kBytes;
        default: return false;
    }
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
// bf16 (the wrapper checks), run by the body and plan that
// kernels/attention.py::bf16_plan chose: body 0 the mma.sync body (rows
// per CTA 16, 32 or 64), body 1 the wgmma body (D = 16, 32 or 64).  A plan
// that is not this library's returns cudaErrorInvalidValue; tensor maps
// that cannot be made return kEncodeError (+ libcuda's CUresult).
extern "C" int sf_imagen_attention_fwd_bf16(const void* q, const void* k,
                                            const void* v, void* out,
                                            int batch, int rows, int J,
                                            int D, int body,
                                            int rows_per_cta, int key_tile,
                                            int stages, int smem_bytes,
                                            void* stream) {
    if (batch <= 0 || rows <= 0 || J <= 0 ||
        !plan_matches(D, body, rows_per_cta, key_tile, stages, smem_bytes))
        return (int)cudaErrorInvalidValue;
    const uint16_t* qh = static_cast<const uint16_t*>(q);
    const uint16_t* kh = static_cast<const uint16_t*>(k);
    const uint16_t* vh = static_cast<const uint16_t*>(v);
    uint16_t* oh = static_cast<uint16_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (body == kBodyWgmma) {
        switch (D) {
            case 16:
                return launch_bf16_wgmma<16>(qh, kh, vh, oh, batch, rows, J,
                                             s);
            case 32:
                return launch_bf16_wgmma<32>(qh, kh, vh, oh, batch, rows, J,
                                             s);
            case 64:
                return launch_bf16_wgmma<64>(qh, kh, vh, oh, batch, rows, J,
                                             s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    const int r = rows_per_cta;
    switch (D) {
        case 8:
            return (int)launch_bf16<8>(qh, kh, vh, oh, batch, rows, J, r, s);
        case 16:
            return (int)launch_bf16<16>(qh, kh, vh, oh, batch, rows, J, r, s);
        case 32:
            return (int)launch_bf16<32>(qh, kh, vh, oh, batch, rows, J, r, s);
        case 64:
            return (int)launch_bf16<64>(qh, kh, vh, oh, batch, rows, J, r, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
