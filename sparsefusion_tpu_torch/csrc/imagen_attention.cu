// Imagen-style attention with one key/value head shared by all query
// heads, for Hopper (sm_90a): out = softmax(q k^T) v, forward only.
//
// Replaces the TPU kernel sparsefusion_tpu/kernels/attention.py::
// imagen_attention (body _attn_kernel).  q is (B, H, N, D), pre-scaled;
// k and v are (B, J, D) with the null key/value and any context tokens
// already prepended.  Inputs, outputs and sums are f32.  No mask.
//
// What bounds it: at the view-conditioned UNet's shapes (H*N = 8 x 16
// rows, J = 17 or 19, D = 64) the work is 0.6 MFLOP on 75 KB, so the
// launch and the latency of one block's chain of dependent steps bound
// it; at (2, 8, 1024, 64) with J = 1027 the 4.3 GFLOP of the two
// products do, which f32 FMA units (67 TFLOP/s) run at a third of the
// rate the tensor cores run TF32 (495 TFLOP/s).
//
// Design:
// * Rows.  The (head, query) pairs of a batch are one axis of H*N rows
//   (q's layout makes them contiguous), so k and v are indexed by batch
//   and never repeated per head.  Each warp owns a 16-row m-tile; a block
//   holds 1, 2 or 4 warps, fewer when the grid would otherwise leave SMs
//   idle (the UNet's 128 rows run as 8 one-warp blocks, not one block).
//   Rows past H*N load zeros and store nothing.
// * k/v tiles of kJ keys (32 at D = 64, 64 at D = 32) stream into shared
//   memory with 16-byte cp.async, double-buffered; keys past J load as
//   zeros and their logits are -inf.  Rows are padded to D + 4 floats so
//   that every fragment read below hits 32 distinct banks.
// * Products on the tensor cores: S = Q K^T and O += P V are
//   mma.sync.m16n8k8 in TF32 with f32 accumulation, each operand split
//   as x = big + small (big = tf32(x), small = tf32(x - big)) and each
//   product taken as a_small b_big + a_big b_small + a_big b_big
//   ("3xTF32"): about f32 accuracy, where one TF32 pass keeps ~3 digits.
// * Online softmax over the tiles (running max and sum per row, the
//   accumulator rescaled once per tile), so any J works.  The softmax runs
//   on S's accumulator fragment in registers; row max and sum reduce over
//   the 4 lanes of a quad.  The keys of each 8-key step of P V are taken
//   in the order (0, 2, 4, 6, 1, 3, 5, 7), which makes S's accumulator
//   fragment P's A fragment as it stands: no shuffle, no shared memory.
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
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
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
    static_assert(D % 32 == 0, "head dim must be a multiple of 32");
    constexpr int kJ = 2048 / D;  // keys per tile
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

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int batch, int rows, int J,
                   cudaStream_t stream) {
    // 4 warps a block, halved while the grid would not cover the SMs
    int warps = kMaxWarps;
    while (warps > 1 &&
           (long long)batch * ((rows + 16 * warps - 1) / (16 * warps))
               < sm_count())
        warps /= 2;
    const dim3 grid((rows + 16 * warps - 1) / (16 * warps), batch);
    imagen_attention_fwd_kernel<D><<<grid, 32 * warps, 0, stream>>>(
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
        case 32: return (int)launch<32>(qf, kf, vf, of, batch, rows, J, s);
        case 64: return (int)launch<64>(qf, kf, vf, of, batch, rows, J, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
