// Imagen-style attention with one key/value head shared by all query
// heads, for Hopper (sm_90a): out = softmax(q k^T) v, forward only.
//
// Replaces the TPU kernel sparsefusion_tpu/kernels/attention.py::
// imagen_attention (body _attn_kernel).  q is (B, H, N, D), pre-scaled;
// k and v are (B, J, D) with the null key/value and any context tokens
// already prepended.  Logits, softmax and sums are f32.  No mask.
//
// What bounds it: k and v depend on the batch only, so one batch's H*N
// query rows all read the same J x D tiles.  At the view-conditioned
// UNet's shapes (H*N = 8 x 16 rows, J = 17 or 19, D = 64) the kernel is
// bound by its launch; at (2, 8, 1024, 64) with J = 1027 by f32 FMA
// throughput (2 x H*N x J x D multiply-adds per batch), since a J x D
// tile never leaves shared memory while the rows of the block consume it.
//
// Design: the (head, query) pairs of a batch are one axis of H*N rows
// (q's layout already makes them contiguous), so k and v are indexed by
// batch and never repeated per head.  One thread owns one query row: q
// and the output accumulator stay in registers; k/v stream through
// shared memory in tiles of kTileJ rows, which every thread reads at
// the same address (a broadcast, no bank conflicts); the softmax is the
// online (running max, running sum) form, rescaled once per tile, so
// any J works (the TPU kernel held the whole J x D block in VMEM, which
// a 1027 x 64 f32 block would overflow here).  Rows past H*N load
// tiles with the rest of the block and store nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileJ = 32;
constexpr int kMaxThreads = 128;

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
imagen_attention_fwd_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, int rows, int J) {
    static_assert(D % 4 == 0, "head dim must be a multiple of 4");
    constexpr int kVec = D / 4;
    __shared__ __align__(16) float ks[kTileJ][D];
    __shared__ __align__(16) float vs[kTileJ][D];

    const int b = blockIdx.y;
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    const bool active = row < rows;
    const long long q_off = ((long long)b * rows + row) * D;
    const float* kb = k + (long long)b * J * D;
    const float* vb = v + (long long)b * J * D;

    float qr[D];
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; d += 4) {
        float4 t = active ? *reinterpret_cast<const float4*>(q + q_off + d)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        qr[d] = t.x; qr[d + 1] = t.y; qr[d + 2] = t.z; qr[d + 3] = t.w;
        acc[d] = 0.f; acc[d + 1] = 0.f; acc[d + 2] = 0.f; acc[d + 3] = 0.f;
    }
    float m = -INFINITY;  // running max of the logits
    float l = 0.f;        // running sum of exp(logit - m)

    for (int j0 = 0; j0 < J; j0 += kTileJ) {
        const int nj = min(kTileJ, J - j0);
        __syncthreads();  // the previous tile has been consumed
        for (int i = threadIdx.x; i < kTileJ * kVec; i += blockDim.x) {
            const int jj = i / kVec;
            const int c = i % kVec;
            float4 kt = make_float4(0.f, 0.f, 0.f, 0.f);
            float4 vt = kt;
            if (jj < nj) {
                const long long off = (long long)(j0 + jj) * D + 4 * c;
                kt = *reinterpret_cast<const float4*>(kb + off);
                vt = *reinterpret_cast<const float4*>(vb + off);
            }
            reinterpret_cast<float4*>(&ks[jj][0])[c] = kt;
            reinterpret_cast<float4*>(&vs[jj][0])[c] = vt;
        }
        __syncthreads();
        if (!active) continue;

        float s[kTileJ];
        float tmax = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kTileJ; ++jj) {
            float dot = 0.f;
#pragma unroll
            for (int d = 0; d < D; d += 4) {
                const float4 kt = *reinterpret_cast<const float4*>(&ks[jj][d]);
                dot = fmaf(qr[d], kt.x, dot);
                dot = fmaf(qr[d + 1], kt.y, dot);
                dot = fmaf(qr[d + 2], kt.z, dot);
                dot = fmaf(qr[d + 3], kt.w, dot);
            }
            s[jj] = dot;
            if (jj < nj) tmax = fmaxf(tmax, dot);
        }
        const float m_new = fmaxf(m, tmax);
        const float corr = expf(m - m_new);  // 0 on the first tile
        l *= corr;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
        for (int jj = 0; jj < kTileJ; ++jj) {
            if (jj < nj) {
                const float p = expf(s[jj] - m_new);
                l += p;
#pragma unroll
                for (int d = 0; d < D; d += 4) {
                    const float4 vt =
                        *reinterpret_cast<const float4*>(&vs[jj][d]);
                    acc[d] = fmaf(p, vt.x, acc[d]);
                    acc[d + 1] = fmaf(p, vt.y, acc[d + 1]);
                    acc[d + 2] = fmaf(p, vt.z, acc[d + 2]);
                    acc[d + 3] = fmaf(p, vt.w, acc[d + 3]);
                }
            }
        }
        m = m_new;
    }

    if (active) {
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < D; d += 4) {
            *reinterpret_cast<float4*>(out + q_off + d) =
                make_float4(acc[d] * inv, acc[d + 1] * inv,
                            acc[d + 2] * inv, acc[d + 3] * inv);
        }
    }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   float* out, int batch, int rows, int J,
                   cudaStream_t stream) {
    const int threads = rows >= kMaxThreads ? kMaxThreads
                                            : ((rows + 31) / 32) * 32;
    const dim3 grid((rows + threads - 1) / threads, batch);
    imagen_attention_fwd_kernel<D><<<grid, threads, 0, stream>>>(
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
