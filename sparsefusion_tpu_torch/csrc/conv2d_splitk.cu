// K4: 2-D convolution forward as a split-K implicit GEMM, f32 inputs and
// outputs with 3xTF32 tensor-core products, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added for the view-conditioned UNet's batch-1 evaluations in the
// PLMS sampler, which took ~18 of each 20.6 device ms in cuDNN's f32
// implicit GEMM with 32 x 32 tiles: at batch 1 a convolution is a GEMM
// with M = H*W output pixels (16 at the 4x4 level, 64 at 8x8), N = C_out
// and K = C_in*kh*kw up to 58,500, so 32-64 output tiles ran each a
// 9,216-18,432-long K loop on 132 SMs, and most of the card's memory
// bandwidth was never asked for.  ~1.2 GB of the UNet's 1.6 GB of f32
// weights sit where M <= 64.
//
// What bounds it: at M <= 64 the weights' bytes (read once, at 3.35 TB/s),
// at M >= 256 the operations (67 TFLOP/s is the f32 rate outside the tensor
// cores; 3xTF32 issues three TF32 products a product).  On an H100 it runs
// at 22-31% of that bound at the UNet's main shapes (PERF.md, section 6).
//
// Design:
// * GEMM.  out[m, n] = sum_k A[m, k] W[n, k] + bias[n], m = (b, oy, ox),
//   n = c_out, k = (c_in, ky, kx).  A is gathered on the fly from the NCHW
//   input (implicit im2col), with zeros for the padding; W is the weight
//   as stored, [C_out, C_in*kh*kw] with K contiguous: no re-layout, no
//   copy.  Any kh, kw, stride and padding; groups 1, dilation 1.
// * Tiles.  A CTA takes BM x 64 outputs (BM = 16, 32 or 64 by the plan)
//   over a contiguous range of 32-wide K blocks, with 8 warps: 4 tile the
//   outputs, and two such groups take half of each K block's 8-wide steps
//   (with one CTA an SM, 4 warps left each scheduler one warp to wait on
//   its own chain of products); the groups' sums add in the epilogue,
//   group 0's first.  Both operands stream into a ring of shared-memory
//   stages with cp.async (the weights 16 bytes a copy where K % 4 == 0,
//   the input 4 bytes a copy), 8 stages at BM <= 32, where the weights'
//   bytes bound the call, 6 at BM = 64.  Padded pitches make every
//   fragment read conflict-free.
// * Split K.  kernels/conv2d.py::plan picks BM and a number of splits S <=
//   8 (the portable cluster size) so that tiles x S covers the 132 SMs in
//   about one wave; S = 1 wherever the tiles alone fill the card.  The S
//   CTAs of one output tile form a thread-block cluster, each summing its
//   share of K.
// * Reduction inside the cluster.  Each CTA parks its partial tile in its
//   own shared memory; after a cluster barrier, CTA r sums an r-th of the
//   tile over the S partials through distributed shared memory, in rank
//   order 0..S-1, adds the bias and writes the output.  No float atomics
//   (two launches give the same bits) and no device-memory workspace.
// * Products.  mma.sync.m16n8k8 in TF32 with f32 accumulation, each operand
//   split as x = big + small and each product taken as a_small b_big +
//   a_big b_small + a_big b_big (3xTF32, as K2): about f32 accuracy, where
//   one TF32 pass keeps ~3 digits.  The split is done in integers
//   (split_int).  16 output pixels fill one m16 fragment.  Each K group's
//   steps of a 32-wide block sum into a fresh partial that is then added
//   to the accumulator in f32: the tensor cores' accumulation rounds
//   toward zero, and over a split's hundreds of steps that bias alone took
//   the 4x4 level's outputs 3e-5 from float64 on an H100 (1e-6 with the
//   partials).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpsK = 2;                 // warp groups along K
constexpr int kThreads = 128 * kWarpsK;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kMaxSplits = 8;

struct ConvShape {
    int cin, h, w, cout, kh, kw, sh, sw, ph, pw, ho, wo;
    int m, k;   // GEMM sizes: m = batch*ho*wo, k = cin*kh*kw (n = cout)
};

template <int BM>
struct Tile {
    // 4 warps tile the output; kWarpsK groups of them split each K block
    static constexpr int kWarpsM = BM >= 32 ? 2 : 1;
    static constexpr int kWarpsN = 4 / kWarpsM;
    static constexpr int kWTM = BM / kWarpsM;   // a warp's rows
    static constexpr int kWTN = kBN / kWarpsN;  // a warp's columns
    static constexpr int kMF = kWTM / 16;       // m16 fragments a warp
    static constexpr int kNF = kWTN / 8;        // n8 fragments a warp
    static constexpr int kStages = BM <= 32 ? 8 : 6;
    static constexpr int kAPitch = BM + 8;      // As[k][m]
    static constexpr int kBPitch = kBK + 4;     // Bs[n][k]
    static constexpr int kCPitch = BM + 4;      // the partial tile, [n][m]
    static constexpr int kAStage = kBK * kAPitch;
    static constexpr int kBStage = kBN * kBPitch;
    static constexpr int kSmemFloats = kStages * (kAStage + kBStage);
    static constexpr int kKPT = kBK * BM / kThreads;  // gathered k a thread
    static_assert(kBN * kCPitch <= kSmemFloats, "partial tile fits the ring");
    static_assert(kKPT >= 1 && kBK * BM % kThreads == 0, "gather split");
};

// split() in integer and float adds, in place of two cvt.rna conversions:
// big = x rounded to TF32 (nearest, ties away: the bits of |x| plus half a
// TF32 ulp, the low 13 bits cleared), small = x - big with its low 13 bits
// cleared (toward zero); the tensor cores read both as TF32.
__device__ __forceinline__ void split_int(float x, uint32_t& big,
                                          uint32_t& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
conv2d_splitk_kernel(const float* __restrict__ x,
                     const float* __restrict__ wt,
                     const float* __restrict__ bias,
                     float* __restrict__ out, ConvShape s, int vec_w) {
    using T = Tile<BM>;
    extern __shared__ __align__(16) float smem[];
    float* as_ring = smem;                             // [stages][kBK][kAPitch]
    float* bs_ring = smem + T::kStages * T::kAStage;   // [stages][kBN][kBPitch]

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int splits = gridDim.x;   // the cluster is (splits, 1, 1)
    const int n0 = blockIdx.y * kBN;
    const int m0 = blockIdx.z * BM;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2;   // fragment row (and row + 8); B's column
    const int t = lane & 3;    // fragment column (and + 4); B's row
    const int kg = warp / 4;   // this warp's K group
    const int wm = (warp % 4) / T::kWarpsN, wn = (warp % 4) % T::kWarpsN;

    // this split's K blocks
    const int kblocks = (s.k + kBK - 1) / kBK;
    const int kb0 = (int)((long long)rank * kblocks / splits);
    const int nk = (int)((long long)(rank + 1) * kblocks / splits) - kb0;

    // the input gather: this thread's output pixel and kKPT consecutive k
    const int a_m = tid % BM;
    const int a_k = (tid / BM) * T::kKPT;
    const int hw = s.ho * s.wo;
    const int gm_a = m0 + a_m;
    const bool m_ok = gm_a < s.m;
    int iy0 = 0, ix0 = 0;
    const float* xb = x;
    if (m_ok) {
        const int b = gm_a / hw, p = gm_a % hw;
        iy0 = (p / s.wo) * s.sh - s.ph;
        ix0 = (p % s.wo) * s.sw - s.pw;
        xb = x + (size_t)b * s.cin * s.h * s.w;
    }
    const int khw = s.kh * s.kw;

    auto load_stage = [&](int slot, int kb) {
        float* as = as_ring + slot * T::kAStage;
        float* bs = bs_ring + slot * T::kBStage;
        int k = kb * kBK + a_k;
        int ci = k / khw;
        int ky = (k - ci * khw) / s.kw;
        int kx = k - ci * khw - ky * s.kw;
#pragma unroll
        for (int j = 0; j < T::kKPT; ++j, ++k) {
            const int iy = iy0 + ky, ix = ix0 + kx;
            const bool ok = m_ok && k < s.k && (unsigned)iy < (unsigned)s.h
                            && (unsigned)ix < (unsigned)s.w;
            const float* src =
                ok ? xb + ((size_t)ci * s.h + iy) * s.w + ix : x;
            cp_async4(as + (a_k + j) * T::kAPitch + a_m, src, ok);
            if (++kx == s.kw) {
                kx = 0;
                if (++ky == s.kh) { ky = 0; ++ci; }
            }
        }
        const int kbase = kb * kBK;
        if (vec_w) {
#pragma unroll
            for (int j = 0; j < kBN * kBK / 4 / kThreads; ++j) {
                const int c = tid + j * kThreads;
                const int n = c / (kBK / 4), kc = (c % (kBK / 4)) * 4;
                const bool ok = n0 + n < s.cout && kbase + kc < s.k;
                const float* src =
                    ok ? wt + (size_t)(n0 + n) * s.k + kbase + kc : wt;
                cp_async16(bs + n * T::kBPitch + kc, src, ok);
            }
        } else {
#pragma unroll 4
            for (int j = 0; j < kBN * kBK / kThreads; ++j) {
                const int c = tid + j * kThreads;
                const int n = c / kBK, kc = c % kBK;
                const bool ok = n0 + n < s.cout && kbase + kc < s.k;
                const float* src =
                    ok ? wt + (size_t)(n0 + n) * s.k + kbase + kc : wt;
                cp_async4(bs + n * T::kBPitch + kc, src, ok);
            }
        }
    };

    float acc[T::kMF][T::kNF][4];
#pragma unroll
    for (int mi = 0; mi < T::kMF; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNF; ++ni)
            acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
                acc[mi][ni][3] = 0.f;

#pragma unroll
    for (int st = 0; st < T::kStages - 1; ++st) {
        if (st < nk) load_stage(st, kb0 + st);
        cp_async_commit();
    }
    for (int i = 0; i < nk; ++i) {
        cp_async_wait<T::kStages - 2>();
        __syncthreads();   // stage i is in; stage i - 1 is free again
        const int next = i + T::kStages - 1;
        if (next < nk) load_stage(next % T::kStages, kb0 + next);
        cp_async_commit();
        const float* as = as_ring + (i % T::kStages) * T::kAStage;
        const float* bs = bs_ring + (i % T::kStages) * T::kBStage;
        // this K group's 8-wide steps of the block sum into a fresh
        // partial, added to the accumulator in f32: the tensor cores'
        // accumulation rounds toward zero, a bias that would grow with
        // every step of a long K loop
        float part[T::kMF][T::kNF][4];
#pragma unroll
        for (int mi = 0; mi < T::kMF; ++mi)
#pragma unroll
            for (int ni = 0; ni < T::kNF; ++ni)
                part[mi][ni][0] = part[mi][ni][1] = part[mi][ni][2] =
                    part[mi][ni][3] = 0.f;
#pragma unroll
        for (int kk = kg * kBK / kWarpsK; kk < (kg + 1) * kBK / kWarpsK;
             kk += 8) {
            // A fragments: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
            // a3 (g + 8, t + 4), as (row m, column k)
            uint32_t a_big[T::kMF][4], a_small[T::kMF][4];
#pragma unroll
            for (int mi = 0; mi < T::kMF; ++mi) {
                const float* a = as + (kk + t) * T::kAPitch
                                 + wm * T::kWTM + mi * 16 + g;
                split_int(a[0], a_big[mi][0], a_small[mi][0]);
                split_int(a[8], a_big[mi][1], a_small[mi][1]);
                split_int(a[4 * T::kAPitch], a_big[mi][2], a_small[mi][2]);
                split_int(a[4 * T::kAPitch + 8], a_big[mi][3],
                          a_small[mi][3]);
            }
#pragma unroll
            for (int ni = 0; ni < T::kNF; ++ni) {
                // B fragment: b0 (k t, n g), b1 (k t + 4, n g)
                const float* b = bs + (wn * T::kWTN + ni * 8 + g) * T::kBPitch
                                 + kk + t;
                uint32_t bb0, bs0, bb1, bs1;
                split_int(b[0], bb0, bs0);
                split_int(b[4], bb1, bs1);
#pragma unroll
                for (int mi = 0; mi < T::kMF; ++mi) {
                    mma_tf32(part[mi][ni], a_small[mi], bb0, bb1);
                    mma_tf32(part[mi][ni], a_big[mi], bs0, bs1);
                    mma_tf32(part[mi][ni], a_big[mi], bb0, bb1);
                }
            }
        }
#pragma unroll
        for (int mi = 0; mi < T::kMF; ++mi)
#pragma unroll
            for (int ni = 0; ni < T::kNF; ++ni)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[mi][ni][c] += part[mi][ni][c];
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is drained: the partial tile goes over it

    // this CTA's partial tile, [n][m]: c0 (g, 2t), c1 (g, 2t + 1),
    // c2 (g + 8, 2t), c3 (g + 8, 2t + 1); K group 0 writes it, each later
    // group adds its sums in turn
    float* cs = smem;
    for (int group = 0; group < kWarpsK; ++group) {
        if (kg == group) {
#pragma unroll
            for (int mi = 0; mi < T::kMF; ++mi)
#pragma unroll
                for (int ni = 0; ni < T::kNF; ++ni) {
                    const int m = wm * T::kWTM + mi * 16 + g;
                    const int n = wn * T::kWTN + ni * 8 + 2 * t;
                    float* c0 = cs + n * T::kCPitch + m;
                    float* c1 = c0 + T::kCPitch;
                    if (group == 0) {
                        c0[0] = acc[mi][ni][0];
                        c1[0] = acc[mi][ni][1];
                        c0[8] = acc[mi][ni][2];
                        c1[8] = acc[mi][ni][3];
                    } else {
                        c0[0] += acc[mi][ni][0];
                        c1[0] += acc[mi][ni][1];
                        c0[8] += acc[mi][ni][2];
                        c1[8] += acc[mi][ni][3];
                    }
                }
        }
        __syncthreads();
    }
    cluster.sync();   // every partial of the cluster is in place

    // CTA `rank` reduces elements [e0, e1) of the BN x BM tile (n-major),
    // over the partials in rank order
    constexpr int kE = kBN * BM;
    const int e0 = rank * kE / splits;
    const int e1 = (rank + 1) * kE / splits;
    for (int e = e0 + tid; e < e1; e += kThreads) {
        const int n = e / BM, m = e % BM;
        const int off = n * T::kCPitch + m;
        float v = *cluster.map_shared_rank(cs + off, 0);
        for (int q = 1; q < splits; ++q)
            v += *cluster.map_shared_rank(cs + off, q);
        const int gn = n0 + n, gm = m0 + m;
        if (gn < s.cout && gm < s.m) {
            if (bias != nullptr) v += bias[gn];
            const int b = gm / hw, p = gm % hw;
            out[((size_t)b * s.cout + gn) * hw + p] = v;
        }
    }
    cluster.sync();   // no CTA leaves while another reads its partial
}

template <int BM>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, const ConvShape& s, int splits, int vec_w,
                   cudaStream_t stream) {
    using T = Tile<BM>;
    constexpr int kSmem = T::kSmemFloats * (int)sizeof(float);
    static bool attribute_set = false;
    if (!attribute_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            conv2d_splitk_kernel<BM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (e != cudaSuccess) return e;
        attribute_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (s.cout + kBN - 1) / kBN, (s.m + BM - 1) / BM);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, conv2d_splitk_kernel<BM>,
                                             x, w, bias, out, s, vec_w);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace

// x (batch, cin, h, w), w (cout, cin, kh, kw), bias (cout) or null, out
// (batch, cout, ho, wo); all f32 and contiguous (the wrapper checks).
// bm and splits are kernels/conv2d.py::plan's; vec_w: the weight rows are
// 16-byte aligned (K % 4 == 0 and w 16-byte aligned).  Returns the CUDA
// error of the launch, or cudaErrorInvalidValue for a shape or plan
// outside what the kernel takes.
extern "C" int sf_conv2d_splitk(const void* x, const void* w,
                                const void* bias, void* out, int batch,
                                int cin, int h, int width, int cout, int kh,
                                int kw, int sh, int sw, int ph, int pw,
                                int bm, int splits, int vec_w,
                                void* stream) {
    if (batch <= 0 || cin <= 0 || h <= 0 || width <= 0 || cout <= 0 ||
        kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 ||
        splits < 1 || splits > kMaxSplits)
        return (int)cudaErrorInvalidValue;
    ConvShape s;
    s.cin = cin; s.h = h; s.w = width; s.cout = cout;
    s.kh = kh; s.kw = kw; s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
    s.ho = (h + 2 * ph - kh) / sh + 1;
    s.wo = (width + 2 * pw - kw) / sw + 1;
    if (h + 2 * ph < kh || width + 2 * pw < kw)
        return (int)cudaErrorInvalidValue;
    s.m = batch * s.ho * s.wo;
    s.k = cin * kh * kw;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(bias);
    float* of = static_cast<float*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (bm) {
        case 16: return (int)launch<16>(xf, wf, bf, of, s, splits, vec_w, st);
        case 32: return (int)launch<32>(xf, wf, bf, of, s, splits, vec_w, st);
        case 64: return (int)launch<64>(xf, wf, bf, of, s, splits, vec_w, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
