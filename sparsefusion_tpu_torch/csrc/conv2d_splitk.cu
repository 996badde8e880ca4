// K4: 2-D convolution forward as a split-K implicit GEMM, f32 inputs and
// outputs with 3xTF32 products on Hopper's warpgroup tensor-core
// instructions (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added for the view-conditioned UNet's batch-1 evaluations in the
// PLMS sampler, which took ~18 of each 20.6 device ms in cuDNN's f32
// implicit GEMM with 32 x 32 tiles: at batch 1 a convolution is a GEMM
// with 1-1024 output pixels, C_out output channels and a reduction over
// K = C_in*kh*kw up to 58,500, too few output tiles to ask for the card's
// memory bandwidth.  It serves Zero-1-to-3's SD-v1 UNet and CLIP's patch
// embedding the same way.
//
// What bounds it: where the output has 64 pixels or fewer (the 4x4 and
// 8x8 levels) the weights' bytes, read once at 3.35 TB/s (89% of the
// VLDM's 1.43 GB of f32 weights an evaluation, 85% of Zero123's 2.36 GB);
// above that the operations, at 165 TFLOP/s for three TF32 products a
// product (67 TFLOP/s is the f32 rate outside the tensor cores).  On an
// H100 (700 W, weights cold) the 4x4 3x3s run at 42-54% of the bytes
// bound, the M = 1024 ones at 54-63% of the bytes-or-f32 bound and 22-26%
// of the 3xTF32 one, held back by the producers' gather; the one-pixel
// 1x1s take ~6 us, most of it launch and latency (PERF.md, section 6).
//
// Design:
// * GEMM, roles swapped for wgmma.  out[n, m] = sum_k W[n, k] X[k, m] +
//   bias[n], n = c_out on wgmma's 64 rows, m = (b, oy, ox) the output
//   pixels on its N (8-64 columns), k = (c_in, ky, kx).  W is the weight
//   as stored, [C_out, K] with K contiguous, which is the K-major A that
//   wgmma takes for TF32: no re-layout and no copy.  The accumulator tile
//   is [channels][pixels], so the NCHW stores run along the pixels.  Any
//   kh, kw, stride and padding; groups 1, dilation 1.
// * CTA.  512 threads: two producer and two consumer warpgroups, over a
//   ring of stages in shared memory (up to 16; one CTA an SM).  A CTA
//   takes 64 RG output channels by BN output pixels (BN = 8, 16, 32 or
//   64, RG = 1 or 2 by the plan) over a contiguous range of 32-wide K
//   blocks.  The producers take the blocks in turn (even, odd): thread 0
//   of one copies block i + kStages / 2's weight tile by TMA (a 2-D tensor
//   map over [C_out, K], 128-byte swizzle, zeros past the edges; the
//   stage's mbarrier counts its bytes), and all 128 threads gather block
//   i + 2's input patch from the NCHW input into registers (implicit
//   im2col, reads along the pixels, zeros for the padding) while they
//   split block i's, each element once, into its two TF32 halves and
//   store them as two K-major tiles in the swizzle wgmma reads.  Where K %
//   4 != 0 (TMA wants 16-byte rows) the producer copies the weight tile
//   itself; no convolution of either UNet, nor CLIP's, needs that.  The
//   consumers issue no loads of device memory.  Where RG = 1 (the M <= 64
//   convolutions, bound by the weights' bytes, and N = 64) they take the
//   blocks in turn, so one's bookkeeping runs under the other's products;
//   where RG = 2 (M and N above 64, bound by the products and the gather
//   that feeds them) each takes 64 of the 128 channels of every block, so
//   one gathered input tile serves both.
// * Products.  Per block a consumer warpgroup reads its 64 x 32 weight
//   tile into registers, splits it (x = big + small: big rounded to the
//   nearest TF32, small the rest toward zero) and issues, per 8-deep
//   step, wgmma.m64nBNk8 three times: a_small b_big, a_big b_small,
//   a_big b_big (3xTF32: about f32 accuracy, where one TF32 pass keeps ~3
//   digits).  The block's first product starts a fresh partial (scale-d
//   0), which is added to the f32 accumulator once the block's products
//   complete: the tensor cores' accumulation rounds toward zero, and over
//   a split's hundreds of steps that bias alone took the 4x4 level's
//   outputs 3e-5 from float64 on an H100 (1e-6 with the partials).  Each
//   thread reads the weight tile's columns 2t and 2t + 1 of a step as
//   wgmma's columns t and t + 4 (one 8-byte read), and the producers write
//   the input's k order permuted to match.
// * Split K.  kernels/conv2d.py::plan picks BN, RG and a number of splits
//   S <= 8 (the portable cluster size): the most whose clusters all run
//   at once (an H100 runs 15 clusters of 8 CTAs, 17 of 6, 30 of 4, 66 of
//   2 of this kernel), so that no convolution takes a second wave; S = 1
//   wherever the tiles alone fill the card.  The S CTAs of one output tile
//   form a thread-block cluster, each summing its share of K blocks.
// * Reduction inside the cluster.  Each CTA parks its partial tile in its
//   own shared memory (where RG = 1 consumer warpgroup 0's sums, then 1's
//   added); after a cluster barrier, CTA r sums an r-th of the tile, four
//   pixels at a time, over the S partials through distributed shared
//   memory, in rank order 0..S-1, adds the bias and writes the output.  No
//   float atomics (two launches give the same bits) and no device-memory
//   workspace.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;           // a consumer warpgroup's channels (M)
constexpr int kBK = 32;             // a K block: one 128-byte tile row
constexpr int kMaxSplits = 8;
constexpr int kThreads = 512;       // two consumer and two producer groups
// registers a thread after setmaxnreg: 2 x 128 x 144 + 2 x 128 x 96 =
// 61,440, within what the 512 threads hold at launch (ptxas gives each
// 128): asking for more leaves the consumers' setmaxnreg.inc waiting for
// ever
constexpr int kProducerRegs = 96;
constexpr int kConsumerRegs = 144;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxStages = 16;

struct ConvShape {
    int cin, h, w, cout, kh, kw, sh, sw, ph, pw, ho, wo;
    int m, k;   // GEMM sizes: m = batch*ho*wo, k = cin*kh*kw (n = cout)
};

// Shared memory, from a 1024-byte boundary (the swizzle's period): the
// ring of stages, each the weight tile [64 RG][32] then the input tile's
// big and small halves [BN][32], all rows 128 bytes and swizzled; then the
// stages' full and empty mbarriers.  The partial tile [64 RG][BN + 8] goes
// over the ring once it is drained.  RG: the CTA's 64-row groups of output
// channels, one a consumer warpgroup where RG = 2.
template <int BN, int RG>
struct Layout {
    static constexpr int kRowsCta = kRows * RG;
    static constexpr int kWBytes = kRowsCta * kBK * 4;
    static constexpr int kXBytes = BN * kBK * 4;
    static constexpr int kStageBytes = kWBytes + 2 * kXBytes;
    static constexpr int kStages =
        (kSmemLimit - 1024 - 16 * kMaxStages) / kStageBytes < kMaxStages
            ? (kSmemLimit - 1024 - 16 * kMaxStages) / kStageBytes
            : kMaxStages;
    static constexpr int kBarOffset = kStages * kStageBytes;
    static constexpr int kBytes = kBarOffset + 16 * kStages + 1024;
    static constexpr int kCPitch = BN + 8;   // the partial tile's rows
    // the gather: threads along the pixels for each of a row's 8 chunks
    static constexpr int kLanesP = BN < 16 ? BN : 16;
    static constexpr int kPixPerThread = BN / kLanesP;
    static_assert(kRowsCta * kCPitch * 4 <= kBarOffset,
                  "partial fits the ring");
    static_assert(kStages >= 2, "a ring of two stages at least");
};

// After the main loops: every thread of the CTA syncs with the cluster,
// reduces its CTA's share of the tile, four pixels at a time, over the S
// partials in rank order (all S reads in flight at once), adds the bias
// and stores; a last barrier keeps each CTA's partial alive until the
// cluster has read it.
template <int BN, int RG>
__device__ __forceinline__ void reduce_and_store(
        float* cs, const float* __restrict__ bias, float* __restrict__ out,
        const ConvShape& s, int n0, int m0) {
    using L = Layout<BN, RG>;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int splits = gridDim.x;   // the cluster is (splits, 1, 1)
    cluster.sync();   // every partial of the cluster is in place
    constexpr int kE = L::kRowsCta * BN / 4;
    const int e0 = rank * kE / splits;
    const int e1 = (rank + 1) * kE / splits;
    const int hw = s.ho * s.wo;
    for (int e = e0 + (int)threadIdx.x; e < e1; e += kThreads) {
        const int n = e / (BN / 4), m = 4 * (e % (BN / 4));
        float* at = cs + n * L::kCPitch + m;
        float4 part[kMaxSplits];
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q)
            if (q < splits)
                part[q] = *reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(at, q));
        float4 v = part[0];
#pragma unroll
        for (int q = 1; q < kMaxSplits; ++q)
            if (q < splits) {
                v.x += part[q].x;
                v.y += part[q].y;
                v.z += part[q].z;
                v.w += part[q].w;
            }
        const int gn = n0 + n;
        if (gn >= s.cout) continue;
        const float add = bias != nullptr ? bias[gn] : 0.f;
        const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int gm = m0 + m + u;
            if (gm < s.m) {
                const int b = gm / hw, p = gm % hw;
                out[((size_t)b * s.cout + gn) * hw + p] =
                    bias != nullptr ? vals[u] + add : vals[u];
            }
        }
    }
    cluster.sync();   // no CTA leaves while another reads its partial
}

template <int BN, int RG>
__global__ void __launch_bounds__(kThreads, 1)
conv2d_splitk_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                           const float* __restrict__ x,
                           const float* __restrict__ wt,
                           const float* __restrict__ bias,
                           float* __restrict__ out, ConvShape s, int tma_w) {
    using L = Layout<BN, RG>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
    uint64_t* empty = full + L::kStages;

    const int rank = (int)cg::this_cluster().block_rank();
    const int splits = gridDim.x;   // the cluster is (splits, 1, 1)
    const int n0 = blockIdx.y * L::kRowsCta;
    const int m0 = blockIdx.z * BN;
    // this split's K blocks
    const int kblocks = (s.k + kBK - 1) / kBK;
    const int kb0 = (int)((long long)rank * kblocks / splits);
    const int nk = (int)((long long)(rank + 1) * kblocks / splits) - kb0;

    if (threadIdx.x == 0) {
        // the tensor map's first read starts now, under the set-up
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
        for (int st = 0; st < L::kStages; ++st) {
            // the weight copy's arrival (with its bytes) + one a gather warp
            mbar_init(&full[st], 1 + 4);
            // the consuming warpgroup's warps, or both's where RG = 2
            mbar_init(&empty[st], 4 * RG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int group = threadIdx.x / 128;
    if (group >= 2) {
        // ---- producers: warpgroup pg = group - 2 takes blocks pg, pg + 2,
        // ...: the input tile gathered into registers one of its blocks
        // ahead, split and stored as the consumers read it; its thread 0
        // copies block i + kAhead's weight tile by TMA.  Half the ring
        // ahead: block i + kAhead's stage was consumed long ago, so the
        // copy never waits on the consumers (at kStages - 2 ahead it
        // waited on the block before last, and the 4x4 level's 3x3 took
        // 33 us in place of 25 on an H100)
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        constexpr int kAhead = L::kStages / 2;
        constexpr int P = L::kPixPerThread;
        const int pg = group - 2;
        const int pt = threadIdx.x % 128;
        const int lane = pt % 32;
        // this thread's chunk c of every 32-wide row, which holds k = kbase
        // + 8 (c / 2) + c % 2 + 2 e, e = 0..3 (the consumers' order), and
        // its pixels p_lo + kLanesP q; threads past 8 kLanesP gather nothing
        const int c = pt / L::kLanesP;
        const bool gathers = c < 8;
        const int p_lo = pt % L::kLanesP;
        const int hw_in = s.h * s.w;
        const int hw = s.ho * s.wo;
        const float* xq[P];
        int iy0[P], ix0[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const int gm = m0 + p_lo + L::kLanesP * q;
            if (gathers && gm < s.m) {
                const int b = gm / hw, p = gm % hw;
                iy0[q] = (p / s.wo) * s.sh - s.ph;
                ix0[q] = (p % s.wo) * s.sw - s.pw;
                xq[q] = x + (b * s.cin * hw_in + iy0[q] * s.w + ix0[q]);
            } else {   // out of every row: each tap fails the bounds test
                iy0[q] = ix0[q] = -(1 << 24);
                xq[q] = x;
            }
        }
        // the next block's four k as (c_in, ky, kx), advanced two blocks
        // (64) at a time
        const int khw = s.kh * s.kw;
        const int d_ci = 2 * kBK / khw, d_ky = 2 * kBK % khw / s.kw,
                  d_kx = 2 * kBK % khw % s.kw;
        int k0 = (kb0 + pg) * kBK + 8 * (c >> 1) + (c & 1);
        int ci[4], ky[4], kx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int k = k0 + 2 * e;
            ci[e] = k / khw;
            ky[e] = k % khw / s.kw;
            kx[e] = k % khw % s.kw;
        }
        // the next block's input values, read along the pixels
        auto gather = [&](float (&v)[P][4]) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool kok = gathers && k0 + 2 * e < s.k;
                const int off = ci[e] * hw_in + ky[e] * s.w + kx[e];
#pragma unroll
                for (int q = 0; q < P; ++q) {
                    const bool ok =
                        kok && (unsigned)(iy0[q] + ky[e]) < (unsigned)s.h
                        && (unsigned)(ix0[q] + kx[e]) < (unsigned)s.w;
                    v[q][e] = ok ? __ldg(xq[q] + off) : 0.f;
                }
                kx[e] += d_kx;
                if (kx[e] >= s.kw) { kx[e] -= s.kw; ++ky[e]; }
                ky[e] += d_ky;
                if (ky[e] >= s.kh) { ky[e] -= s.kh; ++ci[e]; }
                ci[e] += d_ci;
            }
            k0 += 2 * kBK;
        };
        auto tma_weights = [&](int j) {   // block j's weight tile
            const int st = j % L::kStages;
            mbar_expect_tx(&full[st], L::kWBytes);
            tma_load_2d(smem + st * L::kStageBytes, &w_map, &full[st],
                        (kb0 + j) * kBK, n0);
        };
        if (tma_w && pg == 0 && pt == 0)   // the ring starts empty
            for (int j = 0; j < kAhead && j < nk; ++j) tma_weights(j);
        float v[P][4];
        if (pg < nk) gather(v);
        for (int i = pg; i < nk; i += 2) {
            const int st = i % L::kStages;
            float cur[P][4];
#pragma unroll
            for (int q = 0; q < P; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) cur[q][e] = v[q][e];
            if (i + 2 < nk) gather(v);   // in flight while block i is stored
            const int j = i + kAhead;
            if (tma_w && pt == 0 && j < nk) {
                if (j >= L::kStages)   // block j - kStages is consumed
                    mbar_wait(&empty[j % L::kStages],
                              (j / L::kStages - 1) & 1);
                tma_weights(j);
            }
            if (i >= L::kStages)   // so is block i - kStages
                mbar_wait(&empty[st], (i / L::kStages - 1) & 1);
            uint8_t* stage = smem + st * L::kStageBytes;
            if (!tma_w) {
                // the weight tile by plain loads, in the layout TMA writes
                float* ws = reinterpret_cast<float*>(stage);
                const int kbase = (kb0 + i) * kBK;
                for (int e = pt; e < L::kRowsCta * kBK; e += 128) {
                    const int r = e / kBK, cc = e % kBK;
                    const bool ok = n0 + r < s.cout && kbase + cc < s.k;
                    ws[r * kBK + (((cc >> 2) ^ (r & 7)) << 2) + (cc & 3)] =
                        ok ? wt[(size_t)(n0 + r) * s.k + kbase + cc] : 0.f;
                }
                if (pt == 0) mbar_arrive(&full[st]);
            }
            if (gathers) {
                uint32_t* xb = reinterpret_cast<uint32_t*>(stage + L::kWBytes);
                uint32_t* xs = xb + BN * kBK;
#pragma unroll
                for (int q = 0; q < P; ++q) {
                    const int p = p_lo + L::kLanesP * q;
                    const int at = p * kBK + ((c ^ (p & 7)) << 2);
                    uint4 big, small;
                    split_int(cur[q][0], big.x, small.x);
                    split_int(cur[q][1], big.y, small.y);
                    split_int(cur[q][2], big.z, small.z);
                    split_int(cur[q][3], big.w, small.w);
                    *reinterpret_cast<uint4*>(xb + at) = big;
                    *reinterpret_cast<uint4*>(xs + at) = small;
                }
            }
            fence_async_smem();   // the tiles are wgmma's to read
            __syncwarp();
            if (lane == 0) mbar_arrive(&full[st]);
        }
        reduce_and_store<BN, RG>(reinterpret_cast<float*>(smem), bias, out,
                                 s, n0, m0);
    } else {
        // ---- consumers: where RG = 1 warpgroup `group` takes blocks
        // group, group + 2, ...; where RG = 2 it takes every block's rows
        // 64 group .. 64 group + 63
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        const int tid = threadIdx.x % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t = lane & 3;
        // this thread's rows r0 and r0 + 8 of the CTA's tile
        const int r0 = (RG == 2 ? kRows * group : 0) + 16 * warp + g;
        constexpr int kOut = BN / 2;
        float acc[kOut], part[kOut];
#pragma unroll
        for (int q = 0; q < kOut; ++q) acc[q] = part[q] = 0.f;
        constexpr uint32_t kSbo = 8 * kBK * 4;   // 8 rows of 128 bytes
        for (int i = RG == 2 ? 0 : group; i < nk; i += 3 - RG) {
            const int st = i % L::kStages;
            mbar_wait(&full[st], (i / L::kStages) & 1);
            const uint8_t* stage = smem + st * L::kStageBytes;
            const float* ws = reinterpret_cast<const float*>(stage);
            // the A fragments of the block's four 8-deep steps: columns 2t
            // and 2t + 1 of step kk (one 8-byte read) as wgmma's t and t + 4
            uint32_t a_big[4][4], a_small[4][4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const int chunk = ((2 * kk + (t >> 1)) ^ g) << 2;
                const float2 lo = *reinterpret_cast<const float2*>(
                    ws + r0 * kBK + chunk + 2 * (t & 1));
                const float2 hi = *reinterpret_cast<const float2*>(
                    ws + (r0 + 8) * kBK + chunk + 2 * (t & 1));
                split_int(lo.x, a_big[kk][0], a_small[kk][0]);
                split_int(hi.x, a_big[kk][1], a_small[kk][1]);
                split_int(lo.y, a_big[kk][2], a_small[kk][2]);
                split_int(hi.y, a_big[kk][3], a_small[kk][3]);
            }
            const uint32_t xb = smem_u32(stage + L::kWBytes);
            const uint32_t xs = xb + L::kXBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                // 8-deep step kk: 32 bytes into every swizzled row
                const uint64_t db = desc<128>(xb + 32 * kk, 16, kSbo);
                const uint64_t ds = desc<128>(xs + 32 * kk, 16, kSbo);
                wgmma_tf32<BN>(part, a_small[kk], db, kk > 0);
                wgmma_tf32<BN>(part, a_big[kk], ds, 1);
                wgmma_tf32<BN>(part, a_big[kk], db, 1);
            }
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(part);
            fence_regs_u32(a_big);
            fence_regs_u32(a_small);
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
            for (int q = 0; q < kOut; ++q) acc[q] += part[q];
        }
        // both warpgroups are done with the ring: the partial tile goes
        // over it; where RG = 1 warpgroup 0's sums first, then 1's added
        float* cs = reinterpret_cast<float*>(smem);
        fence_async_smem();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        for (int turn = 0; turn < 3 - RG; ++turn) {
            if (RG == 2 || group == turn) {
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    float2* c0 = reinterpret_cast<float2*>(
                        cs + r0 * L::kCPitch + 8 * j + 2 * t);
                    float2* c1 = reinterpret_cast<float2*>(
                        cs + (r0 + 8) * L::kCPitch + 8 * j + 2 * t);
                    if (turn == 0) {
                        *c0 = make_float2(acc[4 * j], acc[4 * j + 1]);
                        *c1 = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
                    } else {
                        const float2 u = *c0, v = *c1;
                        *c0 = make_float2(u.x + acc[4 * j],
                                          u.y + acc[4 * j + 1]);
                        *c1 = make_float2(v.x + acc[4 * j + 2],
                                          v.y + acc[4 * j + 3]);
                    }
                }
            }
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
        }
        reduce_and_store<BN, RG>(cs, bias, out, s, n0, m0);
    }
}

template <int BN, int RG>
int launch(const float* x, const float* w, const float* bias, float* out,
           const ConvShape& s, int splits, int tma_w, cudaStream_t stream) {
    using L = Layout<BN, RG>;
    CUtensorMap w_map = {};
    if (tma_w) {
        const int err =
            encode_f32_map(&w_map, w, s.cout, s.k, L::kRowsCta, kBK);
        if (err != 0) return err;
    }
    static bool attribute_set = false;
    if (!attribute_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            conv2d_splitk_wgmma_kernel<BN, RG>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
        if (e != cudaSuccess) return (int)e;
        attribute_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (s.cout + L::kRowsCta - 1) / L::kRowsCta,
                       (s.m + BN - 1) / BN);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L::kBytes;
    cfg.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, conv2d_splitk_wgmma_kernel<BN, RG>, w_map, x, w, bias, out, s,
        tma_w);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// x (batch, cin, h, w), w (cout, cin, kh, kw), bias (cout) or null, out
// (batch, cout, ho, wo); all f32 and contiguous (the wrapper checks).
// bn (the output pixels of a tile: 8, 16, 32 or 64), rows (its output
// channels: 64, or 128 at bn = 64) and splits are kernels/conv2d.py::
// plan's; tma_w: the weight rows are 16-byte aligned
// (K % 4 == 0 and w 16-byte aligned), so TMA copies them.  Returns the CUDA
// error of the launch, cudaErrorInvalidValue for a shape or plan outside
// what the kernel takes, or kEncodeError (+ libcuda's CUresult) when the
// weight's tensor map cannot be made.
extern "C" int sf_conv2d_splitk(const void* x, const void* w,
                                const void* bias, void* out, int batch,
                                int cin, int h, int width, int cout, int kh,
                                int kw, int sh, int sw, int ph, int pw,
                                int bn, int rows, int splits, int tma_w,
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
    if (rows == 2 * kRows && bn == 64)
        return launch<64, 2>(xf, wf, bf, of, s, splits, tma_w, st);
    if (rows != kRows) return (int)cudaErrorInvalidValue;
    switch (bn) {
        case 8: return launch<8, 1>(xf, wf, bf, of, s, splits, tma_w, st);
        case 16: return launch<16, 1>(xf, wf, bf, of, s, splits, tma_w, st);
        case 32: return launch<32, 1>(xf, wf, bf, of, s, splits, tma_w, st);
        case 64: return launch<64, 1>(xf, wf, bf, of, s, splits, tma_w, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// How many clusters of `splits` CTAs the card runs at once
// (cudaOccupancyMaxActiveClusters) for the instance with the most shared
// memory (every instance holds one CTA an SM), or -1 on an error.
extern "C" int sf_conv2d_splitk_max_clusters(int splits) {
    using L = Layout<64, 2>;
    const auto kernel = conv2d_splitk_wgmma_kernel<64, 2>;
    if (splits < 1 || splits > kMaxSplits ||
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kBytes) != cudaSuccess)
        return -1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L::kBytes;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    int n = -1;
    if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
        return -1;
    return n;
}
