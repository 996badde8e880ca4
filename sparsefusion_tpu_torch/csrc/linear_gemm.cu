// K5: a linear layer's forward, y = x W^T + b, f32 inputs and outputs with
// 3xTF32 products on Hopper's warpgroup tensor-core instructions (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its linears to XLA.  It
// was added for Zero-1-to-3's spatial transformers in the PLMS sampler's
// batch-1 evaluations: the self-attention's four projections, the GEGLU
// projection and the feed-forward's output, 96 GEMMs an evaluation of 16
// to 1024 tokens by 320 to 10,240 features (51.2 GFLOP, 793 MB of f32
// weights), which took ~4 ms an evaluation in cuBLAS's f32 SIMT GEMMs:
// too few output tiles to fill the card, or to pull the weights at the
// memory's rate.
//
// What bounds it: at 64 tokens and fewer the weights' bytes, read once at
// 3.35 TB/s; at 256 and 1024 the operations, at 165 TFLOP/s for three
// TF32 products a product (67 TFLOP/s is the f32 rate outside the tensor
// cores).  PERF.md, section 6, has its times against both.
//
// Design (K4's pipeline, csrc/conv2d_splitk.cu, without its gather):
// * GEMM, roles swapped for wgmma.  y[t, n] = sum_k W[n, k] x[t, k] +
//   b[n], n = the output features on wgmma's 64 rows, t = the tokens on its
//   N (8-64 columns).  W as stored, [N, K] with K contiguous, is the
//   K-major A that wgmma takes for TF32; x as it lies, [T, K] with K
//   contiguous, is the K-major B.  No copy, transpose or pre-split of
//   either.
// * CTA.  384 threads: two consumer warpgroups and one producer warpgroup,
//   over a ring of stages in shared memory (up to 16; one CTA an SM).  An
//   output tile is 64 RG features by BN tokens (BN = 8, 16, 32 or 64, RG
//   = 1, or 2 at BN = 64, by the plan).  The producer's first warp copies each 32-wide
//   K block's weight tile and token tile by TMA (2-D tensor maps over
//   [N, K] and [T, K], 128-byte swizzle, zeros past the edges; one
//   mbarrier counts both tiles' bytes), as far ahead as the ring has room.
//   Its other three warps take the blocks in turn and split each token
//   tile once, in shared memory, into its two TF32 halves: the big half in
//   place, the small half beside it, the k order permuted to the one the
//   consumers read the weights in.  Where RG = 1 the consumer warpgroups
//   take the blocks in turn; where RG = 2 each takes 64 of the 128
//   features of every block, so that one token tile serves both.
// * Products, as K4's.  Per block a consumer warpgroup reads its 64 x 32
//   weight tile into registers, splits it and issues, per 8-deep step,
//   wgmma.m64nBNk8 three times: a_small b_big, a_big b_small, a_big b_big.
//   Each block's first product starts a fresh partial, added to the f32
//   accumulator once the block completes: the tensor cores' accumulation
//   rounds toward zero.
// * Split K over a thread-block cluster, clusters that stay.
//   kernels/linear.py::plan picks BN, RG, S <= 8 splits and C clusters of
//   S CTAs, no more than the card runs at once, so every CTA is resident;
//   cluster c takes output tiles c, c + C, ... in turn, each CTA the same
//   share of K blocks of each, and the producer runs on into the next tile
//   while the consumers finish one.  A finished tile's partial goes,
//   token by token, into shared memory beside the ring; the CTAs of the
//   cluster signal one another through mbarriers (ready: every partial is
//   parked; freed: every CTA has read this one), and CTA r sums an r-th of
//   the tile, four features at a time, over the S partials through
//   distributed shared memory in rank order 0..S-1, adds the bias and
//   stores y along N.  No float atomics (two launches give the same bits)
//   and no device-memory workspace.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;           // a consumer warpgroup's features (M)
constexpr int kBK = 32;             // a K block: one 128-byte tile row
constexpr int kMaxSplits = 8;
constexpr int kThreads = 384;       // two consumer groups, one producer
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxStages = 16;

struct GemmShape {
    int t, n, k;   // tokens, output features, input features
};

// Shared memory, from a 1024-byte boundary (the swizzle's period): the
// ring of stages, each the weight tile [64 RG][32] and the token tile's
// big and small halves [BN][32], all rows 128 bytes and swizzled; the
// partial tile [BN][64 RG + 4], token by token; then each stage's loaded,
// full and empty mbarriers and the cluster's ready and freed ones.
template <int BN, int RG>
struct Layout {
    static constexpr int kRowsCta = kRows * RG;
    static constexpr int kWBytes = kRowsCta * kBK * 4;
    static constexpr int kXBytes = BN * kBK * 4;
    static constexpr int kStageBytes = kWBytes + 2 * kXBytes;
    static constexpr int kCPitch = kRowsCta + 4;   // the partial tile's rows
    static constexpr int kCBytes = (BN * kCPitch * 4 + 1023) / 1024 * 1024;
    static constexpr int kFree = kSmemLimit - 1024 - kCBytes
                                 - 24 * kMaxStages - 16;
    static constexpr int kStages = kFree / kStageBytes < kMaxStages
                                       ? kFree / kStageBytes : kMaxStages;
    static constexpr int kCOffset = kStages * kStageBytes;
    static constexpr int kBarOffset = kCOffset + kCBytes;
    static constexpr int kBytes = kBarOffset + 24 * kStages + 16 + 1024;
    static_assert(kStages >= 3, "a ring of three stages at least");
};

// mbarrier waits with cluster scope (the arrivals come from the cluster's
// other CTAs), polled with test_wait, and an arrival on CTA `rank`'s copy
// of a barrier
__device__ __forceinline__ bool mbar_try_cluster(uint64_t* bar,
                                                 uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 "
        "p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return done != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
    long long t0 = 0;
    while (!mbar_try_cluster(bar, parity)) {
        if (t0 == 0) t0 = clock64();
        else if (clock64() - t0 > (1ll << 34)) __trap();
    }
}

__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(smem_u32(bar)), "r"(rank));
    asm volatile(
        "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n"
        :: "r"(remote) : "memory");
}

// One arrival on each CTA's copy of `bar`, after a fence that orders this
// CTA's reads and writes of partials (the consumers', ordered before it
// by a CTA barrier) before them: one cluster fence and relaxed arrivals
// (a release on each arrival cost ~3 us a tile at 5 splits on an H100)
__device__ __forceinline__ void signal_cluster(uint64_t* bar, int splits) {
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    for (int q = 0; q < splits; ++q) mbar_arrive_remote(bar, q);
}

// The cluster barrier in two halves: every thread arrives once the CTA's
// mbarriers are set, and waits before its first arrival on another CTA's
// (or before it exits), so the ~1,600 clocks it takes run under the
// first tile's work
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The consumers' share of one output tile once every CTA of the cluster
// has parked its partial: an r-th of the tile, four features at a time,
// summed over the S partials in rank order (all S reads in flight at
// once), plus the bias, stored along N.
template <int BN, int RG>
__device__ __forceinline__ void reduce_tile(
        float* cs, const float* __restrict__ bias, float* __restrict__ y,
        const GemmShape& s, int n0, int t0, int rank, int splits, int ctid) {
    using L = Layout<BN, RG>;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int kQ = L::kRowsCta / 4;
    constexpr int kE = BN * kQ;
    const int e0 = rank * kE / splits;
    const int e1 = (rank + 1) * kE / splits;
    for (int e = e0 + ctid; e < e1; e += 256) {
        const int m = e / kQ, n = 4 * (e % kQ);
        float* at = cs + m * L::kCPitch + n;
        float4 part[kMaxSplits];
#pragma unroll
        for (int q = 0; q < kMaxSplits; ++q)
            if (q < splits)
                part[q] = *reinterpret_cast<const float4*>(
                    splits == 1 ? at : cluster.map_shared_rank(at, q));
        float4 v = part[0];
#pragma unroll
        for (int q = 1; q < kMaxSplits; ++q)
            if (q < splits) {
                v.x += part[q].x;
                v.y += part[q].y;
                v.z += part[q].z;
                v.w += part[q].w;
            }
        const int gt = t0 + m, gn = n0 + n;
        if (gt >= s.t || gn >= s.n) continue;
        float* row = y + (size_t)gt * s.n + gn;
        float vals[4] = {v.x, v.y, v.z, v.w};
        if (bias != nullptr) {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (gn + u < s.n) vals[u] += __ldg(bias + gn + u);
        }
        if (s.n % 4 == 0) {   // y's rows are 16-byte aligned
            *reinterpret_cast<float4*>(row) =
                make_float4(vals[0], vals[1], vals[2], vals[3]);
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
                if (gn + u < s.n) row[u] = vals[u];
        }
    }
}

template <int BN, int RG>
__global__ void __launch_bounds__(kThreads, 1)
linear_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const float* __restrict__ bias,
                         float* __restrict__ y, GemmShape s) {
    using L = Layout<BN, RG>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    float* cs = reinterpret_cast<float*>(smem + L::kCOffset);
    // loaded: both tiles' bytes have landed; full: the token tile is split;
    // empty: the block's products are done; ready: every CTA of the
    // cluster has parked its partial of the tile; freed: every CTA has
    // read this CTA's partial
    uint64_t* loaded = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
    uint64_t* full = loaded + L::kStages;
    uint64_t* empty = full + L::kStages;
    uint64_t* ready = empty + L::kStages;
    uint64_t* freed = ready + 1;

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int splits = gridDim.x;     // the cluster is (splits, 1, 1)
    const int clusters = gridDim.y;
    // the output tiles, token tiles fastest, taken by the clusters in
    // turn: this cluster's u-th is tile blockIdx.y + u * clusters
    const int tiles_t = (s.t + BN - 1) / BN;
    const int tiles = (s.n + L::kRowsCta - 1) / L::kRowsCta * tiles_t;
    const int n_tiles = (tiles - (int)blockIdx.y + clusters - 1) / clusters;
    // this split's K blocks, the same in every tile
    const int kblocks = (s.k + kBK - 1) / kBK;
    const int kb0 = (int)((long long)rank * kblocks / splits);
    const int nk = (int)((long long)(rank + 1) * kblocks / splits) - kb0;
    auto tile_origin = [&](int u, int& n0, int& t0) {
        const int tile = (int)blockIdx.y + u * clusters;
        n0 = tile / tiles_t * L::kRowsCta;
        t0 = tile % tiles_t * BN;
    };

    if (threadIdx.x == 0) {
        // the tensor maps' first reads start now, under the set-up
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&w_map)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&x_map)) : "memory");
        for (int st = 0; st < L::kStages; ++st) {
            mbar_init(&loaded[st], 1);      // the copies' arrival and bytes
            mbar_init(&full[st], 1);        // the splitting warp
            mbar_init(&empty[st], 4 * RG);  // the consuming warps
        }
        mbar_init(ready, splits);   // one arrival from each CTA
        mbar_init(freed, splits);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    cluster_arrive();   // this CTA's barriers are set

    const int group = threadIdx.x / 128;
    if (group == 2) {
        // ---- producer: warp 0 copies, warps 1-3 split; both walk every
        // block of every tile of this CTA, as far ahead as the ring allows
        const int pt = threadIdx.x % 128;
        const int lane = pt % 32;
        if (pt < 32) {
            if (lane == 0) {
                for (int u = 0, j = 0; u < n_tiles; ++u) {
                    int n0, t0;
                    tile_origin(u, n0, t0);
                    for (int i = 0; i < nk; ++i, ++j) {
                        const int st = j % L::kStages;
                        if (j >= L::kStages)   // block j - kStages is done
                            mbar_wait(&empty[st], (j / L::kStages - 1) & 1);
                        uint8_t* stage = smem + st * L::kStageBytes;
                        mbar_expect_tx(&loaded[st],
                                       L::kWBytes + L::kXBytes);
                        tma_load_2d(stage, &w_map, &loaded[st],
                                    (kb0 + i) * kBK, n0);
                        tma_load_2d(stage + L::kWBytes, &x_map, &loaded[st],
                                    (kb0 + i) * kBK, t0);
                    }
                }
            }
            __syncwarp();
        } else {
            // warp sw = 0..2 splits blocks sw, sw + 3, ...: each (token row
            // p, 8-deep step kk) pair's raw chunks 2 kk and 2 kk + 1 (k =
            // 8 kk + 0..3, + 4..7) become the chunks the consumers read as
            // wgmma's k = 0..3 and 4..7: k = 8 kk + 0, 2, 4, 6 and 8 kk + 1,
            // 3, 5, 7 (they read the weight tile's columns 2 t and 2 t + 1
            // as wgmma's t and t + 4)
            const int sw = pt / 32 - 1;
            for (int j = sw; j < n_tiles * nk; j += 3) {
                const int st = j % L::kStages;
                mbar_wait(&loaded[st], (j / L::kStages) & 1);
                uint8_t* stage = smem + st * L::kStageBytes;
                uint32_t* xb = reinterpret_cast<uint32_t*>(stage + L::kWBytes);
                uint32_t* xs = xb + BN * kBK;
                // every load first: the split is in place, so a store
                // would otherwise hold back the next pair's loads
                constexpr int kPairs = BN / 8;   // a lane's (p, kk) pairs
                float4 r0[kPairs], r1[kPairs];
                int c0[kPairs], c1[kPairs];
#pragma unroll
                for (int m = 0; m < kPairs; ++m) {
                    const int e = lane + 32 * m;
                    const int p = e / 4, kk = e % 4;
                    c0[m] = p * kBK + (((2 * kk) ^ (p & 7)) << 2);
                    c1[m] = p * kBK + (((2 * kk + 1) ^ (p & 7)) << 2);
                    r0[m] = *reinterpret_cast<const float4*>(xb + c0[m]);
                    r1[m] = *reinterpret_cast<const float4*>(xb + c1[m]);
                }
#pragma unroll
                for (int m = 0; m < kPairs; ++m) {
                    uint4 b0, s0, b1, s1;
                    split_int(r0[m].x, b0.x, s0.x);
                    split_int(r0[m].z, b0.y, s0.y);
                    split_int(r1[m].x, b0.z, s0.z);
                    split_int(r1[m].z, b0.w, s0.w);
                    split_int(r0[m].y, b1.x, s1.x);
                    split_int(r0[m].w, b1.y, s1.y);
                    split_int(r1[m].y, b1.z, s1.z);
                    split_int(r1[m].w, b1.w, s1.w);
                    *reinterpret_cast<uint4*>(xb + c0[m]) = b0;
                    *reinterpret_cast<uint4*>(xb + c1[m]) = b1;
                    *reinterpret_cast<uint4*>(xs + c0[m]) = s0;
                    *reinterpret_cast<uint4*>(xs + c1[m]) = s1;
                }
                fence_async_smem();   // the halves are wgmma's to read
                __syncwarp();
                if (lane == 0) mbar_arrive(&full[st]);
            }
        }
        cluster_wait();
    } else {
        // ---- consumers: where RG = 1 warpgroup `group` takes each tile's
        // blocks group, group + 2, ...; where RG = 2 it takes every block's
        // rows 64 group .. 64 group + 63
        const int ctid = threadIdx.x;   // 0..255
        const int tid = ctid % 128;
        const int warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, t = lane & 3;
        // this thread's rows r0 and r0 + 8 of the CTA's tile
        const int r0 = (RG == 2 ? kRows * group : 0) + 16 * warp + g;
        constexpr int kOut = BN / 2;
        constexpr uint32_t kSbo = 8 * kBK * 4;   // 8 rows of 128 bytes
        float acc[kOut], part[kOut];
#pragma unroll
        for (int q = 0; q < kOut; ++q) acc[q] = part[q] = 0.f;
        for (int u = 0; u < n_tiles; ++u) {
            for (int i = RG == 2 ? 0 : group; i < nk; i += 3 - RG) {
                const int j = u * nk + i;
                const int st = j % L::kStages;
                const uint32_t parity = (j / L::kStages) & 1;
                // both waits before the fragments are read: a wait between
                // their loads and the products makes ptxas serialise the wgmmas
                mbar_wait(&loaded[st], parity);
                mbar_wait(&full[st], parity);
                const uint8_t* stage = smem + st * L::kStageBytes;
                const float* ws = reinterpret_cast<const float*>(stage);
                // the A fragments of the block's four 8-deep steps: columns
                // 2t and 2t + 1 of step kk (one 8-byte read) as wgmma's t
                // and t + 4
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
            // the tile's partial, token by token, once every CTA has read the
            // last one (with one split the CTA barrier after the last
            // reduction says so); where RG = 1 warpgroup 0's sums first,
            // then 1's added
            if (u == 0) cluster_wait();
            else if (splits > 1) mbar_wait_cluster(freed, (u - 1) & 1);
            for (int turn = 0; turn < 3 - RG; ++turn) {
                if (RG == 2 || group == turn) {
#pragma unroll
                    for (int jj = 0; jj < BN / 8; ++jj) {
                        float* c0 = cs + (8 * jj + 2 * t) * L::kCPitch + r0;
                        float* c1 = c0 + L::kCPitch;
                        if (turn == 0) {
                            c0[0] = acc[4 * jj];
                            c1[0] = acc[4 * jj + 1];
                            c0[8] = acc[4 * jj + 2];
                            c1[8] = acc[4 * jj + 3];
                        } else {
                            c0[0] += acc[4 * jj];
                            c1[0] += acc[4 * jj + 1];
                            c0[8] += acc[4 * jj + 2];
                            c1[8] += acc[4 * jj + 3];
                        }
                    }
                }
                asm volatile("bar.sync 1, 256;\n" ::: "memory");
            }
#pragma unroll
            for (int q = 0; q < kOut; ++q) acc[q] = 0.f;
            if (splits > 1) {   // this partial is the cluster's to read
                if (ctid == 0) signal_cluster(ready, splits);
                mbar_wait_cluster(ready, u & 1);
            }
            int n0, t0;
            tile_origin(u, n0, t0);
            reduce_tile<BN, RG>(cs, bias, y, s, n0, t0, rank, splits, ctid);
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
            if (splits > 1 && ctid == 0)   // done with every CTA's partial
                signal_cluster(freed, splits);
        }
        // no CTA leaves while another reads its partial
        if (n_tiles == 0) cluster_wait();
        else if (splits > 1) mbar_wait_cluster(freed, (n_tiles - 1) & 1);
    }
}

template <int BN, int RG>
int launch(const float* x, const float* w, const float* bias, float* y,
           const GemmShape& s, int splits, int clusters, cudaStream_t stream) {
    using L = Layout<BN, RG>;
    const long long tiles = (long long)((s.n + L::kRowsCta - 1) / L::kRowsCta)
                            * ((s.t + BN - 1) / BN);
    if (clusters < 1 || clusters > tiles || clusters > 65535)
        return (int)cudaErrorInvalidValue;
    CUtensorMap w_map = {}, x_map = {};
    int err = encode_f32_map(&w_map, w, s.n, s.k, L::kRowsCta, kBK);
    if (err == 0) err = encode_f32_map(&x_map, x, s.t, s.k, BN, kBK);
    if (err != 0) return err;
    static bool attribute_set = false;
    if (!attribute_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            linear_gemm_wgmma_kernel<BN, RG>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
        if (e != cudaSuccess) return (int)e;
        attribute_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, clusters, 1);
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
        &cfg, linear_gemm_wgmma_kernel<BN, RG>, w_map, x_map, bias, y, s);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// x (t, k), w (n, k), bias (n) or null, y (t, n); all f32 and contiguous,
// x and w 16-byte aligned (the wrapper sees to it), k % 4 == 0 (TMA's
// 16-byte rows).  bn (the tokens of a tile: 8, 16, 32 or 64), rows (its
// output features: 64, or 128 at 64 tokens), splits (at most K's 32-wide blocks) and
// clusters (at most the output tiles; all of them on the card at once)
// are kernels/linear.py::plan's.  Returns the CUDA error of the launch,
// cudaErrorInvalidValue for a shape or plan outside what the kernel
// takes, or kEncodeError (+ libcuda's CUresult) when a tensor map cannot
// be made.
extern "C" int sf_linear_gemm(const void* x, const void* w, const void* bias,
                              void* y, int t, int n, int k, int bn, int rows,
                              int splits, int clusters, void* stream) {
    if (t <= 0 || n <= 0 || k <= 0 || k % 4 != 0 || splits < 1 ||
        splits > kMaxSplits || splits > (k + kBK - 1) / kBK ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    GemmShape s;
    s.t = t; s.n = n; s.k = k;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(bias);
    float* yf = static_cast<float*>(y);
    const int c = clusters;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (rows == kRows) {
        switch (bn) {
            case 8: return launch<8, 1>(xf, wf, bf, yf, s, splits, c, st);
            case 16: return launch<16, 1>(xf, wf, bf, yf, s, splits, c, st);
            case 32: return launch<32, 1>(xf, wf, bf, yf, s, splits, c, st);
            case 64: return launch<64, 1>(xf, wf, bf, yf, s, splits, c, st);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    if (rows == 2 * kRows && bn == 64)
        return launch<64, 2>(xf, wf, bf, yf, s, splits, c, st);
    return (int)cudaErrorInvalidValue;
}
