// Fused multi-resolution grid encode for Hopper (sm_90a): forward and
// table-gradient backward over the master table.
//
// Replaces the TPU kernel sparsefusion_tpu/kernels/grid_gather.py::
// vmem_row_gather (the VMEM row gather behind NGPConfig.pallas_gather,
// reached from ops/grid_encode_blocked.py) together with its XLA
// scatter-add adjoint (_gather_bwd).  On the TPU the lookup was recast as
// one gathered row of a pre-expanded "blocked" table per (point, level),
// because TPU gathers are row-count bound.  On Hopper the whole master
// table fits in L2 (NGPConfig(): 929,336 x 2 f32 = 7.4 MB; 8 x C4:
// 463,672 x 4 = 7.4 MB, of a 50 MB L2), so the kernel reads the 8
// corners of each (point, level) straight from the master table and no
// expanded copy is built.
//
// Forward: the bytes it must move (points, table, encodings: 37.6 MB for
// 262,144 points at 16 x C2) take 0.013 ms at 3.35 TB/s; what bounds it
// is the gather, 8 row reads per (point, level) from L2 and L1, each at
// least one 32-byte sector, and the L1 wavefronts of warp-wide loads
// whose lanes read different rows.  Design: one thread per point,
// consecutive points in a warp, the levels walked in turn with the level
// uniform over the warp, so a warp holds 32 consecutive points (samples
// of one ray) at one level.  On the coarse levels their corners fall on
// the same or neighbouring rows, served in a few sectors; the per-level
// constants are broadcast reads; the point is loaded and box-tested once.
// Each corner row is one vector load (8 bytes for C2 f32 or C4 bf16, 16
// for C4 f32 or C8 bf16), and a level's 8 loads are issued before they
// are summed.  The index is reduced to the level by a mask chosen on the
// host (make_levels): all ones where no corner of a point in the box can
// pass the level's size, size - 1 where the size is a power of two, which
// covers every level of make_grid_encoding; a general modulo only for any
// other level.  The encodings leave in 32-byte chunks of the point's row
// (4 levels at C2), kept in registers until full and written as two
// 16-byte stores, so every store fills whole sectors; no shared memory is
// used, which leaves the SM's L1 to the table's rows.  (Measured on an
// H100, staging a block's rows in shared memory for coalesced stores was
// slower, as was loading more levels at once by hand: the unrolled chunk
// already lets the compiler overlap its levels' loads.)
//
// Backward (table gradient): bound by L2 atomics, and above all by their
// contention.  The renderer hands the points over ray by ray, samples
// fastest, so neighbouring points sit in the same cells of the coarse
// levels and their updates land on the same rows, which the L2 can only
// apply one after another.  Design: a block takes a tile of consecutive
// points for all levels, level by level, so a warp holds 32 consecutive
// points (samples of one ray) at one level.  The tile's grad_out rows are
// staged in shared memory with 16-byte loads.  For each corner, runs of lanes that hit the same row are summed
// first by a segmented scan over the warp (__shfl_up_sync), and only the
// last lane of a run issues the run's update, as one vector atomic
// (float2 / float4, sm_90) per row instead of C scalar ones.  Each warp
// starts its walk over the levels at another level, so the few hot rows
// of the coarse levels are not hit by every warp of the grid at the same
// moment.  What is left is one atomic per distinct row a warp touches,
// and the contention between warps on the coarse levels' rows; the order
// of the f32 sums still changes from run to run (a segment sum over
// sorted rows would be deterministic).  Points outside the unit box add
// nothing.
//
// Scene axis (the port of jax.vmap over the encode in the scene-batched
// loop, distill/batched.py): both kernels take S scenes of one encoding
// in one launch, blockIdx.y the scene.  Scene s's points, table,
// encodings and gradient sit at s times their per-scene sizes; the level
// table is shared; the backward's atomics land only in the scene's own
// (T, C) slice.  The scene offsets are a template flag (kScenes): S = 1
// launches the single-scene instance, the same code as before the axis.
// Four scenes' NGPConfig() tables (29.7 MB) still fit the L2 together.
//
// Semantics are those of ops/grid_encode.py (the plain version):
//   pos = x * scale + 0.5; corner = floor(pos) + bit; frac = pos - floor
//   index = stride-dot (dropped axis: stride 0) or prime-xor hash, uint32
//   row = index % level_size + level_offset; out zero outside [0,1]^3.
// The position math avoids FMA contraction (__fmul_rn / __fadd_rn): a
// fused multiply-add changes floor(pos) at cell edges and would pick a
// different corner than the CPU does.  For a bf16 table the trilinear
// weight is rounded to bf16 and the product taken in f32, as the JAX
// blocked path does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SF_MAX_LEVELS 32

// How make_levels reduces a level's uint32 index to its size.
enum Reduction { kIdentity = 0, kMask = 1, kModulo = 2 };

struct LevelTable {
    uint32_t offsets[SF_MAX_LEVELS];
    uint32_t sizes[SF_MAX_LEVELS];
    uint32_t masks[SF_MAX_LEVELS];  // row index: index & mask, or
    int use_mod[SF_MAX_LEVELS];     // index % size where use_mod is set
    float scales[SF_MAX_LEVELS];
    uint32_t strides[SF_MAX_LEVELS][3];
    int use_hash[SF_MAX_LEVELS];
    uint32_t rows;                  // of one scene's table: offsets[L]
};

// Corner k of a (point, level): its table row and trilinear weight.
struct Cell {
    uint32_t pg[3];
    float frac[3];
};

__device__ __forceinline__ void make_cell(const float (&p)[3], float scale,
                                          Cell& cell) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        float pos = __fadd_rn(__fmul_rn(p[d], scale), 0.5f);
        float fl = floorf(pos);
        cell.frac[d] = __fsub_rn(pos, fl);
        // saturates (NaN -> 0): a corner never leaves [0, 2^32)
        cell.pg[d] = __float2uint_rz(fl);
    }
}

template <bool kBf16Weight>
__device__ __forceinline__ void corner(const Cell& cell, int k,
                                       const LevelTable& lt, int l,
                                       uint32_t& row, float& w) {
    uint32_t c[3];
    float wd[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        uint32_t bit = (k >> d) & 1u;
        c[d] = cell.pg[d] + bit;
        wd[d] = bit ? cell.frac[d] : __fsub_rn(1.0f, cell.frac[d]);
    }
    w = __fmul_rn(__fmul_rn(wd[0], wd[1]), wd[2]);
    if (kBf16Weight) w = __bfloat162float(__float2bfloat16_rn(w));
    uint32_t idx;
    if (lt.use_hash[l]) {
        idx = c[0] ^ (c[1] * 2654435761u) ^ (c[2] * 805459861u);
    } else {
        idx = c[0] * lt.strides[l][0] + c[1] * lt.strides[l][1]
            + c[2] * lt.strides[l][2];
    }
    idx = lt.use_mod[l] ? idx % lt.sizes[l] : idx & lt.masks[l];
    row = idx + lt.offsets[l];
}

// Point n into p, read once; false (p untouched) outside the unit box.
// NaN counts as inside, as in the plain version.
__device__ __forceinline__ bool load_point(const float* __restrict__ x,
                                           long long n, float (&p)[3]) {
    const float a = x[n * 3], b = x[n * 3 + 1], c = x[n * 3 + 2];
    if (a < 0.f || a > 1.f || b < 0.f || b > 1.f || c < 0.f || c > 1.f)
        return false;
    p[0] = a;
    p[1] = b;
    p[2] = c;
    return true;
}

// One row of C channels as f32, in one vector load where the row is at
// most 16 bytes (two for C8 f32).
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ t,
                                         uint32_t row, float (&v)[C]) {
    const float* r = t + (size_t)row * C;
    if constexpr (C == 1) {
        v[0] = __ldg(r);
    } else if constexpr (C == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(r));
        v[0] = a.x;
        v[1] = a.y;
    } else {
#pragma unroll
        for (int c = 0; c < C; c += 4) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(r + c));
            v[c] = a.x;
            v[c + 1] = a.y;
            v[c + 2] = a.z;
            v[c + 3] = a.w;
        }
    }
}

// Two bf16 packed in a word, as f32 (exact: bf16 is the top half of f32).
__device__ __forceinline__ void unpack_bf16x2(uint32_t u, float& lo,
                                              float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
}

template <int C>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ t,
                                         uint32_t row, float (&v)[C]) {
    const __nv_bfloat16* r = t + (size_t)row * C;
    if constexpr (C == 1) {
        v[0] = __uint_as_float(
            (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(r)) << 16);
    } else if constexpr (C == 2) {
        unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(r)), v[0],
                      v[1]);
    } else if constexpr (C == 4) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(r));
        unpack_bf16x2(a.x, v[0], v[1]);
        unpack_bf16x2(a.y, v[2], v[3]);
    } else {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(r));
        unpack_bf16x2(a.x, v[0], v[1]);
        unpack_bf16x2(a.y, v[2], v[3]);
        unpack_bf16x2(a.z, v[4], v[5]);
        unpack_bf16x2(a.w, v[6], v[7]);
    }
}

// One thread per point, consecutive points in a warp, every level in
// turn.  The encodings go out in chunks of G = 8 / C levels, 8 floats
// (one 32-byte sector) of the point's row, kept in registers until the
// chunk is full.  The chunk's levels are unrolled, so the compiler can
// put the loads of several levels in flight at once.  A chunk past the
// last level repeats the last level's reads and drops them.
template <int C, typename T, bool kScenes>
__global__ void __launch_bounds__(256)
grid_encode_fwd_kernel(const float* __restrict__ x,
                       const T* __restrict__ table, float* __restrict__ out,
                       long long n_points, int L,
                       const __grid_constant__ LevelTable lt) {
    constexpr bool kBf16 = sizeof(T) == 2;
    constexpr int G = 8 / C;
    const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= n_points) return;
    const int lc = L * C;
    if constexpr (kScenes) {    // this block's scene
        x += blockIdx.y * n_points * 3;
        table += (size_t)blockIdx.y * lt.rows * C;
        out += blockIdx.y * n_points * lc;
    }
    float p[3] = {0.f, 0.f, 0.f};
    const bool live = load_point(x, n, p);
    float* op = out + n * lc;
    // 16-byte stores where every row of out starts 16-byte aligned
    const bool vec = ((reinterpret_cast<uintptr_t>(out) | (lc * 4)) & 15) == 0;
    for (int l0 = 0; l0 < L; l0 += G) {
        float chunk[8];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const int l = min(l0 + j, L - 1);
            Cell cell;
            make_cell(p, lt.scales[l], cell);
            uint32_t row[8];
            float w[8];
            float v[8][C];
#pragma unroll
            for (int k = 0; k < 8; ++k)
                corner<kBf16>(cell, k, lt, l, row[k], w[k]);
            // all 8 loads issued before the first sum
#pragma unroll
            for (int k = 0; k < 8; ++k) load_row<C>(table, row[k], v[k]);
            float acc[C];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k)
#pragma unroll
                for (int c = 0; c < C; ++c) acc[c] += w[k] * v[k][c];
#pragma unroll
            for (int c = 0; c < C; ++c) chunk[j * C + c] = live ? acc[c] : 0.f;
        }
        const int nf = min(G, L - l0) * C;      // floats of this chunk
        float* dst = op + l0 * C;
        if (vec) {
#pragma unroll
            for (int q = 0; q < 8; q += 4)
                if (q < nf)
                    *reinterpret_cast<float4*>(dst + q) = make_float4(
                        chunk[q], chunk[q + 1], chunk[q + 2], chunk[q + 3]);
        } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
                if (q < nf) dst[q] = chunk[q];
        }
    }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoRow = 0xffffffffu;  // a lane with nothing to add

// One row's update: a vector atomic where sm_90 has one.
template <int C>
__device__ __forceinline__ void atomic_add_row(float* dst,
                                               const float (&v)[C]) {
    if constexpr (C == 1) {
        atomicAdd(dst, v[0]);
    } else if constexpr (C == 2) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    } else {
#pragma unroll
        for (int c = 0; c < C; c += 4)
            atomicAdd(reinterpret_cast<float4*>(dst + c),
                      make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]));
    }
}

// Adds each lane's v to grad_table row `row`, merging runs of adjacent
// lanes with the same row first: a segmented inclusive scan, then one
// atomic from the last lane of each run.  All 32 lanes take part.
template <int C>
__device__ __forceinline__ void warp_merged_add(float* __restrict__ grad_table,
                                                uint32_t row, float (&v)[C],
                                                int lane) {
    const uint32_t left = __shfl_up_sync(kFull, row, 1);
    const unsigned heads = __ballot_sync(kFull, lane == 0 || row != left);
    if (heads != kFull) {
        // first lane of this lane's run: the highest head at or below it
        const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
        for (int off = 1; off < 32; off <<= 1) {
            const bool take = lane - off >= start;
            if (!__any_sync(kFull, take)) break;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float u = __shfl_up_sync(kFull, v[c], off);
                if (take) v[c] += u;
            }
        }
    }
    const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
    if (last && row != kNoRow)
        atomic_add_row<C>(grad_table + (size_t)row * C, v);
}

// Block: blockDim.x consecutive points, all levels; thread i owns point
// i of the tile at every level, so a warp holds 32 consecutive points at
// one level.  Dynamic shared memory: the tile's grad_out rows at a pitch
// of L*C + 1 floats (odd, so a warp's reads of one level are conflict
// free).
template <int C, bool kBf16, bool kScenes>
__global__ void grid_encode_bwd_kernel(const float* __restrict__ x,
                                       const float* __restrict__ grad_out,
                                       float* __restrict__ grad_table,
                                       long long n_points, int L,
                                       const __grid_constant__ LevelTable lt) {
    extern __shared__ float g_tile[];
    const int lc = L * C;
    const int pitch = lc + 1;
    const long long p0 = (long long)blockIdx.x * blockDim.x;
    if constexpr (kScenes) {    // this block's scene
        x += blockIdx.y * n_points * 3;
        grad_out += blockIdx.y * n_points * lc;
        grad_table += (size_t)blockIdx.y * lt.rows * C;
    }
    const int np = (int)min((long long)blockDim.x, n_points - p0);

    // stage grad_out[p0 : p0 + np] (np * lc contiguous floats)
    const float* src = grad_out + p0 * lc;
    const int total = np * lc;
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    for (int i = 4 * threadIdx.x; i < total; i += 4 * blockDim.x) {
        float g4[4];
        if (vec && i + 4 <= total) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(src + i));
            g4[0] = t.x; g4[1] = t.y; g4[2] = t.z; g4[3] = t.w;
        } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
                g4[e] = i + e < total ? __ldg(src + i + e) : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            if (i + e < total) {
                const int p = (i + e) / lc;
                g_tile[p * pitch + (i + e - p * lc)] = g4[e];
            }
        }
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    float p[3] = {0.f, 0.f, 0.f};
    const bool live = threadIdx.x < np && load_point(x, p0 + threadIdx.x, p);
    const float* gp = g_tile + threadIdx.x * pitch;

    // each warp starts at another level, so the few hot rows of the
    // coarse levels are not all hit by every warp at once
    const int l0 = (int)((blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))
                         % L);
    for (int i = 0; i < L; ++i) {
        const int l = l0 + i < L ? l0 + i : l0 + i - L;
        float g[C];
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] = live ? gp[l * C + c] : 0.f;
        Cell cell;
        make_cell(p, lt.scales[l], cell);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            uint32_t row;
            float w;
            corner<kBf16>(cell, k, lt, l, row, w);
            float v[C];
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = w * g[c];
            warp_merged_add<C>(grad_table, live ? row : kNoRow, v, lane);
        }
    }
}

// The level table, with each level's index reduction: the identity (a
// mask of all ones) where the largest index a point in the box reaches
// is below the level's size, the mask size - 1 where the size is a power
// of two, else a modulo.  kernels/grid_encode.py::level_plan mirrors it.
static int make_levels(int L, const long long* offsets, const float* scales,
                       const uint32_t* strides, const int* use_hash,
                       LevelTable* lt, int* reductions) {
    if (L < 1 || L > SF_MAX_LEVELS) return (int)cudaErrorInvalidValue;
    lt->rows = (uint32_t)offsets[L];
    for (int l = 0; l < L; ++l) {
        const uint32_t size = (uint32_t)(offsets[l + 1] - offsets[l]);
        lt->offsets[l] = (uint32_t)offsets[l];
        lt->sizes[l] = size;
        lt->scales[l] = scales[l];
        unsigned long long stride_sum = 0;
        for (int d = 0; d < 3; ++d) {
            lt->strides[l][d] = strides[l * 3 + d];
            stride_sum += strides[l * 3 + d];
        }
        lt->use_hash[l] = use_hash[l];
        // a tiled index peaks at the far corner of the cell of x = 1 on
        // every axis: floor(1 * scale + 0.5) + 1 (the kernel's f32 math)
        unsigned long long max_index = 0xffffffffull;
        if (!use_hash[l]) {
            const float pos = scales[l] + 0.5f;
            max_index = ((unsigned long long)floorf(pos) + 1) * stride_sum;
        }
        int r = kModulo;
        if (max_index < size) r = kIdentity;
        else if ((size & (size - 1)) == 0) r = kMask;
        lt->masks[l] = r == kMask ? size - 1 : 0xffffffffu;
        lt->use_mod[l] = r == kModulo;
        if (reductions) reductions[l] = r;
    }
    return 0;
}

static const int kThreads = 256;

template <int C>
static void launch_fwd(const float* x, const void* table, int bf16,
                       float* out, long long n, int scenes, int L,
                       const LevelTable& lt, cudaStream_t s) {
    const dim3 blocks((unsigned)((n + kThreads - 1) / kThreads), scenes);
    if (bf16 && scenes > 1)
        grid_encode_fwd_kernel<C, __nv_bfloat16, true>
            <<<blocks, kThreads, 0, s>>>(x, (const __nv_bfloat16*)table,
                                         out, n, L, lt);
    else if (bf16)
        grid_encode_fwd_kernel<C, __nv_bfloat16, false>
            <<<blocks, kThreads, 0, s>>>(x, (const __nv_bfloat16*)table,
                                         out, n, L, lt);
    else if (scenes > 1)
        grid_encode_fwd_kernel<C, float, true><<<blocks, kThreads, 0, s>>>(
            x, (const float*)table, out, n, L, lt);
    else
        grid_encode_fwd_kernel<C, float, false><<<blocks, kThreads, 0, s>>>(
            x, (const float*)table, out, n, L, lt);
}

template <int C>
static void launch_bwd(const float* x, const float* g, int bf16, float* gt,
                       long long n, int scenes, int L, const LevelTable& lt,
                       cudaStream_t s) {
    // points per block: 256, halved until the staged grad_out tile fits
    // the 48 KB of shared memory a block gets without opting in
    int tile = 256;
    while (tile > 32 && (size_t)tile * (L * C + 1) * sizeof(float) > 48 * 1024)
        tile /= 2;
    const size_t smem = (size_t)tile * (L * C + 1) * sizeof(float);
    const dim3 blocks((unsigned)((n + tile - 1) / tile), scenes);
    if (bf16 && scenes > 1)
        grid_encode_bwd_kernel<C, true, true><<<blocks, tile, smem, s>>>(
            x, g, gt, n, L, lt);
    else if (bf16)
        grid_encode_bwd_kernel<C, true, false><<<blocks, tile, smem, s>>>(
            x, g, gt, n, L, lt);
    else if (scenes > 1)
        grid_encode_bwd_kernel<C, false, true><<<blocks, tile, smem, s>>>(
            x, g, gt, n, L, lt);
    else
        grid_encode_bwd_kernel<C, false, false><<<blocks, tile, smem, s>>>(
            x, g, gt, n, L, lt);
}

// Host pointers: offsets (L+1) int64, scales (L) f32, strides (L, 3)
// uint32, use_hash (L) int32.  Device pointers, for S = n_scenes scenes
// of n_points each: x (S, N, 3) f32, table (S, T, C) f32 or bf16, its
// data aligned to min(C * element size, 16) bytes, out (S, N, L*C) f32.
// Returns cudaGetLastError().
extern "C" int sf_grid_encode_fwd(const void* x, const void* table,
                                  int table_bf16, void* out,
                                  long long n_points, int n_scenes, int L,
                                  int C,
                                  const void* offsets, const void* scales,
                                  const void* strides, const void* use_hash,
                                  void* stream) {
    LevelTable lt;
    int err = make_levels(L, (const long long*)offsets,
                          (const float*)scales, (const uint32_t*)strides,
                          (const int*)use_hash, &lt, nullptr);
    if (err) return err;
    if (n_scenes < 1 || n_scenes > 65535) return (int)cudaErrorInvalidValue;
    if (n_points == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    float* o = (float*)out;
    const int S = n_scenes;
    switch (C) {
        case 1: launch_fwd<1>(xf, table, table_bf16, o, n_points, S, L, lt, s); break;
        case 2: launch_fwd<2>(xf, table, table_bf16, o, n_points, S, L, lt, s); break;
        case 4: launch_fwd<4>(xf, table, table_bf16, o, n_points, S, L, lt, s); break;
        case 8: launch_fwd<8>(xf, table, table_bf16, o, n_points, S, L, lt, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// grad_out (S, N, L*C) f32; grad_table (S, T, C) f32, zeroed by the
// caller.
extern "C" int sf_grid_encode_bwd(const void* x, const void* grad_out,
                                  int table_bf16, void* grad_table,
                                  long long n_points, int n_scenes, int L,
                                  int C,
                                  const void* offsets, const void* scales,
                                  const void* strides, const void* use_hash,
                                  void* stream) {
    LevelTable lt;
    int err = make_levels(L, (const long long*)offsets,
                          (const float*)scales, (const uint32_t*)strides,
                          (const int*)use_hash, &lt, nullptr);
    if (err) return err;
    if (n_scenes < 1 || n_scenes > 65535) return (int)cudaErrorInvalidValue;
    if (n_points == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const float* g = (const float*)grad_out;
    float* gt = (float*)grad_table;
    const int S = n_scenes;
    switch (C) {
        case 1: launch_bwd<1>(xf, g, table_bf16, gt, n_points, S, L, lt, s); break;
        case 2: launch_bwd<2>(xf, g, table_bf16, gt, n_points, S, L, lt, s); break;
        case 4: launch_bwd<4>(xf, g, table_bf16, gt, n_points, S, L, lt, s); break;
        case 8: launch_bwd<8>(xf, g, table_bf16, gt, n_points, S, L, lt, s); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The reduction make_levels chooses for each level, into reductions (L)
// int32 on the host: 0 identity, 1 mask, 2 modulo.  Host only, launches
// nothing.
extern "C" int sf_grid_encode_plan(int L, const void* offsets,
                                   const void* scales, const void* strides,
                                   const void* use_hash, void* reductions) {
    LevelTable lt;
    return make_levels(L, (const long long*)offsets, (const float*)scales,
                       (const uint32_t*)strides, (const int*)use_hash, &lt,
                       (int*)reductions);
}
