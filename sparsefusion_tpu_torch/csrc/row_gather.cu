// Row gather for Hopper (sm_90a): out[i] = table[idx[i]].
//
// Replaces the TPU kernel benchmarks/pallas_gather_micro.py::
// make_vmem_gather (inner `kernel`, launched by `run`): a row gather out
// of a (R, 128) table held whole in VMEM, bf16 in the micro (f32 too, by
// its dtype parameter), R in {8192, 16384, 32768}.  The Mosaic lowering
// needed the indices broadcast to (rows, 128) int32, a 128x memory tax on
// the indices; here they are an (N,) int32 vector.
//
// What bounds it on this card: bytes.  There is no arithmetic; the kernel
// reads N indices (4 B each), the table once (2-8 MB, which stays in the
// 50 MB L2 across the launch) and writes N rows.  For N = 131,072 bf16
// rows that is 36-43 MB, 10.8-12.7 us at 3.35 TB/s; the output is most
// of it.  Design:
//   - one group of row_bytes / 16 lanes per row (16 lanes for 256-byte
//     bf16 rows, 32 for 512-byte f32 rows), so each lane moves one
//     16-byte vector and a warp covers 2 or 1 whole rows;
//   - the group's first lane loads the row's index and shuffles it to
//     the group, one index load per row;
//   - table reads are read-only vector loads (__ldg on int4): the table
//     stays in L2 and L1, and each row is two or four whole 128-byte
//     lines;
//   - output stores are streaming (__stcs): each row is written once and
//     never read back, so it should not displace the table from L2;
//   - a grid-stride loop over rows, all lanes of a warp making the same
//     number of trips so the shuffle sees the whole warp;
//   - an index outside [0, R) reads nothing and writes a row of zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int LANES>
__global__ void __launch_bounds__(256)
row_gather_kernel(const int4* __restrict__ table,
                  const int* __restrict__ idx, int4* __restrict__ out,
                  long long n, int rows) {
    constexpr int GROUPS_PER_WARP = 32 / LANES;
    const int lane = threadIdx.x & 31;
    const int sub = lane % LANES;
    const int leader = lane - sub;
    const long long warp = (blockIdx.x * (long long)blockDim.x
                            + threadIdx.x) >> 5;
    const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
    for (long long base = warp * GROUPS_PER_WARP; base < n;
         base += n_warps * GROUPS_PER_WARP) {
        const long long r = base + lane / LANES;
        int i = -1;
        if (sub == 0 && r < n) i = __ldg(idx + r);
        i = __shfl_sync(0xffffffffu, i, leader);
        if (r < n) {
            int4 v = make_int4(0, 0, 0, 0);
            if ((unsigned)i < (unsigned)rows)
                v = __ldg(table + (long long)i * LANES + sub);
            __stcs(out + r * LANES + sub, v);
        }
    }
}

template <int LANES>
cudaError_t launch(const void* table, const int* idx, void* out,
                   long long n, int rows, cudaStream_t s) {
    constexpr int THREADS = 256;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    // enough blocks to fill every SM (8 blocks of 256 threads each) a few
    // times over; beyond that the grid-stride loop takes the rest
    const long long groups_per_block = THREADS / LANES;
    long long blocks = (n + groups_per_block - 1) / groups_per_block;
    const long long cap = (long long)sms * 8 * 4;
    if (blocks > cap) blocks = cap;
    row_gather_kernel<LANES><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const int4*)table, idx, (int4*)out, n, rows);
    return cudaGetLastError();
}

}  // namespace

// table (rows, row_bytes) of any element type, 16-byte aligned; idx (n,)
// int32; out (n, row_bytes), 16-byte aligned.  row_bytes is 256 (128
// bf16) or 512 (128 f32).  Returns a cudaError_t; launches nothing when
// n == 0.
extern "C" int sf_row_gather(const void* table, const void* idx, void* out,
                             long long n, int rows, int row_bytes,
                             void* stream) {
    if (n < 0 || rows < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int* ix = (const int*)idx;
    switch (row_bytes) {
        case 256: return (int)launch<16>(table, ix, out, n, rows, s);
        case 512: return (int)launch<32>(table, ix, out, n, rows, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
