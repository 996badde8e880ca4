// The span recorder's device stamp (utils/spans.py): one thread writes
// (slot, tag, %globaltimer) into a ring of stamps at a cursor that it
// advances on the device.
//
// A CUDA graph replays no host code, and a timing event recorded in a
// graph keeps only its last replay, so the recorder enqueues this kernel
// at each edge of a span on a CUDA device.  Captured in a graph, the
// kernel reads the cursor at each replay: every replay leaves its own
// stamps in the next free slots, in the order the stream runs them.  The
// slot number written beside the stamp lets the host tell a stamp it
// expects from one a later lap of the ring has written over.
//
// %globaltimer is the device's nanosecond clock; the host converts it to
// its own clock with a calibration stamp (spans.py).  The kernel's name
// holds none of the words by which the benchmark's breakdown classes
// kernels (portbench/trace.py), so its microseconds fall in "other".

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void span_stamp_kernel(long long* __restrict__ ring,
                                  unsigned long long* __restrict__ cursor,
                                  long long slots, long long tag) {
    const unsigned long long slot = atomicAdd(cursor, 1ULL);
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    long long* row = ring + 3 * (long long)(slot % (unsigned long long)slots);
    row[0] = (long long)slot;
    row[1] = tag;
    row[2] = (long long)now;
}

}  // namespace

// ring (slots, 3) int64 and cursor (1,) uint64 on the current device;
// tag any int64.  Returns a cudaError_t.
extern "C" int sf_span_stamp(void* ring, void* cursor, long long slots,
                             long long tag, void* stream) {
    if (slots <= 0) return (int)cudaErrorInvalidValue;
    span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (long long*)ring, (unsigned long long*)cursor, slots, tag);
    return (int)cudaGetLastError();
}
