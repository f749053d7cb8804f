// Device stamps of the port's tracer (plslam_tpu_torch/utils/trace.py).
//
// A stamp is one thread of one block: it reads the device's global
// nanosecond timer (%globaltimer) and appends (record index, code, ns) to a
// ring of `capacity` records at a cursor in device memory, taken with an
// atomic add. Launched on a stream under CUDA-graph capture it becomes a
// node of the graph, so every replay appends its records behind the earlier
// ones with no host work, whatever baked-in arguments the capture saw: the
// cursor is read on the device. The record index lets a reader tell a
// record from one that overwrote its slot.
//
// The timer probe reads %globaltimer `n` times back to back in one thread:
// the steps between distinct readings are the timer's resolution.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void slam_trace_stamp(unsigned long long* cursor, long long* log,
                                 unsigned long long capacity, int code) {
    const unsigned long long t = global_ns();
    const unsigned long long i = atomicAdd(cursor, 1ull);
    long long* rec = log + 3 * (i % capacity);
    rec[0] = static_cast<long long>(i);
    rec[1] = code;
    rec[2] = static_cast<long long>(t);
}

__global__ void slam_trace_timer_probe(long long* out, int n) {
    for (int k = 0; k < n; ++k) out[k] = static_cast<long long>(global_ns());
}

}  // namespace

extern "C" int plslam_trace_stamp(int device, void* stream, void* cursor,
                                  void* log, long long capacity, int code) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (capacity <= 0) return static_cast<int>(cudaErrorInvalidValue);
    slam_trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<unsigned long long*>(cursor), static_cast<long long*>(log),
        static_cast<unsigned long long>(capacity), code);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int plslam_trace_timer_probe(int device, void* stream, void* out,
                                        int n) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    slam_trace_timer_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(out), n);
    return static_cast<int>(cudaGetLastError());
}
