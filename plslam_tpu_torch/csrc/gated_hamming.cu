// Projection-gated Hamming top-2 search for Hopper (sm_90a).
//
// Replaces the TPU kernel plslam_tpu/ops/pallas_match.py::gated_hamming_best2.
// For N query keypoints and P projected map points it finds, per query, the
// map point of least Hamming distance (and the second-least distance) among
// the pairs that pass every gate:
//   |q_u - d_u| < r and |q_v - d_v| < r   (projection window, float32)
//   |q_oct - d_level| <= 1                (octave agreement)
//   d_visible and q_valid
// With `gated` = 0 only the last line applies: masked_best2 under the
// separable mask q_valid x d_visible. A query with no passing pair gets
// best = second = INVALID (2^20) and index 0; ties go to the lowest index.
//
// What bounds it on the H100: the map side is P x (32 B descriptor + 16 B of
// uv, radius, level, visible) = 590 KB at P = 12288, which stays in the 50 MB
// L2; the work is N x P = 12.6 M pairs at N = 1024, each a handful of float
// and integer compares plus, for pairs inside the gates, 8 XORs and 8
// popcounts. So it is instruction-bound, not bandwidth-bound.
//
// Design: descriptors arrive packed as 8 x uint32. One thread owns one query
// and keeps its descriptor and running (best, second, idx) in registers;
// tiles of map points are staged in shared memory, where every thread of a
// warp reads the same point (a broadcast, no bank conflicts). Gates are
// tested before the popcounts, so gated-out pairs cost only the compares.
// At N = 1024 one query per thread would fill only 8 blocks of 128 threads
// on 132 SMs, so P is cut into chunks along a second grid dimension; each
// (query, chunk) writes a partial top-2 and a second kernel merges the
// partials in chunk order. Output is O(N); the N x P distance matrix is
// never formed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries per block, one per thread
constexpr int kTile = 256;      // map points staged in shared memory at once
constexpr int kWords = 8;       // 256-bit descriptor = 8 x uint32
constexpr int kInvalid = 1 << 20;

__global__ void __launch_bounds__(kThreads)
partial_best2(const uint4* __restrict__ q_desc,      // (N, 2) uint4
              const float2* __restrict__ q_uv,       // (N,)
              const int32_t* __restrict__ q_oct,     // (N,)
              const uint8_t* __restrict__ q_valid,   // (N,)
              const uint4* __restrict__ d_desc,      // (P, 2) uint4
              const float2* __restrict__ d_uv,       // (P,)
              const float* __restrict__ d_radius,    // (P,)
              const int32_t* __restrict__ d_level,   // (P,)
              const uint8_t* __restrict__ d_visible, // (P,)
              int n, int p, int gated, int chunk,
              int32_t* __restrict__ part_best,       // (C, N)
              int32_t* __restrict__ part_second,     // (C, N)
              int32_t* __restrict__ part_idx)        // (C, N)
{
    __shared__ uint4 s_desc[kTile * 2];
    __shared__ float2 s_uv[kTile];
    __shared__ float s_rad[kTile];
    __shared__ int32_t s_lvl[kTile];
    __shared__ uint8_t s_vis[kTile];

    const int q = blockIdx.x * kThreads + threadIdx.x;
    const int c = blockIdx.y;
    const int start = c * chunk;
    const int stop = min(p, start + chunk);

    const bool active = q < n && q_valid[q] != 0;
    uint32_t qw[kWords];
    float qu = 0.f, qv = 0.f;
    int qo = 0;
    if (active) {
        const uint4 a = q_desc[2 * q];
        const uint4 b = q_desc[2 * q + 1];
        qw[0] = a.x; qw[1] = a.y; qw[2] = a.z; qw[3] = a.w;
        qw[4] = b.x; qw[5] = b.y; qw[6] = b.z; qw[7] = b.w;
        const float2 uv = q_uv[q];
        qu = uv.x;
        qv = uv.y;
        qo = q_oct[q];
    }

    int best = kInvalid, second = kInvalid, idx = 0;
    for (int t0 = start; t0 < stop; t0 += kTile) {
        const int len = min(kTile, stop - t0);
        __syncthreads();  // the previous tile is no longer read
        for (int i = threadIdx.x; i < 2 * len; i += kThreads)
            s_desc[i] = d_desc[2 * t0 + i];
        for (int i = threadIdx.x; i < len; i += kThreads) {
            s_uv[i] = d_uv[t0 + i];
            s_rad[i] = d_radius[t0 + i];
            s_lvl[i] = d_level[t0 + i];
            s_vis[i] = d_visible[t0 + i];
        }
        __syncthreads();
        if (!active) continue;
        for (int j = 0; j < len; ++j) {
            if (!s_vis[j]) continue;
            if (gated) {
                const float r = s_rad[j];
                const float2 uv = s_uv[j];
                if (!(fabsf(qu - uv.x) < r && fabsf(qv - uv.y) < r)) continue;
                if (abs(qo - s_lvl[j]) > 1) continue;
            }
            const uint4 a = s_desc[2 * j];
            const uint4 b = s_desc[2 * j + 1];
            const int d = __popc(qw[0] ^ a.x) + __popc(qw[1] ^ a.y)
                        + __popc(qw[2] ^ a.z) + __popc(qw[3] ^ a.w)
                        + __popc(qw[4] ^ b.x) + __popc(qw[5] ^ b.y)
                        + __popc(qw[6] ^ b.z) + __popc(qw[7] ^ b.w);
            // strict < in ascending point order keeps the lowest index on ties
            if (d < best) {
                second = best;
                best = d;
                idx = t0 + j;
            } else if (d < second) {
                second = d;
            }
        }
    }
    if (q < n) {
        part_best[c * n + q] = best;
        part_second[c * n + q] = second;
        part_idx[c * n + q] = idx;
    }
}

// Merge the per-chunk partials of each query in ascending chunk order:
// best = min; idx from the chunk with the strictly smaller best (the lower
// chunk on ties); second = min(max(best_a, best_b), min(second_a, second_b)).
__global__ void merge_best2(const int32_t* __restrict__ part_best,
                            const int32_t* __restrict__ part_second,
                            const int32_t* __restrict__ part_idx,
                            int n, int n_chunks,
                            int32_t* __restrict__ best_out,
                            int32_t* __restrict__ second_out,
                            int32_t* __restrict__ idx_out)
{
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    int best = kInvalid, second = kInvalid, idx = 0;
    for (int c = 0; c < n_chunks; ++c) {
        const int b = part_best[c * n + q];
        const int s = part_second[c * n + q];
        second = min(max(best, b), min(second, s));
        if (b < best) {
            best = b;
            idx = part_idx[c * n + q];
        }
    }
    best_out[q] = best;
    second_out[q] = second;
    idx_out[q] = idx;
}

}  // namespace

// Launches the search on `stream` of `device`. Pointers are device pointers;
// descriptors are (N, 8) and (P, 8) uint32, partials (ceil(P / chunk), N)
// int32, outputs (N,) int32. Returns the cudaError_t of the launches.
extern "C" int plslam_gated_hamming_best2(
    int device, void* stream,
    const void* q_desc, const void* q_uv, const void* q_oct,
    const void* q_valid, const void* d_desc, const void* d_uv,
    const void* d_radius, const void* d_level, const void* d_visible,
    int n, int p, int gated, int chunk,
    void* part_best, void* part_second, void* part_idx,
    void* best, void* second, void* idx)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_chunks = p > 0 ? (p + chunk - 1) / chunk : 0;
    if (n_chunks > 0) {
        dim3 grid((n + kThreads - 1) / kThreads, n_chunks);
        partial_best2<<<grid, kThreads, 0, s>>>(
            static_cast<const uint4*>(q_desc), static_cast<const float2*>(q_uv),
            static_cast<const int32_t*>(q_oct),
            static_cast<const uint8_t*>(q_valid),
            static_cast<const uint4*>(d_desc), static_cast<const float2*>(d_uv),
            static_cast<const float*>(d_radius),
            static_cast<const int32_t*>(d_level),
            static_cast<const uint8_t*>(d_visible),
            n, p, gated, chunk,
            static_cast<int32_t*>(part_best), static_cast<int32_t*>(part_second),
            static_cast<int32_t*>(part_idx));
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    merge_best2<<<(n + 255) / 256, 256, 0, s>>>(
        static_cast<const int32_t*>(part_best),
        static_cast<const int32_t*>(part_second),
        static_cast<const int32_t*>(part_idx), n, n_chunks,
        static_cast<int32_t*>(best), static_cast<int32_t*>(second),
        static_cast<int32_t*>(idx));
    return static_cast<int>(cudaGetLastError());
}
