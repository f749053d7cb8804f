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
// What bounds it on an H100 SXM: descriptors are {0,1} bytes, so the search
// is an integer matrix product of depth 256 plus an epilogue. At N = 1024,
// P = 12288 a dense product is 2 N P 256 = 6.44 G operations: 3.26 us at the
// dense int8 tensor-core peak of 1,979 TOP/s. The inputs as the function
// takes them (u8 rows, uv, radius, level, flags) and its outputs are
// 3.65 MB: 1.09 us at 3.35 TB/s. With the gates on, only the passing pairs
// need a distance, so the bytes bound.
//
// Design:
// - No repacking: the kernel reads the u8 rows as the caller holds them.
//   With a query row q turned into +-1 bytes (2q - 1) once,
//   Hamming(q, b) = sum(q) + sum(b) - 2 q.b = sum(q) - (2q - 1).b, so one
//   u8 x s8 -> s32 tensor-core product per pair and one row sum per query
//   give the exact distance; map points need no row sum.
// - The products run on wgmma (m64n80k32, asynchronous): a block's 80
//   queries are the N operand, staged once in shared memory in the
//   canonical K-major layout, and each 64-point map tile is the M operand,
//   written by the tensor memory accelerator (TMA) in the 128-byte swizzle
//   that wgmma reads without bank conflicts.
// - A block splits its P range over a thread-block cluster of up to 8
//   blocks (interleaved 64-point tiles): 13 query tiles x 8 = 104 blocks at
//   N = 1024, one per SM (the shared memory asks for more than half of one),
//   in 13 clusters. A producer warp reads the visibility flags of the
//   block's tiles and drops those with no visible point (most of a map's
//   capacity is empty), then streams the live tiles through a 6-stage ring
//   from one thread: per tile one byte-counted mbarrier and six TMA copies
//   (the descriptors in two 128-byte halves of k, visibility, uv, radius,
//   level), zero-filled past P. Its first copies overlap the consumer warps'
//   staging of the queries. Three consumer warpgroups take the tiles in
//   turn, so products, copies and epilogues overlap.
// - The gates and the running top-2 live in the epilogue, in registers: a
//   pair's key is (distance << 22) + index, so min/max on keys keeps the
//   lowest index on ties, and a masked pair's key is all ones. The gates
//   are the plain version's float compares with no multiply (no FMA
//   contraction), hence bit-equal; with the gates on, a warp skips the keys
//   of an 8-query block where none of its pairs passes.
// - One launch per search: lanes merge by shuffles, the consumer warps
//   through shared memory, and the cluster's blocks push their keys into the
//   owner block's shared memory (distributed shared memory) before one
//   cluster barrier. Only (idx int64, best, second) reach device memory.
// - A batch of S searches (the stream axis that `jax.vmap` gives the TPU
//   kernel) is one launch too: grid z is the stream, and each z-slice is
//   one stream's search as above, with its own visibility pre-pass, its
//   own cluster along P and its own results. An input holds either one
//   tensor for every stream or S of them back to back (its rows per
//   stream: 0, or N / P, or for a map-side gate field P rounded up so
//   that each stream starts 16-byte aligned). Each map-side tensor map
//   has the stream as its outer dimension, so a tile's copies start at
//   its stream's row and read zeros past P, as a single search's do; no
//   stream reads another's points.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kDescBytes = 256;
constexpr int kChunks = kDescBytes / 16;   // 16-byte k-chunks of a row
constexpr int kTile = 64;                  // map points per tile (wgmma M)
constexpr int kQueries = 80;               // queries per block (wgmma N)
constexpr int kStages = 6;
constexpr int kGroups = 3;                 // consumer warpgroups
constexpr int kConsumers = 4 * kGroups;    // consumer warps
constexpr int kThreads = 32 * kConsumers + 32;   // and one producer warp
constexpr int kMaxCluster = 8;
constexpr int kMaxRankTiles = 4096;        // tiles per block: P < 2^21 at 8
constexpr int kInvalid = 1 << 20;
constexpr int kIdxBits = 22;               // key = (distance << 22) + index
constexpr unsigned kIdxMask = (1u << kIdxBits) - 1;
constexpr unsigned kNoKey = 0xffffffffu;
constexpr int kAccs = kQueries / 2;        // s32 accumulators per thread
// Canonical K-major layout: the core matrix of rows 8 rb .. 8 rb + 7 and
// k-chunk c sits at rb * kRowBlock + c * kCore, its rows 16 bytes apart.
constexpr int kCore = 128;
constexpr int kRowBlock = kChunks * kCore;

__host__ __device__ constexpr int core_offset(int row, int chunk) {
    return (row / 8) * kRowBlock + chunk * kCore + (row % 8) * 16;
}

struct Stage {
    // the tile's two 128-byte halves of k, 64 rows each, as the tensor
    // memory accelerator writes them with its 128-byte swizzle
    alignas(1024) uint8_t desc[2][kTile * 128];
    alignas(16) float2 uv[kTile];   // the gate fields, zero past P
    alignas(16) float radius[kTile];
    alignas(16) int32_t level[kTile];
    alignas(16) uint8_t vis[kTile];
};

// The tensor maps of the map points' inputs, read one tile at a time.
struct Maps {
    CUtensorMap desc, uv, radius, level, visible;
};

// Rows per stream of each input (0: one tensor shared by every stream).
struct Streams {
    int q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level,
        d_visible;
};

// This stream's coordinate along the stream dimension of each map-side
// tensor map (0 for a tensor shared by every stream).
struct MapRows {
    int desc, uv, radius, level, visible;
};

struct Smem {
    Stage stage[kStages];
    alignas(128) int8_t query[kQueries * kDescBytes];   // +-1, canonical
    int4 qrec[kQueries];    // u, v (float bits), octave, row sum
    uint64_t full[kStages];    // the producer's copies of a stage landed
    uint64_t empty[kStages];   // the consuming warpgroup is done with it
    unsigned part[kConsumers][2][kQueries];         // (best, second) per warp
    unsigned gather[kMaxCluster][2][kQueries];      // pushed by each rank
    uint16_t live[kMaxRankTiles];                   // this block's live tiles
    int n_live;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;   // + base alignment

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// Shared-memory matrix descriptors of K-major operands: the queries in the
// canonical layout without swizzle (leading byte offset = the next k-chunk,
// stride byte offset = the next 8 rows), a map tile half in the 128-byte
// swizzle (8-row atoms of 1024 bytes).
__device__ __forceinline__ uint64_t matrix_desc(const void* p) {
    return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4)
         | static_cast<uint64_t>(kCore >> 4) << 16
         | static_cast<uint64_t>(kRowBlock >> 4) << 32;
}

__device__ __forceinline__ uint64_t swizzled_desc(const void* p) {
    return static_cast<uint64_t>((smem_addr(p) & 0x3ffff) >> 4)
         | static_cast<uint64_t>(1) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void pin(int (&d)[kAccs]) {
    #pragma unroll
    for (int i = 0; i < kAccs; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= map tile (64 x 32 u8) x queries (80 x 32 s8)^T for one k-step.
__device__ __forceinline__ void wgmma_u8s8(int (&d)[kAccs], uint64_t a_desc,
                                           uint64_t b_desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "%40, %41, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
        : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// Top-2 of keys: fold in `key`, or merge another top-2 (b2, s2) over a
// disjoint set of points.
__device__ __forceinline__ void push(unsigned& b, unsigned& s, unsigned key) {
    s = min(s, max(b, key));
    b = min(b, key);
}

__device__ __forceinline__ void merge(unsigned& b, unsigned& s, unsigned b2,
                                      unsigned s2) {
    s = min(min(s, s2), max(b, b2));
    b = min(b, b2);
}

// A 2-D tensor copy of one box at element x of row y, completing on
// `bar`.
__device__ __forceinline__ void tensor_copy_2d(void* dst,
                                               const CUtensorMap* map, int x,
                                               int y, uint64_t* bar) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
                 :: "r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y),
                    "r"(smem_addr(bar))
                 : "memory");
}

// The producer's tensor copies of map tile `tile` into `st`, completing on
// `full` by their byte count; rows past P are zero, so invisible.
template <bool kGated>
__device__ __forceinline__ void stage_tile(Stage& st, uint64_t* full,
                                           const Maps& maps,
                                           const MapRows& rows, int tile) {
    constexpr int kBytes = kTile * (kDescBytes + 1)
                         + (kGated ? kTile * (8 + 4 + 4) : 0);
    const int t0 = tile * kTile;
    asm volatile("{\n.reg .b64 state;\n"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;"
                 "\n}\n"
                 :: "r"(smem_addr(full)), "r"(kBytes) : "memory");
    #pragma unroll
    for (int h = 0; h < 2; ++h)
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
            :: "r"(smem_addr(st.desc[h])), "l"(&maps.desc), "r"(128 * h),
               "r"(t0), "r"(rows.desc), "r"(smem_addr(full))
            : "memory");
    tensor_copy_2d(st.vis, &maps.visible, t0, rows.visible, full);
    if (kGated) {
        tensor_copy_2d(st.uv, &maps.uv, 2 * t0, rows.uv, full);
        tensor_copy_2d(st.radius, &maps.radius, t0, rows.radius, full);
        tensor_copy_2d(st.level, &maps.level, t0, rows.level, full);
    }
}

// Folds tile `st` (first point t0 of the stream's P) into this thread's
// running top-2 keys: acc[4 i + 2 h + e] is the product of point
// 16 w + g + 8 h (w: the warp in its warpgroup) and query 8 i + 2 t + e,
// as (2q - 1).b.
template <bool kGated>
__device__ __forceinline__ void fold_tile(
    const Stage& st, const int4* qrec, int t0, int p, int w, int g, int t,
    const int (&acc)[kAccs], unsigned (&best)[kAccs / 2],
    unsigned (&second)[kAccs / 2])
{
    float2 uv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    float rad[2] = {0.f, 0.f};
    int lvl[2] = {0, 0};
    bool vis[2];
    unsigned idx[2];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int j = 16 * w + g + 8 * h;
        vis[h] = st.vis[j] != 0 && t0 + j < p;
        if (kGated) {
            uv[h] = st.uv[j];
            rad[h] = st.radius[j];
            lvl[h] = st.level[j];
        }
        idx[h] = t0 + j;
    }
    // Per block of 8 queries: the gates of this thread's 4 pairs, then the
    // keys; with the gates on, only where a pair of the warp passes (one
    // warp-wide branch).
    #pragma unroll
    for (int i = 0; i < kQueries / 8; ++i) {
        int4 q[2];
        bool pass[2][2];
        bool any = false;
        #pragma unroll
        for (int e = 0; e < 2; ++e) {
            q[e] = qrec[8 * i + 2 * t + e];
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                pass[e][h] = vis[h];
                if (kGated)
                    pass[e][h] = pass[e][h]
                        & (fabsf(__int_as_float(q[e].x) - uv[h].x) < rad[h])
                        & (fabsf(__int_as_float(q[e].y) - uv[h].y) < rad[h])
                        & (static_cast<unsigned>(q[e].z)
                               - static_cast<unsigned>(lvl[h]) + 1u <= 2u);
                any = any | pass[e][h];
            }
        }
        if (kGated && !__any_sync(0xffffffffu, any)) continue;
        #pragma unroll
        for (int e = 0; e < 2; ++e)
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int d = q[e].w - acc[4 * i + 2 * h + e];   // [0, 256]
                const unsigned key =
                    (static_cast<unsigned>(d) << kIdxBits) + idx[h];
                push(best[2 * i + e], second[2 * i + e],
                     pass[e][h] ? key : kNoKey);
            }
    }
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
gated_best2(const __grid_constant__ Maps maps,   // the P map points
            const uint8_t* __restrict__ q_bits,    // (N, 256) {0,1}
            const float2* __restrict__ q_uv,       // (N,)
            const int32_t* __restrict__ q_oct,     // (N,)
            const uint8_t* __restrict__ q_valid,   // (N,)
            const uint8_t* __restrict__ d_visible, // (P,)
            int n, int p, Streams per,             // per stream, see above
            int32_t* __restrict__ best_out,        // (S, N)
            int32_t* __restrict__ second_out,      // (S, N)
            int64_t* __restrict__ idx_out)         // (S, N)
{
    extern __shared__ unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(
        smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024));
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int n_ranks = static_cast<int>(cluster.num_blocks());
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const bool producer = warp == kConsumers;
    const int q_block = blockIdx.y * kQueries;
    // this block's stream: its inputs' rows and its outputs
    const int z = blockIdx.z;
    q_bits += static_cast<size_t>(z) * per.q_bits * kDescBytes;
    q_uv += static_cast<size_t>(z) * per.q_uv;
    q_oct += static_cast<size_t>(z) * per.q_oct;
    q_valid += static_cast<size_t>(z) * per.q_valid;
    const size_t vis0 = static_cast<size_t>(z) * per.d_visible;
    d_visible += vis0;
    best_out += static_cast<size_t>(z) * n;
    second_out += static_cast<size_t>(z) * n;
    idx_out += static_cast<size_t>(z) * n;
    const MapRows map_rows = {per.d_bits ? z : 0, per.d_uv ? z : 0,
                              per.d_radius ? z : 0, per.d_level ? z : 0,
                              per.d_visible ? z : 0};

    // This rank's tiles are rank, rank + n_ranks, ...; the producer warp
    // keeps those with a visible point, in ascending order, and queues the
    // first kStages of them while the consumer warps stage the queries.
    const int n_tiles = (p + kTile - 1) / kTile;
    const int my_tiles = rank < n_tiles
        ? (n_tiles - rank + n_ranks - 1) / n_ranks : 0;
    if (producer) {
        if (lane == 0) {
            for (int s = 0; s < kStages; ++s) {
                mbar_init(&sm.full[s], 1);   // the producer's expect_tx
                mbar_init(&sm.empty[s], 4);  // the consuming warpgroup
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        int n_live = 0;
        for (int k0 = 0; k0 < my_tiles; k0 += 32) {   // a tile per lane
            const int k = k0 + lane;
            bool live = false;
            if (k < my_tiles) {
                const int t0 = (rank + k * n_ranks) * kTile;
                if (t0 + kTile <= p && vis0 % 16 == 0) {
                    const uint4* f =
                        reinterpret_cast<const uint4*>(d_visible + t0);
                    uint4 x = make_uint4(0, 0, 0, 0);
                    #pragma unroll
                    for (int m = 0; m < kTile / 16; ++m) {
                        const uint4 y = f[m];
                        x = make_uint4(x.x | y.x, x.y | y.y, x.z | y.z,
                                       x.w | y.w);
                    }
                    live = (x.x | x.y | x.z | x.w) != 0;
                } else {
                    for (int i = t0; i < p; ++i) live = live || d_visible[i];
                }
            }
            const unsigned m = __ballot_sync(0xffffffffu, live);
            if (live) sm.live[n_live + __popc(m & ((1u << lane) - 1))] = k;
            n_live += __popc(m);
        }
        __syncwarp();
        if (lane == 0) {
            sm.n_live = n_live;
            for (int k = 0; k < min(n_live, kStages); ++k)
                stage_tile<kGated>(sm.stage[k], &sm.full[k], maps, map_rows,
                                   rank + sm.live[k] * n_ranks);
        }
    } else {
        // The block's queries: +-1 rows in the canonical layout, and their
        // gate fields and row sums; a thread per (query, 16-byte chunk),
        // with all of its loads issued before any is used.
        constexpr int kTotal = kQueries * kChunks;
        constexpr int kStride = 32 * kConsumers;
        constexpr int kPer = (kTotal + kStride - 1) / kStride;
        static_assert(kTotal % 32 == 0, "whole warps per row pair");
        uint4 x[kPer];
        float2 uv[kPer];
        int oct[kPer];
        #pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int c = threadIdx.x + i * kStride;
            const int q = q_block + c / kChunks;
            const bool in = c < kTotal && q < n;
            x[i] = in ? *reinterpret_cast<const uint4*>(
                            q_bits + static_cast<size_t>(q) * kDescBytes
                            + 16 * (c % kChunks))
                      : make_uint4(0, 0, 0, 0);
            const bool head = in && kGated && c % kChunks == 0;
            uv[i] = head ? q_uv[q] : make_float2(0.f, 0.f);
            oct[i] = head ? q_oct[q] : 0;
        }
        #pragma unroll
        for (int i = 0; i < kPer; ++i) {
            const int c = threadIdx.x + i * kStride;
            if (c >= kTotal) break;   // whole warps leave together
            const int row = c / kChunks, chunk = c % kChunks;
            unsigned sum = __dp4a(x[i].x, 0x01010101u, 0u);
            sum = __dp4a(x[i].y, 0x01010101u, sum);
            sum = __dp4a(x[i].z, 0x01010101u, sum);
            sum = __dp4a(x[i].w, 0x01010101u, sum);
            // bytes 0 -> -1, 1 -> +1
            *reinterpret_cast<uint4*>(sm.query + core_offset(row, chunk)) =
                make_uint4(~(x[i].x * 0xfeu), ~(x[i].y * 0xfeu),
                           ~(x[i].z * 0xfeu), ~(x[i].w * 0xfeu));
            #pragma unroll
            for (int m = 1; m < kChunks; m *= 2)   // the 16 lanes of a row
                sum += __shfl_xor_sync(0xffffffffu, sum, m);
            if (chunk == 0)
                sm.qrec[row] = make_int4(__float_as_int(uv[i].x),
                                         __float_as_int(uv[i].y), oct[i],
                                         static_cast<int>(sum));
        }
        // the tensor cores read the query rows through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    const int n_live = sm.n_live;

    // The ring: the producer fills stage k % kStages with live tile k once
    // the warpgroup that read its previous use is done; warpgroup
    // k % kGroups folds tile k.
    unsigned best[kAccs / 2], second[kAccs / 2];
    #pragma unroll
    for (int c = 0; c < kAccs / 2; ++c) best[c] = second[c] = kNoKey;
    const int wg = warp / 4, w = warp % 4;
    const int g = lane / 4, t = lane % 4;
    if (producer) {
        for (int k = kStages; k < n_live; ++k) {
            const int s = k % kStages;
            mbar_wait(&sm.empty[s], (k / kStages - 1) & 1);
            if (lane == 0)
                stage_tile<kGated>(sm.stage[s], &sm.full[s], maps, map_rows,
                                   rank + sm.live[k] * n_ranks);
        }
    } else {
        const uint64_t q_desc = matrix_desc(sm.query);
        for (int k = wg; k < n_live; k += kGroups) {
            const int s = k % kStages;
            mbar_wait(&sm.full[s], (k / kStages) & 1);
            int acc[kAccs];
            pin(acc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            #pragma unroll
            for (int ks = 0; ks < kChunks / 2; ++ks)   // 32 bytes per k-step
                wgmma_u8s8(acc,
                           swizzled_desc(sm.stage[s].desc[ks / 4]
                                         + 32 * (ks % 4)),
                           q_desc + ((2 * ks * kCore) >> 4), ks > 0);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
            pin(acc);
            fold_tile<kGated>(sm.stage[s], sm.qrec,
                              (rank + sm.live[k] * n_ranks) * kTile, p, w, g,
                              t, acc, best, second);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[s]);
        }
    }

    // Merge: the 8 lanes of a query column, the consumer warps, the
    // cluster.
    if (!producer) {
        #pragma unroll
        for (int c = 0; c < kAccs / 2; ++c) {
            #pragma unroll
            for (int m = 4; m < 32; m *= 2)
                merge(best[c], second[c],
                      __shfl_xor_sync(0xffffffffu, best[c], m),
                      __shfl_xor_sync(0xffffffffu, second[c], m));
            if (g == 0) {
                const int col = 8 * (c / 2) + 2 * t + c % 2;
                sm.part[warp][0][col] = best[c];
                sm.part[warp][1][col] = second[c];
            }
        }
    }
    __syncthreads();
    const int rows = kQueries / n_ranks;   // rank r owns rows r*rows ...
    if (threadIdx.x < kQueries) {
        const int row = threadIdx.x;
        unsigned b = sm.part[0][0][row], s = sm.part[0][1][row];
        #pragma unroll
        for (int c = 1; c < kConsumers; ++c)
            merge(b, s, sm.part[c][0][row], sm.part[c][1][row]);
        unsigned* dst = cluster.map_shared_rank(&sm.gather[rank][0][0],
                                                row / rows);
        dst[row % rows] = b;
        dst[kQueries + row % rows] = s;
    }
    cluster.sync();   // every rank's keys are in their owners' gather
    if (threadIdx.x < rows) {
        const int row = threadIdx.x;
        unsigned b = kNoKey, s = kNoKey;
        for (int src = 0; src < n_ranks; ++src)
            merge(b, s, sm.gather[src][0][row], sm.gather[src][1][row]);
        const int q = q_block + rank * rows + row;
        if (q < n) {
            const bool valid = q_valid[q] != 0;
            const bool has_best = valid && (b >> kIdxBits) <= 256;
            const bool has_second = valid && (s >> kIdxBits) <= 256;
            best_out[q] = has_best ? static_cast<int>(b >> kIdxBits) : kInvalid;
            second_out[q] = has_second ? static_cast<int>(s >> kIdxBits)
                                       : kInvalid;
            idx_out[q] = has_best ? static_cast<int64_t>(b & kIdxMask) : 0;
        }
    }
}

// A tensor map over `rank` dimensions of `dims` elements (the first
// contiguous, dimension i + 1 `strides[i]` bytes apart), read in boxes of
// `box`; in each dimension,
// reads past the end give zeros. The encoder is the driver's, reached
// through the runtime.
cudaError_t encode_map(CUtensorMap* map, const void* ptr,
                       CUtensorMapDataType type, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box, CUtensorMapSwizzle swizzle)
{
    using Encode = CUresult (*)(
        CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
        const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
        const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
        CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return cudaErrorSymbolNotFound;
        encode = reinterpret_cast<Encode>(fn);
    }
    const cuuint32_t steps[3] = {1, 1, 1};
    const CUresult r = encode(
        map, type, rank, const_cast<void*>(ptr), dims, strides, box,
        steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a gate field: (S or 1) rows of P points of `point_bytes`,
// `per_stream` points apart (0: one row shared by every stream; else a
// multiple of 16 bytes), in boxes of one tile of one row.
cudaError_t encode_rows(CUtensorMap* map, const void* ptr,
                        CUtensorMapDataType type, int elems_per_point,
                        int point_bytes, int p, int s, int per_stream)
{
    const cuuint64_t row_bytes = static_cast<cuuint64_t>(p) * point_bytes;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p) * elems_per_point,
                                static_cast<cuuint64_t>(per_stream ? s : 1)};
    const cuuint64_t strides[1] = {
        per_stream ? static_cast<cuuint64_t>(per_stream) * point_bytes
                   : (row_bytes + 15) / 16 * 16};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(kTile
                                                       * elems_per_point), 1};
    return encode_map(map, ptr, type, 2, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The maps of one batch of searches: the (S or 1) x P x 256 descriptors in
// boxes of 64 rows x 128 bytes of one stream with the 128-byte swizzle, and
// the gate fields in boxes of one tile of one stream.
cudaError_t encode_maps(Maps* maps, const void* d_bits, const void* d_uv,
                        const void* d_radius, const void* d_level,
                        const void* d_visible, int p, int s,
                        const Streams& per, bool gated)
{
    const cuuint64_t desc_dims[3] = {
        kDescBytes, static_cast<cuuint64_t>(p),
        static_cast<cuuint64_t>(per.d_bits ? s : 1)};
    const cuuint64_t desc_strides[2] = {
        kDescBytes,
        static_cast<cuuint64_t>(per.d_bits ? per.d_bits : p) * kDescBytes};
    const cuuint32_t desc_box[3] = {128, kTile, 1};
    cudaError_t err = encode_map(&maps->desc, d_bits,
                                 CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, desc_dims,
                                 desc_strides, desc_box,
                                 CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == cudaSuccess)
        err = encode_rows(&maps->visible, d_visible,
                          CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 1, p, s,
                          per.d_visible);
    if (err == cudaSuccess && gated)
        err = encode_rows(&maps->uv, d_uv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                          2, 8, p, s, per.d_uv);
    if (err == cudaSuccess && gated)
        err = encode_rows(&maps->radius, d_radius,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, 4, p, s,
                          per.d_radius);
    if (err == cudaSuccess && gated)
        err = encode_rows(&maps->level, d_level,
                          CU_TENSOR_MAP_DATA_TYPE_INT32, 1, 4, p, s,
                          per.d_level);
    return err;
}

template <bool kGated>
cudaError_t launch(cudaStream_t stream, const void* q_bits, const void* q_uv,
                   const void* q_oct, const void* q_valid, const void* d_bits,
                   const void* d_uv, const void* d_radius, const void* d_level,
                   const void* d_visible, int n, int p, int s,
                   const Streams& rows, void* best, void* second, void* idx)
{
    cudaError_t err = cudaFuncSetAttribute(
        gated_best2<kGated>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    // P splits over up to 8 ranks of a cluster
    const int p_tiles = (p + kTile - 1) / kTile;
    int cluster = 1;
    while (cluster < kMaxCluster && cluster < p_tiles) cluster *= 2;
    if ((p_tiles + cluster - 1) / cluster > kMaxRankTiles)
        return cudaErrorInvalidValue;
    Maps maps = {};   // unused when P = 0: no tile is live
    if (p > 0) {
        err = encode_maps(&maps, d_bits, d_uv, d_radius, d_level, d_visible,
                          p, s, rows, kGated);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, (n + kQueries - 1) / kQueries, s);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = kSmemBytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, gated_best2<kGated>, maps, static_cast<const uint8_t*>(q_bits),
        static_cast<const float2*>(q_uv), static_cast<const int32_t*>(q_oct),
        static_cast<const uint8_t*>(q_valid),
        static_cast<const uint8_t*>(d_visible), n, p, rows,
        static_cast<int32_t*>(best), static_cast<int32_t*>(second),
        static_cast<int64_t*>(idx));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

int run(int device, void* stream, const void* q_bits, const void* q_uv,
        const void* q_oct, const void* q_valid, const void* d_bits,
        const void* d_uv, const void* d_radius, const void* d_level,
        const void* d_visible, int n, int p, int s, const Streams& rows,
        int gated, void* best, void* second, void* idx)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || s <= 0) return 0;
    if (p < 0 || p >= (1 << 21) || s > 65535
        || static_cast<long long>(s) * p >= (1ll << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    err = gated
        ? launch<true>(st, q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                       d_radius, d_level, d_visible, n, p, s, rows, best,
                       second, idx)
        : launch<false>(st, q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                        d_radius, d_level, d_visible, n, p, s, rows, best,
                        second, idx);
    return static_cast<int>(err);
}

}  // namespace

// Launches S searches (S = 1: one) on `stream` of `device` as one kernel,
// grid (cluster, ceil(N / 80), S) in clusters along P. Pointers are device
// pointers to the (N, 256) and (P, 256) u8 rows, uv float2, int32 octave /
// level, float radius and bool flags; `rows` holds the rows per stream of
// the nine inputs in argument order (0: one tensor for all streams; else
// the streams back to back, N apart for the queries, P for the
// descriptors, and for the map-side gate fields and flags a count >= P
// that starts every stream 16-byte aligned). The map-side inputs are
// 16-byte aligned at their first row (d_visible too), P is below 2^21 and
// S x P below 2^31. Outputs are (S, N) int32 best and second and int64
// index. Returns the cudaError_t of the launch.
extern "C" int plslam_gated_hamming_best2(
    int device, void* stream,
    const void* q_bits, const void* q_uv, const void* q_oct,
    const void* q_valid, const void* d_bits, const void* d_uv,
    const void* d_radius, const void* d_level, const void* d_visible,
    int n, int p, int s, const int* rows, int gated, void* best,
    void* second, void* idx)
{
    const Streams r = {rows[0], rows[1], rows[2], rows[3], rows[4], rows[5],
                       rows[6], rows[7], rows[8]};
    return run(device, stream, q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
               d_radius, d_level, d_visible, n, p, s, r, gated, best, second,
               idx);
}
