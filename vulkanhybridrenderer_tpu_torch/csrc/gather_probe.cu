// Row-gather probes: the card's rate for data-dependent reads of an
// (N, 128) float32 table (the BVH8 table's shape), the counterparts of the
// TPU probes
//   scripts/bench_pallas_gather.py:88 pallas_vector_gather (row 3),
//   scripts/bench_pallas_gather.py:125 pallas_dyn_slice_loop (row 4),
//   scripts/bench_pallas_gather.py:157 pallas_take_along_axis (row 5),
//   scripts/probe_dyngather.py:63 (row 6).
// Column 48 of a row holds the next row's id, so each step's address depends
// on the previous step's load, as in K2's walk.  A walker returns its final
// row id and its own float32 sum of what it read, added in step order, so a
// kernel and its plain PyTorch version (probes/gather.py) agree bit for bit.
//
//   walk kind 0  thread-row: a thread owns its walker, as K4 (a thread a
//                ray) does, and needs its whole 512-byte row a step;
//   walk kind 1  warp-row: a group of kGroup lanes owns its walker, as K2
//                (four lanes a ray) does, the row read coalesced;
//   walk kind 2  thread per walker, only row[0] and row[48] (the latency
//                chase);
//   walk kind 3  per-lane gather: walker i reads tab[idx, i % 128] and steps
//                idx = (idx + (int)v * 7 + s) mod N;
//   walk kind 4  warp per walker, the whole row added into a 128-wide sum;
//   gather16     one independent gather of 16-byte rows out[i] = img[idx[i]]
//                (SSAO's and the PCF's taps);
//   read_rate    the yardstick: coalesced 16-byte reads of a slice a block
//                keeps in L1, or of the whole table from L2, many passes a
//                launch, their bits summed (uint32) so a plain sum checks them;
//   chase_ring   the yardstick's latency: one warp follows a pointer ring
//                resident in L1 or in L2, timed by the global timer.
// Bound on this card: the roofline bound counts each table byte a walk
// reads once at 3.35 TB/s, far below what a walk can reach.  What bounds the
// walks is the L1 and, behind it, the L2: the 2,073,600 walkers of the
// frame-width walk follow chains that converge (20,480 distinct rows at step
// 0, 1,259 at step 31), so a row is read many times, but a 128-walker block
// shares almost none (127.6 to 116.6 distinct rows a step): hits come from
// the SM's L1 as a whole.  Row 3's two walks are built for that:
//   thread-row  a thread owns its walker, 32 walkers a warp, as K4's rays.
//               Each step the warp moves its 32 walkers' rows one coalesced
//               row a load (lane l reads float4 l ^ j of walker j's row:
//               each quarter-warp one whole 128-byte line, where a thread
//               reading its own row touches 32 lines a load); the row ids
//               reach every lane through 128 bytes of shared memory a warp.
//               A mask of "float4 j holds +inf", OR-reduced over the warp
//               (redux), tells each walker whether its row holds +inf;
//               row[0] lands in the owner's own lane and row[48] in lane
//               owner ^ 12, one shuffle away.
//   warp-row    16 lanes a walker, two walkers a warp: a lane issues two
//               independent float4 loads a step, each load instruction
//               covers whole lines; one ballot finds +inf in a group, two
//               shuffles broadcast row[0] and row[48].  512-thread blocks:
//               each resident block reserves 1 KB of shared memory, so fewer
//               blocks leave more L1.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): the frame-width
// walks run at ~2.9 ms (thread-row) and ~2.7 ms (warp-row) against the L1
// ceiling's ~1.17 ms, set by what the L1 misses read from L2 (~6.8 TB/s).
// At the probe's 1,024 walkers thread-row has 32 warps, each moving 32 rows
// a step.  Every byte of a row that kinds 0 and 1 read feeds the walk: a row
// holding +inf would end it at row 0.  The probe's tables are finite, so
// that never happens, but without it the compiler would drop the loads whose
// values go unused and kind 0 would read what kind 2 reads.  A row id
// outside [0, N) stops its walker before the read (its final id is that id),
// and gather16 writes NaN for such an id: no read leaves the table.  The
// plain versions raise there instead; the two agree on every table whose ids
// are in range.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 128;  // thread-row: a block's threads, a walker each
constexpr int kGroup = 16;        // warp-row: lanes a walker
constexpr int kGroupThreads = 512;  // warp-row: a block's threads

__device__ __forceinline__ float4 ld_v4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float max4(float4 v) {
    return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ bool out_of_table(int idx, int n) {
    return (unsigned)idx >= (unsigned)n;
}

__global__ void __launch_bounds__(kRowThreads)
walk_thread_row(const float* __restrict__ tab, const int* __restrict__ idx0, int w, int steps,
                int n, int* out_idx, float* out_acc) {
    __shared__ __align__(16) int ids[kRowThreads];  // each warp's 32 row ids of a step
    const int lane = threadIdx.x & 31;
    int* warp_ids = ids + (threadIdx.x & ~31);
    const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
    if ((i & ~31ll) >= w) return;  // whole warps leave together
    const bool has = i < w;
    int idx = has ? idx0[i] : 0;
    float acc = 0.0f;
    bool alive = has && !out_of_table(idx, n);
    for (int s = 0; s < steps; ++s) {
        if (__ballot_sync(kFull, alive) == 0) break;
        // a stopped walker's row is read as row 0 (its own id may lie
        // outside the table), so no load is predicated; its lane ignores it
        warp_ids[lane] = alive ? idx : 0;
        __syncwarp();
        int r[32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const int4 t = reinterpret_cast<const int4*>(warp_ids)[q];
            r[4 * q] = t.x;
            r[4 * q + 1] = t.y;
            r[4 * q + 2] = t.z;
            r[4 * q + 3] = t.w;
        }
        __syncwarp();
        // load j moves walker j's row: lane l reads its float4 l ^ j (each
        // quarter-warp one whole line), so float4 0 (row[0]) lands in lane
        // j and float4 12 (row[48]) in lane j ^ 12
        float4 v[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) v[j] = ld_v4(tab + (size_t)r[j] * 128 + 4 * (lane ^ j));
        unsigned inf = 0;
        float r0 = 0.0f, x48 = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            inf |= (unsigned)(max4(v[j]) == CUDART_INF_F) << j;
            if (lane == j) r0 = v[j].x;
            if (lane == (j ^ 12)) x48 = v[j].x;
        }
        inf = __reduce_or_sync(kFull, inf);
        const float r48 = __shfl_xor_sync(kFull, x48, 12);
        if (alive) {
            acc = acc + r0;
            idx = (inf >> lane & 1) ? 0 : (int)r48;
            alive = !out_of_table(idx, n);
        }
    }
    if (has) {
        out_idx[i] = idx;
        out_acc[i] = acc;
    }
}

__global__ void __launch_bounds__(kGroupThreads)
walk_warp_row(const float* __restrict__ tab, const int* __restrict__ idx0, int w, int steps,
              int n, int* out_idx, float* out_acc) {
    constexpr int G = kGroup, kLoads = 32 / G;  // float4s a lane reads a step
    const int lane = threadIdx.x & 31, q = lane % G;
    const long long t = (long long)blockIdx.x * kGroupThreads + threadIdx.x;
    if ((t & ~31ll) / G >= w) return;  // whole warps leave together
    const long long wk = t / G;
    const bool has = wk < w;
    const unsigned group = ((1u << G) - 1u) << (lane & ~(G - 1));
    int idx = has ? idx0[wk] : 0;
    float acc = 0.0f;
    bool alive = has && !out_of_table(idx, n);
    for (int s = 0; s < steps; ++s) {
        float4 v[kLoads];
        const float* row = tab + (size_t)idx * 128 + 4 * q;
        bool inf = false;
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
            v[k] = alive ? ld_v4(row + 4 * G * k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            inf = inf || max4(v[k]) == CUDART_INF_F;
        }
        const bool any_inf = (__ballot_sync(kFull, inf) & group) != 0;
        // row[0] is float4 0 (the group's lane 0, load 0); row[48] is float4
        // 12 (lane 12 % G, load 12 / G)
        const float r0 = __shfl_sync(kFull, v[0].x, 0, G);
        const float r48 = __shfl_sync(kFull, v[12 / G].x, 12 % G, G);
        if (alive) {
            acc = acc + r0;
            idx = any_inf ? 0 : (int)r48;
            alive = !out_of_table(idx, n);
        }
    }
    if (has && q == 0) {
        out_idx[wk] = idx;
        out_acc[wk] = acc;
    }
}

__global__ void walk_chase(const float* __restrict__ tab, const int* __restrict__ idx0,
                           int w, int steps, int n, int* out_idx, float* out_acc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    int idx = idx0[i];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float* row = tab + (size_t)idx * 128;
        const float r0 = row[0], r48 = row[48];
        acc = acc + r0;
        idx = (int)r48;
    }
    out_idx[i] = idx;
    out_acc[i] = acc;
}

__global__ void walk_lane(const float* __restrict__ tab, const int* __restrict__ idx0,
                          int w, int steps, int n, int* out_idx, float* out_acc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    const int col = i & 127;
    int idx = idx0[i];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float v = tab[(size_t)idx * 128 + col];
        acc = acc + v;
        int m = (idx + (int)v * 7 + s) % n;  // floor modulo, as torch.remainder
        idx = m < 0 ? m + n : m;
    }
    out_idx[i] = idx;
    out_acc[i] = acc;
}

__global__ void walk_rows_acc(const float* __restrict__ tab, const int* __restrict__ idx0,
                              int w, int steps, int n, int* out_idx, float* out_acc) {
    const int lane = threadIdx.x & 31;
    const long long wk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (wk >= w) return;
    int idx = idx0[wk];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float4 v = ld_v4(tab + (size_t)idx * 128 + 4 * lane);
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
        idx = (int)__shfl_sync(0xffffffffu, v.x, 12);
    }
    reinterpret_cast<float4*>(out_acc)[wk * 32 + lane] = acc;
    if (lane == 0) out_idx[wk] = idx;
}

__global__ void gather16(const float4* __restrict__ img, int rows,
                         const int* __restrict__ idx, int n, float4* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int j = idx[i];
    out[i] = out_of_table(j, rows) ? make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                                 CUDART_NAN_F)
                                   : img[j];
}

// ---- the yardstick ---------------------------------------------------------
constexpr int kRateThreads = 512;
constexpr int kRateLoads = 4;  // 16-byte loads a thread a round, all in flight

// 16-byte loads the compiler may neither drop nor hoist out of the pass loop:
// .ca keeps the line in L1, .cg reads it from L2 and leaves L1 alone
template <bool kL1>
__device__ __forceinline__ uint4 ld_rate(const uint4* p) {
    uint4 v;
    if (kL1)
        asm volatile("ld.global.ca.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "l"(p));
    else
        asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "l"(p));
    return v;
}

// kL1: block b reads its slice of span uint4s (at (b % (n4 / span)) * span)
// `passes` times.  !kL1: the grid strides over all n4 uint4s `passes` times.
// span and n4 are multiples of kRateThreads * kRateLoads.  out[b]: the uint32
// sum of the bits the block read.
template <bool kL1>
__global__ void __launch_bounds__(kRateThreads)
read_rate(const uint4* __restrict__ tab, long long n4, int span, int passes, unsigned* out) {
    const int tid = threadIdx.x;
    const uint4* base = tab;
    long long len = n4, stride = (long long)gridDim.x * kRateThreads;
    long long start = (long long)blockIdx.x * kRateThreads + tid;
    if (kL1) {
        base = tab + (blockIdx.x % (n4 / span)) * (long long)span;
        len = span;
        stride = kRateThreads;
        start = tid;
    }
    unsigned acc = 0;
    for (int p = 0; p < passes; ++p) {
        for (long long e = start; e < len; e += stride * kRateLoads) {
            uint4 v[kRateLoads];
#pragma unroll
            for (int k = 0; k < kRateLoads; ++k)
                v[k] = e + k * stride < len ? ld_rate<kL1>(base + e + k * stride)
                                            : make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int k = 0; k < kRateLoads; ++k) acc += v[k].x + v[k].y + v[k].z + v[k].w;
        }
    }
    __shared__ unsigned part[kRateThreads / 32];
    acc = __reduce_add_sync(kFull, acc);
    if ((tid & 31) == 0) part[tid >> 5] = acc;
    __syncthreads();
    if (tid == 0) {
        unsigned sum = 0;
        for (int k = 0; k < kRateThreads / 32; ++k) sum += part[k];
        out[blockIdx.x] = sum;
    }
}

// One warp follows ring (next = ring[p]) from `start`: `warm` steps that
// bring the ring into the cache, then `steps` timed ones.  out[0]: the final
// position; out[1]: the timed steps' nanoseconds on the global timer.
template <bool kL1>
__global__ void chase_ring(const int* __restrict__ ring, int start, int warm, int steps,
                           long long* out) {
    int p = start;
    for (int s = 0; s < warm; ++s) {
        if (kL1)
            asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(p) : "l"(ring + p));
        else
            asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(p) : "l"(ring + p));
    }
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : : "memory");
    for (int s = 0; s < steps; ++s) {
        if (kL1)
            asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(p) : "l"(ring + p));
        else
            asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(p) : "l"(ring + p));
    }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "r"(p) : "memory");
    if (threadIdx.x == 0) {
        out[0] = p;
        out[1] = (long long)(t1 - t0);
    }
}

}  // namespace

extern "C" int probe_walk_launch(int kind, const float* tab, const int* idx0, int w,
                                 int steps, int n, int* out_idx, float* out_acc, int device,
                                 void* stream) {
    // kind: 0 thread-row, 1 warp-row, 2 chase, 3 lane, 4 warp rows-acc.
    // device: the tensors' card.
    if (w <= 0) return (int)cudaGetLastError();
    const DeviceGuard guard(device);
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 128;
    const long long warp_blocks = ((long long)w * 32 + threads - 1) / threads;
    const int blocks = (w + threads - 1) / threads;
    switch (kind) {
        case 0:
            walk_thread_row<<<(unsigned)((w + kRowThreads - 1) / kRowThreads), kRowThreads, 0,
                              st>>>(tab, idx0, w, steps, n, out_idx, out_acc);
            break;
        case 1: {
            const long long per = kGroupThreads / kGroup;
            walk_warp_row<<<(unsigned)((w + per - 1) / per), kGroupThreads, 0, st>>>(
                tab, idx0, w, steps, n, out_idx, out_acc);
            break;
        }
        case 2:
            walk_chase<<<blocks, threads, 0, st>>>(tab, idx0, w, steps, n, out_idx, out_acc);
            break;
        case 3:
            walk_lane<<<blocks, threads, 0, st>>>(tab, idx0, w, steps, n, out_idx, out_acc);
            break;
        case 4:
            walk_rows_acc<<<(unsigned)warp_blocks, threads, 0, st>>>(tab, idx0, w, steps, n,
                                                                     out_idx, out_acc);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" int probe_gather16_launch(const float* img, int rows, const int* idx, int n,
                                     float* out, int device, void* stream) {
    // img: rows 16-byte rows; out[i] = img[idx[i]]
    if (n > 0) {
        const DeviceGuard guard(device);
        const int threads = 256;
        gather16<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(img), rows, idx, n, reinterpret_cast<float4*>(out));
    }
    return (int)cudaGetLastError();
}

extern "C" int probe_read_rate_launch(int level, const float* tab, long long n4, int span,
                                      int passes, int blocks, unsigned* out, int device,
                                      void* stream) {
    // level 1: each block re-reads its slice of span 16-byte words from L1;
    // level 2: all blocks stride over the n4 words from L2.  n4 and span are
    // multiples of kRateThreads * kRateLoads (2,048 words, 32 KB).
    const long long chunk = (long long)kRateThreads * kRateLoads;
    if (blocks <= 0 || passes <= 0 || n4 <= 0 || n4 % chunk || span <= 0 || span % chunk ||
        span > n4 || (level != 1 && level != 2))
        return (int)cudaErrorInvalidValue;
    const DeviceGuard guard(device);
    cudaStream_t st = (cudaStream_t)stream;
    const uint4* t = reinterpret_cast<const uint4*>(tab);
    if (level == 1)
        read_rate<true><<<blocks, kRateThreads, 0, st>>>(t, n4, span, passes, out);
    else
        read_rate<false><<<blocks, kRateThreads, 0, st>>>(t, n4, span, passes, out);
    return (int)cudaGetLastError();
}

extern "C" int probe_latency_launch(int level, const int* ring, int start, int warm, int steps,
                                    long long* out, int device, void* stream) {
    // level 1: the ring read through L1 (.ca); level 2: from L2 (.cg)
    if (level != 1 && level != 2) return (int)cudaErrorInvalidValue;
    const DeviceGuard guard(device);
    cudaStream_t st = (cudaStream_t)stream;
    if (level == 1)
        chase_ring<true><<<1, 32, 0, st>>>(ring, start, warm, steps, out);
    else
        chase_ring<false><<<1, 32, 0, st>>>(ring, start, warm, steps, out);
    return (int)cudaGetLastError();
}
