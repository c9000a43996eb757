// Row-gather probes: the card's rate for data-dependent reads of an
// (N, 128) float32 table (the BVH8 table's shape), the counterparts of the
// TPU probes
//   scripts/bench_pallas_gather.py:88 pallas_vector_gather (row 3),
//   scripts/bench_pallas_gather.py:125 pallas_dyn_slice_loop (row 4),
//   scripts/bench_pallas_gather.py:157 pallas_take_along_axis (row 5),
//   scripts/probe_dyngather.py:63 (row 6).
// In the row walks column 48 of a row holds the next row's id, so each
// step's address depends on the previous step's load, as in K2's walk.  A
// walker returns its final row id and its own float32 sum of what it read,
// added in step order, so a kernel and its plain PyTorch version
// (probes/gather.py) agree bit for bit.
//
//   walk kind 0  thread-row: a thread owns its walker, as K4 (a thread a
//                ray) does, and needs its whole 512-byte row a step;
//   walk kind 1  warp-row: a group of kGroup lanes owns its walker, as K2
//                (four lanes a ray) does, the row read coalesced;
//   walk kind 2  chase: a thread per walker, only row[0] and row[48] (a
//                latency probe of the card; no TPU kernel computes it);
//   walk kind 3  lane, the per-lane gather: walker i reads tab[idx, i % 128]
//                and steps idx = (idx + (int)v * 7 + s) mod N;
//   walk kind 4  rows-acc, row 6's function: a warp per walker, the whole
//                row added into a 128-wide sum, the next row row[48] mod N;
//   walk kind 5  row-loop, row 4's function: walker i loads row[0] of row
//                idx0[i] `steps` times through L1 and adds each load to its
//                sum in step order; its id never changes, so the kernel
//                writes only the sums (the final ids are idx0 itself);
//   gather16     one independent gather of 16-byte rows out[i] = img[idx[i]]
//                (SSAO's and the PCF's taps);
//   read_rate    the yardstick: coalesced 16-byte reads of a slice a block
//                keeps in L1, or of the whole table from L2, many passes a
//                launch, their bits summed (uint32) so a plain sum checks them;
//   chase_ring   the yardstick's latency: one warp follows a pointer ring
//                resident in L1, in L2 or in shared memory, or takes
//                rows-acc's step (the load, F2I, the wrap, the address)
//                through L1, timed by the global timer;
//   stage_copy   the yardstick's staging time: one block's TMA bulk copy of
//                rows-acc's N = 256 table into its shared memory.
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
// values go unused and kind 0 would read what kind 2 reads.
//   row-loop    (row 4) the TPU kernel re-reads its walkers' rows every
//               step (its ids never change) and adds row[0]: W x steps
//               dynamic row loads from on-chip memory.  Here each of them
//               is an L1 load (ld.global.ca in asm volatile, at an address
//               ptxas cannot prove equal to another's), kRowLoopUnroll of a
//               walker's loads issued back to back so they arrive close
//               together, before other walkers' lines evict the row; only
//               the adds go in order.  So the walk measures scattered L1
//               hits, one 128-byte line a load.  Blocks are sized so the
//               walkers spread over every SM.
//   lane        (row 5) walker i reads only column i % 128: one column,
//               N x 4 bytes (80 KB at N = 20,480), fits a block's shared
//               memory, the card's counterpart of the TPU kernel's VMEM
//               table.  A block owns one column and a chunk of its walkers
//               and stages the column once with one TMA bulk copy; each step
//               reads shared memory.  A column's values, start ids and
//               outputs lie 512 bytes apart (walker i's neighbours belong to
//               other columns), so the launch transposes the table and the
//               ids into column-major scratch first and the outputs back
//               last (32x32 tiles, both sides coalesced): read where they
//               lie, each value would cost a 32-byte sector.  The floor
//               modulo takes one compare and one add or subtract while
//               |(int)v * 7 + s| < N; at the first step where it is not, a
//               second loop finishes the walk with the `%`.  It equals
//               torch.remainder on every int32.  The wrapper refuses a table
//               whose column does not fit (LANE_MAX_ROWS rows).  The launch
//               takes its scratch stream-ordered from a pool of its own per
//               card, which keeps the memory across calls.
//   rows-acc    (row 6) S = 8 walkers of 512 steps: each walker's steps are
//               one chain of dependent loads, so its time is latency, not
//               bytes.  A step's chain is the id's load (4 bytes every
//               lane reads, a broadcast) and fast_row, three fixed-latency
//               operations from row[48] to the next row's address: no F2I,
//               no shuffle, no branch, and no wait for the row's float4,
//               which is added a step or more after its load.  A walk that
//               met an id that is no row of the table walks again by the
//               rule (F2I and the floor modulo).  The walkers' chains meet,
//               so eight walkers a block share an SM's L1: a row one loaded
//               is an L1 hit for the others.  Where the whole table fits a
//               block's shared memory (N <= 453, the TPU probe's N = 256)
//               each walker's block stages it with one TMA bulk copy and
//               walks shared memory.  Ids wrap as the TPU op's: row v mod N
//               (floor), v = (int)row[48] truncated and saturated (NaN 0),
//               the final id unreduced.
// In kinds 0-3 and 5 a row id outside [0, N) stops its walker before the
// read (its final id is that id; a walker stopped at its start has sum 0;
// the lane walk's later ids are mod N and stay in the table), and gather16
// writes NaN for such an id: no read leaves the table.  The plain versions
// of kinds 0, 1, 2, 5 and gather16 raise there instead; the two agree on
// every table whose ids are in range.  rows-acc's plain version wraps as
// its kernel does.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 128;  // thread-row: a block's threads, a walker each
constexpr int kGroup = 16;        // warp-row: lanes a walker
constexpr int kGroupThreads = 512;  // warp-row: a block's threads
constexpr int kRowLoopUnroll = 16;  // row-loop: a walker's loads in flight at once
constexpr int kRowLoopThreads = 128;  // row-loop: the most threads a block
constexpr int kLaneCols = 128;      // lane: the table's columns, walker i reads i % 128
constexpr int kLaneThreads = 1024;  // lane: a block's threads
constexpr int kLaneChunk = 2048;    // lane: a column's walkers a block
// Hopper's 227 KB of shared memory a block, and what a staged table may take
// of it: all but 16 bytes for the staging barrier
constexpr int kBlockSmem = 232448;
constexpr int kStageMaxBytes = kBlockSmem - 16;
constexpr int kLaneMaxRows = kStageMaxBytes / 4;     // lane: a column, 58,108 rows
constexpr int kStageMaxRows = kStageMaxBytes / 512;  // rows-acc's staged table, 453 rows
// rows-acc's walkers a block on the global route: eight, so walkers whose
// chains meet share an SM's L1 (a row one of them loaded is an L1 hit for
// the others).  The staged route takes one (each block reads its own copy
// of the table).
constexpr int kRowsAccPerBlock = 8;

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

// The lane walk's transposes of 4-byte values, 32x32 tiles through shared
// memory, both sides coalesced: dst[c * ld + r] = src[r * cols + c] for r <
// rows, c < cols, where the source index is below src_n and the destination
// index below dst_n.  blockIdx.z picks one of two (src, dst) pairs.
__global__ void __launch_bounds__(256)
transpose32(const unsigned* __restrict__ src0, const unsigned* __restrict__ src1, int rows,
            int cols, long long src_n, unsigned* __restrict__ dst0, unsigned* __restrict__ dst1,
            long long ld, long long dst_n) {
    __shared__ unsigned tile[32][33];
    const unsigned* src = blockIdx.z ? src1 : src0;
    unsigned* dst = blockIdx.z ? dst1 : dst0;
    const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
    const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
        const long long r = r0 + ty + j, c = c0 + tx, at = r * cols + c;
        if (r < rows && c < cols && at < src_n) tile[ty + j][tx] = src[at];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 32; j += 8) {
        const long long r = r0 + tx, c = c0 + ty + j, at = c * ld + r;
        if (r < rows && c < cols && at < dst_n) dst[at] = tile[tx][ty + j];
    }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// thread 0's part of one TMA bulk copy into shared memory: the barrier
// (initialised by mbar_init, count 1) expects `bytes` and the copy of
// `bytes` (a multiple of 16) from global src to shared dst completes them
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
    if (bytes > 0)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(smem_u32(bar))
            : "memory");
}

// every thread waits for the barrier's phase `parity` to complete
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    unsigned done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Block x owns column x and chunk y of its walkers i = x + 128 k, k in
// [y * kLaneChunk, ..).  It stages its column (ld floats of `cols`, the
// table's columns as rows) into shared memory with one TMA bulk copy, then
// a thread walks its walkers one after another, reading start ids from
// `ids` and writing final ids and sums to `res_idx` / `res_acc` (k-major
// rows of kc values a column, both coalesced).  The step's floor modulo: a
// first loop takes one compare and one add or subtract a step while
// |(int)v * 7 + s| < n and leaves at the first step where it is not; a
// second loop finishes the walk with the `%`.  Both wrap as PyTorch's int32
// tensors do.
__global__ void __launch_bounds__(kLaneThreads, 2)
walk_lane(const float* __restrict__ cols, int ld, const int* __restrict__ ids, int kc, int w,
          int steps, int n, int* __restrict__ res_idx, float* __restrict__ res_acc) {
    extern __shared__ __align__(16) float col[];
    __shared__ unsigned long long bar;
    const int c = blockIdx.x;
    if (threadIdx.x == 0) mbar_init(&bar);
    __syncthreads();
    if (threadIdx.x == 0) bulk_copy(col, cols + (size_t)c * ld, (unsigned)ld * 4u, &bar);
    mbar_wait(&bar, 0);
    const int k0 = blockIdx.y * kLaneChunk;
    const int k1 = kc < k0 + kLaneChunk ? kc : k0 + kLaneChunk;
    for (int k = k0 + threadIdx.x; k < k1; k += kLaneThreads) {
        if (c + (long long)kLaneCols * k >= w) break;
        const size_t at = (size_t)c * kc + k;
        int idx = ids[at];
        float acc = 0.0f;
        int s = 0;
        if (!out_of_table(idx, n)) {
            for (; s < steps; ++s) {
                const float v = col[idx];
                // (int)v * 7 + s, wrapped
                const int d = (int)((unsigned)__float2int_rz(v) * 7u + (unsigned)s);
                if ((unsigned)d + (unsigned)(n - 1) > 2u * (unsigned)(n - 1)) break;
                acc = acc + v;
                const int m = idx + d;  // in (-n, 2n)
                idx = m >= n ? m - n : (m < 0 ? m + n : m);
            }
            for (; s < steps; ++s) {
                const float v = col[idx];
                acc = acc + v;
                const int d = (int)((unsigned)__float2int_rz(v) * 7u + (unsigned)s);
                const int r = (int)((unsigned)idx + (unsigned)d) % n;
                idx = r < 0 ? r + n : r;
            }
        }
        res_idx[at] = idx;
        res_acc[at] = acc;
    }
}

// row[0] through L1 (.ca), in asm volatile so the compiler keeps the load
__device__ __forceinline__ float ld_ca(const float* p) {
    float v;
    asm volatile("ld.global.ca.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}

__global__ void __launch_bounds__(kRowLoopThreads)
walk_row_loop(const float* __restrict__ tab, const int* __restrict__ idx0, int w, int steps,
              int n, float* out_acc) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    const int idx = idx0[i];
    float acc = 0.0f;
    if (!out_of_table(idx, n)) {
        const float* row = tab + (size_t)idx * 128;
        // gridDim.z is 1: a zero ptxas cannot see, so step s loads from
        // row + s * zero, an address of its own, and ptxas merges no two of
        // the loads (with one address it kept one load of every 16)
        const size_t zero = gridDim.z - 1;
        int s = 0;
        for (; s + kRowLoopUnroll <= steps; s += kRowLoopUnroll) {
            float v[kRowLoopUnroll];
#pragma unroll
            for (int k = 0; k < kRowLoopUnroll; ++k) v[k] = ld_ca(row + (s + k) * zero);
#pragma unroll
            for (int k = 0; k < kRowLoopUnroll; ++k) acc = acc + v[k];
        }
        for (; s < steps; ++s) acc = acc + ld_ca(row + s * zero);
    }
    out_acc[i] = acc;
}

__device__ __forceinline__ void add4(float4& acc, float4 v) {
    acc.x = acc.x + v.x;
    acc.y = acc.y + v.y;
    acc.z = acc.z + v.z;
    acc.w = acc.w + v.w;
}

// floor modulo into [0, n) for n >= 1: the `%` path of rows-acc's wrap
__device__ __forceinline__ int wrap_row(int v, int n) {
    if ((unsigned)v < (unsigned)n) return v;
    const int m = v % n;
    return m < 0 ? m + n : m;
}

// rows-acc's next row from x = row[48] in three fixed-latency operations:
// y = x + 1.5 * 2^23 puts an integer x in [0, 2^22) into y's low bits, so
// bits(y) - bits(1.5 * 2^23) is the row, and its minimum with n - 1 (one
// add-and-min) a row of the table whatever x is.  `exact` (0 <= x < lim =
// min(n, 2^22) and y - 1.5 * 2^23 == x, float compares off the chain) holds
// iff x is an integer in [0, lim), where the row is the rule's.
constexpr float kMagic = 12582912.0f;       // 1.5 * 2^23
constexpr unsigned kMagicBits = 0x4B400000u;  // its bits

__device__ __forceinline__ unsigned fast_row(float x, int n, float lim, bool& exact) {
    const float y = x + kMagic;
    exact = x >= 0.0f && x < lim && y - kMagic == x;
    return min(__float_as_uint(y) - kMagicBits, (unsigned)n - 1u);
}

// a row's row[48] and its float4 (this lane's), the id first so that it
// does not queue behind the row's four lines (ptxas schedules them: it
// issues a row's float4 a few steps after its id, and chip_smoke.py's SASS
// check holds that no read of a row delays the chain).  asm volatile: the
// compiler neither merges nor sinks them.  Global: through L1 (.nc, the
// read-only path), from the table and from the lane's column; staged:
// shared memory.
template <bool kStaged>
__device__ __forceinline__ void load_row(const float* g_row, const float* g_lane, unsigned s_row,
                                         unsigned s_lane, unsigned r, float4& v, float& next) {
    if (kStaged) {
        asm volatile("ld.shared.f32 %0, [%1+192];" : "=f"(next) : "r"(s_row + r * 512u));
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "r"(s_lane + r * 512u));
    } else {
        asm volatile("ld.global.nc.f32 %0, [%1+192];" : "=f"(next) : "l"(g_row + (size_t)r * 128));
        asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                     : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                     : "l"(g_lane + (size_t)r * 128));
    }
}

// One walker's `steps` steps from id v (its final id back in v), its sums
// added to acc in step order.  kRule: each next row by the rule itself,
// __float2int_rz then wrap_row.  Otherwise by fast_row, with no branch;
// returns whether every id was exact (fast_row's row is then the rule's).
// Two steps an iteration, so the float4 `a` and `b` trade places without a
// copy: a copy of a row's float4 would wait for its load.
template <bool kStaged, bool kRule>
__device__ __forceinline__ bool walk_rows(const float* g_row, const float* g_lane, unsigned s_row,
                                          unsigned s_lane, int n, int steps, int& v,
                                          float4& acc) {
    const float lim = (float)min(n, 1 << 22);
    bool all_exact = true;
    auto next_row = [&](float x) {
        if constexpr (kRule) return (unsigned)wrap_row(__float2int_rz(x), n);
        bool exact;
        const unsigned r = fast_row(x, n, lim, exact);
        all_exact = all_exact && exact;
        return r;
    };
    float4 a, b;
    float next;
    load_row<kStaged>(g_row, g_lane, s_row, s_lane, (unsigned)wrap_row(v, n), a, next);
    int s = 1;
    for (; s + 2 <= steps; s += 2) {
        load_row<kStaged>(g_row, g_lane, s_row, s_lane, next_row(next), b, next);
        add4(acc, a);
        load_row<kStaged>(g_row, g_lane, s_row, s_lane, next_row(next), a, next);
        add4(acc, b);
    }
    if (s < steps) {
        load_row<kStaged>(g_row, g_lane, s_row, s_lane, next_row(next), b, next);
        add4(acc, a);
        a = b;
    }
    add4(acc, a);
    v = __float2int_rz(next);
    return all_exact;
}

// Rows-acc: warp wk walks from row idx0[wk] mod n; each step reads row
// r = v mod n whole (a float4 a lane), adds it to the warp's 128 sums and
// takes v = __float2int_rz(row[48]) (truncated, saturated to int32, NaN 0:
// jnp's astype).  The final id is the last v, unreduced.  The next id's load
// is a 4-byte load every lane makes of one address (a broadcast), and the
// row's float4 is added a step or more after its load, once the next ids'
// loads are issued; the next row comes from row[48] by fast_row, so the
// chain a step waits on is the id's load and three fixed-latency
// operations (no F2I, no shuffle, no branch).  A walk
// that met an id fast_row does not take exactly (an id outside [0, n), or
// no integer) is walked again by the rule itself.  kStaged: the block first
// copies the whole table (n * 512 bytes) into its shared memory with one
// TMA bulk copy and walks it there.  blockDim.x / 32 walkers a block.
template <bool kStaged>
__global__ void __launch_bounds__(32 * kRowsAccPerBlock)
walk_rows_acc(const float* __restrict__ tab, const int* __restrict__ idx0, int w, int steps,
              int n, int* out_idx, float* out_acc) {
    extern __shared__ __align__(16) float staged[];
    __shared__ unsigned long long bar;
    if (kStaged) {
        if (threadIdx.x == 0) mbar_init(&bar);
        __syncthreads();
        if (threadIdx.x == 0) bulk_copy(staged, tab, (unsigned)n * 512u, &bar);
        mbar_wait(&bar, 0);
    }
    const int lane = threadIdx.x & 31;
    const long long wk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (wk >= w) return;
    // the lane's column as a base of its own: ptxas would otherwise add
    // 16 * lane to the row's address, two more instructions a step
    const float* g_lane = tab + 4 * lane;
    asm volatile("" : "+l"(g_lane));
    const unsigned s_row = smem_u32(staged), s_lane = s_row + 16u * (unsigned)lane;
    int v = idx0[wk];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (steps > 0 &&
        !walk_rows<kStaged, false>(tab, g_lane, s_row, s_lane, n, steps, v, acc)) {
        v = idx0[wk];
        acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        walk_rows<kStaged, true>(tab, g_lane, s_row, s_lane, n, steps, v, acc);
    }
    reinterpret_cast<float4*>(out_acc)[wk * 32 + lane] = acc;
    if (lane == 0) out_idx[wk] = v;
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
// kLevel 1: through L1 (.ca); 2: from L2 (.cg); 3: from shared memory (the
// warp first copies the `len`-int ring there); 4: rows-acc's step through
// L1 (step_ring); 5: the same step with __float2int_rz and a compare and
// branch before the next load (the wrap as the chain would take it without
// fast_row).
template <int kLevel>
__device__ __forceinline__ int ring_step(const int* ring, unsigned sring, int p, int len) {
    int q;
    if (kLevel == 1) {
        asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(q) : "l"(ring + p));
    } else if (kLevel == 5) {
        float x;
        asm volatile("ld.global.ca.f32 %0, [%1];" : "=f"(x) : "l"(ring + p));
        q = wrap_row(__float2int_rz(x), len);
    } else if (kLevel == 2) {
        asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(q) : "l"(ring + p));
    } else {
        asm volatile("ld.shared.s32 %0, [%1];" : "=r"(q) : "r"(sring + 4u * (unsigned)p));
    }
    return q;
}

// `steps` steps of rows-acc's chain over the ring's entries read as float32
// (exact ints) through L1: the next entry's load issues from fast_row's row,
// with no branch, as in walk_rows_acc.  One load more than steps (the
// first); returns the position after `steps`, or -1 if an entry was not
// exact.
__device__ __forceinline__ int step_ring(const int* ring, int len, int p, int steps) {
    const float lim = (float)min(len, 1 << 22);
    bool all_exact = true;
    float x;
    asm volatile("ld.global.ca.f32 %0, [%1];" : "=f"(x) : "l"(ring + p));
    for (int s = 0; s < steps; ++s) {
        bool exact;
        p = (int)fast_row(x, len, lim, exact);
        all_exact = all_exact && exact;
        asm volatile("ld.global.ca.f32 %0, [%1];" : "=f"(x) : "l"(ring + p));
    }
    return all_exact ? p : -1;
}

template <int kLevel>
__global__ void chase_ring(const int* __restrict__ ring, int len, int start, int warm, int steps,
                           long long* out) {
    extern __shared__ __align__(16) int sring[];
    if (kLevel == 3) {
        for (int i = threadIdx.x; i < len; i += blockDim.x) sring[i] = ring[i];
        __syncwarp();
    }
    const unsigned sbase = smem_u32(sring);
    int p = start;
    if (kLevel == 4)
        p = step_ring(ring, len, p, warm);
    else
        for (int s = 0; s < warm; ++s) p = ring_step<kLevel>(ring, sbase, p, len);
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : : "memory");
    if (kLevel == 4)
        p = p < 0 ? p : step_ring(ring, len, p, steps);
    else
        for (int s = 0; s < steps; ++s) p = ring_step<kLevel>(ring, sbase, p, len);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : "r"(p) : "memory");
    if (threadIdx.x == 0) {
        out[0] = p;
        out[1] = (long long)(t1 - t0);
    }
}

// The yardstick's staging time: one block copies `bytes` of tab into its
// shared memory with one TMA bulk copy, waits for it, `reps` times in turn
// (rows-acc's staged route makes one).  out[0]: the uint32 sum of the
// staged words' bits; out[1]: the copies' nanoseconds on the global timer.
__global__ void __launch_bounds__(256)
stage_copy(const float* __restrict__ tab, unsigned bytes, int reps, long long* out) {
    extern __shared__ __align__(16) unsigned staged_words[];
    __shared__ unsigned long long bar;
    __shared__ unsigned part[8];
    if (threadIdx.x == 0) mbar_init(&bar);
    __syncthreads();
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0) : : "memory");
    for (int r = 0; r < reps; ++r) {
        if (threadIdx.x == 0) bulk_copy(staged_words, tab, bytes, &bar);
        mbar_wait(&bar, (unsigned)r & 1u);
    }
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1) : : "memory");
    unsigned acc = 0;
    for (unsigned i = threadIdx.x; i < bytes / 4; i += blockDim.x) acc += staged_words[i];
    acc = __reduce_add_sync(kFull, acc);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned sum = 0;
        for (int k = 0; k < (int)(blockDim.x >> 5); ++k) sum += part[k];
        out[0] = sum;
        out[1] = (long long)(t1 - t0);
    }
}

// lane's scratch comes from a pool per card that keeps its memory (a
// release threshold of all of it), so a call maps none after the first
cudaError_t lane_pool(int device, cudaMemPool_t* pool) {
    static cudaMemPool_t pools[64];
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (!pools[device]) {
        cudaMemPoolProps props = {};
        props.allocType = cudaMemAllocationTypePinned;
        props.location.type = cudaMemLocationTypeDevice;
        props.location.id = device;
        cudaMemPool_t made;
        cudaError_t err = cudaMemPoolCreate(&made, &props);
        if (err != cudaSuccess) return err;
        unsigned long long keep = ~0ull;
        err = cudaMemPoolSetAttribute(made, cudaMemPoolAttrReleaseThreshold, &keep);
        if (err != cudaSuccess) return err;
        pools[device] = made;
    }
    *pool = pools[device];
    return cudaSuccess;
}

// Lets the kernels that stage into more than 48 KB of dynamic shared memory
// take what a block has beside their static shared memory, on the current
// card, `device`: once a card.
cudaError_t allow_block_smem(int device) {
    static bool done[64];
    if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
    if (done[device]) return cudaSuccess;
    const void* kernels[] = {reinterpret_cast<const void*>(walk_lane),
                             reinterpret_cast<const void*>(walk_rows_acc<true>),
                             reinterpret_cast<const void*>(chase_ring<3>),
                             reinterpret_cast<const void*>(stage_copy)};
    for (const void* kernel : kernels) {
        cudaFuncAttributes attr;
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kBlockSmem - (int)attr.sharedSizeBytes);
        if (err != cudaSuccess) return err;
    }
    done[device] = true;
    return cudaSuccess;
}

// rows-acc: where the table fits a block's shared memory (n <=
// kStageMaxRows) a walker a block, each block staging the table; else
// kRowsAccPerBlock walkers a block through L1
int rows_acc_launch(const float* tab, const int* idx0, int w, int steps, int n, int* out_idx,
                    float* out_acc, int device, cudaStream_t st) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    if (w <= 0) return (int)cudaGetLastError();
    const DeviceGuard guard(device);
    if (n <= kStageMaxRows) {
        const cudaError_t err = allow_block_smem(device);
        if (err != cudaSuccess) return (int)err;
        walk_rows_acc<true><<<(unsigned)w, 32, (size_t)n * 512, st>>>(tab, idx0, w, steps, n,
                                                                      out_idx, out_acc);
    } else {
        walk_rows_acc<false><<<(unsigned)((w + kRowsAccPerBlock - 1) / kRowsAccPerBlock),
                               32 * kRowsAccPerBlock, 0, st>>>(tab, idx0, w, steps, n, out_idx,
                                                               out_acc);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_walk_launch(int kind, const float* tab, const int* idx0, int w,
                                 int steps, int n, int* out_idx, float* out_acc, int device,
                                 void* stream) {
    // kind: 0 thread-row, 1 warp-row, 2 chase, 3 lane (n <= kLaneMaxRows),
    // 4 rows-acc (n >= 1; out_acc (w, 128)), 5 row-loop (writes out_acc
    // only: its ids are idx0).  device: the tensors' card.
    if (kind == 3 && (n < 0 || n > kLaneMaxRows)) return (int)cudaErrorInvalidValue;
    if (kind == 4) return rows_acc_launch(tab, idx0, w, steps, n, out_idx, out_acc, device,
                                          (cudaStream_t)stream);
    if (w <= 0) return (int)cudaGetLastError();
    const DeviceGuard guard(device);
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 128;
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
        case 3: {
            // scratch, 4-byte values: the table's columns as 128 rows of ld
            // = n rounded up to 4, then the start ids, final ids and sums as
            // 128 rows of kc = ceil(w / 128): four launches, the transposes
            // in and out and the walk
            cudaMemPool_t pool;
            cudaError_t err = lane_pool(device, &pool);
            if (err == cudaSuccess) err = allow_block_smem(device);
            if (err != cudaSuccess) return (int)err;
            const int ld = (n + 3) / 4 * 4;
            const int kc = (int)(((long long)w + kLaneCols - 1) / kLaneCols);
            void* scratch = nullptr;
            err = cudaMallocFromPoolAsync(
                &scratch, ((size_t)kLaneCols * ld + 3ull * kLaneCols * kc) * 4, pool, st);
            if (err != cudaSuccess) return (int)err;
            unsigned* cols = reinterpret_cast<unsigned*>(scratch);
            unsigned* ids = cols + (size_t)kLaneCols * ld;
            unsigned* res_idx = ids + (size_t)kLaneCols * kc;
            unsigned* res_acc = res_idx + (size_t)kLaneCols * kc;
            const long long tab_n = (long long)n * kLaneCols, res_n = (long long)kLaneCols * kc;
            if (n > 0)
                transpose32<<<dim3(kLaneCols / 32, (unsigned)((n + 31) / 32), 1), 256, 0, st>>>(
                    reinterpret_cast<const unsigned*>(tab), nullptr, n, kLaneCols, tab_n, cols,
                    nullptr, ld, (long long)kLaneCols * ld);
            transpose32<<<dim3(kLaneCols / 32, (unsigned)((kc + 31) / 32), 1), 256, 0, st>>>(
                reinterpret_cast<const unsigned*>(idx0), nullptr, kc, kLaneCols, w, ids, nullptr,
                kc, res_n);
            const dim3 grid(kLaneCols, (unsigned)((kc + kLaneChunk - 1) / kLaneChunk));
            walk_lane<<<grid, kLaneThreads, (size_t)ld * 4, st>>>(
                reinterpret_cast<const float*>(cols), ld, reinterpret_cast<const int*>(ids), kc,
                w, steps, n, reinterpret_cast<int*>(res_idx), reinterpret_cast<float*>(res_acc));
            transpose32<<<dim3((unsigned)((kc + 31) / 32), kLaneCols / 32, 2), 256, 0, st>>>(
                res_idx, res_acc, kLaneCols, kc, res_n, reinterpret_cast<unsigned*>(out_idx),
                reinterpret_cast<unsigned*>(out_acc), kLaneCols, w);
            err = cudaGetLastError();
            const cudaError_t freed = cudaFreeAsync(scratch, st);
            return (int)(err != cudaSuccess ? err : freed);
        }
        case 5: {
            // spread the walkers over every SM: a block of at most
            // kRowLoopThreads, a multiple of 8 threads
            int sms = 0;
            const cudaError_t err =
                cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
            if (err != cudaSuccess) return (int)err;
            int per = (int)(((long long)w + sms - 1) / sms);
            per = (per + 7) / 8 * 8;
            const int rl_threads = per < kRowLoopThreads ? per : kRowLoopThreads;
            walk_row_loop<<<(unsigned)(((long long)w + rl_threads - 1) / rl_threads), rl_threads,
                            0, st>>>(tab, idx0, w, steps, n, out_acc);
            break;
        }
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

extern "C" int probe_latency_launch(int level, const int* ring, int len, int start, int warm,
                                    int steps, long long* out, int device, void* stream) {
    // level 1: the ring read through L1 (.ca); 2: from L2 (.cg); 3: from
    // shared memory (len * 4 bytes at most 227 KB); 4: rows-acc's step
    // through L1 (the ring's entries as float32); 5: that step with
    // __float2int_rz and the wrap's branch before the next load
    if (level < 1 || level > 5 || len < 1 || (level == 3 && len > kBlockSmem / 4))
        return (int)cudaErrorInvalidValue;
    const DeviceGuard guard(device);
    cudaStream_t st = (cudaStream_t)stream;
    switch (level) {
        case 1:
            chase_ring<1><<<1, 32, 0, st>>>(ring, len, start, warm, steps, out);
            break;
        case 2:
            chase_ring<2><<<1, 32, 0, st>>>(ring, len, start, warm, steps, out);
            break;
        case 3: {
            const cudaError_t err = allow_block_smem(device);
            if (err != cudaSuccess) return (int)err;
            chase_ring<3><<<1, 32, (size_t)len * 4, st>>>(ring, len, start, warm, steps, out);
            break;
        }
        case 4:
            chase_ring<4><<<1, 32, 0, st>>>(ring, len, start, warm, steps, out);
            break;
        default:
            chase_ring<5><<<1, 32, 0, st>>>(ring, len, start, warm, steps, out);
    }
    return (int)cudaGetLastError();
}

extern "C" int probe_stage_launch(const float* tab, int bytes, int reps, long long* out,
                                  int device, void* stream) {
    // one block stages `bytes` (a multiple of 16, at most kStageMaxRows rows)
    // of tab into its shared memory `reps` times
    if (bytes < 16 || bytes % 16 || bytes > kStageMaxRows * 512 || reps < 1)
        return (int)cudaErrorInvalidValue;
    const DeviceGuard guard(device);
    const cudaError_t err = allow_block_smem(device);
    if (err != cudaSuccess) return (int)err;
    stage_copy<<<1, 256, (size_t)bytes, (cudaStream_t)stream>>>(tab, (unsigned)bytes, reps, out);
    return (int)cudaGetLastError();
}
