// K3: any-hit shadow rays through the light-space shadow grid.
//
// Replaces the XLA while_loop of vulkanhybridrenderer_tpu/ops/shadowgrid.py
// trace_shadow (:229-319), which steps every ray of a strip through its
// cell's entry list in lockstep, one gather of an entry row a step, then
// scans the big tier.  As eager PyTorch that loop would be a round of
// launches a step, so it gets a kernel for the same reason K2 did.  The
// semantics are the reference's:
//   * a ray's cell is the floor of its origin's light-frame (u, v) relative
//     to the grid window, times 1 / cell size, clamped to the grid; the
//     projections round every product, as ops/shadowgrid.origin_cells does;
//   * Moller-Trumbore without culling, in K2's operation order, over the
//     cell's entry rows [v0.xyz v1.xyz v2.xyz tri_id 0 0], at most
//     max_steps of them, and over the num_big rows of the big tier (num_big a
//     device int32, as the grid's static build leaves it);
//   * a hit needs tri >= 0, tmin <= t <= tmax and, with the alpha tables,
//     alpha_accept (alpha_filter.cuh, shared with K2); the ray stops at the
//     first;
//   * a ray with tmax < tmin tests nothing and misses.
// A ray tests the same set of rows in either order of the two lists, so the
// mask is the reference's bit for bit in both.
//
// What bounds it on this card: operations.  A test costs what its early
// return leaves of K2's 59 FP32 operations a triangle: 21 when it ends at
// det, 33 at u, 51 at v, 59 in full (chip_smoke.K3_OPS_STAGE), counted in
// the order this kernel walks by trace_shadow_plain(..., visits=True,
// big_first=True, stages=True).  The bytes (tmax and a byte out a ray, the
// live rays' origins and directions, the offsets of their cells and each
// row the walks reach, once) take a fraction of that.  The design:
//   * a block of kThreads takes a kTileW x kTileH pixel tile (without the
//     image's width, kMaxRays consecutive rays), drops its dead rays and
//     queues the live ones' ids in shared memory, in order (ballot and
//     popc), each with its cell's slot.  The tile is read in kFootW x kFootH
//     footprints, so 32 neighbouring queue slots hold neighbouring pixels;
//   * the block's distinct cells (a shared-memory hash, one insert per warp
//     and cell by __match_any_sync) get the heads of their entry lists
//     staged in dynamic shared memory by TMA bulk copies: stage_rows rows
//     shared equally among the cells, the rest of a longer list read from
//     device memory (with an L1 prefetch a few rows ahead).  The big tier
//     is staged the same way at the block's start, so its rows arrive
//     while the queue is built; the walk starts when both have landed;
//   * each lane walks one ray, the big tier first (on a closed hall the
//     roof, a big row, occludes nearly every ray: a live ray of
//     SponzaProxy's 1080p frame tests 18.4 rows instead of 55), and takes
//     the next queued ray (a warp-aggregated atomic on the queue's head;
//     its origin, direction, tmin and tmax from device memory, where the
//     queueing read them) once its ray has ended: between two refills a
//     lane tests up to kChunk rows of one memory, so the warp votes once
//     a chunk, not once a row.  A warp retires when the queue is empty;
//   * Moller-Trumbore returns as soon as its answer is known (after det,
//     after u, after v): every value it keeps is the full test's, computed
//     by the same operations in the same order, so the answer is the same.
// With `stats`, each warp adds the rows its lanes tested and 32 times the
// most any lane tested in each step: the share of busy lanes the queue
// keeps.  On the 1080p wavefronts the queue keeps more lanes busy than
// pixel-order warps do, but its setup and refills cost more than that
// gains: a thread-a-ray walk in 8 x 4 pixel warps measured faster (PERF.md
// §6).
//
// Built with --fmad=false, so the hit masks equal the plain PyTorch version
// (ops/shadowgrid.trace_shadow_plain) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_filter.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32, kTileH = 8;  // a block's pixels
constexpr int kFootW = 8, kFootH = 4;   // the pixels of 32 consecutive queue slots
constexpr int kMaxRays = kTileW * kTileH;
constexpr int kPer = kMaxRays / kThreads;  // rays a thread loads
constexpr int kHashBits = 8;
constexpr int kHash = 1 << kHashBits;  // >= kMaxRays: every distinct cell finds a slot
constexpr int kSlotsPer = kHash / kThreads;
constexpr int kBigCap = 128;  // ops/shadowgrid.BIG_CAP
constexpr int kPrefetch = 4;  // rows ahead of the walk an L1 prefetch asks for
constexpr int kChunk = 16;    // rows a lane tests between two of its warp's refills
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileW % kFootW == 0 && kFootW * kFootH == 32 && kMaxRays % kThreads == 0 &&
                  kHash >= kMaxRays,
              "a tile is whole footprints, a thread loads whole rays");

// The block's shared memory: this, then kBigCap rows for the big tier (its
// first num_big filled), then stage_rows rows of cell lists (dynamic, 48
// bytes a row).  Sized without num_big, which only the device knows.
struct Shared {
    int rid[kMaxRays];         // a queued ray's id
    int slot[kMaxRays];        // its cell's slot
    int key[kHash];            // a slot's cell, -1 when free
    int first[kHash];          // the cell's first entry row
    int count[kHash];          // the rows a ray of the cell tests, min(count, max_steps)
    int stage[kHash];          // the cell's index, then its list's first staged row
    int staged[kHash];         // how many rows of its list are staged
    unsigned long long bar_big, bar_cells;
    int warp_cnt[2][kWarps];
    int head, ncells, stage_bytes, num_big;
};
constexpr int kRowsOffset = (int)((sizeof(Shared) + 15) / 16 * 16);  // the rows follow

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(1)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar) {
    // every barrier here completes one phase: wait for parity 0
    unsigned done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_u32(bar))
            : "memory");
    } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to this block's shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// Moller-Trumbore of one entry row (read as two float4 and a float2: v0
// v1.x | v1.yz v2.xy | v2.z tri; the row's last two floats unread) against
// the ray, each product rounded: the hit's (t, u, v) when it is a geometric
// hit with tmin <= t <= tmax and tri >= 0.  It returns at the first failed
// test.
__device__ __forceinline__ bool row_hit(float4 a, float4 b, float2 c, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float tmin,
                                        float tmax, int& tri, float& u, float& v) {
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w - v0x, e1y = b.x - v0y, e1z = b.y - v0z;
    const float e2x = b.z - v0x, e2y = b.w - v0y, e2z = c.x - v0z;
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    if (!(fabsf(det) > 1e-9f)) return false;
    const float invdet = 1.0f / det;
    const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
    u = (tvx * px + tvy * py + tvz * pz) * invdet;
    // u > 1 fails u + v <= 1 for every v >= 0: a sum of non-negative floats
    // rounds to no less than either term
    if (!(u >= 0.0f && u <= 1.0f)) return false;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    v = (dx * qx + dy * qy + dz * qz) * invdet;
    if (!(v >= 0.0f && u + v <= 1.0f)) return false;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
    tri = (int)c.y;
    return tri >= 0 && t >= tmin && t <= tmax;
}

__device__ __forceinline__ int cell_coord(float p, float o, float inv, int grid) {
    // floor, clamped to the grid before the conversion (torch.clamp then long)
    const float c = fminf(fmaxf(floorf((p - o) * inv), 0.0f), (float)(grid - 1));
    return (int)c;
}

// the slot of `cell` in the block's hash, inserting it (and numbering it in
// `stage`) if new
__device__ __forceinline__ int hash_slot(Shared& sm, int cell) {
    int h = (int)(((unsigned)cell * 2654435761u) >> (32 - kHashBits));
    while (true) {
        const int prev = atomicCAS(&sm.key[h], -1, cell);
        if (prev == -1) sm.stage[h] = atomicAdd(&sm.ncells, 1);
        if (prev == -1 || prev == cell) return h;
        h = (h + 1) & (kHash - 1);
    }
}

template <bool kFilter, bool kStats>
__global__ void __launch_bounds__(kThreads)
shadow_grid_trace_kernel(AlphaTables at, const float4* __restrict__ entries,
                         const int32_t* __restrict__ offsets, const float4* __restrict__ big,
                         const int32_t* __restrict__ num_big_p, int grid,
                         const float* __restrict__ frame,
                         const float* __restrict__ origin,
                         const float* __restrict__ direction, const float* __restrict__ tmin_a,
                         float tmin_s, const float* __restrict__ tmax_a, float tmax_s,
                         int n_rays, int width, int max_steps, int stage_rows,
                         uint8_t* __restrict__ out_hit, unsigned long long* __restrict__ stats) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
    float4* big_s = reinterpret_cast<float4*>(smem_raw + kRowsOffset);
    float4* cells = big_s + 3 * kBigCap;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int i = tid; i < kHash; i += kThreads) sm.key[i] = -1;
    if (tid == 0) {
        mbar_init(&sm.bar_big);
        mbar_init(&sm.bar_cells);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        sm.head = 0;
        sm.ncells = 0;
        sm.stage_bytes = 0;
        // the big tier's count, read once on the device: the copy's
        // transaction bytes and every later use come from it
        sm.num_big = min(max(__ldg(num_big_p), 0), kBigCap);
    }
    __syncthreads();
    const int num_big = sm.num_big;
    if (tid == 0 && num_big > 0) {
        mbar_arrive_tx(&sm.bar_big, num_big * 48u);
        bulk_copy(big_s, big, num_big * 48u, &sm.bar_big);
    }

    // this block's rays: load, drop the dead ones, find the live ones' cells
    const float fu0 = __ldg(frame), fu1 = __ldg(frame + 1), fu2 = __ldg(frame + 2);
    const float fv0 = __ldg(frame + 3), fv1 = __ldg(frame + 4), fv2 = __ldg(frame + 5);
    const float org_u = __ldg(frame + 6), org_v = __ldg(frame + 7);
    const float inv_u = __ldg(frame + 8), inv_v = __ldg(frame + 9);
    int rr[kPer], cellv[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
        const int i = c * kThreads + tid;
        long long r;
        bool inside;
        if (width > 0) {
            const int tiles_x = (width + kTileW - 1) / kTileW;
            const int foot = i / 32, l = i % 32;
            const int x = (blockIdx.x % tiles_x) * kTileW + (foot % (kTileW / kFootW)) * kFootW +
                          l % kFootW;
            const int y = (blockIdx.x / tiles_x) * kTileH + (foot / (kTileW / kFootW)) * kFootH +
                          l / kFootW;
            r = (long long)y * width + x;
            inside = x < width && r < n_rays;
        } else {
            r = (long long)blockIdx.x * kMaxRays + i;
            inside = r < n_rays;
        }
        rr[c] = (int)r;
        cellv[c] = -1;
        if (inside) {
            const float tmin = tmin_a != nullptr ? tmin_a[r] : tmin_s;
            const float tmax = tmax_a != nullptr ? tmax_a[r] : tmax_s;
            if (!(tmax < tmin)) {
                const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
                // frame: [u_axis, v_axis, origin_uv, inv_cell], the same for every ray
                const float pu = (ox * fu0 + oy * fu1) + oz * fu2;
                const float pv = (ox * fv0 + oy * fv1) + oz * fv2;
                cellv[c] = cell_coord(pv, org_v, inv_v, grid) * grid +
                           cell_coord(pu, org_u, inv_u, grid);
            } else {
                out_hit[r] = 0;
            }
        }
    }
    // the queue, in load order: a warp's live rays by ballot and popc, the
    // warps' counts through shared memory (double-buffered: one barrier a
    // round); one hash insert per warp and distinct cell
    int qlen = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
        const bool q = cellv[c] >= 0;
        const unsigned m = __ballot_sync(kFull, q);
        const unsigned peers = __match_any_sync(kFull, cellv[c]);
        const int leader = __ffs(peers) - 1;
        int slot = 0;
        if (q && lane == leader) slot = hash_slot(sm, cellv[c]);
        slot = __shfl_sync(kFull, slot, leader);
        if (lane == 0) sm.warp_cnt[c & 1][warp] = __popc(m);
        __syncthreads();
        int before = qlen;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int cw = sm.warp_cnt[c & 1][w];
            before += w < warp ? cw : 0;
            qlen += cw;
        }
        if (q) {
            const int j = before + __popc(m & ((1u << lane) - 1));
            sm.rid[j] = rr[c];
            sm.slot[j] = slot;
        }
    }
    __syncthreads();
    if (qlen == 0) {
        // no live ray; the big tier's copy must land before the block ends
        if (tid == 0 && num_big > 0) mbar_wait(&sm.bar_big);
        return;
    }

    // each distinct cell's list; its head staged, stage_rows shared equally
    const int per = stage_rows / sm.ncells;
#pragma unroll
    for (int k = 0; k < kSlotsPer; ++k) {
        const int s = k * kThreads + tid;
        const int cell = sm.key[s];
        if (cell >= 0) {
            const int f = offsets[cell];
            const int n = max(min(offsets[cell + 1] - f, max_steps), 0);
            const int nst = min(n, per);
            sm.first[s] = f;
            sm.count[s] = n;
            sm.stage[s] *= per;
            sm.staged[s] = nst;
            if (nst > 0) atomicAdd(&sm.stage_bytes, nst * 48);
        }
    }
    __syncthreads();
    const int stage_bytes = sm.stage_bytes;
    if (tid == 0) {
        if (stage_bytes > 0)
            mbar_arrive_tx(&sm.bar_cells, (unsigned)stage_bytes);
        else
            mbar_arrive(&sm.bar_cells);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSlotsPer; ++k) {
        const int s = k * kThreads + tid;
        if (sm.key[s] >= 0 && sm.staged[s] > 0)
            bulk_copy(cells + 3 * sm.stage[s], entries + 3 * (long long)sm.first[s],
                      sm.staged[s] * 48u, &sm.bar_cells);
    }
    if (num_big > 0) mbar_wait(&sm.bar_big);
    if (stage_bytes > 0) mbar_wait(&sm.bar_cells);

    // the walk: a lane a ray, refilled from the queue as its ray ends.  Row k
    // of a ray: the big tier's k-th (k < num_big), then its cell list's, the
    // staged head (k < in_smem) from shared memory, the rest from device
    // memory.  The big tier and the staged rows are one shared array: row k
    // of the ray is its row k below num_big, its row st + k from there (st
    // skips the big tier's unfilled rows).
    const float4* rows_s = big_s;
    int rid = -1, k = 0, nall = 0, in_smem = 0, st = 0;
    const float4* rows_g = nullptr;  // the ray's list, offset so row k is rows_g + 3 * k
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, tmin = 0.f, tmax = 0.f;
    bool empty = false;  // the queue is drained (warp-uniform)
    unsigned busy = 0, steps = 0;
    while (true) {
        int tests = 0;  // rows this lane tests in this step
        unsigned act = __ballot_sync(kFull, rid >= 0);
        if (act != kFull && !empty) {
            const unsigned want = ~act;
            const int leader = __ffs(want) - 1;
            int j0 = 0;
            if (lane == leader) j0 = atomicAdd(&sm.head, __popc(want));
            j0 = __shfl_sync(kFull, j0, leader);
            empty = j0 + __popc(want) >= qlen;
            const int j = j0 + __popc(want & ((1u << lane) - 1));
            if (rid < 0 && j < qlen) {
                rid = sm.rid[j];
                ox = __ldg(origin + 3 * rid), oy = __ldg(origin + 3 * rid + 1),
                oz = __ldg(origin + 3 * rid + 2);
                dx = __ldg(direction + 3 * rid), dy = __ldg(direction + 3 * rid + 1),
                dz = __ldg(direction + 3 * rid + 2);
                tmin = tmin_a != nullptr ? __ldg(tmin_a + rid) : tmin_s;
                tmax = tmax_a != nullptr ? __ldg(tmax_a + rid) : tmax_s;
                const int s = sm.slot[j];
                k = 0;
                nall = num_big + sm.count[s];
                in_smem = num_big + sm.staged[s];
                st = sm.stage[s] + kBigCap - num_big;
                rows_g = entries + 3 * ((long long)sm.first[s] - num_big);
                if (nall == 0) {  // an empty cell and no big tier: a miss
                    out_hit[rid] = 0;
                    rid = -1;
                }
            }
            act = __ballot_sync(kFull, rid >= 0);
        }
        if (act == 0) {
            if (empty) break;
            continue;
        }
        if (rid >= 0) {
            // up to kChunk rows of one memory before the warp votes again
            const int lim = min(k < in_smem ? in_smem : nall, k + kChunk);
            const int k0 = k;
            bool hit = false;
            int tri;
            float u, v;
            if (k < in_smem) {
                for (; k < lim && !hit; ++k) {
                    const float4* row = rows_s + 3 * (k < num_big ? k : st + k);
                    hit = row_hit(row[0], row[1], *reinterpret_cast<const float2*>(row + 2), ox,
                                  oy, oz, dx, dy, dz, tmin, tmax, tri, u, v) &&
                          (!kFilter || alpha_accept(at, tri, u, v));
                }
            } else {
                for (; k < lim && !hit; ++k) {
                    const float4* row = rows_g + 3 * k;
                    if (((k - in_smem) & 1) == 0 && k + kPrefetch < nall)
                        asm volatile("prefetch.global.L1 [%0];" ::"l"(row + 3 * kPrefetch));
                    hit = row_hit(__ldg(row), __ldg(row + 1),
                                  __ldg(reinterpret_cast<const float2*>(row + 2)), ox, oy, oz,
                                  dx, dy, dz, tmin, tmax, tri, u, v) &&
                          (!kFilter || alpha_accept(at, tri, u, v));
                }
            }
            tests = k - k0;
            if (hit || k == nall) {
                out_hit[rid] = hit;
                rid = -1;
            }
        }
        if (kStats) {
            busy += __reduce_add_sync(kFull, tests);
            steps += __reduce_max_sync(kFull, tests);
        }
    }
    if (kStats && lane == 0) {
        atomicAdd(stats, (unsigned long long)busy);
        atomicAdd(stats + 1, 32ull * steps);
    }
}

// a block's dynamic shared memory: the fixed part, the big tier's kBigCap
// rows and stage_rows rows of cell lists
size_t shared_bytes(int stage_rows) {
    return (size_t)kRowsOffset + (size_t)(kBigCap + stage_rows) * 48;
}

template <bool kFilter, bool kStats>
cudaError_t launch(int blocks, size_t smem, cudaStream_t s, const AlphaTables& at,
                   const float4* e, const int32_t* offsets, const float4* b,
                   const int32_t* num_big, int grid, const float* frame, const float* origin,
                   const float* direction, const float* tmin_a, float tmin_s,
                   const float* tmax_a, float tmax_s, int n_rays, int width, int max_steps,
                   int stage_rows, uint8_t* out_hit, unsigned long long* stats) {
    static size_t opted = 48 * 1024;  // the dynamic shared memory this instance may take
    if (smem > opted) {
        const cudaError_t err = cudaFuncSetAttribute(
            shadow_grid_trace_kernel<kFilter, kStats>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return err;
        opted = smem;
    }
    shadow_grid_trace_kernel<kFilter, kStats><<<blocks, kThreads, smem, s>>>(
        at, e, offsets, b, num_big, grid, frame, origin, direction, tmin_a, tmin_s, tmax_a,
        tmax_s, n_rays, width, max_steps, stage_rows, out_hit, stats);
    return cudaGetLastError();
}

}  // namespace

extern "C" int shadow_grid_trace_launch(
    const float* entries, const int32_t* offsets, const float* big, const int32_t* num_big,
    int grid, const float* frame, const float* origin, const float* direction,
    const float* tmin_a, float tmin_s, const float* tmax_a, float tmax_s, int n_rays,
    int width, int max_steps, int stage_rows, const float* tri_static, const float* atlas_q,
    int atlas_rows, int atlas_w, uint8_t* out_hit, unsigned long long* stats, int device, void* stream) {
    // tri_static == nullptr: no alpha filter; tmin_a / tmax_a == nullptr: the
    // scalar beside it for every ray.  width > 0: the rays are an image's
    // pixels, row-major, width a row, and a block takes a kTileW x kTileH
    // tile; width <= 0: a block takes kMaxRays consecutive rays.  stage_rows:
    // the cell rows a block stages in shared memory.  Rows are 12 floats (48
    // bytes), copied and read as float4: the tensors' allocations are 16-byte
    // aligned.  frame: the grid's 10 floats on the device, so no launch
    // waits for a copy to the host; num_big: the big tier's count on the
    // device (clamped to [0, kBigCap] there), for the same reason.  stats:
    // nullptr, or two counters the kernel adds its busy and all lane-steps
    // to.  device: the tensors' card.
    if (n_rays <= 0) return (int)cudaGetLastError();
    if (stage_rows < 0) return (int)cudaErrorInvalidValue;
    const DeviceGuard guard(device);
    long long blocks = ((long long)n_rays + kMaxRays - 1) / kMaxRays;
    if (width > 0) {
        const long long rows = ((long long)n_rays + width - 1) / width;
        blocks = (long long)((width + kTileW - 1) / kTileW) * ((rows + kTileH - 1) / kTileH);
    }
    const size_t smem = shared_bytes(stage_rows);
    const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
    const float4* e = reinterpret_cast<const float4*>(entries);
    const float4* b = reinterpret_cast<const float4*>(big);
    cudaStream_t s = (cudaStream_t)stream;
    const auto go = [&](auto kernel_launch) {
        return kernel_launch((int)blocks, smem, s, at, e, offsets, b, num_big, grid, frame,
                             origin, direction, tmin_a, tmin_s, tmax_a, tmax_s, n_rays, width,
                             max_steps, stage_rows, out_hit, stats);
    };
    const bool filter = tri_static != nullptr, counted = stats != nullptr;
    return (int)(filter ? (counted ? go(&launch<true, true>) : go(&launch<true, false>))
                        : (counted ? go(&launch<false, true>) : go(&launch<false, false>)));
}

extern "C" int shadow_grid_occupancy(int stage_rows, int filter, int device, int* blocks,
                                     int* smem_bytes) {
    // the blocks of K3 (unfiltered or filtered, no counters) one SM holds at
    // once at this staging capacity, and the shared memory a block takes
    const DeviceGuard guard(device);
    const size_t smem = shared_bytes(stage_rows);
    *smem_bytes = (int)smem;
    const auto kernel = filter ? shadow_grid_trace_kernel<true, false>
                               : shadow_grid_trace_kernel<false, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
    return (int)err;
}
