// K4: the threaded walk of a binary BVH, any-hit and closest-hit.
//
// Replaces the XLA while_loop of vulkanhybridrenderer_tpu/ops/traverse.py
// _trace_flat (:697-787), reached through trace with a binary BVH: the
// reference's independent oracle for the BVH8 walk (a different tree, a
// different walk, different leaves).  As eager PyTorch that loop would be a
// round of launches a step, so it gets a kernel for the same reason K2 and
// K3 did.  It walks the tables ops/traverse.pack_flat packs once per tree,
// with no stack: a ray holds one link, an internal node's row (>= 0), a
// leaf's first slot as -(start + 2), or -1 (the end).  Internal rows (L-1,
// 8) [lo.xyz, hi.xyz, next, escape], two float4; leaf slots (L * leaf_size,
// 12) at order's positions, three float4 [v0.xyz, id] [v1.xyz, escape]
// [v2.xyz, 0]; links and ids are int32 bits.  So a step reads an internal
// node's row or a leaf's slots, never a leaf's row or `order`.  Semantics
// are the reference's exactly:
//   * direction components with |d| < 1e-12 become +-1e-12 before 1/d;
//   * an internal node is entered (next: its left child) when
//     max(tn, tmin) <= min(tf, t_best), else the walk takes its escape;
//   * a leaf skips its box test: its leaf_size slots are tested in order
//     (ids of -1 skipped), Moller-Trumbore without culling, each accepted
//     when t >= tmin and t < t_best, the t_best the triangle before it
//     left; any-hit ends the walk after the whole leaf, closest-hit takes
//     the leaf's escape;
//   * at most max_steps nodes a ray, every ray from the root; a miss
//     returns tri = -1, t = tmax and u = v = 0.  A ray with tmax < tmin
//     walks like any other and finds nothing (no box interval and no t
//     lies in [tmin, tmax]).
// The alpha any-hit filter (kFilter; alpha_accept in alpha_filter.cuh, as
// K2 and K3 apply it) rejects a geometric candidate whose base-color alpha
// at the hit is below its material's cutoff.
//
// What bounds it on this card: operations.  26 FP32 operations a visited
// internal node's slab test, 59 a tested triangle, 53 a filter evaluation
// (K2's prices, chip_smoke.py, counted by trace_flat_plain(visits=True));
// the bytes a launch must move (32 an internal row and 48 a leaf slot
// once, the rays in, the hits out) take less at 1080p on the benchmark
// scenes.  A thread walks a ray, and a warp runs until its longest walk
// ends and pays every kind of step any of its lanes takes.  The design:
//   * the schedule (after Aila and Laine's while-while, HPG 2009): a round
//     runs up to kWait internal steps, each for the lanes on an internal
//     node, then one leaf step for the lanes on a leaf.  A lane that reached
//     a leaf waits there for the rest of the round and never skips ahead,
//     so each ray's walk is the reference's, node for node; the leaves of a
//     round are tested together, and no lane waits longer than kWait steps;
//   * a link names a leaf by its slots, which carry its escape: a leaf step
//     reads three 16-byte rows, not a node row, an order entry and nine
//     4-byte loads;
//   * the tables are packed once per tree (traverse.pack_flat), and the
//     launch switches device in C (device_guard.cuh).
// PERF.md section 6 has the candidates measured against this one and
// dropped: if-if, while-while with no bound on the wait, waits of 4 and 8,
// a block's live rays queued first, the internal nodes depth first.  With
// `stats` (kStats) a warp adds, for every step it runs, its lanes that run
// it and 32: the share of busy lanes.
//
// Built with --fmad=false, so every product rounds like the plain PyTorch
// version (ops/traverse.trace_flat_plain) and (t, tri, u, v) agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "alpha_filter.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;  // a block's threads and rays
constexpr int kWait = 6;  // a lane's longest wait at a leaf, in internal steps

// Moller-Trumbore without culling (the reference's moller_trumbore,
// traverse.py:679) in the operation order of ops/traverse.moller_trumbore,
// K2's and K3's, each product rounded on its own: the hit's (t, u, v) and
// whether it is a geometric hit (|det| > 1e-9, u, v >= 0, u + v <= 1).
// K3 keeps its own copy: moved into a shared header, its loop ran slower.
__device__ __forceinline__ bool moller_trumbore(float4 r0, float4 r1, float4 r2, float ox,
                                                float oy, float oz, float dx, float dy,
                                                float dz, float& t, float& u, float& v) {
    const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
    const float e1x = r1.x - v0x, e1y = r1.y - v0y, e1z = r1.z - v0z;
    const float e2x = r2.x - v0x, e2y = r2.y - v0y, e2z = r2.z - v0z;
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool okd = fabsf(det) > 1e-9f;
    const float invdet = 1.0f / (okd ? det : 1.0f);
    const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
    u = (tvx * px + tvy * py + tvz * pz) * invdet;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    v = (dx * qx + dy * qy + dz * qz) * invdet;
    t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
    return okd && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// one step of the warp for the stats: its lanes that run it, and 32
template <bool kStats>
__device__ __forceinline__ void count_step(unsigned long long& busy,
                                           unsigned long long& total) {
    if (kStats) {
        const unsigned m = __activemask();
        if ((int)(threadIdx.x & 31) == __ffs(m) - 1) {
            busy += __popc(m);
            total += 32;
        }
    }
}

struct Params {
    AlphaTables at;
    const float4* nodes;
    const float4* leaf;
    int leaf_size, root;
    const float *origin, *direction, *tmin_a, *tmax_a;
    float tmin_s, tmax_s;
    int n_rays, max_steps;
    float* out_t;
    int32_t* out_tri;
    float *out_u, *out_v;
    unsigned long long* stats;
};

// ray r's walk from the root; writes its hit
template <bool kAnyHit, bool kFilter, bool kStats>
__device__ __forceinline__ void walk(const Params& p, long long r, float tmin, float tmax,
                                     unsigned long long& busy, unsigned long long& total) {
    const float ox = p.origin[3 * r], oy = p.origin[3 * r + 1], oz = p.origin[3 * r + 2];
    const float dx = p.direction[3 * r], dy = p.direction[3 * r + 1],
                dz = p.direction[3 * r + 2];
    float t_best = tmax, u_best = 0.0f, v_best = 0.0f;
    int32_t tri_best = -1;
    const float sdx = fabsf(dx) < 1e-12f ? (dx >= 0.0f ? 1e-12f : -1e-12f) : dx;
    const float sdy = fabsf(dy) < 1e-12f ? (dy >= 0.0f ? 1e-12f : -1e-12f) : dy;
    const float sdz = fabsf(dz) < 1e-12f ? (dz >= 0.0f ? 1e-12f : -1e-12f) : dz;
    const float ix = 1.0f / sdx, iy = 1.0f / sdy, iz = 1.0f / sdz;

    int node = p.max_steps > 0 ? p.root : -1, steps = 0;  // a link
    const auto inner_step = [&]() {
        count_step<kStats>(busy, total);
        // [lo.x lo.y lo.z hi.x] [hi.y hi.z next escape]
        const float4 a = __ldg(p.nodes + 2 * (size_t)node);
        const float4 b = __ldg(p.nodes + 2 * (size_t)node + 1);
        const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
        const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
        const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
        node = __float_as_int(fmaxf(tn, tmin) <= fminf(tf, t_best) ? b.z : b.w);
        if (++steps >= p.max_steps) node = -1;
    };
    // a leaf: its slots in order, each against the t_best before it; the
    // first slot's v1.w is the link after the leaf
    const auto leaf_step = [&]() {
        count_step<kStats>(busy, total);
        const float4* slot = p.leaf + 3 * (size_t)(-node - 2);
        int esc = -1;
        bool any = false;
        for (int j = 0; j < p.leaf_size; ++j, slot += 3) {
            const float4 r0 = __ldg(slot), r1 = __ldg(slot + 1), r2 = __ldg(slot + 2);
            if (j == 0) esc = __float_as_int(r1.w);
            const int32_t tri = __float_as_int(r0.w);
            if (tri < 0) continue;
            float t, tu, tv;
            bool ok = moller_trumbore(r0, r1, r2, ox, oy, oz, dx, dy, dz, t, tu, tv) &&
                      t >= tmin && t < t_best;
            if (kFilter && ok) ok = alpha_accept(p.at, tri, tu, tv);
            if (ok) {
                t_best = t;
                tri_best = tri;
                u_best = tu;
                v_best = tv;
                any = true;
            }
        }
        node = (kAnyHit && any) ? -1 : esc;
        if (++steps >= p.max_steps) node = -1;
    };
    while (node != -1) {
        for (int k = 0; k < kWait && node >= 0; ++k) inner_step();
        if (node < -1) leaf_step();
    }
    p.out_t[r] = t_best;
    p.out_tri[r] = tri_best;
    p.out_u[r] = u_best;
    p.out_v[r] = v_best;
}

template <bool kAnyHit, bool kFilter, bool kStats>
__global__ void __launch_bounds__(kThreads) bvh_flat_trace_kernel(const Params p) {
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (r >= p.n_rays) return;
    unsigned long long busy = 0, total = 0;
    walk<kAnyHit, kFilter, kStats>(p, r, p.tmin_a != nullptr ? p.tmin_a[r] : p.tmin_s,
                                   p.tmax_a != nullptr ? p.tmax_a[r] : p.tmax_s, busy, total);
    if (kStats && total > 0) {
        atomicAdd(p.stats, busy);
        atomicAdd(p.stats + 1, total);
    }
}

template <bool kAnyHit, bool kFilter, bool kStats>
cudaError_t launch(const Params& p, cudaStream_t s) {
    const long long blocks = ((long long)p.n_rays + kThreads - 1) / kThreads;
    bvh_flat_trace_kernel<kAnyHit, kFilter, kStats><<<(unsigned)blocks, kThreads, 0, s>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int bvh_flat_trace_launch(const float* nodes, const float* leaf_tris, int leaf_size,
                                     int root, const float* origin, const float* direction,
                                     const float* tmin, float tmin_s, const float* tmax,
                                     float tmax_s, int n_rays, int max_steps, int anyhit,
                                     const float* tri_static, const float* atlas_q,
                                     int atlas_rows, int atlas_w, float* out_t,
                                     int32_t* out_tri, float* out_u, float* out_v,
                                     unsigned long long* stats, int device, void* stream) {
    // nodes (L-1, 8) and leaf_tris (L * leaf_size, 12) float32, read as
    // float4 (the allocations are 16-byte aligned); root: the root's link.
    // tmin / tmax == nullptr: the scalar beside it for every ray.
    // tri_static == nullptr: no alpha filter.  stats: nullptr, or two
    // counters the kernel adds its busy and all lane-steps to.  device: the
    // tensors' card.
    if (n_rays <= 0) return (int)cudaGetLastError();
    const DeviceGuard guard(device);
    const Params p{AlphaTables{tri_static, atlas_q, atlas_rows, atlas_w},
                   reinterpret_cast<const float4*>(nodes),
                   reinterpret_cast<const float4*>(leaf_tris),
                   leaf_size, root, origin, direction, tmin, tmax, tmin_s, tmax_s, n_rays,
                   max_steps, out_t, out_tri, out_u, out_v, stats};
    const cudaStream_t s = (cudaStream_t)stream;
    const bool filter = tri_static != nullptr, counted = stats != nullptr;
    const auto go = [&](auto any) {
        constexpr bool kAny = decltype(any)::value;
        return filter ? (counted ? launch<kAny, true, true>(p, s) : launch<kAny, true, false>(p, s))
                      : (counted ? launch<kAny, false, true>(p, s)
                                 : launch<kAny, false, false>(p, s));
    };
    return (int)(anyhit ? go(std::true_type{}) : go(std::false_type{}));
}
