// K4: the threaded walk of a binary LBVH, any-hit and closest-hit.
//
// Replaces the XLA while_loop of vulkanhybridrenderer_tpu/ops/traverse.py
// _trace_flat (:697-787), reached through trace with a binary BVH: the
// reference's independent oracle for the BVH8 walk (a different tree, a
// different walk, different leaves).  As eager PyTorch that loop would be a
// round of launches a step, so it gets a kernel for the same reason K2 and
// K3 did.  It walks the (2L-1, 8) node rows of ops/traverse.pack_nodes,
// [lo.xyz, hi.xyz, next, escape], with no stack: a ray holds one node
// index.  Semantics are the reference's exactly:
//   * direction components with |d| < 1e-12 become +-1e-12 before 1/d;
//   * an internal node (next >= 0: its left child) is entered when
//     max(tn, tmin) <= min(tf, t_best), else the walk takes its escape;
//   * a leaf (next = -(start + 2)) skips its box test: its leaf_size
//     triangles order[start ...] are tested in order (ids of -1 skipped),
//     Moller-Trumbore without culling, each accepted when t >= tmin and
//     t < t_best, the t_best the triangle before it left;
//     any-hit ends the walk after the whole leaf, closest-hit takes the
//     escape;
//   * at most max_steps nodes a ray, every ray from the root (a ray with
//     tmax < tmin walks the root's step and misses); a miss returns tri =
//     -1, t = tmax and u = v = 0.
// The alpha any-hit filter (kFilter; alpha_accept in alpha_filter.cuh, as
// K2 and K3 apply it) rejects a geometric candidate whose base-color alpha
// at the hit is below its material's cutoff.
//
// What bounds it on this card: operations.  26 FP32 operations a visited
// internal node's slab test, 59 a tested triangle, 53 a filter evaluation
// (K2's prices, chip_smoke.py); the bytes a launch must move (32 a node row,
// 36 a triangle and 4 an order entry once, the rays in, the hits out) take
// less at 1080p on the benchmark scenes.  The design is the simple one, a
// thread a ray: a step reads its node row as two 16-byte loads and a
// leaf's triangles as nine 4-byte loads each; a warp
// runs until its longest walk ends and runs the leaf code whenever one of
// its rays stands on a leaf.
//
// Built with --fmad=false, so every product rounds like the plain PyTorch
// version (ops/traverse.trace_flat_plain) and (t, tri, u, v) agree bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_filter.cuh"

namespace {

constexpr int kThreads = 128;

// Moller-Trumbore without culling (the reference's moller_trumbore,
// traverse.py:679) in the operation order of ops/traverse.moller_trumbore,
// K2's and K3's, each product rounded on its own: the hit's (t, u, v) and
// whether it is a geometric hit (|det| > 1e-9, u, v >= 0, u + v <= 1).
// K3 keeps its own copy: moved into a shared header, its loop ran slower.
__device__ __forceinline__ bool moller_trumbore(const float* __restrict__ tri, float ox,
                                                float oy, float oz, float dx, float dy,
                                                float dz, float& t, float& u, float& v) {
    const float v0x = __ldg(tri), v0y = __ldg(tri + 1), v0z = __ldg(tri + 2);
    const float e1x = __ldg(tri + 3) - v0x, e1y = __ldg(tri + 4) - v0y,
                e1z = __ldg(tri + 5) - v0z;
    const float e2x = __ldg(tri + 6) - v0x, e2y = __ldg(tri + 7) - v0y,
                e2z = __ldg(tri + 8) - v0z;
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

template <bool kAnyHit, bool kFilter>
__global__ void __launch_bounds__(kThreads)
bvh_flat_trace_kernel(AlphaTables at, const float4* __restrict__ nodes,
                      const float* __restrict__ tris9, const int32_t* __restrict__ order,
                      int leaf_size, int root, const float* __restrict__ origin,
                      const float* __restrict__ direction, const float* __restrict__ tmin_a,
                      const float* __restrict__ tmax_a, int n_rays, int max_steps,
                      float* __restrict__ out_t, int32_t* __restrict__ out_tri,
                      float* __restrict__ out_u, float* __restrict__ out_v) {
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (r >= n_rays) return;
    const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
    const float dx = direction[3 * r], dy = direction[3 * r + 1], dz = direction[3 * r + 2];
    const float tmin = tmin_a[r];
    float t_best = tmax_a[r], u_best = 0.0f, v_best = 0.0f;
    int32_t tri_best = -1;
    const float sdx = fabsf(dx) < 1e-12f ? (dx >= 0.0f ? 1e-12f : -1e-12f) : dx;
    const float sdy = fabsf(dy) < 1e-12f ? (dy >= 0.0f ? 1e-12f : -1e-12f) : dy;
    const float sdz = fabsf(dz) < 1e-12f ? (dz >= 0.0f ? 1e-12f : -1e-12f) : dz;
    const float ix = 1.0f / sdx, iy = 1.0f / sdy, iz = 1.0f / sdz;

    int node = root;
    for (int step = 0; node >= 0 && step < max_steps; ++step) {
        // [lo.x lo.y lo.z hi.x] [hi.y hi.z next escape]
        const float4 a = __ldg(nodes + 2 * (size_t)node);
        const float4 b = __ldg(nodes + 2 * (size_t)node + 1);
        const float next = b.z;
        const int esc = (int)b.w;
        if (!(next < -1.5f)) {
            const float t0x = (a.x - ox) * ix, t1x = (a.w - ox) * ix;
            const float t0y = (a.y - oy) * iy, t1y = (b.x - oy) * iy;
            const float t0z = (a.z - oz) * iz, t1z = (b.y - oz) * iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
            node = fmaxf(tn, tmin) <= fminf(tf, t_best) ? (int)next : esc;
        } else {
            const int start = (int)(-next - 2.0f);
            bool any = false;
            for (int j = 0; j < leaf_size; ++j) {
                const int32_t tri = __ldg(order + start + j);
                if (tri < 0) continue;
                float t, tu, tv;
                bool ok = moller_trumbore(tris9 + 9 * (size_t)tri, ox, oy, oz, dx, dy, dz, t,
                                          tu, tv) &&
                          t >= tmin && t < t_best;
                if (kFilter && ok) ok = alpha_accept(at, tri, tu, tv);
                if (ok) {
                    t_best = t;
                    tri_best = tri;
                    u_best = tu;
                    v_best = tv;
                    any = true;
                }
            }
            node = (kAnyHit && any) ? -1 : esc;
        }
    }
    out_t[r] = t_best;
    out_tri[r] = tri_best;
    out_u[r] = u_best;
    out_v[r] = v_best;
}

}  // namespace

extern "C" int bvh_flat_trace_launch(const float* nodes, const float* tris9,
                                     const int32_t* order, int leaf_size, int root,
                                     const float* origin, const float* direction,
                                     const float* tmin, const float* tmax, int n_rays,
                                     int max_steps, int anyhit, const float* tri_static,
                                     const float* atlas_q, int atlas_rows, int atlas_w,
                                     float* out_t, int32_t* out_tri, float* out_u,
                                     float* out_v, void* stream) {
    // tri_static == nullptr: no alpha filter.  nodes: (2L-1, 8) float32,
    // read as two float4 a row (the allocation is 16-byte aligned).
    if (n_rays > 0) {
        const int blocks = (int)(((long long)n_rays + kThreads - 1) / kThreads);
        const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
        const float4* nd = reinterpret_cast<const float4*>(nodes);
        cudaStream_t s = (cudaStream_t)stream;
#define K4_LAUNCH(ANY, FILT)                                                           \
    bvh_flat_trace_kernel<ANY, FILT><<<blocks, kThreads, 0, s>>>(                      \
        at, nd, tris9, order, leaf_size, root, origin, direction, tmin, tmax, n_rays, \
        max_steps, out_t, out_tri, out_u, out_v)
        const bool filt = tri_static != nullptr;
        if (anyhit && filt) K4_LAUNCH(true, true);
        else if (anyhit) K4_LAUNCH(true, false);
        else if (filt) K4_LAUNCH(false, true);
        else K4_LAUNCH(false, false);
#undef K4_LAUNCH
    }
    return (int)cudaGetLastError();
}
