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
//     max_steps of them, then over the num_big rows of the big tier;
//   * a hit needs tri >= 0, tmin <= t <= tmax and, with the alpha tables,
//     alpha_accept (alpha_filter.cuh, shared with K2); the ray stops at the
//     first;
//   * a ray with tmax < tmin tests nothing and misses.
//
// What bounds it on this card: operations.  A tested entry costs 59 FP32
// operations (K2's triangle price, chip_smoke.py), and the bytes a launch
// must move (the rays in, one byte a ray out, the entry table once) take a
// fraction of the tests' issue time on SponzaProxy.  The design is one thread
// a ray, enough for this slice: neighbouring threads shade neighbouring
// pixels, whose origins mostly share a cell, so a warp reads the same entry
// row (three 16-byte loads, broadcast) and walks it in step; a ray that hits
// early idles until its warp's longest walk ends.
//
// Built with --fmad=false, so the hit masks equal the plain PyTorch version
// (ops/shadowgrid.trace_shadow_plain) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_filter.cuh"

namespace {

constexpr int kThreads = 128;

// Moller-Trumbore of one entry row (three float4: v0 v1.x | v1.yz v2.xy |
// v2.z tri 0 0) against the ray, each product rounded: the hit's (t, u, v)
// when it is a geometric hit with tmin <= t <= tmax and tri >= 0.
__device__ __forceinline__ bool row_hit(const float4* __restrict__ row, float ox, float oy,
                                        float oz, float dx, float dy, float dz, float tmin,
                                        float tmax, int& tri, float& u, float& v) {
    const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w - v0x, e1y = b.x - v0y, e1z = b.y - v0z;
    const float e2x = b.z - v0x, e2y = b.w - v0y, e2z = c.x - v0z;
    tri = (int)c.y;
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
    const float t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
    return okd && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && tri >= 0 && t >= tmin &&
           t <= tmax;
}

__device__ __forceinline__ int cell_coord(float p, float o, float inv, int grid) {
    // floor, clamped to the grid before the conversion (torch.clamp then long)
    const float c = fminf(fmaxf(floorf((p - o) * inv), 0.0f), (float)(grid - 1));
    return (int)c;
}

template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
shadow_grid_trace_kernel(AlphaTables at, const float4* __restrict__ entries,
                         const int32_t* __restrict__ offsets, const float4* __restrict__ big,
                         int num_big, int grid, const float* __restrict__ frame,
                         const float* __restrict__ origin,
                         const float* __restrict__ direction, const float* __restrict__ tmin_a,
                         const float* __restrict__ tmax_a, int n_rays, int max_steps,
                         uint8_t* __restrict__ out_hit) {
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (r >= n_rays) return;
    const float tmin = tmin_a[r], tmax = tmax_a[r];
    bool hit = false;
    if (!(tmax < tmin)) {
        const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
        const float dx = direction[3 * r], dy = direction[3 * r + 1],
                    dz = direction[3 * r + 2];
        // frame: [u_axis, v_axis, origin_uv, inv_cell], the same for every ray
        const float pu = (ox * __ldg(frame) + oy * __ldg(frame + 1)) + oz * __ldg(frame + 2);
        const float pv = (ox * __ldg(frame + 3) + oy * __ldg(frame + 4)) + oz * __ldg(frame + 5);
        const int cell = cell_coord(pv, __ldg(frame + 7), __ldg(frame + 9), grid) * grid +
                         cell_coord(pu, __ldg(frame + 6), __ldg(frame + 8), grid);
        const int start = offsets[cell];
        const int n = min(offsets[cell + 1] - start, max_steps);
        int tri;
        float u, v;
        for (int k = 0; k < n && !hit; ++k) {
            hit = row_hit(entries + 3 * (long long)(start + k), ox, oy, oz, dx, dy, dz, tmin,
                          tmax, tri, u, v);
            if (kFilter && hit) hit = alpha_accept(at, tri, u, v);
        }
        for (int i = 0; i < num_big && !hit; ++i) {
            hit = row_hit(big + 3 * i, ox, oy, oz, dx, dy, dz, tmin, tmax, tri, u, v);
            if (kFilter && hit) hit = alpha_accept(at, tri, u, v);
        }
    }
    out_hit[r] = hit;
}

}  // namespace

extern "C" int shadow_grid_trace_launch(
    const float* entries, const int32_t* offsets, const float* big, int num_big, int grid,
    const float* frame, const float* origin, const float* direction, const float* tmin,
    const float* tmax, int n_rays, int max_steps, const float* tri_static,
    const float* atlas_q, int atlas_rows, int atlas_w, uint8_t* out_hit, void* stream) {
    // tri_static == nullptr: no alpha filter.  Rows are 12 floats (48 bytes),
    // read as three float4: the tensors' allocations are 16-byte aligned.
    // frame: the grid's 10 floats on the device, so no launch waits for a
    // copy to the host.
    if (n_rays > 0) {
        const int blocks = (int)(((long long)n_rays + kThreads - 1) / kThreads);
        const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
        const float4* e = reinterpret_cast<const float4*>(entries);
        const float4* b = reinterpret_cast<const float4*>(big);
        cudaStream_t s = (cudaStream_t)stream;
        if (tri_static != nullptr)
            shadow_grid_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
                at, e, offsets, b, num_big, grid, frame, origin, direction, tmin, tmax, n_rays,
                max_steps, out_hit);
        else
            shadow_grid_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
                at, e, offsets, b, num_big, grid, frame, origin, direction, tmin, tmax, n_rays,
                max_steps, out_hit);
    }
    return (int)cudaGetLastError();
}
