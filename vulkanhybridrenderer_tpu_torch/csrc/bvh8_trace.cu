// K2: BVH8 ray traversal, any-hit and closest-hit.
//
// Replaces the XLA lockstep walk vulkanhybridrenderer_tpu/ops/traverse.py
// _trace8 (:135-348, reached through trace, the per-ray schedule), and with
// it the TPU packet schedules.  That walk stands in for the RT cores the
// Vulkan original traced these rays on; an H100 has none.  It walks the
// (N, 128) BVH8 table of ops/bvh8.py with a per-ray stack of (child_base *
// 256 + the remaining slots' mask, offset map) entries.  Semantics are the
// reference's exactly:
//   * direction components with |d| < 1e-12 become +-1e-12 before 1/d;
//   * internal rows: 8-wide slab test against [tmin, t_best], empty slots
//     (inverted boxes) masked by lo.x <= hi.x; children visited near-first in
//     slot ^ octant order;
//   * leaf rows: 8-wide Moller-Trumbore with no culling, accepting tri >= 0,
//     t >= tmin and t < t_best strictly; the first minimum wins;
//   * any-hit stops at the first leaf with an accepted hit, closest-hit
//     shrinks t_best and pops on;
//   * at most max_steps rows per ray; a miss returns tri = -1, t = tmax and
//     u = v = 0; a ray with tmax < tmin misses at once.
//
// The alpha any-hit filter (kFilter; alpha_accept in alpha_filter.cuh, which
// K3 shares: the reference's make_alpha_hit_filter, traverse.py:922-951,
// applied at _trace8:264-270) rejects a leaf candidate whose base-color alpha
// at the hit uv is below its material's cutoff, as
// shadetab.fetch_tri_static / interpolate3 / sample_atlas4 compute it: one
// tri_static row (uv0, alpha_mask, base_tex, base_scale, base_offset,
// alpha_cutoff) and one quad row of the atlas.  It is evaluated only for
// slots that already pass the geometric test (ANDed, so the result is the
// same) and reads the atlas only for masked textured materials.  Unfiltered
// launches compile without it.
//
// What bounds it on this card.  Device memory is not the limit: the table
// (~10 MB for the 108k-triangle benchmark scene) stays in the 50 MB L2, and
// the bytes a launch must move (rays in, hits out, the table once) take
// 0.03-0.06 ms at 3.35 TB/s.  The least work is the walk's FP32 operations,
// which depend on the rays: 208 per internal row (8 slots x 26: 6 FADD + 6
// FMUL of the slab planes, 10 min / max, the interval's 2 min / max and 2
// compares), 472 per leaf row (8 slots x 59 of Moller-Trumbore) and 53 per
// filter evaluation; chip_smoke.py prices each launch from the rows
// trace_plain(visits=True) counts.  What holds the kernel far above that is
// the instructions around those operations (loads, shuffles, the stack, the
// branch each row kind takes) and lanes that idle: a warp walks until the
// longest of its rays ends, and runs the leaf code for every ray whenever
// one of them stands on a leaf.
//
// The design: four lanes a ray, eight rays a warp.  The table is slot-major
// in SoA planes of 8 floats, and lane s holds two adjacent slots of every
// plane, so one 8-byte load a lane brings a ray's whole plane, one 32-byte
// sector: a step issues its 11 loads (the 10 planes either row kind needs,
// [0:80), and the leaf flag [127]) before it uses any of them, one L2 round
// trip a step, where a thread per ray made each load of a warp touch 32
// rows.  Which two slots: lane s takes chunk s ^ (oct >> 1), so that its
// slots' visit positions (slot ^ octant) are 2s and 2s + 1 (swapped when
// oct & 1): the slab tests OR into a mask already in near-first visit
// order, whose first set bit is the next child, and the stack keeps the
// remaining slots in that order.  The slab test and Moller-Trumbore run per
// slot in the reference's operation order; shuffles across the group OR the
// mask together and reduce a leaf's candidates to the lexicographic minimum
// of (t, slot).  The stack lives in shared memory, bvh.depth entries a ray,
// which every lane of a group writes with the same value; a __syncwarp
// between a pop's read of the top and its rewrite keeps the lanes' reads
// from seeing another lane's rewrite.  Control is
// warp-uniform: the warp walks while any of its rays does and runs the
// internal and the leaf code each when any of its rays needs it, so every
// shuffle names the full warp and needs no convergence checks.
//
// Development runs held other designs against this one on the same rays
// (PERF.md): eight lanes a ray with one slot each (slower on every
// wavefront), two with four (faster on coherent shadow and primary rays,
// slower on AO and reflection rays), group-wise control with 8-lane masks,
// the stack in registers, persistent warps that refill a finished ray's
// lanes, leaf rows batched across the warp, leaf-only planes loaded once the
// row kind is known.
//
// Built with --fmad=false so every product rounds like the plain PyTorch
// version and hit / miss decisions on triangle edges agree.

#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_filter.cuh"

namespace {

constexpr int kMaxDepth = 64;  // stack entries per ray (BVH8.depth bound)
constexpr int kGroup = 4;  // lanes per ray
constexpr int kSpl = 2;  // adjacent slots per lane: one 8-byte load a plane
constexpr int kThreads = 128;  // threads per block: 32 rays
template <bool kAnyHit, bool kFilter>
__global__ void __launch_bounds__(kThreads)
bvh8_trace_kernel(AlphaTables at, const float* __restrict__ rows,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ tmin_a,
                  const float* __restrict__ tmax_a, int n_rays, int max_steps,
                  int depth, float* __restrict__ out_t,
                  int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                  float* __restrict__ out_v) {
    constexpr unsigned kFull = 0xffffffffu;
    extern __shared__ int2 stacks[];  // (32 rays, depth) of (a, b) entries
    const int s = threadIdx.x & (kGroup - 1);
    const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
    const bool have_ray = r < n_rays;
    int2* stack = stacks + (threadIdx.x / kGroup) * depth;

    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
    float tmin = 0.0f, t_best = -1.0f;
    if (have_ray) {
        ox = origin[3 * r];
        oy = origin[3 * r + 1];
        oz = origin[3 * r + 2];
        dx = direction[3 * r];
        dy = direction[3 * r + 1];
        dz = direction[3 * r + 2];
        tmin = tmin_a[r];
        t_best = tmax_a[r];
    }
    int32_t tri_best = -1;
    float u_best = 0.0f, v_best = 0.0f;
    const float sdx = fabsf(dx) < 1e-12f ? (dx >= 0.0f ? 1e-12f : -1e-12f) : dx;
    const float sdy = fabsf(dy) < 1e-12f ? (dy >= 0.0f ? 1e-12f : -1e-12f) : dy;
    const float sdz = fabsf(dz) < 1e-12f ? (dz >= 0.0f ? 1e-12f : -1e-12f) : dz;
    const float ix = 1.0f / sdx, iy = 1.0f / sdy, iz = 1.0f / sdz;
    const int oct = ((dx < 0.0f) << 2) | ((dy < 0.0f) << 1) | (dz < 0.0f);
    // lane s holds slots 2c and 2c + 1 of every plane, c = s ^ (oct >> 1);
    // slot x is visited at position x ^ oct, which for them is 2s + (j ^
    // (oct & 1)): masks are built in visit order, so their first set bit is
    // the next child, and the stack keeps them so.  Lane oct >> 1 holds
    // slots 0 and 1, [48] (first child row) and [49] (offset map) of plane 6
    const int chunk = s ^ (oct >> 1);
    const int jflip = oct & 1;
    const int base_lane = oct >> 1;

    int node = (have_ray && !(t_best < tmin)) ? 0 : -1;  // root row, or done
    int sp = 0;
    for (int step = 0;; ++step) {
        const bool live = node >= 0 && step < max_steps;
        if (!__any_sync(kFull, live)) break;
        // every load of the step before any use: planes 0..9 at this lane's
        // slots, and the leaf flag.  A ray that has ended reads row 0.
        const float* row = rows + (size_t)(live ? node : 0) * 128;
        float p[10][kSpl];
#pragma unroll
        for (int k = 0; k < 10; ++k) {
            const float2 v = __ldg(reinterpret_cast<const float2*>(row + 8 * k) + chunk);
            p[k][0] = v.x;
            p[k][1] = v.y;
        }
        const float flag = __ldg(row + 127);
        const bool leaf = live && flag > 0.5f;
        const bool internal = live && !(flag > 0.5f);
        bool next = false;  // the ray has its next row (a child), or is done
        if (__any_sync(kFull, internal)) {
            // internal row: the slab tests of this lane's slots
            int mask = 0;
#pragma unroll
            for (int j = 0; j < kSpl; ++j) {
                const float lox = p[0][j], hix = p[3][j];
                const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
                const float t0y = (p[1][j] - oy) * iy, t1y = (p[4][j] - oy) * iy;
                const float t0z = (p[2][j] - oz) * iz, t1z = (p[5][j] - oz) * iz;
                const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                       fminf(t0z, t1z));
                const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                       fmaxf(t0z, t1z));
                const bool hit = (fmaxf(tn, tmin) <= fminf(tf, t_best)) && (lox <= hix);
                mask |= (int)hit << (kSpl * s + (j ^ jflip));
            }
#pragma unroll
            for (int off = 1; off < kGroup; off *= 2)
                mask |= __shfl_xor_sync(kFull, mask, off, kGroup);
            const int base = (int)__shfl_sync(kFull, p[6][0], base_lane, kGroup);
            const int offmap = (int)__shfl_sync(kFull, p[6][1], base_lane, kGroup);
            if (internal && mask != 0) {
                const int k = __ffs(mask) - 1;  // the next child's visit position
                const int slot = k ^ oct;
                const int remaining = mask & ~(1 << k);
                if (remaining != 0) {
                    stack[sp] = make_int2(base * 256 + remaining, offmap);
                    ++sp;
                }
                node = base + ((offmap >> (3 * slot)) & 7);
                next = true;
            }
        }
        if (__any_sync(kFull, leaf)) {
            // leaf row: Moller-Trumbore of this lane's slots against the
            // pre-leaf t_best; the lane's first minimum
            float tl = __int_as_float(0x7f800000), ul = 0.0f, vl = 0.0f;
            int slot_l = 8;  // 8: no candidate
            int32_t tri_l = -1;
#pragma unroll
            for (int j = 0; j < kSpl; ++j) {
                const int32_t tri = (int32_t)p[9][j];
                const float v0x = p[0][j], v0y = p[1][j], v0z = p[2][j];
                const float e1x = p[3][j] - v0x, e1y = p[4][j] - v0y, e1z = p[5][j] - v0z;
                const float e2x = p[6][j] - v0x, e2y = p[7][j] - v0y, e2z = p[8][j] - v0z;
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = e1x * px + e1y * py + e1z * pz;
                const bool okd = fabsf(det) > 1e-9f;
                // only a leaf row divides by its det: an internal row's
                // planes (3e38 in empty slots) would take the slow path
                const float invdet = 1.0f / ((okd && leaf) ? det : 1.0f);
                const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
                const float u = (tvx * px + tvy * py + tvz * pz) * invdet;
                const float qx = tvy * e1z - tvz * e1y;
                const float qy = tvz * e1x - tvx * e1z;
                const float qz = tvx * e1y - tvy * e1x;
                const float v = (dx * qx + dy * qy + dz * qz) * invdet;
                const float t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
                bool ok = leaf && okd && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                          tri >= 0 && t >= tmin && t < t_best;
                if (kFilter && ok) ok = alpha_accept(at, tri, u, v);
                if (ok && t < tl) {  // slots ascend with j: the first minimum
                    tl = t;
                    ul = u;
                    vl = v;
                    tri_l = tri;
                    slot_l = kSpl * chunk + j;
                }
            }
            if (__any_sync(kFull, slot_l < 8)) {
                // the group's lexicographic minimum of (t, slot)
#pragma unroll
                for (int off = 1; off < kGroup; off *= 2) {
                    const float ot = __shfl_xor_sync(kFull, tl, off, kGroup);
                    const int os = __shfl_xor_sync(kFull, slot_l, off, kGroup);
                    const float ou = __shfl_xor_sync(kFull, ul, off, kGroup);
                    const float ov = __shfl_xor_sync(kFull, vl, off, kGroup);
                    const int otri = __shfl_xor_sync(kFull, tri_l, off, kGroup);
                    if (ot < tl || (ot == tl && os < slot_l)) {
                        tl = ot;
                        slot_l = os;
                        ul = ou;
                        vl = ov;
                        tri_l = otri;
                    }
                }
                if (slot_l < 8) {
                    t_best = tl;
                    tri_best = tri_l;
                    u_best = ul;
                    v_best = vl;
                    if (kAnyHit) {  // terminate on the first accepted hit
                        node = -1;
                        next = true;
                    }
                }
            }
        }
        // leaf, or internal row with no box hit: pop the next sibling.  Every
        // lane of the group reads the top before any lane rewrites it (votes
        // and shuffles do not order shared memory; __syncwarp does)
        const bool pop = live && !next;
        const int2 top = stack[sp > 0 ? sp - 1 : 0];
        __syncwarp(kFull);
        if (pop) {
            if (sp == 0) {
                node = -1;
            } else {
                const int k = __ffs(top.x & 255) - 1;
                const int pslot = k ^ oct;
                const int prem = (top.x & 255) & ~(1 << k);
                node = (top.x >> 8) + ((top.y >> (3 * pslot)) & 7);
                if (prem == 0) {
                    --sp;
                } else {
                    stack[sp - 1].x = (top.x & ~255) | prem;
                }
            }
        }
    }
    if (have_ray && s == 0) {
        out_t[r] = t_best;
        out_tri[r] = tri_best;
        out_u[r] = u_best;
        out_v[r] = v_best;
    }
}

}  // namespace

extern "C" int bvh8_trace_max_depth() { return kMaxDepth; }

extern "C" int bvh8_trace_launch(const float* rows, const float* origin,
                                 const float* direction, const float* tmin,
                                 const float* tmax, int n_rays, int max_steps,
                                 int anyhit, int depth, const float* tri_static,
                                 const float* atlas_q, int atlas_rows, int atlas_w,
                                 float* out_t, int32_t* out_tri, float* out_u,
                                 float* out_v, void* stream) {
    // tri_static == nullptr: no alpha filter.  depth: the stack's entries
    // per ray (BVH8.depth, at most kMaxDepth)
    if (depth < 1 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
    if (n_rays > 0) {
        const long long threads = (long long)n_rays * kGroup;
        const int blocks = (int)((threads + kThreads - 1) / kThreads);
        const size_t smem = (size_t)(kThreads / kGroup) * depth * sizeof(int2);
        cudaStream_t s = (cudaStream_t)stream;
        const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
#define K2_LAUNCH(ANY, FILT)                                                     \
    bvh8_trace_kernel<ANY, FILT><<<blocks, kThreads, smem, s>>>(                 \
        at, rows, origin, direction, tmin, tmax, n_rays, max_steps, depth,      \
        out_t, out_tri, out_u, out_v)
        const bool filt = tri_static != nullptr;
        if (anyhit && filt) K2_LAUNCH(true, true);
        else if (anyhit) K2_LAUNCH(true, false);
        else if (filt) K2_LAUNCH(false, true);
        else K2_LAUNCH(false, false);
#undef K2_LAUNCH
    }
    return (int)cudaGetLastError();
}
