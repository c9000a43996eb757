// K2: BVH8 ray traversal, any-hit and closest-hit.
//
// Replaces the XLA lockstep walk vulkanhybridrenderer_tpu/ops/traverse.py
// _trace8 (reached through trace, the per-ray schedule), and with it the TPU
// packet schedules; the Vulkan original traced these rays on RT cores, which
// an H100 does not have.  One thread per ray walks the (N, 128) BVH8 table of
// ops/bvh8.py with a private stack of (child_base * 256 + remaining slot mask,
// offset map) entries.  Semantics are the reference's exactly:
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
// The alpha any-hit filter (kFilter; the reference's make_alpha_hit_filter,
// traverse.py:922-951, applied at _trace8:264-270) rejects a leaf candidate
// whose base-color alpha at the hit uv is below its material's cutoff, as
// shadetab.fetch_tri_static / interpolate3 / sample_atlas4 compute it: one
// tri_static row (uv0, alpha_mask, base_tex, base_scale, base_offset,
// alpha_cutoff) and one quad row of the atlas.  It is evaluated only for
// candidates that already pass the geometric test (ANDed, so the result is
// the same) and reads the atlas only for masked textured materials: misses
// cost no extra row.  Unfiltered launches compile without it.
//
// Bound on this card: latency of the dependent row loads.  Each step reads
// one 512-byte row whose address depends on the previous step, and the table
// (~10 MB for the 108k-triangle benchmark scene) stays in the 50 MB L2, so a
// warp's step costs an L2 round trip plus ~100-200 FP32 ops.  The design
// keeps many independent rays in flight (one thread each, small register
// footprint, stack in local memory that stays in L1) so the SMs hide that
// latency by switching warps; rays whose walks end early just retire.
// Divergence between the 32 rays of a warp is the main loss and is work for
// later changes (ray sorting, wider node tests per warp).
//
// Built with --fmad=false so every product rounds like the plain PyTorch
// version and hit / miss decisions on triangle edges agree.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDepth = 64;  // stack entries per ray (BVH8.depth bound)
constexpr int kTriStaticW = 60;  // ShadeTables.tri_static columns
// tri_static columns (shadetab.py: TriRow [12:72), PrimRow folded in at 28)
constexpr int kUv0 = 21, kBaseTex = 32, kBaseScale = 33, kBaseOffset = 35,
              kAlphaMask = 49, kAlphaCutoff = 50;

struct AlphaTables {
    const float* tri_static;  // (T, 60)
    const float* atlas_q;     // (AH * AW, 16) quad rows
    int atlas_rows, atlas_w;
};

__device__ __forceinline__ float remainder_torch(float a, float b) {
    // torch.remainder / jnp.remainder: the sign of the divisor
    float m = fmodf(a, b);
    if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
    return m;
}

__device__ bool alpha_accept(const AlphaTables& at, int tri, float u, float v) {
    const float* row = at.tri_static + (size_t)tri * kTriStaticW;
    const int tex = (int)row[kBaseTex];
    if (!(row[kAlphaMask] == 1.0f) || tex < 0) return true;
    // interpolate3(uv0, (1 - u - v, u, v)): (a0 w0 + a1 w1) + a2 w2
    const float w0 = (1.0f - u) - v;
    const float uvx = (row[kUv0] * w0 + row[kUv0 + 2] * u) + row[kUv0 + 4] * v;
    const float uvy = (row[kUv0 + 1] * w0 + row[kUv0 + 3] * u) + row[kUv0 + 5] * v;
    // sample_atlas4: REPEAT wrap, half-texel centres, clamped address
    const float sx = row[kBaseScale], sy = row[kBaseScale + 1];
    const float tx = (uvx - floorf(uvx)) * sx - 0.5f;
    const float ty = (uvy - floorf(uvy)) * sy - 0.5f;
    const float t0x = floorf(tx), t0y = floorf(ty);
    const float fx = tx - t0x, fy = ty - t0y;
    const float x0 = remainder_torch(t0x, fmaxf(sx, 1.0f));
    const float y0 = remainder_torch(t0y, fmaxf(sy, 1.0f));
    long long lin = (long long)(row[kBaseOffset + 1] + y0) * at.atlas_w +
                    (long long)(row[kBaseOffset] + x0);
    lin = lin < 0 ? 0 : (lin >= at.atlas_rows ? at.atlas_rows - 1 : lin);
    const float* q = at.atlas_q + lin * 16;  // c00 c10 c01 c11, alpha at 3
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    const float alpha = ((q[3] * gx * gy + q[7] * fx * gy) + q[11] * gx * fy) +
                        q[15] * fx * fy;
    return !(alpha < row[kAlphaCutoff]);
}

__device__ __forceinline__ int first_slot(int mask, int oct) {
    // first set slot of `mask` in slot ^ octant order (mask != 0)
    for (int k = 0; k < 8; ++k) {
        const int slot = k ^ oct;
        if ((mask >> slot) & 1) return slot;
    }
    return oct;
}

template <bool kAnyHit, bool kFilter>
__global__ void bvh8_trace_kernel(AlphaTables at,
                                  const float* __restrict__ rows,
                                  const float* __restrict__ origin,
                                  const float* __restrict__ direction,
                                  const float* __restrict__ tmin_a,
                                  const float* __restrict__ tmax_a,
                                  int n_rays, int max_steps,
                                  float* __restrict__ out_t,
                                  int32_t* __restrict__ out_tri,
                                  float* __restrict__ out_u,
                                  float* __restrict__ out_v) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rays) return;
    const float ox = origin[3 * r], oy = origin[3 * r + 1], oz = origin[3 * r + 2];
    const float dx = direction[3 * r], dy = direction[3 * r + 1],
                dz = direction[3 * r + 2];
    const float tmin = tmin_a[r];
    float t_best = tmax_a[r];
    int32_t tri_best = -1;
    float u_best = 0.0f, v_best = 0.0f;

    if (!(t_best < tmin)) {
        const float sdx = fabsf(dx) < 1e-12f ? (dx >= 0.0f ? 1e-12f : -1e-12f) : dx;
        const float sdy = fabsf(dy) < 1e-12f ? (dy >= 0.0f ? 1e-12f : -1e-12f) : dy;
        const float sdz = fabsf(dz) < 1e-12f ? (dz >= 0.0f ? 1e-12f : -1e-12f) : dz;
        const float ix = 1.0f / sdx, iy = 1.0f / sdy, iz = 1.0f / sdz;
        const int oct = ((dx < 0.0f) << 2) | ((dy < 0.0f) << 1) | (dz < 0.0f);

        int stack_a[kMaxDepth];
        int stack_b[kMaxDepth];
        int sp = 0;
        int node = 0;  // root row
        for (int step = 0; node >= 0 && step < max_steps; ++step) {
            const float* row = rows + (size_t)node * 128;
            if (!(row[127] > 0.5f)) {
                // internal row: 8-wide slab test
                int mask = 0;
#pragma unroll
                for (int s = 0; s < 8; ++s) {
                    const float lox = row[s], hix = row[24 + s];
                    const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
                    const float t0y = (row[8 + s] - oy) * iy, t1y = (row[32 + s] - oy) * iy;
                    const float t0z = (row[16 + s] - oz) * iz, t1z = (row[40 + s] - oz) * iz;
                    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                           fminf(t0z, t1z));
                    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                           fmaxf(t0z, t1z));
                    const bool hit = (fmaxf(tn, tmin) <= fminf(tf, t_best)) && (lox <= hix);
                    mask |= (int)hit << s;
                }
                if (mask != 0) {
                    const int base = (int)row[48];
                    const int offmap = (int)row[49];
                    const int slot = first_slot(mask, oct);
                    const int remaining = mask & ~(1 << slot);
                    if (remaining != 0) {
                        stack_a[sp] = base * 256 + remaining;
                        stack_b[sp] = offmap;
                        ++sp;
                    }
                    node = base + ((offmap >> (3 * slot)) & 7);
                    continue;
                }
            } else {
                // leaf row: 8-wide Moller-Trumbore against the pre-leaf t_best
                const float t_limit = t_best;
                bool have = false;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const int32_t tri = (int32_t)row[72 + j];
                    const float v0x = row[j], v0y = row[8 + j], v0z = row[16 + j];
                    const float e1x = row[24 + j] - v0x;
                    const float e1y = row[32 + j] - v0y;
                    const float e1z = row[40 + j] - v0z;
                    const float e2x = row[48 + j] - v0x;
                    const float e2y = row[56 + j] - v0y;
                    const float e2z = row[64 + j] - v0z;
                    const float px = dy * e2z - dz * e2y;
                    const float py = dz * e2x - dx * e2z;
                    const float pz = dx * e2y - dy * e2x;
                    const float det = e1x * px + e1y * py + e1z * pz;
                    const bool okd = fabsf(det) > 1e-9f;
                    const float invdet = 1.0f / (okd ? det : 1.0f);
                    const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
                    const float u = (tvx * px + tvy * py + tvz * pz) * invdet;
                    const float qx = tvy * e1z - tvz * e1y;
                    const float qy = tvz * e1x - tvx * e1z;
                    const float qz = tvx * e1y - tvy * e1x;
                    const float v = (dx * qx + dy * qy + dz * qz) * invdet;
                    const float t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
                    bool ok = okd && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                              tri >= 0 && t >= tmin && t < t_limit;
                    if (kFilter && ok) ok = alpha_accept(at, tri, u, v);
                    if (ok && (!have || t < t_best)) {
                        have = true;
                        t_best = t;
                        tri_best = tri;
                        u_best = u;
                        v_best = v;
                    }
                }
                if (kAnyHit && have) break;  // terminate on first accepted hit
            }
            // leaf, or internal row with no box hit: pop the next sibling
            if (sp == 0) {
                node = -1;
            } else {
                const int top = stack_a[sp - 1];
                const int pslot = first_slot(top & 255, oct);
                const int prem = (top & 255) & ~(1 << pslot);
                node = (top >> 8) + ((stack_b[sp - 1] >> (3 * pslot)) & 7);
                stack_a[sp - 1] = (top & ~255) | prem;
                if (prem == 0) --sp;
            }
        }
    }
    out_t[r] = t_best;
    out_tri[r] = tri_best;
    out_u[r] = u_best;
    out_v[r] = v_best;
}

}  // namespace

extern "C" int bvh8_trace_max_depth() { return kMaxDepth; }

extern "C" int bvh8_trace_launch(const float* rows, const float* origin,
                                 const float* direction, const float* tmin,
                                 const float* tmax, int n_rays, int max_steps,
                                 int anyhit, const float* tri_static,
                                 const float* atlas_q, int atlas_rows, int atlas_w,
                                 float* out_t, int32_t* out_tri, float* out_u,
                                 float* out_v, void* stream) {
    // tri_static == nullptr: no alpha filter
    if (n_rays > 0) {
        const int threads = 128;
        const int blocks = (n_rays + threads - 1) / threads;
        cudaStream_t s = (cudaStream_t)stream;
        const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
#define K2_LAUNCH(ANY, FILT)                                                     \
    bvh8_trace_kernel<ANY, FILT><<<blocks, threads, 0, s>>>(                     \
        at, rows, origin, direction, tmin, tmax, n_rays, max_steps, out_t,      \
        out_tri, out_u, out_v)
        const bool filt = tri_static != nullptr;
        if (anyhit && filt) K2_LAUNCH(true, true);
        else if (anyhit) K2_LAUNCH(true, false);
        else if (filt) K2_LAUNCH(false, true);
        else K2_LAUNCH(false, false);
#undef K2_LAUNCH
    }
    return (int)cudaGetLastError();
}
