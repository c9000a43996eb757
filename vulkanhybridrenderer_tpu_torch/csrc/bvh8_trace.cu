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
// which depend on the rays, priced per slot of a visited row: 26 a box (an
// internal row's non-empty slot: 6 FADD + 6 FMUL of the slab planes, 10 min
// / max, the interval's 2 min / max and 2 compares), 59 a triangle (a leaf
// row's non-empty slot: Moller-Trumbore), 1 an empty slot (the compare that
// rejects it), 53 a filter evaluation, and on bf16 rows the decode the
// kernel still does (below: 9 a triangle); chip_smoke.py prices each launch
// from the rows and slots trace_plain(visits=True) counts.  What holds the
// kernel far above that is the instructions around those operations (loads,
// shuffles, the stack, the branch each row kind takes) and lanes that idle:
// a warp walks until the longest of its rays ends, and runs the leaf code
// for every ray whenever one of them stands on a leaf.
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
// Row kinds (kKind; ops/bvh8.py, the reference's three tables).  kF32x8,
// the (N, 128) f32 table with 8-triangle leaves: bvh8_trace_kernel, the
// code above, walking the table in place.  kF32x12 (f32 rows whose leaves
// hold 12 triangles) and kBf16x8 (table_to_bf16's 256-byte bf16 rows):
// bvh8_trace_packed, over the lane-major copy ops/traverse.pack_rows makes
// once per table on its device, at the table's bytes (BVH8.rows stays the
// reference's).  Walked in place, these tables would spend a step's time on
// what their layout asks: for bf16 rows 14 loads a lane (a plane each, the
// centroid, the flag), a decode of every row whatever its kind (24
// unpacks, 18 centroid adds) and six shuffles to gather the child base's
// and offset map's 8-bit pieces; for leaf-12 rows 30 scalar loads a lane
// on every leaf step, after the flag.  A packed row is four
// regions, one a lane's chunk c, interleaved by 16 bytes (granule v of
// region c is the row's 4v + c: the group's v-th loads read 64 contiguous
// bytes), each holding every word its lane reads:
//   internal rows (both kinds): the slab planes of slots 2c, 2c + 1 in f32
//     (w[2k + j]; a bf16 row's values widened, exactly: an internal step
//     decodes nothing), w12 the first child row, w13 the offset map;
//   bf16 leaf rows (16 words, 64 B): w0..w8 the bf16 pairs of the vertex
//     planes at slots 2c, 2c + 1 as the row holds them, w9, w10 their
//     triangle ids, w11..w13 the centroid c_hi + c_lo summed in f32;
//   leaf-12 rows (32 words, 128 B): the vertex planes of slots c + 4j at
//     word 9j + k and their ids at 27 + j, skipping w15;
//   w15 the flag.
// A bf16 step issues its region's 4 loads of 16 bytes before any use: one
// round trip.  A leaf-12 step issues the first 4 (an internal row's words
// and the flag) and, where a ray of the warp stands on a leaf, the other 4
// in the leaf code; slots 8..11 (a lane's third) are tested only where a
// ray of the warp has a triangle there.  The decode left is what the
// reference's arithmetic asks of a bf16 leaf: each vertex coordinate,
// exact in f32 from its bf16 bits (a shift or a mask), plus its centroid
// (decode_rows' FADD).  Every lane reads the child base and offset map from
// its own region: no shuffle.  The slab tests, Moller-Trumbore, the
// group's reductions, the warp-uniform control and the shared-memory stack
// are bvh8_trace_kernel's.  Development runs on realglb's and
// SponzaProxy's wavefronts held other designs against this one in turns
// (PERF.md §6): regions one after another (a load of the group touching
// four 128-byte lines), each step loading half a region where the parent
// row's per-slot leaf bits said the next row was internal (slower for both
// kinds), a leaf-12 region loaded whole in one round trip (slower than the
// split), 64 or 72 registers forced by __launch_bounds__ (slower for bf16,
// mixed for leaf-12), and leaf-12 slots without the vote (slower).
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
// row kinds: f32 rows with 8-triangle leaves, with 12, bf16 rows with 8
constexpr int kF32x8 = 0, kF32x12 = 1, kBf16x8 = 2;
constexpr unsigned kFull = 0xffffffffu;

// a bf16's f32 value: its bits in the high half
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Moller-Trumbore of one slot in the reference's operation order; ok: the
// geometric hit before the t and id tests.  Only a leaf row divides by its
// det: an internal row's planes (3e38 in empty slots) would take the
// division's slow path.
__device__ __forceinline__ void slot_mt(const float (&lv)[9], float ox, float oy, float oz,
                                        float dx, float dy, float dz, bool leaf, float& t,
                                        float& u, float& v, bool& ok) {
    const float v0x = lv[0], v0y = lv[1], v0z = lv[2];
    const float e1x = lv[3] - v0x, e1y = lv[4] - v0y, e1z = lv[5] - v0z;
    const float e2x = lv[6] - v0x, e2y = lv[7] - v0y, e2z = lv[8] - v0z;
    const float px = dy * e2z - dz * e2y;
    const float py = dz * e2x - dx * e2z;
    const float pz = dx * e2y - dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool okd = fabsf(det) > 1e-9f;
    const float invdet = 1.0f / ((okd && leaf) ? det : 1.0f);
    const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
    u = (tvx * px + tvy * py + tvz * pz) * invdet;
    const float qx = tvy * e1z - tvz * e1y;
    const float qy = tvz * e1x - tvx * e1z;
    const float qz = tvx * e1y - tvy * e1x;
    v = (dx * qx + dy * qy + dz * qz) * invdet;
    t = (e2x * qx + e2y * qy + e2z * qz) * invdet;
    ok = okd && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// one slot's slab test in the reference's operation order
__device__ __forceinline__ bool slot_slab(float lox, float loy, float loz, float hix,
                                          float hiy, float hiz, float ox, float oy, float oz,
                                          float ix, float iy, float iz, float tmin,
                                          float t_best) {
    const float t0x = (lox - ox) * ix, t1x = (hix - ox) * ix;
    const float t0y = (loy - oy) * iy, t1y = (hiy - oy) * iy;
    const float t0z = (loz - oz) * iz, t1z = (hiz - oz) * iz;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return (fmaxf(tn, tmin) <= fminf(tf, t_best)) && (lox <= hix);
}

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

    // the planes a step loads at this lane's chunk, [0:80)
    constexpr int kPlanes = 10;
    int node = (have_ray && !(t_best < tmin)) ? 0 : -1;  // root row, or done
    int sp = 0;
    for (int step = 0;; ++step) {
        const bool live = node >= 0 && step < max_steps;
        if (!__any_sync(kFull, live)) break;
        // every load of the step before any use: the planes at this lane's
        // slots, and the leaf flag.  A ray that has ended reads row 0.
        const float* row = rows + (size_t)(live ? node : 0) * 128;
        float p[kPlanes][kSpl];
#pragma unroll
        for (int k = 0; k < kPlanes; ++k) {
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
            constexpr int kNoSlot = kGroup * kSpl;  // the row's slots
            float tl = __int_as_float(0x7f800000), ul = 0.0f, vl = 0.0f;
            int slot_l = kNoSlot;  // no candidate
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
                    slot_l = chunk * kSpl + j;
                }
            }
            if (__any_sync(kFull, slot_l < kNoSlot)) {
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
                if (slot_l < kNoSlot) {
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

// the packed regions' words (ops/traverse.pack_rows; the note above)
template <int kKind>
struct Packed {
    static constexpr int kWords = kKind == kBf16x8 ? 16 : 32;  // a region
    static constexpr int kVec = kWords / 4;  // 16-byte loads of a leaf row
    // 16-byte loads a step issues before its flag is known: all of a bf16
    // region; the first half of a leaf-12 one (an internal row's words and
    // the flag), its second half only where a ray stands on a leaf
    static constexpr int kStepVec = kKind == kF32x12 ? 4 : kVec;
    static constexpr int kFlag = 15;
    static constexpr int kBase = 12;  // first child row
    static constexpr int kOffmap = 13;  // offset map
    static constexpr int kLeafSpl = kKind == kBf16x8 ? 2 : 3;  // leaf slots a lane
    // region c's leaf slot j: 2c + j in bf16 rows, c + 4j in leaf-12 rows
    static __device__ __forceinline__ constexpr int leaf_slot(int c, int j) {
        return kKind == kBf16x8 ? 2 * c + j : c + kGroup * j;
    }
    static constexpr int kCen = 11;  // bf16: the centroid, 3 words
    // a leaf-12 region's logical word i (planes 9j + k, ids 27 + j) skips w15
    static __device__ __forceinline__ constexpr int leaf(int i) { return i < kFlag ? i : i + 1; }
};

template <int kKind, bool kAnyHit, bool kFilter>
__global__ void __launch_bounds__(kThreads)
bvh8_trace_packed(AlphaTables at, const uint4* __restrict__ packed,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  const float* __restrict__ tmin_a,
                  const float* __restrict__ tmax_a, int n_rays, int max_steps,
                  int depth, float* __restrict__ out_t,
                  int32_t* __restrict__ out_tri, float* __restrict__ out_u,
                  float* __restrict__ out_v) {
    using P = Packed<kKind>;
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
    // lane s reads region c = s ^ (oct >> 1): an internal row's slots 2c and
    // 2c + 1, visited at positions 2s + (j ^ (oct & 1)), as bvh8_trace_kernel
    const int chunk = s ^ (oct >> 1);
    const int jflip = oct & 1;

    int node = (have_ray && !(t_best < tmin)) ? 0 : -1;  // root row, or done
    int sp = 0;
    for (int step = 0;; ++step) {
        const bool live = node >= 0 && step < max_steps;
        if (!__any_sync(kFull, live)) break;
        // every load of the step before any use: the lane's region of the
        // row, whose 16-byte granule v is the row's (4v + c)-th, so that a
        // load v of the group's four lanes reads 64 contiguous bytes.  A
        // ray that has ended reads row 0.
        const uint4* reg = packed + (size_t)(live ? node : 0) * (kGroup * P::kVec) + chunk;
        unsigned w[P::kWords];
#pragma unroll
        for (int v = 0; v < P::kStepVec; ++v) {
            const uint4 q = __ldg(reg + kGroup * v);
            w[4 * v] = q.x;
            w[4 * v + 1] = q.y;
            w[4 * v + 2] = q.z;
            w[4 * v + 3] = q.w;
        }
        const bool leaf = live && w[P::kFlag] != 0u;
        const bool internal = live && w[P::kFlag] == 0u;
        bool next = false;  // the ray has its next row (a child), or is done
        if (__any_sync(kFull, internal)) {
            // internal row: the slab tests of this lane's slots
            int mask = 0;
#pragma unroll
            for (int j = 0; j < kSpl; ++j) {
                float pl[6];
#pragma unroll
                for (int k = 0; k < 6; ++k) pl[k] = __uint_as_float(w[2 * k + j]);
                const bool hit = slot_slab(pl[0], pl[1], pl[2], pl[3], pl[4], pl[5], ox, oy,
                                           oz, ix, iy, iz, tmin, t_best);
                mask |= (int)hit << (kSpl * s + (j ^ jflip));
            }
#pragma unroll
            for (int off = 1; off < kGroup; off *= 2)
                mask |= __shfl_xor_sync(kFull, mask, off, kGroup);
            if (internal && mask != 0) {
                const int base = (int)w[P::kBase];
                const int offmap = (int)w[P::kOffmap];
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
            constexpr int kNoSlot = kGroup * P::kLeafSpl;  // the row's slots
            // a leaf-12 region's second half (every lane: the warp runs
            // this code when any of its rays stands on a leaf)
#pragma unroll
            for (int v = P::kStepVec; v < P::kVec; ++v) {
                const uint4 q = __ldg(reg + kGroup * v);
                w[4 * v] = q.x;
                w[4 * v + 1] = q.y;
                w[4 * v + 2] = q.z;
                w[4 * v + 3] = q.w;
            }
            float tl = __int_as_float(0x7f800000), ul = 0.0f, vl = 0.0f;
            int slot_l = kNoSlot;  // no candidate
            int32_t tri_l = -1;
#pragma unroll
            for (int j = 0; j < P::kLeafSpl; ++j) {
                float lv[9];
                int32_t tri;
                if constexpr (kKind == kBf16x8) {
                    // the decode_rows order: the bf16 value, then + (c_hi + c_lo)
                    const float cen[3] = {__uint_as_float(w[P::kCen]),
                                          __uint_as_float(w[P::kCen + 1]),
                                          __uint_as_float(w[P::kCen + 2])};
#pragma unroll
                    for (int k = 0; k < 9; ++k)
                        lv[k] = (j == 0 ? bf16_lo(w[k]) : bf16_hi(w[k])) + cen[k % 3];
                    tri = (int32_t)w[9 + j];
                } else {
                    tri = (int32_t)w[P::leaf(27 + j)];
                    // slots 8..11: tested where a ray of the warp has a
                    // triangle there
                    if (j == 2 && !__any_sync(kFull, leaf && tri >= 0)) continue;
#pragma unroll
                    for (int k = 0; k < 9; ++k) lv[k] = __uint_as_float(w[P::leaf(9 * j + k)]);
                }
                float t, u, v;
                bool ok;
                slot_mt(lv, ox, oy, oz, dx, dy, dz, leaf, t, u, v, ok);
                ok = leaf && ok && tri >= 0 && t >= tmin && t < t_best;
                if (kFilter && ok) ok = alpha_accept(at, tri, u, v);
                if (ok && t < tl) {  // slots ascend with j: the first minimum
                    tl = t;
                    ul = u;
                    vl = v;
                    tri_l = tri;
                    slot_l = P::leaf_slot(chunk, j);
                }
            }
            if (__any_sync(kFull, slot_l < kNoSlot)) {
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
                if (slot_l < kNoSlot) {
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
        // leaf, or internal row with no box hit: pop the next sibling, as
        // bvh8_trace_kernel
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

// one launch of the kind's kernel in one mode
template <bool kAnyHit, bool kFilter>
void launch_mode(int kind, int blocks, size_t smem, cudaStream_t stream, const AlphaTables& at,
                 const void* rows, const float* origin, const float* direction,
                 const float* tmin, const float* tmax, int n_rays, int max_steps, int depth,
                 float* out_t, int32_t* out_tri, float* out_u, float* out_v) {
    if (kind == kF32x8)
        bvh8_trace_kernel<kAnyHit, kFilter><<<blocks, kThreads, smem, stream>>>(
            at, static_cast<const float*>(rows), origin, direction, tmin, tmax, n_rays,
            max_steps, depth, out_t, out_tri, out_u, out_v);
    else if (kind == kF32x12)
        bvh8_trace_packed<kF32x12, kAnyHit, kFilter><<<blocks, kThreads, smem, stream>>>(
            at, static_cast<const uint4*>(rows), origin, direction, tmin, tmax, n_rays,
            max_steps, depth, out_t, out_tri, out_u, out_v);
    else
        bvh8_trace_packed<kBf16x8, kAnyHit, kFilter><<<blocks, kThreads, smem, stream>>>(
            at, static_cast<const uint4*>(rows), origin, direction, tmin, tmax, n_rays,
            max_steps, depth, out_t, out_tri, out_u, out_v);
}

}  // namespace

extern "C" int bvh8_trace_max_depth() { return kMaxDepth; }

extern "C" int bvh8_trace_launch(const void* rows, const float* origin,
                                 const float* direction, const float* tmin,
                                 const float* tmax, int n_rays, int max_steps,
                                 int anyhit, int depth, int kind,
                                 const float* tri_static, const float* atlas_q,
                                 int atlas_rows, int atlas_w, float* out_t,
                                 int32_t* out_tri, float* out_u, float* out_v,
                                 void* stream) {
    // tri_static == nullptr: no alpha filter.  depth: the stack's entries
    // per ray (BVH8.depth, at most kMaxDepth).  kind: the rows' kind, kF32x8
    // (rows: the (N, 128) float table), or kF32x12 or kBf16x8 (rows: the
    // table's pack_rows copy, 16-byte aligned)
    if (depth < 1 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
    if (kind != kF32x8 && kind != kF32x12 && kind != kBf16x8)
        return (int)cudaErrorInvalidValue;
    if (kind != kF32x8 && (reinterpret_cast<uintptr_t>(rows) & 15) != 0)
        return (int)cudaErrorMisalignedAddress;
    if (n_rays > 0) {
        const long long threads = (long long)n_rays * kGroup;
        const int blocks = (int)((threads + kThreads - 1) / kThreads);
        const size_t smem = (size_t)(kThreads / kGroup) * depth * sizeof(int2);
        cudaStream_t s = (cudaStream_t)stream;
        const AlphaTables at{tri_static, atlas_q, atlas_rows, atlas_w};
        const bool filt = tri_static != nullptr;
        auto* launch = anyhit ? (filt ? launch_mode<true, true> : launch_mode<true, false>)
                              : (filt ? launch_mode<false, true> : launch_mode<false, false>);
        launch(kind, blocks, smem, s, at, rows, origin, direction, tmin, tmax, n_rays,
               max_steps, depth, out_t, out_tri, out_u, out_v);
    }
    return (int)cudaGetLastError();
}
