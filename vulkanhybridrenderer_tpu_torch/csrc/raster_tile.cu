// K1a, K1b, K1c, K1d: binned tile depth test (the opaque, peel-bound,
// compact-tile and multisample modes of the tile raster).
//
// Replaces the Pallas kernel vulkanhybridrenderer_tpu/ops/rasterizer_tiled.py
// _raster_kernel (launched by rasterize_binned, pallas_call at :567).  For
// every 128x8 screen tile it walks the tile's binned triangle entries and
// evaluates the homogeneous planes l0, l1, l2 and z = A*px + B*py + C at pixel
// centres.  A pixel is covered when l0, l1, l2 >= 0 and 0 <= z <= 1; the
// winner is the lexicographic max of (z, triangle id): reverse-Z, larger id
// on ties.  Per pixel it writes depth (clear 0), tri id (-1), and bary =
// (l1, l2, l0 + l1 + l2) (clear 0, 0, 1), straight into (H, W) / (H, W, 3)
// images.
//
// The three modes are one template:
//   K1a  raster_tile_launch          every tile, no bound (the opaque stream).
//   K1b  raster_tile_peel_launch     every tile; a fragment is a candidate only
//        when it is also strictly below the pixel's depth-peel bound
//        (zcap, captid) in (z, id) order: z < zc || (z == zc && id < tc)
//        (the reference's z_cap / tid_cap mode, :387-398).  Ids are int32
//        here; the reference holds them as f32, which compares the same for
//        ids below 2^24.
//   K1c  raster_tile_compact_launch  K1b over a list of physical tiles: block
//        b rasters tile tile_ids[b] from that tile's entry range and writes
//        only that tile's pixels (the reference's tile_ids remap mode,
//        :301-305, :453-455).  The caller pre-fills the outputs with the
//        clear values, so on the listed tiles the result equals K1b's
//        full-width round bit for bit, and elsewhere it stays clear.  The
//        list's length is counted on the device: the grid covers every slot
//        of the buffer (one per tile of the image), and a block whose slot
//        is at or past *n_live, or holds -1, exits before its first load of
//        the tile, so the peel never waits for the host to size a round.
// K1d (raster_tile_msaa_launch) is a kernel of its own, templated on the
// sample count: K1a at the 2, 4 or 8 standard Vulkan sample positions, where
// the reference runs its kernel once per sample on C-shifted entry copies
// (rasterize_scene_msaa:1031-1036).  Here the entry stream is read once and
// each staged entry is tested at every sample, in one launch.
//
// The bound on this card.  The parent kernel tested every (entry, pixel)
// pair at ~23 FP32 instructions: FP32 issue bound, with a tile holding ~110
// entries on SponzaProxy's 1080p frame and a triangle covering a few dozen
// of the tile's 1,024 pixels, so most of the work went to pixels the
// triangle cannot cover.  The TPU design fed 128 entries per matmul against
// the whole tile; this one culls first.  What is left: the operations of the
// (entry, sub-tile) pairs that pass (~9% of them), each block's fixed cost
// (offsets -> entry ids -> rows, three barriers a batch, the bary recompute)
// and the 20 bytes a pixel of outputs, which set the 4096^2 shadow map's
// bound.  One block owns one 128x8 tile, 512 threads: warp w owns the 8x4
// sub-tiles w and w + 16 (an 8x8 block of pixels), a thread one pixel in
// each.  The design does three things:
//   1. Exact sub-tile culling.  While a batch is staged, warp w takes entries
//      w, w + 16, ..., lane s tests sub-tile s at two corner pixel centres,
//      and __ballot_sync makes the entry's 32-bit mask.  The kernel
//      evaluates a plane as fl(fl(fl(px*A) + fl(py*B)) + C) (--fmad=false);
//      rounding is monotone, so over a sub-tile's pixel centres its maximum
//      is that expression at the corner picked by the signs of A and B, its
//      minimum at the opposite one.  A pair is culled only when some l_k's
//      maximum < 0, or z's maximum < 0, or z's minimum > 1: then no pixel of
//      the sub-tile passes the coverage test.  A NaN compares false and keeps
//      the pair; inf + -inf is NaN and keeps it too.  The result is the
//      dense test's bit for bit, by construction.  A warp then loads 32
//      masks a lane at a time, ballots whether its bits are set and walks
//      the set bits with __ffs: a culled entry costs it a fraction of an
//      instruction, and each of its pixels is tested only where its own
//      sub-tile's bit is set.
//   2. Vector staging, double-buffered.  An entry is staged as its 48-byte
//      plane row, three 16-byte cp.async copies into shared memory, while the
//      previous batch is tested; a test reads it as three broadcast float4
//      loads and the id (13 scalar loads before).  The wrapper checks that
//      `planes` is 16-byte aligned.
//   3. Winners of two registers.  A pixel keeps (z, id) only; bary is
//      recomputed from the winner's row at the end, with the same operations,
//      so it is the same bits.
// K1d culls per sample: a pair passes when some sample's shifted planes pass
// the corner test, and the warp then tests all its samples.  No atomics, no
// second pass; tiles run independently in any order.
//
// Measured on SponzaProxy, the parent's kernel timed in turns in the same
// call (NVIDIA H100 80GB HBM3, 700.00 W): K1a 0.098 ms at 1920x1080 (0.497
// before this design) and 0.246 ms on the 4096^2 light view (0.935), K1d
// 0.225 ms at 4 samples (1.246), K1b 0.026 ms (0.028), K1c a tie at ~0.02
// ms (few entries).  K1a's bound at 1080p (every triangle, as chip_smoke.py
// times it) counts the operations of the pairs that pass: 8 sign compares
// an entry (they depend on A and B alone; the kernel repeats them on every
// lane), 25 a corner test of an (entry, sub-tile) pair, 23 a pixel of a
// passing pair.  That is 0.0197 ms at the card's FP32 rate, a share of 0.19
// of the kernel's 0.10 ms (the dense test's bound: 0.157 ms).  K1d's and
// the light view's bounds are set by their outputs' bytes.  A thread a
// pixel (1,024 threads, one 8x4 sub-tile a warp) was up to 10% faster at
// 1080p and 37% slower on the light view;
// persistent blocks that prefetch their next tile, tiles in descending order
// of entries and other batch sizes lost (PERF.md, section 6).
//
// Built with --fmad=false: a*b+c must round exactly like the plain PyTorch
// version (separately rounded multiply and add), or edge pixels flip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 128, kTileH = 8;  // the bins' tile (TILE_W, TILE_H)
constexpr int kSubW = 8, kSubH = 4;      // a sub-tile: one bit of an entry's mask
constexpr int kSubX = kTileW / kSubW;    // 16 sub-tiles across, 2 down
constexpr int kSubtiles = kSubX * (kTileH / kSubH);  // 32: one mask bit each
constexpr int kPix = kTileH / kSubH;     // pixels a thread: 2, one a sub-tile row
constexpr int kThreads = kTileW * kTileH / kPix;  // 512
constexpr int kWarps = kThreads / 32;    // warp w owns sub-tiles w and w + 16
constexpr int kBatch = 256;              // entries staged per batch
constexpr unsigned kFull = 0xffffffffu;
// bound of pixels outside the image: no fragment (z >= 0) is below it
constexpr float kNoCandidate = -3.4e38f;

static_assert(kSubtiles == 32, "one mask bit per sub-tile, one lane each");
static_assert(kWarps == kSubX, "warp w owns the sub-tile column w");
static_assert(kBatch <= kThreads, "one staging thread per entry");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A staged entry: its plane row {A0 B0 C0 A1} {B1 C1 A2 B2} {C2 A3 B3 C3}.
struct Row {
    float4 q[3];
};

// Double-buffered batch: rows, ids and sub-tile masks.
struct Stage {
    Row rows[2][kBatch];
    int32_t ids[2][kBatch];
    uint32_t masks[2][kBatch];
};

// Thread t < n copies entry base + t's row into the batch buffer; every
// thread commits a (possibly empty) group, so wait counts agree.
__device__ __forceinline__ void stage_batch(const float* __restrict__ planes,
                                            const int32_t* __restrict__ entry_tri,
                                            int base, int n, Row* rows, int32_t* ids) {
    const int t = threadIdx.x;
    if (t < n) {
        const int32_t id = entry_tri[base + t];
        const float4* src = reinterpret_cast<const float4*>(planes) + (size_t)id * 3;
        cp_async16(&rows[t].q[0], src);
        cp_async16(&rows[t].q[1], src + 1);
        cp_async16(&rows[t].q[2], src + 2);
        ids[t] = id;
    }
    cp_async_commit();
}

// (px * A + py * B), each operation rounded (--fmad=false).
__device__ __forceinline__ float ab(float px, float py, float a, float b) {
    return px * a + py * b;
}

// The corner pixel centres of a plane's maximum over a sub-tile.
__device__ __forceinline__ float corner_max(float a, float b, float xl, float xh,
                                            float yl, float yh) {
    return ab(a > 0.0f ? xh : xl, b > 0.0f ? yh : yl, a, b);
}
__device__ __forceinline__ float corner_min(float a, float b, float xl, float xh,
                                            float yl, float yh) {
    return ab(a > 0.0f ? xl : xh, b > 0.0f ? yl : yh, a, b);
}

// The corner test of one sub-tile with constants (c0, c1, c2, cz) added to
// the four planes' corner products: false only when no pixel centre of the
// sub-tile can pass the coverage test (written so that NaN passes).
__device__ __forceinline__ bool corner_pass(float m0, float m1, float m2, float mz,
                                            float nz, float c0, float c1, float c2,
                                            float cz) {
    return !((m0 + c0 < 0.0f) | (m1 + c1 < 0.0f) | (m2 + c2 < 0.0f) |
             (mz + cz < 0.0f) | (nz + cz > 1.0f));
}

// The pixels of lane `lane` of warp `warp`: lane (l % 8, l / 8) of its
// sub-tiles w and w + 16, column x, rows y0 and y0 + 4 (pixel j at
// y0 + j * kSubH).
__device__ __forceinline__ void pixels_of(int tx0, int ty0, int warp, int lane, int& x,
                                          int& y0) {
    x = tx0 + warp * kSubW + lane % kSubW;
    y0 = ty0 + lane / kSubW;
}

// The mask bits of a warp's sub-tiles.
__device__ __forceinline__ uint32_t warp_bits(int warp) {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < kPix; ++j) m |= 1u << (warp + j * kWarps);
    return m;
}

// Lane s's sub-tile corners in the tile at (tx0, ty0).
struct Corners {
    float xl, xh, yl, yh;
};
__device__ __forceinline__ Corners subtile_corners(int tx0, int ty0, int s) {
    const int x = tx0 + (s % kSubX) * kSubW;
    const int y = ty0 + (s / kSubX) * kSubH;
    return {(float)x + 0.5f, (float)(x + kSubW - 1) + 0.5f, (float)y + 0.5f,
            (float)(y + kSubH - 1) + 0.5f};
}

// bary of the winner's row at (px, py), plane constants shifted by (dx, dy)
// when kShift (K1d), as the test computed them.
template <bool kShift>
__device__ __forceinline__ void winner_bary(const float* __restrict__ planes, int32_t id,
                                            float px, float py, float dx, float dy,
                                            float& b1, float& b2, float& s) {
    const float4* row = reinterpret_cast<const float4*>(planes) + (size_t)id * 3;
    const float4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2);
    float c0 = q0.z, c1 = q1.y, c2 = q2.x;
    if (kShift) {
        c0 = c0 + (q0.x * dx + q0.y * dy);
        c1 = c1 + (q0.w * dx + q1.x * dy);
        c2 = c2 + (q1.z * dx + q1.w * dy);
    }
    const float l0 = ab(px, py, q0.x, q0.y) + c0;
    const float l1 = ab(px, py, q0.w, q1.x) + c1;
    const float l2 = ab(px, py, q1.z, q1.w) + c2;
    b1 = l1;
    b2 = l2;
    s = l0 + l1 + l2;
}

// Three blocks a SM (at most 42 registers, no spill): on the light view and
// the peel's nearly empty tiles the per-tile chain of loads sets the time,
// and more blocks hide more of it.
template <bool kCap, bool kList>
__global__ void __launch_bounds__(kThreads, 3)
raster_tile_kernel(const float* __restrict__ planes,
                   const int32_t* __restrict__ entry_tri,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ tile_ids,
                   const int32_t* __restrict__ n_live,
                   const float* __restrict__ zcap,
                   const int32_t* __restrict__ captid, int ntx, int width,
                   int height, float* __restrict__ depth,
                   int32_t* __restrict__ tri, float* __restrict__ bary) {
    __shared__ Stage st;

    // K1c: a slot past the device count, or a sentinel, rasters nothing (the
    // whole block leaves before any barrier)
    if (kList && (int)blockIdx.x >= *n_live) return;
    const int tile = kList ? tile_ids[blockIdx.x] : blockIdx.x;
    if (tile < 0) return;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tx0 = (tile % ntx) * kTileW, ty0 = (tile / ntx) * kTileH;
    const uint32_t mine = warp_bits(warp);
    // the sub-tile this lane tests while masks are made
    const Corners cn = subtile_corners(tx0, ty0, lane);

    int x, y0;
    pixels_of(tx0, ty0, warp, lane, x, y0);
    const float px = (float)x + 0.5f;
    float py[kPix], zc[kPix], best_z[kPix];
    int32_t tc[kPix], best_id[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        const int y = y0 + j * kSubH;
        py[j] = (float)y + 0.5f;
        zc[j] = kNoCandidate;
        tc[j] = -1;
        if (kCap && x < width && y < height) {
            zc[j] = zcap[(size_t)y * width + x];
            tc[j] = captid[(size_t)y * width + x];
        }
        best_z[j] = 0.0f;
        best_id[j] = -1;
    }

    const int begin = offsets[tile];
    const int end = offsets[tile + 1];
    const int nb = (end - begin + kBatch - 1) / kBatch;
    if (nb > 0) stage_batch(planes, entry_tri, begin, min(kBatch, end - begin), st.rows[0],
                            st.ids[0]);
    for (int b = 0; b < nb; ++b) {
        const int buf = b & 1;
        const int base = begin + b * kBatch;
        const int n = min(kBatch, end - base);
        if (b + 1 < nb) {
            stage_batch(planes, entry_tri, base + kBatch, min(kBatch, end - base - kBatch),
                        st.rows[buf ^ 1], st.ids[buf ^ 1]);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // batch b's rows and ids are in shared memory
        for (int e = warp; e < n; e += kWarps) {
            const Row& r = st.rows[buf][e];
            const float4 q0 = r.q[0], q1 = r.q[1], q2 = r.q[2];
            const bool pass = corner_pass(
                corner_max(q0.x, q0.y, cn.xl, cn.xh, cn.yl, cn.yh),
                corner_max(q0.w, q1.x, cn.xl, cn.xh, cn.yl, cn.yh),
                corner_max(q1.z, q1.w, cn.xl, cn.xh, cn.yl, cn.yh),
                corner_max(q2.y, q2.z, cn.xl, cn.xh, cn.yl, cn.yh),
                corner_min(q2.y, q2.z, cn.xl, cn.xh, cn.yl, cn.yh), q0.z, q1.y, q2.x, q2.w);
            const uint32_t m = __ballot_sync(kFull, pass);
            if (lane == 0) st.masks[buf][e] = m;
        }
        __syncthreads();  // every mask of batch b is made
        for (int c = 0; c < n; c += 32) {
            const int e = c + lane;
            uint32_t bits = __ballot_sync(kFull, e < n && (st.masks[buf][e] & mine));
            while (bits) {
                const int i = c + __ffs(bits) - 1;
                bits &= bits - 1;
                const uint32_t m = st.masks[buf][i];
                const Row& r = st.rows[buf][i];
                const float4 q0 = r.q[0], q1 = r.q[1], q2 = r.q[2];
                const int32_t id = st.ids[buf][i];
#pragma unroll
                for (int j = 0; j < kPix; ++j) {
                    if (!((m >> (warp + j * kWarps)) & 1u)) continue;  // warp-uniform
                    const float l0 = ab(px, py[j], q0.x, q0.y) + q0.z;
                    const float l1 = ab(px, py[j], q0.w, q1.x) + q1.y;
                    const float l2 = ab(px, py[j], q1.z, q1.w) + q2.x;
                    const float z = ab(px, py[j], q2.y, q2.z) + q2.w;
                    bool covered = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f) &
                                   (z >= 0.0f) & (z <= 1.0f);
                    if (kCap) covered &= (z < zc[j]) | ((z == zc[j]) & (id < tc[j]));
                    if (covered && (z > best_z[j] || (z == best_z[j] && id > best_id[j]))) {
                        best_z[j] = z;
                        best_id[j] = id;
                    }
                }
            }
        }
        __syncthreads();  // batch b consumed: its buffer may be refilled
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        const int y = y0 + j * kSubH;
        if (x >= width || y >= height) continue;
        const size_t p = (size_t)y * width + x;
        float b1 = 0.0f, b2 = 0.0f, s = 1.0f;
        if (best_id[j] >= 0)
            winner_bary<false>(planes, best_id[j], px, py[j], 0.0f, 0.0f, b1, b2, s);
        depth[p] = best_z[j];
        tri[p] = best_id[j];
        bary[3 * p + 0] = b1;
        bary[3 * p + 1] = b2;
        bary[3 * p + 2] = s;
    }
}

// K1d: K1a at 2, 4 or 8 sample positions of every pixel in one launch over
// the entry stream.  A block rasters its tile at kSamples (2 or 4) of them,
// samples kSamples * blockIdx.y onwards: 8 samples take two blocks a tile,
// so that a thread keeps at most 4 winners a pixel (8 spilled).  Sample s moves each plane's constant to
// C' = C + ((A * dx_s) + (B * dy_s)), rounded op by op as the plain version
// (offset_planes) and the reference's offset_bins do; the pixel then
// evaluates (px * A + py * B) + C' exactly as K1a does.  While the masks of
// a batch are made, the warp that owns an entry also makes its 4 x kSamples
// shifted constants, one a lane, into shared memory; lane s then tests
// sub-tile s at every sample, and the pair passes when some sample does.
// px * A + py * B of the four planes is shared by the samples (8 FMUL +
// 4 FADD per entry and pixel), then each sample adds its C' and compares
// (4 FADD + 7).  A thread keeps kSamples running (z, id) winners for each of
// its pixels in registers and recomputes the winners' bary at the end.
struct SampleOffsets {
    float dx[8];
    float dy[8];
};

template <int kSamples>
__global__ void __launch_bounds__(kThreads)
raster_tile_msaa_kernel(const float* __restrict__ planes,
                        const int32_t* __restrict__ entry_tri,
                        const int32_t* __restrict__ offsets,
                        const __grid_constant__ SampleOffsets so, int ntx, int width,
                        int height, float* __restrict__ depth, int32_t* __restrict__ tri,
                        float* __restrict__ bary) {
    static_assert(4 * kSamples <= 32, "one shifted constant a lane");
    __shared__ Stage st;
    __shared__ float4 shifted[kBatch][kSamples];  // C' of (l0, l1, l2, z)
    __shared__ float2 offs[kSamples];              // this block's (dx, dy)

    const int s0 = kSamples * blockIdx.y;  // the block's first sample
    if (threadIdx.x < kSamples)
        offs[threadIdx.x] = make_float2(so.dx[s0 + threadIdx.x], so.dy[s0 + threadIdx.x]);
    __syncthreads();

    const int tile = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tx0 = (tile % ntx) * kTileW, ty0 = (tile / ntx) * kTileH;
    const uint32_t mine = warp_bits(warp);
    const Corners cn = subtile_corners(tx0, ty0, lane);

    int x, y0;
    pixels_of(tx0, ty0, warp, lane, x, y0);
    const float px = (float)x + 0.5f;
    float py[kPix], best_z[kPix][kSamples];
    int32_t best_id[kPix][kSamples];
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        py[j] = (float)(y0 + j * kSubH) + 0.5f;
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
            best_z[j][s] = 0.0f;
            best_id[j][s] = -1;
        }
    }

    const int begin = offsets[tile];
    const int end = offsets[tile + 1];
    const int nb = (end - begin + kBatch - 1) / kBatch;
    if (nb > 0) stage_batch(planes, entry_tri, begin, min(kBatch, end - begin), st.rows[0],
                            st.ids[0]);
    for (int b = 0; b < nb; ++b) {
        const int buf = b & 1;
        const int base = begin + b * kBatch;
        const int n = min(kBatch, end - base);
        if (b + 1 < nb) {
            stage_batch(planes, entry_tri, base + kBatch, min(kBatch, end - base - kBatch),
                        st.rows[buf ^ 1], st.ids[buf ^ 1]);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();  // batch b's rows and ids are in shared memory
        for (int e = warp; e < n; e += kWarps) {
            const Row& r = st.rows[buf][e];
            if (lane < 4 * kSamples) {
                const int k = lane / kSamples, s = lane % kSamples;  // plane, sample
                const float2 d = offs[s];
                const float* f = reinterpret_cast<const float*>(&r) + 3 * k;
                reinterpret_cast<float*>(&shifted[e][s])[k] = f[2] + (f[0] * d.x + f[1] * d.y);
            }
            __syncwarp();
            const float4 q0 = r.q[0], q1 = r.q[1], q2 = r.q[2];
            const float m0 = corner_max(q0.x, q0.y, cn.xl, cn.xh, cn.yl, cn.yh);
            const float m1 = corner_max(q0.w, q1.x, cn.xl, cn.xh, cn.yl, cn.yh);
            const float m2 = corner_max(q1.z, q1.w, cn.xl, cn.xh, cn.yl, cn.yh);
            const float mz = corner_max(q2.y, q2.z, cn.xl, cn.xh, cn.yl, cn.yh);
            const float nz = corner_min(q2.y, q2.z, cn.xl, cn.xh, cn.yl, cn.yh);
            bool pass = false;
#pragma unroll
            for (int s = 0; s < kSamples; ++s) {
                const float4 c = shifted[e][s];
                pass |= corner_pass(m0, m1, m2, mz, nz, c.x, c.y, c.z, c.w);
            }
            const uint32_t m = __ballot_sync(kFull, pass);
            if (lane == 0) st.masks[buf][e] = m;
        }
        __syncthreads();  // every mask and shifted constant of batch b is made
        for (int c = 0; c < n; c += 32) {
            const int e = c + lane;
            uint32_t bits = __ballot_sync(kFull, e < n && (st.masks[buf][e] & mine));
            while (bits) {
                const int i = c + __ffs(bits) - 1;
                bits &= bits - 1;
                const uint32_t m = st.masks[buf][i];
                const Row& r = st.rows[buf][i];
                const float4 q0 = r.q[0], q1 = r.q[1], q2 = r.q[2];
                const int32_t id = st.ids[buf][i];
#pragma unroll
                for (int j = 0; j < kPix; ++j) {
                    if (!((m >> (warp + j * kWarps)) & 1u)) continue;  // warp-uniform
                    const float pa0 = ab(px, py[j], q0.x, q0.y);
                    const float pa1 = ab(px, py[j], q0.w, q1.x);
                    const float pa2 = ab(px, py[j], q1.z, q1.w);
                    const float paz = ab(px, py[j], q2.y, q2.z);
#pragma unroll
                    for (int s = 0; s < kSamples; ++s) {
                        const float4 cs = shifted[i][s];
                        const float l0 = pa0 + cs.x;
                        const float l1 = pa1 + cs.y;
                        const float l2 = pa2 + cs.z;
                        const float z = paz + cs.w;
                        const bool covered = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f) &
                                             (z >= 0.0f) & (z <= 1.0f);
                        if (covered &&
                            (z > best_z[j][s] || (z == best_z[j][s] && id > best_id[j][s]))) {
                            best_z[j][s] = z;
                            best_id[j][s] = id;
                        }
                    }
                }
            }
        }
        __syncthreads();  // batch b consumed: its buffers may be refilled
    }
    const size_t npix = (size_t)width * height;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
        const int y = y0 + j * kSubH;
        if (x >= width || y >= height) continue;
        const size_t p = (size_t)y * width + x;
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
            float b1 = 0.0f, b2 = 0.0f, sum = 1.0f;
            if (best_id[j][s] >= 0)
                winner_bary<true>(planes, best_id[j][s], px, py[j], offs[s].x, offs[s].y, b1,
                                  b2, sum);
            const size_t q = (size_t)(s0 + s) * npix + p;
            depth[q] = best_z[j][s];
            tri[q] = best_id[j][s];
            bary[3 * q + 0] = b1;
            bary[3 * q + 1] = b2;
            bary[3 * q + 2] = sum;
        }
    }
}

bool bad_shape(int tile_w, int tile_h, const float* planes) {
    return tile_w != kTileW || tile_h != kTileH || ((uintptr_t)planes & 15) != 0;
}

template <bool kCap, bool kList>
int launch(int nblocks, const float* planes, const int32_t* entry_tri,
           const int32_t* offsets, const int32_t* tile_ids, const int32_t* n_live,
           const float* zcap,
           const int32_t* captid, int tile_w, int tile_h, int ntx, int width,
           int height, float* depth, int32_t* tri, float* bary, void* stream) {
    if (bad_shape(tile_w, tile_h, planes)) return (int)cudaErrorInvalidValue;
    if (nblocks > 0) {
        raster_tile_kernel<kCap, kList><<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
            planes, entry_tri, offsets, tile_ids, n_live, zcap, captid, ntx, width, height,
            depth, tri, bary);
    }
    return (int)cudaGetLastError();
}

// kSamples per block, `groups` blocks a tile (kSamples * groups samples).
template <int kSamples>
int launch_msaa(int nblocks, int groups, const float* planes, const int32_t* entry_tri,
                const int32_t* offsets, const SampleOffsets& so, int tile_w,
                int tile_h, int ntx, int width, int height, float* depth,
                int32_t* tri, float* bary, void* stream) {
    if (bad_shape(tile_w, tile_h, planes)) return (int)cudaErrorInvalidValue;
    if (nblocks > 0) {
        raster_tile_msaa_kernel<kSamples>
            <<<dim3(nblocks, groups), kThreads, 0, (cudaStream_t)stream>>>(
                planes, entry_tri, offsets, so, ntx, width, height, depth, tri, bary);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Every launch takes 128x8 tiles (tile_w, tile_h) and a 16-byte aligned
// `planes` (T, 12) table, else returns cudaErrorInvalidValue and launches
// nothing.

// K1a: every tile of the ntx x nty grid.
extern "C" int raster_tile_launch(const float* planes, const int32_t* entry_tri,
                                  const int32_t* offsets, int tile_w, int tile_h,
                                  int ntx, int nty, int width, int height,
                                  float* depth, int32_t* tri, float* bary,
                                  void* stream) {
    return launch<false, false>(ntx * nty, planes, entry_tri, offsets, nullptr,
                                nullptr, nullptr, nullptr, tile_w, tile_h, ntx, width,
                                height, depth, tri, bary, stream);
}

// K1b: every tile, fragments bounded by the per-pixel (zcap, captid) images.
extern "C" int raster_tile_peel_launch(const float* planes,
                                       const int32_t* entry_tri,
                                       const int32_t* offsets,
                                       const float* zcap, const int32_t* captid,
                                       int tile_w, int tile_h, int ntx, int nty,
                                       int width, int height, float* depth,
                                       int32_t* tri, float* bary, void* stream) {
    return launch<true, false>(ntx * nty, planes, entry_tri, offsets, nullptr,
                               nullptr, zcap, captid, tile_w, tile_h, ntx, width, height,
                               depth, tri, bary, stream);
}

// K1c: the physical tiles of tile_ids' n_tiles slots, bounded like K1b;
// writes only those tiles' pixels of the caller's pre-filled outputs.  A
// block a slot; slots at or past the device count *n_live, and slots
// holding -1, list nothing.
extern "C" int raster_tile_compact_launch(const float* planes,
                                          const int32_t* entry_tri,
                                          const int32_t* offsets,
                                          const int32_t* tile_ids, int n_tiles,
                                          const int32_t* n_live,
                                          const float* zcap,
                                          const int32_t* captid, int tile_w,
                                          int tile_h, int ntx, int width,
                                          int height, float* depth,
                                          int32_t* tri, float* bary,
                                          void* stream) {
    return launch<true, true>(n_tiles, planes, entry_tri, offsets, tile_ids,
                              n_live, zcap, captid, tile_w, tile_h, ntx, width, height,
                              depth, tri, bary, stream);
}

// K1d: every tile at `samples` (2, 4 or 8) sample positions; sample s is at
// the pixel centre + (dxdy[2s], dxdy[2s + 1]) (a host array).  Outputs are
// (samples, H, W) depth and tri id and (samples, H, W, 3) bary.  Any other
// sample count returns cudaErrorInvalidValue and launches nothing.
extern "C" int raster_tile_msaa_launch(const float* planes,
                                       const int32_t* entry_tri,
                                       const int32_t* offsets,
                                       const float* dxdy, int samples,
                                       int tile_w, int tile_h, int ntx, int nty,
                                       int width, int height, float* depth,
                                       int32_t* tri, float* bary, void* stream) {
    SampleOffsets so = {};
    for (int s = 0; s < samples && s < 8; ++s) {
        so.dx[s] = dxdy[2 * s];
        so.dy[s] = dxdy[2 * s + 1];
    }
    const int n = ntx * nty;
    switch (samples) {
        case 2:
            return launch_msaa<2>(n, 1, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        case 4:
            return launch_msaa<4>(n, 1, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        case 8:
            return launch_msaa<4>(n, 2, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
