// K1a, K1b, K1c, K1d: binned tile depth test (the opaque, peel-bound,
// compact-tile and multisample modes of the tile raster).
//
// Replaces the Pallas kernel vulkanhybridrenderer_tpu/ops/rasterizer_tiled.py
// _raster_kernel (launched by rasterize_binned, pallas_call at :567).  For
// every screen tile it walks the tile's binned triangle entries and evaluates
// the homogeneous planes l0, l1, l2 and z = A*px + B*py + C at pixel centres.
// A pixel is covered when l0, l1, l2 >= 0 and 0 <= z <= 1; the winner is the
// lexicographic max of (z, triangle id): reverse-Z, larger id on ties.  Per
// pixel it writes depth (clear 0), tri id (-1), and bary = (l1, l2,
// l0 + l1 + l2) (clear 0, 0, 1), straight into (H, W) / (H, W, 3) images.
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
//        full-width round bit for bit, and elsewhere it stays clear.
// K1d (raster_tile_msaa_launch) is a kernel of its own, templated on the
// sample count: K1a at the 2, 4 or 8 standard Vulkan sample positions, where
// the reference runs its kernel once per sample on C-shifted entry copies
// (rasterize_scene_msaa:1031-1036).  Here the entry stream is read once and
// each staged entry is tested at every sample, in one launch.
//
// Bound on this card: arithmetic.  Each entry costs every pixel of its tile
// ~16 multiply/adds plus compares, and the entry stream per tile is small
// (13 floats per entry, read once per block), so the kernel is FP32-issue
// bound, far below memory bandwidth.  The TPU design fed 128 entries per
// matmul from a double-buffered DMA; here one block owns one tile, one thread
// owns one pixel and keeps its running winner (and its peel bound) in
// registers, and the block stages batches of entries in shared memory (SoA,
// 12 plane floats + id) so every plane read is a broadcast.  Tiles are
// processed independently in any order; no atomics, no second pass.
//
// Built with --fmad=false: a*b+c must round exactly like the plain PyTorch
// version (separately rounded multiply and add), or edge pixels flip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 256;  // entries staged per shared-memory batch
// bound of pixels outside the image: no fragment (z >= 0) is below it
constexpr float kNoCandidate = -3.4e38f;

template <bool kCap, bool kList>
__global__ void raster_tile_kernel(const float* __restrict__ planes,
                                   const int32_t* __restrict__ entry_tri,
                                   const int32_t* __restrict__ offsets,
                                   const int32_t* __restrict__ tile_ids,
                                   const float* __restrict__ zcap,
                                   const int32_t* __restrict__ captid,
                                   int tile_w, int tile_h, int ntx,
                                   int width, int height,
                                   float* __restrict__ depth,
                                   int32_t* __restrict__ tri,
                                   float* __restrict__ bary) {
    __shared__ float sp[12][kBatch];
    __shared__ int32_t sid[kBatch];

    const int tile = kList ? tile_ids[blockIdx.x] : blockIdx.x;
    const int lx = threadIdx.x % tile_w;
    const int ly = threadIdx.x / tile_w;
    const int x = (tile % ntx) * tile_w + lx;
    const int y = (tile / ntx) * tile_h + ly;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;
    const bool inside = x < width && y < height;
    const size_t p = inside ? (size_t)y * width + x : 0;

    float zc = kNoCandidate;
    int32_t tc = -1;
    if (kCap && inside) {
        zc = zcap[p];
        tc = captid[p];
    }

    float best_z = 0.0f, best_b1 = 0.0f, best_b2 = 0.0f, best_s = 1.0f;
    int32_t best_id = -1;

    const int begin = offsets[tile];
    const int end = offsets[tile + 1];
    const int nthreads = blockDim.x;
    for (int base = begin; base < end; base += kBatch) {
        const int n = min(kBatch, end - base);
        __syncthreads();  // previous batch fully consumed
        for (int i = threadIdx.x; i < n * 12; i += nthreads) {
            const int e = i / 12;
            const int f = i - e * 12;
            const int32_t id = entry_tri[base + e];
            sp[f][e] = planes[(size_t)id * 12 + f];
            if (f == 0) sid[e] = id;
        }
        __syncthreads();
        for (int e = 0; e < n; ++e) {
            const float l0 = px * sp[0][e] + py * sp[1][e] + sp[2][e];
            const float l1 = px * sp[3][e] + py * sp[4][e] + sp[5][e];
            const float l2 = px * sp[6][e] + py * sp[7][e] + sp[8][e];
            const float z = px * sp[9][e] + py * sp[10][e] + sp[11][e];
            const int32_t id = sid[e];
            bool covered = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f) &
                           (z >= 0.0f) & (z <= 1.0f);
            if (kCap) covered &= (z < zc) | ((z == zc) & (id < tc));
            if (covered && (z > best_z || (z == best_z && id > best_id))) {
                best_z = z;
                best_id = id;
                best_b1 = l1;
                best_b2 = l2;
                best_s = l0 + l1 + l2;
            }
        }
    }
    if (inside) {
        depth[p] = best_z;
        tri[p] = best_id;
        bary[3 * p + 0] = best_b1;
        bary[3 * p + 1] = best_b2;
        bary[3 * p + 2] = best_s;
    }
}

// K1d: K1a at kSamples sample positions of every pixel in one pass over the
// entry stream.  Sample s moves each plane's constant to
// C' = C + ((A * dx_s) + (B * dy_s)), rounded op by op as the plain version
// (offset_planes) and the reference's offset_bins do; the pixel then
// evaluates px * A + py * B + C' exactly as K1a does.  C' is made once per
// (entry, sample) while the batch is staged, so shared memory holds A and B
// per plane and kSamples shifted constants per plane: 164 bytes an entry at
// kSamples = 8 (41 KB at kBatch = 256, under the 48 KB of static shared
// memory).  Each thread keeps kSamples running winners in registers; with
// 1024 threads a block, __launch_bounds__ caps them at 64 registers.
// Bound: arithmetic, like K1a.  px * A + py * B of the four planes is shared
// by the samples (8 FMUL + 4 FADD per entry and pixel), then each sample
// adds its C' and compares (4 FADD + 7), 12 + 11 * kSamples in all, where
// kSamples K1a launches do 23 * kSamples and read the entries kSamples times.
// Measured by chip_smoke.py at 4 samples on SponzaProxy's forward frame
// (220,491 entries, 1920x1080): 1.24 ms against a 0.38 ms bound, and 1.96 ms
// for the four K1a launches it replaces (NVIDIA H100 80GB HBM3, 700.00 W).
struct SampleOffsets {
    float dx[8];
    float dy[8];
};

template <int kSamples>
__global__ void __launch_bounds__(1024)
raster_tile_msaa_kernel(const float* __restrict__ planes,
                        const int32_t* __restrict__ entry_tri,
                        const int32_t* __restrict__ offsets, SampleOffsets so,
                        int tile_w, int tile_h, int ntx, int width, int height,
                        float* __restrict__ depth, int32_t* __restrict__ tri,
                        float* __restrict__ bary) {
    __shared__ float sa[4][kBatch];
    __shared__ float sb[4][kBatch];
    __shared__ float sc[4][kSamples][kBatch];
    __shared__ int32_t sid[kBatch];

    const int tile = blockIdx.x;
    const int lx = threadIdx.x % tile_w;
    const int ly = threadIdx.x / tile_w;
    const int x = (tile % ntx) * tile_w + lx;
    const int y = (tile / ntx) * tile_h + ly;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;

    float best_z[kSamples], best_b1[kSamples], best_b2[kSamples], best_s[kSamples];
    int32_t best_id[kSamples];
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
        best_z[s] = 0.0f;
        best_b1[s] = 0.0f;
        best_b2[s] = 0.0f;
        best_s[s] = 1.0f;
        best_id[s] = -1;
    }

    const int begin = offsets[tile];
    const int end = offsets[tile + 1];
    const int nthreads = blockDim.x;
    for (int base = begin; base < end; base += kBatch) {
        const int n = min(kBatch, end - base);
        __syncthreads();  // previous batch fully consumed
        for (int i = threadIdx.x; i < n * 4; i += nthreads) {
            const int e = i / 4;
            const int f = i - e * 4;  // plane: l0, l1, l2, z
            const int32_t id = entry_tri[base + e];
            const float* row = planes + (size_t)id * 12 + 3 * f;
            const float a = row[0], b = row[1], c = row[2];
            sa[f][e] = a;
            sb[f][e] = b;
#pragma unroll
            for (int s = 0; s < kSamples; ++s) sc[f][s][e] = c + (a * so.dx[s] + b * so.dy[s]);
            if (f == 0) sid[e] = id;
        }
        __syncthreads();
        for (int e = 0; e < n; ++e) {
            const float pa0 = px * sa[0][e] + py * sb[0][e];
            const float pa1 = px * sa[1][e] + py * sb[1][e];
            const float pa2 = px * sa[2][e] + py * sb[2][e];
            const float paz = px * sa[3][e] + py * sb[3][e];
            const int32_t id = sid[e];
#pragma unroll
            for (int s = 0; s < kSamples; ++s) {
                const float l0 = pa0 + sc[0][s][e];
                const float l1 = pa1 + sc[1][s][e];
                const float l2 = pa2 + sc[2][s][e];
                const float z = paz + sc[3][s][e];
                const bool covered = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f) &
                                     (z >= 0.0f) & (z <= 1.0f);
                if (covered && (z > best_z[s] || (z == best_z[s] && id > best_id[s]))) {
                    best_z[s] = z;
                    best_id[s] = id;
                    best_b1[s] = l1;
                    best_b2[s] = l2;
                    best_s[s] = l0 + l1 + l2;
                }
            }
        }
    }
    if (x < width && y < height) {
        const size_t npix = (size_t)width * height;
        const size_t p = (size_t)y * width + x;
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
            const size_t q = s * npix + p;
            depth[q] = best_z[s];
            tri[q] = best_id[s];
            bary[3 * q + 0] = best_b1[s];
            bary[3 * q + 1] = best_b2[s];
            bary[3 * q + 2] = best_s[s];
        }
    }
}

template <bool kCap, bool kList>
int launch(int nblocks, const float* planes, const int32_t* entry_tri,
           const int32_t* offsets, const int32_t* tile_ids, const float* zcap,
           const int32_t* captid, int tile_w, int tile_h, int ntx, int width,
           int height, float* depth, int32_t* tri, float* bary, void* stream) {
    if (nblocks > 0) {
        raster_tile_kernel<kCap, kList>
            <<<nblocks, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
                planes, entry_tri, offsets, tile_ids, zcap, captid, tile_w,
                tile_h, ntx, width, height, depth, tri, bary);
    }
    return (int)cudaGetLastError();
}

template <int kSamples>
int launch_msaa(int nblocks, const float* planes, const int32_t* entry_tri,
                const int32_t* offsets, const SampleOffsets& so, int tile_w,
                int tile_h, int ntx, int width, int height, float* depth,
                int32_t* tri, float* bary, void* stream) {
    if (nblocks > 0) {
        raster_tile_msaa_kernel<kSamples>
            <<<nblocks, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
                planes, entry_tri, offsets, so, tile_w, tile_h, ntx, width,
                height, depth, tri, bary);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// K1a: every tile of the ntx x nty grid.
extern "C" int raster_tile_launch(const float* planes, const int32_t* entry_tri,
                                  const int32_t* offsets, int tile_w, int tile_h,
                                  int ntx, int nty, int width, int height,
                                  float* depth, int32_t* tri, float* bary,
                                  void* stream) {
    return launch<false, false>(ntx * nty, planes, entry_tri, offsets, nullptr,
                                nullptr, nullptr, tile_w, tile_h, ntx, width,
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
                               zcap, captid, tile_w, tile_h, ntx, width, height,
                               depth, tri, bary, stream);
}

// K1c: the n_tiles physical tiles of tile_ids, bounded like K1b; writes only
// those tiles' pixels of the caller's pre-filled outputs.
extern "C" int raster_tile_compact_launch(const float* planes,
                                          const int32_t* entry_tri,
                                          const int32_t* offsets,
                                          const int32_t* tile_ids, int n_tiles,
                                          const float* zcap,
                                          const int32_t* captid, int tile_w,
                                          int tile_h, int ntx, int width,
                                          int height, float* depth,
                                          int32_t* tri, float* bary,
                                          void* stream) {
    return launch<true, true>(n_tiles, planes, entry_tri, offsets, tile_ids,
                              zcap, captid, tile_w, tile_h, ntx, width, height,
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
            return launch_msaa<2>(n, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        case 4:
            return launch_msaa<4>(n, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        case 8:
            return launch_msaa<8>(n, planes, entry_tri, offsets, so, tile_w, tile_h,
                                  ntx, width, height, depth, tri, bary, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
