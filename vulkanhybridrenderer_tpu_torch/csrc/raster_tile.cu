// K1a: binned tile depth test (the opaque mode of the tile raster).
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
// Bound on this card: arithmetic.  Each entry costs every pixel of its tile
// ~16 multiply/adds plus compares, and the entry stream per tile is small
// (13 floats per entry, read once per block), so the kernel is FP32-issue
// bound, far below memory bandwidth.  The TPU design fed 128 entries per
// matmul from a double-buffered DMA; here one block owns one tile, one thread
// owns one pixel and keeps its running winner in registers, and the block
// stages batches of entries in shared memory (SoA, 12 plane floats + id) so
// every plane read is a broadcast.  Tiles are processed independently in any
// order; no atomics, no second pass.
//
// Built with --fmad=false: a*b+c must round exactly like the plain PyTorch
// version (separately rounded multiply and add), or edge pixels flip.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBatch = 256;  // entries staged per shared-memory batch

__global__ void raster_tile_kernel(const float* __restrict__ planes,
                                   const int32_t* __restrict__ entry_tri,
                                   const int32_t* __restrict__ offsets,
                                   int tile_w, int tile_h, int ntx,
                                   int width, int height,
                                   float* __restrict__ depth,
                                   int32_t* __restrict__ tri,
                                   float* __restrict__ bary) {
    __shared__ float sp[12][kBatch];
    __shared__ int32_t sid[kBatch];

    const int tile = blockIdx.x;
    const int lx = threadIdx.x % tile_w;
    const int ly = threadIdx.x / tile_w;
    const int x = (tile % ntx) * tile_w + lx;
    const int y = (tile / ntx) * tile_h + ly;
    const float px = (float)x + 0.5f;
    const float py = (float)y + 0.5f;

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
            const bool covered = (l0 >= 0.0f) & (l1 >= 0.0f) & (l2 >= 0.0f) &
                                 (z >= 0.0f) & (z <= 1.0f);
            if (covered && (z > best_z || (z == best_z && id > best_id))) {
                best_z = z;
                best_id = id;
                best_b1 = l1;
                best_b2 = l2;
                best_s = l0 + l1 + l2;
            }
        }
    }
    if (x < width && y < height) {
        const size_t p = (size_t)y * width + x;
        depth[p] = best_z;
        tri[p] = best_id;
        bary[3 * p + 0] = best_b1;
        bary[3 * p + 1] = best_b2;
        bary[3 * p + 2] = best_s;
    }
}

}  // namespace

extern "C" int raster_tile_launch(const float* planes, const int32_t* entry_tri,
                                  const int32_t* offsets, int tile_w, int tile_h,
                                  int ntx, int nty, int width, int height,
                                  float* depth, int32_t* tri, float* bary,
                                  void* stream) {
    const int ntiles = ntx * nty;
    if (ntiles > 0) {
        raster_tile_kernel<<<ntiles, tile_w * tile_h, 0, (cudaStream_t)stream>>>(
            planes, entry_tri, offsets, tile_w, tile_h, ntx, width, height,
            depth, tri, bary);
    }
    return (int)cudaGetLastError();
}
