// Row-gather probes: the card's rate for data-dependent reads of an
// (N, 128) float32 table (the BVH8 table's shape), the counterparts of the
// TPU probes
//   scripts/bench_pallas_gather.py:88 pallas_vector_gather (row 3),
//   scripts/bench_pallas_gather.py:125 pallas_dyn_slice_loop (row 4),
//   scripts/bench_pallas_gather.py:157 pallas_take_along_axis (row 5),
//   scripts/probe_dyngather.py:63 (row 6).
// Column 48 of a row holds the next row's id, so each step's address depends
// on the previous step's load, as in K2's walk.  A walker returns its final
// row id and its own float32 sum of what it read, added in step order, so a
// kernel and its plain PyTorch version (probes/gather.py) agree bit for bit.
//
//   walk kind 0  thread per walker, the whole 512-byte row per step as 32
//                16-byte loads (K2's access pattern today);
//   walk kind 1  warp per walker, the row read coalesced, one float4 a lane
//                (the candidate layout for K2);
//   walk kind 2  thread per walker, only row[0] and row[48] (the latency
//                chase);
//   walk kind 3  per-lane gather: walker i reads tab[idx, i % 128] and steps
//                idx = (idx + (int)v * 7 + s) mod N;
//   walk kind 4  warp per walker, the whole row added into a 128-wide sum;
//   gather16     one independent gather of 16-byte rows out[i] = img[idx[i]]
//                (SSAO's and the PCF's taps).
// Bound on this card: the latency of dependent loads for the walks (L2 or
// HBM round trips, hidden only by walkers in flight); bytes for gather16.
// Every byte of a row that kinds 0 and 1 read feeds the walk: a row holding
// +inf would end it at row 0.  The probe's tables are finite, so that never
// happens, but without it the compiler would drop the loads whose values go
// unused and kind 0 would read what kind 2 reads.  A row id outside [0, N)
// stops its walker before the read (its final id is that id), and gather16
// writes NaN for such an id: no read leaves the table.  The plain versions
// raise there instead; the two agree on every table whose ids are in range.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 ld_v4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float max4(float4 v) {
    return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ bool out_of_table(int idx, int n) {
    return (unsigned)idx >= (unsigned)n;
}

__global__ void walk_thread_row(const float* __restrict__ tab, const int* __restrict__ idx0,
                                int w, int steps, int n, int* out_idx, float* out_acc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    int idx = idx0[i];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float* row = tab + (size_t)idx * 128;
        float r0 = 0.0f, r48 = 0.0f, mx = -CUDART_INF_F;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
            const float4 v = ld_v4(row + 4 * k);
            if (k == 0) r0 = v.x;
            if (k == 12) r48 = v.x;
            mx = fmaxf(mx, max4(v));
        }
        acc = acc + r0;
        idx = mx == CUDART_INF_F ? 0 : (int)r48;
    }
    out_idx[i] = idx;
    out_acc[i] = acc;
}

__global__ void walk_warp_row(const float* __restrict__ tab, const int* __restrict__ idx0,
                              int w, int steps, int n, int* out_idx, float* out_acc) {
    const int lane = threadIdx.x & 31;
    const long long wk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (wk >= w) return;  // whole warps leave together
    int idx = idx0[wk];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float4 v = ld_v4(tab + (size_t)idx * 128 + 4 * lane);
        const bool inf = __any_sync(0xffffffffu, max4(v) == CUDART_INF_F);
        acc = acc + __shfl_sync(0xffffffffu, v.x, 0);
        idx = (int)__shfl_sync(0xffffffffu, v.x, 12);
        if (inf) idx = 0;
    }
    if (lane == 0) {
        out_idx[wk] = idx;
        out_acc[wk] = acc;
    }
}

__global__ void walk_chase(const float* __restrict__ tab, const int* __restrict__ idx0,
                           int w, int steps, int n, int* out_idx, float* out_acc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    int idx = idx0[i];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float* row = tab + (size_t)idx * 128;
        const float r0 = row[0], r48 = row[48];
        acc = acc + r0;
        idx = (int)r48;
    }
    out_idx[i] = idx;
    out_acc[i] = acc;
}

__global__ void walk_lane(const float* __restrict__ tab, const int* __restrict__ idx0,
                          int w, int steps, int n, int* out_idx, float* out_acc) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= w) return;
    const int col = i & 127;
    int idx = idx0[i];
    float acc = 0.0f;
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float v = tab[(size_t)idx * 128 + col];
        acc = acc + v;
        int m = (idx + (int)v * 7 + s) % n;  // floor modulo, as torch.remainder
        idx = m < 0 ? m + n : m;
    }
    out_idx[i] = idx;
    out_acc[i] = acc;
}

__global__ void walk_rows_acc(const float* __restrict__ tab, const int* __restrict__ idx0,
                              int w, int steps, int n, int* out_idx, float* out_acc) {
    const int lane = threadIdx.x & 31;
    const long long wk = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (wk >= w) return;
    int idx = idx0[wk];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < steps && !out_of_table(idx, n); ++s) {
        const float4 v = ld_v4(tab + (size_t)idx * 128 + 4 * lane);
        acc.x = acc.x + v.x;
        acc.y = acc.y + v.y;
        acc.z = acc.z + v.z;
        acc.w = acc.w + v.w;
        idx = (int)__shfl_sync(0xffffffffu, v.x, 12);
    }
    reinterpret_cast<float4*>(out_acc)[wk * 32 + lane] = acc;
    if (lane == 0) out_idx[wk] = idx;
}

__global__ void gather16(const float4* __restrict__ img, int rows,
                         const int* __restrict__ idx, int n, float4* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int j = idx[i];
    out[i] = out_of_table(j, rows) ? make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F,
                                                 CUDART_NAN_F)
                                   : img[j];
}

}  // namespace

extern "C" int probe_walk_launch(int kind, const float* tab, const int* idx0, int w,
                                 int steps, int n, int* out_idx, float* out_acc,
                                 void* stream) {
    // kind: 0 thread-row, 1 warp-row, 2 chase, 3 lane, 4 warp rows-acc
    if (w > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        const int threads = 128;
        const long long warp_blocks = ((long long)w * 32 + threads - 1) / threads;
        const int blocks = (w + threads - 1) / threads;
        switch (kind) {
            case 0:
                walk_thread_row<<<blocks, threads, 0, st>>>(tab, idx0, w, steps, n, out_idx,
                                                            out_acc);
                break;
            case 1:
                walk_warp_row<<<(unsigned)warp_blocks, threads, 0, st>>>(tab, idx0, w, steps, n,
                                                                         out_idx, out_acc);
                break;
            case 2:
                walk_chase<<<blocks, threads, 0, st>>>(tab, idx0, w, steps, n, out_idx, out_acc);
                break;
            case 3:
                walk_lane<<<blocks, threads, 0, st>>>(tab, idx0, w, steps, n, out_idx, out_acc);
                break;
            case 4:
                walk_rows_acc<<<(unsigned)warp_blocks, threads, 0, st>>>(tab, idx0, w, steps, n,
                                                                         out_idx, out_acc);
                break;
            default:
                return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}

extern "C" int probe_gather16_launch(const float* img, int rows, const int* idx, int n,
                                     float* out, void* stream) {
    // img: rows 16-byte rows; out[i] = img[idx[i]]
    if (n > 0) {
        const int threads = 256;
        gather16<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(img), rows, idx, n, reinterpret_cast<float4*>(out));
    }
    return (int)cudaGetLastError();
}
