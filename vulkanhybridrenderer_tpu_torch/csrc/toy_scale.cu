// Toy kernel o[i] = x[i] * 2.0f: the port's counterpart of the Pallas
// kernel of tests/test_compile_cache.py:33 (o_ref[:] = x_ref[:] * 2.0).
// That kernel pinned the XLA cache key; this one pins the port's build key
// (utils/build.py): one library for a given command line and source bytes,
// whoever asks.
//
// Bound on this card: bytes, a read and a write of 4 bytes an element (at
// 4096^2, 64 MiB each way: 0.0401 ms at 3.35 TB/s).  The body is
// grid-stride over float4s, 16 bytes a thread a load, neighbouring threads
// on neighbouring addresses, four loads in flight a thread before their
// stores, with a scalar tail.  Loads and stores are streaming (__ldcs /
// __stcs, evict-first): every byte is touched once, and at 4096^2 the 128
// MiB do not fit the 50 MB L2.  The grid is 32 blocks an SM, capped by the
// work.  A contiguous view need not be 16-byte aligned (x[1:] of a fresh
// tensor is not): when x or o is not, the whole launch takes the scalar
// body and never reads a misaligned float4.  At small sizes the time is the
// host's launch path
// (utils/build.toy_scale: the checks, one output, one read of the stream,
// the device switch in device_guard.cuh), not this body.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 32;

__global__ void __launch_bounds__(kThreads)
toy_scale_vec_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long n4,
                     const float* __restrict__ xt, float* __restrict__ ot, int tail) {
    const long long stride = (long long)gridDim.x * kThreads;
    long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    for (; i + 3 * stride < n4; i += 4 * stride) {
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __ldcs(x + i + k * stride);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            __stcs(o + i + k * stride,
                   make_float4(v[k].x * 2.0f, v[k].y * 2.0f, v[k].z * 2.0f, v[k].w * 2.0f));
    }
    for (; i < n4; i += stride) {
        const float4 v = __ldcs(x + i);
        __stcs(o + i, make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f));
    }
    // the last n % 4 elements, after the float4s
    if (blockIdx.x == 0 && (int)threadIdx.x < tail) ot[threadIdx.x] = xt[threadIdx.x] * 2.0f;
}

__global__ void __launch_bounds__(kThreads)
toy_scale_kernel(const float* __restrict__ x, float* __restrict__ o, long long n) {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
        o[i] = x[i] * 2.0f;
}

int blocks_for(long long items, int device) {
    static int sms[64] = {};  // each card's SM count, asked once
    const bool known = device >= 0 && device < 64 && sms[device] > 0;
    int count = known ? sms[device] : 0;
    if (!known) {
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
        if (count <= 0) count = 1;
        if (device >= 0 && device < 64) sms[device] = count;
    }
    const long long cap = (long long)count * kBlocksPerSm;
    const long long need = (items + kThreads - 1) / kThreads;
    return (int)(need < cap ? need : cap);
}

}  // namespace

extern "C" int toy_scale_launch(const float* x, float* o, long long n, int device,
                                void* stream) {
    if (n > 0) {
        const DeviceGuard guard(device);
        cudaStream_t s = (cudaStream_t)stream;
        const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)o % 16 == 0);
        if (aligned) {
            const long long n4 = n / 4;
            const int tail = (int)(n - 4 * n4);
            toy_scale_vec_kernel<<<blocks_for(n4 > 0 ? n4 : 1, device), kThreads, 0, s>>>(
                reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(o), n4,
                x + 4 * n4, o + 4 * n4, tail);
        } else {
            toy_scale_kernel<<<blocks_for(n, device), kThreads, 0, s>>>(x, o, n);
        }
    }
    return (int)cudaGetLastError();
}
