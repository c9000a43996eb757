// Toy kernel o[i] = x[i] * 2.0f: the port's counterpart of the Pallas
// kernel of tests/test_compile_cache.py:33 (o_ref[:] = x_ref[:] * 2.0).
// That kernel pinned the XLA cache key; this one pins the port's build key
// (utils/build.py): one library for a given command line and source bytes,
// whoever asks.  Bound on this card: bytes (a read and a write of 4 bytes per
// element); one thread per element, neighbouring threads on neighbouring
// addresses.
#include <cuda_runtime.h>

namespace {

__global__ void toy_scale_kernel(const float* __restrict__ x, float* __restrict__ o,
                                 int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) o[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int toy_scale_launch(const float* x, float* o, int n, void* stream) {
    if (n > 0) {
        const int threads = 256;
        toy_scale_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(x, o, n);
    }
    return (int)cudaGetLastError();
}
