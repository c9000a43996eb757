// The launch functions' device switch: the tensors' card becomes the calling
// thread's current CUDA device for the launch and the caller's comes back
// after, with no cudaSetDevice when it already is current.  The wrappers
// pass the device index (and its current stream) instead of entering
// torch.cuda.device on every call.
#pragma once

#include <cuda_runtime.h>

namespace {

struct DeviceGuard {
    int prev = -1;
    explicit DeviceGuard(int device) {
        int cur = 0;
        if (cudaGetDevice(&cur) == cudaSuccess && cur != device &&
            cudaSetDevice(device) == cudaSuccess)
            prev = cur;
    }
    ~DeviceGuard() {
        if (prev >= 0) cudaSetDevice(prev);
    }
    DeviceGuard(const DeviceGuard&) = delete;
    DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace
