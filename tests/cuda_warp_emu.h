// A CPU emulation of the CUDA constructs csrc/bvh8_trace.cu uses, so that
// g++ can build and run that source (tests/test_torch_k2_emulated.py): each
// warp's 32 lanes are 32 threads that meet at every collective (shuffles,
// votes, __syncwarp) with full-warp semantics; a partial mask aborts.  A
// block's warps run one after another over one shared-memory buffer; the
// kernel's own launch syntax is rewritten to emu_launch by the test.
#pragma once
#include <barrier>
#include <cstdint>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int2 { int x, y; };
inline int2 make_int2(int a, int b) { return {a, b}; }
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 716 };
inline int cudaGetLastError() { return 0; }
struct Idx { unsigned x = 0, y = 0, z = 0; };
inline thread_local Idx threadIdx, blockIdx;
struct WarpCtx {
    std::barrier<> bar{32};
    uint64_t slot[32];
};
inline thread_local WarpCtx* emu_warp = nullptr;
inline thread_local char* emu_smem = nullptr;
inline int emu_lane() { return threadIdx.x & 31; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> uint64_t emu_bits(T v) { uint64_t b = 0; std::memcpy(&b, &v, sizeof(T)); return b; }
template <class T> T emu_from(uint64_t b) { T v; std::memcpy(&v, &b, sizeof(T)); return v; }
template <class T> T emu_fetch(T v, int src) {
    WarpCtx* w = emu_warp;
    w->slot[emu_lane()] = emu_bits(v);
    w->bar.arrive_and_wait();
    T out = emu_from<T>(w->slot[src]);
    w->bar.arrive_and_wait();
    return out;
}
template <class T> T __shfl_sync(unsigned m, T v, int src, int width = 32) {
    if (m != 0xffffffffu) std::abort();
    const int l = emu_lane();
    return emu_fetch(v, (l & ~(width - 1)) + (src & (width - 1)));
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int off, int width = 32) {
    if (m != 0xffffffffu) std::abort();
    const int l = emu_lane();
    return emu_fetch(v, (l & ~(width - 1)) + ((l ^ off) & (width - 1)));
}
inline bool __any_sync(unsigned m, bool b) {
    if (m != 0xffffffffu) std::abort();
    WarpCtx* w = emu_warp;
    w->slot[emu_lane()] = b;
    w->bar.arrive_and_wait();
    bool any = false;
    for (int i = 0; i < 32; ++i) any |= w->slot[i] != 0;
    w->bar.arrive_and_wait();
    return any;
}
inline void __syncwarp(unsigned m = 0xffffffffu) {
    if (m != 0xffffffffu) std::abort();
    emu_warp->bar.arrive_and_wait();
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __uint_as_float(unsigned u) { return emu_from<float>(u); }
inline float __int_as_float(int u) { return emu_from<float>((unsigned)u); }
inline unsigned __float_as_uint(float f) { return (unsigned)emu_bits(f); }
template <class T> T* emu_shared() { return reinterpret_cast<T*>(emu_smem); }
template <class F, class... A>
void emu_launch(int blocks, int threads, size_t smem, cudaStream_t, F fn, A... args) {
    std::vector<char> shared(smem + 16);
    for (int b = 0; b < blocks; ++b) {
        for (int wp = 0; wp < threads / 32; ++wp) {
            WarpCtx ctx;
            std::vector<std::thread> lanes;
            for (int l = 0; l < 32; ++l)
                lanes.emplace_back([&, l] {
                    threadIdx.x = wp * 32 + l;
                    blockIdx.x = b;
                    emu_warp = &ctx;
                    emu_smem = shared.data();
                    fn(args...);
                });
            for (auto& t : lanes) t.join();
        }
    }
}
