// The alpha any-hit filter shared by K2 (bvh8_trace.cu) and K3
// (shadow_grid.cu): the reference's make_alpha_hit_filter
// (vulkanhybridrenderer_tpu/ops/traverse.py:922-951, shadow_anyhit.rahit).
// A candidate hit (tri, u, v) of an alpha-masked, textured material is
// rejected when the base-color alpha at its uv is below the material's
// cutoff, computed as shadetab.fetch_tri_static / interpolate3 /
// sample_atlas4 compute it: one tri_static row (uv0, alpha_mask, base_tex,
// base_scale, base_offset, alpha_cutoff) and one quad row of the atlas.
// Each product rounds on its own (the including files build with
// --fmad=false), so the answer equals the plain PyTorch filter's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
