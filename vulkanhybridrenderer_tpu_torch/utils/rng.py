"""Bit-exact port of the shader RNG (data/shaders/common.glsl:47-76).

Wang hash seeding + xorshift32, vectorized over pixel grids.  torch has no
shifts on uint32 on the CPU, so states are int64 tensors holding uint32
values, masked with 0xFFFFFFFF after every operation that can overflow.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF


def seed_thread(seed):
    """Wang hash (common.glsl:50-58).  seed: int64 tensor of uint32 values."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & _M
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & _M
    seed = seed ^ (seed >> 15)
    return seed


def next_u32(state):
    """xorshift32 step (common.glsl:60-66).  Returns (new_state, value)."""
    state = state ^ ((state << 13) & _M)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & _M)
    return state, state


def random01(state):
    """Uniform float in [0, 1) from the top 23 random bits (common.glsl:68-70).
    Returns (new_state, float32 tensor)."""
    state, bits = next_u32(state)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return state, f - 1.0


def pixel_seed(width: int, height: int, frame_index, device="cpu", row0: int = 0,
               rows: int | None = None):
    """Per-pixel seeds of raygen.rgen:18: seed_thread((y * H + x) * frame).

    The reference multiplies the row by the HEIGHT and by the frame index, so
    frame 0 seeds every pixel with seed_thread(0); both quirks are kept.
    frame_index: a () integer tensor on `device` (PerFrameData's, read on
    the device, so a captured frame draws each frame's noise) or an int.
    Returns an (H, W) int64 state grid, or its `rows` rows from `row0` (a
    row slab of a mesh shard; every row to the end by default)."""
    stop = height if rows is None else row0 + rows
    y = torch.arange(row0, stop, dtype=torch.int64, device=device)[:, None]
    x = torch.arange(width, dtype=torch.int64, device=device)[None, :]
    frame = (frame_index.to(torch.int64) if isinstance(frame_index, torch.Tensor)
             else int(frame_index)) & _M
    lin = (((y * height + x) & _M) * frame) & _M
    return seed_thread(lin)
