"""PyTorch + CUDA port of the hybrid renderer (reference: ``vulkanhybridrenderer_tpu``).

The port runs the reference-defaults hybrid frame (RT shadows, AO / reflections /
denoise off, alpha-masked geometry rastered solid) end to end on one NVIDIA GPU:
geometry -> binned tile raster (hand-written CUDA kernel, ``csrc/raster_tile.cu``)
-> G-buffer resolve -> BVH8 any-hit shadow rays (hand-written CUDA kernel,
``csrc/bvh8_trace.cu``) -> composition.  Module paths mirror the JAX package so
each module's reference counterpart is easy to find.

Conventions are the reference's (see ``vulkanhybridrenderer_tpu/__init__.py``):
matrices act on column vectors, NDC y points down with reverse-Z depth, images
are channel-planar ``(C, H, W)`` float32 tensors with row 0 at the top.

Every kernel has a plain PyTorch version in the same module.  A kernel wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  The package never imports JAX.
"""

import torch

# The 4x4 transforms and the G-buffer resolve must stay full float32: TF32
# keeps ~3 decimal digits, which moves reprojected positions by whole pixels.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
