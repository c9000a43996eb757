"""Monte-Carlo direction sampling (common.glsl:29-42; port of ``ops/sampling.py``)."""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.utils.math3d import TWO_PI, onb_from_unit_vector


def uniform_sample_cone(u, cos_theta_max):
    """Uniform direction in a cone around +z.  u: (..., 2); returns (..., 3)."""
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[..., 1] * TWO_PI
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )


def uniform_sample_cosine_hemisphere(u):
    """Cosine-weighted hemisphere around +z."""
    r = torch.sqrt(u[..., 0])
    phi = TWO_PI * u[..., 1]
    z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def to_basis(n, local_dir):
    """Rotate a +z-hemisphere sample into the basis around unit vector n."""
    t, b, nn = onb_from_unit_vector(n)
    return local_dir[..., 0:1] * t + local_dir[..., 1:2] * b + local_dir[..., 2:3] * nn
