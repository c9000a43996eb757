"""3D math (port of ``vulkanhybridrenderer_tpu/utils/math3d.py``).

Camera and light matrices are built on the host in numpy, exactly as the
reference builds them.  The tensor helpers work on any device.  Small matrix
products are written as explicit multiply-adds in a fixed order, so a CPU and
a GPU run of the same frame round identically (and never go through TF32).
"""
from __future__ import annotations

import numpy as np
import torch

PI = 3.14159265358979323846264
TWO_PI = 6.28318530717958647692528
PI_INVERSE = 0.31830988618379067153776


def normalize(v, dim: int = -1, eps: float = 1e-20):
    """Normalize vectors along `dim` (safe at zero length)."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return v / torch.clamp(n, min=eps)


def dot(a, b, dim: int = -1, keepdim: bool = False):
    return torch.sum(a * b, dim=dim, keepdim=keepdim)


def cross(a, b):
    """Cross product over the last axis, in jnp.cross's operation order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def reflect(i, n):
    """GLSL reflect: i - 2*dot(n,i)*n."""
    return i - 2.0 * dot(i, n, keepdim=True) * n


def matmul4(a, b):
    """(4, 4) @ (4, 4) as explicit multiply-adds (same rounding on every
    device)."""
    return a[:, 0:1] * b[0] + a[:, 1:2] * b[1] + a[:, 2:3] * b[2] + a[:, 3:4] * b[3]


def transform_points(m, p):
    """Apply a (4, 4) matrix to (..., 3) points (w=1); returns (..., 4)
    homogeneous results, no perspective divide."""
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    return x * m[:, 0] + y * m[:, 1] + z * m[:, 2] + m[:, 3]


def infinite_reverse_z_projection(yfov: float, aspect: float, znear: float,
                                  flip_y: bool = True):
    """Infinite far-plane reverse-Z perspective (vulkan_utils.h:494-503)."""
    scale = 1.0 / np.tan(yfov * 0.5)
    sy = -scale if flip_y else scale
    return np.array(
        [
            [scale / aspect, 0.0, 0.0, 0.0],
            [0.0, sy, 0.0, 0.0],
            [0.0, 0.0, 0.0, znear],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=np.float32,
    )


def ortho(left, right, bottom, top, znear, zfar, flip_y: bool = True):
    """GLM orthoRH_ZO (depth 0..1)."""
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -1.0 / (zfar - znear)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -znear / (zfar - znear)
    m[3, 3] = 1.0
    if flip_y:
        m[1] = -m[1]
    return m


def look_at(eye, center, up):
    """GLM lookAtRH."""
    eye = np.asarray(eye, np.float32)
    center = np.asarray(center, np.float32)
    up = np.asarray(up, np.float32)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m


def yaw_pitch_roll(yaw: float, pitch: float, roll: float):
    """GLM yawPitchRoll: R = Ry(yaw) @ Rx(pitch) @ Rz(roll), as a (4, 4)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = ry @ rx @ rz
    return m


def normal_matrix(model):
    """Inverse-transpose of the upper-left 3x3, padded to (4, 4)."""
    m = np.asarray(model, np.float64)
    n = np.linalg.inv(m[:3, :3]).T
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = n.astype(np.float32)
    return out


def onb_from_unit_vector(n):
    """Frisvad ONB (common.glsl:80-93); returns (t, b, n), each (..., 3)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    degenerate = nz < -0.9999999
    a = 1.0 / torch.where(degenerate, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    t0 = torch.stack([1.0 - nx * nx * a, b, -nx], dim=-1)
    b0 = torch.stack([b, 1.0 - ny * ny * a, -ny], dim=-1)
    t_deg = torch.tensor([0.0, -1.0, 0.0], dtype=n.dtype, device=n.device)
    b_deg = torch.tensor([-1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    deg = degenerate[..., None]
    return torch.where(deg, t_deg, t0), torch.where(deg, b_deg, b0), n
