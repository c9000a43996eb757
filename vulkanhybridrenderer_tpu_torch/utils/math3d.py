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
COS_PI_4 = 0.70710678118654752440084

#: NDC xy in [-1, 1] -> uv in [0, 1] for shadow-map lookups (common.glsl:6-11)
SHADOW_BIAS_MATRIX = np.array(
    [
        [0.5, 0.0, 0.0, 0.5],
        [0.0, 0.5, 0.0, 0.5],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float32,
)


def div(x, s: float):
    """x / s for a Python scalar s, rounded alike on every device.  CUDA
    PyTorch divides a tensor by a Python scalar through the scalar's
    reciprocal, which rounds differently unless s is a power of two; a 0-dim
    tensor on x's device is a true divisor there, as on the CPU."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


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


def transform_directions(m, d):
    """Apply the upper-left 3x3 of a (4, 4) matrix to (..., 3) directions
    (w=0); returns (..., 3)."""
    r = m[:3, :3]
    return d[..., 0:1] * r[:, 0] + d[..., 1:2] * r[:, 1] + d[..., 2:3] * r[:, 2]


def project_points(m, p):
    """Transform (..., 3) points by a (4, 4) matrix and divide by w ->
    (..., 3) NDC (x, y, depth)."""
    h = transform_points(m, p)
    return h[..., :3] / h[..., 3:4]


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



def extract_euler_yxz(m):
    """GLM extractEulerAngleYXZ on the rotation part of a (4, 4) matrix:
    (yaw, pitch, roll) such that yaw_pitch_roll rebuilds the rotation
    (scene_loader.cpp:62-67)."""
    r = np.asarray(m, np.float64)[:3, :3]
    r = r / np.linalg.norm(r, axis=0, keepdims=True)  # strip scale
    # R = Ry @ Rx @ Rz; R[1, 2] = -sin(pitch)
    pitch = np.arcsin(np.clip(-r[1, 2], -1.0, 1.0))
    if abs(np.cos(pitch)) > 1e-6:
        yaw = np.arctan2(r[0, 2], r[2, 2])
        roll = np.arctan2(r[1, 0], r[1, 1])
    else:  # gimbal lock
        yaw = np.arctan2(-r[2, 0], r[0, 0])
        roll = 0.0
    return float(yaw), float(pitch), float(roll)


def quat_rotate(q, v):
    """Rotate vector(s) v by the quaternion q = (w, x, y, z)."""
    q = np.asarray(q, np.float64)
    w, xyz = q[0], q[1:]
    t = 2.0 * np.cross(xyz, v)
    return np.asarray(v + w * t + np.cross(xyz, t), np.float32)


def decompose_rotation(m):
    """Unit quaternion (w, x, y, z) of the rotation part of a (4, 4)
    transform (GLM decompose, of which scene_loader.cpp:76-83 keeps the
    rotation)."""
    r = np.asarray(m, np.float64)[:3, :3]
    r = r / np.linalg.norm(r, axis=0, keepdims=True)
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (r[2, 1] - r[1, 2]) / s
        y = (r[0, 2] - r[2, 0]) / s
        z = (r[1, 0] - r[0, 1]) / s
    elif r[0, 0] > r[1, 1] and r[0, 0] > r[2, 2]:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        w = (r[2, 1] - r[1, 2]) / s
        x = 0.25 * s
        y = (r[0, 1] + r[1, 0]) / s
        z = (r[0, 2] + r[2, 0]) / s
    elif r[1, 1] > r[2, 2]:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        w = (r[0, 2] - r[2, 0]) / s
        x = (r[0, 1] + r[1, 0]) / s
        y = 0.25 * s
        z = (r[1, 2] + r[2, 1]) / s
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        w = (r[1, 0] - r[0, 1]) / s
        x = (r[0, 2] + r[2, 0]) / s
        y = (r[1, 2] + r[2, 1]) / s
        z = 0.25 * s
    return np.array([w, x, y, z], np.float64)

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


def _sign_not_zero(v):
    return torch.where(v >= 0.0, torch.ones_like(v), -torch.ones_like(v))


def oct_encode(v):
    """Octahedral encoding of unit vectors (..., 3) -> (..., 2)
    (common.glsl:101-104)."""
    denom = v[..., 0].abs() + v[..., 1].abs() + v[..., 2].abs()
    p = v[..., :2] / denom[..., None]
    wrapped = (1.0 - p.flip(-1).abs()) * _sign_not_zero(p)
    return torch.where((v[..., 2] <= 0.0)[..., None], wrapped, p)


def oct_decode(e):
    """Octahedral decoding (..., 2) -> unit vectors (..., 3)
    (common.glsl:105-108)."""
    z = 1.0 - e[..., 0].abs() - e[..., 1].abs()
    xy = torch.where((z < 0.0)[..., None], (1.0 - e.flip(-1).abs()) * _sign_not_zero(e), e)
    return normalize(torch.cat([xy, z[..., None]], dim=-1))
