"""SVGF denoising of the RT shadow and AO channels (port of ``ops/svgf.py``).

Two stages, as in the reference:
  * temporal reprojection + moments / variance integration (svgf.comp:16-144)
  * the edge-stopping 5x5 a-trous filter with a 3x3 Gaussian of the variance,
    5 iterations with steps 1, 2, 4, 8, 16 (svgf_atrous_filter.comp:17-101,
    loop in hybrid_render_path.cpp:288-329)

The temporal state (shadow / AO history, moments history, previous normals
and object ids) is a TemporalState passed in and returned, in place of the
reference's persistent storage images.

Parity details:
  * reprojection is valid for an in-bounds tap of the same object id whose
    normals agree to dot >= cos(pi/4) (svgf.comp:16-39);
  * 2x2 bilinear tap at (coords - motion * size + 0.5), 3x3 unweighted
    fallback (:51-97); alpha = moments alpha = 0.2 (:105-106).  A tap reads
    the history at (clamp(base) + offset), which is where the reference's
    single patch gather reads it;
  * the shadow / AO history is the FIRST a-trous iteration's output, the
    moments history the temporal stage's, and the previous normals are this
    frame's (hybrid_render_path.cpp:310-321);
  * a-trous: B3-spline weights, edge stop = object id * normal^128 *
    exp(-|lum_p - lum_q| / (4 sqrt(var_p) + 1e-6)); variance filtered with
    w^2; the centre tap has weight 1 and taps outside the image are skipped.

The reference runs the a-trous iterations as one lax.scan over a
dynamic-step body, which exists to cut XLA compile time; here they are a
Python loop over atrous_iteration (the reference's tests pin the two equal).
"""
from __future__ import annotations

import torch

from vulkanhybridrenderer_tpu_torch.core.types import TemporalState
from vulkanhybridrenderer_tpu_torch.ops.filters import shifted
from vulkanhybridrenderer_tpu_torch.utils.math3d import COS_PI_4

ALPHA = 0.2
MOMENTS_ALPHA = 0.2

_B3 = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
_GAUSS = (1 / 4, 1 / 2, 1 / 4)


def temporal(normal_oid, motion_mr, shadow_ao, state: TemporalState):
    """Returns (integrated (4, H, W): shadow, ao, var_s, var_a; the new
    moments history (4, H, W))."""
    _, h, w = normal_oid.shape
    dev = normal_oid.device
    cur_n = normal_oid[:3].permute(1, 2, 0)
    cur_oid = normal_oid[3].to(torch.int32)
    cur_shadow, cur_ao = shadow_ao[0], shadow_ao[1]
    motion = motion_mr[:2]

    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    px = xx - motion[0] * w + 0.5  # svgf.comp:53
    py = yy - motion[1] * h + 0.5
    fx = px - torch.floor(px)
    fy = py - torch.floor(py)
    ix = torch.floor(px).to(torch.int64)
    iy = torch.floor(py).to(torch.int64)
    base_x = torch.clamp(ix, 0, w - 1)
    base_y = torch.clamp(iy, 0, h - 1)

    nhist = state.shadow_ao_history.shape[0]
    table = torch.cat(
        [state.shadow_ao_history, state.moments_history, state.prev_normal_oid]
    ).permute(1, 2, 0).reshape(h * w, -1)  # (H*W, nhist + 8)

    def tap(oy, ox):
        """One history tap -> (valid, shadow / ao (H, W, nhist), moments)."""
        sy = torch.clamp(base_y + oy, 0, h - 1)
        sx = torch.clamp(base_x + ox, 0, w - 1)
        row = table[sy * w + sx]
        inb = (ix + ox >= 0) & (ix + ox < w) & (iy + oy >= 0) & (iy + oy < h)
        same_obj = cur_oid == row[..., nhist + 7].to(torch.int32)
        aligned = torch.sum(cur_n * row[..., nhist + 4:nhist + 7], dim=-1) >= COS_PI_4
        return inb & same_obj & aligned, row[..., :nhist], row[..., nhist:nhist + 4]

    taps = {(oy, ox): tap(oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1)}

    def accumulate(weighted):
        acc_s = torch.zeros((h, w), device=dev)
        acc_a = torch.zeros((h, w), device=dev)
        acc_m = torch.zeros((h, w, 4), device=dev)
        acc_w = torch.zeros((h, w), device=dev)
        for (oy, ox), wgt in weighted:
            valid, sh_ao, mom = taps[(oy, ox)]
            vw = torch.where(valid, wgt, 0.0)
            acc_s = acc_s + vw * sh_ao[..., 0]
            acc_a = acc_a + vw * sh_ao[..., 1]
            acc_m = acc_m + vw[..., None] * mom
            acc_w = acc_w + vw
        return acc_s, acc_a, acc_m, acc_w

    # 2x2 bilinear (svgf.comp:52-77), then the 3x3 fallback (:79-97)
    bil = accumulate([((0, 0), (1 - fx) * (1 - fy)), ((0, 1), fx * (1 - fy)),
                      ((1, 0), (1 - fx) * fy), ((1, 1), fx * fy)])
    box = accumulate([((oy, ox), torch.ones((h, w), device=dev))
                      for oy in (-1, 0, 1) for ox in (-1, 0, 1)])
    use_box = ~(bil[3] > 1e-6)
    acc_s, acc_a, acc_m, acc_w = (
        torch.where(use_box[..., None] if b.dim() == 3 else use_box, f, b)
        for b, f in zip(bil, box)
    )
    valid = acc_w > 1e-6
    sw = torch.clamp(acc_w, min=1e-12)
    prev_s, prev_a, prev_m = acc_s / sw, acc_a / sw, acc_m / sw[..., None]

    # moments + integration (svgf.comp:99-137)
    cur_m = torch.stack(
        [cur_shadow, cur_shadow * cur_shadow, cur_ao, cur_ao * cur_ao], dim=-1
    )
    mom = torch.where(valid[..., None], prev_m + (cur_m - prev_m) * MOMENTS_ALPHA, cur_m)
    var_s = torch.clamp(mom[..., 1] - mom[..., 0] * mom[..., 0], min=0.0)
    var_a = torch.clamp(mom[..., 3] - mom[..., 2] * mom[..., 2], min=0.0)
    int_s = torch.where(valid, prev_s + (cur_shadow - prev_s) * ALPHA, cur_shadow)
    int_a = torch.where(valid, prev_a + (cur_ao - prev_a) * ALPHA, cur_ao)
    integrated = torch.stack([int_s, int_a, var_s, var_a])
    return integrated, mom.permute(2, 0, 1).contiguous()


def atrous_iteration(integrated, normal_oid, step: int):
    """One edge-stopping a-trous iteration (svgf_atrous_filter.comp:56-101).
    integrated: (4, H, W) (shadow, ao, var_s, var_a)."""
    _, h, w = integrated.shape
    dev = integrated.device
    n_p = normal_oid[:3]
    oid_p = normal_oid[3]

    # 3x3 Gaussian of the variance channels (:17-38); taps outside the image
    # are skipped without renormalizing, which the zero fill reproduces
    var = integrated[2:4]
    var_f = torch.zeros_like(var)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            var_f = var_f + (_GAUSS[oy + 1] * _GAUSS[ox + 1]) * shifted(var, oy, ox)

    p_sh, p_ao = integrated[0], integrated[1]
    sum_sh, sum_ao = p_sh, p_ao  # the centre tap has weight 1 (:66-67)
    sum_vs, sum_va = integrated[2], integrated[3]
    sum_ws = torch.ones((h, w), device=dev)
    sum_wa = torch.ones((h, w), device=dev)
    sigma_s = 4.0 * torch.sqrt(var_f[0]) + 1e-6
    sigma_a = 4.0 * torch.sqrt(var_f[1]) + 1e-6
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    oid_pi = oid_p.to(torch.int32)

    for oy in range(-2, 3):
        for ox in range(-2, 3):
            if oy == 0 and ox == 0:
                continue
            dy, dx = oy * step, ox * step
            kern = _B3[oy + 2] * _B3[ox + 2]
            inb = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            q = shifted(integrated, dy, dx)
            n_q = shifted(n_p, dy, dx)
            oid_q = shifted(oid_p, dy, dx, fill=-2.0)

            w_norm = torch.clamp(torch.sum(n_p * n_q, dim=0), min=0.0)
            for _ in range(7):  # ** 128 by squaring, as XLA's integer_pow
                w_norm = w_norm * w_norm
            w_oid = (oid_pi == oid_q.to(torch.int32)).to(torch.float32)
            base = kern * w_norm * w_oid * inb
            w_s = base * torch.exp(-torch.abs(p_sh - q[0]) / sigma_s)
            w_a = base * torch.exp(-torch.abs(p_ao - q[1]) / sigma_a)

            sum_sh = sum_sh + w_s * q[0]
            sum_ao = sum_ao + w_a * q[1]
            sum_vs = sum_vs + w_s * w_s * q[2]
            sum_va = sum_va + w_a * w_a * q[3]
            sum_ws = sum_ws + w_s
            sum_wa = sum_wa + w_a

    return torch.stack([
        sum_sh / sum_ws,
        sum_ao / sum_wa,
        sum_vs / (sum_ws * sum_ws),
        sum_va / (sum_wa * sum_wa),
    ])


def denoise(normal_oid, motion_mr, shadow_ao, state: TemporalState,
            iterations: int = 5):
    """Full SVGF: temporal + `iterations` a-trous steps (1, 2, 4, ...).
    Returns (denoised shadow / AO (4, H, W), the new TemporalState)."""
    integrated, new_moments = temporal(normal_oid, motion_mr, shadow_ao, state)
    cur, history = integrated, integrated[:2]
    for i in range(iterations):
        cur = atrous_iteration(cur, normal_oid, 1 << i)
        if i == 0:
            history = cur[:2]
    new_state = TemporalState(
        shadow_ao_history=history.contiguous(),
        moments_history=new_moments,
        prev_normal_oid=normal_oid,
    )
    return cur, new_state
