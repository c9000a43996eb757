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
sequence of atrous_iteration steps (the reference's tests pin the two
equal).  ``denoise_steps`` is the stages as graph Steps, the SVGF Denoise
Pass's body; ``denoise`` runs them on one device.

Over a mesh (parallel/mesh.py) each shard computes its row slab (``rows``):
the temporal stage from the whole previous state (a motion vector may point
at any row), each a-trous iteration of step s from its rows and the 2 s rows
above and below them (its 5x5 taps; the variance's 3x3 Gaussian is read at
the centre only).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vulkanhybridrenderer_tpu_torch.core.types import TemporalState
from vulkanhybridrenderer_tpu_torch.graph.render_graph import ROWS, WHOLE, Step, halo, run_steps
from vulkanhybridrenderer_tpu_torch.ops.filters import shifted
from vulkanhybridrenderer_tpu_torch.ops.screen import Rows
from vulkanhybridrenderer_tpu_torch.utils.math3d import COS_PI_4

ALPHA = 0.2
MOMENTS_ALPHA = 0.2

_B3 = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
_GAUSS = (1 / 4, 1 / 2, 1 / 4)


def temporal(normal_oid, motion_mr, shadow_ao, state: TemporalState,
             rows: Rows | None = None):
    """Returns (integrated (4, H, W): shadow, ao, var_s, var_a; the new
    moments history (4, H, W)).  With `rows` the current images are those
    rows of the image and the outputs too; the state is always whole."""
    _, n, w = normal_oid.shape
    rows = rows or Rows.whole(n)
    h = rows.height
    dev = normal_oid.device
    cur_n = normal_oid[:3].permute(1, 2, 0)
    cur_oid = normal_oid[3].to(torch.int32)
    cur_shadow, cur_ao = shadow_ao[0], shadow_ao[1]
    motion = motion_mr[:2]

    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    yy = torch.arange(rows.start, rows.stop, dtype=torch.float32, device=dev)[:, None]
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
        acc_s = torch.zeros((n, w), device=dev)
        acc_a = torch.zeros((n, w), device=dev)
        acc_m = torch.zeros((n, w, 4), device=dev)
        acc_w = torch.zeros((n, w), device=dev)
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
    box = accumulate([((oy, ox), torch.ones((n, w), device=dev))
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


def atrous_iteration(integrated, normal_oid, step: int, rows: Rows | None = None):
    """One edge-stopping a-trous iteration (svgf_atrous_filter.comp:56-101).
    integrated: (4, H, W) (shadow, ao, var_s, var_a).  With `rows`,
    integrated and normal_oid are rows.window(2 * step) of the image, the
    rows the 5x5 taps reach, and the output is `rows`."""
    r = 2 * step
    whole = rows is None
    rows = rows or Rows.whole(integrated.shape[1])
    top, bottom = rows.window(r)
    n, h, w = rows.count, rows.height, integrated.shape[2]
    own = slice(rows.start - top, rows.stop - top)
    dev = integrated.device

    def taps(img, fill=0.0):
        """tap(dy, dx): img shifted as shifted(img, dy, dx, fill) reads it,
        on the output rows only (with `rows`, row k of the padded copy is
        image row rows.start - r + k; fill past the image's edges)."""
        if whole:
            return lambda dy, dx: shifted(img, dy, dx, fill)
        pad = F.pad(img, (0, 0, r - (rows.start - top), r - (bottom - rows.stop)), value=fill)
        return lambda dy, dx: shifted(pad[..., r + dy:r + dy + n, :], 0, dx, fill)

    tap_i, tap_v, tap_n = taps(integrated), taps(integrated[2:4]), taps(normal_oid[:3])
    tap_oid = taps(normal_oid[3], fill=-2.0)
    cen = integrated[:, own]
    n_p = normal_oid[:3, own]
    oid_p = normal_oid[3, own]

    # 3x3 Gaussian of the variance channels (:17-38); taps outside the image
    # are skipped without renormalizing, which the zero fill reproduces
    var_f = torch.zeros_like(cen[2:4])
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            var_f = var_f + (_GAUSS[oy + 1] * _GAUSS[ox + 1]) * tap_v(oy, ox)

    p_sh, p_ao = cen[0], cen[1]
    sum_sh, sum_ao = p_sh, p_ao  # the centre tap has weight 1 (:66-67)
    sum_vs, sum_va = cen[2], cen[3]
    sum_ws = torch.ones((n, w), device=dev)
    sum_wa = torch.ones((n, w), device=dev)
    sigma_s = 4.0 * torch.sqrt(var_f[0]) + 1e-6
    sigma_a = 4.0 * torch.sqrt(var_f[1]) + 1e-6
    ys = torch.arange(rows.start, rows.stop, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    oid_pi = oid_p.to(torch.int32)

    for oy in range(-2, 3):
        for ox in range(-2, 3):
            if oy == 0 and ox == 0:
                continue
            dy, dx = oy * step, ox * step
            kern = _B3[oy + 2] * _B3[ox + 2]
            inb = (ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)
            q = tap_i(dy, dx)
            n_q = tap_n(dy, dx)
            oid_q = tap_oid(dy, dx)

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


def denoise_steps(normals: str, motion: str, shadow_ao: str, state: str, out: str,
                  state_out: str, scale: int = 1, iterations: int = 5) -> tuple:
    """Full SVGF as graph Steps over the named resources (normal_oid,
    motion_mr, the noisy shadow / AO and the TemporalState in; the denoised
    shadow / AO (4, H, W) and the new TemporalState out): the temporal stage,
    which reads the whole previous state; `iterations` a-trous steps (1, 2,
    4, ...), the one of step s with a halo of 2 s rows; the new state.
    `scale` is the images' trace scale (Step.scale)."""
    stages = [f"{out} Integrated"] + [f"{out} A-Trous {i}" for i in range(1, iterations + 1)]
    moments = f"{out} Moments"

    def temporal_step(res):
        integrated, new_moments = temporal(res[normals], res[motion], res[shadow_ao],
                                           res[state], rows=res["rows"])
        return {stages[0]: integrated, moments: new_moments}

    def atrous_step(i):
        return lambda res: {stages[i + 1]: atrous_iteration(res[stages[i]], res[normals],
                                                            1 << i, rows=res["rows"])}

    history = stages[min(1, iterations)]  # the first iteration's output

    def state_step(res):
        return {out: res[stages[-1]], state_out: TemporalState(
            shadow_ao_history=res[history][:2].contiguous(),
            moments_history=res[moments], prev_normal_oid=res[normals])}

    return (
        Step(temporal_step, {normals: ROWS, motion: ROWS, shadow_ao: ROWS, state: WHOLE},
             scale),
        *(Step(atrous_step(i), {stages[i]: halo(2 << i), normals: halo(2 << i)}, scale)
          for i in range(iterations)),
        Step(state_step, dict.fromkeys((stages[-1], history, moments, normals), ROWS), scale),
    )


def denoise(normal_oid, motion_mr, shadow_ao, state: TemporalState,
            iterations: int = 5):
    """Full SVGF: temporal + `iterations` a-trous steps (1, 2, 4, ...).
    Returns (denoised shadow / AO (4, H, W), the new TemporalState)."""
    res = run_steps(denoise_steps("normal_oid", "motion_mr", "shadow_ao", "state", "out",
                                  "state_out", iterations=iterations),
                    {"normal_oid": normal_oid, "motion_mr": motion_mr, "shadow_ao": shadow_ao,
                     "state": state})
    return res["out"], res["state_out"]
