"""The reference's per-pixel passes, in plain PyTorch: texture sampling,
the G-buffer resolve, the hybrid ray set-up and its hit shading, SVGF, SSAO,
the shadow map's PCF, composition and the raytraced frame's shading.

Each function follows the formula the JAX package's ``ops/`` modules state
(read as the specification, not imported), which cite the upstream
renderer's shaders.  Images are channel-last (H, W, C) here.
"""
from __future__ import annotations

import torch

PI = 3.14159265358979323846264
TWO_PI = 6.28318530717958647692528
PI_INVERSE = 0.31830988618379067153776
COS_PI_4 = 0.70710678118654752440084
MIN_ROUGHNESS = 0.04
M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ vectors ---
def normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-20)


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def points(m, p):
    """(..., 4) = m @ (p, 1) for (..., 3) points."""
    return torch.cat([p, torch.ones_like(p[..., :1])], -1) @ m.T


def mix3(a, w):
    """Per-vertex values (..., 3, k) blended by weights (..., 3)."""
    return a[..., 0, :] * w[..., 0:1] + a[..., 1, :] * w[..., 1:2] + a[..., 2, :] * w[..., 2:3]


# ---------------------------------------------------------------------- RNG ---
def seed_thread(s):
    """Thomas Wang's hash on uint32 values held in int64."""
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & M32
    return s ^ (s >> 15)


def random01(s):
    """(next state, uniform in [0, 1)): xorshift32, the top 23 bits as a
    float in [1, 2) less 1."""
    s = s ^ ((s << 13) & M32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & M32)
    f = ((s >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return s, f


def pixel_seed(width: int, height: int, frame_index: int, device):
    """seed_thread((y * height + x) * frame_index), the upstream raygen's seed."""
    y = torch.arange(height, device=device, dtype=torch.int64)[:, None]
    x = torch.arange(width, device=device, dtype=torch.int64)[None, :]
    return seed_thread((((y * height + x) & M32) * (int(frame_index) & M32)) & M32)


# ----------------------------------------------------------------- textures ---
def sample(tex, tex_id, uv, fallback=None):
    """Bilinear sample of texture `tex_id` (-1: `fallback`, ones where None)
    at uv, wrapping (REPEAT) inside the texture, texel centres at +0.5."""
    safe = tex_id.clamp_min(0)
    w, h, off = tex.width[safe], tex.height[safe], tex.offset[safe]
    u = uv - torch.floor(uv)
    tx = u[..., 0] * w - 0.5
    ty = u[..., 1] * h - 0.5
    x0f, y0f = torch.floor(tx), torch.floor(ty)
    fx, fy = (tx - x0f)[..., None], (ty - y0f)[..., None]
    x0 = torch.remainder(x0f, w.clamp_min(1.0))
    y0 = torch.remainder(y0f, h.clamp_min(1.0))
    x1 = torch.where(x0 + 1 >= w, torch.zeros_like(x0), x0 + 1)
    y1 = torch.where(y0 + 1 >= h, torch.zeros_like(y0), y0 + 1)
    wi = w.long()

    def texel(yy, xx):
        return tex.texels[off + yy.long() * wi + xx.long()]

    out = (texel(y0, x0) * (1 - fx) * (1 - fy) + texel(y0, x1) * fx * (1 - fy)
           + texel(y1, x0) * (1 - fx) * fy + texel(y1, x1) * fx * fy)
    if fallback is None:
        fallback = torch.ones_like(out)
    return torch.where((tex_id >= 0)[..., None], out, fallback)


def normal_mapped(n, tan, nm_tex, ts_rgb):
    """Object-space normal mapping with the upstream shader's bitangent,
    cross(sampled normal, tangent) * tangent.w."""
    ts = normalize(ts_rgb * 2.0 - 1.0)
    bt = cross(ts, tan[..., :3]) * tan[..., 3:4]
    t = normalize(tan[..., :3] - n * dot(tan[..., :3], n)[..., None])
    m = t * ts[..., 0:1] + bt * ts[..., 1:2] + n * ts[..., 2:3]
    return torch.where((nm_tex >= 0)[..., None], m, n)


def material(sc, tri, w, world_pos_v):
    """What a surface point of triangles `tri` at vertex weights `w` reads:
    uv, object-space normal and tangent, world position, its primitive."""
    tv = sc.tri_vertex[tri]
    prim = sc.tri_prim[tri]
    return {"prim": prim, "uv": mix3(sc.uv0[tv], w), "normal": mix3(sc.normals[tv], w),
            "tangent": mix3(sc.tangents[tv], w), "position": mix3(world_pos_v[tv], w)}


def albedo_of(sc, at):
    p = at["prim"]
    return sample(sc.textures, sc.base_tex[p], at["uv"], sc.base_color[p])


def metal_rough(sc, at):
    """Metallic and roughness: factors times the texture's G and B."""
    p = at["prim"]
    mt = sc.mr_tex[p]
    mr = sample(sc.textures, mt, at["uv"])
    one = torch.ones_like(mr[..., 1])
    return (sc.metallic[p] * torch.where(mt >= 0, mr[..., 1], one),
            sc.roughness[p] * torch.where(mt >= 0, mr[..., 2], one))


def mapped_normal(sc, at):
    nt = sc.normal_tex[at["prim"]]
    ts = sample(sc.textures, nt, at["uv"])[..., :3]
    return normal_mapped(at["normal"], at["tangent"], nt, ts)


# --------------------------------------------------------------------- BRDF ---
def fresnel(f0, h, v):
    m = 1.0 - dot(h, v).clamp_min(0.0)[..., None]
    return f0 + (1.0 - f0) * m * m * m * m * m


def specular(rough, f, v, l, n, h):
    a2 = rough * rough
    ndh = dot(n, h).clamp_min(0.0)
    dd = ndh * ndh * (a2 - 1.0) + 1.0
    d_ggx = a2 / (PI * dd * dd)
    k = (rough + 1.0) * (rough + 1.0) * 0.125
    ndv, ndl = dot(n, v).clamp_min(0.0), dot(n, l).clamp_min(0.0)
    g = ndv / (ndv * (1.0 - k) + k) * (ndl / (ndl * (1.0 - k) + k))
    denom = 4.0 * ndv * ndl
    return (d_ggx * g)[..., None] * f / denom.clamp_min(1e-6)[..., None]


def diffuse(metallic, albedo, f):
    return (1.0 - f) * (1.0 - metallic)[..., None] * albedo / PI


def direct(albedo, metallic, rough, n, v, l, color, intensity, ambient_factor):
    rough = rough.clamp(MIN_ROUGHNESS, 1.0)
    metallic = metallic.clamp(0.0, 1.0)
    h = normalize(l + v)
    f0 = 0.04 + (albedo - 0.04) * metallic[..., None]
    f = fresnel(f0, h, v)
    ndl = dot(n, l).clamp_min(0.0)[..., None]
    return (albedo * ambient_factor
            + (diffuse(metallic, albedo, f) + specular(rough, f, v, l, n, h)) * ndl * intensity * color)


# ---------------------------------------------------------------- G-buffer ---
def weights(bary):
    s = bary[..., 2]
    inv = 1.0 / torch.where(s.abs() > 1e-12, s, torch.ones_like(s))
    l1, l2 = bary[..., 0] * inv, bary[..., 1] * inv
    return torch.stack([1.0 - l1 - l2, l1, l2], -1)


def gbuffer(sc, vis, world_pos_v, f):
    """Albedo (H, W, 4), normal + object id (H, W, 4), motion + metallic +
    roughness (H, W, 4), depth (H, W): the upstream gbuf shaders."""
    h, w = vis["tri"].shape
    valid = vis["tri"] >= 0
    at = material(sc, vis["tri"].clamp_min(0), weights(vis["bary"]), world_pos_v)
    albedo = albedo_of(sc, at)
    n = normalize(torch.einsum("...ij,...j->...i", sc.normal_mat[at["prim"]], mapped_normal(sc, at)))
    dev = albedo.device
    cur = torch.stack(torch.broadcast_tensors(
        (torch.arange(w, device=dev, dtype=torch.float32)[None, :] + 0.5) / w,
        (torch.arange(h, device=dev, dtype=torch.float32)[:, None] + 0.5) / h), -1)
    prev = points(f["prev_viewproj"], at["position"])
    motion = cur - (prev[..., :2] / prev[..., 3:4] * 0.5 + 0.5)
    metallic, rough = metal_rough(sc, at)
    v = valid[..., None]
    clear = torch.tensor([0.0, 0.0, -1.0, -1.0], device=dev)
    return {
        "albedo": torch.where(v, albedo, 0.0),
        "normal_oid": torch.where(v, torch.cat([n, at["prim"].float()[..., None]], -1), 0.0),
        "motion_mr": torch.where(v, torch.cat([motion, metallic[..., None], rough[..., None]], -1),
                                 clear),
        "depth": vis["depth"],
    }


def pixel_uv(h, w, device):
    return torch.stack(torch.broadcast_tensors(
        (torch.arange(w, device=device, dtype=torch.float32)[None, :] + 0.5) / w,
        (torch.arange(h, device=device, dtype=torch.float32)[:, None] + 0.5) / h), -1)


def from_depth(depth, uv, inverse):
    """Positions from reverse-Z depth: inverse @ (uv * 2 - 1, depth, 1),
    the w divide kept off zero (sky, depth 0, lands ~1e8 away)."""
    hp = points(inverse, torch.cat([uv * 2.0 - 1.0, depth[..., None]], -1))
    wv = hp[..., 3:4]
    wv = torch.where(wv.abs() < 1e-8, torch.where(wv < 0, -1e-8, 1e-8), wv)
    return hp[..., :3] / wv


# ---------------------------------------------------------- hybrid RT rays ---
def onb(n):
    """Frisvad's basis (t, b) around unit n."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    deg = nz < -0.9999999
    a = 1.0 / torch.where(deg, torch.ones_like(nz), 1.0 + nz)
    b = -nx * ny * a
    t = torch.stack([1.0 - nx * nx * a, b, -nx], -1)
    bb = torch.stack([b, 1.0 - ny * ny * a, -ny], -1)
    t = torch.where(deg[..., None], torch.tensor([0.0, -1.0, 0.0], device=n.device), t)
    bb = torch.where(deg[..., None], torch.tensor([-1.0, 0.0, 0.0], device=n.device), bb)
    return t, bb


def to_basis(n, d):
    t, b = onb(n)
    return d[..., 0:1] * t + d[..., 1:2] * b + d[..., 2:3] * n


def cone(u1, u2, cos_max):
    ct = (1.0 - u1) + u1 * cos_max
    st = (1.0 - ct * ct).clamp_min(0.0).sqrt()
    phi = u2 * TWO_PI
    return torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], -1)


def cosine_hemisphere(u1, u2):
    r = u1.sqrt()
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), (1.0 - u1).clamp_min(0.0).sqrt()], -1)


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def hit_attributes(sc, tri, u, v, world_pos_v):
    w = torch.stack([1.0 - u - v, u, v], -1)
    return material(sc, tri.clamp_min(0), w, world_pos_v)


def reflection_shade(sc, at, f):
    """The upstream reflection hit shader: ambient 0.2/pi and GGX direct
    light at the hit, the raw interpolated normal, no shadow."""
    albedo = albedo_of(sc, at)[..., :3]
    metallic, rough = metal_rough(sc, at)
    v = normalize(f["camera_pos"] - at["position"])
    n = at["normal"]
    l = torch.broadcast_to(f["to_light"], n.shape)
    rgb = direct(albedo, metallic, rough, n, v, l, f["light_color"], f["light_intensity"],
                 PI_INVERSE * 0.2)
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)


# --------------------------------------------------------------------- SVGF ---
ATROUS = [[1 / 256, 1 / 64, 3 / 128, 1 / 64, 1 / 256], [1 / 64, 1 / 16, 3 / 32, 1 / 16, 1 / 64],
          [3 / 128, 3 / 32, 9 / 64, 3 / 32, 3 / 128], [1 / 64, 1 / 16, 3 / 32, 1 / 16, 1 / 64],
          [1 / 256, 1 / 64, 3 / 128, 1 / 64, 1 / 256]]
GAUSS3 = [[1 / 16, 1 / 8, 1 / 16], [1 / 8, 1 / 4, 1 / 8], [1 / 16, 1 / 8, 1 / 16]]


def shift(img, dy: int, dx: int, fill: float = 0.0):
    """out[y, x] = img[y + dy, x + dx], `fill` outside (channel-last or 2-D)."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    ys, yd = slice(max(0, dy), h + min(0, dy)), slice(max(0, -dy), h - max(0, dy))
    xs, xd = slice(max(0, dx), w + min(0, dx)), slice(max(0, -dx), w - max(0, dx))
    if ys.start < ys.stop and xs.start < xs.stop:
        out[yd, xd] = img[ys, xs]
    return out


def svgf_temporal(normal_oid, motion_mr, shadow_ao, state):
    """(integrated (H, W, 4): shadow, ao, their variances; moments (H, W, 4)).
    History taps (2x2 bilinear at coords - motion * size + 0.5, else the
    3x3 around it) count where in the image, of the same object and with
    normals within pi/4; each tap reads its offset from the clamped base."""
    h, w = normal_oid.shape[:2]
    dev = normal_oid.device
    hist = torch.cat([state["shadow_ao_history"], state["moments_history"],
                      state["prev_normal_oid"]], -1)  # (H, W, 10)
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    px = xx - motion_mr[..., 0] * w + 0.5
    py = yy - motion_mr[..., 1] * h + 0.5
    fx, fy = px - torch.floor(px), py - torch.floor(py)
    ix, iy = torch.floor(px).long(), torch.floor(py).long()
    bx, by = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    cur_n, cur_oid = normal_oid[..., :3], normal_oid[..., 3].long()
    flat = hist.view(h * w, 10)

    def tap(oy, ox):
        sy, sx = by + oy, bx + ox
        inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
        row = flat[(sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1))]
        row = torch.where(inside[..., None], row, 0.0)
        ty, tx = iy + oy, ix + ox
        inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
        ok = inb & (cur_oid == row[..., 9].long()) & (dot(cur_n, row[..., 6:9]) >= COS_PI_4)
        return ok, row

    def accumulate(taps):
        acc = torch.zeros(h, w, 6, device=dev)
        wsum = torch.zeros(h, w, device=dev)
        for (oy, ox), wt in taps:
            ok, row = tap(oy, ox)
            vw = torch.where(ok, wt, torch.zeros_like(wt))
            acc = acc + vw[..., None] * row[..., :6]
            wsum = wsum + vw
        return acc, wsum

    bil, bw = accumulate([((0, 0), (1 - fx) * (1 - fy)), ((0, 1), fx * (1 - fy)),
                          ((1, 0), (1 - fx) * fy), ((1, 1), fx * fy)])
    one = torch.ones(h, w, device=dev)
    fb, fw = accumulate([((oy, ox), one) for oy in (-1, 0, 1) for ox in (-1, 0, 1)])
    use_fb = ~(bw > 1e-6)
    acc = torch.where(use_fb[..., None], fb, bil)
    wsum = torch.where(use_fb, fw, bw)
    valid = wsum > 1e-6
    prev = acc / wsum.clamp_min(1e-12)[..., None]
    s, a = shadow_ao[..., 0], shadow_ao[..., 1]
    cur_m = torch.stack([s, s * s, a, a * a], -1)
    mom = torch.where(valid[..., None], prev[..., 2:6] + (cur_m - prev[..., 2:6]) * 0.2, cur_m)
    var_s = (mom[..., 1] - mom[..., 0] * mom[..., 0]).clamp_min(0.0)
    var_a = (mom[..., 3] - mom[..., 2] * mom[..., 2]).clamp_min(0.0)
    int_s = torch.where(valid, prev[..., 0] + (s - prev[..., 0]) * 0.2, s)
    int_a = torch.where(valid, prev[..., 1] + (a - prev[..., 1]) * 0.2, a)
    return torch.stack([int_s, int_a, var_s, var_a], -1), mom


def atrous(x, normal_oid, step: int):
    """One edge-stopping a-trous pass (5x5 B3 spline at `step`): weights by
    object id, normal^128 and luminance over 4 sqrt(3x3-blurred variance);
    the centre weighs 1, taps outside the image none."""
    h, w = x.shape[:2]
    dev = x.device
    var_f = torch.zeros(h, w, 2, device=dev)
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            var_f = var_f + GAUSS3[oy + 1][ox + 1] * shift(x[..., 2:4], oy, ox)
    n_p, oid_p = normal_oid[..., :3], normal_oid[..., 3]
    s_sh = 4.0 * var_f[..., 0].sqrt() + 1e-6
    s_ao = 4.0 * var_f[..., 1].sqrt() + 1e-6
    sum_v = x.clone()
    ws = torch.ones(h, w, device=dev)
    wa = torch.ones(h, w, device=dev)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    for oy in range(-2, 3):
        for ox in range(-2, 3):
            if oy == 0 and ox == 0:
                continue
            dy, dx = oy * step, ox * step
            inb = ((ys + dy >= 0) & (ys + dy < h) & (xs + dx >= 0) & (xs + dx < w)).float()
            q = shift(x, dy, dx)
            n_q = shift(n_p, dy, dx)
            oid_q = shift(oid_p, dy, dx, fill=-2.0)
            w_n = dot(n_p, n_q).clamp_min(0.0) ** 128
            w_o = (oid_p.long() == oid_q.long()).float()
            base = ATROUS[oy + 2][ox + 2] * w_n * w_o * inb
            w_s = base * torch.exp(-(x[..., 0] - q[..., 0]).abs() / s_sh)
            w_a = base * torch.exp(-(x[..., 1] - q[..., 1]).abs() / s_ao)
            sum_v = sum_v + torch.stack([w_s * q[..., 0], w_a * q[..., 1], w_s * w_s * q[..., 2],
                                         w_a * w_a * q[..., 3]], -1)
            ws = ws + w_s
            wa = wa + w_a
    return torch.stack([sum_v[..., 0] / ws, sum_v[..., 1] / wa, sum_v[..., 2] / (ws * ws),
                        sum_v[..., 3] / (wa * wa)], -1)


def svgf(normal_oid, motion_mr, shadow_ao, state, iterations: int = 5):
    """(denoised (H, W, 4), the next state): the history is the first
    a-trous pass's output, the moments the temporal pass's."""
    x, mom = svgf_temporal(normal_oid, motion_mr, shadow_ao, state)
    hist = x[..., :2]
    for i in range(iterations):
        x = atrous(x, normal_oid, 1 << i)
        if i == 0:
            hist = x[..., :2]
    return x, {"shadow_ao_history": hist, "moments_history": mom, "prev_normal_oid": normal_oid}


# --------------------------------------------------------------------- SSAO ---
def bilinear_clamped(img, uv):
    """A linear clamp-to-edge sample of a 2-D image at uv in [0, 1]."""
    h, w = img.shape
    x = (uv[..., 0] * w - 0.5).clamp(0.0, w - 1.0)
    y = (uv[..., 1] * h - 0.5).clamp(0.0, h - 1.0)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    xi, yi = x0.long().clamp_max(w - 1), y0.long().clamp_max(h - 1)
    xj, yj = (xi + 1).clamp_max(w - 1), (yi + 1).clamp_max(h - 1)
    top = img[yi, xi] * (1 - fx) + img[yi, xj] * fx
    bot = img[yj, xi] * (1 - fx) + img[yj, xj] * fx
    return top * (1 - fy) + bot * fy


def ssao(f, depth, normal_oid, radius: float):
    """Alchemy AO, 16 samples of the shader RNG, then the 13x13 box blur
    that divides by 169 everywhere."""
    h, w = depth.shape
    dev = depth.device
    coords = torch.stack(torch.broadcast_tensors(
        torch.arange(w, device=dev, dtype=torch.float32)[None, :] / w,
        torch.arange(h, device=dev, dtype=torch.float32)[:, None] / h), -1)
    d0 = bilinear_clamped(depth, coords)
    p = from_depth(d0, coords, f["proj_inv"])
    n = normal_oid[..., :3] @ f["view"][:3, :3].T
    pr = radius / p[..., 2]
    state = pixel_seed(w, h, f["frame_index"], dev)
    acc = torch.zeros(h, w, device=dev)
    for _ in range(16):
        state, r1 = random01(state)
        state, r2 = random01(state)
        ang, dist = r1 * TWO_PI, r2 * pr
        suv = coords + torch.stack([torch.cos(ang) * dist, torch.sin(ang) * dist], -1)
        ps = from_depth(bilinear_clamped(depth, suv), suv, f["proj_inv"])
        v = ps - p
        acc = acc + (dot(v, n) - 1e-4).clamp_min(0.0) / (dot(v, v) + 1e-4)
    ao = (1.0 - (2.0 / 16) * acc).clamp_min(0.0)
    ao = torch.where(d0 == 0.0, torch.zeros_like(ao), ao)
    blur = torch.zeros_like(ao)
    for dy in range(-6, 7):
        for dx in range(-6, 7):
            blur = blur + shift(ao, dy, dx)
    return blur / 169.0


# --------------------------------------------------------------- shadow map ---
BIAS = torch.tensor([[0.5, 0, 0, 0.5], [0, 0.5, 0, 0.5], [0, 0, 1, 0], [0, 0, 0, 1]])


def pcf16(shadow_map, light_projview, p, bias: float = 1e-4):
    """16 nearest taps on a 4x4 grid of half-texel offsets (in units of
    1/4096 of the map), lit where depth >= stored - bias, averaged; the taps
    read as the program's 4-wide rows do: each row's four from the texel
    left of the grid, clamped."""
    hm, wm = shadow_map.shape
    sc = points(BIAS.to(p.device) @ light_projview, p)
    sc = sc[..., :3] / sc[..., 3:4]
    sx, sy = wm / 4096.0, hm / 4096.0
    fx, fy = sc[..., 0] * wm, sc[..., 1] * hm
    x0 = torch.floor(fx - 1.5 * sx).long().clamp(0, wm - 4)
    acc = torch.zeros_like(fx)
    offs = (-1.5, -0.5, 0.5, 1.5)
    for oy in offs:
        yj = (fy + oy * sy).to(torch.int64).clamp(0, hm - 1)
        for ox in offs:
            xi = (fx + ox * sx).to(torch.int64).clamp(0, wm - 1)
            lane = (xi - x0).clamp(0, 3)
            d = shadow_map[yj, x0 + lane]
            acc = acc + torch.where(sc[..., 2] < d - bias, 0.0, 1.0)
    return acc / 16.0


# -------------------------------------------------------------- composition ---
def compose(gb, f, shadow, ao, refl=None):
    """The upstream composition shader: ambient ao * albedo / pi, diffuse and
    GGX specular lit by the shadow term, specular replaced or blended by
    the reflection (times the shadow) by metalness and roughness."""
    h, w = gb["depth"].shape
    albedo = gb["albedo"][..., :3]
    p = from_depth(gb["depth"], pixel_uv(h, w, albedo.device), f["viewproj_inv"])
    n = gb["normal_oid"][..., :3]
    metallic = gb["motion_mr"][..., 2].clamp(0.0, 1.0)
    rough = gb["motion_mr"][..., 3].clamp(MIN_ROUGHNESS, 1.0)
    v = normalize(f["camera_pos"] - p)
    l = torch.broadcast_to(f["to_light"], n.shape)
    hv = normalize(l + v)
    f0 = 0.04 + (albedo - 0.04) * metallic[..., None]
    fr = fresnel(f0, hv, v)
    ndl = dot(n, l).clamp_min(0.0)
    common = (ndl * shadow)[..., None] * f["light_intensity"] * f["light_color"]
    amb = ao[..., None] * albedo * PI_INVERSE
    dif = diffuse(metallic, albedo, fr) * common
    spec = specular(rough, fr, v, l, n, hv) * common
    if refl is not None:
        r = refl[..., :3] * shadow[..., None]
        spec = torch.where((metallic == 1.0)[..., None], r, spec + (r - spec) * rough[..., None])
    rgb = amb + dif + spec
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)


def primary_shade(sc, at, lit, f, test_alpha: bool):
    """The upstream raytraced hit shader: ambient plus, where the shadow ray
    missed, N.L albedo light (the alpha-testing variant: ambient 0.2 albedo
    and no intensity factor)."""
    albedo = albedo_of(sc, at)[..., :3]
    n = mapped_normal(sc, at)
    ndl = dot(n, f["to_light"]).clamp_min(0.0)[..., None]
    if test_alpha:
        amb, dirl = 0.2 * albedo, albedo * ndl * f["light_color"]
    else:
        amb = PI_INVERSE * albedo
        dirl = albedo * ndl * f["light_intensity"] * f["light_color"]
    rgb = amb + torch.where(lit[..., None], dirl, torch.zeros_like(dirl))
    return torch.cat([rgb, torch.ones_like(rgb[..., :1])], -1)

