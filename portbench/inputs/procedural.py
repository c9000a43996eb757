"""Frozen copy of the port's ``scene/procedural.sponza_proxy`` at its
defaults: the SponzaProxy colonnade hall, 108,732 triangles, 288 of them
alpha-masked.  It returns host arrays (vertices, indices, primitives with
their transforms and materials, RGBA texture images, camera and sun), which
the port assembles through its ``scene/gltf.build_scene_buffers`` and the
reference through its own ``scene.from_arrays``.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# Mesh primitives (host-side numpy). Counter-clockwise winding viewed from outside.
# ---------------------------------------------------------------------------
def box_mesh(half=(1.0, 1.0, 1.0)):
    hx, hy, hz = half
    # 6 faces x 4 verts; normals per face; uv covers each face.
    faces = [
        # +x
        ([hx, -hy, -hz], [hx, hy, -hz], [hx, hy, hz], [hx, -hy, hz], [1, 0, 0], [0, 0, 1]),
        # -x
        ([-hx, -hy, hz], [-hx, hy, hz], [-hx, hy, -hz], [-hx, -hy, -hz], [-1, 0, 0], [0, 0, -1]),
        # +y
        ([-hx, hy, -hz], [-hx, hy, hz], [hx, hy, hz], [hx, hy, -hz], [0, 1, 0], [1, 0, 0]),
        # -y
        ([-hx, -hy, hz], [-hx, -hy, -hz], [hx, -hy, -hz], [hx, -hy, hz], [0, -1, 0], [1, 0, 0]),
        # +z
        ([-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz], [0, 0, 1], [1, 0, 0]),
        # -z
        ([hx, -hy, -hz], [-hx, -hy, -hz], [-hx, hy, -hz], [hx, hy, -hz], [0, 0, -1], [-1, 0, 0]),
    ]
    pos, nrm, tan, uv = [], [], [], []
    idx = []
    for f, (a, b, c, d, n, t) in enumerate(faces):
        base = 4 * f
        pos += [a, b, c, d]
        nrm += [n] * 4
        tan += [list(t) + [1.0]] * 4
        uv += [[0, 0], [1, 0], [1, 1], [0, 1]]
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (
        np.asarray(pos, np.float32),
        np.asarray(nrm, np.float32),
        np.asarray(tan, np.float32),
        np.asarray(uv, np.float32),
        np.asarray(idx, np.int32),
    )


def quad_mesh(size=(1.0, 1.0)):
    """Unit quad in the xz plane facing +y."""
    sx, sz = size
    pos = np.asarray(
        [[-sx, 0, -sz], [-sx, 0, sz], [sx, 0, sz], [sx, 0, -sz]], np.float32
    )
    nrm = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
    tan = np.tile(np.asarray([[1, 0, 0, 1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [0, 1], [1, 1], [1, 0]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.int32)
    return pos, nrm, tan, uv, idx


def grid_mesh(nx=64, nz=64, size=(1.0, 1.0), displace=0.0, seed=0):
    """Subdivided xz-plane grid facing +y with optional smooth displacement --
    the triangle-density workhorse for Sponza/Bistro-scale proxy scenes
    (2 * nx * nz triangles)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-size[0], size[0], nx + 1)
    zs = np.linspace(-size[1], size[1], nz + 1)
    px, pz = np.meshgrid(xs, zs, indexing="ij")
    py = np.zeros_like(px)
    if displace:
        f1, f2 = rng.uniform(1.0, 3.0, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        py = displace * (
            np.sin(f1 * px / size[0] * np.pi + p1) * np.cos(f2 * pz / size[1] * np.pi + p2)
        )
    pos = np.stack([px, py, pz], axis=-1).reshape(-1, 3).astype(np.float32)
    # analytic-ish normals via central differences
    dx = np.gradient(py, axis=0) / max(np.gradient(px, axis=0).mean(), 1e-6)
    dz = np.gradient(py, axis=1) / max(np.gradient(pz, axis=1).mean(), 1e-6)
    n = np.stack([-dx, np.ones_like(py), -dz], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    nrm = n.reshape(-1, 3).astype(np.float32)
    tan = np.zeros((len(pos), 4), np.float32)
    tan[:, 0] = 1.0
    tan[:, 3] = 1.0
    u, v = np.meshgrid(
        np.linspace(0, 1, nx + 1), np.linspace(0, 1, nz + 1), indexing="ij"
    )
    uv = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)
    idx = []
    for i in range(nx):
        for j in range(nz):
            a = i * (nz + 1) + j
            b = a + nz + 1
            idx += [a, a + 1, b + 1, a, b + 1, b]
    return pos, nrm, tan, uv, np.asarray(idx, np.int32)


def cylinder_mesh(radius=0.5, height=2.0, segments=16):
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # (S, 2)
    bottom = np.concatenate(
        [radius * ring[:, :1], np.zeros((segments, 1)), radius * ring[:, 1:]], axis=-1
    )
    top = bottom + np.asarray([0, height, 0])
    pos = np.concatenate([bottom, top]).astype(np.float32)
    n = np.concatenate(
        [ring[:, :1], np.zeros((segments, 1)), ring[:, 1:]], axis=-1
    ).astype(np.float32)
    nrm = np.concatenate([n, n])
    tan = np.zeros((2 * segments, 4), np.float32)
    tan[:, 0] = -nrm[:, 2]
    tan[:, 2] = nrm[:, 0]
    tan[:, 3] = 1.0
    u = np.linspace(0, 1, segments, endpoint=False)
    uv = np.concatenate(
        [np.stack([u, np.zeros(segments)], -1), np.stack([u, np.ones(segments)], -1)]
    ).astype(np.float32)
    idx = []
    for s in range(segments):
        s2 = (s + 1) % segments
        idx += [s, s2, segments + s2, s, segments + s2, segments + s]
    return pos, nrm, tan, uv, np.asarray(idx, np.int32)


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def scale_mat(s):
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate_y(a):
    m = np.eye(4, dtype=np.float32)
    c, s = np.cos(a), np.sin(a)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


# ---------------------------------------------------------------------------
# Procedural textures
# ---------------------------------------------------------------------------
def checker_texture(size=64, c0=(255, 255, 255), c1=(40, 40, 40), tiles=8):
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    mask = ((yy * tiles // size) + (xx * tiles // size)) % 2 == 0
    img = np.zeros((size, size, 4), np.uint8)
    img[..., :3] = np.where(mask[..., None], np.uint8(c0), np.uint8(c1))
    img[..., 3] = 255
    return img


def brick_texture(size=128, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 4), np.uint8)
    base = np.asarray([155, 80, 60], np.float32)
    noise = rng.normal(0, 10, (size, size, 1)).astype(np.float32)
    img[..., :3] = np.clip(base + noise, 0, 255).astype(np.uint8)
    bh, bw = size // 8, size // 4
    for r in range(0, size, bh):
        img[r : r + 2, :, :3] = 70
        off = (r // bh % 2) * bw // 2
        for cstart in range(-bw, size + bw, bw):
            c = cstart + off
            img[r : r + bh, max(c, 0) : max(c + 2, 0), :3] = 70
    img[..., 3] = 255
    return img


def leaf_texture(size=64):
    """Alpha-masked foliage-like texture (tests alpha_cutoff paths)."""
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    r = np.sqrt(xx**2 + yy**2)
    alpha = (r < 0.8).astype(np.uint8) * 255
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = 140
    img[..., 0] = 30
    img[..., 2] = 30
    img[..., 3] = alpha
    return img


# ---------------------------------------------------------------------------
# Scene assembly helper
# ---------------------------------------------------------------------------
class SceneBuilder:
    def __init__(self):
        self.positions, self.normals, self.tangents = [], [], []
        self.uv0, self.indices = [], []
        self.prims = []
        self.images = []
        self.srgb = []
        self._v = 0
        self._i = 0

    def add_texture(self, img, srgb=True) -> int:
        self.images.append(img)
        self.srgb.append(srgb)
        return len(self.images) - 1

    def add(self, mesh, transform=None, **material):
        pos, nrm, tan, uv, idx = mesh
        self.prims.append(
            dict(
                transform=np.eye(4, dtype=np.float32) if transform is None else transform,
                vertex_offset=self._v,
                index_offset=self._i,
                index_count=len(idx),
                **material,
            )
        )
        self.positions.append(pos)
        self.normals.append(nrm)
        self.tangents.append(tan)
        self.uv0.append(uv)
        self.indices.append(idx)
        self._v += len(pos)
        self._i += len(idx)
        return len(self.prims) - 1

    def build(self, name, camera: dict, light: dict) -> dict:
        """The scene's host arrays: the entries ``build_scene_buffers`` takes
        (uv1 mirrors uv0), with the name, camera and sun."""
        return {
            "name": name,
            "positions": np.concatenate(self.positions),
            "normals": np.concatenate(self.normals),
            "tangents": np.concatenate(self.tangents),
            "uv0": np.concatenate(self.uv0),
            "uv1": np.concatenate(self.uv0),
            "indices": np.concatenate(self.indices),
            "primitives": self.prims,
            "images": self.images,
            "srgb": self.srgb,
            "camera": camera,
            "light": light,
        }


# ---------------------------------------------------------------------------
# Scenes
# ---------------------------------------------------------------------------
def sponza_proxy(columns=12, segments=48, extra_boxes=600, grid_res=128, seed=7,
                 name="SponzaProxy") -> dict:
    """Colonnade hall, the perf stand-in for Sponza (BASELINE.md configs).

    Default params yield ~200k triangles (real Sponza is ~262k): displaced-grid
    floor/ceiling/tapestries carry the density, plus columns, clutter, and
    alpha-masked foliage.  Raise grid_res/extra_boxes for Bistro-scale runs.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    brick = b.add_texture(brick_texture(), srgb=True)
    check = b.add_texture(checker_texture(128, (200, 190, 170), (90, 85, 75), 16), srgb=True)
    leaf = b.add_texture(leaf_texture(), srgb=True)

    floor_mat = dict(base_color_texture=check, metallic_factor=0.0, roughness_factor=0.8)
    wall_mat = dict(base_color_texture=brick, metallic_factor=0.0, roughness_factor=0.95)
    col_mat = dict(base_color=(0.75, 0.72, 0.65, 1.0), metallic_factor=0.0, roughness_factor=0.7)
    metal_mat = dict(base_color=(0.9, 0.9, 0.95, 1.0), metallic_factor=1.0, roughness_factor=0.15)
    leaf_mat = dict(
        base_color_texture=leaf, alpha_mask=1, alpha_cutoff=0.5,
        metallic_factor=0.0, roughness_factor=1.0,
    )

    L, W_, H = 24.0, 10.0, 8.0  # hall dimensions
    # dense displaced grids carry the triangle budget (floor, ceiling, two
    # tapestry-like drapes along the walls)
    b.add(grid_mesh(grid_res, grid_res, (L / 2, W_ / 2), displace=0.03, seed=1),
          translate([0, 0.0, 0]), **floor_mat)
    flip_down = scale_mat([1, -1, -1])  # proper rotation (pi about x): faces -y
    b.add(grid_mesh(grid_res, grid_res, (L / 2, W_ / 2), displace=0.05, seed=2),
          translate([0, H, 0]) @ flip_down, **wall_mat)
    drape = grid_mesh(grid_res, grid_res // 2, (L / 2 - 1.0, H / 2 - 1.0),
                      displace=0.15, seed=3)
    rot_up = np.array(
        [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
    )  # xz-grid -> xy wall panel facing +z
    b.add(drape, translate([0, H / 2, -W_ / 2 + 0.3]) @ rot_up, **wall_mat)
    b.add(drape, translate([0, H / 2, W_ / 2 - 0.3]) @ rotate_y(np.pi) @ rot_up,
          **wall_mat)
    b.add(box_mesh((L / 2, H / 2, 0.2)), translate([0, H / 2, -W_ / 2]), **wall_mat)
    b.add(box_mesh((L / 2, H / 2, 0.2)), translate([0, H / 2, W_ / 2]), **wall_mat)
    b.add(box_mesh((0.2, H / 2, W_ / 2)), translate([-L / 2, H / 2, 0]), **wall_mat)
    b.add(box_mesh((0.2, H / 2, W_ / 2)), translate([L / 2, H / 2, 0]), **wall_mat)
    b.add(box_mesh((L / 2, 0.2, W_ / 2)), translate([0, H + 0.2, 0]), **wall_mat)

    cyl = cylinder_mesh(0.35, 4.0, segments)
    for i in range(columns):
        x = -L / 2 + (i + 0.5) * L / columns
        for z in (-W_ / 4, W_ / 4):
            b.add(cyl, translate([x, 0, z]), **col_mat)
            b.add(box_mesh((0.5, 0.1, 0.5)), translate([x, 4.1, z]), **col_mat)
            b.add(box_mesh((0.45, 0.08, 0.45)), translate([x, 0.08, z]), **col_mat)

    # clutter boxes (some metallic for reflections), floating leaves for alpha test
    for i in range(extra_boxes):
        s = rng.uniform(0.1, 0.5)
        x = rng.uniform(-L / 2 + 1, L / 2 - 1)
        z = rng.uniform(-W_ / 2 + 1, W_ / 2 - 1)
        mat = metal_mat if i % 7 == 0 else dict(
            base_color=(*rng.uniform(0.2, 0.9, 3), 1.0),
            metallic_factor=0.0,
            roughness_factor=float(rng.uniform(0.3, 1.0)),
        )
        b.add(
            box_mesh((s, s, s)),
            translate([x, s, z]) @ rotate_y(rng.uniform(0, np.pi)),
            **mat,
        )
    for i in range(24):
        x = rng.uniform(-L / 2 + 2, L / 2 - 2)
        z = rng.uniform(-W_ / 2 + 1, W_ / 2 - 1)
        y = rng.uniform(2.0, 5.0)
        b.add(
            box_mesh((0.6, 0.6, 0.01)),
            translate([x, y, z]) @ rotate_y(rng.uniform(0, np.pi)),
            **leaf_mat,
        )

    cam = dict(
        yfov=float(np.deg2rad(65.0)),
        znear=0.1,
        aspect=16 / 9,
        yaw=float(np.deg2rad(-90.0)),
        pitch=float(np.deg2rad(-8.0)),
        position=np.array([-L / 2 + 1.5, 2.2, 0.0], np.float32),
    )
    light = dict(direction=[0.3, -0.85, 0.25], color=(1.0, 1.0, 1.0), intensity=30.0)
    return b.build(name, cam, light)


def make(params: dict, workdir) -> dict:
    """The scene ``params["scene"]`` names (``sponza_proxy``) with
    ``params["args"]``; {"arrays": its host arrays}."""
    scenes = {"sponza_proxy": sponza_proxy}
    return {"arrays": scenes[params["scene"]](**params.get("args", {}))}
