"""Programmatic construction of real multi-feature glTF 2.0 binary assets
(port of ``scene/sample_asset.py``).

The reference renderer ships binary scenes; with no network, the equivalent
assets are built here from scratch, with a writer (raw struct / json / numpy,
PNG textures through ``utils/png``) that shares no code with
``scene/gltf.py``, so loading them round-trips the loader.  The meshes,
textures, materials and nodes are the reference package's, value for value;
only the PNG bytes differ, and they decode to the same pixels.

``build_sample_glb`` writes the "Atrium", which exercises every loader
branch:
  * 11 primitives over a node hierarchy (parented transforms, TRS nodes)
  * 4 embedded PNG textures: sRGB base color, alpha-cutout leaf, normal map,
    metallic-roughness (linear)
  * 4 materials: textured PBR (+ normal / MR maps), alpha MASK with cutoff,
    factor-only, a second textured one
  * one interleaved vertex buffer (byteStride accessors)
  * one sparse accessor (displaced positions)
  * TEXCOORD_1 on one primitive, TANGENTs where normal-mapped
  * u16 and u32 index types
  * a perspective camera node and a KHR_lights_punctual directional light
``build_sponza_class_glb`` writes the flagship benchmark asset ("realglb").
"""
from __future__ import annotations

import json
import struct

import numpy as np

from vulkanhybridrenderer_tpu_torch.utils.png import encode_png


def _brick_texture(n=64):
    img = np.zeros((n, n, 4), np.uint8)
    img[..., 3] = 255
    for y in range(n):
        for_row = (y // 8) % 2
        for x in range(n):
            mortar = (y % 8 == 0) or ((x + for_row * 4) % 8 == 0)
            img[y, x, :3] = (190, 190, 185) if mortar else (165, 70, 48)
    return img


def _leaf_texture(n=32):
    img = np.zeros((n, n, 4), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    c = ((yy - n / 2) ** 2 / (n / 2.2) ** 2 + (xx - n / 2) ** 2 / (n / 3.2) ** 2) < 1
    img[..., 1] = np.where(c, 150, 0)
    img[..., 0] = np.where(c, 40, 0)
    img[..., 2] = np.where(c, 30, 0)
    img[..., 3] = np.where(c, 255, 0)
    return img


def _normal_map(n=32):
    img = np.zeros((n, n, 4), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    nx = 0.3 * np.sin(xx * np.pi / 4)
    ny = 0.3 * np.sin(yy * np.pi / 4)
    nz = np.sqrt(np.clip(1 - nx**2 - ny**2, 0, 1))
    img[..., 0] = ((nx * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 1] = ((ny * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 2] = ((nz * 0.5 + 0.5) * 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def _mr_texture(n=32):
    img = np.zeros((n, n, 4), np.uint8)
    yy, xx = np.mgrid[0:n, 0:n]
    img[..., 1] = 40 + (xx * 4).astype(np.uint8)
    img[..., 2] = np.where((yy // 8 + xx // 8) % 2 == 0, 220, 60)
    img[..., 3] = 255
    return img


def _quad(sx=1.0, sz=1.0):
    pos = np.array(
        [[-sx, 0, -sz], [sx, 0, -sz], [sx, 0, sz], [-sx, 0, sz]], np.float32
    )
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    tan = np.tile(np.array([[1, 0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    return pos, nrm, tan, uv, idx


def _box(hx=0.5, hy=0.5, hz=0.5):
    faces = []
    for axis, sign in [(0, 1), (0, -1), (1, 1), (1, -1), (2, 1), (2, -1)]:
        n = np.zeros(3, np.float32)
        n[axis] = sign
        u = np.zeros(3, np.float32)
        u[(axis + 1) % 3] = 1
        v = np.cross(n, u)
        c = n * (hx, hy, hz)[axis]
        hu = (hx, hy, hz)[(axis + 1) % 3]
        hv = float(np.abs(v @ np.array([hx, hy, hz])))
        quad = [
            c - u * hu - v * hv, c + u * hu - v * hv,
            c + u * hu + v * hv, c - u * hu + v * hv,
        ]
        faces.append((np.asarray(quad, np.float32), n))
    pos = np.concatenate([f[0] for f in faces])
    nrm = np.concatenate([np.tile(f[1], (4, 1)) for f in faces]).astype(np.float32)
    uv = np.tile(np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), (6, 1))
    tan = np.zeros((24, 4), np.float32)
    tan[:, 0] = 1
    tan[:, 3] = 1
    idx = np.concatenate(
        [np.array([0, 2, 1, 0, 3, 2], np.uint16) + 4 * f for f in range(6)]
    )
    return pos, nrm, tan, uv, idx


def _icosahedron():
    t = (1 + 5**0.5) / 2
    v = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float32,
    )
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.uint32,
    )
    return v, f


class _GlbWriter:
    """Minimal from-scratch GLB writer (not derived from the loader)."""

    def __init__(self):
        self.bin = bytearray()
        self.views = []
        self.accessors = []

    def _pad(self, align=4):
        while len(self.bin) % align:
            self.bin.append(0)

    def add_view(self, data: bytes, stride=None) -> int:
        self._pad()
        view = {"buffer": 0, "byteOffset": len(self.bin), "byteLength": len(data)}
        if stride is not None:
            view["byteStride"] = stride
        self.bin.extend(data)
        self.views.append(view)
        return len(self.views) - 1

    def add_accessor(self, arr: np.ndarray, type_str: str, component: int,
                     view=None, byte_offset=0, normalized=False,
                     minmax=False) -> int:
        if view is None:
            view = self.add_view(np.ascontiguousarray(arr).tobytes())
            byte_offset = 0
        acc = {
            "bufferView": view,
            "byteOffset": byte_offset,
            "componentType": component,
            "count": int(arr.shape[0]),
            "type": type_str,
        }
        if normalized:
            acc["normalized"] = True
        if minmax:
            acc["min"] = np.asarray(arr).min(0).tolist()
            acc["max"] = np.asarray(arr).max(0).tolist()
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def write(self, path, doc: dict):
        """Write `doc` (its one buffer sized here) and the binary chunk as a
        GLB file."""
        self._pad()
        doc["buffers"] = [{"byteLength": len(self.bin)}]
        js = json.dumps(doc).encode()
        while len(js) % 4:
            js += b" "
        total = 12 + 8 + len(js) + 8 + len(self.bin)
        with open(path, "wb") as fh:
            fh.write(struct.pack("<III", 0x46546C67, 2, total))
            fh.write(struct.pack("<II", len(js), 0x4E4F534A))
            fh.write(js)
            fh.write(struct.pack("<II", len(self.bin), 0x004E4942))
            fh.write(bytes(self.bin))


F32 = 5126
U16 = 5123
U32 = 5125


def build_sample_glb(path) -> dict:
    """Write the Atrium GLB to `path`; returns ground-truth info for tests."""
    w = _GlbWriter()
    truth = {"prims": 0}

    images = [
        _brick_texture(), _leaf_texture(), _normal_map(), _mr_texture()
    ]
    image_views = [w.add_view(encode_png(im)) for im in images]

    meshes = []
    nodes = []

    # ---- floor: INTERLEAVED pos/normal/uv buffer with byteStride --------------
    pos, nrm, tan, uv, idx = _quad(6.0, 6.0)
    inter = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)  # (4, 8)
    iv = w.add_view(inter.tobytes(), stride=32)
    a_pos = w.add_accessor(pos, "VEC3", F32, view=iv, byte_offset=0, minmax=True)
    a_nrm = w.add_accessor(nrm, "VEC3", F32, view=iv, byte_offset=12)
    a_uv = w.add_accessor(uv, "VEC2", F32, view=iv, byte_offset=24)
    a_tan = w.add_accessor(tan, "VEC4", F32)
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    meshes.append({"primitives": [{
        "attributes": {"POSITION": a_pos, "NORMAL": a_nrm, "TEXCOORD_0": a_uv,
                       "TANGENT": a_tan},
        "indices": a_idx, "material": 0,
    }]})
    nodes.append({"mesh": 0, "name": "floor"})
    truth["prims"] += 1
    truth["floor_interleaved_pos"] = pos.copy()

    # ---- 4 columns (boxes, factor material), CHILDREN of a parent node --------
    pos, nrm, tan, uv, idx = _box(0.35, 1.6, 0.35)
    a = {
        "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
        "NORMAL": w.add_accessor(nrm, "VEC3", F32),
        "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
    }
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": 2}
    ]})
    col_children = []
    for i, (cx, cz) in enumerate([(-3, -3), (3, -3), (-3, 3), (3, 3)]):
        nodes.append({"mesh": 1, "translation": [cx, 1.6, cz],
                      "name": f"column{i}"})
        col_children.append(len(nodes) - 1)
        truth["prims"] += 1
    # parent shifts all columns by +0.5 in z (exercises hierarchy transforms)
    nodes.append({"children": col_children, "translation": [0, 0, 0.5],
                  "name": "colonnade"})
    truth["column0_world_x"] = -3.0
    truth["column0_world_z"] = -3.0 + 0.5

    # ---- back wall (textured brick + normal map + MR map) ---------------------
    pos, nrm, tan, uv, idx = _quad(6.0, 2.0)
    a = {
        "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
        "NORMAL": w.add_accessor(nrm, "VEC3", F32),
        "TANGENT": w.add_accessor(tan, "VEC4", F32),
        "TEXCOORD_0": w.add_accessor(uv * 3.0, "VEC2", F32),
    }
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": 0}
    ]})
    nodes.append({"mesh": 2, "translation": [0, 2.0, -6.0],
                  "rotation": [0.7071068, 0, 0, 0.7071068], "name": "wall"})
    truth["prims"] += 1

    # ---- 2 alpha-masked leaves ------------------------------------------------
    pos, nrm, tan, uv, idx = _quad(0.8, 0.8)
    a = {
        "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
        "NORMAL": w.add_accessor(nrm, "VEC3", F32),
        "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
    }
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": 1}
    ]})
    for i, (lx, lz) in enumerate([(-1.5, 0.0), (1.5, 1.0)]):
        nodes.append({"mesh": 3, "translation": [lx, 1.2, lz],
                      "name": f"leaf{i}"})
        truth["prims"] += 1

    # ---- sphere with SPARSE position accessor (u32 indices) -------------------
    v, f = _icosahedron()
    base_pos = v.astype(np.float32)
    # sparse: push 4 vertices outward 1.5x
    sparse_idx = np.array([0, 3, 7, 9], np.uint16)
    sparse_vals = (base_pos[sparse_idx] * 1.5).astype(np.float32)
    pv = w.add_view(base_pos.tobytes())
    acc = {
        "bufferView": pv,
        "byteOffset": 0,
        "componentType": F32,
        "count": len(base_pos),
        "type": "VEC3",
        "min": base_pos.min(0).tolist(),
        "max": (base_pos.max(0) * 1.5).tolist(),
        "sparse": {
            "count": 4,
            "indices": {
                "bufferView": w.add_view(sparse_idx.tobytes()),
                "componentType": U16,
            },
            "values": {"bufferView": w.add_view(sparse_vals.tobytes())},
        },
    }
    w.accessors.append(acc)
    a_pos = len(w.accessors) - 1
    a = {
        "POSITION": a_pos,
        "NORMAL": w.add_accessor(base_pos, "VEC3", F32),
    }
    a_idx = w.add_accessor(f.reshape(-1, 1).astype(np.uint32), "SCALAR", U32)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": 2}
    ]})
    nodes.append({"mesh": 4, "translation": [0, 1.0, -2.0],
                  "scale": [0.6, 0.6, 0.6], "name": "spiky"})
    truth["prims"] += 1
    truth["sparse_vertex0_local"] = base_pos[0] * 1.5  # displaced by sparse

    # ---- quad with TEXCOORD_1 + second textured material (brick again) --------
    pos, nrm, tan, uv, idx = _quad(1.2, 1.2)
    uv1 = uv * 0.5 + 0.25
    a = {
        "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
        "NORMAL": w.add_accessor(nrm, "VEC3", F32),
        "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
        "TEXCOORD_1": w.add_accessor(uv1, "VEC2", F32),
    }
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    # two primitives in ONE mesh (multi-primitive mesh branch)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": 3},
        {"attributes": a, "indices": a_idx, "material": 2},
    ]})
    nodes.append({"mesh": 5, "translation": [2.5, 0.01, 2.5], "name": "rug"})
    truth["prims"] += 2
    truth["uv1"] = uv1.copy()

    # ---- camera + light nodes -------------------------------------------------
    nodes.append({
        "camera": 0,
        "translation": [0.0, 2.2, 7.0],
        "name": "cam",
    })
    nodes.append({
        "extensions": {"KHR_lights_punctual": {"light": 0}},
        "rotation": [-0.3826834, 0, 0, 0.9238795],  # pitch -45deg: light down -z/-y
        "name": "sun",
    })

    doc = {
        "asset": {"version": "2.0", "generator": "vulkanhybridrenderer_tpu test"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "cameras": [{
            "type": "perspective",
            "perspective": {"yfov": 1.0, "znear": 0.1, "aspectRatio": 1.0},
        }],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.98, 0.92], "intensity": 3.0}
        ]}},
        "materials": [
            {  # 0: brick + normal map + MR map
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": 0},
                    "metallicRoughnessTexture": {"index": 3},
                },
                "normalTexture": {"index": 2},
            },
            {  # 1: alpha-masked leaf
                "pbrMetallicRoughness": {"baseColorTexture": {"index": 1}},
                "alphaMode": "MASK",
                "alphaCutoff": 0.4,
                "doubleSided": True,
            },
            {  # 2: factor-only
                "pbrMetallicRoughness": {
                    "baseColorFactor": [0.75, 0.78, 0.82, 1.0],
                    "metallicFactor": 0.1,
                    "roughnessFactor": 0.8,
                },
            },
            {  # 3: brick, no extra maps
                "pbrMetallicRoughness": {"baseColorTexture": {"index": 0}},
            },
        ],
        "textures": [{"source": i} for i in range(4)],
        "images": [
            {"bufferView": v, "mimeType": "image/png"} for v in image_views
        ],
        "bufferViews": w.views,
        "accessors": w.accessors,
    }

    w.write(path, doc)
    return truth


# ---------------------------------------------------------------------------
# Sponza-class benchmark asset (bench.py's realglb)
# ---------------------------------------------------------------------------
def _texture_variant(i: int, n: int = 64) -> np.ndarray:
    """Distinct procedural 64x64 RGBA texture per index: brick / stripe /
    checker / noise pattern families with per-index palettes."""
    rng = np.random.default_rng(1000 + i)
    c0 = rng.integers(60, 230, 3)
    c1 = rng.integers(20, 120, 3)
    yy, xx = np.mgrid[0:n, 0:n]
    fam = i % 4
    if fam == 0:  # brick
        row = (yy // 8) % 2
        m = (yy % 8 == 0) | (((xx + row * 4) % 8) == 0)
    elif fam == 1:  # stripes
        m = ((xx + yy // 2) // (3 + i % 5)) % 2 == 0
    elif fam == 2:  # checker
        t = 4 + (i % 3) * 4
        m = ((xx // t) + (yy // t)) % 2 == 0
    else:  # blob noise
        m = rng.random((n // 8, n // 8)).repeat(8, 0).repeat(8, 1) > 0.5
    img = np.zeros((n, n, 4), np.uint8)
    img[..., :3] = np.where(m[..., None], c0, c1)
    img[..., 3] = 255
    return img


def _grid_np(nx: int, nz: int, sx: float, sz: float, amp: float, seed: int):
    """Subdivided xz grid with smooth displacement; u32 indices."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-sx, sx, nx + 1, dtype=np.float32)
    z = np.linspace(-sz, sz, nz + 1, dtype=np.float32)
    xx, zz = np.meshgrid(x, z, indexing="ij")
    y = np.zeros_like(xx)
    for _ in range(3):
        fx, fz = rng.uniform(0.3, 1.8, 2)
        ph1, ph2 = rng.uniform(0, 6.28, 2)
        y += amp * np.sin(xx * fx + ph1) * np.cos(zz * fz + ph2) / 3
    pos = np.stack([xx, y, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    # smooth normals from the analytic-ish finite differences
    dy_dx = np.gradient(y, axis=0) / max(np.gradient(x).mean(), 1e-6)
    dy_dz = np.gradient(y, axis=1) / max(np.gradient(z).mean(), 1e-6)
    nrm = np.stack([-dy_dx, np.ones_like(y), -dy_dz], axis=-1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm.reshape(-1, 3).astype(np.float32)
    u, v = np.meshgrid(
        np.linspace(0, 4, nx + 1), np.linspace(0, 4, nz + 1), indexing="ij"
    )
    uv = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    v00 = (ii * (nz + 1) + jj).ravel()
    v01 = v00 + 1
    v10 = ((ii + 1) * (nz + 1) + jj).ravel()
    v11 = v10 + 1
    idx = np.stack([v00, v01, v11, v00, v11, v10], axis=1).reshape(-1)
    return pos, nrm, uv, idx.astype(np.uint32)


def _cylinder_np(nseg: int, nh: int, r: float, h: float):
    """Open column shaft with smooth normals; u32 indices."""
    th = np.linspace(0, 2 * np.pi, nseg + 1, dtype=np.float32)
    y = np.linspace(0, h, nh + 1, dtype=np.float32)
    tt, yy = np.meshgrid(th, y, indexing="ij")
    # mild entasis (column taper) for visual interest
    rr = r * (1.0 - 0.15 * (yy / h))
    pos = np.stack(
        [rr * np.cos(tt), yy, rr * np.sin(tt)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    nrm = np.stack(
        [np.cos(tt), np.zeros_like(tt), np.sin(tt)], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    uv = np.stack([tt / (2 * np.pi) * 4, yy / h * 4], axis=-1).reshape(
        -1, 2
    ).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(nseg), np.arange(nh), indexing="ij")
    v00 = (ii * (nh + 1) + jj).ravel()
    v01 = v00 + 1
    v10 = ((ii + 1) * (nh + 1) + jj).ravel()
    v11 = v10 + 1
    idx = np.stack([v00, v11, v01, v00, v10, v11], axis=1).reshape(-1)
    return pos, nrm, uv, idx.astype(np.uint32)


def build_sponza_class_glb(path, scale: float = 1.0) -> dict:
    """Write a Sponza-scale textured GLB: >= 250k triangles (at scale=1),
    >= 32 distinct textures, hundreds of primitives with full material
    diversity (normal maps, MR maps, alpha MASK foliage, factor-only).  The
    real-asset benchmark target of BASELINE.md configs 3/5 (the reference
    renders Sponza/Bistro, README.md:20-23), generated in the repository so
    that no download is needed.  At scale=1: 254,636 triangles, 370
    primitives, 39 textures.  `scale` shrinks subdivision counts for fast
    CPU tests."""
    w = _GlbWriter()
    truth = {"prims": 0, "textures": 0}

    def sc(n, lo=2):
        return max(lo, int(round(n * scale)))

    n_col_tex = 24
    images = [_texture_variant(i) for i in range(n_col_tex + 12)]
    images.append(_leaf_texture(32))
    leaf_tex = len(images) - 1
    images.append(_normal_map(32))
    nm_tex = len(images) - 1
    images.append(_mr_texture(32))
    mr_tex = len(images) - 1
    image_views = [w.add_view(encode_png(im)) for im in images]
    truth["textures"] = len(images)

    materials = []

    def add_mat(tex=None, nm=False, mr=False, mask=False, factor=None):
        m = {"pbrMetallicRoughness": {}}
        if tex is not None:
            m["pbrMetallicRoughness"]["baseColorTexture"] = {"index": tex}
        if factor is not None:
            m["pbrMetallicRoughness"]["baseColorFactor"] = list(factor)
        m["pbrMetallicRoughness"]["metallicFactor"] = 0.05
        m["pbrMetallicRoughness"]["roughnessFactor"] = 0.85
        if nm:
            m["normalTexture"] = {"index": nm_tex}
        if mr:
            m["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
                "index": mr_tex
            }
        if mask:
            m["alphaMode"] = "MASK"
            m["alphaCutoff"] = 0.4
            m["doubleSided"] = True
        materials.append(m)
        return len(materials) - 1

    meshes = []
    nodes = []

    def add_mesh(pos, nrm, uv, idx, mat, name, translation=None, rotation=None,
                 m_scale=None, instances=None):
        a = {
            "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
            "NORMAL": w.add_accessor(nrm, "VEC3", F32),
            "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
        }
        comp = U32 if pos.shape[0] > 65000 or idx.max() > 65000 else U16
        arr = idx.astype(np.uint32 if comp == U32 else np.uint16)
        a_idx = w.add_accessor(arr.reshape(-1, 1), "SCALAR", comp)
        meshes.append({"primitives": [
            {"attributes": a, "indices": a_idx, "material": mat}
        ]})
        mesh_id = len(meshes) - 1
        for k, inst in enumerate(instances or [(translation, rotation, m_scale)]):
            tr, rot, s = inst
            node = {"mesh": mesh_id, "name": f"{name}{k}"}
            if tr is not None:
                node["translation"] = list(tr)
            if rot is not None:
                node["rotation"] = list(rot)
            if s is not None:
                node["scale"] = list(s)
            nodes.append(node)
            truth["prims"] += 1
        return mesh_id

    rng = np.random.default_rng(7)

    # ground: large displaced grid
    g = sc(186, lo=8)
    pos, nrm, uv, idx = _grid_np(g, g, 20.0, 12.0, 0.25, seed=1)
    add_mesh(pos, nrm, uv, idx, add_mat(tex=0, nm=True, mr=True), "ground",
             translation=[0, 0, 0])

    # 4 boundary walls (vertical displaced grids via +-90deg x-rotation)
    wx = sc(128, lo=8)
    wyn = sc(24, lo=4)
    for i, (t, rot) in enumerate([
        ([0, 4.0, -12.0], [0.7071068, 0, 0, 0.7071068]),
        ([0, 4.0, 12.0], [-0.7071068, 0, 0, 0.7071068]),
        ([-20.0, 4.0, 0], [0.5, 0.5, 0.5, 0.5]),
        ([20.0, 4.0, 0], [-0.5, -0.5, 0.5, 0.5]),
    ]):
        pos, nrm, uv, idx = _grid_np(
            wx if i < 2 else sc(80, lo=8), wyn,
            20.0 if i < 2 else 12.0, 4.0, 0.12, seed=10 + i,
        )
        add_mesh(pos, nrm, uv, idx, add_mat(tex=1 + i, nm=True), f"wall{i}",
                 translation=t, rotation=rot)

    # colonnade: 24 columns, DISTINCT texture each (atlas diversity at scale)
    cseg, crow = sc(32, lo=6), sc(24, lo=4)
    for i in range(24):
        pos, nrm, uv, idx = _cylinder_np(cseg, crow, 0.45, 6.5)
        cx = -15.0 + (i % 12) * 2.7
        cz = -8.0 if i < 12 else 8.0
        add_mesh(pos, nrm, uv, idx,
                 add_mat(tex=5 + i, nm=(i % 3 == 0), mr=(i % 4 == 0)),
                 f"col{i}", translation=[cx, 0.0, cz])

    # rocks / clutter: displaced grids at random poses, cycling textures
    rocks = sc(40, lo=3)
    rg = sc(40, lo=4)
    for i in range(rocks):
        pos, nrm, uv, idx = _grid_np(rg, rg, 1.0, 1.0, 0.55, seed=100 + i)
        t = [float(rng.uniform(-17, 17)), float(rng.uniform(0.0, 0.3)),
             float(rng.uniform(-10, 10))]
        ang = float(rng.uniform(0, np.pi))
        rot = [0.0, float(np.sin(ang / 2)), 0.0, float(np.cos(ang / 2))]
        s = [float(rng.uniform(0.6, 1.8))] * 3
        add_mesh(pos, nrm, uv, idx, add_mat(tex=29 + (i % 7)), f"rock{i}",
                 translation=t, rotation=rot, m_scale=s)

    # foliage: alpha-masked leaf quads scattered through the atrium
    leaf_mat = add_mat(tex=leaf_tex, mask=True)
    pos, nrm, tan, uv, idx = _quad(0.5, 0.5)
    insts = []
    for i in range(sc(300, lo=8)):
        t = [float(rng.uniform(-16, 16)), float(rng.uniform(0.5, 5.0)),
             float(rng.uniform(-9, 9))]
        ang = float(rng.uniform(0, np.pi))
        insts.append((t, [float(np.sin(ang / 2)) * 0.7071, 0.0, 0.0,
                          float(np.cos(ang / 2)) * 0.7071 + 0.2929], None))
    a = {
        "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
        "NORMAL": w.add_accessor(nrm, "VEC3", F32),
        "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
    }
    a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
    meshes.append({"primitives": [
        {"attributes": a, "indices": a_idx, "material": leaf_mat}
    ]})
    mesh_id = len(meshes) - 1
    for k, (t, rot, _) in enumerate(insts):
        nodes.append({"mesh": mesh_id, "translation": t, "rotation": rot,
                      "name": f"leaf{k}"})
        truth["prims"] += 1

    # a couple of factor-only accents
    posb, nrmb, tanb, uvb, idxb = _box(0.8, 0.4, 0.8)
    add_mesh(posb, nrmb, uvb, idxb,
             add_mat(factor=[0.85, 0.3, 0.15, 1.0]), "crate",
             translation=[3.0, 0.45, 2.0])

    nodes.append({"camera": 0, "translation": [0.0, 3.0, 10.5], "name": "cam"})
    nodes.append({
        "extensions": {"KHR_lights_punctual": {"light": 0}},
        "rotation": [-0.3826834, 0, 0, 0.9238795],
        "name": "sun",
    })

    doc = {
        "asset": {"version": "2.0",
                  "generator": "vulkanhybridrenderer_tpu bench asset"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "cameras": [{
            "type": "perspective",
            "perspective": {"yfov": 1.0, "znear": 0.1, "aspectRatio": 1.777},
        }],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.97, 0.9],
             "intensity": 3.0}
        ]}},
        "materials": materials,
        "textures": [{"source": i} for i in range(len(images))],
        "images": [
            {"bufferView": v, "mimeType": "image/png"} for v in image_views
        ],
        "bufferViews": w.views,
        "accessors": w.accessors,
    }

    w.write(path, doc)
    return truth


def build_texture_board_glb(path, images: list[bytes]) -> None:
    """Write a GLB that shows each JPEG image (its bytes embedded as they
    are) as the base colour of one upright quad, in a row above a floor,
    with a camera facing the row and a directional light."""
    w = _GlbWriter()
    n = len(images)
    image_views = [w.add_view(bytes(im)) for im in images]
    meshes, nodes, materials = [], [], []

    def add_quad(sx, sz, material, translation, rotation=None):
        pos, nrm, tan, uv, idx = _quad(sx, sz)
        a = {
            "POSITION": w.add_accessor(pos, "VEC3", F32, minmax=True),
            "NORMAL": w.add_accessor(nrm, "VEC3", F32),
            "TANGENT": w.add_accessor(tan, "VEC4", F32),
            "TEXCOORD_0": w.add_accessor(uv, "VEC2", F32),
        }
        a_idx = w.add_accessor(idx.reshape(-1, 1), "SCALAR", U16)
        meshes.append({"primitives": [{"attributes": a, "indices": a_idx,
                                       "material": material}]})
        node = {"mesh": len(meshes) - 1, "translation": translation}
        if rotation is not None:
            node["rotation"] = rotation
        nodes.append(node)

    materials.append({"pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.7, 0.72, 1.0],
                                               "roughnessFactor": 0.9}})
    add_quad(1.2 * n + 1.0, 3.0, 0, [0.0, 0.0, 0.0])
    for i in range(n):
        materials.append({"pbrMetallicRoughness": {"baseColorTexture": {"index": i}}})
        # stood up to face +z: a quarter turn about x
        add_quad(0.5, 0.5, i + 1, [1.2 * (i - (n - 1) / 2), 0.6, 0.0],
                 rotation=[0.7071068, 0.0, 0.0, 0.7071068])
    nodes.append({"camera": 0, "translation": [0.0, 0.8, 0.6 * n + 2.5], "name": "cam"})
    nodes.append({"extensions": {"KHR_lights_punctual": {"light": 0}},
                  "rotation": [-0.3826834, 0, 0, 0.9238795], "name": "sun"})
    doc = {
        "asset": {"version": "2.0", "generator": "vulkanhybridrenderer_tpu texture board"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": meshes,
        "cameras": [{"type": "perspective",
                     "perspective": {"yfov": 0.9, "znear": 0.1, "aspectRatio": 1.777}}],
        "extensionsUsed": ["KHR_lights_punctual"],
        "extensions": {"KHR_lights_punctual": {"lights": [
            {"type": "directional", "color": [1.0, 0.97, 0.9], "intensity": 3.0}]}},
        "materials": materials,
        "textures": [{"source": i} for i in range(n)],
        "images": [{"bufferView": v, "mimeType": "image/jpeg"} for v in image_views],
        "bufferViews": w.views,
        "accessors": w.accessors,
    }
    w.write(path, doc)
