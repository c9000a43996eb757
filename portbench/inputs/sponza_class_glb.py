"""Frozen copy of the port's ``scene/sample_asset.build_sponza_class_glb``:
the flagship asset ("realglb"), a Sponza-class GLB of 254,636 triangles,
370 primitives and 39 PNG textures at scale 1, written from scratch with
numpy, struct and json.  The benchmark writes it and hands the same file
to the port's and to the reference's loader.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes: 8-bit RGB or RGBA, every row
    filter 0, one zlib stream at level 6."""
    img = np.asarray(img)
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


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


def make(params: dict, workdir) -> dict:
    """Write the asset at ``params["scale"]`` into `workdir`; {"glb": its path}."""
    from pathlib import Path

    path = Path(workdir) / "realglb.glb"
    build_sponza_class_glb(path, scale=float(params.get("scale", 1.0)))
    return {"glb": str(path)}
