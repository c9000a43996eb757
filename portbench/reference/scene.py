"""The reference's scene: what a frame reads, built from the benchmark's
inputs alone (a GLB file, or the host arrays of a generated scene).

The semantics are the renderer's scene loader, as the JAX package's
``scene/gltf.py`` states them (read, not imported): node transforms
composed parent first, translation then rotation then scale; a normal
matrix the inverse transpose of the model's 3x3; textures numbered in the
order of their glTF index, base-colour ones sRGB-decoded, the rest linear;
a textured material's base colour factor replaced by ones; absent
attributes zero (no tangents are generated); a MASK material's cutoff 0.5
unless given; the camera's yaw and pitch taken Y-X-Z from its node; a
directional light along its node's -Z, at intensity 30.

Textures stay one image each (``Textures``): a sample wraps inside its own
image, where the program packs an atlas.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import torch


# --------------------------------------------------------------- matrices ---
def yaw_pitch_roll(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """R = Ry(yaw) Rx(pitch) Rz(roll) as a 4x4 float32 matrix."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float32)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = ry @ rx @ rz
    return m


def perspective(yfov: float, aspect: float, znear: float) -> np.ndarray:
    """Infinite reverse-Z perspective with the y flip baked in: depth is
    znear / -z_view, 1 at the near plane and 0 at infinity."""
    s = 1.0 / np.tan(yfov * 0.5)
    return np.array([[s / aspect, 0, 0, 0], [0, -s, 0, 0], [0, 0, 0, znear], [0, 0, -1, 0]],
                    np.float32)


def light_projview(direction: np.ndarray) -> np.ndarray:
    """The sun's shadow projection times view: an orthographic box of
    +-8 units, near 12 and far 0.1 (so depth grows toward the light), seen
    from 12 units up the light from the origin with +Y up."""
    l, r, b, t, n, f = -8.0, 8.0, -8.0, 8.0, 12.0, 0.1
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 2.0 / (r - l)
    proj[1, 1] = 2.0 / (t - b)
    proj[2, 2] = -1.0 / (f - n)
    proj[0, 3] = -(r + l) / (r - l)
    proj[1, 3] = -(t + b) / (t - b)
    proj[2, 3] = -n / (f - n)
    proj[3, 3] = 1.0
    proj[1] = -proj[1]
    eye = (-direction * 12.0).astype(np.float32)
    fwd = -eye / np.linalg.norm(eye)
    side = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    side = side / np.linalg.norm(side)
    up = np.cross(side, fwd)
    view = np.eye(4, dtype=np.float32)
    view[0, :3], view[1, :3], view[2, :3] = side, up, -fwd
    view[0, 3], view[1, 3], view[2, 3] = -side @ eye, -up @ eye, fwd @ eye
    return (proj @ view).astype(np.float32)


def quat_matrix(q) -> np.ndarray:
    """3x3 rotation of a glTF quaternion (x, y, z, w)."""
    x, y, z, w = (float(c) for c in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def euler_yxz(m: np.ndarray) -> tuple:
    """(yaw, pitch, roll) with yaw_pitch_roll(...) = m's rotation."""
    r = np.asarray(m, np.float64)[:3, :3]
    r = r / np.linalg.norm(r, axis=0, keepdims=True)
    pitch = np.arcsin(np.clip(-r[1, 2], -1.0, 1.0))
    if abs(np.cos(pitch)) > 1e-6:
        return float(np.arctan2(r[0, 2], r[2, 2])), float(pitch), float(np.arctan2(r[1, 0], r[1, 1]))
    return float(np.arctan2(-r[2, 0], r[0, 0])), float(pitch), 0.0


@dataclasses.dataclass
class Camera:
    yfov: float
    znear: float
    aspect: float
    position: np.ndarray
    yaw: float
    pitch: float
    roll: float = 0.0

    def view(self, position=None, yaw=None, pitch=None) -> np.ndarray:
        """The view matrix at a pose (the camera's own where not given)."""
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = np.asarray(self.position if position is None else position, np.float32)
        m = t @ yaw_pitch_roll(self.yaw if yaw is None else yaw,
                               self.pitch if pitch is None else pitch, self.roll)
        return np.linalg.inv(m).astype(np.float32)


@dataclasses.dataclass
class Light:
    direction: np.ndarray  # (3,) unit, the way the light travels
    color: np.ndarray  # (3,)
    intensity: float

    @property
    def projview(self) -> np.ndarray:
        return light_projview(self.direction)


# ---------------------------------------------------------------- textures ---
def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)


@dataclasses.dataclass
class Textures:
    """Every texture's RGBA texels, linear, in one (N, 4) array: texture k's
    row-major image from texel ``offset[k]``, ``width[k]`` by ``height[k]``."""

    texels: torch.Tensor
    offset: torch.Tensor  # (K,) int64
    width: torch.Tensor  # (K,) float32
    height: torch.Tensor

    @classmethod
    def build(cls, images: list, srgb: list) -> "Textures":
        rows, offs, ws, hs, at = [], [], [], [], 0
        for im, is_srgb in zip(images, srgb):
            im = np.asarray(im)
            if im.ndim == 2:
                im = np.repeat(im[..., None], 4, axis=-1)
            if im.shape[-1] == 3:
                im = np.concatenate([im, np.full(im.shape[:2] + (1,), 255, im.dtype)], axis=-1)
            f = im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im.astype(np.float32)
            if is_srgb:
                f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
            h, w = f.shape[:2]
            rows.append(f.reshape(h * w, 4))
            offs.append(at)
            ws.append(w)
            hs.append(h)
            at += h * w
        if not rows:
            rows, offs, ws, hs = [np.ones((1, 4), np.float32)], [0], [1], [1]
        return cls(torch.from_numpy(np.concatenate(rows)), torch.tensor(offs, dtype=torch.int64),
                   torch.tensor(ws, dtype=torch.float32), torch.tensor(hs, dtype=torch.float32))

    def to(self, device) -> "Textures":
        return Textures(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


# ------------------------------------------------------------------- scene ---
@dataclasses.dataclass
class RefScene:
    """Object-space vertices, triangles with global vertex ids and their
    primitive, one row of transform and material a primitive, textures,
    camera and light."""

    positions: torch.Tensor  # (V, 3)
    normals: torch.Tensor  # (V, 3)
    tangents: torch.Tensor  # (V, 4)
    uv0: torch.Tensor  # (V, 2)
    tri_vertex: torch.Tensor  # (T, 3) int64
    tri_prim: torch.Tensor  # (T,) int64
    transform: torch.Tensor  # (P, 4, 4)
    normal_mat: torch.Tensor  # (P, 3, 3)
    base_color: torch.Tensor  # (P, 4)
    base_tex: torch.Tensor  # (P,) int64, -1 none
    normal_tex: torch.Tensor
    mr_tex: torch.Tensor
    metallic: torch.Tensor  # (P,)
    roughness: torch.Tensor
    alpha_mask: torch.Tensor  # (P,) bool
    alpha_cutoff: torch.Tensor
    textures: Textures
    camera: Camera
    light: Light

    def to(self, device) -> "RefScene":
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to(device) if isinstance(v, (torch.Tensor, Textures)) else v
        return RefScene(**out)


def from_arrays(positions, normals, tangents, uv0, indices, prims: list, images: list,
                srgb: list, camera: Camera, light: Light) -> RefScene:
    """A scene from host arrays: `prims` are dicts with transform,
    vertex_offset, index_offset, index_count and the material entries
    (absent: base colour ones, no textures, metallic and roughness 1,
    opaque)."""
    tv, tp = [], []
    indices = np.asarray(indices, np.int64)
    for p, d in enumerate(prims):
        idx = indices[d["index_offset"]:d["index_offset"] + d["index_count"]].reshape(-1, 3)
        tv.append(idx + d["vertex_offset"])
        tp.append(np.full(len(idx), p, np.int64))
    xf = np.stack([np.asarray(d["transform"], np.float32) for d in prims])
    nm = np.stack([np.linalg.inv(np.asarray(m, np.float64)[:3, :3]).T for m in xf]).astype(np.float32)

    def col(name, default, dtype=np.float32):
        return torch.from_numpy(np.asarray([d.get(name, default) for d in prims], dtype))

    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return RefScene(
        positions=f32(positions), normals=f32(normals), tangents=f32(tangents), uv0=f32(uv0),
        tri_vertex=torch.from_numpy(np.concatenate(tv)), tri_prim=torch.from_numpy(np.concatenate(tp)),
        transform=f32(xf), normal_mat=f32(nm),
        base_color=f32(np.stack([np.asarray(d.get("base_color", (1, 1, 1, 1)), np.float32)
                                 for d in prims])),
        base_tex=col("base_color_texture", -1, np.int64), normal_tex=col("normal_map", -1, np.int64),
        mr_tex=col("metallic_roughness_texture", -1, np.int64),
        metallic=col("metallic_factor", 1.0), roughness=col("roughness_factor", 1.0),
        alpha_mask=col("alpha_mask", 0, np.int64) == 1, alpha_cutoff=col("alpha_cutoff", 0.0),
        textures=Textures.build(images, srgb), camera=camera, light=light)


def sun(direction, color=(1.0, 1.0, 1.0), intensity: float = 30.0) -> Light:
    d = np.asarray(direction, np.float32)
    return Light(direction=(d / np.linalg.norm(d)).astype(np.float32),
                 color=np.asarray(color, np.float32)[:3], intensity=float(intensity))


# ---------------------------------------------------------------------- PNG ---
def decode_png(blob: bytes) -> np.ndarray:
    """8-bit greyscale, grey-alpha, RGB or RGBA PNG (no interlace) -> (H, W, 4) uint8."""
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in (0, 2, 4, 6):
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {ctype}, interlace {interlace}")
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    out = np.zeros((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        elif f == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 255
        else:
            cur = np.zeros_like(line)
            for x in range(w * bpp):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if f == 3:
                    cur[x] = (line[x] + (a + b) // 2) & 255
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[x] = (line[x] + pred) & 255
        out[y] = cur
        prev = cur
    px = out.reshape(h, w, bpp)
    if ctype == 0:
        return np.concatenate([np.repeat(px, 3, axis=-1), np.full((h, w, 1), 255, np.uint8)], -1)
    if ctype == 4:
        return np.concatenate([np.repeat(px[..., :1], 3, axis=-1), px[..., 1:]], -1)
    if ctype == 2:
        return np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
    return px


# ---------------------------------------------------------------------- GLB ---
_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16, 5125: np.uint32,
           5126: np.float32}
_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def load_glb(path) -> RefScene:
    """A binary glTF file (one embedded buffer, PNG images) as a RefScene."""
    raw = Path(path).read_bytes()
    _, _, length = struct.unpack_from("<III", raw, 0)
    pos, doc, binary = 12, None, b""
    while pos < length:
        n, kind = struct.unpack_from("<II", raw, pos)
        chunk = raw[pos + 8:pos + 8 + n]
        if kind == 0x4E4F534A:
            doc = json.loads(chunk)
        elif kind == 0x004E4942:
            binary = chunk
        pos += 8 + n

    def view_bytes(i):
        v = doc["bufferViews"][i]
        return binary[v.get("byteOffset", 0):v.get("byteOffset", 0) + v["byteLength"]]

    def accessor(i):
        a = doc["accessors"][i]
        dt, k = np.dtype(_DTYPES[a["componentType"]]), _COUNTS[a["type"]]
        v = doc["bufferViews"][a["bufferView"]]
        base = v.get("byteOffset", 0) + a.get("byteOffset", 0)
        stride = v.get("byteStride") or dt.itemsize * k
        rows = np.frombuffer(binary, np.uint8, a["count"] * stride, offset=base).reshape(-1, stride)
        out = np.ascontiguousarray(rows[:, :dt.itemsize * k]).view(dt).reshape(a["count"], k)
        if a.get("normalized"):
            out = out.astype(np.float32) / float(np.iinfo(dt).max)
        return out

    nodes = doc.get("nodes", [])
    parent = {c: i for i, n in enumerate(nodes) for c in n.get("children", [])}

    def local(n):
        if "matrix" in n:
            return np.asarray(n["matrix"], np.float32).reshape(4, 4).T
        t, r, s = np.eye(4), np.eye(4), np.eye(4)
        t[:3, 3] = n.get("translation", (0, 0, 0))
        if "rotation" in n:
            r[:3, :3] = quat_matrix(n["rotation"])
        s[0, 0], s[1, 1], s[2, 2] = n.get("scale", (1, 1, 1))
        return (t @ r @ s).astype(np.float32)

    def world(i):
        m = local(nodes[i])
        return world(parent[i]) @ m if i in parent else m

    materials = doc.get("materials", [])
    srgb_of = {}
    for m in materials:
        pbr = m.get("pbrMetallicRoughness", {})
        for key, owner, is_srgb in (("baseColorTexture", pbr, True),
                                    ("metallicRoughnessTexture", pbr, False),
                                    ("normalTexture", m, False)):
            if key in owner:
                srgb_of.setdefault(owner[key]["index"], is_srgb)
    order = sorted(srgb_of)
    slot = {t: k for k, t in enumerate(order)}
    images = [decode_png(view_bytes(doc["images"][doc["textures"][t]["source"]]["bufferView"]))
              for t in order]

    lights = doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    camera, light = None, None
    P, N, TG, UV, IDX, prims = [], [], [], [], [], []
    nv = ni = 0
    for i, node in enumerate(nodes):
        m = world(i)
        if "camera" in node:
            c = doc["cameras"][node["camera"]]
            if c.get("type") == "perspective":
                p = c["perspective"]
                yaw, pitch, roll = euler_yxz(m)
                camera = Camera(yfov=p["yfov"], znear=p.get("znear", 0.1),
                                aspect=p.get("aspectRatio", 16 / 9), position=m[:3, 3].copy(),
                                yaw=yaw, pitch=pitch, roll=roll)
            continue
        li = node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        if li is not None and lights and lights[li]["type"] == "directional":
            r = np.asarray(m, np.float64)[:3, :3]
            r = r / np.linalg.norm(r, axis=0, keepdims=True)
            light = sun(r @ np.array([0.0, 0.0, -1.0]), lights[li].get("color", (1, 1, 1)), 30.0)
            continue
        if "mesh" not in node:
            continue
        for prim in doc["meshes"][node["mesh"]]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue
            at = prim["attributes"]
            pos = accessor(at["POSITION"]).astype(np.float32)
            nvx = len(pos)
            get = lambda key, k: (accessor(at[key]).astype(np.float32) if key in at
                                  else np.zeros((nvx, k), np.float32))
            idx = accessor(prim["indices"]).reshape(-1).astype(np.int64)
            mat = materials[prim["material"]] if "material" in prim else {}
            pbr = mat.get("pbrMetallicRoughness", {})
            tex = lambda entry: slot.get(entry.get("index"), -1) if entry else -1
            base = tex(pbr.get("baseColorTexture"))
            mask = mat.get("alphaMode") == "MASK"
            prims.append(dict(
                transform=m, vertex_offset=nv, index_offset=ni, index_count=len(idx),
                base_color=(np.asarray(pbr.get("baseColorFactor", (1, 1, 1, 1)), np.float32)
                            if base < 0 else np.ones(4, np.float32)),
                base_color_texture=base,
                metallic_roughness_texture=tex(pbr.get("metallicRoughnessTexture")),
                normal_map=tex(mat.get("normalTexture")),
                metallic_factor=pbr.get("metallicFactor", 1.0),
                roughness_factor=pbr.get("roughnessFactor", 1.0),
                alpha_mask=1 if mask else 0,
                alpha_cutoff=mat.get("alphaCutoff", 0.5) if mask else 0.0))
            P.append(pos)
            N.append(get("NORMAL", 3))
            TG.append(get("TANGENT", 4))
            UV.append(get("TEXCOORD_0", 2))
            IDX.append(idx)
            nv += nvx
            ni += len(idx)
    if light is None:
        raise ValueError("the reference takes scenes with a directional light")
    if camera is None:
        camera = Camera(yfov=np.deg2rad(60.0), znear=0.1, aspect=16 / 9,
                        position=np.array([0.0, 1.0, 3.0], np.float32), yaw=0.0, pitch=0.0)
    return from_arrays(np.concatenate(P), np.concatenate(N), np.concatenate(TG), np.concatenate(UV),
                       np.concatenate(IDX), prims, images, [srgb_of[t] for t in order],
                       camera, light)
