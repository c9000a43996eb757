"""glTF 2.0 / GLB scene loader and host scene assembly (port of
``scene/gltf.py``).

A reader of the glTF subset the reference consumes through cgltf
(scene_loader.cpp:30-350): triangle meshes with POSITION / NORMAL / TANGENT /
TEXCOORD_0 / TEXCOORD_1, indexed geometry (interleaved, sparse and normalized
accessors too), PBR metallic-roughness materials (base color, metallic-
roughness and normal textures, MASK alpha mode), perspective cameras and
KHR_lights_punctual directional lights.  Embedded and external images are
decoded by ``utils/png`` or ``utils/jpeg``, chosen by the file's signature
as PIL chooses (not by the URI or mime type).  Camera, light and
SceneBuffers construction is shared with the procedural scenes.  Arrays stay
numpy until the renderer uploads the scene with one
``Scene.buffers.to(device)``.

Parity notes (as the reference package):
  * camera -> infinite reverse-Z projection from yfov / aspect / znear,
    yaw / pitch / roll extracted YXZ for the fly camera;
  * directional light -> ortho(-8..8, 12, 0.1) projview, direction =
    rot * (0, 0, -1), lookAt(-dir * 12, 0, +Y); intensity 2 for Pica.glb,
    else 30; a zero-intensity fallback light when the scene has none;
  * base-color textures are sRGB, the others linear.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import struct
from pathlib import Path

import numpy as np

from vulkanhybridrenderer_tpu_torch.core.types import (
    DirectionalLight,
    MaterialsSoA,
    SceneBuffers,
)
from vulkanhybridrenderer_tpu_torch.scene.atlas import build_atlas
from vulkanhybridrenderer_tpu_torch.utils import math3d as m3
from vulkanhybridrenderer_tpu_torch.utils.jpeg import decode_jpeg
from vulkanhybridrenderer_tpu_torch.utils.png import decode_png


@dataclasses.dataclass
class Camera:
    """Host-side camera (reference Scene::camera)."""

    yfov: float = np.deg2rad(60.0)
    znear: float = 0.1
    aspect: float = 16.0 / 9.0
    yaw: float = 0.0
    pitch: float = 0.0
    roll: float = 0.0
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32)
    )

    def transform(self) -> np.ndarray:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = self.position
        return t @ m3.yaw_pitch_roll(self.yaw, self.pitch, self.roll)

    def view(self) -> np.ndarray:
        return np.linalg.inv(self.transform()).astype(np.float32)

    def projection(self, aspect: float | None = None) -> np.ndarray:
        return m3.infinite_reverse_z_projection(
            self.yfov, self.aspect if aspect is None else aspect, self.znear
        )


@dataclasses.dataclass
class Scene:
    """Host-side scene: buffers + camera + light + name."""

    name: str
    buffers: SceneBuffers
    camera: Camera
    light: DirectionalLight


def make_directional_light(
    direction, color=(1.0, 1.0, 1.0), intensity=30.0
) -> DirectionalLight:
    """scene_loader.cpp:84-99."""
    direction = np.asarray(direction, np.float32)
    direction = direction / np.linalg.norm(direction)
    light_perspective = m3.ortho(-8.0, 8.0, -8.0, 8.0, 12.0, 0.1)
    light_view = m3.look_at(-direction * 12.0, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    return DirectionalLight(
        projview=(light_perspective @ light_view).astype(np.float32),
        direction=np.append(direction, 0.0).astype(np.float32),
        color=np.append(np.asarray(color, np.float32), 1.0).astype(np.float32),
        intensity=np.full((4,), float(intensity), np.float32),
    )


def fallback_directional_light() -> DirectionalLight:
    """scene_loader.cpp:322-329: present but zero-intensity."""
    return DirectionalLight(
        projview=np.eye(4, dtype=np.float32),
        direction=np.array([0.0, -1.0, 0.01, 0.0], np.float32),
        color=np.array([1.0, 1.0, 1.0, 0.0], np.float32),
        intensity=np.zeros(4, np.float32),
    )


def build_scene_buffers(
    positions: np.ndarray,
    normals: np.ndarray,
    tangents: np.ndarray,
    uv0: np.ndarray,
    uv1: np.ndarray,
    indices: np.ndarray,
    primitives: list[dict],
    images: list[np.ndarray] | None = None,
    srgb: list[bool] | None = None,
) -> SceneBuffers:
    """Assemble host SceneBuffers.  primitives: dicts with transform (4, 4),
    vertex_offset, index_offset, index_count and the material fields
    (glsl_common.h:94-99)."""
    num_prims = len(primitives)
    prim_transform = np.stack(
        [np.asarray(p["transform"], np.float32) for p in primitives]
    )
    prim_normal = np.stack([m3.normal_matrix(t) for t in prim_transform])

    def field(name, default):
        return np.asarray([p.get(name, default) for p in primitives], np.float32)

    def ifield(name, default):
        return np.asarray([p.get(name, default) for p in primitives], np.int32)

    materials = MaterialsSoA(
        base_color=(
            np.stack(
                [np.asarray(p.get("base_color", (1, 1, 1, 1)), np.float32)
                 for p in primitives]
            )
            if num_prims
            else np.zeros((0, 4), np.float32)
        ),
        base_color_texture=ifield("base_color_texture", -1),
        metallic_roughness_texture=ifield("metallic_roughness_texture", -1),
        normal_map=ifield("normal_map", -1),
        metallic_factor=field("metallic_factor", 1.0),
        roughness_factor=field("roughness_factor", 1.0),
        alpha_mask=ifield("alpha_mask", 0),
        alpha_cutoff=field("alpha_cutoff", 0.0),
    )

    vtx_off = ifield("vertex_offset", 0)
    idx_off = ifield("index_offset", 0)
    idx_cnt = ifield("index_count", 0)

    # flatten to the global triangle list the rasterizer and BVH consume
    indices = np.asarray(indices, np.int32)
    tri_vertex, tri_prim = [], []
    for p in range(num_prims):
        idx = indices[idx_off[p] : idx_off[p] + idx_cnt[p]].reshape(-1, 3)
        tri_vertex.append(idx + vtx_off[p])
        tri_prim.append(np.full(len(idx), p, np.int32))
    tri_vertex = (
        np.concatenate(tri_vertex) if tri_vertex else np.zeros((0, 3), np.int32)
    )
    tri_prim = np.concatenate(tri_prim) if tri_prim else np.zeros((0,), np.int32)

    tri_masked = (
        materials.alpha_mask[tri_prim] == 1 if len(tri_prim) else np.zeros(0, bool)
    )
    alpha_tri_idx = np.nonzero(tri_masked)[0].astype(np.int32)

    return SceneBuffers(
        positions=np.asarray(positions, np.float32),
        normals=np.asarray(normals, np.float32),
        tangents=np.asarray(tangents, np.float32),
        uv0=np.asarray(uv0, np.float32),
        uv1=np.asarray(uv1, np.float32),
        indices=indices,
        prim_vertex_offset=vtx_off,
        prim_index_offset=idx_off,
        prim_index_count=idx_cnt,
        tri_vertex=tri_vertex.astype(np.int32),
        tri_prim=tri_prim,
        prim_transform=prim_transform,
        prim_normal_mat=prim_normal,
        materials=materials,
        atlas=build_atlas(images or [], srgb),
        alpha_tri_idx=alpha_tri_idx,
        has_alpha_mask=bool(alpha_tri_idx.size),
        has_normal_maps=bool((materials.normal_map >= 0).any()),
        has_mr_textures=bool((materials.metallic_roughness_texture >= 0).any()),
    )


# ---------------------------------------------------------------------------
# glTF parsing
# ---------------------------------------------------------------------------
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class _Gltf:
    """One .glb or .gltf file: its JSON document and its buffers (the GLB's
    BIN chunk, data URIs, or files beside it)."""

    def __init__(self, path: Path):
        self.path = path
        raw = path.read_bytes()
        if raw[:4] == b"glTF":
            _, _, length = struct.unpack_from("<III", raw, 0)
            offset = 12
            self.json = None
            self.bin = None
            while offset < length:
                chunk_len, chunk_type = struct.unpack_from("<II", raw, offset)
                chunk = raw[offset + 8 : offset + 8 + chunk_len]
                if chunk_type == 0x4E4F534A:  # JSON
                    self.json = json.loads(chunk)
                elif chunk_type == 0x004E4942:  # BIN
                    self.bin = chunk
                offset += 8 + chunk_len
        else:
            self.json = json.loads(raw)
            self.bin = None
        self.buffers = [self._load_buffer(b) for b in self.json.get("buffers", [])]

    def _load_buffer(self, buf: dict) -> bytes:
        uri = buf.get("uri")
        if uri is None:
            return self.bin
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        return (self.path.parent / uri).read_bytes()

    def buffer_view_bytes(self, view_idx: int) -> bytes:
        view = self.json["bufferViews"][view_idx]
        data = self.buffers[view["buffer"]]
        off = view.get("byteOffset", 0)
        return data[off : off + view["byteLength"]]

    def accessor(self, idx: int) -> np.ndarray:
        """Accessor `idx` as a writable (count, components) array."""
        acc = self.json["accessors"][idx]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            out = np.zeros((count, ncomp), dtype)
        else:
            view = self.json["bufferViews"][acc["bufferView"]]
            data = self.buffers[view["buffer"]]
            base = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = view.get("byteStride") or (np.dtype(dtype).itemsize * ncomp)
            if stride == np.dtype(dtype).itemsize * ncomp:
                out = np.frombuffer(data, dtype, count * ncomp, offset=base).reshape(
                    count, ncomp)
            else:  # interleaved: byteStride rows, this accessor's columns
                rows = np.frombuffer(data, np.uint8, count * stride, offset=base).reshape(
                    count, stride)
                out = rows[:, : np.dtype(dtype).itemsize * ncomp].copy().view(dtype)
        sparse = acc.get("sparse")
        if sparse:
            # substitute `count` rows of `values` at positions `indices`, both
            # tightly packed in their own views (scene_loader.cpp:334-349)
            n = sparse["count"]
            isec = sparse["indices"]
            idt = _COMPONENT_DTYPES[isec["componentType"]]
            iview = self.json["bufferViews"][isec["bufferView"]]
            ibase = iview.get("byteOffset", 0) + isec.get("byteOffset", 0)
            sidx = np.frombuffer(self.buffers[iview["buffer"]], idt, n,
                                 offset=ibase).astype(np.int64)
            vsec = sparse["values"]
            vview = self.json["bufferViews"][vsec["bufferView"]]
            vbase = vview.get("byteOffset", 0) + vsec.get("byteOffset", 0)
            vals = np.frombuffer(self.buffers[vview["buffer"]], dtype, n * ncomp,
                                 offset=vbase).reshape(n, ncomp)
            out = np.array(out)
            out[sidx] = vals
        if acc.get("normalized"):
            out = out.astype(np.float32) / float(np.iinfo(dtype).max)
        return np.array(out)  # np.frombuffer's views are read-only

    def image_pixels(self, image_idx: int) -> np.ndarray:
        """Image `image_idx` as (H, W, 4) uint8 RGBA (stbi_load,
        scene_loader.cpp:283-291)."""
        img = self.json["images"][image_idx]
        if "uri" in img and not img["uri"].startswith("data:"):
            blob = (self.path.parent / img["uri"]).read_bytes()
        elif "uri" in img:
            blob = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            blob = self.buffer_view_bytes(img["bufferView"])
        return decode_jpeg(blob) if blob[:3] == b"\xff\xd8\xff" else decode_png(blob)


def _node_world_transforms(doc: dict) -> list[np.ndarray]:
    nodes = doc.get("nodes", [])
    parents = {}
    for i, n in enumerate(nodes):
        for c in n.get("children", []):
            parents[c] = i

    def local(n):
        if "matrix" in n:
            return np.asarray(n["matrix"], np.float32).reshape(4, 4).T  # column-major
        t = np.eye(4, dtype=np.float32)
        if "translation" in n:
            tt = np.eye(4, dtype=np.float32)
            tt[:3, 3] = n["translation"]
            t = t @ tt
        if "rotation" in n:
            x, y, z, w = n["rotation"]
            r = np.eye(4, dtype=np.float32)
            q = np.array([w, x, y, z])
            r[:3, :3] = np.stack(
                [
                    m3.quat_rotate(q, np.array([1.0, 0, 0])),
                    m3.quat_rotate(q, np.array([0, 1.0, 0])),
                    m3.quat_rotate(q, np.array([0, 0, 1.0])),
                ],
                axis=1,
            )
            t = t @ r
        if "scale" in n:
            s = np.eye(4, dtype=np.float32)
            s[0, 0], s[1, 1], s[2, 2] = n["scale"]
            t = t @ s
        return t

    memo: dict[int, np.ndarray] = {}

    def world(i):
        if i in memo:
            return memo[i]
        m = local(nodes[i])
        if i in parents:
            m = world(parents[i]) @ m
        memo[i] = m
        return m

    return [world(i) for i in range(len(nodes))]


def load_scene(path: str | Path) -> Scene:
    """Load a .gltf / .glb file into a host Scene (the reference's
    SceneLoader::LoadScene)."""
    path = Path(path)
    g = _Gltf(path)
    doc = g.json
    name = path.name

    # textures: classify sRGB (base color) against linear, dedupe
    materials = doc.get("materials", [])
    tex_format_srgb: dict[int, bool] = {}
    for mat in materials:
        pbr = mat.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr:
            tex_format_srgb.setdefault(pbr["baseColorTexture"]["index"], True)
        if "metallicRoughnessTexture" in pbr:
            tex_format_srgb.setdefault(pbr["metallicRoughnessTexture"]["index"], False)
        if "normalTexture" in mat:
            tex_format_srgb.setdefault(mat["normalTexture"]["index"], False)
    tex_ids = sorted(tex_format_srgb)
    tex_slot = {t: i for i, t in enumerate(tex_ids)}
    textures = doc.get("textures", [])
    images = [g.image_pixels(textures[t]["source"]) for t in tex_ids]
    srgb_flags = [tex_format_srgb[t] for t in tex_ids]

    def slot(tex_index):
        return tex_slot.get(tex_index, -1) if tex_index is not None else -1

    world = _node_world_transforms(doc)
    positions, normals, tangents, uv0s, uv1s, indices = [], [], [], [], [], []
    prims: list[dict] = []
    v_total = i_total = 0
    camera = light = None
    ext_lights = doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])

    def attr(attrs, key, vcount, width):
        if key not in attrs:
            return np.zeros((vcount, width), np.float32)
        return g.accessor(attrs[key]).astype(np.float32)

    for ni, node in enumerate(doc.get("nodes", [])):
        xform = world[ni]
        if "camera" in node:
            cam = doc["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                p = cam["perspective"]
                yaw, pitch, roll = m3.extract_euler_yxz(xform)
                camera = Camera(
                    yfov=p["yfov"], znear=p.get("znear", 0.1),
                    aspect=p.get("aspectRatio", 16.0 / 9.0), yaw=yaw, pitch=pitch,
                    roll=roll, position=np.asarray(xform[:3, 3], np.float32),
                )
            continue
        nl = node.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        if nl is not None and ext_lights and ext_lights[nl]["type"] == "directional":
            q = m3.decompose_rotation(xform)
            direction = m3.quat_rotate(q, np.array([0.0, 0.0, -1.0]))
            light = make_directional_light(
                direction, color=ext_lights[nl].get("color", [1.0, 1.0, 1.0]),
                intensity=2.0 if name == "Pica.glb" else 30.0,
            )
            continue
        if "mesh" not in node:
            continue
        for prim in doc["meshes"][node["mesh"]].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only, like the reference
                continue
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            vcount = len(pos)
            idx = g.accessor(prim["indices"]).reshape(-1).astype(np.int32)
            mat = materials[prim["material"]] if "material" in prim else {}
            pbr = mat.get("pbrMetallicRoughness", {})
            base_color_tex = slot(pbr.get("baseColorTexture", {}).get("index"))
            masked = mat.get("alphaMode") == "MASK"
            prims.append({
                "transform": xform,
                "vertex_offset": v_total,
                "index_offset": i_total,
                "index_count": len(idx),
                # cgltf semantics (scene_loader.cpp:195-203): the factor
                # defaults to 1s and counts only without a base color texture
                "base_color": np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]),
                                         np.float32)
                if base_color_tex < 0 else np.ones(4, np.float32),
                "base_color_texture": base_color_tex,
                "metallic_roughness_texture": slot(
                    pbr.get("metallicRoughnessTexture", {}).get("index")),
                "normal_map": slot(mat.get("normalTexture", {}).get("index")),
                "metallic_factor": pbr.get("metallicFactor", 1.0),
                "roughness_factor": pbr.get("roughnessFactor", 1.0),
                "alpha_mask": 1 if masked else 0,
                "alpha_cutoff": mat.get("alphaCutoff", 0.5) if masked else 0.0,
            })
            positions.append(pos)
            normals.append(attr(attrs, "NORMAL", vcount, 3))
            tangents.append(attr(attrs, "TANGENT", vcount, 4))
            uv0s.append(attr(attrs, "TEXCOORD_0", vcount, 2))
            uv1s.append(attr(attrs, "TEXCOORD_1", vcount, 2))
            indices.append(idx)
            v_total += vcount
            i_total += len(idx)

    if light is None:
        light = fallback_directional_light()
    if camera is None:
        camera = Camera(position=np.array([0.0, 1.0, 3.0], np.float32))

    def cat(parts, width, dtype=np.float32):
        if parts:
            return np.concatenate(parts)
        return np.zeros((0, width) if width else (0,), dtype)

    buffers = build_scene_buffers(
        cat(positions, 3), cat(normals, 3), cat(tangents, 4), cat(uv0s, 2),
        cat(uv1s, 2), cat(indices, 0, np.int32), prims, images, srgb_flags,
    )
    return Scene(name=name, buffers=buffers, camera=camera, light=light)
