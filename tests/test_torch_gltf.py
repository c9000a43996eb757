"""The port's glTF / GLB reader (scene/gltf.py) and asset writer
(scene/sample_asset.py) against the reference package's.

No tolerance anywhere: both readers run the same float32 / float64 numpy
arithmetic and the port's PNG decode equals PIL's, so every SceneBuffers
field (atlas data, offsets and scales included), the camera and the light
must be equal; measured equal on the Atrium and on the sponza-class asset at
scale 1 (254,636 triangles, 39 textures).  GLBs the port writes, read by the
reference's reader, must equal the reference-written ones read the same way.
A hand-made .gltf covers what the two assets do not: data-URI and external
buffers, an external PNG and a data-URI PNG, a matrix node and a normalized
accessor.  The port's scene, utils and app modules must import and load a
GLB with PIL unavailable.
"""
import base64
import dataclasses
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu.scene import sample_asset as jasset
from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
from vulkanhybridrenderer_tpu_torch.scene import sample_asset as passet
from vulkanhybridrenderer_tpu_torch.utils import png

REPO = Path(__file__).resolve().parents[1]
WRITERS = {"atrium": "build_sample_glb", "sponza_class": "build_sponza_class_glb"}


def _flat(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def assert_scenes_equal(a, b):
    """Every buffer, light and camera field of two Scenes equal (values,
    shapes and dtypes)."""
    assert a.name == b.name
    for part in ("buffers", "light"):
        fa, fb = _flat(getattr(a, part)), _flat(getattr(b, part))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            va, vb = fa[k], fb[k]
            if isinstance(va, (bool, int, float)):
                assert va == vb, k
                continue
            va, vb = np.asarray(va), np.asarray(vb)
            assert va.dtype == vb.dtype, (k, va.dtype, vb.dtype)
            np.testing.assert_array_equal(va, vb, err_msg=k)
    for f in dataclasses.fields(a.camera):
        va, vb = getattr(a.camera, f.name), getattr(b.camera, f.name)
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=f.name)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """{asset: (reference-written path, port-written path, reference truth,
    port truth)} at full scale."""
    d = tmp_path_factory.mktemp("glb")
    out = {}
    for name, fn in WRITERS.items():
        jp, pp = d / f"jax_{name}.glb", d / f"port_{name}.glb"
        out[name] = (jp, pp, getattr(jasset, fn)(jp), getattr(passet, fn)(pp))
    return out


@pytest.fixture(scope="module")
def jax_scenes(assets):
    return {name: jgltf.load_scene(v[0]) for name, v in assets.items()}


@pytest.mark.parametrize("asset", sorted(WRITERS))
def test_load_scene_matches_jax(assets, jax_scenes, asset):
    ps = pgltf.load_scene(assets[asset][0])
    assert_scenes_equal(jax_scenes[asset], ps)
    assert isinstance(ps.buffers.positions, np.ndarray)
    assert ps.buffers.positions.flags.writeable  # copies, not np.frombuffer views


@pytest.mark.parametrize("asset", sorted(WRITERS))
def test_port_written_glb_reads_as_reference_written(assets, jax_scenes, asset):
    jp, pp, jtruth, ptruth = assets[asset]
    assert sorted(jtruth) == sorted(ptruth)
    for k in jtruth:
        np.testing.assert_array_equal(np.asarray(jtruth[k]), np.asarray(ptruth[k]))
    loaded = jgltf.load_scene(pp)
    loaded.name = jax_scenes[asset].name  # the file names differ
    assert_scenes_equal(jax_scenes[asset], loaded)


def test_sponza_class_counts(jax_scenes, assets):
    """The flagship asset's counts, as the reference writes and reads it."""
    b = pgltf.load_scene(assets["sponza_class"][1]).buffers
    assert b.num_triangles == 254_636
    assert b.prim_transform.shape[0] == assets["sponza_class"][3]["prims"] == 370
    assert b.atlas.uv_offset.shape[0] == 39
    assert b.alpha_tri_idx.shape[0] == 600
    assert b.atlas.data.shape == (4, 72, 2560)
    assert b.has_alpha_mask and b.has_normal_maps and b.has_mr_textures


@pytest.fixture(scope="module")
def atrium(assets):
    jp, _, truth, _ = assets["atrium"]
    return pgltf.load_scene(jp), truth, json.loads(_glb_json(jp))


def _glb_json(path) -> bytes:
    raw = Path(path).read_bytes()
    n, kind = struct.unpack_from("<II", raw, 12)
    assert kind == 0x4E4F534A
    return raw[20 : 20 + n]


def test_atrium_interleaved_and_hierarchy(atrium):
    scene, truth, doc = atrium
    b = scene.buffers
    assert any(v.get("byteStride") == 32 for v in doc["bufferViews"])
    np.testing.assert_array_equal(b.positions[:4], truth["floor_interleaved_pos"])
    t = b.prim_transform[:, :3, 3]
    hits = (np.abs(t[:, 0] - truth["column0_world_x"]) < 1e-6) & (
        np.abs(t[:, 2] - truth["column0_world_z"]) < 1e-6)
    assert hits.sum() == 1  # column 0 under its parent's +0.5 z


def test_atrium_sparse_accessor(atrium):
    scene, truth, doc = atrium
    assert sum("sparse" in a for a in doc["accessors"]) == 1
    d = np.linalg.norm(scene.buffers.positions - truth["sparse_vertex0_local"], axis=1)
    assert d.min() == 0.0


def test_atrium_texcoord1_and_index_types(atrium):
    scene, truth, doc = atrium
    b = scene.buffers
    rug = [i for i, row in enumerate(b.uv1) if (row != 0).any()]
    assert len(rug) == 8  # two primitives share the rug's 4 vertices
    np.testing.assert_array_equal(b.uv1[rug[:4]], truth["uv1"])
    index_types = {doc["accessors"][p["indices"]]["componentType"]
                   for m in doc["meshes"] for p in m["primitives"]}
    assert index_types == {5123, 5125}  # u16 and u32
    assert b.num_triangles == 2 + 4 * 12 + 2 + 2 * 2 + 20 + 2 * 2
    assert b.prim_transform.shape[0] == truth["prims"] == 11


def test_atrium_camera_and_light(atrium, jax_scenes):
    scene, _, _ = atrium
    j = jax_scenes["atrium"]
    assert (scene.camera.yaw, scene.camera.pitch, scene.camera.roll) == (
        j.camera.yaw, j.camera.pitch, j.camera.roll)
    np.testing.assert_array_equal(scene.camera.position, np.float32([0.0, 2.2, 7.0]))
    np.testing.assert_array_equal(scene.light.direction, np.asarray(j.light.direction))
    np.testing.assert_array_equal(scene.light.projview, np.asarray(j.light.projview))
    assert scene.light.intensity[0] == 30.0


def test_gltf_json_uris_matrix_and_normalized(tmp_path):
    """A .gltf with a data-URI buffer, an external .bin, a data-URI PNG, an
    external PNG, a camera under a matrix node and normalized u8 texcoords:
    both readers give the same scene."""
    rng = np.random.default_rng(3)
    img0 = rng.integers(0, 256, (5, 7, 4)).astype(np.uint8)
    img1 = rng.integers(0, 256, (6, 3, 3)).astype(np.uint8)
    Image.fromarray(img1).save(tmp_path / "tex1.png")
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    uv = np.array([[0, 0], [255, 0], [0, 255], [255, 128]], np.uint8)
    idx = np.array([0, 1, 2, 2, 1, 3], np.uint16)
    (tmp_path / "geo.bin").write_bytes(pos.tobytes())
    inline = uv.tobytes() + idx.tobytes()
    uri = "data:application/octet-stream;base64," + base64.b64encode(inline).decode()
    png_uri = "data:image/png;base64," + base64.b64encode(png.encode_png(img0)).decode()
    cam_matrix = np.eye(4)
    cam_matrix[:3, :3] = [[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]]
    cam_matrix[:3, 3] = [1.0, 2.0, 3.0]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "geo.bin", "byteLength": 48},
                    {"uri": uri, "byteLength": len(inline)}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 48},
                        {"buffer": 1, "byteOffset": 0, "byteLength": 8},
                        {"buffer": 1, "byteOffset": 8, "byteLength": 12}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5121, "count": 4, "type": "VEC2",
             "normalized": True},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "images": [{"uri": png_uri}, {"uri": "tex1.png"}],
        "textures": [{"source": 0}, {"source": 1}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicRoughnessTexture": {"index": 1}}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "cameras": [{"type": "perspective", "perspective": {"yfov": 0.9}}],
        "nodes": [{"mesh": 0, "scale": [2.0, 1.0, 1.0]},
                  {"camera": 0, "matrix": cam_matrix.T.reshape(-1).tolist()}],
        "scenes": [{"nodes": [0, 1]}],
    }
    path = tmp_path / "scene.gltf"
    path.write_text(json.dumps(doc))
    j, p = jgltf.load_scene(path), pgltf.load_scene(path)
    assert_scenes_equal(j, p)
    np.testing.assert_array_equal(p.buffers.uv0[1], [1.0, 0.0])
    assert p.buffers.atlas.uv_offset.shape[0] == 2
    assert p.camera.yaw != 0.0 and p.light.intensity[0] == 0.0  # fallback light


def test_jpeg_texture_raises(tmp_path):
    """A JPEG texture, once a ValueError, loads equal to the reference's
    (PIL) through utils/jpeg, chosen by the data's signature.  A 4:2:0
    texture of odd size whose values vary, so the IDCT, the upsampling and
    the colour conversion all show."""
    import io

    rng = np.random.default_rng(11)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (13, 9, 3)).astype(np.uint8)).save(buf, format="JPEG")
    jpg = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    data = pos.tobytes() + np.array([0, 1, 2], np.uint16).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(data).decode(), "byteLength": len(data)}],
        "bufferViews": [{"buffer": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        "images": [{"uri": jpg}],
        "textures": [{"source": 0}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1,
                                    "material": 0}]}],
        "nodes": [{"mesh": 0}],
    }
    path = tmp_path / "jpeg.gltf"
    path.write_text(json.dumps(doc))
    assert_scenes_equal(jgltf.load_scene(path), pgltf.load_scene(path))


def test_port_modules_import_and_load_without_pil(tmp_path):
    """With PIL unavailable (sys.modules["PIL"] = None), the port's scene,
    utils, runtime.app and runtime.viewer import, write the Atrium and load
    it; neither PIL nor JAX is imported."""
    code = f"""
import sys
sys.modules["PIL"] = None
import vulkanhybridrenderer_tpu_torch.scene.gltf, vulkanhybridrenderer_tpu_torch.scene.procedural
import vulkanhybridrenderer_tpu_torch.scene.sample_asset as sa
import vulkanhybridrenderer_tpu_torch.utils.png, vulkanhybridrenderer_tpu_torch.utils.image
import vulkanhybridrenderer_tpu_torch.utils.bluenoise, vulkanhybridrenderer_tpu_torch.utils.math3d
import vulkanhybridrenderer_tpu_torch.runtime.app as app, vulkanhybridrenderer_tpu_torch.runtime.viewer
path = {str(tmp_path / "a.glb")!r}
sa.build_sample_glb(path)
scene = app.load_any_scene(path)
assert scene.buffers.atlas.uv_offset.shape[0] == 4
assert sys.modules["PIL"] is None
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
assert not any(m.startswith("vulkanhybridrenderer_tpu.") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
