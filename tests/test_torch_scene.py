"""The port's host scene construction against the JAX package's.

Procedural scenes, the texture atlas, camera / light matrices and the per-frame
constants must be identical: every later comparison between the two packages
starts from them.  Also: importing the port never imports JAX.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vulkanhybridrenderer_tpu.core import types as jtypes
from vulkanhybridrenderer_tpu.scene import procedural as jproc
from vulkanhybridrenderer_tpu.utils import math3d as jm3
from vulkanhybridrenderer_tpu_torch import bridge
from vulkanhybridrenderer_tpu_torch.core import types as ptypes
from vulkanhybridrenderer_tpu_torch.scene import procedural as pproc
from vulkanhybridrenderer_tpu_torch.utils import math3d as pm3

torch.set_num_threads(2)

SCENES = {
    "cornell": dict(),
    "sponza": dict(columns=3, segments=6, extra_boxes=12, grid_res=8),
}


def _build(pkg, name):
    return pkg.cornell_box() if name == "cornell" else pkg.sponza_proxy(**SCENES[name])


def _flat(obj, prefix=""):
    """Dataclass of arrays -> {dotted field name: value} (nested)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flat(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, (bool, int, float)):
            assert va == vb, k
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.shape == vb.shape, k
        assert va.dtype == vb.dtype or va.dtype.kind == vb.dtype.kind, k
        np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_procedural_scene_arrays_identical(name):
    js = _build(jproc, name)
    ps = _build(pproc, name)
    assert js.name == ps.name
    _assert_same(_flat(js.buffers), _flat(ps.buffers))
    _assert_same(_flat(js.light), _flat(ps.light))
    for f in dataclasses.fields(js.camera):
        np.testing.assert_array_equal(
            np.asarray(getattr(js.camera, f.name)), np.asarray(getattr(ps.camera, f.name))
        )
    np.testing.assert_array_equal(js.camera.view(), ps.camera.view())
    np.testing.assert_array_equal(js.camera.projection(1.5), ps.camera.projection(1.5))


def test_bridge_scene_equals_procedural():
    js = _build(jproc, "sponza")
    ps = bridge.scene_from_numpy(
        js.name, dataclasses.asdict(js.buffers), dataclasses.asdict(js.camera),
        dataclasses.asdict(js.light),
    )
    _assert_same(_flat(_build(pproc, "sponza").buffers), _flat(ps.buffers))
    dev = ps.buffers.to("cpu")
    assert isinstance(dev.positions, torch.Tensor)
    assert dev.tri_vertex.dtype == torch.int32
    assert dev.materials.alpha_mask.dtype == torch.int32
    assert dev.atlas.data.shape == tuple(js.buffers.atlas.data.shape)
    assert dev.has_alpha_mask is js.buffers.has_alpha_mask


def test_camera_light_math_identical():
    args = [(np.deg2rad(55.0), 1.5, 0.05), (np.deg2rad(65.0), 16 / 9, 0.1)]
    for a in args:
        np.testing.assert_array_equal(
            jm3.infinite_reverse_z_projection(*a), pm3.infinite_reverse_z_projection(*a)
        )
    np.testing.assert_array_equal(
        jm3.ortho(-8.0, 8.0, -8.0, 8.0, 12.0, 0.1), pm3.ortho(-8.0, 8.0, -8.0, 8.0, 12.0, 0.1)
    )
    eye, up = [3.0, 10.8, -2.5], [0.0, 1.0, 0.0]
    np.testing.assert_array_equal(jm3.look_at(eye, [0, 0, 0], up), pm3.look_at(eye, [0, 0, 0], up))
    np.testing.assert_array_equal(jm3.yaw_pitch_roll(-1.5, -0.14, 0.2),
                                  pm3.yaw_pitch_roll(-1.5, -0.14, 0.2))
    m = jm3.yaw_pitch_roll(0.3, 0.1, 0.0) @ np.diag([2.0, 1.0, 3.0, 1.0]).astype(np.float32)
    np.testing.assert_array_equal(jm3.normal_matrix(m), pm3.normal_matrix(m))


@pytest.mark.parametrize("frame", [0, 3])
def test_per_frame_data_identical(frame):
    js = _build(jproc, "sponza")
    ps = _build(pproc, "sponza")
    view, proj = js.camera.view(), js.camera.projection(96 / 64)
    prev_view = view.copy()
    prev_view[0, 3] += 0.25  # a moved camera: prev matrices differ
    jp = jtypes.make_per_frame_data(view, proj, js.light, 96, 64, frame_index=frame,
                                    prev_view=prev_view, prev_proj=proj)
    pp = ptypes.make_per_frame_data(view, proj, ps.light, 96, 64, frame_index=frame,
                                    prev_view=prev_view, prev_proj=proj)
    ja, pa = _flat(jp), _flat(pp)
    ja = {k: (int(v) if k in ("frame_index", "blue_noise_index") else v) for k, v in ja.items()}
    pa = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in pa.items()}
    _assert_same(ja, pa)
    np.testing.assert_array_equal(np.asarray(jp.camera_position), pp.camera_position.numpy())


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: jax must stay
    out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vulkanhybridrenderer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m.startswith('vulkanhybridrenderer_tpu.') or m == 'vulkanhybridrenderer_tpu')\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
