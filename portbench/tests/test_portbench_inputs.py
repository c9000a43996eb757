"""The frozen input generators give the port's generators' scenes."""
import dataclasses

import numpy as np
import torch

from portbench.inputs import procedural, sponza_class_glb


def test_sponza_class_glb_bytes_equal_the_ports(tmp_path):
    from vulkanhybridrenderer_tpu_torch.scene import sample_asset

    for scale in (0.05, 0.1):
        mine = sponza_class_glb.make({"scale": scale}, tmp_path)["glb"]
        theirs = tmp_path / "port.glb"
        sample_asset.build_sponza_class_glb(theirs, scale=scale)
        assert open(mine, "rb").read() == theirs.read_bytes()


def _arrays(obj, prefix=""):
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            out.update(_arrays(getattr(obj, f.name), f"{prefix}{f.name}."))
        return out
    if isinstance(obj, torch.Tensor):
        return {prefix: obj.numpy()}
    return {prefix: np.asarray(obj)}


def test_the_port_assembles_the_frozen_arrays_into_its_own_sponza_proxy(tmp_path):
    """The harness hands the frozen generator's host arrays to the port's
    public ``gltf.build_scene_buffers``: the scene equals the port's own
    ``procedural.sponza_proxy``."""
    from vulkanhybridrenderer_tpu_torch.scene import procedural as port_procedural

    from portbench.lib.harness import import_port, port_scene

    args = {"columns": 2, "segments": 8, "extra_boxes": 12, "grid_res": 16}
    made = procedural.make({"scene": "sponza_proxy", "args": args}, tmp_path)
    mine = port_scene(import_port(), made, {})
    theirs = port_procedural.sponza_proxy(**args)
    a, b = _arrays(mine.buffers), _arrays(theirs.buffers)
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    for f in ("position", "yaw", "pitch", "yfov", "znear"):
        assert np.array_equal(np.asarray(getattr(mine.camera, f)),
                              np.asarray(getattr(theirs.camera, f)))
    assert _arrays(mine.light).keys() == _arrays(theirs.light).keys()
    for k, v in _arrays(mine.light).items():
        assert np.array_equal(v, _arrays(theirs.light)[k])
