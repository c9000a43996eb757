"""The reference is right, on the CPU at a tiny size: it agrees with the JAX
package, the renderer's specification, frame after frame from an empty
history with its own SVGF state carried, on each cell's path; and it agrees
with the port through the harness's own run and check."""
import os

import numpy as np
import pytest
import torch
from conftest import ROOT, TINY, checked, tiny_run

FRAMES = 5


def jax_frames(cell_name: str, seed: int, tmp_path):
    """(the JAX package's frames, the reference's) of the cell's path at its
    tiny size, the camera flying the seed's path from frame 0."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    pytest.importorskip("jax")
    from vulkanhybridrenderer_tpu.core import config as jax_config
    from vulkanhybridrenderer_tpu.runtime.renderer import Renderer
    from vulkanhybridrenderer_tpu.scene import gltf, procedural

    from portbench.lib import scenes, spec
    from portbench.lib.fly import Fly, view_forward
    from portbench.reference import render

    cell = spec.load_cell(cell_name, ROOT)
    tiny = TINY[cell_name]
    width, height = tiny["size"]
    params = {**cell.config["scene"], **tiny.get("scene", {})}
    made = spec.generator(params["generator"])(params, tmp_path)
    if "glb" in made:
        scene = gltf.load_scene(made["glb"])
    else:
        scene = procedural.sponza_proxy(**params.get("args", {}))
    settings = {**cell.workload["render_config"], **tiny.get("settings", {})}
    jax_renderer = Renderer(scene, spec.settings(jax_config.RenderConfig, {
        **settings, "width": width, "height": height}), path=cell.workload["path"])
    ref = render.Reference(scenes.reference_scene(made), settings, cell.workload["path"],
                           width, height, "cpu")
    cam = scene.camera
    fly = Fly(cell.traffic, seed, np.array(cam.position), cam.yaw, cam.pitch,
              view_forward(cam.view()))
    theirs, mine, state = [], [], None
    for i in range(FRAMES):
        pose = fly.pose(i)
        cam.position = np.asarray(pose.position, np.float32)
        cam.yaw, cam.pitch = pose.yaw, pose.pitch
        theirs.append(torch.from_numpy(np.asarray(jax_renderer.render_frame())))
        out, state = ref.frame(pose, fly.pose(max(i - 1, 0)), i, state)
        mine.append(out)
    return theirs, mine


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_agrees_with_the_jax_package(cell, tmp_path):
    from portbench.lib import check

    theirs, mine = jax_frames(cell, 2**31 + 9, tmp_path)
    for k, (a, b) in enumerate(zip(theirs, mine)):
        got = check.frame_numbers(a, b)
        assert got["off_share"] <= 5e-3 and got["rel_err"] <= 1e-4, (k, got)


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_reference_agrees_with_the_port(cell, seed, tmp_path):
    v = checked(tiny_run(cell, seed, tmp_path))
    assert v["correct"], v
    assert v["numbers"]["off_share"]["value"] <= 1e-3
