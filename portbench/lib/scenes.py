"""The reference's copy of a scene a generator made (``inputs/``): the same
GLB file through the reference's own loader, or the same host arrays
through its own assembly."""
from __future__ import annotations


def reference_scene(made: dict):
    from portbench.reference import scene

    if "glb" in made:
        return scene.load_glb(made["glb"])
    a = made["arrays"]
    cam = a["camera"]
    return scene.from_arrays(
        a["positions"], a["normals"], a["tangents"], a["uv0"], a["indices"], a["primitives"],
        a["images"], a["srgb"],
        scene.Camera(yfov=cam["yfov"], znear=cam["znear"], aspect=cam["aspect"],
                     position=cam["position"], yaw=cam["yaw"], pitch=cam["pitch"],
                     roll=cam.get("roll", 0.0)),
        scene.sun(**a["light"]))
