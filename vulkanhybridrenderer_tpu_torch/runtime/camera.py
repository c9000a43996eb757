"""Fly camera controller (reference Renderer::Update, renderer.cpp:46-101;
port of ``runtime/camera.py``).

The reference's constants: 10 units/s along the view-forward axis on WASD,
mouse-look 0.75 rad/s per pixel of delta, pitch clamped to +-1.55 rad.
"""
from __future__ import annotations

import numpy as np

from vulkanhybridrenderer_tpu_torch.scene.gltf import Camera

MOVEMENT_SPEED = 10.0
CAMERA_SPEED = 0.75
PITCH_LIMIT = 1.55


def update_camera(camera: Camera, dt: float, keys=frozenset(),
                  mouse_delta: tuple[float, float] = (0.0, 0.0),
                  mouse_down: bool = False) -> Camera:
    """Move and turn `camera` in place (the reference mutates scene.camera);
    returns it."""
    forward = camera.view()[2, :3]  # row 2 of the view matrix (renderer.cpp:66)
    forward = forward / np.linalg.norm(forward)
    pos = np.array(camera.position, np.float32)
    side = np.cross(forward, [0.0, 1.0, 0.0])
    if "w" in keys:
        pos -= forward * MOVEMENT_SPEED * dt
    if "s" in keys:
        pos += forward * MOVEMENT_SPEED * dt
    if "a" in keys:
        pos += side * MOVEMENT_SPEED * dt
    if "d" in keys:
        pos -= side * MOVEMENT_SPEED * dt
    camera.position = pos.astype(np.float32)

    if mouse_down and (mouse_delta[0] != 0.0 or mouse_delta[1] != 0.0):
        camera.yaw -= mouse_delta[0] * CAMERA_SPEED * dt
        camera.pitch -= mouse_delta[1] * CAMERA_SPEED * dt
        camera.pitch = float(np.clip(camera.pitch, -PITCH_LIMIT, PITCH_LIMIT))
    return camera
