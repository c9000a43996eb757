"""The camera a user flies, as a function of the seed and the frame index.

One general generator for every traffic mix of this benchmark; a mix is a
file of its parameters (``traffic/<name>.json``):

- ``step_s``: the time step a frame, as the port's app and viewer step the
  camera (1/60 s);
- ``speed``: units a second along the start camera's view direction while a
  key is held (the reference's 10);
- ``walk_frames``: frames ``w`` is held, then as many frames of ``s``: the
  camera walks out and back, between the start and ``speed * step_s *
  walk_frames`` units ahead of it;
- ``yaw_amplitude``, ``pitch_amplitude``: radians of mouse-look, a sine over
  the period, the pitch at twice the rate;
- ``period``: frames after which every pose repeats exactly.

The seed sets where in the period frame 0 falls and the sign and phase of
the look; the set of poses a period visits is the same for every seed.  No
pose depends on how fast frames come: frame i's pose is ``pose(i)``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pose:
    position: tuple
    yaw: float
    pitch: float


class Fly:
    def __init__(self, params: dict, seed: int, position, yaw: float, pitch: float,
                 forward) -> None:
        """`position`, `yaw`, `pitch`: the scene's camera; `forward`: its unit
        view direction (where ``w`` moves it)."""
        self.step_s = float(params["step_s"])
        self.speed = float(params["speed"])
        self.walk_frames = int(params["walk_frames"])
        self.yaw_amplitude = float(params["yaw_amplitude"])
        self.pitch_amplitude = float(params["pitch_amplitude"])
        self.period = int(params["period"])
        if self.period % (2 * self.walk_frames):
            raise ValueError("period must be a whole number of walks out and back")
        rng = np.random.default_rng(int(seed))
        self.offset = int(rng.integers(self.period))
        self.yaw_sign = float(rng.choice((-1.0, 1.0)))
        self.pitch_sign = float(rng.choice((-1.0, 1.0)))
        self.pitch_phase = float(rng.uniform(0.0, 2.0 * math.pi))
        self.position = np.asarray(position, np.float64)
        self.forward = np.asarray(forward, np.float64)
        self.yaw, self.pitch = float(yaw), float(pitch)

    def walk(self, j: int) -> float:
        """Units walked ahead of the start at step j of the period."""
        k = j % (2 * self.walk_frames)
        held = min(k, 2 * self.walk_frames - k)
        return held * self.speed * self.step_s

    def pose(self, i: int) -> Pose:
        j = (i + self.offset) % self.period
        a = 2.0 * math.pi * j / self.period
        pos = self.position + self.forward * self.walk(j)
        return Pose(
            position=tuple(float(v) for v in pos),
            yaw=self.yaw + self.yaw_sign * self.yaw_amplitude * math.sin(a),
            pitch=self.pitch + self.pitch_sign * self.pitch_amplitude
            * math.sin(2.0 * a + self.pitch_phase),
        )


def view_forward(view: np.ndarray) -> np.ndarray:
    """The unit direction ``w`` moves a camera with view matrix `view`
    (the reference's Renderer::Update: minus row 2 of the view)."""
    f = -np.asarray(view, np.float64)[2, :3]
    return f / np.linalg.norm(f)
