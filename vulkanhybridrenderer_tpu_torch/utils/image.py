"""Image output and color transfer helpers (port of ``utils/image.py``; the
reference's debug-texture viewer, user_interface.cpp:129-150).  PNGs go
through ``utils/png``."""
from __future__ import annotations

import numpy as np

from vulkanhybridrenderer_tpu_torch.utils import png


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.clip(np.asarray(c, np.float32), 0.0, 1.0)
    return np.where(c <= 0.0031308, 12.92 * c, 1.055 * c ** (1 / 2.4) - 0.055)


def to_uint8_image(planar: np.ndarray, srgb: bool = True) -> np.ndarray:
    """(C, H, W) linear float -> (H, W, 3) uint8 for a PNG dump, sRGB-encoded
    as the reference's B8G8R8A8_SRGB swapchain presents it."""
    arr = np.asarray(planar, np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    rgb = arr[:3] if arr.shape[0] >= 3 else np.repeat(arr[:1], 3, axis=0)
    rgb = rgb.transpose(1, 2, 0)
    rgb = linear_to_srgb(rgb) if srgb else np.clip(rgb, 0.0, 1.0)
    return (rgb * 255.0 + 0.5).astype(np.uint8)


def save_png(path, planar: np.ndarray, srgb: bool = True) -> None:
    with open(path, "wb") as fh:
        fh.write(png.encode_png(to_uint8_image(planar, srgb)))


def encode_png(arr: np.ndarray, srgb: bool = True, already_u8: bool = False) -> bytes:
    """PNG bytes in memory (the live viewer's frame transport).  already_u8:
    `arr` is an (H, W, 4) uint8 swapchain image (render_frame(srgb8=True))."""
    img = np.asarray(arr)[..., :3] if already_u8 else to_uint8_image(arr, srgb)
    return png.encode_png(img)


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.sqrt(np.mean((a - b) ** 2)))
