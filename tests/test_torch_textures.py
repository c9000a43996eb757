"""The textures the reference decodes through PIL and the port through numpy:
16-bit and Adam7-interlaced PNGs (utils/png.py) and JPEGs (utils/jpeg.py),
against ``PIL.Image.open(...).convert("RGBA")``.

Tolerance: none.  Every sample equals Pillow's (12.1 here, whose JPEG reader
is libjpeg-turbo) on every image below; measured equal on all of them, so no
JPEG case needed the one-level allowance a different IDCT or upsampler would
have asked for.  Pillow's 16-bit conversions, measured and held here: grey
(mode I;16) clips at 255 (256, 1000, 65535 -> 255); RGB, RGBA and grey +
alpha keep the high byte (256 -> 1, 40000 -> 156, 383 -> 1); a tRNS key
matches those 8-bit values by its low byte.  PNGs are written here with
numpy and zlib (Pillow cannot write Adam7), in every colour type and bit
depth, as small as 1x1 where most of Adam7's passes are empty.  JPEGs are
written by Pillow: baseline and progressive, grey, 4:4:4, 4:2:2 and 4:2:0,
restart intervals, odd sizes, and a few hypothesis cases; one more is a
three-component JPEG without JFIF whose component ids 'R', 'G', 'B' make
libjpeg skip the colour conversion.  A glTF with JPEG textures (one behind
a ".png" name, one PNG behind ".jpg") loads equal to the reference's
``load_scene``.  ~6 s alone.
"""
import base64
import io
import json
import struct
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
from vulkanhybridrenderer_tpu_torch.utils import png
from vulkanhybridrenderer_tpu_torch.utils.jpeg import decode_jpeg

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_gltf import assert_scenes_equal  # noqa: E402
from test_torch_png import ADAM7, chunk, filter_rows, pack  # noqa: E402

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: (colour type, bit depth) of every PNG
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (3, 1), (3, 2), (3, 4), (3, 8),
           (2, 8), (2, 16), (4, 8), (4, 16), (6, 8), (6, 16)]


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def write_png(samples, ctype, depth, interlace, rng, extra=b"") -> bytes:
    """(H, W, channels) samples (uint16 at 16 bits) as a PNG, plain or
    Adam7, each pass's rows filtered with random filter types."""
    h, w, c = samples.shape
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        ph, pw = sub.shape[:2]
        flat = sub.reshape(ph, pw * c)
        rows = (flat.astype(">u2").view(np.uint8).reshape(ph, 2 * pw * c) if depth == 16
                else pack(flat, depth))
        raw += filter_rows(rows, rng.integers(0, 5, ph).tolist(),
                           max(1, c * depth // 8)).tobytes()
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", header) + extra
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def random_png(rng, ctype, depth, h, w, interlace, trns):
    """Random samples (16-bit ones half below 600, so clipping and low
    bytes show), with a palette and a tRNS chunk where asked."""
    c = CHANNELS[ctype]
    top = (1 << depth) - 1
    s = rng.integers(0, top + 1, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
    if depth == 16:
        s[::2] = rng.integers(0, 600, s[::2].shape)
    extra = b""
    if ctype == 3:
        extra += chunk(b"PLTE", rng.integers(0, 256, 3 << depth).astype(np.uint8).tobytes())
        if trns:
            extra += chunk(b"tRNS", rng.integers(0, 256, 1 << depth).astype(np.uint8).tobytes())
    elif trns and ctype == 0:
        extra += chunk(b"tRNS", struct.pack(">H", int(s[0, 0, 0])))
    elif trns and ctype == 2:
        extra += chunk(b"tRNS", struct.pack(">HHH", *map(int, s[0, 0])))
    return write_png(s, ctype, depth, interlace, rng, extra)


@pytest.mark.parametrize("ctype, trns", [(0, False), (0, True), (2, False), (2, True),
                                         (4, False), (6, False)])
def test_png_16bit_every_colour_type(ctype, trns):
    """Colour types 4 and 6 carry alpha and take no tRNS."""
    rng = np.random.default_rng(10 * ctype + trns)
    data = random_png(rng, ctype, 16, 11, 13, 0, trns)
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def test_png_16bit_conversions_as_measured():
    """Pillow's 16-bit rules, on values chosen to tell them apart."""
    v = np.array([0, 1, 255, 256, 383, 1000, 40000, 65535], np.uint16)
    rng = np.random.default_rng(0)
    grey = png.decode_png(write_png(v.reshape(1, 8, 1), 0, 16, 0, rng))
    np.testing.assert_array_equal(grey[0, :, 0], [0, 1, 255, 255, 255, 255, 255, 255])
    rgb = png.decode_png(write_png(np.stack([v] * 3, -1).reshape(1, 8, 3), 2, 16, 0, rng))
    np.testing.assert_array_equal(rgb[0, :, 0], [0, 0, 0, 1, 1, 3, 156, 255])
    for key, clear in ((256, 0), (1000, None), (65535, 255)):
        data = write_png(v.reshape(1, 8, 1), 0, 16, 0, rng, chunk(b"tRNS", struct.pack(">H", key)))
        got = png.decode_png(data)
        np.testing.assert_array_equal(got, pil_rgba(data))
        want = grey[0, :, 0] == clear if clear is not None else np.zeros(8, bool)
        np.testing.assert_array_equal(got[0, :, 3] == 0, want)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (5, 7), (8, 8), (13, 21)])
@pytest.mark.parametrize("fmt", FORMATS, ids=[f"ct{c}-{d}bit" for c, d in FORMATS])
def test_png_adam7(fmt, size):
    """Adam7 at every colour type and bit depth; below 8x8 some passes are
    empty and write no scanlines."""
    ctype, depth = fmt
    rng = np.random.default_rng(ctype * 100 + depth * 10 + size[0])
    data = random_png(rng, ctype, depth, *size, 1, trns=ctype in (0, 2, 3))
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


@settings(max_examples=25, deadline=None, database=None, derandomize=True)
@given(fmt=st.sampled_from(FORMATS), w=st.integers(1, 30), h=st.integers(1, 20),
       seed=st.integers(0, 2**31 - 1), interlace=st.integers(0, 1), trns=st.booleans())
def test_png_random(fmt, w, h, seed, interlace, trns):
    ctype, depth = fmt
    data = random_png(np.random.default_rng(seed), ctype, depth, h, w, interlace,
                      trns and ctype in (0, 2, 3))
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def photo(h, w, channels, seed):
    """Smooth colour gradients plus noise: blocks with DC and AC energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(channels)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def pil_jpeg(arr, **kw) -> bytes:
    img = Image.fromarray(arr[..., 0] if arr.shape[2] == 1 else arr,
                          "L" if arr.shape[2] == 1 else "RGB")
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


JPEG_CASES = {
    "baseline 4:2:0": dict(quality=75),
    "baseline 4:4:4": dict(quality=95, subsampling=0),
    "baseline 4:2:2": dict(quality=50, subsampling=1),
    "baseline 4:2:0 restarts": dict(quality=85, restart_marker_blocks=3),
    "progressive 4:2:0": dict(progressive=True),
    "progressive 4:4:4": dict(progressive=True, subsampling=0, quality=97),
    "progressive 4:2:2 restarts": dict(progressive=True, subsampling=1, restart_marker_rows=1),
    "grey": dict(quality=80, channels=1),
    "grey progressive restarts": dict(progressive=True, restart_marker_blocks=2, channels=1),
}


@pytest.mark.parametrize("size", [(8, 8), (37, 53), (2, 3), (17, 1), (33, 130)])
@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_equals_pil(case, size):
    kw = dict(JPEG_CASES[case])
    arr = photo(*size, kw.pop("channels", 3), seed=size[0] * size[1])
    data = pil_jpeg(arr, **kw)
    got = decode_jpeg(data)
    assert got.shape == (*size, 4)
    np.testing.assert_array_equal(got, pil_rgba(data))


@settings(max_examples=12, deadline=None, database=None, derandomize=True)
@given(w=st.integers(1, 70), h=st.integers(1, 50), seed=st.integers(0, 2**31 - 1),
       quality=st.integers(5, 100), subsampling=st.integers(0, 2),
       progressive=st.booleans(), restart=st.integers(0, 4))
def test_jpeg_random(w, h, seed, quality, subsampling, progressive, restart):
    kw = dict(quality=quality, subsampling=subsampling, progressive=progressive)
    if restart:
        kw["restart_marker_blocks"] = restart
    data = pil_jpeg(photo(h, w, 3, seed), **kw)
    np.testing.assert_array_equal(decode_jpeg(data), pil_rgba(data))


def _segments(data: bytes):
    """(marker, payload start, payload end) of the header segments up to SOS."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (length,) = struct.unpack_from(">H", data, pos + 2)
        out.append((data[pos + 1], pos + 4, pos + 2 + length))
        pos += 2 + length
    return out


def test_jpeg_rgb_component_ids():
    """Without JFIF, component ids 'R', 'G', 'B' mean RGB samples: libjpeg
    converts nothing, and neither does the decoder."""
    data = bytearray(pil_jpeg(photo(16, 24, 3, 5), quality=90, subsampling=0))
    segs = _segments(bytes(data))
    (_, sof, _), = [s for s in segs if s[0] == 0xC0]
    sos = bytes(data).index(b"\xff\xda") + 4  # the scan header's payload
    for k, cid in enumerate(b"RGB"):
        data[sof + 6 + 3 * k] = cid  # the frame's component k
        data[sos + 1 + 2 * k] = cid  # the scan's
    (_, a0, a1), = [s for s in segs if s[0] == 0xE0]
    data = bytes(data[:a0 - 4] + data[a1:])  # drop the JFIF segment
    got, want = decode_jpeg(data), pil_rgba(data)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, decode_jpeg(pil_jpeg(photo(16, 24, 3, 5), quality=90,
                                                        subsampling=0)))


@pytest.mark.parametrize("what", ["12-bit", "arithmetic", "CMYK", "lossless", "not a JPEG"])
def test_jpeg_unsupported_raise(what):
    data = bytearray(pil_jpeg(photo(8, 8, 3, 1)))
    sof = [s for s in _segments(bytes(data)) if s[0] == 0xC0][0]
    if what == "12-bit":
        data[sof[1]] = 12
    elif what == "arithmetic":
        data[sof[1] - 3] = 0xC9
    elif what == "lossless":
        data[sof[1] - 3] = 0xC3
    elif what == "CMYK":
        buf = io.BytesIO()
        Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(buf, format="JPEG")
        data = buf.getvalue()
    else:
        data = b"\x89PNG" + bytes(data[4:])
    with pytest.raises(ValueError, match=what):
        decode_jpeg(bytes(data))


def test_jpeg_decode_time():
    """A 512x512 4:2:0 JPEG decodes to PIL's samples; prints the host time
    (the module docstring quotes it)."""
    data = pil_jpeg(photo(512, 512, 3, 9), quality=90)
    t0 = time.perf_counter()
    got = decode_jpeg(data)
    print(f"decode 512x512 4:2:0 JPEG: {time.perf_counter() - t0:.3f} s")
    np.testing.assert_array_equal(got, pil_rgba(data))


def test_gltf_with_jpeg_textures_loads_as_reference(tmp_path):
    """External files, dispatched on their bytes: a progressive JPEG base
    colour behind a ".png" name, a 16-bit Adam7 PNG normal map behind
    ".jpg", and a grey baseline JPEG metallic-roughness map in a data URI
    labelled image/png."""
    rng = np.random.default_rng(3)
    (tmp_path / "base.png").write_bytes(pil_jpeg(photo(24, 40, 3, 1), progressive=True))
    (tmp_path / "normal.jpg").write_bytes(random_png(rng, 2, 16, 16, 16, 1, False))
    mr = "data:image/png;base64," + base64.b64encode(
        pil_jpeg(photo(9, 14, 1, 2), quality=70)).decode()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
    blob = pos.tobytes() + uv.tobytes() + np.array([0, 1, 2], np.uint16).tobytes()
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode(), "byteLength": len(blob)}],
        "bufferViews": [{"buffer": 0, "byteLength": 36},
                        {"buffer": 0, "byteOffset": 36, "byteLength": 24},
                        {"buffer": 0, "byteOffset": 60, "byteLength": 6}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
                      {"bufferView": 1, "componentType": 5126, "count": 3, "type": "VEC2"},
                      {"bufferView": 2, "componentType": 5123, "count": 3, "type": "SCALAR"}],
        "images": [{"uri": "base.png"}, {"uri": "normal.jpg"}, {"uri": mr}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "metallicRoughnessTexture": {"index": 2}},
                       "normalTexture": {"index": 1}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0}]}],
        "nodes": [{"mesh": 0}],
    }
    path = tmp_path / "textures.gltf"
    path.write_text(json.dumps(doc))
    j, p = jgltf.load_scene(path), pgltf.load_scene(path)
    assert_scenes_equal(j, p)
    assert p.buffers.atlas.uv_offset.shape[0] == 3
