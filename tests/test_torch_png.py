"""The port's PNG codec (vulkanhybridrenderer_tpu_torch/utils/png.py) against
PIL, which the reference package decodes and encodes with.

Decoding must equal ``PIL.Image.open(...).convert("RGBA")`` exactly (no
tolerance; measured equal on every image here): on every image embedded in
the JAX-written Atrium and sponza-class GLBs (PIL picks a filter type per
row there), and on PNGs this file builds with each filter type 0-4 forced,
per image or drawn per row by hypothesis, in every colour type and bit depth
the decoder takes, with tRNS and with the image data split over several
IDAT chunks.  PIL must read the port's encoded PNGs back equal to their
source.  Unsupported files raise ValueError.
"""
import io
import struct
import time
import zlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from vulkanhybridrenderer_tpu.scene import gltf as jgltf
from vulkanhybridrenderer_tpu.scene import sample_asset as jasset
from vulkanhybridrenderer_tpu_torch.utils import png

#: (colour type, bit depth) of every PNG the decoder takes
FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (3, 1), (3, 2), (3, 4), (3, 8),
           (2, 8), (4, 8), (6, 8)]
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def filter_rows(rows: np.ndarray, ftypes, bpp: int) -> np.ndarray:
    """The PNG filter of each row (ftypes[y] in 0-4) applied to (H, rowbytes)
    uint8, written from the spec with the whole image known."""
    h, n = rows.shape
    r = rows.astype(np.int32)
    up = np.vstack([np.zeros((1, n), np.int32), r[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), r[:, :-bpp]])
    upleft = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    a, b, c = left, up, upleft
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    preds = [np.zeros_like(r), a, b, (a + b) >> 1, paeth]
    out = np.empty((h, n + 1), np.uint8)
    for y in range(h):
        out[y, 0] = ftypes[y]
        out[y, 1:] = (r[y] - preds[ftypes[y]][y]) & 0xFF
    return out


def pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, N) samples of `depth` bits -> (H, rowbytes) packed MSB first."""
    if depth == 8:
        return samples.astype(np.uint8)
    h, n = samples.shape
    per = 8 // depth
    s = np.hstack([samples, np.zeros((h, (-n) % per), samples.dtype)])
    s = s.reshape(h, -1, per).astype(np.uint16)
    return (s << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)


def build_png(samples, ctype, depth, ftypes, extra=b"", n_idat=1,
              interlace=0) -> bytes:
    """A PNG of (H, W, channels) samples with row filters `ftypes`; `extra`
    chunks go before the image data, split over `n_idat` IDAT chunks."""
    h, w, c = samples.shape
    rows = pack(samples.reshape(h, w * c), depth)
    raw = filter_rows(rows, ftypes, max(1, c * depth // 8)).tobytes()
    z = np.frombuffer(zlib.compress(raw), np.uint8)
    parts = np.array_split(z, n_idat)
    header = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + chunk(b"IHDR", header) + extra
            + b"".join(chunk(b"IDAT", p.tobytes()) for p in parts) + chunk(b"IEND", b""))


def pil_rgba(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def random_png(rng, ctype, depth, w, h, ftypes, trns, n_idat):
    """Random samples of one format, with a tRNS chunk when `trns` (a key
    taken from the image for grey and RGB, per-entry alpha for a palette)."""
    c = CHANNELS[ctype]
    # few distinct values, so a tRNS key matches some pixels
    hi = (1 << depth) if ctype in (0, 3) else 4
    samples = rng.integers(0, hi, (h, w, c)).astype(np.uint8)
    if ctype in (2, 4, 6) and rng.random() < 0.5:
        samples = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
    extra = b""
    if ctype == 3:
        pal = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8)
        extra += chunk(b"PLTE", pal.tobytes())
        if trns:
            alpha = rng.integers(0, 256, int(rng.integers(1, (1 << depth) + 1)))
            extra += chunk(b"tRNS", alpha.astype(np.uint8).tobytes())
    elif trns and ctype == 0:
        extra += chunk(b"tRNS", struct.pack(">H", int(samples[0, 0, 0])))
    elif trns and ctype == 2:
        extra += chunk(b"tRNS", struct.pack(">HHH", *map(int, samples[0, 0])))
    return build_png(samples, ctype, depth, ftypes, extra, n_idat)


def glb_images(path):
    """Every embedded image of a GLB, as bytes (read with the reference
    package's reader)."""
    g = jgltf._Gltf(path)
    return [g.buffer_view_bytes(img["bufferView"]) for img in g.json["images"]]


@pytest.mark.parametrize("asset", ["atrium", "sponza_class"])
def test_decode_equals_pil_on_the_reference_assets(tmp_path, asset):
    path = tmp_path / f"{asset}.glb"
    if asset == "atrium":
        jasset.build_sample_glb(path)
    else:
        jasset.build_sponza_class_glb(path, scale=0.12)
    blobs = glb_images(path)
    assert len(blobs) == (4 if asset == "atrium" else 39)
    for blob in blobs:
        got = png.decode_png(blob)
        assert got.dtype == np.uint8 and got.shape[2] == 4
        np.testing.assert_array_equal(got, pil_rgba(blob))


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("fmt", FORMATS, ids=[f"ct{c}-{d}bit" for c, d in FORMATS])
def test_decode_each_filter_forced(fmt, ftype):
    """One filter type on every row, each format, tRNS on, 3 IDAT chunks,
    at a width that leaves a partial byte at low bit depths."""
    ctype, depth = fmt
    rng = np.random.default_rng(100 * ctype + 10 * depth + ftype)
    w, h = 19, 7
    data = random_png(rng, ctype, depth, w, h, [ftype] * h, trns=ctype in (0, 2, 3),
                      n_idat=3)
    got = png.decode_png(data)
    assert got.shape == (h, w, 4)
    np.testing.assert_array_equal(got, pil_rgba(data))


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(fmt=st.sampled_from(FORMATS), w=st.integers(1, 40), h=st.integers(1, 24),
       seed=st.integers(0, 2**31 - 1), trns=st.booleans(), n_idat=st.integers(1, 4))
def test_decode_random_row_filters(fmt, w, h, seed, trns, n_idat):
    ctype, depth = fmt
    rng = np.random.default_rng(seed)
    ftypes = rng.integers(0, 5, h).tolist()
    data = random_png(rng, ctype, depth, w, h, ftypes, trns, n_idat)
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


@pytest.mark.parametrize("which", ["zero", "one", "middle", "top"])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_grey_trns_key_as_pil(depth, which):
    """PIL holds a grey tRNS key against the samples scaled to 8 bits (the
    key of a 1-bit image scaled too); the decoder does the same."""
    top = (1 << depth) - 1
    key = {"zero": 0, "one": 1, "middle": (top + 1) // 2, "top": top}[which]
    g = ((np.arange(64) * 5) % (1 << depth)).astype(np.uint8).reshape(8, 8, 1)
    data = build_png(g, 0, depth, [0] * 8, chunk(b"tRNS", struct.pack(">H", key)))
    np.testing.assert_array_equal(png.decode_png(data), pil_rgba(data))


def test_decode_1024_rgba_every_filter():
    """A 1024x1024 RGBA image whose rows cycle through filter types 0-4
    decodes to its source; prints the host time (the module docstring
    quotes it)."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (1024, 1024, 4)).astype(np.uint8)
    data = build_png(img, 6, 8, [y % 5 for y in range(1024)])
    t0 = time.perf_counter()
    got = png.decode_png(data)
    print(f"decode 1024x1024 RGBA: {time.perf_counter() - t0:.3f} s")
    np.testing.assert_array_equal(got[..., :4], img)


@pytest.mark.parametrize("channels", [3, 4])
def test_encode_read_back_by_pil(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (37, 53, channels)).astype(np.uint8)
    data = png.encode_png(img)
    pil = Image.open(io.BytesIO(data))
    assert pil.mode == ("RGB" if channels == 3 else "RGBA")
    np.testing.assert_array_equal(np.asarray(pil), img)
    back = png.decode_png(data)
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8), np.zeros((4, 4, 2), np.uint8),
                                 np.zeros((4, 4, 3), np.float32)])
def test_encode_rejects_other_arrays(bad):
    with pytest.raises(ValueError):
        png.encode_png(bad)


def _corrupt(data: bytes) -> bytes:
    b = bytearray(data)
    b[-20] ^= 0xFF  # inside the last IDAT's payload or CRC
    return bytes(b)


@pytest.mark.parametrize("case, what", [
    ("16-bit", "16-bit"),
    ("interlaced", "interlaced"),
    ("jpeg", "JPEG"),
    ("not-png", "not a PNG"),
    ("crc", "CRC"),
])
def test_unsupported_raise(case, what):
    img = np.zeros((4, 4, 3), np.uint8)
    if case == "16-bit":
        header = struct.pack(">IIBBBBB", 4, 4, 16, 2, 0, 0, 0)
        data = (png.SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(bytes(4 * 25))) + chunk(b"IEND", b""))
    elif case == "interlaced":
        data = build_png(img, 2, 8, [0] * 4, interlace=1)
    elif case == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        data = buf.getvalue()
    elif case == "not-png":
        data = b"GIF89a" + bytes(32)
    else:
        data = _corrupt(png.encode_png(img))
    with pytest.raises(ValueError, match=what):
        png.decode_png(data)
