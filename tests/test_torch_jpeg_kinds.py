"""The JPEG kinds the reference reads through Pillow beyond Huffman DCT
frames (utils/jpeg.py): arithmetic-coded sequential and progressive frames
(SOF9, SOF10, with DAC conditioning and restarts), 8-bit lossless frames
(SOF3: predictors 1-7, point transforms, restarts, one, three and four
components, subsampled), CMYK with and without Adobe APP14, and YCCK;
then the kinds Pillow refuses, which must raise ``ValueError``; then the
committed fixtures of chip_smoke.py's "jpeg kinds" phase and a glTF that
shows them, loaded by both packages.

Tolerance: none.  The port's ``decode_jpeg`` must equal
``np.asarray(Image.open(...).convert("RGBA"))`` (Pillow 12.1 here,
libjpeg-turbo 3.1) on every stream.  No encoder here writes these kinds,
so tests/jpeg_writers.py builds them, and each writer is first held to
what it meant by Pillow alone: an arithmetic transcode decodes in Pillow
to exactly the pixels of its Huffman original (the same coefficients), a
lossless stream to its source samples shifted by the point transform, the
baseline encoder's CMYK / YCCK to its source within the loss of a quality
100 DCT (measured: CMYK within 1, YCCK within 4).  Sizes are the grid of
``test_torch_textures.py::test_jpeg_equals_pil``.  ~20 s alone.
"""
import io
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent))
import jpeg_writers as W  # noqa: E402
from test_torch_textures import _segments, pil_jpeg, pil_rgba  # noqa: E402
from vulkanhybridrenderer_tpu_torch.utils.jpeg import decode_jpeg  # noqa: E402

SIZES = [(8, 8), (37, 53), (2, 3), (17, 1), (33, 130)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def assert_port_equals_pil(data: bytes):
    want = pil_rgba(data)
    got = decode_jpeg(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    return got


def _markers(data: bytes) -> set:
    return {m for m, _, _ in _segments(data)}


# ---- arithmetic coding --------------------------------------------------------
ARITH = {
    "sequential": dict(),
    "sequential restarts": dict(restart=2),
    "sequential DAC": dict(dac={0: 0x31, 1: 0x52, 16: 2, 17: 12}),
    "progressive": dict(progressive=True),
    "progressive restarts DAC": dict(progressive=True, restart=3, dac={0: 0x20, 16: 9, 17: 1}),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("case", list(ARITH))
def test_arithmetic_equals_pil(case, sub, size):
    """Pillow's Huffman stream (baseline, or progressive with its own scan
    script) coded again with the QM-coder."""
    kw = dict(ARITH[case])
    src = pil_jpeg(W.photo(*size, 3, seed=size[0] * size[1]), quality=80,
                   subsampling=SUBSAMPLING[sub], progressive=kw.pop("progressive", False))
    data = W.transcode_arith(src, **kw)
    sof = 0xCA if "progressive" in case else 0xC9
    assert sof in _markers(data) and 0xC4 not in _markers(data)
    assert (0xCC in _markers(data)) == ("dac" in kw)
    np.testing.assert_array_equal(pil_rgba(data), pil_rgba(src))  # the writer's intent
    assert_port_equals_pil(data)


@pytest.mark.parametrize("size", [(37, 53), (17, 1)])
@pytest.mark.parametrize("progressive", [False, True])
def test_arithmetic_grey(size, progressive):
    src = pil_jpeg(W.photo(*size, 1, seed=3)[..., 0:1], quality=85, progressive=progressive)
    data = W.transcode_arith(src, restart=4)
    np.testing.assert_array_equal(pil_rgba(data), pil_rgba(src))
    assert_port_equals_pil(data)


def test_arithmetic_libjpeg_script_on_baseline_source():
    """A sequential source under libjpeg's own progression script (the
    fixtures' progressive stream is made so), and the transcode is really
    read: one flipped bit changes Pillow's pixels, and the port follows."""
    src = pil_jpeg(W.photo(40, 56, 3, seed=7), quality=90)
    data = W.transcode_arith(src, script=W.progressive_script(3))
    np.testing.assert_array_equal(pil_rgba(data), pil_rgba(src))
    assert_port_equals_pil(data)
    bad = bytearray(data)
    bad[data.index(b"\xff\xda") + 30] ^= 0x10
    assert not np.array_equal(pil_rgba(bytes(bad)), pil_rgba(src))
    assert_port_equals_pil(bytes(bad))


# ---- lossless ----------------------------------------------------------------
def _grey(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size).astype(np.uint8)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_grey_equals_pil(predictor, pt, size):
    g = _grey(size, predictor * 10 + pt)
    for restart in (0, size[1] * 2):
        data = W.encode_lossless([g], predictor, pt, restart=restart)
        np.testing.assert_array_equal(pil_rgba(data)[..., 0], (g >> pt) << pt)
        assert_port_equals_pil(data)


COLOUR_LOSSLESS = {
    "Adobe 0": dict(app=W.adobe(0)),
    "ids RGB": dict(ids=[82, 71, 66]),
    "ids 1 2 3": dict(),
    "ids 4 5 6": dict(ids=[4, 5, 6]),
}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(COLOUR_LOSSLESS))
def test_lossless_rgb_equals_pil(case, size):
    """Three components: with Adobe transform 0, ids 'R' 'G' 'B', or no
    marker at all, libjpeg-turbo takes a lossless frame as RGB."""
    rgb = W.photo(*size, 3, seed=size[0] + size[1])
    for predictor, restart in ((1, 0), (5, size[1]), (7, size[1] * 3)):
        data = W.encode_lossless(list(np.moveaxis(rgb, -1, 0)), predictor, 1, restart=restart,
                                 **COLOUR_LOSSLESS[case])
        np.testing.assert_array_equal(pil_rgba(data)[..., :3], (rgb >> 1) << 1)
        assert_port_equals_pil(data)


@pytest.mark.parametrize("sampling", [[(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                                      [(1, 2), (1, 1), (1, 1)]])
@pytest.mark.parametrize("size", [(10, 14), (9, 13), (3, 5)])
def test_lossless_subsampled_replicates(size, sampling):
    """libjpeg upsamples a lossless frame by replication (its block is one
    sample), never with the fancy filters."""
    h, w = size
    (fx, fy) = sampling[0]
    y = _grey(size, 1)
    cb, cr = (_grey((-(-h // fy), -(-w // fx)), s) for s in (2, 3))
    data = W.encode_lossless([y, cb, cr], 6, 0, sampling=sampling, app=W.adobe(0),
                             restart=-(-w // fx))
    up = [np.repeat(np.repeat(p, fy, 0), fx, 1)[:h, :w] for p in (cb, cr)]
    np.testing.assert_array_equal(pil_rgba(data)[..., :3], np.stack([y] + up, -1))
    assert_port_equals_pil(data)


@pytest.mark.parametrize("app", [b"", W.adobe(0)], ids=["plain", "Adobe 0"])
def test_lossless_cmyk_equals_pil(app):
    cmyk = W.photo(21, 13, 4, seed=5)
    data = W.encode_lossless(list(np.moveaxis(cmyk, -1, 0)), 4, 0, app=app, restart=13)
    im = Image.open(io.BytesIO(data))
    assert im.mode == "CMYK"
    np.testing.assert_array_equal(np.asarray(im), 255 - cmyk)  # PIL's inverted reading
    assert_port_equals_pil(data)


# ---- CMYK and YCCK -------------------------------------------------------------
def pil_cmyk(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, "CMYK").save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _drop_adobe(data: bytes) -> bytes:
    (_, a0, a1), = [s for s in _segments(data) if s[0] == 0xEE]
    return data[:a0 - 4] + data[a1:]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("kind", ["APP14", "no APP14", "progressive", "restarts"])
def test_cmyk_equals_pil(kind, sub, size):
    """Pillow's CMYK JPEGs carry Adobe APP14 transform 0; without it
    libjpeg takes four components as CMYK too, and Pillow reads both as
    Adobe-inverted.  Pillow's subsampling option halves the last three
    components against the first."""
    kw = {"progressive": dict(progressive=True),
          "restarts": dict(restart_marker_blocks=2)}.get(kind, {})
    data = pil_cmyk(W.photo(*size, 4, seed=size[0] * 7 + size[1]), quality=85,
                    subsampling=SUBSAMPLING[sub], **kw)
    if kind == "no APP14":
        data = _drop_adobe(data)
        assert 0xEE not in _markers(data)
    assert_port_equals_pil(data)


def test_cmyk_measured_pairs():
    """convert("RGBA") of two flat CMYK images, measured with Pillow 12.1:
    (10, 20, 30, 40) -> (207, 198, 190) and (200, 100, 50, 250) -> (1, 3, 4)."""
    for cmyk, rgb in (((10, 20, 30, 40), (207, 198, 190)), ((200, 100, 50, 250), (1, 3, 4))):
        buf = io.BytesIO()
        Image.new("CMYK", (8, 8), cmyk).save(buf, format="JPEG", quality=100)
        got = assert_port_equals_pil(buf.getvalue())
        assert (got[..., :3] == rgb).all() and (got[..., 3] == 255).all()


@pytest.mark.parametrize("app", [W.adobe(0), b""], ids=["Adobe 0", "no marker"])
def test_baseline_writer_cmyk_intent(app):
    cmyk = W.photo(24, 32, 4, seed=11)
    data = W.encode_baseline([255 - cmyk[..., k] for k in range(4)], quality=100, app=app)
    got = np.asarray(Image.open(io.BytesIO(data))).astype(int)
    assert np.abs(got - cmyk).max() <= 1
    assert_port_equals_pil(data)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("restart", [0, 3])
def test_ycck_equals_pil(restart, sub, size):
    """Adobe transform 2: libjpeg converts YCCK to CMYK; Y and K at full
    resolution, Cb and Cr subsampled."""
    chroma = {"4:4:4": (1, 1), "4:2:2": (1, 2), "4:2:0": (1, 1)}[sub]
    full = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}[sub]
    cmyk = W.photo(*size, 4, seed=size[0] * size[1] + 1)
    data = W.encode_baseline(W.ycck_planes(cmyk), [full, chroma, chroma, full], quality=90,
                             app=W.adobe(2), restart=restart)
    assert_port_equals_pil(data)


def test_ycck_writer_intent():
    """At quality 100 and full resolution the YCCK stream reads back in
    Pillow as its source CMYK within 4 levels (float YCbCr, then
    libjpeg's integer conversion back)."""
    cmyk = W.photo(24, 32, 4, seed=12)
    data = W.encode_baseline(W.ycck_planes(cmyk), quality=100, app=W.adobe(2))
    got = np.asarray(Image.open(io.BytesIO(data))).astype(int)
    assert np.abs(got - cmyk).max() <= 4
    assert_port_equals_pil(data)


def test_baseline_writer_ycbcr_equals_pil():
    """The baseline writer's YCbCr 4:2:0 with JFIF, as the fixtures' source."""
    rgb = W.photo(37, 53, 3, seed=13)
    data = W.encode_baseline(W.ycc_planes(rgb), [(2, 2), (1, 1), (1, 1)], quality=85,
                             app=W.JFIF, restart=4)
    assert np.abs(pil_rgba(data)[..., :3].astype(int) - rgb).mean() < 12
    assert_port_equals_pil(data)


# ---- what Pillow refuses -------------------------------------------------------
def _refused(what: str) -> bytes:
    g = _grey((9, 14), 4)
    rgb = list(np.moveaxis(W.photo(9, 14, 3, seed=4), -1, 0))
    if what == "lossless 16-bit":
        return W.encode_lossless([g], 1, 0, precision=16)
    if what == "arithmetic-coded lossless":
        return W.encode_lossless([g], 1, 0, sof=0xCB)
    if what == "lossless JPEG in YCC":  # JFIF: YCbCr, which lossless mode cannot convert
        return W.encode_lossless(rgb, 1, 0, app=W.JFIF)
    if what == "lossless JPEG in YCCK":
        return W.encode_lossless(rgb + [g], 1, 0, app=W.adobe(2))
    if what == "restart interval":  # not a whole number of MCU rows
        return W.encode_lossless([g], 1, 0, restart=15)
    if what == "Huffman table":  # the scan names DC table 1, which no DHT defines
        data = bytearray(W.encode_lossless([g], 1, 0))
        sos = data.index(b"\xff\xda")
        data[sos + 6] = 0x10
        return bytes(data)
    assert what == "2 components"
    return W.encode_lossless(rgb[:2], 1, 0)


#: beside test_torch_textures.py's (other precisions, hierarchical, DNL)
REFUSED = ["lossless 16-bit", "arithmetic-coded lossless", "lossless JPEG in YCC",
           "lossless JPEG in YCCK", "restart interval", "Huffman table", "2 components"]


@pytest.mark.parametrize("what", REFUSED)
def test_refused_as_pil_refuses(what):
    data = _refused(what)
    with pytest.raises(Exception):
        pil_rgba(data)
    with pytest.raises(ValueError, match=what):
        decode_jpeg(data)


# ---- the chip_smoke.py fixtures and a glTF that shows them ----------------------
def test_fixtures_current():
    """tests/data/torch_jpeg holds exactly what jpeg_writers.fixtures()
    writes, each beside Pillow's decode of it, and the port decodes each to
    it (rewrite them with ``python tests/jpeg_writers.py``)."""
    streams = W.fixtures()
    assert sorted(p.stem for p in W.FIXTURE_DIR.glob("*.jpg")) == sorted(streams)
    for name, data in streams.items():
        assert (W.FIXTURE_DIR / f"{name}.jpg").read_bytes() == data, name
        golden = np.load(W.FIXTURE_DIR / f"{name}.npy")
        np.testing.assert_array_equal(golden, pil_rgba(data))
        np.testing.assert_array_equal(decode_jpeg(data), golden)
        assert len(data) < 8192


def test_texture_board_loads_as_reference(tmp_path):
    """The fixtures as the textures of scene/sample_asset's texture board:
    the port's load_scene equals the reference's, and its atlas holds the
    goldens."""
    from test_torch_gltf import assert_scenes_equal
    from vulkanhybridrenderer_tpu.scene import gltf as jgltf
    from vulkanhybridrenderer_tpu_torch.scene import gltf as pgltf
    from vulkanhybridrenderer_tpu_torch.scene import sample_asset
    from vulkanhybridrenderer_tpu_torch.scene.atlas import build_atlas

    names = sorted(W.fixtures())
    path = tmp_path / "board.glb"
    sample_asset.build_texture_board_glb(path, [(W.FIXTURE_DIR / f"{n}.jpg").read_bytes()
                                                for n in names])
    j, p = jgltf.load_scene(path), pgltf.load_scene(path)
    assert_scenes_equal(j, p)
    goldens = [np.load(W.FIXTURE_DIR / f"{n}.npy") for n in names]
    want = build_atlas(goldens, [True] * len(names))  # base colours: sRGB
    np.testing.assert_array_equal(np.asarray(p.buffers.atlas.data), want.data)
