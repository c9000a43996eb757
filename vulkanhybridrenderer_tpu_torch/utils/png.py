"""PNG codec in numpy and zlib (what the reference package gets from PIL).

``decode_png`` returns (H, W, 4) uint8 RGBA, as ``PIL.Image.open(...)
.convert("RGBA")`` does: grayscale, RGB, gray + alpha and RGBA at 8 and 16
bits, palette and grayscale at 1, 2, 4 and 8 bits, filter types 0-4 per row,
Adam7 interlacing, any number of IDAT chunks and a tRNS chunk.  16-bit
samples go to 8 bits as Pillow takes them: grayscale (mode I;16) clipped at
255, every other colour type by its high byte; a 16-bit tRNS key is held
against those 8-bit values by its low byte.  A JPEG or other non-PNG file
raises ``ValueError`` naming it (``scene/gltf`` sends JPEGs to
``utils/jpeg``).

The Average and Paeth filters predict a byte from its left neighbour, so a
row cannot be undone with one vector operation.  The unfilter walks the
image's anti-diagonals instead: byte group (y, x) needs only (y, x-1),
(y-1, x) and (y-1, x-1), which all lie on earlier diagonals, so each of the
H + W - 1 steps undoes one whole diagonal of every row at once.  A 1024x1024
RGBA image whose rows cycle through every filter type decodes in ~0.5 s of
host time (0.51-0.54 s measured on an x86 CPU;
``tests/test_torch_png.py::test_decode_1024_rgba_every_filter`` prints it),
against minutes for a loop over bytes.  An Adam7 image is seven such
images, the passes, each filtered on its own (a pass with no pixels has no
scanlines), whose pixels interleave.

``encode_png`` writes 8-bit RGB or RGBA with filter type 0 on every row.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_BIT_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        if data[:3] == b"\xff\xd8\xff":
            raise ValueError("a JPEG file is not a PNG (utils/jpeg decodes JPEG)")
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        payload = data[pos + 8 : pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + length)
        if zlib.crc32(ctype + payload) != crc:
            raise ValueError(f"PNG chunk {ctype!r} fails its CRC")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(raw: np.ndarray, height: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` (height * (1 + rowbytes) bytes) into
    (height, rowbytes) uint8.  bpp: bytes a filter step spans (>= 1)."""
    rows = raw.reshape(height, 1 + rowbytes)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} does not exist")
    n = rowbytes // bpp
    # Skewed layout: byte group (y, x) sits at column y + x, so diagonal d is
    # column d, and its left, up and up-left neighbours are columns d - 1,
    # d - 1 and d - 2 of this row and the row above.  Two leading zero
    # columns and a zero row on top stand for the image's zero border.
    ys, xs = np.mgrid[0:height, 0:n]
    filt = np.zeros((height, height + n, bpp), np.int16)
    filt[ys, ys + xs] = rows[:, 1:].reshape(height, n, bpp)
    skew = np.zeros((height + 1, height + n + 2, bpp), np.int16)
    ft = ftype[:, None, None]
    for d in range(height + n - 1):
        lo, hi = max(0, d - n + 1), min(height, d + 1)
        a = skew[lo + 1 : hi + 1, d + 1]  # left
        b = skew[lo:hi, d + 1]  # up
        c = skew[lo:hi, d]  # up-left
        f = ft[lo:hi, 0]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(f, (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        skew[lo + 1 : hi + 1, d + 2] = (filt[lo:hi, d] + pred) & 0xFF
    return skew[1:, 2:][ys, ys + xs].reshape(height, rowbytes).astype(np.uint8)


def _unpack(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, rowbytes) packed samples of `depth` bits -> (H, width) samples
    (uint16 at 16 bits, uint8 below)."""
    if depth == 16:  # big-endian byte pairs
        pairs = rows[:, :2 * width].reshape(rows.shape[0], width, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :width]
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # MSB first
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(rows.shape[0], rows.shape[1] * per)[:, :width]


def _samples(raw: np.ndarray, width: int, height: int, channels: int, depth: int,
             interlace: int) -> np.ndarray:
    """The (H, W, channels) samples of the decompressed image data `raw`,
    plain or Adam7-interlaced."""
    bpp = max(1, channels * depth // 8)
    passes = [(0, 0, 1, 1)] if not interlace else _ADAM7
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass has no scanlines
        rowbytes = (w * channels * depth + 7) // 8
        size = h * (1 + rowbytes)
        if raw.size < pos + size:
            raise ValueError("PNG image data is shorter than its header says")
        rows = _unfilter(raw[pos:pos + size], h, rowbytes, bpp)
        pos += size
        out[y0::dy, x0::dx] = _unpack(rows, w * channels, depth).reshape(h, w, channels)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA (PIL's ``convert("RGBA")``)."""
    header = None
    idat, palette, trns = [], None, None
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = payload
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    width, height, depth, ctype_, _, _, interlace = header
    if ctype_ not in _CHANNELS:
        raise ValueError(f"PNG colour type {ctype_} does not exist")
    if depth not in _BIT_DEPTHS[ctype_]:
        raise ValueError(f"PNG colour type {ctype_} at bit depth {depth} is not valid")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace} does not exist")
    channels = _CHANNELS[ctype_]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = _samples(raw, width, height, channels, depth, interlace)
    if depth == 16:
        # Pillow: grayscale (I;16) clips at 255, the other types keep the
        # high byte; a tRNS key matches those values by its low byte
        eight = np.minimum(samples, 255) if ctype_ == 0 else samples >> 8
        samples = eight.astype(np.uint8)

    out = np.empty((height, width, 4), np.uint8)
    if ctype_ == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[: len(palette), :3] = palette
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            lut[: len(alpha), 3] = alpha
        return lut[samples[..., 0]]
    if ctype_ in (0, 4):
        gray = samples[..., 0]
        if depth < 8:
            scaled = gray * np.uint8(255 // ((1 << depth) - 1))
        else:
            scaled = gray
        out[..., :3] = scaled[..., None]
        out[..., 3] = samples[..., 1] if ctype_ == 4 else 255
        if ctype_ == 0 and trns is not None:
            # PIL holds the key against the samples it scaled to 8 bits:
            # a 1-bit key is scaled with them, a 2- or 4-bit key is not
            (key,) = struct.unpack(">H", trns[:2])
            key = key * 255 if depth == 1 else (key & 0xFF if depth == 16 else key)
            out[..., 3] = np.where(scaled == key, 0, 255)
        return out
    out[..., :channels] = samples
    if ctype_ == 2:
        out[..., 3] = 255
        if trns is not None:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            if depth == 16:
                key &= 0xFF
            out[..., 3] = np.where((samples == key).all(axis=-1), 0, 255)
    return out


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) uint8 -> PNG bytes (8-bit RGB or RGBA)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3 or 4) uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
