"""JPEG decoder in numpy (what the reference package gets from PIL).

``decode_jpeg`` returns (H, W, 4) uint8 RGBA equal to
``PIL.Image.open(...).convert("RGBA")``, whose JPEG reader is libjpeg-turbo
with its defaults: the accurate integer IDCT, fancy upsampling, the
fixed-point YCbCr table.  It reads baseline and extended-sequential Huffman
JPEGs (SOF0, SOF1) and progressive ones (SOF2: DC and AC first and
refinement scans, EOB runs), grey and YCbCr (or RGB, as libjpeg decides from
the JFIF and Adobe markers and the component ids), any sampling factors, and
restart intervals.  CMYK / YCCK, arithmetic coding, lossless and
hierarchical JPEGs and 12-bit samples raise ``ValueError`` naming them.

Three pieces make the output libjpeg-turbo's to the bit:
  * the IDCT is ``jidctint.c`` (jpeg_idct_islow): 13-bit fixed-point
    constants, the column pass descaled by 11 bits, the row pass by 18,
    then the range limit of a value taken modulo 1024;
  * chroma is upsampled as ``jdsample.c`` does: h2v1 and h2v2 "fancy"
    (triangle) filters with their alternating rounding biases (+1 / +2,
    +8 / +7) for components more than 2 samples wide, h1v2 with +1 / +2,
    edge samples repeated (the context rows above the first and below the
    last real row are copies of them), box replication otherwise;
  * YCbCr goes to RGB through ``jdcolor.c``'s tables: 16-bit fixed point,
    Cr_r = (FIX(1.402) x + 2^15) >> 16, Cb_b likewise, G from the sum of
    the scaled -0.34414 and -0.71414 terms shifted once.
Entropy decoding is a Python loop over the symbols with 16-bit lookup
tables, the rest numpy over every block at once: a 512x512 4:2:0 image at
quality 90 decodes in ~0.3-0.4 s of host time (0.28-0.43 s measured on an x86
CPU; ``tests/test_torch_textures.py::test_jpeg_decode_time`` prints it).
"""
from __future__ import annotations

import struct

import numpy as np

#: zig-zag position -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
#: as libjpeg's jpeg_natural_order: 16 extra entries keep a corrupt run in
#: the block
_ZZ = ZIGZAG.tolist() + [63] * 16
_UNSUPPORTED_SOF = {
    0xC3: "lossless JPEG (SOF3)", 0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded progressive JPEG (SOF10)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}


class _Huffman:
    """A DHT table as 16-bit lookup arrays: the symbol and the code length
    of every 16-bit window that starts with a code (length 0: no code)."""

    def __init__(self, counts, symbols):
        sym = np.zeros(1 << 16, np.int64)
        length = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for bits in range(1, 17):
            for _ in range(counts[bits - 1]):
                lo = code << (16 - bits)
                hi = (code + 1) << (16 - bits)
                if hi > 1 << 16:
                    raise ValueError("JPEG Huffman table is over-subscribed")
                sym[lo:hi] = symbols[k]
                length[lo:hi] = bits
                code += 1
                k += 1
            code <<= 1
        self.sym = sym.tolist()
        self.len = length.tolist()


class _Bits:
    """MSB-first reader over one restart interval's unstuffed bytes; reads
    past the end see zero bits (libjpeg fills a short segment with 0s)."""

    def __init__(self, data: bytes):
        self.buf = list(data) + [0, 0, 0, 0]
        self.pos = 0

    def peek16(self) -> int:
        b, buf = self.pos >> 3, self.buf
        if b + 2 >= len(buf):
            buf.extend([0] * (b + 3 - len(buf)))
        v = (buf[b] << 16) | (buf[b + 1] << 8) | buf[b + 2]
        return (v >> (8 - (self.pos & 7))) & 0xFFFF

    def bits(self, n: int) -> int:
        """The next n (<= 16) bits as an unsigned integer."""
        if n == 0:
            return 0
        if n > 16:
            raise ValueError(f"JPEG entropy data asks for a {n}-bit field")
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v

    def huff(self, table: _Huffman) -> int:
        p = self.peek16()
        n = table.len[p]
        if n == 0:
            raise ValueError("JPEG entropy data holds a code no Huffman table has")
        self.pos += n
        return table.sym[p]


def _extend(v: int, s: int) -> int:
    """The JPEG sign extension of an s-bit magnitude."""
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _segments(data: bytes, pos: int):
    """The entropy-coded bytes from `pos` up to the next marker that is not
    RSTn, split at RSTn and unstuffed; and the position of that marker."""
    parts, start, i, n = [], pos, pos, len(data)
    while True:
        i = data.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            raise ValueError("JPEG scan runs past the end of the file")
        nxt = data[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            i += 1 if nxt == 0xFF else 2
            continue
        parts.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            start = i = i + 2
            continue
        return parts, i


class _Frame:
    def __init__(self, sof: int, payload: bytes):
        precision, self.height, self.width, nc = struct.unpack_from(">BHHB", payload)
        if precision != 8:
            raise ValueError(f"{precision}-bit JPEG samples are not supported, only 8-bit")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG with a zero or DNL-defined size is not supported")
        self.progressive = sof == 0xC2
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for c in range(nc):
            cid, hv, tq = struct.unpack_from(">BBB", payload, 6 + 3 * c)
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        if nc not in (1, 3):
            raise ValueError(f"JPEG with {nc} components (CMYK / YCCK) is not supported")
        self.hmax, self.vmax = max(self.h), max(self.v)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        # each component's coefficients over the interleaved block grid
        self.coef = [np.zeros((self.mcuy * v, self.mcux * h, 64), np.int64)
                     for h, v in zip(self.h, self.v)]

    def comp_size(self, c):
        """A component's real width and height in samples."""
        return (-(-self.width * self.h[c] // self.hmax),
                -(-self.height * self.v[c] // self.vmax))


def _scan_blocks(frame: _Frame, comps):
    """The (component, block row, block column) of every block of a scan, in
    MCU order, grouped by MCU."""
    if len(comps) == 1:
        c = comps[0]
        w, h = frame.comp_size(c)
        return [[(c, by, bx)] for by in range(-(-h // 8)) for bx in range(-(-w // 8))]
    mcus = []
    for my in range(frame.mcuy):
        for mx in range(frame.mcux):
            mcus.append([(c, my * frame.v[c] + y, mx * frame.h[c] + x)
                         for c in comps for y in range(frame.v[c]) for x in range(frame.h[c])])
    return mcus


def _decode_scan(frame, comps, dc_tabs, ac_tabs, ss, se, ah, al, parts, restart):
    mcus = _scan_blocks(frame, comps)
    per = restart if restart else len(mcus)
    coef = frame.coef
    for interval, start in enumerate(range(0, len(mcus), per)):
        if interval >= len(parts):
            raise ValueError("JPEG scan has fewer restart intervals than its MCUs need")
        bits = _Bits(parts[interval])
        pred = {c: 0 for c in comps}
        eobrun = 0
        for mcu in mcus[start:start + per]:
            for c, by, bx in mcu:
                blk = coef[c][by, bx]
                if not frame.progressive:
                    s = bits.huff(dc_tabs[c])
                    pred[c] += _extend(bits.bits(s), s)
                    blk[0] = pred[c]
                    ac, k = ac_tabs[c], 1
                    while k < 64:
                        rs = bits.huff(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[_ZZ[k]] = _extend(bits.bits(s), s)
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
                elif ss == 0:  # DC scans
                    if ah == 0:
                        s = bits.huff(dc_tabs[c])
                        pred[c] += _extend(bits.bits(s), s)
                        blk[0] = pred[c] << al
                    elif bits.bits(1):
                        blk[0] |= 1 << al
                elif ah == 0:  # AC first scan
                    if eobrun:
                        eobrun -= 1
                        continue
                    ac, k = ac_tabs[c], ss
                    while k <= se:
                        rs = bits.huff(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[_ZZ[k]] = _extend(bits.bits(s), s) << al
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = (1 << r) + bits.bits(r) - 1
                            break
                else:  # AC refinement (jdphuff.c decode_mcu_AC_refine)
                    p1, m1 = 1 << al, -1 << al
                    k = ss
                    if eobrun == 0:
                        ac = ac_tabs[c]
                        while k <= se:
                            rs = bits.huff(ac)
                            r, s = rs >> 4, rs & 15
                            if s:
                                s = p1 if bits.bits(1) else m1
                            elif r != 15:
                                eobrun = (1 << r) + bits.bits(r)
                                break
                            while k <= se:
                                z = _ZZ[k]
                                if blk[z] != 0:
                                    if bits.bits(1) and (blk[z] & p1) == 0:
                                        blk[z] += p1 if blk[z] >= 0 else m1
                                else:
                                    r -= 1
                                    if r < 0:
                                        break
                                k += 1
                            if s:
                                blk[_ZZ[k]] = s
                            k += 1
                    if eobrun > 0:
                        while k <= se:
                            z = _ZZ[k]
                            if blk[z] != 0 and bits.bits(1) and (blk[z] & p1) == 0:
                                blk[z] += p1 if blk[z] >= 0 else m1
                            k += 1
                        eobrun -= 1


def idct_islow(coef, qt):
    """jidctint.c's jpeg_idct_islow of (N, 64) natural-order coefficients
    with their (N, 64) quantisation values: (N, 8, 8) uint8 samples."""
    c13, p1 = 13, 2

    def butterfly(s0, s1, s2, s3, s4, s5, s6, s7, shift):
        z1 = (s2 + s6) * 4433  # FIX(0.541196100)
        tmp2 = z1 + s6 * -15137  # FIX(1.847759065)
        tmp3 = z1 + s2 * 6270  # FIX(0.765366865)
        tmp0 = (s0 + s4) << c13
        tmp1 = (s0 - s4) << c13
        t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        o0, o1, o2, o3 = s7, s5, s3, s1
        z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
        z5 = (z3 + z4) * 9633  # FIX(1.175875602)
        # FIX(0.298631336), FIX(2.053119869), FIX(3.072711026), FIX(1.501321110)
        o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
        z1, z2 = z1 * -7373, z2 * -20995  # FIX(0.899976223), FIX(2.562915447)
        z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5  # FIX(1.961570560), FIX(0.390180644)
        o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
        half = 1 << (shift - 1)
        return [(x + half) >> shift for x in (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                                              t13 - o0, t12 - o1, t11 - o2, t10 - o3)]

    x = (coef.astype(np.int64) * qt).reshape(-1, 8, 8)  # [block, row u, column v]
    cols = butterfly(*[x[:, u, :] for u in range(8)], c13 - p1)  # 8 x (N, 8 columns)
    ws = np.stack(cols, axis=1)  # [block, y, v]
    rows = butterfly(*[ws[:, :, v] for v in range(8)], c13 + p1 + 3)  # 8 x (N, 8 rows)
    out = np.stack(rows, axis=2)  # [block, y, x]
    out = ((out + 512) & 1023) - 512  # the range-limit table's index, mod 1024
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _fancy_h2(s, dw):
    """h2v1 fancy upsampling of (rows, width) samples whose real width is dw
    (> 2): (3 * near + far + 1 or + 2) >> 2, edge samples repeated."""
    s = s[:, :dw].astype(np.int64)
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    out = np.empty((s.shape[0], 2 * dw), np.int64)
    out[:, 0::2] = (3 * s + left + 1) >> 2
    out[:, 1::2] = (3 * s + right + 2) >> 2
    return out


def _upsample(plane, fx, fy, dw, dh):
    """A component plane (padded) upsampled by (fx, fy) as jdsample.c does;
    dw, dh: its real size in samples."""
    p = plane[:dh].astype(np.int64)
    if fx == 1 and fy == 1:
        return p
    if (fx, fy) == (2, 1) and dw > 2:
        return _fancy_h2(p, dw)
    if (fx, fy) in ((2, 2), (1, 2)) and (fx == 1 or dw > 2):
        above = np.concatenate([p[:1], p[:-1]], axis=0)
        below = np.concatenate([p[1:], p[-1:]], axis=0)
        if fx == 1:
            out = np.empty((2 * dh, p.shape[1]), np.int64)
            out[0::2] = (3 * p + above + 1) >> 2
            out[1::2] = (3 * p + below + 2) >> 2
            return out
        out = np.empty((2 * dh, 2 * dw), np.int64)
        for v, near in ((0, above), (1, below)):
            cs = (3 * p + near)[:, :dw]  # column sums
            lc = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            rc = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * cs + lc + 8) >> 4
            out[v::2, 1::2] = (3 * cs + rc + 7) >> 4
        return out
    return np.repeat(np.repeat(plane.astype(np.int64), fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: its integer tables, evaluated directly."""
    one_half, sb = 1 << 15, 16
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((91881 * x_cr + one_half) >> sb)  # FIX(1.40200)
    b = y + ((116130 * x_cb + one_half) >> sb)  # FIX(1.77200)
    g = y + ((-22554 * x_cb + one_half - 46802 * x_cr) >> sb)  # FIX(0.34414), FIX(0.71414)
    return np.stack([np.clip(c, 0, 255) for c in (r, g, b)], axis=-1).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA (PIL's ``convert("RGBA")``)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qts, dcs, acs = {}, {}, {}
    frame, restart, jfif, adobe = None, 0, False, None
    pos = 2
    while True:
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError("JPEG ends without an EOI marker")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if marker == 0xFF:  # a fill byte before the marker
            pos += 1
            continue
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        (length,) = struct.unpack_from(">H", data, pos + 2)
        payload = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1, 0xC2):
            frame = _Frame(marker, payload)
        elif marker in _UNSUPPORTED_SOF or marker == 0xCC:
            raise ValueError(f"{_UNSUPPORTED_SOF.get(marker, 'arithmetic-coded JPEG (DAC)')} "
                             "is not supported")
        elif marker == 0xDB:
            i = 0
            while i < len(payload):
                pq, tq = payload[i] >> 4, payload[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(payload[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                qts[tq] = np.zeros(64, np.int64)
                qts[tq][ZIGZAG] = vals
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(payload):
                tc, th = payload[i] >> 4, payload[i] & 15
                counts = list(payload[i + 1:i + 17])
                syms = list(payload[i + 17:i + 17 + sum(counts)])
                (acs if tc else dcs)[th] = _Huffman(counts, syms)
                i += 17 + sum(counts)
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", payload)
        elif marker == 0xE0 and payload[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and payload[:5] == b"Adobe":
            adobe = payload[11] if len(payload) >= 12 else 0
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = payload[0]
            comps, dc_tabs, ac_tabs = [], {}, {}
            for k in range(ns):
                cid, t = payload[1 + 2 * k], payload[2 + 2 * k]
                c = frame.ids.index(cid)
                comps.append(c)
                dc_tabs[c], ac_tabs[c] = dcs.get(t >> 4), acs.get(t & 15)
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            parts, pos = _segments(data, pos)
            _decode_scan(frame, comps, dc_tabs, ac_tabs, ss, se, a >> 4, a & 15, parts, restart)
    if frame is None:
        raise ValueError("JPEG without a frame header")

    planes = []
    for c in range(len(frame.ids)):
        co = frame.coef[c]
        by, bx = co.shape[:2]
        px = idct_islow(co.reshape(-1, 64), qts[frame.tq[c]][None, :])
        plane = px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        dw, dh = frame.comp_size(c)
        up = _upsample(plane, frame.hmax // frame.h[c], frame.vmax // frame.v[c], dw, dh)
        planes.append(up[:frame.height, :frame.width])
    out = np.empty((frame.height, frame.width, 4), np.uint8)
    out[..., 3] = 255
    if len(planes) == 1:
        out[..., :3] = planes[0][..., None]
        return out
    # libjpeg's jpeg_color_space for three components (jdapimin.c)
    ids = frame.ids
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == [82, 71, 66]  # 'R', 'G', 'B'
    out[..., :3] = (np.stack(planes, axis=-1) if rgb else _ycc_to_rgb(*planes))
    return out
