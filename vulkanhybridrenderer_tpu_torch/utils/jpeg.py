"""JPEG decoder in numpy (what the reference package gets from PIL).

``decode_jpeg`` returns (H, W, 4) uint8 RGBA equal to
``PIL.Image.open(...).convert("RGBA")``, whose JPEG reader is libjpeg-turbo
with its defaults: the accurate integer IDCT, fancy upsampling, the
fixed-point YCbCr table.  It reads every 8-bit kind that reader decodes:
  * DCT frames, Huffman-coded (SOF0 baseline, SOF1 extended sequential,
    SOF2 progressive: DC and AC first and refinement scans, EOB runs) or
    arithmetic-coded (SOF9 sequential, SOF10 progressive: the QM-coder of
    ITU-T T.81 Annex D with the statistics and conditioning of F.1.4 and
    G.1.3, DAC segments or their defaults L = 0, U = 1, Kx = 5);
  * lossless frames (SOF3, Huffman): predictors 1-7, the point transform,
    the 1-D predictor on the first row of the scan and of each restart
    interval (T.81 H.1.2.1);
  * one, three or four components with any sampling factors, and restart
    intervals.
Colour follows libjpeg's reading of the JFIF and Adobe markers and the
component ids: grey; YCbCr or RGB; CMYK or YCCK (Adobe transform other than
0), which libjpeg turns into CMYK.  PIL takes four-component data as
Adobe-inverted CMYK whatever the markers say (its rawmode "CMYK;I") and
converts it as ``Convert.c``'s cmyk2rgb: with k' = 255 - K each of R, G, B
is k' - (x k' + 128 + ((x k' + 128) >> 8)) >> 8 of its inverted sample x.
In lossless mode libjpeg converts no colour and upsamples by replication
(its block size is one sample), so there YCbCr and YCCK frames raise.
Raised as ``ValueError``, as PIL refuses them: samples of any precision
other than 8 bits (DCT or lossless), hierarchical frames (SOF5-7, SOF13-15),
arithmetic-coded lossless frames (SOF11), a DNL-defined height, two
components, and a lossless restart interval that is not a whole number of
MCU rows.

Three pieces make the output libjpeg-turbo's to the bit:
  * the IDCT is ``jidctint.c`` (jpeg_idct_islow): 13-bit fixed-point
    constants, the column pass descaled by 11 bits, the row pass by 18,
    then clamped to 0-255 as libjpeg-turbo's SIMD version of it (the one
    PIL runs on x86-64) saturates; the C version's range-limit table
    wraps a value more than 384 outside the range instead, which only
    corrupt data reaches;
  * chroma is upsampled as ``jdsample.c`` does: h2v1 and h2v2 "fancy"
    (triangle) filters with their alternating rounding biases (+1 / +2,
    +8 / +7) for components more than 2 samples wide, h1v2 with +1 / +2,
    edge samples repeated (the context rows above the first and below the
    last real row are copies of them), box replication otherwise;
  * YCbCr goes to RGB through ``jdcolor.c``'s tables: 16-bit fixed point,
    Cr_r = (FIX(1.402) x + 2^15) >> 16, Cb_b likewise, G from the sum of
    the scaled -0.34414 and -0.71414 terms shifted once.
Entropy decoding is a Python loop over the symbols (16-bit lookup tables
for Huffman codes, one call a binary decision for the QM-coder), the rest
numpy over every block at once: a 512x512 4:2:0 Huffman image at quality 90
decodes in ~0.3-0.4 s of host time (0.28-0.43 s measured on an x86 CPU;
``tests/test_torch_textures.py::test_jpeg_decode_time`` prints it).
"""
from __future__ import annotations

import dataclasses
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
_HUFFMAN_DCT_SOF = (0xC0, 0xC1, 0xC2)
_ARITHMETIC_DCT_SOF = (0xC9, 0xCA)
_UNSUPPORTED_SOF = {
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical JPEG (SOF6)",
    0xC7: "hierarchical lossless JPEG (SOF7)", 0xC8: "JPEG extension frame (JPG)",
    0xCB: "arithmetic-coded lossless JPEG (SOF11)", 0xCD: "hierarchical JPEG (SOF13)",
    0xCE: "hierarchical JPEG (SOF14)", 0xCF: "hierarchical lossless JPEG (SOF15)",
}
#: T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) of each
#: probability-estimation state; state 113 is the fixed one-half estimate
#: of the sign and refinement bits libjpeg codes with it
_QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
]
#: each state as libjpeg packs it: (Qe, Next_Index_LPS | Switch_MPS << 7,
#: Next_Index_MPS); a statistics bin holds a state index | MPS << 7
_QE = [(qe, nl | sw << 7, nm) for qe, nl, nm, sw in _QE_TABLE]
FIXED_BIN = 113
DC_STAT_BINS, AC_STAT_BINS = 64, 256


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
        self.arrays = sym, length


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


class _Arith:
    """The QM-coder's decoder over one restart interval's unstuffed bytes
    (jdarith.c's arith_decode: the C register holds the interval's base and
    the unread bits, CT counts them; past the end of the bytes it reads
    zeros, as libjpeg does once it meets a marker)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0
        self.a, self.c, self.ct = 0, 0, -16  # the first call reads 2 bytes

    def decode(self, st: list, i: int) -> int:
        """One binary decision with statistics bin st[i], which it updates."""
        a, c, ct = self.a, self.c, self.ct
        while a < 0x8000:  # renormalize, reading bytes as CT runs out
            ct -= 1
            if ct < 0:
                pos = self.pos
                c = (c << 8) | (self.data[pos] if pos < len(self.data) else 0)
                self.pos = pos + 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000  # two initial bytes read: A becomes 0x10000
            a <<= 1
        sv = st[i]
        qe, nl, nm = _QE[sv & 0x7F]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:  # conditional exchange: the MPS after all
                st[i] = (sv & 0x80) ^ nm
            else:
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:  # conditional exchange: the LPS after all
                st[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm
        self.a, self.c, self.ct = a, c, ct
        return sv >> 7


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
        self.lossless = sof == 0xC3
        self.arithmetic = sof in _ARITHMETIC_DCT_SOF
        self.progressive = sof in (0xC2, 0xCA)
        if precision != 8:
            kind = "lossless " if self.lossless else ""
            raise ValueError(f"{kind}{precision}-bit JPEG samples are not supported, only 8-bit")
        if self.height == 0 or self.width == 0:
            raise ValueError("JPEG with a zero or DNL-defined size is not supported")
        self.ids, self.h, self.v, self.tq = [], [], [], []
        for c in range(nc):
            cid, hv, tq = struct.unpack_from(">BBB", payload, 6 + 3 * c)
            self.ids.append(cid)
            self.h.append(hv >> 4)
            self.v.append(hv & 15)
            self.tq.append(tq)
        if nc not in (1, 3, 4):
            raise ValueError(f"JPEG with {nc} components is not supported")
        self.hmax, self.vmax = max(self.h), max(self.v)
        unit = 1 if self.lossless else 8  # samples a block side
        self.mcux = -(-self.width // (unit * self.hmax))
        self.mcuy = -(-self.height // (unit * self.vmax))
        # each component's coefficients (DCT) or sample differences
        # (lossless) over the interleaved block grid
        self.coef = [np.zeros((self.mcuy * v, self.mcux * h) + ((64,) if unit == 8 else ()),
                              np.int64) for h, v in zip(self.h, self.v)]
        self.samples = [None] * nc  # lossless: each component's samples

    def comp_size(self, c):
        """A component's real width and height in samples."""
        return (-(-self.width * self.h[c] // self.hmax),
                -(-self.height * self.v[c] // self.vmax))


def _scan_blocks(frame: _Frame, comps):
    """The (component, block row, block column) of every block of a scan
    (a sample in lossless frames), in MCU order, grouped by MCU."""
    if len(comps) == 1:
        c = comps[0]
        w, h = frame.comp_size(c)
        unit = 1 if frame.lossless else 8
        return [[(c, by, bx)] for by in range(-(-h // unit)) for bx in range(-(-w // unit))]
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


class _ArithError(Exception):
    """Corrupt arithmetic-coded data: libjpeg warns and decodes nothing
    more in the restart interval."""


def _decode_scan_arith(frame, comps, dc_tbl, ac_tbl, ss, se, ah, al, parts, restart, cond):
    """An arithmetic-coded DCT scan (jdarith.c): sequential scans decode DC
    and AC together (decode_mcu), progressive ones their first and
    refinement passes.  Statistics, DC predictions and contexts start at
    zero in every restart interval; a decoding error ends its interval, the
    rest of whose blocks keep what they hold, as libjpeg leaves them."""
    mcus = _scan_blocks(frame, comps)
    per = restart if restart else len(mcus)
    coef = frame.coef
    dc_l, dc_u, ac_k = cond
    seq = not frame.progressive
    fixed = [FIXED_BIN]
    for interval, start in enumerate(range(0, len(mcus), per)):
        if interval >= len(parts):
            raise ValueError("JPEG scan has fewer restart intervals than its MCUs need")
        dec = _Arith(parts[interval])
        decode = dec.decode
        dc_stats = {t: [0] * DC_STAT_BINS for t in {dc_tbl[c] for c in comps}}
        ac_stats = {t: [0] * AC_STAT_BINS for t in {ac_tbl[c] for c in comps}}
        last_dc = {c: 0 for c in comps}
        dc_ctx = {c: 0 for c in comps}
        try:
            for mcu in mcus[start:start + per]:
                for c, by, bx in mcu:
                    blk = coef[c][by, bx]
                    if seq or (ss == 0 and ah == 0):  # DC: Figure F.19
                        tbl = dc_tbl[c]
                        st = dc_stats[tbl]
                        s0 = dc_ctx[c]
                        if decode(st, s0) == 0:
                            dc_ctx[c] = 0
                        else:
                            sign = decode(st, s0 + 1)
                            i = s0 + 2 + sign
                            m = decode(st, i)
                            if m:
                                i = 20
                                while decode(st, i):
                                    m <<= 1
                                    if m == 0x8000:
                                        raise _ArithError
                                    i += 1
                            if m < (1 << dc_l[tbl]) >> 1:
                                dc_ctx[c] = 0
                            elif m > (1 << dc_u[tbl]) >> 1:
                                dc_ctx[c] = 12 + 4 * sign
                            else:
                                dc_ctx[c] = 4 + 4 * sign
                            v = m
                            i += 14
                            m >>= 1
                            while m:
                                if decode(st, i):
                                    v |= m
                                m >>= 1
                            v += 1
                            last_dc[c] = (last_dc[c] + (-v if sign else v)) & 0xFFFF
                        blk[0] = (((last_dc[c] << al) + 0x8000) & 0xFFFF) - 0x8000
                        if not seq:
                            continue
                    elif ss == 0:  # DC refinement: the next bit, fixed estimate
                        if decode(fixed, 0):
                            blk[0] |= 1 << al
                        continue
                    tbl = ac_tbl[c]
                    st = ac_stats[tbl]
                    k, kend = (1, 63) if seq else (ss, se)
                    if seq or ah == 0:  # AC first pass: Figure F.20
                        while k <= kend:
                            i = 3 * (k - 1)
                            if decode(st, i):  # EOB
                                break
                            while decode(st, i + 1) == 0:
                                i += 3
                                k += 1
                                if k > kend:
                                    raise _ArithError
                            sign = decode(fixed, 0)
                            i += 2
                            m = decode(st, i)
                            if m and decode(st, i):
                                m <<= 1
                                i = 189 if k <= ac_k[tbl] else 217
                                while decode(st, i):
                                    m <<= 1
                                    if m == 0x8000:
                                        raise _ArithError
                                    i += 1
                            v = m
                            i += 14
                            m >>= 1
                            while m:
                                if decode(st, i):
                                    v |= m
                                m >>= 1
                            v += 1
                            blk[_ZZ[k]] = (-v if sign else v) << al
                            k += 1
                    else:  # AC refinement: Figure G.10's decoder
                        p1, m1 = 1 << al, -1 << al
                        kex = se
                        while kex > 0 and blk[_ZZ[kex]] == 0:
                            kex -= 1
                        while k <= kend:
                            i = 3 * (k - 1)
                            if k > kex and decode(st, i):  # EOB
                                break
                            while True:
                                z = _ZZ[k]
                                if blk[z]:  # previously nonzero: a correction bit
                                    if decode(st, i + 2):
                                        blk[z] += m1 if blk[z] < 0 else p1
                                    break
                                if decode(st, i + 1):  # newly nonzero
                                    blk[z] = m1 if decode(fixed, 0) else p1
                                    break
                                i += 3
                                k += 1
                                if k > kend:
                                    raise _ArithError
                            k += 1
        except _ArithError:
            continue


def _difference_lookup(table: _Huffman):
    """Per 16-bit window of a lossless scan: the bits one whole difference
    takes (its code and magnitude bits) and its value; 0 bits where the two
    run past the window or the code is not valid (libjpeg's lookahead)."""
    w = np.arange(1 << 16)
    s, n = table.arrays
    # category 16 (32768) reads no magnitude bits; one past 16 is no category
    m = np.where(s >= 16, 0, s)
    t = n + m
    extra = (w >> np.clip(16 - t, 0, 16)) & ((1 << m) - 1)
    neg = (m > 0) & (extra < (1 << np.maximum(m - 1, 0)))
    value = np.where(s == 16, 32768, np.where(neg, extra - (1 << m) + 1, extra))
    return np.where((n > 0) & (s <= 16) & (t <= 16), t, 0).tolist(), value.tolist()


def _decode_scan_lossless(frame, comps, dc_tabs, pred, se, ah, pt, parts, restart):
    """A lossless scan (jdlhuff.c, jdlossls.c): each sample's difference
    (SSSS category 16 is 32768), then per component the prediction undone
    modulo 2^16 and the point transform, kept as the frame's samples.
    Restarts come every `restart` MCUs, a whole number of MCU rows; the
    first row of the scan and of each interval takes the 1-D predictor and
    2^(7 - Pt) at its first sample."""
    if len(comps) == 1:
        w, h = frame.comp_size(comps[0])
        units, mcus_per_row, n_mcus = [(comps[0], 1, 1)], w, w * h
    else:  # (component, its rows and columns of samples in one MCU)
        units = [(c, frame.v[c], frame.h[c]) for c in comps]
        mcus_per_row, n_mcus = frame.mcux, frame.mcux * frame.mcuy
    if restart and restart % mcus_per_row:
        raise ValueError(f"lossless JPEG restart interval {restart} is not a whole number "
                         f"of MCU rows ({mcus_per_row} MCUs)")
    if not 1 <= pred <= 7 or se != 0 or ah != 0 or pt >= 8:
        raise ValueError(f"lossless JPEG scan with predictor {pred}, Se {se}, Ah {ah}, Pt {pt} "
                         "is not valid")
    if any(dc_tabs[c] is None for c in comps):
        raise ValueError("JPEG scan names a Huffman table it does not define")
    tabs = {id(t): t for t in dc_tabs.values()}
    lookups = {k: _difference_lookup(t) for k, t in tabs.items()}
    # one (bits, value, table) a sample of the MCU, in MCU order
    slots = [lookups[id(dc_tabs[c])] + (dc_tabs[c],) for c, ny, nx in units
             for _ in range(ny * nx)]
    per = restart if restart else n_mcus
    vals, i = [0] * (n_mcus * len(slots)), 0
    for interval, start in enumerate(range(0, n_mcus, per)):
        if interval >= len(parts):
            raise ValueError("JPEG scan has fewer restart intervals than its MCUs need")
        bits = _Bits(parts[interval])
        buf, pos = bits.buf, 0
        nbuf = len(buf)
        for _ in range(min(per, n_mcus - start)):
            for tot, dif, tab in slots:
                b = pos >> 3
                if b + 2 < nbuf:
                    v = ((buf[b] << 16 | buf[b + 1] << 8 | buf[b + 2]) >> (8 - (pos & 7))) & 0xFFFF
                    t = tot[v]
                    if t:
                        vals[i] = dif[v]
                        pos += t
                        i += 1
                        continue
                # near the end of the bytes, a long magnitude, or a bad code
                bits.pos = pos
                s = bits.huff(tab)
                vals[i] = 32768 if s == 16 else _extend(bits.bits(s), s)
                pos = bits.pos
                i += 1
    vals = np.array(vals, np.int64).reshape(n_mcus, len(slots))
    diff = frame.coef
    if len(comps) == 1:
        diff[comps[0]][:h, :w] = vals.reshape(h, w)
    else:
        j = 0
        for c, ny, nx in units:
            diff[c][...] = (vals[:, j:j + ny * nx].reshape(frame.mcuy, frame.mcux, ny, nx)
                            .transpose(0, 2, 1, 3).reshape(frame.mcuy * ny, frame.mcux * nx))
            j += ny * nx
    rows_per_interval = restart // mcus_per_row if restart else 0
    for c in comps:
        w, h = frame.comp_size(c)
        v = 1 if len(comps) == 1 else frame.v[c]
        first = np.zeros(h, bool)
        first[0] = True
        if rows_per_interval:
            first[::v * rows_per_interval] = True
        out = _undo_prediction(pred, diff[c][:h, :w], pt, first)
        frame.samples[c] = (out << pt) & 0xFF


def _undo_prediction(pred, d, pt, first):
    """The samples, modulo 2^16 as libjpeg stores them, of an (H, W) plane
    of differences.  A row where `first` is set takes the 1-D predictor (Ra,
    the first sample from 2^(P - Pt - 1)); every other row's first sample is
    predicted from the sample above (Rb), the rest by predictor `pred` (Ra
    left, Rb above, Rc above left)."""
    h, w = d.shape
    out = np.zeros((h, w), np.int64)
    for r in np.flatnonzero(first):
        row = d[r].copy()
        row[0] += 1 << (8 - pt - 1)
        out[r] = np.cumsum(row) & 0xFFFF
    for r in np.flatnonzero(~first):
        up = out[r - 1]
        out[r, 0] = (d[r, 0] + up[0]) & 0xFFFF
        rb, rc = up[1:], up[:-1]
        if pred == 2:
            out[r, 1:] = (d[r, 1:] + rb) & 0xFFFF
        elif pred == 3:
            out[r, 1:] = (d[r, 1:] + rc) & 0xFFFF
        elif pred in (1, 4, 5):  # Ra plus a term from the row above: a running sum
            step = d[r, 1:] + (0 if pred == 1 else rb - rc if pred == 4 else (rb - rc) >> 1)
            out[r, 1:] = (out[r, 0] + np.cumsum(step)) & 0xFFFF
    if pred in (6, 7) and w > 1:
        # Ra sits inside a halving, so no running sum: (r, x) needs (r, x-1),
        # (r-1, x) and (r-1, x-1), so every sample of one anti-diagonal
        # r + x = k is computed at once, k rising; the 1-D rows and column 0
        # are known already
        o, dd = out.reshape(-1), d.reshape(-1)
        for k in range(2, h + w - 1):
            x = np.arange(max(1, k - h + 1), min(k, w - 1) + 1)
            r = k - x
            keep = ~first[r]
            idx = (r * w + x)[keep]
            ra, rb, rc = o[idx - 1], o[idx - w], o[idx - w - 1]
            p = rb + ((ra - rc) >> 1) if pred == 6 else (ra + rb) >> 1
            o[idx] = (dd[idx] + p) & 0xFFFF
    return out


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
    return _replicate(plane, fx, fy)


def _replicate(plane, fx, fy):
    """Box upsampling: each sample repeated fx x fy times."""
    return np.repeat(np.repeat(plane.astype(np.int64), fy, axis=0), fx, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: its integer tables, evaluated directly."""
    one_half, sb = 1 << 15, 16
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((91881 * x_cr + one_half) >> sb)  # FIX(1.40200)
    b = y + ((116130 * x_cb + one_half) >> sb)  # FIX(1.77200)
    g = y + ((-22554 * x_cb + one_half - 46802 * x_cr) >> sb)  # FIX(0.34414), FIX(0.71414)
    return np.stack([np.clip(c, 0, 255) for c in (r, g, b)], axis=-1).astype(np.uint8)


def _cmyk_to_rgb(c, m, y, k):
    """PIL's reading of four samples: inverted ("CMYK;I"), then
    Convert.c's cmyk2rgb, nk - MULDIV255(255 - s, nk) with nk = 255 minus
    the inverted K, which is the K sample itself."""
    nk = k.astype(np.int64)

    def channel(s):
        t = (255 - s.astype(np.int64)) * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)

    return np.stack([channel(c), channel(m), channel(y)], axis=-1).astype(np.uint8)


@dataclasses.dataclass
class _Decoded:
    """A JPEG read up to its samples: the frame (coefficients of DCT frames,
    samples of lossless ones), the quantisation tables (natural order), the
    JFIF / Adobe markers libjpeg reads colour from."""
    frame: _Frame
    qts: dict
    jfif: bool
    adobe: int | None


def _read(data: bytes) -> _Decoded:
    """Every marker segment and scan of `data`, entropy-decoded."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qts, dcs, acs = {}, {}, {}
    # arithmetic conditioning (DAC) per table: DC L and U, AC Kx
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
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
        if marker in _HUFFMAN_DCT_SOF or marker in _ARITHMETIC_DCT_SOF or marker == 0xC3:
            frame = _Frame(marker, payload)
        elif marker in _UNSUPPORTED_SOF:
            raise ValueError(f"{_UNSUPPORTED_SOF[marker]} is not supported")
        elif marker == 0xDC:
            raise ValueError("JPEG with a DNL-defined height is not supported")
        elif marker == 0xCC:
            for i in range(0, len(payload) - 1, 2):
                t, val = payload[i], payload[i + 1]
                if t >= 32:
                    raise ValueError(f"JPEG DAC table index {t} is out of range")
                if t >= 16:
                    ac_k[t - 16] = val
                else:
                    dc_l[t], dc_u[t] = val & 15, val >> 4
                    if dc_l[t] > dc_u[t]:
                        raise ValueError(f"JPEG DAC conditioning value {val:#x} has L > U")
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
        elif marker == 0xE0 and payload[:5] == b"JFIF\x00" and len(payload) >= 14:
            jfif = True
        elif marker == 0xEE and payload[:5] == b"Adobe" and len(payload) >= 12:
            adobe = payload[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            ns = payload[0]
            comps, td, ta = [], {}, {}
            for k in range(ns):
                cid, t = payload[1 + 2 * k], payload[2 + 2 * k]
                c = frame.ids.index(cid)
                comps.append(c)
                td[c], ta[c] = t >> 4, t & 15
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            parts, pos = _segments(data, pos)
            if frame.lossless:
                _decode_scan_lossless(frame, comps, {c: dcs.get(td[c]) for c in comps},
                                      ss, se, ah, al, parts, restart)
            elif frame.arithmetic:
                _decode_scan_arith(frame, comps, td, ta, ss, se, ah, al, parts, restart,
                                   (dc_l, dc_u, ac_k))
            else:
                _decode_scan(frame, comps, {c: dcs.get(td[c]) for c in comps},
                             {c: acs.get(ta[c]) for c in comps}, ss, se, ah, al, parts, restart)
    if frame is None:
        raise ValueError("JPEG without a frame header")
    return _Decoded(frame, qts, jfif, adobe)


def _colour_space(frame, jfif, adobe) -> str:
    """libjpeg's jpeg_color_space (jdapimin.c, libjpeg-turbo 3): "grey",
    "ycc", "rgb", "cmyk" or "ycck"."""
    n = len(frame.ids)
    if n == 1:
        return "grey"
    if n == 4:
        return "ycck" if adobe is not None and adobe != 0 else "cmyk"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    if frame.ids == [82, 71, 66]:  # 'R', 'G', 'B'
        return "rgb"
    # ids 1, 2, 3 or unknown: a DCT frame is taken as YCbCr, a lossless one as RGB
    return "rgb" if frame.lossless else "ycc"


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 4) uint8 RGBA (PIL's ``convert("RGBA")``)."""
    dec = _read(data)
    frame = dec.frame
    space = _colour_space(frame, dec.jfif, dec.adobe)
    if frame.lossless and space in ("ycc", "ycck"):
        raise ValueError(f"lossless JPEG in {space.upper()} is not supported (libjpeg converts "
                         "no colour in lossless mode)")
    planes = []
    for c in range(len(frame.ids)):
        dw, dh = frame.comp_size(c)
        fx, fy = frame.hmax // frame.h[c], frame.vmax // frame.v[c]
        if frame.lossless:
            if frame.samples[c] is None:
                raise ValueError("lossless JPEG component has no scan")
            up = _replicate(frame.samples[c], fx, fy)
        else:
            co = frame.coef[c]
            by, bx = co.shape[:2]
            px = idct_islow(co.reshape(-1, 64), dec.qts[frame.tq[c]][None, :])
            plane = px.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
            up = _upsample(plane, fx, fy, dw, dh)
        planes.append(up[:frame.height, :frame.width])
    out = np.empty((frame.height, frame.width, 4), np.uint8)
    out[..., 3] = 255
    if space == "grey":
        out[..., :3] = planes[0][..., None]
    elif space == "rgb":
        out[..., :3] = np.stack(planes, axis=-1)
    elif space == "ycc":
        out[..., :3] = _ycc_to_rgb(*planes)
    else:
        if space == "ycck":  # jdcolor.c's ycck_cmyk_convert: 255 - each RGB of YCC
            cmy = 255 - _ycc_to_rgb(*planes[:3]).astype(np.int64)
            planes = [cmy[..., 0], cmy[..., 1], cmy[..., 2], planes[3]]
        out[..., :3] = _cmyk_to_rgb(*planes)
    return out
