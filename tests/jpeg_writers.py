"""Writers of the JPEG kinds no encoder here produces, for the tests of the
port's decoder (``utils/jpeg.py``) and the fixtures of chip_smoke.py's "jpeg
kinds" phase:

* ``encode_baseline``: a small baseline (SOF0) encoder with a float DCT,
  the standard quantisation and Huffman tables of T.81 Annex K and any
  number of components (YCCK, CMYK, YCbCr, grey), box-averaged chroma;
* ``encode_lossless``: lossless (SOF3) frames with one Huffman table,
  predictors 1-7, a point transform, restarts and any sampling, written as
  T.81 H.1 and libjpeg read them (the 1-D predictor on the first row of the
  scan and of each restart interval);
* ``transcode_arith``: a Huffman DCT stream's quantised coefficients (read
  by the port's coefficient stage, ``utils.jpeg._read``) coded again with
  the QM-coder as SOF9, or SOF10 under a scan script, with optional DAC
  conditioning and restart interval: libjpeg's jcarith.c, written out.

None of them is judged by the decoder under test: the tests hold each
stream's Pillow decode to what its writer meant (the source samples, or
the Huffman original's pixels).  Run ``python tests/jpeg_writers.py`` to
rewrite ``tests/data/torch_jpeg/``: the fixture streams and, beside each,
Pillow's ``convert("RGBA")`` of it as ``.npy`` (needs Pillow);
``python tests/jpeg_writers.py --time 1024`` times the port's decode of each
kind at 1024x1024 (and Pillow's, where it is installed).
"""
from __future__ import annotations

import struct
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from vulkanhybridrenderer_tpu_torch.utils import jpeg  # noqa: E402

FIXTURE_DIR = Path(__file__).resolve().parent / "data" / "torch_jpeg"

ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
          12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
          35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
          58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
#: T.81 K.3: (code counts by length, symbols) of the standard tables,
#: luminance (0) and chrominance (1)
STD_DC = {
    0: ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    1: ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
}
STD_AC = {
    0: ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    1: ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}
#: T.81 K.1: the luminance and chrominance quantisation tables, row-major
STD_QUANT = {
    0: [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    1: [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32,
}
#: lossless: one table with every SSSS category 0-16 (Kraft sum < 1)
LOSSLESS_COUNTS = [0, 0, 6, 2, 2, 2, 2, 3] + [0] * 8
LOSSLESS_SYMBOLS = bytes(range(17))


def segment(marker: int, payload: bytes) -> bytes:
    return b"\xff" + bytes([marker]) + struct.pack(">H", len(payload) + 2) + payload


JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    """An Adobe APP14 segment with the given colour transform."""
    return segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


def huffman_codes(counts, symbols) -> dict:
    """symbol -> (code, length) of a canonical table."""
    codes, code, k = {}, 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            codes[symbols[k]] = (code, bits)
            code += 1
            k += 1
        code <<= 1
    return codes


class BitWriter:
    """MSB-first bits with 0xFF bytes stuffed; padded with 1 bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _category(v: int):
    """(SSSS, the low SSSS bits) of a difference or coefficient."""
    s = abs(v).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1) & ((1 << s) - 1)


def mcu_blocks(width, height, sampling, comps, unit):
    """(component, block row, block column) of a scan's blocks (samples
    when unit is 1), in MCU order, grouped by MCU: T.81 A.2."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if len(comps) == 1:
        h, v = sampling[comps[0]]
        cw = -(-(-(-width * h // hmax)) // unit)
        ch = -(-(-(-height * v // vmax)) // unit)
        return [[(comps[0], by, bx)] for by in range(ch) for bx in range(cw)]
    mx_n, my_n = -(-width // (unit * hmax)), -(-height // (unit * vmax))
    return [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x)
             for c in comps for y in range(sampling[c][1]) for x in range(sampling[c][0])]
            for my in range(my_n) for mx in range(mx_n)]


def _component_planes(planes, sampling, unit):
    """Full-resolution planes box-averaged to their components' sizes and
    padded by edge replication to whole MCUs."""
    height, width = planes[0].shape
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mx_n, my_n = -(-width // (unit * hmax)), -(-height // (unit * vmax))
    out = []
    for p, (h, v) in zip(planes, sampling):
        fx, fy = hmax // h, vmax // v
        a = np.pad(p.astype(np.float64), ((0, (-height) % fy), (0, (-width) % fx)), mode="edge")
        a = a.reshape(a.shape[0] // fy, fy, a.shape[1] // fx, fx).mean(axis=(1, 3))
        a = np.floor(a + 0.5)
        out.append(np.pad(a, ((0, my_n * v * unit - a.shape[0]),
                              (0, mx_n * h * unit - a.shape[1])), mode="edge"))
    return out


def quant_table(table: int, quality: int) -> np.ndarray:
    """libjpeg's scaling of a K.1 table to `quality`, row-major."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = (np.array(STD_QUANT[table], np.int64) * scale + 50) // 100
    return np.clip(q, 1, 255)


_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def encode_baseline(planes, sampling=None, quality=90, app=b"", restart=0, ids=None) -> bytes:
    """A baseline JPEG of full-resolution (H, W) uint8 planes, one per
    component in frame order: components 0 and 3 take the luminance
    tables, 1 and 2 the chrominance ones.  The DCT is float; a quantised
    value is rounded half up after rounding to 6 decimals, so that float
    noise cannot move it."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    height, width = planes[0].shape
    tab = [0 if c in (0, 3) else 1 for c in range(n)]
    qts = {t: quant_table(t, quality) for t in set(tab)}
    comp = _component_planes(planes, sampling, 8)
    coef = []
    for c, p in enumerate(comp):
        blocks = (p - 128.0).reshape(p.shape[0] // 8, 8, p.shape[1] // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,abxy,vy->abuv", _DCT, blocks, _DCT)
        q = qts[tab[c]].reshape(8, 8)
        coef.append(np.floor(np.round(f / q, 6) + 0.5).astype(np.int64))
    dc = {t: huffman_codes(*STD_DC[t]) for t in set(tab)}
    ac = {t: huffman_codes(*STD_AC[t]) for t in set(tab)}
    out = bytearray(b"\xff\xd8") + app
    for t in sorted(qts):
        out += segment(0xDB, bytes([t]) + bytes(qts[t].reshape(-1)[ZIGZAG].tolist()))
    out += segment(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], tab[c]]) for c in range(n)))
    for t in sorted(set(tab)):
        out += segment(0xC4, bytes([t]) + bytes(STD_DC[t][0]) + STD_DC[t][1])
        out += segment(0xC4, bytes([0x10 | t]) + bytes(STD_AC[t][0]) + STD_AC[t][1])
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([n]) + b"".join(bytes([ids[c], tab[c] * 0x11]) for c in range(n))
                   + bytes([0, 63, 0]))
    mcus = mcu_blocks(width, height, sampling, list(range(n)), 8)
    bits, pred = BitWriter(), [0] * n
    for k, mcu in enumerate(mcus):
        if restart and k and k % restart == 0:
            out += bits.flush() + bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
            bits, pred = BitWriter(), [0] * n
        for c, by, bx in mcu:
            blk = coef[c][by, bx].reshape(-1)[ZIGZAG]
            s, v = _category(int(blk[0]) - pred[c])
            pred[c] = int(blk[0])
            bits.put(*dc[tab[c]][s])
            bits.put(v, s)
            run = 0
            for z in blk[1:].tolist():
                if z == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac[tab[c]][0xF0])
                    run -= 16
                s, v = _category(z)
                bits.put(*ac[tab[c]][(run << 4) | s])
                bits.put(v, s)
                run = 0
            if run:
                bits.put(*ac[tab[c]][0x00])
    out += bits.flush() + b"\xff\xd9"
    return bytes(out)


def _predict(sel, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[sel]


def encode_lossless(planes, predictor=1, pt=0, restart=0, ids=None, app=b"", sampling=None,
                    precision=8, sof=0xC3) -> bytes:
    """A lossless JPEG of (H, W) uint8 planes at their components'
    resolutions (sampling: (h, v) per component; the frame's height and
    width are those of the components at the largest factors), one
    interleaved scan (a single component: one non-interleaved
    scan).  Samples are shifted right by the point transform `pt`.  The
    restart interval counts MCUs and should be a whole number of MCU rows,
    as libjpeg requires.  `precision` and `sof` are written as given, for
    streams a reader must refuse."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height = max(p.shape[0] for p, (_, v) in zip(planes, sampling) if v == vmax)
    width = max(p.shape[1] for p, (h, _) in zip(planes, sampling) if h == hmax)
    codes = huffman_codes(LOSSLESS_COUNTS, LOSSLESS_SYMBOLS)
    out = bytearray(b"\xff\xd8") + app
    out += segment(sof, struct.pack(">BHHB", precision, height, width, n) + b"".join(
        bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0]) for c in range(n)))
    out += segment(0xC4, bytes([0]) + bytes(LOSSLESS_COUNTS) + LOSSLESS_SYMBOLS)
    if restart:
        out += segment(0xDD, struct.pack(">H", restart))
    out += segment(0xDA, bytes([n]) + b"".join(bytes([ids[c], 0]) for c in range(n))
                   + bytes([predictor, 0, pt]))
    mcus = mcu_blocks(width, height, sampling, list(range(n)), 1)
    per_row = (planes[0].shape[1] if n == 1 else -(-width // hmax))
    rows_per_interval = restart // per_row if restart else 0
    init = 1 << (precision - pt - 1)
    diffs = []
    for c in range(n):
        a = planes[c].astype(np.int64) >> pt
        v = 1 if n == 1 else sampling[c][1]
        d = np.zeros_like(a)
        for r in range(a.shape[0]):
            first = r == 0 or (rows_per_interval and r % v == 0
                               and (r // v) % rows_per_interval == 0)
            for x in range(a.shape[1]):
                if first:
                    p = init if x == 0 else a[r, x - 1]
                elif x == 0:
                    p = a[r - 1, 0]
                else:
                    p = _predict(predictor, int(a[r, x - 1]), int(a[r - 1, x]),
                                 int(a[r - 1, x - 1]))
                d[r, x] = (int(a[r, x]) - p) & 0xFFFF
        diffs.append(d)
    bits = BitWriter()
    for k, mcu in enumerate(mcus):
        if restart and k and k % restart == 0:
            out += bits.flush() + bytes([0xFF, 0xD0 + (k // restart - 1) % 8])
            bits = BitWriter()
        for c, y, x in mcu:
            d = diffs[c]
            # samples past a component's edge (whole MCUs) repeat its last
            diff = int(d[min(y, d.shape[0] - 1), min(x, d.shape[1] - 1)])
            diff = diff - 65536 if diff >= 32768 else diff
            s, v = _category(diff)
            bits.put(*codes[s])
            if 0 < s < 16:
                bits.put(v, s)
    out += bits.flush() + b"\xff\xd9"
    return bytes(out)


class ArithEncoder:
    """The QM-coder's encoder (jcarith.c's arith_encode and finish_pass):
    the C register with 3 spacer bits, CT counting to the next byte, a
    pending byte and counts of stacked 0x00 / 0xFF bytes for the carry."""

    def __init__(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1
        self.out = bytearray()

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b: int):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _carry(self):
        """A carry into the pending byte: it goes out plus one, and the
        stacked 0xFF bytes become 0x00."""
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):
        """No carry can reach the pending byte or the stacked 0xFF any more."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe, nl, nm = jpeg._QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the LPS, or the MPS by conditional exchange
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalize, a byte out every 8 shifts
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        """T.81 D.1.8: the C in the interval with the most trailing zeros,
        then the bytes still held; final 0x00 bytes are left out."""
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _value(enc, st, i, v, chain):
    """Figures F.6-F.9 after the sign: v > 0 coded as v - 1's magnitude
    category from bin i (a chain from bin `chain`, for AC only after a
    second decision in bin i) and its low bits from 14 bins on."""
    v -= 1
    m = 0
    if v:
        enc.encode(st, i, 1)
        m = 1
        v2 = v >> 1
        if chain == 20:  # DC: the chain starts at once
            i = 20
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, i, 1)
            m <<= 1
            i = chain
            v2 >>= 1
            while v2:
                enc.encode(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
    enc.encode(st, i, 0)
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1


def _shifted(x: int, shift: int) -> int:
    """A coefficient's point transform: its magnitude shifted, sign kept."""
    return x >> shift if x >= 0 else -((-x) >> shift)


def encode_arith_scan(coef, mcus, td, ta, ss, se, ah, al, progressive, restart, cond) -> bytes:
    """One arithmetic-coded scan of natural-order coefficients (jcarith.c:
    encode_mcu for sequential scans, encode_mcu_DC_first / AC_first /
    DC_refine / AC_refine for progressive ones), RSTn between intervals."""
    dc_l, dc_u, ac_k = cond
    comps = sorted({c for mcu in mcus for c, _, _ in mcu})
    per = restart or len(mcus)
    out = bytearray()
    for interval, start in enumerate(range(0, len(mcus), per)):
        if interval:
            out += bytes([0xFF, 0xD0 + (interval - 1) % 8])
        enc, fixed = ArithEncoder(), [jpeg.FIXED_BIN]
        dc_stats = {td[c]: [0] * jpeg.DC_STAT_BINS for c in comps}
        ac_stats = {ta[c]: [0] * jpeg.AC_STAT_BINS for c in comps}
        last, ctx = {c: 0 for c in comps}, {c: 0 for c in comps}
        for mcu in mcus[start:start + per]:
            for c, by, bx in mcu:
                blk = coef[c][by, bx].tolist()
                zz = [blk[ZIGZAG[k]] for k in range(64)]
                if not progressive or (ss == 0 and ah == 0):
                    st, i = dc_stats[td[c]], ctx[c]
                    m = zz[0] >> al
                    v = m - last[c]
                    if v == 0:
                        enc.encode(st, i, 0)
                        ctx[c] = 0
                    else:
                        last[c] = m
                        enc.encode(st, i, 1)
                        sign = int(v < 0)
                        enc.encode(st, i + 1, sign)
                        mag = abs(v) - 1
                        cat = 1 << (mag.bit_length() - 1) if mag else 0
                        if cat < (1 << dc_l[td[c]]) >> 1:
                            ctx[c] = 0
                        elif cat > (1 << dc_u[td[c]]) >> 1:
                            ctx[c] = 12 + 4 * sign
                        else:
                            ctx[c] = 4 + 4 * sign
                        _value(enc, st, i + 2 + sign, abs(v), 20)
                    if progressive:
                        continue
                elif ss == 0:
                    enc.encode(fixed, 0, (zz[0] >> al) & 1)
                    continue
                st, t = ac_stats[ta[c]], ta[c]
                k0, kend = (1, 63) if not progressive else (ss, se)
                ke = kend
                while ke > 0 and _shifted(zz[ke], al) == 0:
                    ke -= 1
                k = k0
                if not progressive or ah == 0:
                    while k <= ke:
                        i = 3 * (k - 1)
                        enc.encode(st, i, 0)  # not EOB
                        while _shifted(zz[k], al) == 0:
                            enc.encode(st, i + 1, 0)
                            i += 3
                            k += 1
                        v = _shifted(zz[k], al)
                        enc.encode(st, i + 1, 1)
                        enc.encode(fixed, 0, int(v < 0))
                        _value(enc, st, i + 2, abs(v), 189 if k <= ac_k[t] else 217)
                        k += 1
                else:
                    kex = ke
                    while kex > 0 and _shifted(zz[kex], ah) == 0:
                        kex -= 1
                    while k <= ke:
                        i = 3 * (k - 1)
                        if k > kex:
                            enc.encode(st, i, 0)  # not EOB
                        while _shifted(zz[k], al) == 0:
                            enc.encode(st, i + 1, 0)
                            i += 3
                            k += 1
                        v = _shifted(zz[k], al)
                        if abs(v) >> 1:  # nonzero before: its next bit
                            enc.encode(st, i + 2, abs(v) & 1)
                        else:  # newly nonzero
                            enc.encode(st, i + 1, 1)
                            enc.encode(fixed, 0, int(v < 0))
                        k += 1
                if k <= kend:
                    enc.encode(st, 3 * (k - 1), 1)  # EOB
        out += enc.finish()
    return bytes(out)


def progressive_script(n: int):
    """libjpeg's jpeg_simple_progression: (components, Ss, Se, Ah, Al) of
    each scan, for 1 or 3 components."""
    if n == 1:
        return [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]
    return [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
            ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
            ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
            ([0], 1, 63, 1, 0)]


def transcode_arith(data: bytes, script=None, dac=None, restart=None) -> bytes:
    """A Huffman DCT JPEG coded again with the QM-coder: its segments kept
    but DHT, its SOF0 / SOF1 written as SOF9 and SOF2 as SOF10, each scan's
    coefficients re-encoded.  `script` ((components, Ss, Se, Ah, Al) per
    scan) makes a progressive SOF10 of any source; `dac` ({table index:
    value}, DC 0-15: U << 4 | L, AC 16-31: Kx) adds a DAC segment;
    `restart` replaces the restart interval (0: none)."""
    dec = jpeg._read(data)
    frame = dec.frame
    sampling = list(zip(frame.h, frame.v))
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for t, val in (dac or {}).items():
        if t >= 16:
            ac_k[t - 16] = val
        else:
            dc_l[t], dc_u[t] = val & 15, val >> 4
    progressive = frame.progressive or script is not None
    interval = 0
    out, scans = bytearray(b"\xff\xd8"), []
    pos = 2
    while data[pos + 1] != 0xD9:
        marker = data[pos + 1]
        (length,) = struct.unpack_from(">H", data, pos + 2)
        payload = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1, 0xC2):
            out += segment(0xCA if progressive else 0xC9, payload)
            if dac:
                out += segment(0xCC, b"".join(bytes([t, v]) for t, v in sorted(dac.items())))
            if restart is not None and restart:
                out += segment(0xDD, struct.pack(">H", restart))
        elif marker == 0xDD:
            (interval,) = struct.unpack(">H", payload)
            if restart is None:
                out += segment(marker, payload)
        elif marker == 0xDA:
            ns = payload[0]
            sel = {frame.ids.index(payload[1 + 2 * k]): payload[2 + 2 * k] for k in range(ns)}
            ss, se, a = payload[1 + 2 * ns:4 + 2 * ns]
            scans.append((list(sel), ss, se, a >> 4, a & 15, sel))
            _, pos = jpeg._segments(data, pos)
        elif marker != 0xC4:
            out += segment(marker, payload)
    if restart is not None:
        interval = restart
    sel = scans[0][5] if len(scans[0][5]) == len(frame.ids) else {
        c: (0x00 if c in (0, 3) else 0x11) for c in range(len(frame.ids))}
    if script is not None:
        scans = [(comps, ss, se, ah, al, {c: sel[c] for c in comps})
                 for comps, ss, se, ah, al in script]
    for comps, ss, se, ah, al, tsel in scans:
        out += segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([frame.ids[c], tsel[c]]) for c in comps) + bytes([ss, se, (ah << 4) | al]))
        mcus = mcu_blocks(frame.width, frame.height, sampling, comps, 8)
        out += encode_arith_scan(frame.coef, mcus, {c: tsel[c] >> 4 for c in comps},
                                 {c: tsel[c] & 15 for c in comps}, ss, se, ah, al,
                                 progressive, interval, (dc_l, dc_u, ac_k))
    return bytes(out + b"\xff\xd9")


def photo(h, w, channels, seed):
    """Smooth colour gradients plus noise: blocks with DC and AC energy."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 11.0 - k)
                     for k in range(channels)], -1)
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def ycc_planes(rgb):
    """JFIF's float RGB -> YCbCr of (H, W, 3) samples, rounded and clipped."""
    r, g, b = (rgb[..., k].astype(np.float64) for k in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return [np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8) for p in (y, cb, cr)]


def ycck_planes(cmyk):
    """The samples of a YCCK frame whose PIL reading is `cmyk` (PIL's
    inverted CMYK values): C, M, Y taken as R, G, B into YCbCr, K
    inverted."""
    return ycc_planes(cmyk[..., :3]) + [255 - cmyk[..., 3]]


def fixtures() -> dict:
    """The chip_smoke.py "jpeg kinds" streams by name (a few KB each),
    made from numpy alone."""
    colour = photo(40, 56, 3, seed=16)
    grey = photo(33, 47, 1, seed=17)[..., 0]
    cmyk = photo(36, 44, 4, seed=18)
    ycc = encode_baseline(ycc_planes(colour), [(2, 2), (1, 1), (1, 1)], quality=85, app=JFIF)
    return {
        "arith_seq_420_restart_dac": transcode_arith(ycc, dac={0: 0x31, 16: 2}, restart=3),
        "arith_prog_420": transcode_arith(ycc, script=progressive_script(3)),
        "lossless_grey_p7_pt1_restart": encode_lossless([grey], 7, 1, restart=47 * 4),
        "lossless_rgb_p4": encode_lossless(list(np.moveaxis(colour, -1, 0)), 4, app=adobe(0)),
        "lossless_cmyk_p6": encode_lossless(list(np.moveaxis(cmyk, -1, 0)), 6),
        "cmyk_adobe": encode_baseline([255 - cmyk[..., k] for k in range(4)], quality=90,
                                      app=adobe(0)),
        "cmyk_plain": encode_baseline([255 - cmyk[..., k] for k in range(4)], quality=90),
        "ycck_420": encode_baseline(ycck_planes(cmyk), [(2, 2), (1, 1), (1, 1), (2, 2)],
                                    quality=90, app=adobe(2), restart=2),
    }


def write_fixtures(directory: Path = FIXTURE_DIR):
    """Each fixture stream as <name>.jpg and Pillow's RGBA decode of it as
    <name>.npy."""
    import io

    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    for name, data in fixtures().items():
        (directory / f"{name}.jpg").write_bytes(data)
        np.save(directory / f"{name}.npy", np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))


def texture_streams(size: int) -> dict:
    """The fixture kinds at a texture's size (size x size pixels), and a
    Huffman 4:2:0 stream beside them (the path every other kind is compared
    with), by name."""
    colour = photo(size, size, 3, seed=16)
    grey = photo(size, size, 1, seed=17)[..., 0]
    cmyk = photo(size, size, 4, seed=18)
    ycc = encode_baseline(ycc_planes(colour), [(2, 2), (1, 1), (1, 1)], quality=85, app=JFIF)
    return {
        "huffman_420": ycc,
        "arith_seq_420_restart_dac": transcode_arith(ycc, dac={0: 0x31, 16: 2},
                                                     restart=size // 16),
        "arith_prog_420": transcode_arith(ycc, script=progressive_script(3)),
        "lossless_grey_p7_pt1_restart": encode_lossless([grey], 7, 1, restart=size * 32),
        "lossless_rgb_p4": encode_lossless(list(np.moveaxis(colour, -1, 0)), 4, app=adobe(0)),
        "lossless_cmyk_p6": encode_lossless(list(np.moveaxis(cmyk, -1, 0)), 6),
        "cmyk_adobe": encode_baseline([255 - cmyk[..., k] for k in range(4)], quality=90,
                                      app=adobe(0)),
        "ycck_420": encode_baseline(ycck_planes(cmyk), [(2, 2), (1, 1), (1, 1), (2, 2)],
                                    quality=90, app=adobe(2), restart=size // 16),
    }


def time_decodes(size: int) -> None:
    """Print the seconds `decode_jpeg` takes on each kind at size x size
    (one decode, this process's host), and Pillow's where Pillow is
    installed, with whether the two agree.  Pillow reads the stream in one
    block: fed in its default 65,536-byte blocks, libjpeg's arithmetic
    decoder, which cannot suspend, fails on a larger arithmetic-coded
    stream."""
    import time

    try:
        import io

        from PIL import Image
    except ImportError:
        Image = None
    for name, data in texture_streams(size).items():
        t = time.perf_counter()
        got = jpeg.decode_jpeg(data)
        port_s = time.perf_counter() - t
        line = f"{name} {size}x{size} ({len(data)} bytes): decode_jpeg {port_s:.3f} s"
        if Image is not None:
            t = time.perf_counter()
            im = Image.open(io.BytesIO(data))
            im.decodermaxblock = len(data)
            want = np.asarray(im.convert("RGBA"))
            line += (f", Pillow {time.perf_counter() - t:.4f} s, "
                     f"equal {bool(np.array_equal(got, want))}")
        print(line, flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", type=int, metavar="SIZE",
                    help="time decode_jpeg on each kind at SIZE x SIZE instead of "
                         "writing the fixtures")
    args = ap.parse_args()
    if args.time:
        time_decodes(args.time)
    else:
        write_fixtures()
        print(f"wrote {len(fixtures())} streams and their decodes to {FIXTURE_DIR}")
