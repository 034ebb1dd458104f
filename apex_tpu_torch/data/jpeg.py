"""The port's JPEG codec: what PIL computes for the JAX loader, bit for bit.

The JAX package decodes with PIL (libjpeg-turbo). The machine beside the
card has neither PIL nor torchvision, so the port carries its own codec,
held to libjpeg-turbo's output bit for bit:

- **decode** (:func:`decode`, :func:`read_rgb`): baseline and extended
  sequential Huffman JPEG (SOF0/SOF1), 8-bit, 1 or 3 components, sampling
  factors up to 2x2 (4:4:4, 4:2:2, 4:2:0, 4:4:0), restart intervals,
  the JFIF and Adobe colour-transform flags; APPn and COM segments are
  skipped. Progressive, arithmetic-coded, lossless, hierarchical, 12-bit
  and 4-component (CMYK/YCCK) files raise ``OSError`` naming the file and
  the marker, as PIL raises ``OSError`` for a file it cannot read. The
  stages, each a C++ call (``csrc/jpeg_entropy.cpp``, built with the host
  compiler at first use): Huffman decoding into int16 coefficients
  (:func:`read_coefficients`), libjpeg's ``JDCT_ISLOW`` integer IDCT
  (:func:`idct`), "fancy" upsampling and the fixed-point YCbCr->RGB
  tables (:func:`to_rgb`). Marker parsing and tables are here.
- **encode** (:func:`encode`): baseline files with the IJG tables scaled
  by quality and the standard Huffman tables, vectorised in numpy (colour
  transform, chroma averaging, a float DCT, quantisation, DC differences,
  AC run/size symbols, codes packed by offsets from a cumsum, byte
  stuffing, restart markers). Files need not equal PIL's byte for byte;
  PIL decodes them to the pixels :func:`decode` gives.

No fallback stands in for the C++ library: a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["Component", "Frame", "read_coefficients", "idct", "to_rgb",
           "pixels", "decode", "read_rgb", "encode", "quant_tables", "NATURAL",
           "STD_HUFFMAN"]


def _zigzag() -> np.ndarray:
    cells = [(x + y, y if (x + y) % 2 else -y, 8 * y + x)
             for y in range(8) for x in range(8)]
    return np.array([c[2] for c in sorted(cells)], np.int64)


#: zigzag position -> natural (row-major) index within an 8x8 block
NATURAL = _zigzag()

#: the IJG example quantisation tables (JPEG Annex K.1), natural order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
_CHROMA_Q = np.full(64, 99, np.int64)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]


def _ac_vals(rows: str) -> List[int]:
    return [int(v, 16) for v in rows.split()]


#: the standard Huffman tables (JPEG Annex K.3): (bits, values) for
#: DC luma, DC chroma, AC luma, AC chroma
STD_HUFFMAN = {
    "dc_luma": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
                list(range(12))),
    "dc_chroma": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                  list(range(12))),
    "ac_luma": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
                _ac_vals("""
        01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91
        a1 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a
        25 26 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53
        54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79
        7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5
        a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9
        ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2
        f3 f4 f5 f6 f7 f8 f9 fa""")),
    "ac_chroma": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                  _ac_vals("""
        00 01 02 03 11 04 05 21 31 06 12 41 51 07 61 71 13 22 32 81 08 14
        42 91 a1 b1 c1 09 23 33 52 f0 15 62 72 d1 0a 16 24 34 e1 25 f1 17
        18 19 1a 26 27 28 29 2a 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a
        53 54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78
        79 7a 82 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3
        a4 a5 a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7
        c8 c9 ca d2 d3 d4 d5 d6 d7 d8 d9 da e2 e3 e4 e5 e6 e7 e8 e9 ea f2
        f3 f4 f5 f6 f7 f8 f9 fa""")),
}

_SOF_NAMES = {0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
              0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical (SOF6)",
              0xC7: "hierarchical (SOF7)", 0xC8: "reserved (JPG)",
              0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded "
              "progressive (SOF10)", 0xCB: "arithmetic-coded lossless "
              "(SOF11)", 0xCC: "arithmetic-coding conditioning (DAC)",
              0xCD: "arithmetic-coded hierarchical (SOF13)",
              0xCE: "arithmetic-coded hierarchical (SOF14)",
              0xCF: "arithmetic-coded hierarchical (SOF15)"}


# --- the C++ library ----------------------------------------------------------

_LIB = [None]


def _lib():
    """The codec's host library, built at first use."""
    if _LIB[0] is None:
        from apex_tpu_torch.ops import _build
        lib = _build.load_host("jpeg_entropy")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.jpeg_decode_scan.argtypes = [p, i64, i64, i32, p, p, i32, i32,
                                         i32, p, p]
        lib.jpeg_decode_scan.restype = i32
        lib.jpeg_idct_islow.argtypes = [p, i64, i64, p, p]
        lib.jpeg_idct_islow.restype = None
        lib.jpeg_upsample.argtypes = [p, i64, i32, i32, i32, i32, i32, i32,
                                      p]
        lib.jpeg_upsample.restype = None
        lib.jpeg_color.argtypes = [p, p, p, i64, i32, p]
        lib.jpeg_color.restype = None
        lib.jpeg_pixels.argtypes = [i32, p, p, p, i32, i32, i32, p]
        lib.jpeg_pixels.restype = None
        lib.resample_rgb.argtypes = [p, i64, i64, p, i64, i64, p]
        lib.resample_rgb.restype = i32
        _LIB[0] = lib
    return _LIB[0]


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# --- decode -------------------------------------------------------------------

@dataclasses.dataclass
class Component:
    """One frame component: sampling factors, its samples' extent
    (``dw`` x ``dh``) and its coefficient array (rows x cols x 64, int16,
    natural order) with the quantisation table latched at its first scan."""
    ident: int
    h: int
    v: int
    tq: int
    dw: int
    dh: int
    coefs: np.ndarray
    qtable: Optional[np.ndarray] = None


@dataclasses.dataclass
class Frame:
    """A decoded file up to its coefficients."""
    width: int
    height: int
    components: List[Component]
    hmax: int
    vmax: int
    color: str                 # "gray" | "ycc" | "rgb"
    restart_interval: int


def _be16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _color_space(comps, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's default_decompress_parms for 1 and 3 components."""
    if len(comps) == 1:
        return "gray"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    ids = tuple(c.ident for c in comps)
    return "rgb" if ids == (82, 71, 66) else "ycc"


def read_coefficients(data: bytes, name: str = "<bytes>") -> Frame:
    """Parse a JPEG file and Huffman-decode every scan: the entropy stage.
    Raises ``OSError`` for a file this decoder does not read."""
    def bad(msg):
        return OSError(f"cannot decode JPEG {name!r}: {msg}")

    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise bad("no SOI marker (not a JPEG file)")
    buf = np.frombuffer(data, np.uint8)
    pos = 2
    frame = None
    qt, huff = {}, {}
    restart = 0
    jfif, adobe = False, None
    scans = 0
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1                        # garbage between segments
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if scans:
                break                       # no EOI after complete scans
            raise bad("the file ends before its image data (truncated)")
        m = data[pos]
        pos += 1
        if m == 0xD9:                       # EOI
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue                        # markers without a length
        if pos + 2 > n:
            raise bad(f"segment 0xFF{m:02X} is truncated")
        length = _be16(data, pos)
        if length < 2 or pos + length > n:
            raise bad(f"segment 0xFF{m:02X} is truncated")
        seg = data[pos + 2:pos + length]
        nxt = pos + length
        if m in _SOF_NAMES:
            raise bad(f"{_SOF_NAMES[m]} JPEG (marker 0xFF{m:02X}) is not "
                      f"supported: baseline or extended sequential Huffman "
                      f"(SOF0/SOF1) only")
        if m in (0xC0, 0xC1):
            if frame is not None:
                raise bad("a second frame header (SOF)")
            frame = _read_sof(seg, m, bad)
        elif m == 0xC4:
            _read_dht(seg, huff, bad)
        elif m == 0xDB:
            _read_dqt(seg, qt, bad)
        elif m == 0xDD:
            if len(seg) < 2:
                raise bad("DRI segment is truncated")
            restart = _be16(seg, 0)
        elif m == 0xDC:
            raise bad("a DNL marker (0xFFDC) is not supported")
        elif m == 0xE0:
            jfif = jfif or seg[:5] == b"JFIF\0"
        elif m == 0xEE:
            if seg[:5] == b"Adobe" and len(seg) >= 12:
                adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise bad("a scan (SOS) before the frame header (SOF)")
            nxt = _decode_scan(data, buf, nxt, seg, frame, qt, huff, restart,
                               bad)
            scans += 1
        # APPn, COM and anything else: skipped
        pos = nxt
    if frame is None or not scans:
        raise bad("no frame or no scan before EOI")
    for c in frame.components:
        if c.qtable is None:
            raise bad(f"component {c.ident} appears in no scan")
    frame.restart_interval = restart
    frame.color = _color_space(frame.components, jfif, adobe)
    return frame


def _read_sof(seg: bytes, marker: int, bad) -> Frame:
    if len(seg) < 6:
        raise bad("SOF segment is truncated")
    precision, height, width, nf = seg[0], _be16(seg, 1), _be16(seg, 3), seg[5]
    if precision != 8:
        raise bad(f"{precision}-bit samples (marker 0xFF{marker:02X}) are "
                  f"not supported: 8-bit only")
    if height == 0 or width == 0:
        raise bad("a zero image dimension (DNL-defined height) is not "
                  "supported")
    if nf == 4:
        raise bad("4-component (CMYK/YCCK) JPEG is not supported")
    if nf not in (1, 3) or len(seg) < 6 + 3 * nf:
        raise bad(f"{nf} components: 1 or 3 only")
    raw = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15,
            seg[8 + 3 * i]) for i in range(nf)]
    for ident, h, v, _ in raw:
        if h not in (1, 2) or v not in (1, 2):
            raise bad(f"sampling factors {h}x{v} of component {ident}: up "
                      f"to 2x2 only")
    hmax = max(h for _, h, _, _ in raw)
    vmax = max(v for _, _, v, _ in raw)
    mcus_x = -(-width // (8 * hmax))
    mcus_y = -(-height // (8 * vmax))
    comps = []
    for ident, h, v, tq in raw:
        dw = -(-width * h // hmax)
        dh = -(-height * v // vmax)
        rows = max(mcus_y * v, -(-dh // 8))
        cols = max(mcus_x * h, -(-dw // 8))
        comps.append(Component(ident, h, v, tq, dw, dh,
                               np.zeros((rows, cols, 64), np.int16)))
    return Frame(width, height, comps, hmax, vmax, "", 0)


def _read_dht(seg: bytes, huff: dict, bad) -> None:
    i = 0
    while i < len(seg):
        if i + 17 > len(seg):
            raise bad("DHT segment is truncated")
        tc, th = seg[i] >> 4, seg[i] & 15
        bits = bytes(seg[i + 1:i + 17])
        count = sum(bits)
        if tc > 1 or th > 3 or count > 256 or i + 17 + count > len(seg):
            raise bad("a malformed Huffman table (DHT)")
        vals = bytes(seg[i + 17:i + 17 + count]).ljust(256, b"\0")
        huff[(tc, th)] = bits + vals
        i += 17 + count


def _read_dqt(seg: bytes, qt: dict, bad) -> None:
    i = 0
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        size = 128 if pq else 64
        if tq > 3 or pq > 1 or i + 1 + size > len(seg):
            raise bad("a malformed quantisation table (DQT)")
        raw = np.frombuffer(seg, ">u2" if pq else np.uint8, 64, i + 1)
        table = np.zeros(64, np.uint16)
        table[NATURAL] = raw
        qt[tq] = table
        i += 1 + size


_SCAN_ERRORS = {-1: "the entropy-coded data ends early (truncated or "
                    "corrupt file)",
                -2: "a bad Huffman code or table (corrupt file)",
                -3: "a missing or out-of-order restart marker"}


def _decode_scan(data, buf, pos, seg, frame: Frame, qt, huff, restart,
                 bad) -> int:
    ns = seg[0] if seg else 0
    if ns < 1 or ns > 4 or len(seg) < 4 + 2 * ns:
        raise bad("a malformed scan header (SOS)")
    ss, se, ahal = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        raise bad(f"scan parameters Ss={ss} Se={se} Ah/Al={ahal:#x} are "
                  f"not sequential")
    by_id = {c.ident: c for c in frame.components}
    comps, tables = [], np.zeros((8, 272), np.uint8)
    spec = np.zeros((ns, 7), np.int32)
    for i in range(ns):
        cid, tsel = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise bad(f"scan names unknown component {cid}")
        c = by_id[cid]
        td, ta = tsel >> 4, tsel & 15
        if td > 3 or ta > 3 or (0, td) not in huff or (1, ta) not in huff:
            raise bad(f"component {cid} uses a Huffman table that is not "
                      f"defined")
        tables[td] = np.frombuffer(huff[(0, td)], np.uint8)
        tables[4 + ta] = np.frombuffer(huff[(1, ta)], np.uint8)
        if c.qtable is None:
            if c.tq not in qt:
                raise bad(f"component {cid} uses quantisation table "
                          f"{c.tq}, which is not defined")
            c.qtable = qt[c.tq].copy()
        spec[i] = (c.h, c.v, td, ta, c.coefs.shape[1], -(-c.dw // 8),
                   -(-c.dh // 8))
        comps.append(c)
    ptrs = (ctypes.c_void_p * ns)(*[_ptr(c.coefs) for c in comps])
    end = ctypes.c_int64(0)
    mcus_x = -(-frame.width // (8 * frame.hmax))
    mcus_y = -(-frame.height // (8 * frame.vmax))
    rc = _lib().jpeg_decode_scan(
        _ptr(buf), len(data), pos, ns, _ptr(spec), _ptr(tables), mcus_x,
        mcus_y, restart, ptrs, ctypes.byref(end))
    if rc:
        raise bad(_SCAN_ERRORS.get(rc, f"scan error {rc}"))
    return int(end.value)


def idct(c: Component) -> np.ndarray:
    """The IDCT stage: dequantise and inverse-transform one component's
    blocks (libjpeg's ``JDCT_ISLOW``) into a (rows*8, cols*8) uint8
    plane."""
    rows, cols = c.coefs.shape[:2]
    out = np.empty((rows * 8, cols * 8), np.uint8)
    q = np.ascontiguousarray(c.qtable, np.uint16)
    _lib().jpeg_idct_islow(_ptr(c.coefs), rows, cols, _ptr(q), _ptr(out))
    return out


def to_rgb(frame: Frame, planes: List[np.ndarray]) -> np.ndarray:
    """The upsample-and-colour stage: each plane to full resolution
    (libjpeg's fancy upsampling), then libjpeg's YCbCr->RGB (or the gray
    and RGB copies). Returns (height, width, 3) uint8."""
    lib = _lib()
    w, h = frame.width, frame.height
    chans = []
    for c, p in zip(frame.components, planes):
        ch = np.empty((h, w), np.uint8)
        lib.jpeg_upsample(_ptr(p), p.shape[1], c.dw, c.dh,
                          frame.hmax // c.h, frame.vmax // c.v, w, h,
                          _ptr(ch))
        chans.append(ch)
    out = np.empty((h, w, 3), np.uint8)
    kind = _KINDS[frame.color]
    c1 = chans[1] if len(chans) > 1 else chans[0]
    c2 = chans[2] if len(chans) > 2 else chans[0]
    lib.jpeg_color(_ptr(chans[0]), _ptr(c1), _ptr(c2), h * w, kind,
                   _ptr(out))
    return out


_KINDS = {"gray": 0, "ycc": 1, "rgb": 2}


def pixels(frame: Frame) -> np.ndarray:
    """The IDCT, upsample and colour stages of :func:`idct` and
    :func:`to_rgb` in one C++ call (no intermediate arrays in Python):
    (height, width, 3) uint8."""
    comps = frame.components
    n = len(comps)
    coefs = (ctypes.c_void_p * n)(*[_ptr(c.coefs) for c in comps])
    qts = [np.ascontiguousarray(c.qtable, np.uint16) for c in comps]
    qptr = (ctypes.c_void_p * n)(*[_ptr(q) for q in qts])
    dims = np.array([(c.coefs.shape[0], c.coefs.shape[1], c.dw, c.dh,
                      frame.hmax // c.h, frame.vmax // c.v) for c in comps],
                    np.int32)
    out = np.empty((frame.height, frame.width, 3), np.uint8)
    _lib().jpeg_pixels(n, ctypes.addressof(coefs), ctypes.addressof(qptr),
                       _ptr(dims), frame.width, frame.height,
                       _KINDS[frame.color], _ptr(out))
    return out


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A JPEG file's bytes -> (height, width, 3) uint8 RGB, as PIL's
    ``Image.open(f).convert("RGB")`` gives it."""
    return pixels(read_coefficients(data, name))


def read_rgb(path: str) -> np.ndarray:
    """Read and decode one file; an ``OSError`` names the path."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, path)


# --- encode -------------------------------------------------------------------

def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """IJG's quality scaling of the Annex K tables (clamped to 1..255,
    baseline), natural order: (luma, chroma)."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in (_LUMA_Q, _CHROMA_Q):
        t = (base * scale + 50) // 100
        out.append(np.clip(t, 1, 255).astype(np.uint16))
    return out[0], out[1]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    return m


_DCT = _dct_matrix()
_SIZE = np.array([int(i).bit_length() for i in range(4096)], np.int64)


def _huff_codes(bits, vals):
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = code
            lens[vals[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's fixed-point RGB->YCbCr (jccolor.c)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16

    def fix(v):
        return int(v * 65536 + 0.5)

    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + half - 1) >> 16
    return np.stack([y, cb, cr], -1)


def _blocks_fdct(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(H, W) samples, H and W multiples of 8 -> (H/8, W/8, 64) int16
    quantised coefficients, natural order."""
    hb, wb = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.reshape(hb, 8, wb, 8).transpose(0, 2, 1, 3) - 128.0
    # D X D^T as two flat GEMMs over every block's rows, then columns
    y = (x.reshape(-1, 8) @ _DCT.T).reshape(hb, wb, 8, 8)
    f = (y.transpose(0, 1, 3, 2).reshape(-1, 8) @ _DCT.T).reshape(
        hb, wb, 8, 8).transpose(0, 1, 3, 2).reshape(hb, wb, 64)
    r = f / q.astype(np.float64)
    c = np.sign(r) * np.floor(np.abs(r) + 0.5)
    c[..., 1:] = np.clip(c[..., 1:], -1023, 1023)
    return c.astype(np.int16)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Concatenate codes MSB first, pad the last byte with 1 bits, stuff
    a 0x00 after every 0xFF. Each code (at most 27 bits) lands in a 40-bit
    window at its byte offset; codes never share a bit, so the bytes of
    all windows add up by position (``bincount``) to the packed stream."""
    total = int(lens.sum())
    if total == 0:
        return b""
    starts = np.cumsum(lens) - lens
    first = starts >> 3
    window = vals << (40 - (starts & 7) - lens)
    nbytes = (total + 7) // 8
    acc = np.zeros(nbytes + 5)
    for k in range(5):
        acc += np.bincount(first + k, weights=(window >> (32 - 8 * k))
                           & 0xFF, minlength=nbytes + 5)
    out = acc[:nbytes].astype(np.uint8)
    pad = (-total) % 8
    if pad:
        out[-1] |= (1 << pad) - 1
    ff = np.nonzero(out == 0xFF)[0]
    return np.insert(out, ff + 1, 0).tobytes()


def encode(image: np.ndarray, quality: int = 85,
           sampling: Tuple[int, int] = (2, 2), restart_interval: int = 0,
           return_coefficients: bool = False):
    """Encode (H, W, 3) RGB or (H, W) gray uint8 as a baseline JFIF file.

    ``sampling`` is the luma component's (h, v) factors over 1x1 chroma:
    (2, 2) is 4:2:0, (2, 1) 4:2:2, (1, 2) 4:4:0, (1, 1) 4:4:4.
    ``restart_interval`` > 0 writes a DRI segment and a restart marker
    every that many MCUs. With ``return_coefficients`` returns ``(bytes,
    [per component (rows, cols, 64) int16 quantised coefficients in
    natural order])``, what :func:`read_coefficients` must give back."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError("encode takes (H, W, 3) or (H, W) uint8")
    height, width = img.shape[:2]
    gray = img.ndim == 2
    hs, vs = (1, 1) if gray else (int(sampling[0]), int(sampling[1]))
    if hs not in (1, 2) or vs not in (1, 2):
        raise ValueError(f"sampling {sampling}: factors 1 or 2")
    lq, cq = quant_tables(quality)
    factors = [(hs, vs)] if gray else [(hs, vs), (1, 1), (1, 1)]
    mcus_x, mcus_y = -(-width // (8 * hs)), -(-height // (8 * vs))
    pw, ph = mcus_x * 8 * hs, mcus_y * 8 * vs
    if gray:
        pw, ph = -(-width // 8) * 8, -(-height // 8) * 8
    pad = ((0, ph - height), (0, pw - width)) + (() if gray else ((0, 0),))
    full = np.pad(img, pad, mode="edge")
    samples = [full.astype(np.int64)] if gray else list(
        np.moveaxis(_rgb_to_ycc(full), -1, 0))
    coefs = []
    for i, (s, (h, v)) in enumerate(zip(samples, factors)):
        fh, fv = hs // h, vs // v
        if fh > 1 or fv > 1:
            s = s.reshape(ph // fv, fv, pw // fh, fh).sum((1, 3))
            s = (s + (fh * fv) // 2) // (fh * fv)
        coefs.append(_blocks_fdct(s.astype(np.float64),
                                  lq if i == 0 else cq))
    # block order of the scan
    if gray:
        rows, cols = coefs[0].shape[:2]
        idx = np.arange(rows * cols)
        comp = np.zeros_like(idx)
        by, bx = np.divmod(idx, cols)
        mcu = idx
    else:
        per_mcu = sum(h * v for h, v in factors)
        keys, parts, off = [], [], 0
        my, mx = np.divmod(np.arange(mcus_x * mcus_y), mcus_x)
        for i, (h, v) in enumerate(factors):
            for dv in range(v):
                for dh in range(h):
                    keys.append((my * mcus_x + mx) * per_mcu + off)
                    parts.append((np.full_like(my, i), my * v + dv,
                                  mx * h + dh, my * mcus_x + mx))
                    off += 1
        key = np.concatenate(keys)
        order = np.argsort(key, kind="stable")
        comp, by, bx, mcu = (np.concatenate([p[j] for p in parts])[order]
                             for j in range(4))
    zz = np.empty((len(comp), 64), np.int64)
    for i in range(len(coefs)):
        sel = comp == i
        zz[sel] = coefs[i][by[sel], bx[sel]][:, NATURAL]
    interval = (mcu // restart_interval if restart_interval
                else np.zeros_like(mcu))
    # DC differences per component, reset at each restart interval
    diff = np.empty(len(comp), np.int64)
    for i in range(len(coefs)):
        sel = np.nonzero(comp == i)[0]
        dc = zz[sel, 0]
        prev = np.concatenate([[0], dc[:-1]])
        same = np.concatenate([[False], interval[sel][1:]
                               == interval[sel][:-1]])
        diff[sel] = dc - np.where(same, prev, 0)
    tabs = [_huff_codes(*STD_HUFFMAN[k]) for k in
            ("dc_luma", "dc_chroma", "ac_luma", "ac_chroma")]
    chroma = comp > 0
    nblk = len(comp)

    def lookup(table_pair, sym, is_chroma):
        (lc, ll), (cc, cl) = table_pair
        return (np.where(is_chroma, cc[sym], lc[sym]),
                np.where(is_chroma, cl[sym], ll[sym]))

    def extra(v, s):
        return np.where(v < 0, v + (1 << s) - 1, v)

    # DC events
    s = _SIZE[np.abs(diff)]
    code, clen = lookup((tabs[0], tabs[1]), s, chroma)
    ev_key = [np.arange(nblk) * 256]
    ev_val = [(code << s) | extra(diff, s)]
    ev_len = [clen + s]
    # AC events: ZRLs and run/size symbols, then EOB
    ac = zz[:, 1:]
    nz = ac != 0
    k = np.arange(1, 64)
    last = np.maximum.accumulate(np.where(nz, k, 0), axis=1)
    prev_nz = np.concatenate([np.zeros((nblk, 1), np.int64), last[:, :-1]],
                             axis=1)
    b_i, k_i = np.nonzero(nz)
    kk = k_i + 1
    run = kk - prev_nz[b_i, k_i] - 1
    v = ac[b_i, k_i]
    s = _SIZE[np.abs(v)]
    sym = ((run % 16) << 4) | s
    code, clen = lookup((tabs[2], tabs[3]), sym, chroma[b_i])
    ev_key.append(b_i * 256 + 1 + (kk - 1) * 4 + 3)
    ev_val.append((code << s) | extra(v, s))
    ev_len.append(clen + s)
    nzrl = run // 16
    zc, zl = lookup((tabs[2], tabs[3]), np.full_like(b_i, 0xF0),
                    chroma[b_i])
    for j in range(3):
        sel = nzrl > j
        ev_key.append(b_i[sel] * 256 + 1 + (kk[sel] - 1) * 4 + j)
        ev_val.append(zc[sel])
        ev_len.append(zl[sel])
    eob = ~nz[:, -1]
    ec, el = lookup((tabs[2], tabs[3]), np.zeros(nblk, np.int64), chroma)
    ev_key.append(np.nonzero(eob)[0] * 256 + 255)
    ev_val.append(ec[eob])
    ev_len.append(el[eob])
    key = np.concatenate(ev_key)
    order = np.argsort(key, kind="stable")
    vals = np.concatenate(ev_val)[order]
    lens = np.concatenate(ev_len)[order]
    ev_interval = interval[key[order] // 256]
    # pack each restart interval on its own, then the RSTn markers
    scan = bytearray()
    bounds = np.searchsorted(ev_interval,
                             np.arange(int(interval[-1]) + 2))
    for r in range(len(bounds) - 1):
        if r:
            scan += bytes([0xFF, 0xD0 + (r - 1) % 8])
        scan += _pack(vals[bounds[r]:bounds[r + 1]],
                      lens[bounds[r]:bounds[r + 1]])
    out = _headers(width, height, factors, lq, cq, restart_interval)
    out += bytes(scan) + b"\xff\xd9"
    if return_coefficients:
        return bytes(out), coefs
    return bytes(out)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _headers(width, height, factors, lq, cq, restart) -> bytearray:
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    nf = len(factors)
    dqt = bytes([0]) + lq[NATURAL].astype(np.uint8).tobytes()
    if nf > 1:
        dqt += bytes([1]) + cq[NATURAL].astype(np.uint8).tobytes()
    out += _segment(0xDB, dqt)
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([nf])
    for i, (h, v) in enumerate(factors):
        sof += bytes([i + 1, (h << 4) | v, 0 if i == 0 else 1])
    out += _segment(0xC0, sof)
    dht = b""
    for tc_th, name in ((0x00, "dc_luma"), (0x10, "ac_luma"),
                        (0x01, "dc_chroma"), (0x11, "ac_chroma")):
        if nf == 1 and "chroma" in name:
            continue
        bits, vals = STD_HUFFMAN[name]
        dht += bytes([tc_th]) + bytes(bits) + bytes(vals)
    out += _segment(0xC4, dht)
    if restart:
        out += _segment(0xDD, int(restart).to_bytes(2, "big"))
    sos = bytes([nf])
    for i in range(nf):
        sos += bytes([i + 1, 0x00 if i == 0 else 0x11])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    return out
