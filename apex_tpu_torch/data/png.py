"""The port's PNG decoder: what PIL's ``Image.open(f).convert("RGB")``
gives, bit for bit, in numpy and the standard library's ``zlib``.

It reads every PNG that PIL 12 reads as a still image: bit depths 1, 2,
4, 8 and 16; gray, gray + alpha, RGB, RGBA and palette images, with or
without ``tRNS``; Adam7 interlacing; image data over any number of IDAT
chunks. Ancillary chunks are skipped. What ``convert("RGB")`` does, and
so what this module does:

- gray at 1, 2 and 4 bits is scaled to 8 (×255, ×85, ×17: PIL's ``1``,
  ``L;2`` and ``L;4`` raw modes); 16-bit gray is PIL's ``I;16``, whose
  conversion to RGB clips each sample to 255 (it does not scale it);
- 16-bit RGB, RGBA and gray + alpha keep each sample's high byte;
- alpha is dropped, not composited; ``tRNS`` changes no pixel;
- a palette index past the PLTE entries reads as black (PIL pads the
  palette with zeros).

As PIL does, the CRC of every chunk before the first IDAT is checked and
the CRCs from the first IDAT on are not; a file PIL refuses (a bad
signature, header or CRC, an unknown bit depth, colour type, filter or
interlace method, truncated or corrupt image data) raises ``OSError``
naming the file.

Unfiltering: each scanline's filter (None, Sub, Up, Average, Paeth)
reconstructs a byte from the byte ``bpp`` to its left, the byte above and
the byte above-left. The decoder runs it in C++ (``png_unfilter`` of
``csrc/jpeg_entropy.cpp``, the codec's host library, under ctypes, which
releases the GIL, so the loader's decode threads scale as they do on
JPEG); :func:`_unfilter_plain` is the same function in numpy, a
wavefront over anti-diagonals of (row, pixel) on a skewed copy where
each anti-diagonal is one column, which the tests hold the library to.
Everything else is numpy and the standard library's ``zlib``.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["SIGNATURE", "decode", "read_rgb"]

SIGNATURE = b"\x89PNG\r\n\x1a\n"

#: (bit depth, colour type) -> samples a pixel; PIL's supported set
_CHANNELS = {(1, 0): 1, (2, 0): 1, (4, 0): 1, (8, 0): 1, (16, 0): 1,
             (8, 2): 3, (16, 2): 3,
             (1, 3): 1, (2, 3): 1, (4, 3): 1, (8, 3): 1,
             (8, 4): 2, (16, 4): 2,
             (8, 6): 4, (16, 6): 4}

_CID = re.compile(rb"\w\w\w\w")

#: Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(raw: np.ndarray, rows: int, rowbytes: int, bpp: int,
              bad) -> np.ndarray:
    """(rows, rowbytes) reconstructed bytes from ``raw`` (rows lines of a
    filter byte and rowbytes filtered bytes): the codec library's
    ``png_unfilter`` (C++, the GIL released)."""
    from apex_tpu_torch.data.jpeg import _lib
    out = np.empty((rows, rowbytes), np.uint8)
    src = np.ascontiguousarray(raw[:rows * (rowbytes + 1)])
    if _lib().png_unfilter(src.ctypes.data, rows, rowbytes, bpp,
                           out.ctypes.data):
        ft = src.reshape(rows, rowbytes + 1)[:, 0]
        raise bad(f"unrecognized filter type {int(ft.max())}")
    return out


def _unfilter_plain(raw: np.ndarray, rows: int, rowbytes: int, bpp: int,
                    bad) -> np.ndarray:
    """:func:`_unfilter` in numpy, the reference the tests hold the
    library to."""
    lines = raw[:rows * (rowbytes + 1)].reshape(rows, rowbytes + 1)
    ft = lines[:, 0].astype(np.int64)
    if (ft > 4).any():
        raise bad(f"unrecognized filter type {int(ft.max())}")
    units = rowbytes // bpp              # pixels (bytes below 8 bits)
    filt = lines[:, 1:]
    # The wavefront, on a skewed layout: rec(r, x) sits at sk[r + 1, r + x
    # + 2], so anti-diagonal t = r + x is column t + 2, the byte to the
    # left (a) and the byte above (b) are column t + 1 of rows r + 1 and r,
    # the byte above-left (c) column t of row r; row 0 and the columns
    # left of each row stay zero, as the filters' edges want
    steps = rows + units - 1
    fs = np.zeros((rows, steps, bpp), np.int16)
    r_i = np.arange(rows)[:, None]
    fs[r_i, r_i + np.arange(units)[None, :]] = filt.reshape(rows, units, bpp)
    sk = np.zeros((rows + 1, steps + 2, bpp), np.int16)
    kind = ft[:, None]
    has_avg = np.concatenate([[0], np.cumsum(ft == 3)])
    has_paeth = np.concatenate([[0], np.cumsum(ft == 4)])
    zero = np.zeros((rows, bpp), np.int16)
    for t in range(steps):
        lo, hi = max(0, t - units + 1), min(rows, t + 1)
        a = sk[lo + 1:hi + 1, t + 1]
        b = sk[lo:hi, t + 1]
        c = sk[lo:hi, t]
        choices = [zero[:hi - lo], a, b, a, a]
        if has_avg[hi] > has_avg[lo]:
            choices[3] = (a + b) >> 1
        if has_paeth[hi] > has_paeth[lo]:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            choices[4] = np.where((pa <= pb) & (pa <= pc), a,
                                  np.where(pb <= pc, b, c))
        pred = np.choose(kind[lo:hi], choices)
        sk[lo + 1:hi + 1, t + 2] = (fs[lo:hi, t] + pred) & 0xFF
    rec = sk[1:, 2:][r_i, r_i + np.arange(units)[None, :]]
    return rec.astype(np.uint8).reshape(rows, rowbytes)


def _samples(rec: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """(rows, width, channels) samples (uint8, or uint16 at 16 bits)."""
    rows = rec.shape[0]
    if depth == 16:
        return rec.view(">u2")[:, :width * channels].reshape(
            rows, width, channels)
    if depth == 8:
        return rec[:, :width * channels].reshape(rows, width, channels)
    bits = np.unpackbits(rec, axis=1).reshape(rows, -1, depth)
    vals = np.zeros(bits.shape[:2], np.uint8)
    for i in range(depth):
        vals = (vals << 1) | bits[:, :, i]
    return vals[:, :width, None]


def _to_rgb(s: np.ndarray, depth: int, ctype: int,
            palette: Optional[np.ndarray]) -> np.ndarray:
    """PIL's mode for the file, then its ``convert("RGB")``."""
    if ctype == 3:
        return palette[s[..., 0]]
    if depth == 16:
        if ctype == 0:                       # I;16 -> RGB clips
            s = np.minimum(s, 255)
        else:                                # high bytes
            s = s >> 8
        s = s.astype(np.uint8)
    elif depth < 8:
        s = s * np.uint8({1: 255, 2: 85, 4: 17}[depth])
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=-1)
    return np.ascontiguousarray(s[..., :3])


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes -> (height, width, 3) uint8 RGB, as PIL's
    ``Image.open(f).convert("RGB")`` gives it."""
    def bad(msg):
        return OSError(f"cannot decode PNG {name!r}: {msg}")

    if data[:8] != SIGNATURE:
        raise bad("no PNG signature")
    pos, n = 8, len(data)
    header, palette, idat = None, None, []
    seen_idat = False
    while True:
        if pos + 8 > n:
            if seen_idat:
                break                          # no IEND: PIL stops here too
            raise bad("the file ends before its image data (truncated)")
        length, cid = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if seen_idat and cid != b"IDAT":
            break                              # PIL reads one IDAT run
        if not _CID.fullmatch(cid):
            raise bad(f"a broken chunk type {cid!r}")
        if cid != b"IDAT":                     # PIL checks IDAT's never
            if len(body) < length or pos + 12 + length > n:
                raise bad(f"chunk {cid!r} is truncated")
            crc = struct.unpack(">I", data[pos + 8 + length:
                                           pos + 12 + length])[0]
            if zlib.crc32(body, zlib.crc32(cid)) != crc:
                raise bad(f"bad checksum in chunk {cid!r}")
        if cid == b"IHDR":
            if length < 13:
                raise bad("truncated IHDR chunk")
            w, h, depth, ctype, comp, filt, inter = struct.unpack(
                ">IIBBBBB", body[:13])
            if (depth, ctype) not in _CHANNELS:
                raise bad(f"bit depth {depth} with colour type {ctype} is "
                          f"not a PNG mode")
            if filt:
                raise bad("unknown filter category")
            if comp or inter > 1 or not w or not h:
                raise bad("unknown compression or interlace method, or an "
                          "empty image")
            header = (w, h, depth, ctype, inter)
        elif cid == b"PLTE" and header is not None and header[3] == 3:
            pal = np.zeros((256, 3), np.uint8)   # past PLTE: black
            entries = np.frombuffer(body[:len(body) // 3 * 3], np.uint8)
            pal[:min(256, len(entries) // 3)] = entries.reshape(-1, 3)[:256]
            palette = pal
        elif cid == b"IDAT":
            if header is None:
                raise bad("image data before the header (IHDR)")
            idat.append(body)
            seen_idat = True
        elif cid == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise bad("no header or no image data")
    w, h, depth, ctype, inter = header
    if ctype == 3 and palette is None:
        raise bad("a palette image without a palette (PLTE)")
    try:
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat)),
                            np.uint8)
    except zlib.error as e:
        raise bad(f"corrupt image data ({e})") from None
    ch = _CHANNELS[(depth, ctype)]
    bits = depth * ch
    bpp = max(1, bits // 8)
    out = np.empty((h, w, 3), np.uint8)
    passes = _ADAM7 if inter else ((0, 0, 1, 1),)
    off = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = -(-pw * bits // 8)
        need = ph * (rowbytes + 1)
        if off + need > raw.size:
            raise bad("image data is truncated")
        rec = _unfilter(raw[off:off + need], ph, rowbytes, bpp, bad)
        off += need
        out[y0::dy, x0::dx] = _to_rgb(_samples(rec, pw, depth, ch), depth,
                                      ctype, palette)
    return out


def read_rgb(path: str) -> np.ndarray:
    """Read and decode one file; an ``OSError`` names the path."""
    with open(path, "rb") as f:
        return decode(f.read(), path)
