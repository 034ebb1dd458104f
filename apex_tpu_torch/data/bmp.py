"""The port's BMP decoder: what PIL's ``Image.open(f).convert("RGB")``
gives, bit for bit (PIL 12's ``BmpImagePlugin``), in numpy.

Headers: the OS/2 core header (12 bytes: 16-bit sizes, 3-byte palette
entries) and the Windows info headers of 40, 52, 56, 64, 108 (V4) and
124 (V5) bytes, bottom-up or top-down (a negative height). Pixels: 1-,
4- and 8-bit palettes; 16-bit 555; 24 bits; 32 bits (the fourth byte
ignored); RLE8 and RLE4; and the bitfield layouts PIL takes (16-bit 555
and 565, 24-bit BGR, and its eight 32-bit masks). What PIL then does:

- a 16-bit channel of n bits becomes ``v * 255 // (2**n - 1)``;
- a palette that is the gray ramp (or black and white with two colours)
  is read as gray, which gives the same RGB as the palette;
- alpha is dropped; an index past the palette reads as black;
- RLE is decoded as PIL's Python decoder decodes it, quirks included: a
  delta escape skips the two bytes after it and reads (right, up) from the
  next two, an odd absolute RLE4 run yields one pixel less than it names,
  and absolute runs align to even offsets of the file.

Anything PIL refuses (another header size, bit depth, compression or
bitfield layout, a palette of 0 or more than 65536 colours, too little
pixel data) raises ``OSError`` naming the file; so does a gray-ramp
palette whose size does not match the pixel depth, which PIL misreads.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decode", "read_rgb"]

_BITFIELDS = {
    32: {(0xFF0000, 0xFF00, 0xFF, 0x0): "BGRX",
         (0xFF000000, 0xFF0000, 0xFF00, 0x0): "XBGR",
         (0xFF000000, 0xFF00, 0xFF, 0x0): "BGXR",
         (0xFF000000, 0xFF0000, 0xFF00, 0xFF): "ABGR",
         (0xFF, 0xFF00, 0xFF0000, 0xFF000000): "RGBA",
         (0xFF0000, 0xFF00, 0xFF, 0xFF000000): "BGRA",
         (0xFF000000, 0xFF00, 0xFF, 0xFF0000): "BGAR",
         (0x0, 0x0, 0x0, 0x0): "BGRA"},
    24: {(0xFF0000, 0xFF00, 0xFF): "BGR"},
    16: {(0xF800, 0x7E0, 0x1F): "BGR;16", (0x7C00, 0x3E0, 0x1F): "BGR;15"},
}
_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
#: the byte order of each 24/32-bit raw mode: where R, G and B sit
_BYTE_OF = {"BGR": (2, 1, 0), "BGRX": (2, 1, 0), "XBGR": (3, 2, 1),
            "BGXR": (3, 1, 0), "ABGR": (3, 2, 1), "RGBA": (0, 1, 2),
            "BGRA": (2, 1, 0), "BGAR": (3, 1, 0)}


def _u(data, fmt, pos, bad):
    try:
        return struct.unpack_from(fmt, data, pos)
    except struct.error:
        raise bad("the header is truncated") from None


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool):
    """PIL's ``BmpRleDecoder``: bytes of one index a pixel, rows in file
    order, from the stream at ``pos`` (an absolute file offset)."""
    out = bytearray()
    x, n, end = 0, width * height, len(data)

    def read(k):
        nonlocal pos
        got = data[pos:pos + k]
        pos += len(got)
        return got

    while len(out) < n:
        pair = read(2)
        if len(pair) < 2:
            break
        count, byte = pair
        if count:                                  # an encoded run
            if x + count > width:
                count = max(0, width - x)
            if rle4:
                hi, lo = bytes([byte >> 4]), bytes([byte & 15])
                out += b"".join(hi if i % 2 == 0 else lo
                                for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                            # end of line
            while len(out) % width:
                out.append(0)
            x = 0
        elif byte == 1:                            # end of bitmap
            break
        elif byte == 2:                            # delta, as PIL reads it
            if len(read(2)) < 2:
                break
            d = read(2)
            right, up = (d[0], d[1]) if len(d) == 2 else (0, 0)
            out += b"\0" * (right + up * width)
            x = len(out) % width
        else:                                      # an absolute run
            if rle4:
                k = byte // 2
                got = read(k)
                for v in got:
                    out += bytes([v >> 4, v & 15])
            else:
                k = byte
                got = read(k)
                out += got
            if len(got) < k:
                break
            x += byte
            if pos % 2:
                pos = min(pos + 1, end)
    return bytes(out)


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A BMP file's bytes -> (height, width, 3) uint8 RGB, as PIL's
    ``Image.open(f).convert("RGB")`` gives it."""
    def bad(msg):
        return OSError(f"cannot decode BMP {name!r}: {msg}")

    if data[:2] != b"BM" or len(data) < 18:
        raise bad("not a BMP file")
    offset, = _u(data, "<I", 10, bad)
    hsize, = _u(data, "<I", 14, bad)
    hdr = data[18:14 + hsize]
    if len(hdr) < hsize - 4:
        raise bad("the header is truncated")
    pos = 14 + hsize
    masks = None
    if hsize == 12:
        width, height, _, bits = _u(hdr, "<HHHH", 0, bad)
        compression, colors, padding, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = hdr[7] == 0xFF
        width, height = _u(hdr, "<II", 0, bad)
        if top_down:
            height = 2 ** 32 - height
        _, bits, compression = _u(hdr, "<HHI", 8, bad)
        colors, = _u(hdr, "<I", 28, bad)
        padding = 4
        if compression == 3:
            if len(hdr) >= 48:
                masks = list(_u(hdr, "<III", 36, bad))
                masks.append(_u(hdr, "<I", 48, bad)[0] if len(hdr) >= 52
                             else 0)
            else:
                masks = list(_u(data, "<III", pos, bad)) + [0]
                pos += 12
    else:
        raise bad(f"unsupported BMP header type ({hsize})")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _RAW:
        raise bad(f"unsupported BMP pixel depth ({bits})")
    raw, rle = _RAW[bits], None
    if compression == 3:
        table = _BITFIELDS.get(bits, {})
        key = tuple(masks) if bits == 32 else tuple(masks[:3])
        if key not in table:
            raise bad("unsupported BMP bitfields layout")
        raw = table[key]
    elif compression in (1, 2):
        rle = compression == 2
    elif compression != 0:
        raise bad(f"unsupported BMP compression ({compression})")
    if not width or not height:
        raise bad("an empty image")

    palette = None
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise bad(f"unsupported BMP palette size ({colors})")
        pal = data[pos:pos + padding * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * padding:i * padding + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        if gray and not ((colors == 2 and bits == 1) or (
                colors != 2 and bits == 8)):
            raise bad(f"a gray-ramp palette of {colors} colours with "
                      f"{bits}-bit pixels (PIL misreads it)")
        palette = np.zeros((max(256, colors), 3), np.uint8)
        n = min(colors, len(pal) // padding)
        entries = np.frombuffer(pal[:n * padding], np.uint8).reshape(
            n, padding)
        palette[:n] = entries[:, 2::-1]
        if gray:
            palette[:] = 0
            palette[:256] = np.arange(256, dtype=np.uint8)[:, None]
            if colors == 2:
                palette[1] = 255

    if rle is not None:
        px = _rle(data, offset, width, height, rle)
        if len(px) < width * height:
            raise bad("image file is truncated")
        idx = np.frombuffer(px[:width * height], np.uint8).reshape(
            height, width)
        idx = idx if top_down else idx[::-1]
        return palette[idx]

    stride = ((width * bits + 31) >> 3) & ~3
    body = data[offset:offset + stride * height]
    if len(body) < stride * height:
        raise bad("image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(height, stride)
    rows = rows if top_down else rows[::-1]
    if bits <= 8:
        if bits == 8:
            idx = rows[:, :width]
        else:
            b = np.unpackbits(rows, axis=1)[:, :width * bits]
            b = b.reshape(height, width, bits)
            idx = np.zeros((height, width), np.int64)
            for i in range(bits):
                idx = (idx << 1) | b[:, :, i]
        return palette[idx]
    if bits == 16:
        v = rows[:, :2 * width].view("<u2").astype(np.int64)
        if raw == "BGR;16":
            chans = ((v >> 11) & 31, 31), ((v >> 5) & 63, 63), (v & 31, 31)
        else:
            chans = ((v >> 10) & 31, 31), ((v >> 5) & 31, 31), (v & 31, 31)
        return np.stack([c * 255 // m for c, m in chans], -1).astype(
            np.uint8)
    px = rows[:, :width * bits // 8].reshape(height, width, bits // 8)
    return np.ascontiguousarray(px[:, :, list(_BYTE_OF[raw])])


def read_rgb(path: str) -> np.ndarray:
    """Read and decode one file; an ``OSError`` names the path."""
    with open(path, "rb") as f:
        return decode(f.read(), path)
