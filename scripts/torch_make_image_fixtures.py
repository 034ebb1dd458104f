#!/usr/bin/env python3
"""Write the image-format fixtures of the port's loader, with PIL's pixels.

    python3 scripts/torch_make_image_fixtures.py [--out DIR]

Writes small image files of every format and mode the JAX loader reads
through ``PIL.Image.open(path).convert("RGB")`` (progressive, CMYK and
YCCK JPEG; PNG at every bit depth and colour type, with and without
``tRNS``, Adam7-interlaced and over several IDAT chunks; BMP with 1-, 4-
and 8-bit palettes, 16-bit 555 and bitfields, 24 and 32 bits, RLE4 and
RLE8, top-down, the OS/2 core header and the V4/V5 headers), into
``tests/data/torch_image_formats/`` by default. Beside each file it
writes PIL's pixels, ``<name>.npy`` ((H, W, 3) uint8), and
``manifest.json`` lists every file with its format, what it exercises,
and whether PIL and the port read it (``"ok"``) or raise (``"raises"``):
files PIL refuses, and the progressive file PIL block-smooths, which the
port refuses by design (``apex_tpu_torch/data/jpeg.py``). It runs
without the port: the tests hold the port to these files.

PIL writes what it can (baseline and progressive JPEG, CMYK JPEG, 8-bit
PNG, 1/8/24-bit BMP); a writer here makes the rest: PNG chunks with
every filter type and 16-bit samples, BMP headers, palettes, masks and
RLE streams, and YCCK (a CMYK file whose Adobe marker names transform
2). The pixels come from a seed. The fixtures stay under 2 MB; a few are
256² or larger.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import struct
import sys
import zlib

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_image_formats")


def picture(h, w, seed, channels=3):
    """A smooth picture with edges and mild noise: compresses, and every
    PNG filter and JPEG coefficient gets work."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for c in range(channels):
        f = rng.uniform(0.5, 3.0, 2)
        p = 127 + 100 * np.sin(x * f[0] / 17 + c) * np.cos(y * f[1] / 23)
        p += 60 * ((x + 2 * y + 7 * c) % 53 < 20)
        p += rng.randint(-6, 7, (h, w))
        planes.append(p)
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


# --- PNG ----------------------------------------------------------------------

def _chunk(cid: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + cid + body
            + struct.pack(">I", zlib.crc32(body, zlib.crc32(cid))))


def _filter_rows(rows: np.ndarray, bpp: int, start: int) -> bytes:
    """Filter each (rowbytes,) uint8 row with filter (start + i) % 5."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for i, row in enumerate(rows.astype(np.int64)):
        ft = (start + i) % 5
        a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        b = prev
        if ft == 0:
            f = row
        elif ft == 1:
            f = row - a
        elif ft == 2:
            f = row - b
        elif ft == 3:
            f = row - ((a + b) >> 1)
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a,
                               np.where(pb <= pc, b, c))
        out.append(ft)
        out += (f & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, C) samples -> (H, rowbytes) uint8 scanlines."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    bits = np.unpackbits(flat[..., None], axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=-1)


def write_png(samples, depth, ctype, *, interlace=False, palette=None,
              trns=None, idat_split=1, filter_start=0):
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    raw = bytearray()
    if interlace:
        passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                  (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
        for i, (x0, y0, dx, dy) in enumerate(passes):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter_rows(_pack_rows(sub, depth), bpp,
                                    filter_start + i)
    else:
        raw += _filter_rows(_pack_rows(samples, depth), bpp, filter_start)
    z = zlib.compress(bytes(raw), 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    cuts = np.linspace(0, len(z), idat_split + 1).astype(int)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


# --- BMP ----------------------------------------------------------------------

def _rle(indices: np.ndarray, rle4: bool) -> bytes:
    """RLE8/RLE4 stream of (H, W) indices, bottom-up: encoded runs of
    equal values, absolute runs of at least 3 otherwise, end of line after
    every row, end of bitmap."""
    out = bytearray()
    for row in indices[::-1]:
        row = [int(v) for v in row]
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and row[j] == row[i] and j - i < 255:
                j += 1
            if j - i >= 3 or len(row) - i < 3:
                n = j - i
                val = row[i] * 17 if rle4 else row[i]
                out += bytes([n, val])
                i = j
                continue
            k = i                      # absolute: until a run of 3 starts
            while k < len(row) and k - i < 254 and not (
                    k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
                k += 1
            n = k - i
            if n < 3:
                for v in row[i:k]:
                    out += bytes([1, v * 17 if rle4 else v])
                i = k
                continue
            if rle4 and n % 2:
                n -= 1                 # PIL reads an odd absolute run short
            seg = row[i:i + n]
            if rle4:
                data = bytes((seg[t] << 4) | seg[t + 1]
                             for t in range(0, n, 2))
            else:
                data = bytes(seg)
            out += bytes([0, n]) + data
            if len(data) % 2:
                out += b"\0"           # word alignment
            i += n
        out += b"\0\0"                 # end of line
    return bytes(out + b"\0\1")        # end of bitmap


def write_bmp(pixels: bytes, w, h, bits, *, header=40, compression=0,
              palette=None, masks=None, top_down=False, colors=0):
    """A BMP: file header, an info header of ``header`` bytes (12: the
    OS/2 core header; 40, 108 or 124), palette (BGRX, or BGR with the core
    header), bitfield masks (after a 40-byte header, else inside it) and
    the given pixel bytes."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
        pal = b"" if palette is None else b"".join(
            bytes([b, g, r]) for r, g, b in palette)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, len(pixels), 2835, 2835,
                           colors, 0)
        extra = b""
        if masks is not None:
            extra = struct.pack("<" + "I" * len(masks), *masks)
        if header == 40:
            info += extra if masks is not None else b""
        else:
            body = extra.ljust(16, b"\0")
            info += body + b"\0" * (header - 40 - len(body))
        pal = b"" if palette is None else b"".join(
            bytes([b, g, r, 0]) for r, g, b in palette)
    off = 14 + len(info) + len(pal)
    head = b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off)
    return head + info + pal + pixels


def _rows(data: np.ndarray, stride: int, top_down=False) -> bytes:
    """(H, nbytes) uint8 rows, padded to ``stride``, bottom-up."""
    h = data.shape[0]
    out = np.zeros((h, stride), np.uint8)
    out[:, :data.shape[1]] = data
    return (out if top_down else out[::-1]).tobytes()


def _packed_indices(idx: np.ndarray, bits: int) -> np.ndarray:
    h, w = idx.shape
    b = np.unpackbits(idx.astype(np.uint8)[..., None], axis=-1)[..., 8 - bits:]
    return np.packbits(b.reshape(h, -1), axis=-1)


# --- the fixtures -------------------------------------------------------------

def _jpeg(im, **kw):
    b = io.BytesIO()
    im.save(b, "JPEG", **kw)
    return b.getvalue()


def _pil_png(im, **kw):
    b = io.BytesIO()
    im.save(b, "PNG", **kw)
    return b.getvalue()


def _pil_bmp(im):
    b = io.BytesIO()
    im.save(b, "BMP")
    return b.getvalue()


def fixtures():
    """(name, format, what it exercises, bytes) of every fixture."""
    out = []

    def add(name, fmt, what, data):
        out.append((name, fmt, what, data))

    big = Image.fromarray(picture(256, 320, 1))
    small = picture(47, 61, 2)
    add("jpeg_baseline.jpg", "jpeg", "baseline 4:2:0 (PIL)",
        _jpeg(Image.fromarray(small), quality=85))
    add("jpeg_progressive_320x256.jpg", "jpeg", "progressive 4:2:0 (PIL)",
        _jpeg(big, progressive=True, quality=90))
    add("jpeg_progressive_444_restart.jpg", "jpeg",
        "progressive 4:4:4, restart every 3 MCUs",
        _jpeg(Image.fromarray(small), progressive=True, subsampling=0,
              restart_marker_blocks=3))
    add("jpeg_progressive_422.jpg", "jpeg", "progressive 4:2:2",
        _jpeg(Image.fromarray(small), progressive=True, subsampling=1))
    add("jpeg_progressive_gray.jpg", "jpeg", "progressive gray",
        _jpeg(Image.fromarray(small[..., 0]), progressive=True))
    cmyk = Image.fromarray(picture(40, 48, 3, 4), "CMYK")
    add("jpeg_cmyk.jpg", "jpeg", "Adobe CMYK (transform 0)",
        _jpeg(cmyk, quality=90))
    add("jpeg_cmyk_progressive.jpg", "jpeg", "Adobe CMYK, progressive",
        _jpeg(cmyk, quality=90, progressive=True))
    ycck = bytearray(_jpeg(cmyk, quality=90))
    at = ycck.find(b"Adobe")
    ycck[at + 11] = 2                  # the Adobe transform: YCCK
    add("jpeg_ycck.jpg", "jpeg", "Adobe YCCK (transform 2)", bytes(ycck))
    prog = _jpeg(Image.fromarray(small), progressive=True)
    sos = [i for i in range(len(prog) - 1)
           if prog[i] == 0xFF and prog[i + 1] == 0xDA]
    add("jpeg_progressive_smoothed.jpg", "jpeg",
        "progressive, last scan cut (libjpeg block-smooths: the port "
        "refuses)", prog[:sos[-1]] + b"\xff\xd9")

    g = picture(29, 37, 4)
    gray = g[..., :1]
    for depth in (1, 2, 4):
        s = (gray >> (8 - depth)).astype(np.uint8)
        add(f"png_gray{depth}.png", "png", f"gray {depth}-bit",
            write_png(s, depth, 0))
    add("png_gray8.png", "png", "gray 8-bit (PIL)",
        _pil_png(Image.fromarray(gray[..., 0])))
    g16 = (gray.astype(np.uint16) * 3 + 100)   # spans past 255: clipped
    add("png_gray16.png", "png", "gray 16-bit (I;16, clipped)",
        write_png(g16, 16, 0, filter_start=2))
    add("png_gray8_trns.png", "png", "gray 8-bit with tRNS",
        write_png(gray, 8, 0, trns=struct.pack(">H", int(gray[0, 0, 0]))))
    add("png_graya8.png", "png", "gray + alpha 8-bit",
        write_png(g[..., :2], 8, 4, filter_start=1))
    add("png_graya16.png", "png", "gray + alpha 16-bit",
        write_png(g[..., :2].astype(np.uint16) * 257 + 3, 16, 4))
    add("png_rgb8.png", "png", "RGB 8-bit (PIL)",
        _pil_png(Image.fromarray(g)))
    add("png_rgb8_filters.png", "png", "RGB 8-bit, filters 0-4",
        write_png(g, 8, 2, filter_start=3))
    add("png_rgb16.png", "png", "RGB 16-bit",
        write_png(g.astype(np.uint16) * 251 + 7, 16, 2))
    add("png_rgb8_trns.png", "png", "RGB 8-bit with tRNS",
        write_png(g, 8, 2, trns=struct.pack(">HHH", *map(int, g[0, 0]))))
    rgba = picture(29, 37, 5, 4)
    add("png_rgba8.png", "png", "RGBA 8-bit (PIL)",
        _pil_png(Image.fromarray(rgba, "RGBA")))
    add("png_rgba16.png", "png", "RGBA 16-bit",
        write_png(rgba.astype(np.uint16) * 257, 16, 6, filter_start=4))
    rng = np.random.RandomState(6)
    for depth in (1, 2, 4, 8):
        n = 1 << depth
        pal = rng.randint(0, 256, (n, 3))
        idx = (g[..., :1].astype(np.int64) * n // 256).astype(np.uint8)
        add(f"png_pal{depth}.png", "png", f"palette {depth}-bit",
            write_png(idx, depth, 3, palette=pal, filter_start=depth))
    idx = (g[..., :1].astype(np.int64) * 256 // 256).astype(np.uint8)
    pal = rng.randint(0, 256, (256, 3))
    add("png_pal8_trns.png", "png", "palette 8-bit with tRNS alphas",
        write_png(idx, 8, 3, palette=pal,
                  trns=bytes(rng.randint(0, 256, 200).astype(np.uint8))))
    add("png_pal4_short_plte.png", "png",
        "palette 4-bit, indices past a 10-entry PLTE",
        write_png((g[..., :1] >> 4).astype(np.uint8), 4, 3,
                  palette=pal[:10]))
    big_rgba = picture(256, 256, 7, 4)
    add("png_rgba8_adam7_256.png", "png", "RGBA 8-bit, Adam7, 256x256",
        write_png(big_rgba, 8, 6, interlace=True, idat_split=5))
    add("png_gray2_adam7.png", "png", "gray 2-bit, Adam7",
        write_png((gray >> 6).astype(np.uint8), 2, 0, interlace=True))
    add("png_pal4_adam7.png", "png", "palette 4-bit, Adam7",
        write_png((g[..., :1] >> 4).astype(np.uint8), 4, 3,
                  palette=pal[:16], interlace=True, filter_start=2))
    add("png_rgb16_adam7.png", "png", "RGB 16-bit, Adam7",
        write_png(g.astype(np.uint16) * 257, 16, 2, interlace=True))
    add("png_rgb8_multi_idat.png", "png", "RGB 8-bit over 7 IDAT chunks",
        write_png(g, 8, 2, idat_split=7, filter_start=1))
    add("png_named_as.jpg", "png", "a PNG file named .jpg",
        write_png(g, 8, 2, filter_start=4))
    bad_crc = bytearray(write_png(g, 8, 2))
    bad_crc[29] ^= 0xFF                # IHDR's CRC
    add("png_bad_ihdr_crc.png", "png", "bad IHDR checksum (PIL refuses)",
        bytes(bad_crc))

    b = picture(23, 33, 8)
    pal16 = rng.randint(0, 256, (16, 3))
    pal256 = rng.randint(0, 256, (256, 3))
    pal2 = np.array([[200, 30, 10], [20, 40, 220]])
    i1 = (b[..., 0] > 127).astype(np.uint8)
    i4 = (b[..., 0] >> 4).astype(np.uint8)
    i8 = b[..., 0]
    w, h = 33, 23

    def stride(bits):
        return ((w * bits + 31) >> 3) & ~3

    add("bmp_pal1.bmp", "bmp", "1-bit palette",
        write_bmp(_rows(_packed_indices(i1, 1), stride(1)), w, h, 1,
                  palette=pal2))
    add("bmp_pal4.bmp", "bmp", "4-bit palette",
        write_bmp(_rows(_packed_indices(i4, 4), stride(4)), w, h, 4,
                  palette=pal16))
    add("bmp_pal8.bmp", "bmp", "8-bit palette (PIL)",
        _pil_bmp(Image.fromarray(b).quantize(200)))
    add("bmp_rgb24.bmp", "bmp", "24-bit (PIL)", _pil_bmp(Image.fromarray(b)))
    bgr = b[..., ::-1]
    x32 = np.concatenate([bgr, np.full((h, w, 1), 77, np.uint8)], -1)
    add("bmp_rgb32.bmp", "bmp", "32-bit BGRX",
        write_bmp(_rows(x32.reshape(h, -1), w * 4), w, h, 32))
    r5, g5, b5 = (b[..., i].astype(np.uint16) >> 3 for i in range(3))
    v555 = (r5 << 10) | (g5 << 5) | b5
    add("bmp_rgb16_555.bmp", "bmp", "16-bit 555",
        write_bmp(_rows(v555.astype("<u2").view(np.uint8).reshape(h, -1),
                        stride(16)), w, h, 16))
    add("bmp_bitfields_555.bmp", "bmp", "16-bit bitfields 555",
        write_bmp(_rows(v555.astype("<u2").view(np.uint8).reshape(h, -1),
                        stride(16)), w, h, 16, compression=3,
                  masks=(0x7C00, 0x3E0, 0x1F)))
    v565 = ((b[..., 0].astype(np.uint16) >> 3) << 11) | (
        (b[..., 1].astype(np.uint16) >> 2) << 5) | (b[..., 2] >> 3)
    add("bmp_bitfields_565.bmp", "bmp", "16-bit bitfields 565",
        write_bmp(_rows(v565.astype("<u2").view(np.uint8).reshape(h, -1),
                        stride(16)), w, h, 16, compression=3,
                  masks=(0xF800, 0x7E0, 0x1F)))
    add("bmp_bitfields32_v4.bmp", "bmp", "32-bit bitfields, V4 header",
        write_bmp(_rows(x32.reshape(h, -1), w * 4), w, h, 32, header=108,
                  compression=3, masks=(0xFF0000, 0xFF00, 0xFF, 0)))
    rgba32 = np.concatenate([b, np.full((h, w, 1), 99, np.uint8)], -1)
    add("bmp_rgba32_v5.bmp", "bmp", "32-bit RGBA bitfields, V5 header",
        write_bmp(_rows(rgba32.reshape(h, -1), w * 4), w, h, 32, header=124,
                  compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)))
    add("bmp_rgb24_v5.bmp", "bmp", "24-bit, V5 header",
        write_bmp(_rows(bgr.reshape(h, -1), stride(24)), w, h, 24,
                  header=124))
    add("bmp_topdown.bmp", "bmp", "24-bit top-down (negative height)",
        write_bmp(_rows(bgr.reshape(h, -1), stride(24), top_down=True), w,
                  h, 24, top_down=True))
    add("bmp_os2_core.bmp", "bmp", "8-bit palette, OS/2 core header",
        write_bmp(_rows(i8[:, :, None].reshape(h, -1), stride(8)), w, h, 8,
                  header=12, palette=pal256))
    add("bmp_rle4.bmp", "bmp", "RLE4",
        write_bmp(_rle(i4, True), w, h, 4, compression=2, palette=pal16))
    bb = picture(256, 256, 9)
    i8b = (bb[..., 0] // 16 * 16).astype(np.uint8)     # runs
    add("bmp_rle8_256.bmp", "bmp", "RLE8, 256x256",
        write_bmp(_rle(i8b, False), 256, 256, 8, compression=1,
                  palette=pal256))
    add("bmp_bits2.bmp", "bmp", "2-bit pixels (PIL refuses)",
        write_bmp(_rows(_packed_indices(i1, 2), stride(2)), w, h, 2,
                  palette=pal16[:4]))
    add("bmp_bad_bitfields.bmp", "bmp",
        "16-bit bitfields 444 (PIL refuses the layout)",
        write_bmp(_rows(v555.astype("<u2").view(np.uint8).reshape(h, -1),
                        stride(16)), w, h, 16, compression=3,
                  masks=(0xF00, 0xF0, 0xF)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    manifest, total = {}, 0
    for name, fmt, what, data in fixtures():
        path = os.path.join(args.out, name)
        with open(path, "wb") as f:
            f.write(data)
        total += len(data)
        try:
            with Image.open(path) as im:
                want = np.asarray(im.convert("RGB"))
            pil = "ok"
        except Exception:              # PIL refuses the file
            want, pil = None, "raises"
        # the port reads what PIL reads, but the file PIL block-smooths
        port = "raises" if pil == "raises" or "smoothed" in name else "ok"
        if port == "ok":
            np.save(os.path.join(args.out, name + ".npy"), want)
            total += want.nbytes + 128
        manifest[name] = {"format": fmt, "what": what, "pil": pil,
                          "port": port}
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"{len(manifest)} fixtures, {total} bytes, in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
