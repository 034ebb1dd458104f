"""Every image file the JAX loader reads, read by the port as PIL reads it.

The fixtures in ``tests/data/torch_image_formats/`` (made by
``scripts/torch_make_image_fixtures.py`` with PIL 12.1: progressive,
CMYK and YCCK JPEG, every PNG mode, every BMP mode) decode through
``data.image.read_rgb`` equal to ``Image.open(path).convert("RGB")`` bit
for bit, and to the committed ``.npy`` pixels; where PIL raises, the port
raises ``OSError``, and it raises for the progressive file PIL's
libjpeg block-smooths. The fixed-point colour steps are held exhaustively
on their 8-bit grids (BMP's 555 and 565 expansions, PIL's CMYK->RGB) and
on a dense sample (YCCK). A tree mixing every format gives the JAX
loader's batches bit for bit, raw and through the packed cache.
"""

import ctypes
import io
import json
import os
import shutil
import struct

import numpy as np
import pytest
from PIL import Image

import apex_tpu.data as jdata
from apex_tpu_torch.data import (ImageFolderSource, PackedSource, bmp,
                                 build_cache, image, jpeg)

DIR = os.path.join(os.path.dirname(__file__), "data", "torch_image_formats")
MANIFEST = json.load(open(os.path.join(DIR, "manifest.json")))
READ = sorted(n for n, v in MANIFEST.items() if v["port"] == "ok")
REFUSED = sorted(n for n, v in MANIFEST.items() if v["port"] == "raises")


def _pil(path_or_bytes):
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"))


def test_manifest_covers_every_format_and_mode():
    whats = " ".join(v["what"] for v in MANIFEST.values())
    for needed in ("progressive", "CMYK", "YCCK", "gray 1-bit", "gray 2-bit",
                   "gray 4-bit", "gray 16-bit", "gray + alpha 16-bit",
                   "RGB 16-bit", "RGBA 16-bit", "palette 1-bit",
                   "palette 8-bit with tRNS", "Adam7", "IDAT chunks",
                   "named .jpg", "1-bit palette", "4-bit palette",
                   "8-bit palette", "16-bit 555", "bitfields 565", "24-bit",
                   "32-bit", "RLE4", "RLE8", "top-down", "OS/2 core",
                   "V4 header", "V5 header"):
        assert needed in whats, needed
    sizes = [os.path.getsize(os.path.join(DIR, f)) for f in os.listdir(DIR)]
    assert sum(sizes) < 2 << 20
    assert sum(np.load(os.path.join(DIR, n + ".npy")).shape[0] >= 256
               for n in READ) >= 3


@pytest.mark.parametrize("name", READ)
def test_fixture_equals_pil(name):
    path = os.path.join(DIR, name)
    got = image.read_rgb(path)
    want = _pil(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.load(path + ".npy"))


@pytest.mark.parametrize("name", REFUSED)
def test_port_raises_where_pil_raises_or_smooths(name):
    path = os.path.join(DIR, name)
    if MANIFEST[name]["pil"] == "raises":
        with pytest.raises(Exception):
            _pil(path)
    else:                       # the smoothed progressive file: PIL reads
        _pil(path)
    with pytest.raises(OSError, match=name.replace(".", r"\.")):
        image.read_rgb(path)


def test_format_comes_from_content_not_extension(tmp_path):
    png = os.path.join(DIR, "png_named_as.jpg")
    assert image.format_of(open(png, "rb").read(8)) == "png"
    for src, ext in (("jpeg_progressive_422.jpg", ".png"),
                     ("bmp_rle4.bmp", ".jpeg"), ("png_rgb16.png", ".bmp")):
        dst = tmp_path / (src + ext)
        shutil.copy(os.path.join(DIR, src), dst)
        np.testing.assert_array_equal(image.read_rgb(str(dst)),
                                      _pil(str(dst)))
    junk = tmp_path / "junk.jpg"
    junk.write_bytes(b"GIF89a" + bytes(64))
    with pytest.raises(OSError, match="junk.jpg"):
        image.read_rgb(str(junk))


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_png_unfilter_library_equals_numpy(bpp):
    """The codec library's PNG unfilter against the numpy wavefront, on
    random bytes under every filter type (rows of each type, and mixed)."""
    from apex_tpu_torch.data import png
    rng = np.random.RandomState(bpp)
    rows, rowbytes = 23, bpp * 19
    raw = rng.randint(0, 256, (rows, rowbytes + 1)).astype(np.uint8)
    raw[:, 0] = np.r_[np.repeat(np.arange(5), 3), rng.randint(0, 5, 8)]
    raw = raw.reshape(-1)
    np.testing.assert_array_equal(
        png._unfilter(raw, rows, rowbytes, bpp, OSError),
        png._unfilter_plain(raw, rows, rowbytes, bpp, OSError))
    raw = raw.copy()
    raw[rowbytes + 1] = 5                   # row 1's filter type
    with pytest.raises(OSError, match="filter type 5"):
        png._unfilter(raw, rows, rowbytes, bpp, OSError)


def _bmp16(values: np.ndarray, masks):
    h, w = values.shape
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 3, values.nbytes,
                       0, 0, 0, 0) + struct.pack("<III", *masks)
    body = values[::-1].astype("<u2").tobytes()
    off = 14 + len(info)
    return (b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + info
            + body)


@pytest.mark.parametrize("masks", [(0x7C00, 0x3E0, 0x1F),
                                   (0xF800, 0x7E0, 0x1F)],
                         ids=["555", "565"])
def test_bmp_16bit_expansion_exhaustive(masks):
    """Every 16-bit value (every 5- and 6-bit channel level) as PIL."""
    data = _bmp16(np.arange(65536, dtype=np.uint16).reshape(256, 256), masks)
    np.testing.assert_array_equal(bmp.decode(data), _pil(data))


def test_cmyk_to_rgb_exhaustive():
    """PIL's CMYK->RGB over every (c, k) pair, through the codec's colour
    stage (inverted CMYK planes, as a CMYK JPEG's samples)."""
    lib = jpeg._lib()
    c = np.arange(256, dtype=np.uint8)
    cc, kk = (np.ascontiguousarray(a) for a in np.meshgrid(c, c,
                                                           indexing="ij"))
    inv = np.ascontiguousarray(255 - cc)
    inv_k = np.ascontiguousarray(255 - kk)
    out = np.empty((256, 256, 3), np.uint8)
    p = ctypes.c_void_p
    lib.jpeg_color4(*(p(a.ctypes.data) for a in (inv, inv, inv, inv_k)),
                    256 * 256, 3, p(out.ctypes.data))
    want = np.asarray(Image.fromarray(
        np.stack([cc, cc, cc, kk], -1), "CMYK").convert("RGB"))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("progressive", [False, True])
def test_ycck_dense_sample(progressive):
    """A 96x128 YCCK file of noise at quality 100, 4:4:4: thousands of
    (Y, Cb, Cr, K) samples through libjpeg's YCCK->CMYK and PIL's steps."""
    rng = np.random.RandomState(3)
    cmyk = Image.fromarray(rng.randint(0, 256, (96, 128, 4)).astype(
        np.uint8), "CMYK")
    b = io.BytesIO()
    cmyk.save(b, "JPEG", quality=100, progressive=progressive)
    data = bytearray(b.getvalue())
    at = data.find(b"Adobe")
    data[at + 11] = 2
    data = bytes(data)
    np.testing.assert_array_equal(jpeg.decode(data), _pil(data))


@pytest.fixture(scope="module")
def mixed_tree(tmp_path_factory):
    """Every readable fixture, twice, under three class folders."""
    root = tmp_path_factory.mktemp("mixed")
    for i, name in enumerate(READ * 2):
        cls = root / f"class{i % 3}"
        cls.mkdir(exist_ok=True)
        shutil.copy(os.path.join(DIR, name), cls / f"{i:03d}_{name}")
    return str(root)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_mixed_tree_batches_equal_jax(mixed_tree, train):
    kw = dict(workers=2, seed=4, train=train)
    a = jdata.ImageFolderSource(mixed_tree, 8, 32, **kw)
    b = ImageFolderSource(mixed_tree, 8, 32, **kw)
    steps = len(READ) * 2 // 8 + 2                     # into a second epoch
    n = 0
    for (xa, ya), (xb, yb) in zip(a.batches(steps), b.batches(steps)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        n += 1
    assert n == steps


def test_mixed_tree_caches_equal_jax(mixed_tree, tmp_path):
    j = jdata.build_cache(mixed_tree, str(tmp_path / "j"), store_size=40,
                          shard_images=16)
    t = build_cache(mixed_tree, str(tmp_path / "t"), store_size=40,
                    shard_images=16)
    with jdata.PackedSource(j, 8, 32, seed=1, workers=2) as a, \
            PackedSource(t, 8, 32, seed=1, workers=2) as b:
        n = 0
        for (xa, ya), (xb, yb) in zip(a.batches(8), b.batches(8)):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)
            n += 1
        assert n == 8
