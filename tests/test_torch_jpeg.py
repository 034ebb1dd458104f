"""The port's JPEG codec and bilinear resampler against PIL, bit for bit.

PIL (libjpeg-turbo) is what the JAX loader decodes and resizes with; the
port's codec (``apex_tpu_torch.data.jpeg``, C++ stages built with the host
compiler at first use) and resampler (``apex_tpu_torch.data.resample``)
must give its pixels exactly. Stages one at a time: a grayscale file
holds the entropy stage and the IDCT alone, a 4:4:4 colour file adds the
colour tables, 4:2:0, 4:2:2 (and the port's 4:4:0) add the upsampler; odd
sizes exercise edge blocks. Then the encoder: its coefficients come back
from the decoder bit for bit and PIL decodes its files (restart intervals
included) to the port's pixels; its tables are PIL's. Unsupported files
raise ``OSError``.
"""

import io

import numpy as np
import pytest
from PIL import Image

from apex_tpu_torch.data import jpeg
from apex_tpu_torch.data.resample import resize

SIZES = [(8, 8), (50, 37), (64, 64), (256, 256)]     # (width, height)
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}
SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
            "4:4:0": (1, 2)}


def _image(w, h, seed, gray=False):
    """Noise over a gradient: smooth regions and busy ones."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 255 // max(w - 1, 1)), (y * 255 // max(h - 1, 1)),
                     ((x + y) * 3) % 256], -1)
    img = np.clip(base + rng.randint(-40, 41, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if gray else img


def _pil_bytes(arr, **kw):
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", **kw)
    return b.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("quality", [50, 85, 95])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["gray", *SUBSAMPLING])
def test_decode_equals_pil_on_pil_files(mode, size, quality):
    w, h = size
    if mode == "gray":
        data = _pil_bytes(_image(w, h, quality, gray=True), quality=quality)
    else:
        data = _pil_bytes(_image(w, h, quality), quality=quality,
                          subsampling=SUBSAMPLING[mode])
    got = jpeg.decode(data)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pil_rgb(data))


def test_grayscale_stages_alone():
    """One component: the entropy stage and the IDCT are the whole
    decode; the plane cropped to the image is PIL's "L" image."""
    data = _pil_bytes(_image(50, 37, 0, gray=True), quality=85)
    frame = jpeg.read_coefficients(data)
    assert frame.color == "gray" and len(frame.components) == 1
    plane = jpeg.idct(frame.components[0])
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(plane[:37, :50], want)


def test_idct_within_one_of_a_float_idct():
    """The integer IDCT against a float64 IDCT of the same dequantised
    coefficients: within ±1, the peak error IEEE 1180 allows."""
    data = _pil_bytes(_image(256, 256, 3), quality=95, subsampling=0)
    frame = jpeg.read_coefficients(data)
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    m[0] /= np.sqrt(2)
    for c in frame.components:
        rows, cols = c.coefs.shape[:2]
        deq = (c.coefs.astype(np.float64) * c.qtable).reshape(
            rows, cols, 8, 8)
        ref = np.einsum("ui,abuv,vj->abij", m, deq, m) + 128
        ref = np.clip(np.round(ref), 0, 255).transpose(0, 2, 1, 3)
        got = jpeg.idct(c).astype(np.float64)
        assert np.abs(got - ref.reshape(got.shape)).max() <= 1


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("restart", [0, 1, 3])
def test_encoder_round_trip_and_pil_decodes_it(sampling, restart):
    """The port's files: the decoder gives back the encoder's quantised
    coefficients bit for bit, and PIL decodes them to the port's pixels
    (restart markers and the 4:4:0 upsampler included)."""
    for w, h in [(50, 37), (64, 64)]:
        img = _image(w, h, restart)
        data, coefs = jpeg.encode(img, quality=85,
                                  sampling=SAMPLING[sampling],
                                  restart_interval=restart,
                                  return_coefficients=True)
        frame = jpeg.read_coefficients(data)
        assert frame.restart_interval == restart
        for c, want in zip(frame.components, coefs):
            np.testing.assert_array_equal(c.coefs, want)
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
    gray = jpeg.encode(_image(50, 37, 1, gray=True),
                       restart_interval=restart)
    np.testing.assert_array_equal(jpeg.decode(gray), _pil_rgb(gray))


def test_encoder_tables_are_pils():
    """quality-scaled IJG quantisation tables and the Annex K Huffman
    tables, as PIL writes them."""
    img = _image(16, 16, 0)
    for q in (10, 50, 85, 95, 100):
        im = Image.open(io.BytesIO(_pil_bytes(img, quality=q)))
        lq, cq = jpeg.quant_tables(q)
        assert list(im.quantization[0]) == list(lq)
        assert list(im.quantization[1]) == list(cq)
    data = _pil_bytes(img, quality=85)
    tables, pos = {}, 0
    names = {0x00: "dc_luma", 0x10: "ac_luma", 0x01: "dc_chroma",
             0x11: "ac_chroma"}
    while (pos := data.find(b"\xff\xc4", pos)) >= 0:
        seg = data[pos + 4:pos + 2 + int.from_bytes(data[pos + 2:pos + 4],
                                                    "big")]
        i = 0
        while i < len(seg):
            n = sum(seg[i + 1:i + 17])
            tables[names[seg[i]]] = (list(seg[i + 1:i + 17]),
                                     list(seg[i + 17:i + 17 + n]))
            i += 17 + n
        pos += 2
    assert tables == {k: (list(b), list(v))
                      for k, (b, v) in jpeg.STD_HUFFMAN.items()}


def test_fake_imagefolder_files_decode_like_pil(tmp_path):
    from apex_tpu_torch.data import make_fake_imagefolder
    root = make_fake_imagefolder(str(tmp_path), n_classes=1, per_class=2,
                                 size=64)
    for p in sorted((tmp_path / "class_000").iterdir()):
        data = p.read_bytes()
        np.testing.assert_array_equal(jpeg.decode(data), _pil_rgb(data))
    assert root == str(tmp_path)


def test_color_space_rules():
    """libjpeg's choice for 3 components: JFIF means YCbCr, else Adobe's
    transform flag, else component ids 'R','G','B' mean RGB."""
    c = [jpeg.Component(i, 1, 1, 0, 8, 8, None) for i in (1, 2, 3)]
    rgb = [jpeg.Component(i, 1, 1, 0, 8, 8, None) for i in (82, 71, 66)]
    assert jpeg._color_space(c, False, None) == "ycc"
    assert jpeg._color_space(rgb, False, None) == "rgb"
    assert jpeg._color_space(rgb, True, None) == "ycc"
    assert jpeg._color_space(c, False, 0) == "rgb"
    assert jpeg._color_space(c, False, 1) == "ycc"
    assert jpeg._color_space(c[:1], False, None) == "gray"


def _cmyk_bytes():
    b = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(b, format="JPEG")
    return b.getvalue()


def test_cmyk_file_decodes_like_pil():
    data = _cmyk_bytes()
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(jpeg.decode(data), want)


@pytest.mark.parametrize("kind,match", [
    ("truncated", "ends early|truncated"),
    ("progressive_smoothed", "block-smooths"),
    ("arithmetic", r"arithmetic-coded \(SOF9\).*0xFFC9"),
    ("png", "not a JPEG"),
])
def test_unsupported_or_broken_files_raise_oserror(kind, match, tmp_path):
    """What the codec refuses: a truncated file; a progressive file whose
    cut-short progression libjpeg would block-smooth (a whole progression,
    and CMYK, decode: tests/test_torch_image_formats.py); arithmetic
    coding; another format."""
    img = _image(64, 64, 5)
    if kind == "truncated":
        full = _pil_bytes(img, quality=85)
        data = full[:len(full) // 2]
    elif kind == "progressive_smoothed":
        full = _pil_bytes(img, quality=85, progressive=True)
        data = full[:full.rindex(b"\xff\xda")] + b"\xff\xd9"
    elif kind == "arithmetic":
        full = bytearray(_pil_bytes(img, quality=85))
        full[full.index(b"\xff\xc0") + 1] = 0xC9
        data = bytes(full)
    else:
        b = io.BytesIO()
        Image.fromarray(img).save(b, format="PNG")
        data = b.getvalue()
    path = tmp_path / f"x_{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(OSError, match=match) as ei:
        jpeg.read_rgb(str(path))
    assert str(path) in str(ei.value)


@pytest.mark.parametrize("seed", range(6))
def test_resize_equals_pil_bilinear_over_random_boxes(seed):
    """``Image.resize(size, BILINEAR, box=box)`` on RGB, up- and
    down-scaling, full and partial boxes, passes skipped or not."""
    rng = np.random.RandomState(seed)
    for trial in range(25):
        h, w = rng.randint(1, 200, 2)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        x0, y0 = rng.randint(0, w), rng.randint(0, h)
        x1, y1 = rng.randint(x0 + 1, w + 1), rng.randint(y0 + 1, h + 1)
        if trial % 5 == 0:
            x0, y0, x1, y1 = 0, 0, w, h
        ow, oh = (int(v) for v in rng.randint(1, 300, 2))
        if trial % 7 == 0:
            ow, oh = x1 - x0, y1 - y0        # a crop, no scaling
        want = np.asarray(Image.fromarray(img).resize(
            (ow, oh), Image.BILINEAR, box=(x0, y0, x1, y1)))
        np.testing.assert_array_equal(resize(img, (ow, oh),
                                             (x0, y0, x1, y1)), want)
