"""apex_tpu_torch.data — input pipeline (decode → augment → device prefetch).

The port of ``apex_tpu.data``: a threaded JPEG decode+augment source over
an ImageFolder tree, a packed pre-decoded uint8 cache, a pinned-memory
side-stream prefetcher to the card, and measurement helpers that report
whether a configuration is input-bound or compute-bound. Decoding runs
through the port's own decoders, picked from each file's first bytes as
PIL picks them (:mod:`~apex_tpu_torch.data.image`): JPEG
(:mod:`~apex_tpu_torch.data.jpeg`, C++ stages built at first use:
baseline, extended and progressive Huffman, gray, YCbCr, RGB, CMYK and
YCCK), PNG (:mod:`~apex_tpu_torch.data.png`: every bit depth and colour
type, Adam7) and BMP (:mod:`~apex_tpu_torch.data.bmp`: palettes, 16/24/32
bits, bitfields, RLE), and PIL's bilinear resampler
(:mod:`~apex_tpu_torch.data.resample`), each equal to PIL 12 bit for bit.
PIL itself is never imported (the card's machine has PIL 12.2 and the
port does not need it). Arithmetic-coded JPEG, and progressive JPEG that
libjpeg would block-smooth, raise ``OSError``.
"""

from apex_tpu_torch.data.pipeline import (
    DevicePrefetcher,
    ImageFolderSource,
    make_fake_imagefolder,
    measure_source,
    normalize_uint8,
    synthetic_source,
)
from apex_tpu_torch.data.packed import PackedSource, build_cache

__all__ = [
    "DevicePrefetcher", "ImageFolderSource", "make_fake_imagefolder",
    "measure_source", "normalize_uint8", "synthetic_source",
    "PackedSource", "build_cache",
]
