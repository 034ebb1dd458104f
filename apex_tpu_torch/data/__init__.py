"""apex_tpu_torch.data — input pipeline (decode → augment → device prefetch).

The port of ``apex_tpu.data``: a threaded JPEG decode+augment source over
an ImageFolder tree, a packed pre-decoded uint8 cache, a pinned-memory
side-stream prefetcher to the card, and measurement helpers that report
whether a configuration is input-bound or compute-bound. Decoding runs
through the port's own codec (:mod:`~apex_tpu_torch.data.jpeg`, C++
stages built at first use) and PIL's bilinear resampler
(:mod:`~apex_tpu_torch.data.resample`), each equal to PIL bit for bit;
PIL itself is never imported. Only JPEG files decode: PNG, BMP,
progressive and CMYK files raise ``OSError``.
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
