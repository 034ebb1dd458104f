"""PIL's bilinear resize of 8-bit RGB, bit for bit.

``resize(img, (w, h), box)`` computes what Pillow's
``Image.resize((w, h), Image.BILINEAR, box=box)`` computes for an RGB
image (``Resample.c``): per axis, double-precision triangle coefficients
over a support scaled by ``max(scale, 1)``, each output's weights
normalised to sum 1 and rounded to int32 with 22 fractional bits (the box
taken as floats, as Pillow takes it); then a horizontal pass over only
the input rows the vertical pass needs and a vertical pass, each summing
from ``1 << 21``, shifting by 22 and clipping to uint8. A pass whose axis
is unchanged is skipped, as Pillow skips it. The whole resize is one C++
call (``csrc/jpeg_entropy.cpp`` ``resample_rgb``), which drops the GIL.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["resize"]


def resize(img: np.ndarray, size: Tuple[int, int],
           box: Optional[Sequence[float]] = None) -> np.ndarray:
    """(H, W, 3) uint8 -> (size[1], size[0], 3) uint8, as
    ``Image.fromarray(img).resize(size, Image.BILINEAR, box=box)``."""
    from apex_tpu_torch.data.jpeg import _lib, _ptr

    img = np.ascontiguousarray(img, np.uint8)
    in_h, in_w = img.shape[:2]
    out_w, out_h = int(size[0]), int(size[1])
    box = (0, 0, in_w, in_h) if box is None else tuple(box)
    if (in_w, in_h) == (out_w, out_h) and box == (0, 0, in_w, in_h):
        return img.copy()
    out = np.empty((out_h, out_w, 3), np.uint8)
    fbox = np.asarray(box, np.float32)
    if _lib().resample_rgb(_ptr(img), in_w, in_h, _ptr(fbox), out_w, out_h,
                           _ptr(out)):
        raise ValueError(f"cannot resize {in_w}x{in_h} to {size}")
    return out
