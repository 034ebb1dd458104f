"""Read an image file as the JAX loader reads it: ``read_rgb(path)``.

The JAX package opens every file with ``PIL.Image.open(path).convert(
"RGB")``; PIL picks the format from the file's first bytes, whatever its
extension. So does :func:`read_rgb`: ``\\xFF\\xD8`` is JPEG
(:mod:`~apex_tpu_torch.data.jpeg`), ``\\x89PNG\\r\\n\\x1a\\n`` PNG
(:mod:`~apex_tpu_torch.data.png`), ``BM`` BMP
(:mod:`~apex_tpu_torch.data.bmp`); each decoder gives PIL's pixels bit
for bit. Anything else raises ``OSError`` naming the file, as PIL's
``UnidentifiedImageError`` (an ``OSError``) does.
"""

from __future__ import annotations

import numpy as np

from apex_tpu_torch.data import bmp, jpeg, png

__all__ = ["read_rgb", "decode", "format_of"]


def format_of(data: bytes):
    """``"jpeg"``, ``"png"``, ``"bmp"`` or None, from the first bytes."""
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:8] == png.SIGNATURE:
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    return None


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A file's bytes -> (H, W, 3) uint8 RGB, by the format they hold."""
    fmt = format_of(data)
    if fmt is None:
        raise OSError(f"cannot identify image file {name!r}")
    return {"jpeg": jpeg.decode, "png": png.decode,
            "bmp": bmp.decode}[fmt](data, name)


def read_rgb(path: str) -> np.ndarray:
    """Read and decode one file; an ``OSError`` names the path."""
    with open(path, "rb") as f:
        data = f.read()
    return decode(data, path)
