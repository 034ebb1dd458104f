"""The launch convention every arena kernel shares.

Port of ``apex_tpu/ops/_dispatch.py``'s ``launch`` / ``as_rows``:

- operands are flat contiguous 1-D buffers of one length, a multiple of
  ``BUFFER_MULTIPLE`` (as :func:`apex_tpu_torch.arena.flatten` pads them),
  so a kernel's power-of-two block never needs a mask;
- a kernel runs one 1-D grid over the buffer, and indexes it in int64, so
  no buffer length is too long for it;
- runtime scalars (lr, betas, bias corrections, the clip factor) reach the
  kernel as one f32 device tensor, the counterpart of the TPU kernels'
  SMEM scalar vector: a value computed on the device (a step count, a
  global norm, a schedule's lr) is never read back to the host.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.arena.arena import BUFFER_MULTIPLE
from apex_tpu_torch.ops import _build


def check_length(*bufs) -> int:
    """The common length of 1-D buffers; raises unless it is a multiple of
    ``BUFFER_MULTIPLE``."""
    n = bufs[0].numel()
    for b in bufs:
        if b.dim() != 1 or b.numel() != n:
            raise ValueError(f"arena operands must be 1-D buffers of one "
                             f"length; got shapes "
                             f"{[tuple(x.shape) for x in bufs]}")
    if n % BUFFER_MULTIPLE:
        raise ValueError(f"arena buffer length {n} is not a multiple of "
                         f"BUFFER_MULTIPLE = {BUFFER_MULTIPLE}; flat "
                         f"optimizer buffers come from arena.flatten")
    return n


def check_buffers(*bufs, dtypes=None) -> int:
    """Kernel operands: contiguous buffers on one CUDA device, of one
    length that is a multiple of ``BUFFER_MULTIPLE``."""
    _build.check_operands(*bufs, dtypes=dtypes)
    return check_length(*bufs)


def device_scalars(values, device) -> torch.Tensor:
    """One f32 device vector of ``values``: Python numbers or device
    scalars, which stay on the device."""
    return torch.stack([
        v.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=torch.float32, device=device)
        for v in values])
