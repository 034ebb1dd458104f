"""DCGAN generator and discriminator, NHWC: the multi-model, multi-loss
amp example.

Port of ``apex_tpu/models/dcgan.py``. Submodule and parameter names follow
the flax auto-naming (``ConvTranspose_0..4`` and ``BatchNorm_0..3`` in the
generator, ``Conv_0..4`` and ``BatchNorm_0..2`` in the discriminator;
running statistics are the buffers ``BatchNorm_i.mean``/``var``), so
:func:`apex_tpu_torch.convert.dcgan_variables_from_jax` maps one tree onto
the other name for name, and O2's ``keep_batchnorm_fp32`` exempts the
``BatchNorm_i`` params as it does in the JAX package. Convolutions are
PyTorch's (cuDNN), as they are XLA's there; the BatchNorm is flax's
``nn.BatchNorm`` (:mod:`apex_tpu_torch.models.layers`), not the fused BN
unit.

In training ``forward`` returns ``(out, new_batch_stats)``; called through
``torch.func.functional_call`` with the params and the batch statistics,
it is the counterpart of flax's ``model.apply(..., mutable=
["batch_stats"])``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex_tpu_torch.models.layers import (
    BatchNorm, Conv, ConvTranspose, lecun_normal_,
)


class _DCGAN(nn.Module):
    """Seeded flax-style init and the batch-statistics bookkeeping."""

    def _init(self, device, seed):
        if torch.device(device).type == "meta":
            return
        gen = torch.Generator(device).manual_seed(seed)
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, (Conv, ConvTranspose)):
                    lecun_normal_(mod.weight, mod.fan_in, gen)

    def _collect(self, stats):
        new = {}
        for name, mod in self.named_modules():
            if mod in stats:
                new[f"{name}.mean"], new[f"{name}.var"] = stats[mod]
        return new


class Generator(_DCGAN):
    """z (N, 1, 1, nz) → image (N, 64, 64, nc) in [-1, 1]."""

    def __init__(self, nz: int = 100, ngf: int = 64, nc: int = 3,
                 device="cuda", seed: int = 0):
        super().__init__()
        widths = [ngf * 8, ngf * 4, ngf * 2, ngf]
        c_in = nz
        for i, c in enumerate(widths):
            first = i == 0
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(
                c_in, c, (4, 4), (1, 1) if first else (2, 2),
                padding="VALID" if first else "SAME", device=device))
            self.add_module(f"BatchNorm_{i}", BatchNorm(c, device=device))
            c_in = c
        self.ConvTranspose_4 = ConvTranspose(ngf, nc, (4, 4), (2, 2),
                                             device=device)
        self._init(device, seed)

    def forward(self, z, train: bool = True):
        stats = {} if train else None
        x = z
        for i in range(4):
            x = getattr(self, f"ConvTranspose_{i}")(x)
            x = F.relu(getattr(self, f"BatchNorm_{i}")(x, train, stats))
        x = torch.tanh(self.ConvTranspose_4(x))
        return (x, self._collect(stats)) if train else x


class Discriminator(_DCGAN):
    """image (N, 64, 64, nc) → logit (N,)."""

    def __init__(self, ndf: int = 64, nc: int = 3, device="cuda",
                 seed: int = 1):
        super().__init__()
        widths = [ndf, ndf * 2, ndf * 4, ndf * 8]
        c_in = nc
        for i, c in enumerate(widths):
            self.add_module(f"Conv_{i}", Conv(c_in, c, (4, 4), (2, 2),
                                              device=device))
            if i:
                self.add_module(f"BatchNorm_{i - 1}",
                                BatchNorm(c, device=device))
            c_in = c
        self.Conv_4 = Conv(ndf * 8, 1, (4, 4), padding=((0, 0), (0, 0)),
                           device=device)
        self._init(device, seed)

    def forward(self, x, train: bool = True):
        stats = {} if train else None
        for i in range(4):
            x = getattr(self, f"Conv_{i}")(x)
            if i:
                x = getattr(self, f"BatchNorm_{i - 1}")(x, train, stats)
            x = F.leaky_relu(x, 0.2)
        x = self.Conv_4(x).reshape(x.shape[0])
        return (x, self._collect(stats)) if train else x
