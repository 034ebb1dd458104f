"""The BERT MLM training step: amp O1 + FusedLAMB, auto_cast forward.

Port of ``bench._bert_step_builder``: the same model (BERT-Large unless an
encoder is given), the same inputs from ``np.random.RandomState(seed)``,
and the same step through the normal entry points: ``amp.Amp(policy,
FusedLAMB(lr=1e-3))``, ``Amp.backward``, ``Amp.apply_gradients`` and
``models.mlm_loss`` under ``amp.auto_cast``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from apex_tpu_torch import amp, models
from apex_tpu_torch.optim import FusedLAMB


def build_bert_step(batch: int, seq: int, encoder=None, opt_level="O1",
                    half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                    vocab: Optional[int] = None):
    """Returns ``(step, state, (toks, labels), policy, enc)``.

    ``step(state, toks, labels) -> (state', loss)`` runs one training step.
    ``encoder=None`` builds BERT-Large on ``device``; tokens and labels are
    drawn below ``vocab`` (default: 30000, as ``bench.py`` draws them, or
    the encoder's vocab if smaller).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_bert_step runs on cuda by default and no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain versions on the CPU")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    enc = encoder if encoder is not None else models.BertLarge(
        device=device, seed=seed)
    vocab = vocab if vocab is not None else min(30000, enc.vocab_size)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                           dtype=torch.int64, device=device)
    labels = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                             dtype=torch.int64, device=device)
    amp_opt = amp.Amp(policy, FusedLAMB(lr=1e-3))
    state = amp_opt.init(dict(enc.named_parameters()))

    def step(state, toks, labels):
        def loss_fn(mp):
            with amp.auto_cast(policy):
                return models.mlm_loss(enc, mp, toks, labels)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    return step, state, (toks, labels), policy, enc
