"""The training steps: BERT MLM (amp O1 + FusedLAMB, auto_cast forward)
and ResNet-50 (amp O2 + FusedSGD).

``build_bert_step`` is the port of ``bench._bert_step_builder``: the same
model (BERT-Large unless an encoder is given), the same inputs from
``np.random.RandomState(seed)``, and the same step through the normal
entry points: ``amp.Amp(policy, FusedLAMB(lr=1e-3, strategy=strategy))``,
``Amp.backward``,
``Amp.apply_gradients`` and ``models.mlm_loss`` under ``amp.auto_cast``.
``strategy`` is ``FusedLAMB``'s own option ("auto", the JAX step's
default, takes the tree update for BERT-Large and the flat arena for a
model below 8M params; "arena" forces the arena kernels).

``build_resnet_step`` is the port of ``bench._resnet_step_builder``:
ResNet-50 (NHWC, the model computing in the policy's compute dtype), the
same inputs from ``np.random.RandomState(seed)`` (pre-cast to the compute
dtype when the policy casts the model), ``Amp(policy, FusedSGD(lr=0.1,
momentum=0.9, strategy=strategy))``, and the mean fused cross-entropy as
the loss, with the new BN running statistics as the loss's aux output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from apex_tpu_torch import amp, models, ops
from apex_tpu_torch.optim import FusedLAMB, FusedSGD


def _device(device, entry):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} runs on cuda by default and no CUDA "
                           f"device is available; pass device='cpu' to run "
                           f"the plain versions on the CPU")
    return device


def build_bert_step(batch: int, seq: int, encoder=None, opt_level="O1",
                    half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                    vocab: Optional[int] = None, strategy: str = "auto"):
    """Returns ``(step, state, (toks, labels), policy, enc)``.

    ``step(state, toks, labels) -> (state', loss)`` runs one training step.
    ``encoder=None`` builds BERT-Large on ``device``; tokens and labels are
    drawn below ``vocab`` (default: 30000, as ``bench.py`` draws them, or
    the encoder's vocab if smaller).
    """
    device = _device(device, "build_bert_step")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    enc = encoder if encoder is not None else models.BertLarge(
        device=device, seed=seed)
    vocab = vocab if vocab is not None else min(30000, enc.vocab_size)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                           dtype=torch.int64, device=device)
    labels = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                             dtype=torch.int64, device=device)
    amp_opt = amp.Amp(policy, FusedLAMB(lr=1e-3, strategy=strategy))
    state = amp_opt.init(dict(enc.named_parameters()))

    def step(state, toks, labels):
        def loss_fn(mp):
            with amp.auto_cast(policy):
                return models.mlm_loss(enc, mp, toks, labels)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    return step, state, (toks, labels), policy, enc


def build_resnet_step(batch: int, size: int, opt_level: str = "O2",
                      half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                      model=None, strategy: str = "auto"):
    """Returns ``(step, (state, batch_stats), (x, y), policy, model)``.

    ``step(state, batch_stats, x, y) -> (state', batch_stats', loss)`` runs
    one training step. ``model=None`` builds ResNet-50 (1000 classes, the
    policy's compute dtype) on ``device``; labels are drawn below the
    model's ``num_classes``.
    """
    device = _device(device, "build_resnet_step")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    if model is None:
        model = models.ResNet50(num_classes=1000, dtype=policy.compute_dtype,
                                device=device, seed=seed)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.rand(batch, size, size, 3).astype(np.float32),
                        device=device)
    # inputs arrive pre-cast to the compute dtype, as a loader ships them
    if policy.cast_model_type is not None:
        x = x.to(policy.compute_dtype)
    y = torch.as_tensor(rng.randint(0, model.num_classes, batch),
                        dtype=torch.int64, device=device)
    amp_opt = amp.Amp(policy, FusedSGD(lr=0.1, momentum=0.9,
                                       strategy=strategy))
    state = amp_opt.init(dict(model.named_parameters()))
    batch_stats = {k: b.detach().clone() for k, b in model.named_buffers()}

    def step(state, batch_stats, xb, yb):
        def loss_fn(mp):
            logits, new_bs = functional_call(
                model, {**mp, **batch_stats}, (xb,), {"train": True})
            loss = torch.mean(ops.softmax_cross_entropy_loss(logits, yb))
            return loss, new_bs

        (loss, new_bs), grads, state, finite = amp_opt.backward(
            state, loss_fn, has_aux=True)
        return amp_opt.apply_gradients(state, grads, finite), new_bs, loss

    return step, (state, batch_stats), (x, y), policy, model
