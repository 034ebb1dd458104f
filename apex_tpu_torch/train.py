"""The training steps: BERT MLM (amp O1 + FusedLAMB or another fused
optimizer, auto_cast forward), ResNet-50 (amp O2 + FusedSGD) and DCGAN
(two amp bundles, three losses, FusedAdam).

``build_bert_step`` is the port of ``bench._bert_step_builder``: the same
model (BERT-Large unless an encoder is given), the same inputs from
``np.random.RandomState(seed)``, and the same step through the normal
entry points: ``amp.Amp(policy, FusedLAMB(lr=1e-3, strategy=strategy))``,
``Amp.backward``, ``Amp.apply_gradients``, and the encoder with
``models.mlm_loss``'s head under ``amp.auto_cast``. ``strategy`` is
``FusedLAMB``'s own option ("auto", the JAX step's default, takes the
tree update for BERT-Large and the flat arena for a model below 8M
params; "arena" forces the arena kernels); ``optimizer=`` trains the same
step with another optimizer instead (``FusedNovoGrad``,
``FusedAdagrad``), which brings its own strategy. ``dropout=0.1,
padded=True`` trains BERT as published: padding masks and attention
dropout, the encoder called as the JAX package's ``BertEncoder(tokens,
attn_mask, deterministic=False)`` with the MLM head of ``mlm_loss``.

``build_resnet_step`` is the port of ``bench._resnet_step_builder``:
ResNet-50 (NHWC, the model computing in the policy's compute dtype), the
same inputs from ``np.random.RandomState(seed)`` (pre-cast to the compute
dtype when the policy casts the model), ``Amp(policy, FusedSGD(lr=0.1,
momentum=0.9, strategy=strategy))``, and the mean fused cross-entropy as
the loss, with the new BN running statistics as the loss's aux output.

``build_dcgan_step`` is the port of the ``step`` in ``bench._bench_dcgan``,
line for line: a generator and a discriminator, each under its own
``amp.Amp(policy, FusedAdam(lr=2e-4, betas=(0.5, 0.999)))`` (D's with
``num_losses=2``), every model call under ``amp.auto_cast``, and three
scaled backwards a step: D on the real batch (``loss_id=0``), D on the
detached fake batch (``loss_id=1``), then G through D.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from apex_tpu_torch import amp, models, ops
from apex_tpu_torch.models.transformer import _mlm_head
from apex_tpu_torch.optim import FusedAdam, FusedLAMB, FusedSGD


def _device(device, entry):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{entry} runs on cuda by default and no CUDA "
                           f"device is available; pass device='cpu' to run "
                           f"the plain versions on the CPU")
    return device


def build_bert_step(batch: int, seq: int, encoder=None, opt_level="O1",
                    half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                    vocab: Optional[int] = None, strategy: str = "auto",
                    dropout: float = 0.0, padded: bool = False,
                    optimizer=None):
    """Returns ``(step, state, (toks, labels), policy, enc)``.

    ``optimizer=None`` trains with ``FusedLAMB(lr=1e-3, strategy=
    strategy)``; an optimizer given (``FusedNovoGrad(...)``,
    ``FusedAdagrad(...)``, ...) is used as it is and brings its own
    strategy, so passing ``strategy`` with it raises.

    ``step(state, toks, labels) -> (state', loss)`` runs one training step.
    ``encoder=None`` builds BERT-Large on ``device`` (with attention dropout
    ``dropout``; a given encoder brings its own); tokens and labels are
    drawn below ``vocab`` (default: 30000, as ``bench.py`` draws them, or
    the encoder's vocab if smaller).

    BERT as published trains with ``dropout=0.1, padded=True``: each
    sequence's length is drawn from [128, seq] after the tokens and labels,
    the encoder gets the padding mask (``step.attn_mask``) and labels at
    padded positions are -1, which the loss ignores; an encoder with
    dropout > 0 runs ``deterministic=False`` and draws its dropout seeds
    from ``step.generator`` (a ``torch.Generator`` on ``device`` seeded with
    ``seed``).
    """
    device = _device(device, "build_bert_step")
    if optimizer is None:
        optimizer = FusedLAMB(lr=1e-3, strategy=strategy)
    elif strategy != "auto":
        raise ValueError("build_bert_step takes strategy= for its default "
                         "FusedLAMB only; set it on the optimizer given")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    enc = encoder if encoder is not None else models.BertLarge(
        device=device, seed=seed, dropout=dropout)
    vocab = vocab if vocab is not None else min(30000, enc.vocab_size)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, vocab, (batch, seq)),
                           dtype=torch.int64, device=device)
    labels = rng.randint(0, vocab, (batch, seq))
    attn_mask = None
    if padded:
        lengths = rng.randint(128, seq + 1, batch)
        mask = np.arange(seq) < lengths[:, None]
        labels = np.where(mask, labels, -1)
        attn_mask = torch.as_tensor(mask, device=device)
    labels = torch.as_tensor(labels, dtype=torch.int64, device=device)
    amp_opt = amp.Amp(policy, optimizer)
    state = amp_opt.init(dict(enc.named_parameters()))
    gen = torch.Generator(device).manual_seed(seed)
    kwargs = {"deterministic": enc.dropout == 0.0, "generator": gen}

    def step(state, toks, labels):
        def loss_fn(mp):
            with amp.auto_cast(policy):
                hidden = functional_call(enc, mp, (toks, attn_mask), kwargs)
                return _mlm_head(hidden, mp["tok_emb.weight"], labels)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    step.attn_mask, step.generator = attn_mask, gen
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


def bce(logit, target):
    """Binary cross-entropy on logits, in the logits' dtype (the O1 patch
    surface has no ``exp``/``log1p``, so under O1 it runs in the half
    dtype, as the JAX step's does)."""
    return torch.mean(torch.clamp_min(logit, 0) - logit * target
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def build_dcgan_step(batch: int, opt_level: str = "O1",
                     half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                     nz: int = 100, ngf: int = 64, ndf: int = 64,
                     strategy: str = "auto", **policy_overrides):
    """Returns ``(step, (gstate, dstate, g_bs, d_bs), (z, real), policy,
    (G, D))``.

    ``step(gstate, dstate, g_bs, d_bs, z, real) -> (gstate', dstate',
    g_bs', d_bs', (loss_d_real, loss_d_fake, loss_g))`` runs one step. The
    models are ``Generator(nz, ngf)`` and ``Discriminator(ndf)`` on
    ``device`` with weights from ``seed`` (D's from ``seed + 1``); ``z``
    (batch, 1, 1, nz) and ``real`` (batch, 64, 64, 3) are drawn from
    ``np.random.RandomState(seed)`` as ``bench.py`` draws them.
    ``strategy`` is ``FusedAdam``'s ("auto" takes the arena at these
    sizes); ``policy_overrides`` go to ``Policy.from_opt_level`` (e.g.
    ``enabled=False`` runs everything in f32).
    """
    device = _device(device, "build_dcgan_step")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype,
                                       **policy_overrides)
    G = models.Generator(nz=nz, ngf=ngf, device=device, seed=seed)
    D = models.Discriminator(ndf=ndf, device=device, seed=seed + 1)
    rng = np.random.RandomState(seed)
    z = torch.as_tensor(rng.randn(batch, 1, 1, nz).astype(np.float32),
                        device=device)
    real = torch.as_tensor(rng.rand(batch, 64, 64, 3).astype(np.float32),
                           device=device)

    def adam():
        return FusedAdam(lr=2e-4, betas=(0.5, 0.999), strategy=strategy)

    ampG = amp.Amp(policy, adam())
    ampD = amp.Amp(policy, adam(), num_losses=2)
    gstate = ampG.init(dict(G.named_parameters()))
    dstate = ampD.init(dict(D.named_parameters()))
    g_bs = {k: b.detach().clone() for k, b in G.named_buffers()}
    d_bs = {k: b.detach().clone() for k, b in D.named_buffers()}
    train = {"train": True}

    def step(gstate, dstate, g_bs, d_bs, z, real):
        with amp.auto_cast(policy):
            fake, g_bs = functional_call(
                G, {**ampG.model_params(gstate), **g_bs}, (z,), train)

        def d_real(mp):
            with amp.auto_cast(policy):
                out, bs = functional_call(D, {**mp, **d_bs}, (real,), train)
            return bce(out, 1.0), bs

        (loss_real, d_bs2), gr, dstate, f1 = ampD.backward(
            dstate, d_real, loss_id=0, has_aux=True)
        dstate = ampD.apply_gradients(dstate, gr, f1)

        def d_fake(mp):
            with amp.auto_cast(policy):
                out, bs = functional_call(D, {**mp, **d_bs2},
                                          (fake.detach(),), train)
            return bce(out, 0.0), bs

        (loss_fake, d_bs3), gf, dstate, f2 = ampD.backward(
            dstate, d_fake, loss_id=1, has_aux=True)
        dstate = ampD.apply_gradients(dstate, gf, f2)

        def g_loss(mp):
            with amp.auto_cast(policy):
                fake2, bs = functional_call(G, {**mp, **g_bs}, (z,), train)
                # D at its twice-updated params; its new statistics are
                # dropped, as the JAX step drops them
                out = functional_call(
                    D, {**ampD.model_params(dstate), **d_bs3}, (fake2,),
                    train)[0]
            return bce(out.float(), 1.0), bs

        (loss_g, g_bs4), gg, gstate, f3 = ampG.backward(
            gstate, g_loss, has_aux=True)
        gstate = ampG.apply_gradients(gstate, gg, f3)
        return gstate, dstate, g_bs4, d_bs3, (loss_real, loss_fake, loss_g)

    return step, (gstate, dstate, g_bs, d_bs), (z, real), policy, (G, D)
