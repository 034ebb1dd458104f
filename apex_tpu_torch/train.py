"""The training steps: BERT MLM (amp O1 + FusedLAMB or another fused
optimizer, auto_cast forward), ResNet-50 (amp O0, O1 or O2 + FusedSGD or
another fused optimizer), the fused
MLP (amp O2 + 2:4 ASP around FusedAdam) and DCGAN (two amp bundles, three
losses, FusedAdam).

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
ResNet-50 (NHWC, the model computing in the policy's compute dtype: f32 at
O0, the half dtype at O1 and O2), the same inputs from
``np.random.RandomState(seed)`` (pre-cast to the compute dtype when the
policy casts the model, as at O2; f32 at O0 and O1), ``Amp(policy,
FusedSGD(lr=0.1, momentum=0.9, strategy=strategy))`` or ``Amp(policy,
optimizer)``, and the mean fused cross-entropy as the loss, with the new
BN running statistics as the loss's aux output. With ``bn_axis_name`` it
is ``bench._bench_resnet(sync_bn=True)``, BASELINE configuration 3: every
BN unit's statistics across the ranks of the mesh's ``data`` axis, the
gradients all-reduced over it with ``parallel.sync_gradients`` after the
amp backward (or by a ``DistributedDataParallel``'s ``sync``), each rank
training on its slice of the seeded global batch.

``build_mlp_step`` trains ``ops.MLP`` (DLRM's bottom MLP by default,
``--arch-mlp-bot=13-512-256-128``) under amp (O2 bf16 by default) with
``sparsity.ASP(FusedAdam(lr=1e-3), pattern="m4n2_1d")`` as the optimizer,
on an MSE loss to a target drawn from the seed. No JAX step builder trains
the MLP; its parity test builds the same step from JAX functions.

``build_dcgan_step`` is the port of the ``step`` in ``bench._bench_dcgan``,
line for line: a generator and a discriminator, each under its own
``amp.Amp(policy, FusedAdam(lr=2e-4, betas=(0.5, 0.999)))`` (D's with
``num_losses=2``), every model call under ``amp.auto_cast``, and three
scaled backwards a step: D on the real batch (``loss_id=0``), D on the
detached fake batch (``loss_id=1``), then G through D.

``build_dcgan_example_step`` is the port of the ``step`` of the JAX
package's ``examples/dcgan/main_amp.py`` (the reference Apex's DCGAN
example), which differs from the bench's: no ``auto_cast`` (at the
example's O2 the f32 inputs meet half weights and the layers compute in
the promoted dtype, f32, as flax promotes), D's two gradients summed into
one update under both finite flags, and G's one: two Adam updates a step.
``scripts/torch_dcgan_main_amp.py`` is the example's entry point.

``build_mha_perf_test`` is the reference Apex's multihead-attention
benchmark (``perf_test_multihead_attn.py``): a stack of
``SelfMultiheadAttn`` (or, ``encdec=True``, ``EncdecMultiheadAttn``)
layers with the norm-add variant, cast to half as the script's
``.half()``; ``impl="default"`` is its ``--ref``. ``build_mha_train_step``
trains that stack through ``amp.initialize`` and ``FusedAdam`` on an MSE
loss; ``build_transformer_step`` trains a stack of ``TransformerLayer``s
(pre-LN) and ``build_rnn_step`` a ``models.rnn`` stack the same
way. No JAX step builder trains these; each drives the port's modules
through its user entry points.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from apex_tpu_torch import amp, models, ops, parallel, sparsity
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
                    optimizer=None, monitor: bool = False, policy=None):
    """Returns ``(step, state, (toks, labels), policy, enc)``.

    ``policy`` (an ``amp.Policy``) replaces the preset of ``opt_level`` and
    ``half_dtype``, as in :func:`build_resnet_step`: ``amp.Policy(
    opt_level="O0", enabled=False)``, the JAX package's default policy,
    trains BERT in f32 end to end (the attention through the generic flash
    kernels, the f32 baseline every amp speed-up is stated against).

    ``optimizer=None`` trains with ``FusedLAMB(lr=1e-3, strategy=
    strategy)``; an optimizer given (``FusedNovoGrad(...)``,
    ``FusedAdagrad(...)``, ...) is used as it is and brings its own
    strategy, so passing ``strategy`` with it raises.

    ``step(state, toks, labels) -> (state', loss)`` runs one training step.
    ``step.amp_opt`` is the ``amp.Amp`` bundle and
    ``step.make_loss(toks, labels)`` the loss function of one batch.
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
    ``seed``). ``monitor=True`` carries the ``monitor.Metrics`` tuple on the
    state (``state.metrics``).
    """
    device = _device(device, "build_bert_step")
    if optimizer is None:
        optimizer = FusedLAMB(lr=1e-3, strategy=strategy)
    elif strategy != "auto":
        raise ValueError("build_bert_step takes strategy= for its default "
                         "FusedLAMB only; set it on the optimizer given")
    if policy is None:
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
    amp_opt = amp.Amp(policy, optimizer, monitor=monitor)
    state = amp_opt.init(dict(enc.named_parameters()))
    gen = torch.Generator(device).manual_seed(seed)
    kwargs = {"deterministic": enc.dropout == 0.0, "generator": gen}

    def make_loss(toks, labels):
        def loss_fn(mp):
            with amp.auto_cast(policy):
                hidden = functional_call(enc, mp, (toks, attn_mask), kwargs)
                return _mlm_head(hidden, mp["tok_emb.weight"], labels)
        return loss_fn

    def step(state, toks, labels):
        loss, grads, state, finite = amp_opt.backward(
            state, make_loss(toks, labels))
        return amp_opt.apply_gradients(state, grads, finite), loss

    step.attn_mask, step.generator = attn_mask, gen
    step.amp_opt, step.make_loss = amp_opt, make_loss
    return step, state, (toks, labels), policy, enc


def build_resnet_step(batch: int, size: int, opt_level: str = "O2",
                      half_dtype=torch.bfloat16, device="cuda", seed: int = 0,
                      model=None, strategy: str = "auto", optimizer=None,
                      bn_axis_name=None, ddp=None, policy=None,
                      with_accuracy: bool = False, monitor: bool = False):
    """Returns ``(step, (state, batch_stats), (x, y), policy, model)``.

    ``step(state, batch_stats, x, y) -> (state', batch_stats', loss)`` runs
    one training step. ``model=None`` builds ResNet-50 (1000 classes, the
    policy's compute dtype, BN statistics across ``bn_axis_name``) on
    ``device``; labels are drawn below the model's ``num_classes``.
    ``optimizer=None`` trains with ``FusedSGD(lr=0.1, momentum=0.9,
    strategy=strategy)``; an optimizer given (``FusedAdam(...)``, ...)
    brings its own strategy, so passing ``strategy`` with it raises.

    Data parallel: with ``bn_axis_name`` (the JAX bench's ``"data"``) or a
    ``parallel.DistributedDataParallel`` ``ddp``, the step runs with the
    mesh bound (``ddp.mesh``, else ``parallel.data_parallel_mesh(device)``
    over the started process group), ``batch`` is the global batch,
    ``(x, y)`` are this rank's rows of it, and the gradients are synced over the ``data`` axis after the
    amp backward: by ``parallel.sync_gradients`` or by ``ddp.sync``. As in
    the JAX bench, the update applies with this rank's own finite flag
    (taken before the sync) and ``loss`` is this rank's.

    ``policy`` (an ``amp.Policy``) replaces the preset of ``opt_level`` and
    ``half_dtype`` (the ImageNet example's ``--keep-batchnorm-fp32`` and
    ``--loss-scale`` overrides); ``with_accuracy`` makes the step also
    return the batch's top-1 accuracy (f32, this rank's). ``monitor=True``
    carries the ``monitor.Metrics`` tuple on the state (``state.metrics``),
    as the JAX bench's ``_resnet_step_builder(monitor=)``.
    ``step.amp_opt`` is the ``amp.Amp`` bundle.
    """
    device = _device(device, "build_resnet_step")
    dp = bn_axis_name is not None or ddp is not None
    if dp:
        mesh = ddp.mesh if ddp is not None else parallel.data_parallel_mesh(
            device)
    if optimizer is None:
        optimizer = FusedSGD(lr=0.1, momentum=0.9, strategy=strategy)
    elif strategy != "auto":
        raise ValueError("build_resnet_step takes strategy= for its default "
                         "FusedSGD only; set it on the optimizer given")
    if policy is None:
        policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    if model is None:
        model = models.ResNet50(num_classes=1000, dtype=policy.compute_dtype,
                                device=device, seed=seed,
                                bn_axis_name=bn_axis_name)
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, size, size, 3).astype(np.float32)
    y = rng.randint(0, model.num_classes, batch)
    if dp:
        n = parallel.local_batch(batch, mesh)
        me = parallel.axis_index(parallel.DATA_AXIS, mesh)
        x, y = x[me * n:(me + 1) * n], y[me * n:(me + 1) * n]
    x = torch.as_tensor(x, device=device)
    # inputs arrive pre-cast to the compute dtype, as a loader ships them
    if policy.cast_model_type is not None:
        x = x.to(policy.compute_dtype)
    y = torch.as_tensor(y, dtype=torch.int64, device=device)
    amp_opt = amp.Amp(policy, optimizer, monitor=monitor)
    state = amp_opt.init(dict(model.named_parameters()))
    batch_stats = {k: b.detach().clone() for k, b in model.named_buffers()}

    def step(state, batch_stats, xb, yb):
        def loss_fn(mp):
            logits, new_bs = functional_call(
                model, {**mp, **batch_stats}, (xb,), {"train": True})
            loss = torch.mean(ops.softmax_cross_entropy_loss(logits, yb))
            if with_accuracy:
                acc = torch.mean((torch.argmax(logits, -1) == yb).float())
                return loss, (new_bs, acc)
            return loss, new_bs

        (loss, aux), grads, state, finite = amp_opt.backward(
            state, loss_fn, has_aux=True)
        if ddp is not None:
            grads = ddp.sync(grads)
        elif dp:
            grads = parallel.sync_gradients(grads, parallel.DATA_AXIS)
        state = amp_opt.apply_gradients(state, grads, finite)
        if with_accuracy:
            return state, aux[0], loss, aux[1]
        return state, aux, loss

    if dp:
        local_step = step

        def step(state, batch_stats, xb, yb):
            with parallel.use_mesh(mesh):
                return local_step(state, batch_stats, xb, yb)

    step.amp_opt = amp_opt
    return step, (state, batch_stats), (x, y), policy, model


def build_mlp_step(batch: int, sizes=(13, 512, 256, 128),
                   opt_level: str = "O2", half_dtype=torch.bfloat16,
                   device="cuda", seed: int = 0, model=None,
                   strategy: str = "auto"):
    """Returns ``(step, state, (x, target), policy, model)``.

    ``step(state, x, target) -> (state', loss)`` runs one training step of
    ``model`` (default ``ops.MLP(sizes)`` on ``device``, weights from
    ``seed``): the f32 mean squared error of its output against ``target``,
    through ``amp.Amp(policy, ASP(FusedAdam(lr=1e-3, strategy=strategy),
    pattern="m4n2_1d"))``. ``x`` (batch, D0) ~ N(0, 1) and ``target`` (batch,
    D_L) ~ U[0, 1) come from ``np.random.RandomState(seed)``; ``x`` arrives
    pre-cast to the compute dtype when the policy casts the model, as a
    loader ships it.
    """
    device = _device(device, "build_mlp_step")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    if model is None:
        model = ops.MLP(sizes, device=device, seed=seed)
    d0, dl = model.sizes[0], model.sizes[-1]
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(batch, d0).astype(np.float32),
                        device=device)
    if policy.cast_model_type is not None:
        x = x.to(policy.compute_dtype)
    target = torch.as_tensor(rng.rand(batch, dl).astype(np.float32),
                             device=device)
    amp_opt = amp.Amp(policy, sparsity.ASP(
        FusedAdam(lr=1e-3, strategy=strategy), pattern="m4n2_1d"))
    state = amp_opt.init(dict(model.named_parameters()))

    def step(state, xb, tb):
        def loss_fn(mp):
            y = functional_call(model, mp, (xb,))
            return torch.mean(torch.square(y.float() - tb))

        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    return step, state, (x, target), policy, model


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


def build_dcgan_example_step(batch: int = 64, image_size: int = 64,
                             nz: int = 100, ngf: int = 64, ndf: int = 64,
                             lr: float = 2e-4, beta1: float = 0.5,
                             opt_level: str = "O2",
                             half_dtype=torch.bfloat16, device="cuda",
                             seed: int = 0, nets=None):
    """Returns ``(step, (dstate, gstate, d_bs, g_bs), draw, policy, (G,
    D))``: the JAX package's DCGAN example.

    ``draw() -> (real, z)`` gives the next batch from
    ``np.random.RandomState(seed)`` as the example draws it: ``real``
    (batch, image_size, image_size, 3) ~ U[-1, 1) and ``z`` (batch, 1, 1,
    nz) ~ N(0, 1), both f32. ``step(dstate, gstate, d_bs, g_bs, real, z)
    -> (dstate', gstate', d_bs', g_bs', loss_d, loss_g)`` runs one step:
    ``loss_d`` is D's real plus fake loss. ``nets`` is ``(G, D)`` (e.g.
    carried from the JAX package by ``convert.dcgan_variables_from_jax``),
    else ``Generator(nz, ngf)`` and ``Discriminator(ndf)`` on ``device``
    with weights from seeds 1 and 2 (the example's ``PRNGKey(1)``/``(2)``,
    whose bits the port cannot draw). Optimizers: ``FusedAdam(lr, betas=
    (beta1, 0.999))`` under ``amp.Amp(policy, ...)``, D's with
    ``num_losses=2``.
    """
    device = _device(device, "build_dcgan_example_step")
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    if nets is None:
        nets = (models.Generator(nz=nz, ngf=ngf, device=device, seed=1),
                models.Discriminator(ndf=ndf, device=device, seed=2))
    G, D = nets

    def adam():
        return FusedAdam(lr=lr, betas=(beta1, 0.999))

    ampD = amp.Amp(policy, adam(), num_losses=2)
    ampG = amp.Amp(policy, adam())
    dstate = ampD.init(dict(D.named_parameters()))
    gstate = ampG.init(dict(G.named_parameters()))
    d_bs = {k: b.detach().clone() for k, b in D.named_buffers()}
    g_bs = {k: b.detach().clone() for k, b in G.named_buffers()}
    rng = np.random.RandomState(seed)
    train = {"train": True}

    def draw():
        real = rng.rand(batch, image_size, image_size, 3).astype(
            np.float32) * 2 - 1
        z = rng.randn(batch, 1, 1, nz).astype(np.float32)
        return (torch.as_tensor(real, device=device),
                torch.as_tensor(z, device=device))

    def step(dstate, gstate, d_bs, g_bs, real, z):
        def d_real(mp):
            out, bs = functional_call(D, {**mp, **d_bs}, (real,), train)
            return bce(out.float(), 1.0), bs

        (loss_real, d_bs1), gr, dstate, fin_r = ampD.backward(
            dstate, d_real, loss_id=0, has_aux=True)
        with torch.no_grad():
            fake = functional_call(G, {**ampG.model_params(gstate), **g_bs},
                                   (z,), train)[0]

        def d_fake(mp):
            out, bs = functional_call(D, {**mp, **d_bs1}, (fake,), train)
            return bce(out.float(), 0.0), bs

        (loss_fake, d_bs2), gf, dstate, fin_f = ampD.backward(
            dstate, d_fake, loss_id=1, has_aux=True)
        grads = {k: gr[k] + gf[k] for k in gr}
        finite = (fin_r and fin_f) if isinstance(fin_r, bool) \
            else torch.logical_and(fin_r, fin_f)
        dstate = ampD.apply_gradients(dstate, grads, finite)

        def g_loss(mp):
            img, bs = functional_call(G, {**mp, **g_bs}, (z,), train)
            # D at its updated params; its new statistics are dropped, as
            # the example drops them
            out = functional_call(D, {**ampD.model_params(dstate), **d_bs2},
                                  (img,), train)[0]
            return bce(out.float(), 1.0), bs

        (loss_g, g_bs1), gg, gstate, fin_g = ampG.backward(
            gstate, g_loss, loss_id=0, has_aux=True)
        gstate = ampG.apply_gradients(gstate, gg, fin_g)
        return dstate, gstate, d_bs2, g_bs1, loss_real + loss_fake, loss_g

    return step, (dstate, gstate, d_bs, g_bs), draw, policy, (G, D)


class LayerStack(torch.nn.Module):
    """``layers`` applied in turn, each called as ``layer(x, *args,
    **kwargs)``; params ``layers.<i>.<name>``."""

    def __init__(self, layers):
        super().__init__()
        self.layers = torch.nn.ModuleList(layers)

    def forward(self, x, *args, **kwargs):
        for layer in self.layers:
            x = layer(x, *args, **kwargs)
        return x


@torch.no_grad()
def seeded_init(module: torch.nn.Module, seed: int) -> None:
    """Draw ``module``'s weights from ``seed`` at flax's scales: a norm's
    scale (``*scale``) ones, biases zeros, every other (out, in, ...)
    weight N(0, 1/in)."""
    gen = None
    for name, p in module.named_parameters():
        if gen is None:
            gen = torch.Generator(p.device).manual_seed(seed)
        leaf = name.rpartition(".")[2]
        if leaf.endswith("scale"):
            p.fill_(1.0)
        elif leaf.endswith("bias"):
            p.zero_()
        else:
            p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)


def _mha_stack(layers, hidden, heads, dropout, impl, encdec, device, seed):
    cls = ops.EncdecMultiheadAttn if encdec else ops.SelfMultiheadAttn
    stack = LayerStack([cls(hidden, heads, dropout=dropout,
                            include_norm_add=True, impl=impl, device=device)
                        for _ in range(layers)])
    seeded_init(stack, seed)
    return stack


def build_mha_perf_test(batch: int = 128, seq: int = 64, layers: int = 18,
                        hidden: int = 1024, heads: int = 16,
                        dropout: float = 0.1, impl: str = "fast",
                        encdec: bool = False, half_dtype=torch.float16,
                        device="cuda", seed: int = 0):
    """Returns ``(run, params, inputs)``: the reference Apex's MHA
    benchmark.

    A stack of ``layers`` norm-add attention layers (weights from
    ``seed``); ``params`` are its params cast to ``half_dtype`` by
    ``fp16_utils.network_to_half`` (the script's ``.half()``), leaves that
    require grad; ``inputs`` are the (batch, seq, hidden) half query (and,
    ``encdec=True``, an encoder memory of the same length), requiring grad
    as the script's. ``run(params, deterministic=False)`` is one forward of
    the stack, its dropout seeds drawn from a generator seeded with
    ``seed``.
    """
    from apex_tpu_torch.fp16_utils import network_to_half
    device = _device(device, "build_mha_perf_test")
    stack = _mha_stack(layers, hidden, heads, dropout, impl, encdec, device,
                       seed)
    params = {k: v.detach().requires_grad_(True) for k, v in
              network_to_half(dict(stack.named_parameters()),
                              half_dtype).items()}
    rng = np.random.RandomState(seed)
    inputs = tuple(torch.as_tensor(rng.randn(batch, seq, hidden).astype(
        np.float32), device=device).to(half_dtype).requires_grad_(True)
        for _ in range(2 if encdec else 1))
    gen = torch.Generator(device).manual_seed(seed)

    def run(params, deterministic: bool = False):
        return functional_call(stack, params, inputs, dict(
            deterministic=deterministic, generator=gen))

    return run, params, inputs


def _mse(y, target):
    return torch.mean(torch.square(y.float() - target))


def build_mha_train_step(batch: int = 128, seq: int = 64, layers: int = 18,
                         hidden: int = 1024, heads: int = 16,
                         dropout: float = 0.1, opt_level: str = "O2",
                         half_dtype=torch.float16, device="cuda",
                         seed: int = 0):
    """Returns ``(step, state, (x, target), policy, stack)``: the MHA
    benchmark's norm-add stack trained through ``amp.initialize(params,
    FusedAdam(lr=1e-4, strategy="arena"), opt_level, half_dtype=...)`` on
    the f32 mean squared error of its output against a target drawn from
    ``seed``, with its dropout on (seeds from a generator seeded with
    ``seed``). ``step(state) -> (state', loss)``."""
    device = _device(device, "build_mha_train_step")
    stack = _mha_stack(layers, hidden, heads, dropout, "fast", False, device,
                       seed)
    amp_opt, state = amp.initialize(
        dict(stack.named_parameters()),
        FusedAdam(lr=1e-4, strategy="arena"), opt_level,
        half_dtype=half_dtype, verbosity=0)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(batch, seq, hidden).astype(np.float32),
                        device=device)
    x = amp_opt.policy.cast_inputs(x)
    target = torch.as_tensor(rng.randn(batch, seq, hidden).astype(
        np.float32), device=device)
    gen = torch.Generator(device).manual_seed(seed)
    kwargs = dict(deterministic=dropout == 0.0, generator=gen)

    def step(state):
        def loss_fn(mp):
            return _mse(functional_call(stack, mp, (x,), kwargs), target)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    return step, state, (x, target), amp_opt.policy, stack


def _train_step(model, inputs, target, kwargs, opt_level, half_dtype,
                optimizer):
    policy = amp.Policy.from_opt_level(opt_level, half_dtype=half_dtype)
    amp_opt = amp.Amp(policy, optimizer)
    state = amp_opt.init(dict(model.named_parameters()))

    def step(state):
        def loss_fn(mp):
            with amp.auto_cast(policy):
                y = functional_call(model, mp, inputs, kwargs)
            return _mse(y, target)
        loss, grads, state, finite = amp_opt.backward(state, loss_fn)
        return amp_opt.apply_gradients(state, grads, finite), loss

    return step, state, policy


def build_transformer_step(batch: int = 16, seq: int = 512,
                           layers: int = 24, hidden: int = 1024,
                           heads: int = 16, ffn_hidden: int = 4096,
                           dropout: float = 0.1, opt_level: str = "O1",
                           half_dtype=torch.bfloat16, device="cuda",
                           seed: int = 0):
    """Returns ``(step, state, (x, mask, target), policy, model)``: a stack
    of pre-LN ``TransformerLayer(hidden, heads, ffn_hidden, dropout)``
    (BERT-Large's widths by default; weights from ``seed``) trained under
    ``auto_cast`` of ``opt_level`` with ``FusedLAMB(lr=1e-3,
    strategy="arena")`` on the f32 mean squared error of its output against
    a target, both (batch, seq, hidden) f32 from
    ``np.random.RandomState(seed)``. Each sequence's length is drawn from
    [min(128, seq), seq] as ``build_bert_step`` draws it, and the padding
    mask (B, 1, 1, S) is passed; dropout > 0 runs ``deterministic=False``
    with seeds from a generator seeded with ``seed``. ``step(state) ->
    (state', loss)``.
    """
    device = _device(device, "build_transformer_step")
    model = LayerStack([models.TransformerLayer(
        hidden, heads, ffn_hidden, dropout, pre_ln=True, device=device)
        for _ in range(layers)])
    seeded_init(model, seed)
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(batch, seq, hidden).astype(np.float32),
                        device=device)
    target = torch.as_tensor(rng.randn(batch, seq, hidden).astype(
        np.float32), device=device)
    lengths = rng.randint(min(128, seq), seq + 1, batch)
    mask = torch.as_tensor(np.arange(seq) < lengths[:, None],
                           device=device)[:, None, None, :]
    gen = torch.Generator(device).manual_seed(seed)
    kwargs = dict(deterministic=dropout == 0.0, generator=gen)
    step, state, policy = _train_step(
        model, (x, mask), target, kwargs, opt_level, half_dtype,
        FusedLAMB(lr=1e-3, strategy="arena"))
    return step, state, (x, mask, target), policy, model


def build_rnn_step(model, batch: int, seq: int, input_size: int,
                   opt_level: str = "O1", half_dtype=torch.bfloat16,
                   device="cuda", seed: int = 0):
    """Returns ``(step, state, (x, target), policy, model)``: a
    ``models.rnn`` stack trained under ``auto_cast`` of ``opt_level`` with
    ``FusedAdam(lr=1e-3, strategy="arena")`` on the f32 mean squared error
    of its (batch, seq, width) output against a target; input (batch, seq,
    input_size) and target from ``np.random.RandomState(seed)``. A model
    with dropout runs ``deterministic=False`` with keep masks from a
    generator seeded with ``seed``. ``step(state) -> (state', loss)``."""
    device = _device(device, "build_rnn_step")
    rng = np.random.RandomState(seed)
    width = model.hidden * (2 if model.bidirectional else 1)
    x = torch.as_tensor(rng.randn(batch, seq, input_size).astype(
        np.float32), device=device)
    target = torch.as_tensor(rng.rand(batch, seq, width).astype(
        np.float32) * 2 - 1, device=device)
    gen = torch.Generator(device).manual_seed(seed)
    kwargs = dict(deterministic=model.dropout == 0.0, generator=gen)
    step, state, policy = _train_step(
        model, (x,), target, kwargs, opt_level, half_dtype,
        FusedAdam(lr=1e-3, strategy="arena"))
    return step, state, (x, target), policy, model
