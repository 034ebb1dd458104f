"""Operation cast-policy tables for the precision engine.

The port's copy of ``apex_tpu.amp.lists``: the same three op-name groups
(resolved by ``Policy.op_dtype``) and the module tables that
:func:`apex_tpu_torch.amp.auto_cast` applies to the port's own modules.

- HALF  ("whitelist"): tensor-core ops — run in the policy's half dtype.
- FLOAT ("blacklist"): reductions, norms, losses, transcendentals — fp32.
- PROMOTE: multi-input elementwise ops — widest input dtype wins.

Users extend the tables as in the JAX package: ``register_half_op`` /
``register_float_op`` / ``register_promote_op`` / ``unregister_op`` take an
op name, or a ``(module, attr)`` pair that gives a user function the O1
functional patch's treatment; ``register_half_module`` /
``register_float_module`` add module classes that :func:`auto_cast`
consults before its built-in tables, so a user re-registration of a
built-in wins.
"""

from __future__ import annotations

from apex_tpu_torch.amp import functional_patch

HALF_OPS = {
    "conv", "conv1d", "conv2d", "conv3d", "conv_transpose",
    "dense", "linear", "matmul", "einsum", "dot_general",
    "attention", "mlp", "rnn_cell", "lstm_cell", "gru_cell",
}

FLOAT_OPS = {
    "softmax", "log_softmax", "layer_norm", "group_norm", "batch_norm",
    "rms_norm", "weight_norm", "cross_entropy", "softmax_cross_entropy",
    "nll_loss", "mse_loss", "l1_loss", "cosine_similarity",
    "exp", "expm1", "log", "log1p", "log2", "log10", "pow", "erf", "erfinv",
    "sum", "mean", "prod", "cumsum", "cumprod", "var", "std", "norm",
    "sigmoid_focal_loss", "renorm", "softplus", "gelu_exact",
}

PROMOTE_OPS = {
    "add", "sub", "mul", "div", "addcmul", "addcdiv",
    "concatenate", "stack", "where", "equal", "maximum", "minimum",
    "atan2", "cross", "bilinear", "dot",
}

BANNED_HALF_OPS = {
    "binary_cross_entropy",
}

BANNED_MESSAGE = (
    "{name} is numerically unsafe in {dtype}. Compute it in float32 — e.g. "
    "use apex_tpu_torch.ops.softmax_cross_entropy_loss (fused, fp32 "
    "internals) or pass logits and use a *_with_logits loss, which is "
    "stable in mixed precision."
)


def classify(op_name: str) -> str:
    """Return 'banned' | 'half' | 'float' | 'promote' | 'neutral'."""
    if op_name in BANNED_HALF_OPS:
        return "banned"
    if op_name in HALF_OPS:
        return "half"
    if op_name in FLOAT_OPS:
        return "float"
    if op_name in PROMOTE_OPS:
        return "promote"
    return "neutral"


def register_half_op(name) -> None:
    """Classify op ``name`` (str) as half, or give a ``(module, attr)``
    function the functional patch's half treatment."""
    if not isinstance(name, str):
        functional_patch.register_raw_target(name[0], name[1], "half")
        return
    FLOAT_OPS.discard(name)
    PROMOTE_OPS.discard(name)
    HALF_OPS.add(name)


def register_float_op(name) -> None:
    """Classify op ``name`` (str) as fp32, or give a ``(module, attr)``
    function the functional patch's fp32 treatment."""
    if not isinstance(name, str):
        functional_patch.register_raw_target(name[0], name[1], "float")
        return
    HALF_OPS.discard(name)
    PROMOTE_OPS.discard(name)
    FLOAT_OPS.add(name)


def register_promote_op(name: str) -> None:
    HALF_OPS.discard(name)
    FLOAT_OPS.discard(name)
    PROMOTE_OPS.add(name)


def unregister_op(name) -> None:
    """Remove an op name from every table, or drop a ``(module, attr)``
    registration of the functional patch (restored at once inside a live
    scope). Idempotent."""
    if not isinstance(name, str):
        functional_patch.unregister_raw_target(name[0], name[1])
        return
    HALF_OPS.discard(name)
    FLOAT_OPS.discard(name)
    PROMOTE_OPS.discard(name)


# --- module-class tables (consulted by amp.interceptor) ---------------------

# user-registered module classes, consulted before the built-in tables
_EXTRA_HALF_MODULES: list = []
_EXTRA_FLOAT_MODULES: list = []


def register_half_module(cls) -> None:
    """Calls of ``cls`` under ``auto_cast`` run in the policy half dtype."""
    if cls in _EXTRA_FLOAT_MODULES:
        _EXTRA_FLOAT_MODULES.remove(cls)
    if cls not in _EXTRA_HALF_MODULES:
        _EXTRA_HALF_MODULES.append(cls)


def register_float_module(cls) -> None:
    """Calls of ``cls`` under ``auto_cast`` run in fp32."""
    if cls in _EXTRA_HALF_MODULES:
        _EXTRA_HALF_MODULES.remove(cls)
    if cls not in _EXTRA_FLOAT_MODULES:
        _EXTRA_FLOAT_MODULES.append(cls)


def module_tables():
    """(HALF_MODULES, FLOAT_MODULES) over the port's module classes.

    As the JAX package's flax tables: Dense, Embed, Conv and ConvTranspose
    are HALF, BatchNorm is FLOAT. The fused LayerNorm module and the fused
    BN unit are in neither table: in the JAX package they are custom
    modules the interceptor passes through, so they normalize in whatever
    dtype reaches them.
    """
    from apex_tpu_torch.models.layers import BatchNorm, Conv, ConvTranspose
    from apex_tpu_torch.models.transformer import Dense, Embed

    return (Dense, Embed, Conv, ConvTranspose), (BatchNorm,)
