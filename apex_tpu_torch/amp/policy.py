"""Precision policy: the amp opt levels as an immutable value.

The port of ``apex_tpu.amp.policy``: the same O0–O3 presets and defaults,
over torch dtypes. bfloat16 is the default half dtype, which shares fp32's
exponent range, so its presets carry no loss scaler; ``half_dtype=
torch.float16`` brings dynamic loss scaling back.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Optional, Union

import torch

from apex_tpu_torch.amp import lists
from apex_tpu_torch.utils import tree_cast

_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Immutable precision policy (the reference's validated ``Properties``).

    Fields as in the JAX package: ``opt_level``, ``enabled``,
    ``half_dtype``, ``cast_model_type`` (dtype params are cast to for the
    forward, None = leave fp32), ``patch_ops`` (the O1 per-op policy),
    ``keep_batchnorm_fp32``, ``master_weights``, ``loss_scale``
    ('dynamic' | float | None) and ``output_dtype``.
    """

    opt_level: Optional[str] = None
    enabled: bool = True
    half_dtype: torch.dtype = torch.bfloat16
    cast_model_type: Optional[torch.dtype] = None
    patch_ops: bool = False
    keep_batchnorm_fp32: bool = False
    master_weights: bool = True
    loss_scale: Union[str, float, None] = None
    output_dtype: Optional[torch.dtype] = torch.float32

    @classmethod
    def from_opt_level(cls, opt_level: str, *, half_dtype=torch.bfloat16,
                       **overrides) -> "Policy":
        """Build a preset policy, then apply per-field overrides."""
        default_scale = "dynamic" if half_dtype == torch.float16 else None
        presets = {
            "O0": dict(enabled=True, cast_model_type=None, patch_ops=False,
                       keep_batchnorm_fp32=False, master_weights=False,
                       loss_scale=None, half_dtype=half_dtype),
            "O1": dict(enabled=True, cast_model_type=None, patch_ops=True,
                       keep_batchnorm_fp32=False, master_weights=False,
                       loss_scale=default_scale, half_dtype=half_dtype),
            "O2": dict(enabled=True, cast_model_type=half_dtype,
                       patch_ops=False, keep_batchnorm_fp32=True,
                       master_weights=True, loss_scale=default_scale,
                       half_dtype=half_dtype),
            "O3": dict(enabled=True, cast_model_type=half_dtype,
                       patch_ops=False, keep_batchnorm_fp32=False,
                       master_weights=False, loss_scale=1.0,
                       half_dtype=half_dtype),
        }
        if opt_level not in presets:
            raise ValueError(
                f"Unexpected optimization level {opt_level!r}; options are "
                "'O0', 'O1', 'O2', 'O3'.")
        kwargs = presets[opt_level]
        kwargs.update(overrides)
        policy = cls(opt_level=opt_level, **kwargs)
        policy.validate()
        return policy

    def replace(self, **overrides) -> "Policy":
        """A copy with ``overrides`` applied, validated."""
        p = dataclasses.replace(self, **overrides)
        p.validate()
        return p

    def validate(self) -> None:
        if self.half_dtype not in _HALF:
            raise ValueError(
                f"half_dtype must be bfloat16 or float16, got {self.half_dtype}")
        cm = self.cast_model_type
        if cm is not None and not cm.is_floating_point:
            raise ValueError(f"cast_model_type must be a float dtype, got {cm}")
        if self.patch_ops and cm is not None and cm != torch.float32:
            raise ValueError(
                "patch_ops (O1-style op policy) expects fp32 params; "
                "combining it with a cast model is not supported.")
        if isinstance(self.loss_scale, str) and self.loss_scale != "dynamic":
            raise ValueError("loss_scale must be a float, 'dynamic', or None")
        fp16_compute = (cm == torch.float16
                        or (self.patch_ops and self.half_dtype == torch.float16))
        if fp16_compute and self.loss_scale is None and self.enabled:
            raise ValueError(
                "float16 compute without loss scaling will underflow; pass "
                "loss_scale='dynamic' (or a static scale).")

    # ---- dtype queries -----------------------------------------------------

    @property
    def compute_dtype(self) -> torch.dtype:
        if not self.enabled:
            return torch.float32
        if self.cast_model_type is not None:
            return self.cast_model_type
        if self.patch_ops:
            return self.half_dtype
        return torch.float32

    @property
    def param_dtype(self) -> torch.dtype:
        if self.enabled and self.cast_model_type is not None:
            return self.cast_model_type
        return torch.float32

    @property
    def uses_loss_scaling(self) -> bool:
        return self.enabled and self.loss_scale is not None

    def op_dtype(self, op_name: str, *input_dtypes) -> torch.dtype:
        """Compute dtype for a named op under this policy (HALF ops get
        ``half_dtype``, FLOAT ops fp32, PROMOTE ops the widest input)."""
        if not self.enabled:
            return torch.float32
        kind = lists.classify(op_name)
        if kind == "banned":
            if self.patch_ops or self.cast_model_type is not None:
                raise TypeError(lists.BANNED_MESSAGE.format(
                    name=op_name, dtype=self.half_dtype))
            return torch.float32
        if not self.patch_ops and self.cast_model_type is None:
            return _promote(input_dtypes) if input_dtypes else torch.float32
        if kind == "half":
            return self.half_dtype
        if kind == "float":
            return torch.float32
        if kind == "promote":
            return _promote(input_dtypes)
        return _promote(input_dtypes[:1]) if input_dtypes else torch.float32

    # ---- casting helpers ---------------------------------------------------

    @staticmethod
    def _bn_exempt(name: str) -> bool:
        """True if the param ``name`` (dotted) belongs to a norm layer."""
        return any(_NORM_COMPONENT_RE.match(part.lower())
                   for part in name.split("."))

    def cast_params(self, params):
        """Cast a ``{name: tensor}`` dict to the model dtype; norm params
        stay fp32 under ``keep_batchnorm_fp32``."""
        if not self.enabled or self.cast_model_type is None:
            return params
        pred = ((lambda name, _x: not self._bn_exempt(name))
                if self.keep_batchnorm_fp32 else None)
        return tree_cast(params, self.cast_model_type, predicate=pred)

    def cast_inputs(self, tree):
        """Cast floating inputs to the model dtype (the cast amp puts
        before the model's forward); a no-op without a cast model."""
        if not self.enabled or self.cast_model_type is None:
            return tree
        return tree_cast(tree, self.cast_model_type)

    def cast_outputs(self, tree):
        """Cast floating outputs to ``output_dtype`` (f32 by default)."""
        if not self.enabled or self.output_dtype is None:
            return tree
        return tree_cast(tree, self.output_dtype)

    def cast_to_compute(self, tree):
        """Cast floating leaves to :attr:`compute_dtype`."""
        return tree_cast(tree, self.compute_dtype)


_NORM_COMPONENT_RE = re.compile(
    r"^(bn\d*"
    r"|batch_?norm.*|sync_?batch_?norm.*"
    r"|(layer|group|rms|instance)_?norm.*"
    r"|norm(_\d+)?"
    r"|batch_stats)$"
)


def _promote(dtypes) -> torch.dtype:
    dts = [d for d in dtypes if d is not None and d.is_floating_point]
    if not dts:
        return torch.float32
    out = dts[0]
    for d in dts[1:]:
        out = torch.promote_types(out, d)
    return out


# --- ambient policy ---------------------------------------------------------

class _PolicyState(threading.local):
    def __init__(self):
        self.stack = []


_state = _PolicyState()

_DEFAULT_POLICY = Policy(opt_level="O0", enabled=False)


def current_policy() -> Policy:
    return _state.stack[-1] if _state.stack else _DEFAULT_POLICY


@contextlib.contextmanager
def policy_scope(policy: Policy):
    """Bind ``policy`` as the ambient policy for the duration."""
    _state.stack.append(policy)
    try:
        yield policy
    finally:
        _state.stack.pop()
