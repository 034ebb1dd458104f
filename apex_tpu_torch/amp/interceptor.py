"""Automatic per-module casting for the port's own modules (O1 ergonomics).

The JAX package installs a flax method interceptor that casts the inputs of
tensor-core modules (Dense, Embed, ...) to the policy's half dtype and of
norm modules to fp32. The port's modules ask :func:`module_cast_dtype` at
the top of their ``forward`` instead, which classifies them the way
``make_interceptor`` does with its built-in tables: the float table
first, then the half table. (User module registration is not ported.)

This is not ``torch.autocast``: autocast's op lists differ from
``amp/lists.py``, and the port is held against the JAX package's choices.
As there, casting applies whenever the bound policy is enabled, whatever
its opt level.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp.policy import Policy, policy_scope


class _CastState(threading.local):
    def __init__(self):
        self.stack = []


_active = _CastState()


def module_cast_dtype(module) -> Optional[torch.dtype]:
    """Dtype ``module``'s call computes in under the innermost
    :func:`auto_cast`, or None when no cast applies."""
    if not _active.stack:
        return None
    policy = _active.stack[-1]
    if not policy.enabled:
        return None
    half_mods, float_mods = lists.module_tables()
    if isinstance(module, float_mods):
        return torch.float32
    if isinstance(module, half_mods):
        return policy.half_dtype
    return None


@contextlib.contextmanager
def auto_cast(policy: Policy):
    """Bind ``policy`` for the port's modules and as the ambient policy::

        with amp.auto_cast(policy):
            loss = models.mlm_loss(enc, params, toks, labels)
    """
    with policy_scope(policy):
        _active.stack.append(policy)
        try:
            yield
        finally:
            _active.stack.pop()
