"""Automatic per-module casting for the port's own modules (O1 ergonomics).

The JAX package installs a flax method interceptor that casts the inputs of
tensor-core modules (Dense, Embed, ...) to the policy's half dtype and of
norm modules to fp32. The port's modules ask :func:`module_cast_dtype` at
the top of their ``forward`` instead, which classifies them the way
``make_interceptor`` does: the user's float registrations, the user's half
registrations (``lists.register_{float,half}_module``), then the built-in
float table and the built-in half table.

Under a policy with ``patch_ops`` (O1), :func:`auto_cast` also installs the
functional patch (:mod:`apex_tpu_torch.amp.functional_patch`) for the
scope, as the JAX package's does.

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

from apex_tpu_torch.amp import functional_patch, lists
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
    if isinstance(module, tuple(lists._EXTRA_FLOAT_MODULES)):
        return torch.float32
    if isinstance(module, tuple(lists._EXTRA_HALF_MODULES)):
        return policy.half_dtype
    half_mods, float_mods = lists.module_tables()
    if isinstance(module, float_mods):
        return torch.float32
    if isinstance(module, half_mods):
        return policy.half_dtype
    return None


@contextlib.contextmanager
def auto_cast(policy: Policy):
    """Bind ``policy`` for the port's modules and as the ambient policy, and
    under ``patch_ops`` (O1) install the functional patch::

        with amp.auto_cast(policy):
            loss = models.mlm_loss(enc, params, toks, labels)
    """
    do_patch = policy.enabled and policy.patch_ops
    with policy_scope(policy):
        _active.stack.append(policy)
        if do_patch:
            functional_patch.patch_functional(policy)
        try:
            yield
        finally:
            if do_patch:
                functional_patch.unpatch_functional()
            _active.stack.pop()
