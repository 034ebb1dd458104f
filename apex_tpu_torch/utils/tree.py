"""Tree utilities over flat ``{name: tensor}`` dicts.

The port's own copy of ``apex_tpu.utils.tree``: where the JAX package maps
over pytrees, the port's parameter trees are the ordered dicts a
``state_dict`` gives, so each helper walks one dict level (and plain
tuples/lists of tensors, for call arguments).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest)))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):            # NamedTuple state
            return type(tree)(*out)
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_cast(tree, dtype: Optional[torch.dtype],
              predicate: Optional[Callable[[Any, torch.Tensor], bool]] = None):
    """Cast every floating tensor leaf to ``dtype``.

    ``predicate(name, leaf)`` may veto the cast per leaf of a dict (the
    ``keep_batchnorm_fp32`` exemption). Non-float leaves pass through.
    """
    if dtype is None:
        return tree
    if isinstance(tree, dict) and predicate is not None:
        return type(tree)(
            (k, v.to(dtype) if _is_float(v) and predicate(k, v) else v)
            for k, v in tree.items())
    return tree_map(lambda x: x.to(dtype) if _is_float(x) else x, tree)


def tree_all_finite(tree) -> torch.Tensor:
    """One boolean device scalar: True iff every float element is finite.

    The flag stays on the device; callers commit with ``torch.where`` and
    never read it back on the host.
    """
    leaves = [x for x in tree_leaves(tree) if _is_float(x)]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(x).all() for x in leaves]).all()


def tree_select(pred, on_true, on_false):
    """``torch.where(pred, a, b)`` over two matching trees.

    A Python-bool ``pred`` (statically known, e.g. no loss scaler)
    short-circuits to the chosen tree with no device work.
    """
    if isinstance(pred, bool):
        return on_true if pred else on_false
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def global_norm(tree, ord=2) -> torch.Tensor:
    """Global L2 (``ord=2``) or Linf (``ord=inf``, ``"inf"``) norm over all
    leaves, computed in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    if ord == 2:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    if ord == float("inf") or ord == "inf":
        return torch.stack([torch.max(torch.abs(x.float()))
                            for x in leaves]).max()
    raise ValueError(f"unsupported ord={ord}")
