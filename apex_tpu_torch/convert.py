"""Carry BERT weights from the JAX package's flax param tree to the port.

The flax tree (as nested dicts of numpy arrays) maps name for name onto
the port's ``state_dict``: path components join with ``.``, a Dense
``kernel`` (in, out) becomes a ``Linear.weight`` (out, in), and the token
table ``tok_emb/embedding`` becomes ``tok_emb.weight``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def bert_params_from_jax(params, device="cuda") -> Dict[str, torch.Tensor]:
    """``{port name: tensor}`` from a flax BERT ``params`` tree."""
    out = {}
    for name, leaf in _flatten(params):
        arr = np.asarray(leaf, dtype=np.float32)
        if name.endswith(".kernel"):
            name, arr = name[:-len("kernel")] + "weight", arr.T
        elif name.endswith(".embedding"):
            name = name[:-len("embedding")] + "weight"
        out[name] = torch.tensor(arr, device=device)
    return out
