"""Weights across the two packages: the JAX params pytree (numpy leaves,
weights (in, out)) <-> the port's reference-named state_dict (weights
(out, in)).

Key rule, as in vipnerf_tpu/utils/reference_ckpt.py: `coarse` <->
`coarse_model`, `fine` <-> `fine_model`, list indices become `.N`, `w` <->
`weight` (transposed), `b` <-> `bias`. A `module.` prefix (DataParallel) is
dropped on the way in.
"""

from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np
import torch

_TO_TORCH = {"coarse": "coarse_model", "fine": "fine_model"}
_FROM_TORCH = {v: k for k, v in _TO_TORCH.items()}


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (i,))
    else:
        yield prefix, tree


def state_dict_from_jax_params(params: Dict[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX params pytree (numpy or array leaves) -> port state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, leaf in _walk(params):
        arr = np.asarray(leaf, dtype=np.float32)
        parts = [str(_TO_TORCH.get(p, p)) for p in path[:-1]]
        if path[-1] == "w":
            parts.append("weight")
            arr = arr.T
        elif path[-1] == "b":
            parts.append("bias")
        else:
            raise ValueError(f"unrecognized parameter path: {path}")
        sd[".".join(parts)] = torch.tensor(arr)
    return sd


def _listify(node):
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return [_listify(node[i]) for i in range(max(node) + 1)]
        return {k: _listify(v) for k, v in node.items()}
    return node


def jax_params_from_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Port (or reference) state_dict -> JAX params pytree of f32 numpy arrays."""
    tree: Dict[Any, Any] = {}
    for key, tensor in state_dict.items():
        parts: List[str] = key.split(".")
        if parts[0] == "module":
            parts = parts[1:]
        path = [int(p) if p.isdigit() else _FROM_TORCH.get(p, p) for p in parts[:-1]]
        arr = tensor.detach().float().cpu().numpy()
        if parts[-1] == "weight":
            leaf, arr = "w", arr.T
        elif parts[-1] == "bias":
            leaf = "b"
        else:
            raise ValueError(f"unrecognized parameter key: {key}")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr, dtype=np.float32)
    return _listify(tree)
