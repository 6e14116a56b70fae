"""Weight bridge between flax param trees (as numpy arrays) and the port's
``state_dict``.

The port's submodules carry the flax module names, so a param path maps
to a state_dict key by joining with dots, and only the leaves change:
- Dense ``kernel`` (in, out) <-> Linear ``weight`` (out, in), transposed;
- LayerNorm ``scale`` <-> ``weight``;
- ``bias`` <-> ``bias``.
A 2-D ``weight`` is a Linear kernel and a 1-D one a LayerNorm scale, which
makes the map invertible.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested flax params (or a variables dict holding ``params``) ->
    state_dict of float32 CPU tensors."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, prefix + (name,))
                continue
            arr = np.asarray(sub)
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale":
                name = "weight"
            elif name != "bias":
                raise ValueError(f"no torch counterpart for flax leaf "
                                 f"{'/'.join(prefix + (name,))}")
            out[".".join(prefix + (name,))] = torch.tensor(
                np.ascontiguousarray(arr))

    walk(params, ())
    return out


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """state_dict -> nested flax params of numpy arrays."""
    tree: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy().copy()
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T.copy()) if arr.ndim == 2 \
                else ("scale", arr)
        elif leaf != "bias":
            raise ValueError(f"no flax counterpart for state_dict key {key}")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree
