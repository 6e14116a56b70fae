"""Weight bridge between flax variables (as numpy arrays) and the port's
``state_dict``.

The port's submodules carry the flax module names, so a variable path maps
to a state_dict key by joining with dots, and only the leaves change:
- Dense ``kernel`` (in, out) <-> Linear ``weight`` (out, in), transposed;
- LayerNorm ``scale`` <-> ``weight``;
- ``bias`` <-> ``bias``;
- any other param leaf (``res_conv``, ``proj_k``, ``proj_v``,
  ``transconv_kernel``, ``transconv_bias``) <-> an ``nn.Parameter`` of the
  same name and layout, not transposed;
- a leaf of the ``constants`` collection (Performer's ``projection``) <->
  a registered buffer of the same name and layout.
A 2-D ``weight`` is a Linear kernel and a 1-D one a LayerNorm scale, and a
buffer's leaf name is one of ``CONSTANT_LEAVES``, which makes the map
invertible.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

# leaf names of the flax ``constants`` collection: registered buffers here
CONSTANT_LEAVES = ("projection",)
_COLLECTIONS = ("params", "constants")


def flax_to_state_dict(variables: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """A flax variables dict (``params`` and optionally ``constants``), or a
    bare params tree -> state_dict of CPU tensors."""
    if not isinstance(variables.get("params"), Mapping):
        variables = {"params": variables}
    unknown = sorted(set(variables) - set(_COLLECTIONS))
    if unknown:
        raise ValueError(f"no torch counterpart for flax collections "
                         f"{unknown}")
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, collection):
        for name, sub in tree.items():
            if isinstance(sub, Mapping):
                walk(sub, prefix + (name,), collection)
                continue
            arr = np.asarray(sub)
            if (collection == "constants") != (name in CONSTANT_LEAVES):
                raise ValueError(f"flax leaf {collection}/"
                                 f"{'/'.join(prefix + (name,))} is not in "
                                 f"the collection the bridge maps it from")
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale":
                name = "weight"
            out[".".join(prefix + (name,))] = torch.tensor(
                np.ascontiguousarray(arr))

    for collection in _COLLECTIONS:
        walk(variables.get(collection, {}), (), collection)
    return out


def state_dict_to_variables(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Dict[str, Any]]:
    """state_dict -> flax variables {"params": ..., "constants": ...} of
    numpy arrays (``constants`` only where a buffer of
    ``CONSTANT_LEAVES`` exists)."""
    variables: Dict[str, Dict[str, Any]] = {"params": {}}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy().copy()
        collection = "constants" if leaf in CONSTANT_LEAVES else "params"
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T.copy()) if arr.ndim == 2 \
                else ("scale", arr)
        node = variables.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return variables


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """state_dict -> nested flax params of numpy arrays (buffers of the
    ``constants`` collection left out)."""
    return state_dict_to_variables(state_dict)["params"]
