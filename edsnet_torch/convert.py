"""Weight bridge between flax variables (as numpy arrays) and the port's
``state_dict``.

The port's submodules carry the flax module names, so a variable path maps
to a state_dict key by joining with dots, and only the leaves change:
- Dense ``kernel`` (in, out) <-> Linear ``weight`` (out, in), transposed;
- a 3-D DenseGeneral ``kernel`` (flax MHA's ``query`` / ``key`` /
  ``value`` [in, H, D] and ``out`` [H, D, F]) <-> a ``weight`` of the same
  layout, not transposed, and its ``bias`` ([H, D] or [F]) <-> ``bias``
  (models/mha.py:DenseGeneral);
- LayerNorm ``scale`` <-> ``weight``;
- ``bias`` <-> ``bias``;
- any other param leaf (``res_conv``, ``proj_k``, ``proj_v``,
  ``transconv_kernel``, ``transconv_bias``) <-> an ``nn.Parameter`` of the
  same name and layout, not transposed;
- a leaf of the ``constants`` collection (Performer's ``projection``) <->
  a registered buffer of the same name and layout;
- an ``OptimizedLSTMCell_{i}`` subtree (per-gate Dense leaves ``ii``,
  ``if``, ``ig``, ``io`` without bias, ``hi``, ``hf``, ``hg``, ``ho`` with
  bias) <-> the ``nn.LSTM`` of that name: ``weight_ih_l0`` the input
  kernels stacked in gate order i, f, g, o and transposed, ``weight_hh_l0``
  the hidden ones, ``bias_hh_l0`` their biases, ``bias_ih_l0`` zero (into
  flax it is added to the hidden bias).
A 2-D ``weight`` is a Linear kernel, a 3-D one a DenseGeneral kernel and a
1-D one a LayerNorm scale, and a buffer's leaf name is one of
``CONSTANT_LEAVES``, which makes the map invertible.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

# leaf names of the flax ``constants`` collection: registered buffers here
CONSTANT_LEAVES = ("projection",)
_COLLECTIONS = ("params", "constants")
_GATES = ("i", "f", "g", "o")     # torch's stacking order of the LSTM gates
_LSTM_LEAVES = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")


def _lstm_to_torch(cell: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax OptimizedLSTMCell params -> nn.LSTM leaves."""
    bias_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"])
                              for g in _GATES])
    return {
        "weight_ih_l0": np.concatenate(
            [np.asarray(cell[f"i{g}"]["kernel"]).T for g in _GATES]),
        "weight_hh_l0": np.concatenate(
            [np.asarray(cell[f"h{g}"]["kernel"]).T for g in _GATES]),
        "bias_ih_l0": np.zeros_like(bias_hh),
        "bias_hh_l0": bias_hh}


def _lstm_to_flax(leaves: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """nn.LSTM leaves (``bias_ih_l0`` may be absent) -> flax
    OptimizedLSTMCell params."""
    bias = leaves["bias_hh_l0"] + leaves.get("bias_ih_l0", 0.0)
    w_ih, w_hh, bias = (np.split(a, 4) for a in (
        leaves["weight_ih_l0"], leaves["weight_hh_l0"], bias))
    cell: Dict[str, Any] = {}
    for i, g in enumerate(_GATES):
        cell[f"i{g}"] = {"kernel": w_ih[i].T.copy()}
        cell[f"h{g}"] = {"kernel": w_hh[i].T.copy(), "bias": bias[i]}
    return cell


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
            if isinstance(sub, Mapping) and name.startswith(
                    "OptimizedLSTMCell_"):
                for leaf, arr in _lstm_to_torch(sub).items():
                    out[".".join(prefix + (name, leaf))] = torch.tensor(
                        np.ascontiguousarray(arr))
                continue
            if isinstance(sub, Mapping):
                walk(sub, prefix + (name,), collection)
                continue
            arr = np.asarray(sub)
            if (collection == "constants") != (name in CONSTANT_LEAVES):
                raise ValueError(f"flax leaf {collection}/"
                                 f"{'/'.join(prefix + (name,))} is not in "
                                 f"the collection the bridge maps it from")
            if name == "kernel":
                name, arr = "weight", (arr.T if arr.ndim == 2 else arr)
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
    cells: Dict[Tuple[str, ...], Dict[str, np.ndarray]] = {}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        arr = tensor.detach().cpu().numpy().copy()
        if leaf in _LSTM_LEAVES:
            cells.setdefault(tuple(path), {})[leaf] = arr
            continue
        collection = "constants" if leaf in CONSTANT_LEAVES else "params"
        if leaf == "weight":
            if arr.ndim == 1:
                leaf = "scale"
            else:
                leaf, arr = "kernel", (arr.T.copy() if arr.ndim == 2
                                       else arr)
        node = variables.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    for (*path, name), leaves in cells.items():
        node = variables["params"]
        for part in path:
            node = node.setdefault(part, {})
        node[name] = _lstm_to_flax(leaves)
    return variables


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Any]:
    """state_dict -> nested flax params of numpy arrays (buffers of the
    ``constants`` collection left out)."""
    return state_dict_to_variables(state_dict)["params"]
