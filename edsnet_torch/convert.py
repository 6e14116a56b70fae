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

The frame CNNs and the conv3d motion net do not carry flax names: their
modules keep torchvision's ``state_dict`` names, and
``flax_to_torch_cnn`` inverts each JAX ``convert_torch_state_dict``
(models/googlenet.py, convnext.py, swin.py) and maps the flax tree of
JAX's ``data/motion.py`` net.
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


def _t(arr, *perm) -> torch.Tensor:
    arr = np.asarray(arr)
    return torch.tensor(np.ascontiguousarray(arr.transpose(*perm)
                                             if perm else arr))


def _conv(node) -> Dict[str, torch.Tensor]:
    """A flax Conv -> torch's [O, I, kh, kw] (or 3-D) weight and bias."""
    kernel = np.asarray(node["kernel"])
    perm = (kernel.ndim - 1, kernel.ndim - 2) + tuple(range(kernel.ndim - 2))
    out = {"weight": _t(kernel, *perm)}
    if "bias" in node:
        out["bias"] = _t(node["bias"])
    return out


def _dense(node) -> Dict[str, torch.Tensor]:
    out = {"weight": _t(node["kernel"], 1, 0)}
    if "bias" in node:
        out["bias"] = _t(node["bias"])
    return out


def _norm(node) -> Dict[str, torch.Tensor]:
    return {"weight": _t(node["scale"]), "bias": _t(node["bias"])}


def _googlenet_to_torch(variables) -> Dict[str, torch.Tensor]:
    """Inverse of JAX's googlenet ``convert_torch_state_dict``: flax
    ``branch2_0`` is torch's ``branch2.0``; BN ``scale`` / ``bias`` /
    ``mean`` / ``var`` are ``weight`` / ``bias`` / ``running_mean`` /
    ``running_var``, and ``num_batches_tracked`` is 0."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, stats, path):
        if "conv" in node and "bn" in node:
            prefix = ".".join(path)
            out[f"{prefix}.conv.weight"] = _conv(node["conv"])["weight"]
            for k, v in _norm(node["bn"]).items():
                out[f"{prefix}.bn.{k}"] = v
            out[f"{prefix}.bn.running_mean"] = _t(stats["bn"]["mean"])
            out[f"{prefix}.bn.running_var"] = _t(stats["bn"]["var"])
            out[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)
            return
        for name, sub in node.items():
            walk(sub, stats[name], path + (name.replace("_", "."),))

    walk(variables["params"], variables["batch_stats"], ())
    return out


def _convnext_to_torch(variables) -> Dict[str, torch.Tensor]:
    """Inverse of JAX's convnext ``convert_torch_state_dict``."""
    from edsnet_torch.models.convnext import DEPTHS

    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, leaves):
        out.update({f"{prefix}.{k}": v for k, v in leaves.items()})

    put("features.0.0", _conv(params["stem_conv"]))
    put("features.0.1", _norm(params["stem_norm"]))
    for s, depth in enumerate(DEPTHS):
        fi = 2 * s + 1
        if s > 0:
            put(f"features.{fi - 1}.0", _norm(params[f"down{s}_norm"]))
            put(f"features.{fi - 1}.1", _conv(params[f"down{s}_conv"]))
        for b in range(depth):
            block = params[f"stage{s}_block{b}"]
            pre = f"features.{fi}.{b}"
            put(f"{pre}.block.0", _conv(block["dwconv"]))
            put(f"{pre}.block.2", _norm(block["norm"]))
            put(f"{pre}.block.3", _dense(block["pw1"]))
            put(f"{pre}.block.5", _dense(block["pw2"]))
            out[f"{pre}.layer_scale"] = _t(
                np.asarray(block["layer_scale"]).reshape(-1, 1, 1))
    return out


def _swin_to_torch(variables) -> Dict[str, torch.Tensor]:
    """Inverse of JAX's swin ``convert_torch_state_dict``, with the
    attention buffers recomputed (models/swin.py)."""
    from edsnet_torch.models.swin import (DEPTHS, WINDOW,
                                          relative_coords_table,
                                          relative_position_index)

    params = variables["params"]
    out: Dict[str, torch.Tensor] = {}

    def put(prefix, leaves):
        out.update({f"{prefix}.{k}": v for k, v in leaves.items()})

    table = torch.from_numpy(relative_coords_table(WINDOW)).view(
        1, 2 * WINDOW - 1, 2 * WINDOW - 1, 2)
    index = torch.from_numpy(relative_position_index(WINDOW)).reshape(-1)
    put("features.0.0", _conv(params["patch_conv"]))
    put("features.0.2", _norm(params["patch_norm"]))
    for s, depth in enumerate(DEPTHS):
        fi = 2 * s + 1
        if s > 0:
            merge = params[f"merge{s}"]
            put(f"features.{fi - 1}.reduction", _dense(merge["reduction"]))
            put(f"features.{fi - 1}.norm", _norm(merge["norm"]))
        for b in range(depth):
            block = params[f"stage{s}_block{b}"]
            attn = block["attn"]
            pre = f"features.{fi}.{b}"
            put(f"{pre}.attn.qkv", _dense({"kernel": attn["qkv_kernel"],
                                           "bias": attn["qkv_bias"]}))
            put(f"{pre}.attn.proj", _dense({"kernel": attn["proj_kernel"],
                                            "bias": attn["proj_bias"]}))
            out[f"{pre}.attn.logit_scale"] = _t(
                np.asarray(attn["logit_scale"]).reshape(-1, 1, 1))
            put(f"{pre}.attn.cpb_mlp.0", _dense({"kernel": attn["cpb_w1"],
                                                 "bias": attn["cpb_b1"]}))
            put(f"{pre}.attn.cpb_mlp.2", _dense({"kernel": attn["cpb_w2"]}))
            out[f"{pre}.attn.relative_coords_table"] = table.clone()
            out[f"{pre}.attn.relative_position_index"] = index.clone()
            put(f"{pre}.norm1", _norm(block["norm1"]))
            put(f"{pre}.norm2", _norm(block["norm2"]))
            put(f"{pre}.mlp.0", _dense(block["mlp1"]))
            put(f"{pre}.mlp.3", _dense(block["mlp2"]))
    put("norm", _norm(params["final_norm"]))
    return out


def _conv3d_to_torch(variables) -> Dict[str, torch.Tensor]:
    """JAX's data/motion.py net (``conv0`` .. ``conv3`` flax Conv
    [kT, kH, kW, I, O], ``head`` Dense) -> data/motion.py's
    ``Conv3DMotionNet`` module."""
    out: Dict[str, torch.Tensor] = {}
    for name, node in variables["params"].items():
        leaves = _dense(node) if name == "head" else _conv(node)
        out.update({f"{name}.{k}": v for k, v in leaves.items()})
    return out


_CNN_BRIDGES = {"google-net": _googlenet_to_torch,
                "convnext": _convnext_to_torch,
                "swin-transformer": _swin_to_torch,
                "conv3d": _conv3d_to_torch}


def flax_to_torch_cnn(kind: str, variables: Mapping[str, Any]
                      ) -> Dict[str, torch.Tensor]:
    """Flax variables of a frame CNN (``kind`` a fetch_weights key:
    google-net, convnext, swin-transformer) or of the conv3d motion net
    (``conv3d``) -> the port module's ``state_dict`` of CPU tensors."""
    return _CNN_BRIDGES[kind](variables)
