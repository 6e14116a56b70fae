"""Checkpoint save/load with the reference's on-disk naming contract,
``{model_dir}/checkpoint/{split_file}.{idx}.pt``.

Counterpart of edsnet_tpu/utils/checkpoint.py:save_checkpoint /
load_checkpoint.  Save writes a torch ``state_dict``.  Load reads either
that or a flax msgpack checkpoint written by edsnet_tpu (msgpack maps, each
array an ext type 1 holding ``(shape, dtype name, C-order bytes)``), which
goes through the weight bridge.  ``msgpack`` is imported only for the
latter.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from edsnet_torch.convert import flax_to_state_dict

_EXT_NDARRAY = 1


def save_checkpoint(model: nn.Module | Mapping[str, torch.Tensor],
                    path) -> None:
    """Write a module's ``state_dict``, or a state_dict itself."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if isinstance(model, nn.Module) else model
    torch.save(dict(state), path)


def _ndarray(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 flax checkpoints are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def read_flax_msgpack(data: bytes) -> Dict[str, Any]:
    """Decode flax ``serialization.to_bytes`` output into nested dicts of
    numpy arrays."""
    import msgpack

    def ext_hook(code, payload):
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        raise ValueError(f"unsupported msgpack ext type {code} in a flax "
                         f"checkpoint")

    tree = msgpack.unpackb(data, ext_hook=ext_hook, raw=False)
    if not isinstance(tree, dict):
        raise ValueError("not a flax msgpack checkpoint")
    return tree


def load_checkpoint(model: nn.Module, path) -> nn.Module:
    """Load a torch or flax checkpoint into ``model`` (strict), on the
    device of the model's parameters."""
    data = Path(path).read_bytes()
    device = next(model.parameters()).device
    if data[:2] == b"PK":  # torch.save's zip container
        state_dict = torch.load(io.BytesIO(data), map_location=device,
                                weights_only=True)
    else:
        state_dict = flax_to_state_dict(read_flax_msgpack(data))
    model.load_state_dict(state_dict, strict=True)
    return model
