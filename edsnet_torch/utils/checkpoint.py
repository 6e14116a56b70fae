"""Checkpoint save/load with the reference's on-disk naming contract,
``{model_dir}/checkpoint/{split_file}.{idx}.pt``.

Counterpart of edsnet_tpu/utils/checkpoint.py.  ``save_checkpoint`` writes
a torch ``state_dict``.  ``load_checkpoint`` reads either that or a flax
msgpack checkpoint written by edsnet_tpu (the variables dict, ``params`` and
``constants``, as msgpack maps, each array an ext type 1 holding ``(shape,
dtype name, C-order bytes)``), which goes through the weight bridge.
``msgpack`` is imported only for the latter.  The shapes come from the
file where flax's restore takes them from it: a motion head is rebuilt at
the checkpoint's motion width before the load, whatever it was built at.

``save_train_state`` / ``load_train_state`` / ``restore_np_rng`` keep the
resumable train state at ``{checkpoint}.state`` in ``torch.save`` format:
the model's and Adam's ``state_dict``, the next epoch, the best F-score and
the trainer's RNG streams (the numpy ``RandomState`` that composes batches
and the torch generators of dropout and label sampling), so a resumed run
replays an uninterrupted one.  The TPU package's msgpack snapshots are not
read.

Under tensor parallelism (``layout``, parallel/tensor_parallel.py:
``TPLayout``) the files still hold the full ``state_dict`` and full Adam
moments, gathered over the ``model`` ranks, so a checkpoint is the same
file whatever the mesh; ``load_train_state`` slices them back to this
rank's heads.  Every rank calls ``save_train_state`` (its gathers are
collectives) and ``save_checkpoint``, which the trainer hands the
gathered ``state_dict``; rank 0 writes.
"""
from __future__ import annotations

import io
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from edsnet_torch.convert import flax_to_state_dict
from edsnet_torch.parallel.mesh import is_writer

_EXT_NDARRAY = 1


def save_checkpoint(model: nn.Module | Mapping[str, torch.Tensor],
                    path) -> None:
    """Write a module's ``state_dict``, or a state_dict itself (rank 0;
    under tensor parallelism the caller passes the gathered one)."""
    if not is_writer():
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = model.state_dict() if isinstance(model, nn.Module) else model
    torch.save(dict(state), path)


def save_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     epoch: int, best_fscore: float, path,
                     np_rng: Optional[np.random.RandomState] = None,
                     generators: Optional[Mapping[str, torch.Generator]]
                     = None, layout=None) -> None:
    """Write the resumable train state: ``epoch`` is the next one to run.
    The file is replaced in one step, so a crash mid-write keeps the last
    snapshot.  ``layout``: the model and moments are gathered whole."""
    state, opt_state = dict(model.state_dict()), optimizer.state_dict()
    if layout is not None:
        state = layout.gather_state(state)
        opt_state = layout.gather_optimizer(model, opt_state)
    if not is_writer():
        return
    payload: Dict[str, Any] = {
        "model": state,
        "optimizer": opt_state,
        "epoch": int(epoch),
        "best_fscore": float(best_fscore),
    }
    if np_rng is not None:
        _, keys, pos, has_gauss, cached = np_rng.get_state()
        payload["np_rng"] = {"keys": torch.from_numpy(keys.astype(np.int64)),
                             "pos": int(pos), "has_gauss": int(has_gauss),
                             "cached": float(cached)}
    if generators:
        payload["generators"] = {name: g.get_state()
                                 for name, g in generators.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(payload, tmp)
    tmp.replace(path)


def load_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                     path, layout=None) -> Tuple[int, float, Dict[str, Any]]:
    """Restore a snapshot into ``model`` and ``optimizer`` -> (next epoch,
    best F-score, extras); ``extras`` holds the saved ``np_rng`` payload and
    ``generators`` states, where recorded.  It is read onto the CPU: the
    loads move each tensor to its parameter's device, and Adam's step
    counts and the generator states stay on the CPU, as in a fresh run.
    ``layout``: the full tensors are sliced to this rank's heads."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state, opt_state = raw["model"], raw["optimizer"]
    if layout is not None:
        state = layout.slice_state(state)
        opt_state = layout.slice_optimizer(model, opt_state)
    model.load_state_dict(state, strict=True)
    optimizer.load_state_dict(opt_state)
    extras = {k: raw[k] for k in ("np_rng", "generators") if k in raw}
    return int(raw["epoch"]), float(raw["best_fscore"]), extras


def restore_np_rng(rng: np.random.RandomState, payload) -> None:
    """Apply a saved numpy ``RandomState`` payload in place."""
    rng.set_state(("MT19937", payload["keys"].numpy().astype(np.uint32),
                   int(payload["pos"]), int(payload["has_gauss"]),
                   float(payload["cached"])))


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
    device of the model's parameters; a motion head takes the
    checkpoint's motion width (``set_motion_width``)."""
    data = Path(path).read_bytes()
    device = next(model.parameters()).device
    if data[:2] == b"PK":  # torch.save's zip container
        state_dict = torch.load(io.BytesIO(data), map_location=device,
                                weights_only=True)
    else:
        state_dict = flax_to_state_dict(read_flax_msgpack(data))
    if getattr(model, "motion_width", 0):     # a motion head with decoders
        from edsnet_torch.parallel.eval_device import checkpoint_motion_width
        model.set_motion_width(checkpoint_motion_width(state_dict))
    model.load_state_dict(state_dict, strict=True)
    return model
