"""The ranks of a ``torch.distributed`` world laid out as a device mesh.

Counterpart of edsnet_tpu/parallel/mesh.py (``make_mesh``,
``make_ring_mesh``, ``shard_batch``, ``replicate``), of
edsnet_tpu/parallel/tensor_parallel.py's ``make_dp_tp_mesh``, and of the
multi-host start-up in edsnet_tpu/utils/runtime.py.  One process drives
one device: the JAX package's devices become the ranks of the world,
started by ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``PORT``), with backend ``nccl`` on ``cuda:LOCAL_RANK``
and ``gloo`` under ``--device cpu``.

A ``Mesh`` names its axes as JAX's do (``data``, ``seq``, ``model``) in
JAX's order, the last axis varying fastest over the ranks.  For each axis
it holds the process group of the ranks that share this rank's
coordinates on every other axis: the gradient sum runs over ``data``, the
ring over ``seq``, the attention output's sum over ``model``.  The
collectives below run whenever a process group exists, at any world size
(a world of 1 still calls NCCL); without one, the world is this process
alone and they return their input.
"""
from __future__ import annotations

import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def torchrun_env() -> bool:
    """Whether this process was started by ``torchrun`` (or its
    variables are set by hand)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def init_distributed(device: torch.device) -> None:
    """Join the process group that ``torchrun``'s variables describe
    (``nccl`` on a CUDA device, ``gloo`` on the CPU); nothing without
    them, or once joined."""
    if not torchrun_env() or dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, init_method="env://", **kwargs)


def world() -> Tuple[int, int]:
    """(this process's rank, the world size); (0, 1) without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_writer() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return world()[0] == 0


class Mesh:
    """The ranks of the world on named axes.

    ``shape`` maps each axis name to its size, in JAX's axis order; rank r
    sits at the coordinates of r in that row-major layout.  Unlike a JAX
    mesh over the first devices, it must span the world: a rank outside
    it would have nothing to run."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.rank, world_size = world()
        if self.size != world_size:
            raise ValueError(f"a mesh of {self.size} device(s) over a "
                             f"world of {world_size}: torchrun must start "
                             f"one rank per mesh device")
        self.distributed = dist.is_initialized()
        sizes = list(self.shape.values())
        self.coords = dict(zip(self.axis_names, _unravel(self.rank, sizes)))
        self._ranks: Dict[str, List[int]] = {}
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for axis in self.axis_names:
            self._ranks[axis], self._groups[axis] = self._axis_group(axis)

    def _axis_group(self, axis: str):
        """The ranks along ``axis`` through this rank, and their group.
        Every rank creates every group of the axis, in the same order, as
        ``new_group`` requires."""
        names, sizes = self.axis_names, list(self.shape.values())
        i = names.index(axis)
        others = [range(n) for j, n in enumerate(sizes) if j != i]
        mine, groups = None, []
        for rest in itertools.product(*others):
            ranks = []
            for a in range(sizes[i]):
                coord = list(rest[:i]) + [a] + list(rest[i:])
                ranks.append(_ravel(coord, sizes))
            groups.append(ranks)
            if self.rank in ranks:
                mine = ranks
        if not self.distributed:
            return mine, None
        if len(mine) == dist.get_world_size():
            return mine, dist.group.WORLD
        handle = None
        for ranks in groups:
            g = dist.new_group(ranks)
            if self.rank in ranks:
                handle = g
        return mine, handle

    def axis_rank(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """The world ranks along ``axis`` through this rank, in axis
        order."""
        return self._ranks[axis]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _unravel(index: int, sizes: Sequence[int]) -> List[int]:
    out = []
    for n in reversed(sizes):
        out.append(index % n)
        index //= n
    return out[::-1]


def _ravel(coord: Sequence[int], sizes: Sequence[int]) -> int:
    index = 0
    for c, n in zip(coord, sizes):
        index = index * n + c
    return index


def make_mesh(num_devices: int = 0, axis: str = "data") -> Mesh:
    """1-D mesh over ``num_devices`` ranks (0 = all).  A request larger
    than the world raises, with JAX's text: training on fewer devices than
    asked would change the batch padding and the random streams."""
    devices = world()[1]
    n = num_devices if num_devices > 0 else devices
    if n > devices:
        raise ValueError(f"requested {n} devices, but only "
                         f"{devices} are available")
    return Mesh({axis: n})


def make_dp_tp_mesh(dp: int, tp: int) -> Mesh:
    """2-D ``('data', 'model')`` mesh: the batch over ``dp`` ranks, the
    attention heads over ``tp``, ``model`` the faster axis."""
    devices = world()[1]
    if devices < dp * tp:
        raise ValueError(f"need {dp}x{tp} devices, have {devices}")
    return Mesh({"data": dp, "model": tp})


def make_ring_mesh(cp: int, tp: int = 0, num_devices: int = 0) -> Mesh:
    """``('data', 'seq'[, 'model'])`` mesh over the training ranks: the
    ring on ``seq = cp`` ranks (-1: every rank ``tp`` leaves), the batch
    on the ranks left over, and the heads on ``model`` when ``tp`` > 1.
    Raises ValueError, with JAX's texts, when the layout does not divide
    the rank count."""
    devices = world()[1]
    total = num_devices if num_devices > 0 else devices
    if total > devices:
        raise ValueError(f"ring mesh over {total} devices requested, but "
                         f"only {devices} are available")
    tp = max(int(tp), 1)
    seq = int(cp) if int(cp) > 0 else max(total // tp, 1)
    if seq < 2:
        raise ValueError(f"ring mesh needs >=2 sequence-axis devices, "
                         f"got cp={cp} of {total}")
    if total % (seq * tp):
        raise ValueError(
            f"--context-parallel {seq}" +
            (f" x --tensor-parallel {tp}" if tp > 1 else "") +
            f" must divide the device count {total}")
    shape = {"data": total // (seq * tp), "seq": seq}
    if tp > 1:
        shape["model"] = tp
    return Mesh(shape)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """In place: ``t`` summed over ``axis``'s group (returned)."""
    if mesh.distributed:
        dist.all_reduce(t, group=mesh.group(axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on ``dim`` in axis
    order (bool tensors travel as uint8)."""
    if not mesh.distributed:
        return t
    size = mesh.shape[axis]
    src = t.contiguous()
    as_bool = src.dtype == torch.bool
    if as_bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim)
    return out.bool() if as_bool else out


def shard_rows(t: torch.Tensor, mesh: Optional[Mesh],
               axis: str = "data") -> torch.Tensor:
    """This rank's rows of a global batch: block ``axis_rank`` of
    ``size`` equal blocks of dim 0 (the whole tensor on a 1-rank axis)."""
    if mesh is None or mesh.shape.get(axis, 1) == 1:
        return t
    size = mesh.shape[axis]
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not split over the "
                         f"{size} ranks of axis {axis!r}")
    rows = t.shape[0] // size
    return t[mesh.axis_rank(axis) * rows:(mesh.axis_rank(axis) + 1) * rows]


def shard_batch(batch: Dict, mesh: Optional[Mesh]) -> Dict:
    """``shard_rows`` over ``data`` of every tensor of a batch."""
    return {k: shard_rows(v, mesh) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """In place: every rank's ``tensors`` set to rank 0's."""
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, src=0)
