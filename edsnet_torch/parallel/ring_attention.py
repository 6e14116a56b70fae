"""Ring attention: the sequence axis of the attention backbone sharded over
the ``seq`` ranks of a mesh.

Counterpart of edsnet_tpu/parallel/ring_attention.py.  Each rank holds the
N/P positions of its chunk of q, k and v and the key mask; for P steps it
merges one score block of its queries against the k / v chunk it holds
into an online softmax (``ring_step``, a pure function), then passes that
chunk to the next rank of the seq group and takes the previous rank's
(``rotate``: ``batch_isend_irecv``).  The output is gathered over the seq
group.  The mask is JAX's one level: a masked score is ``NEG`` and the
normaliser is floored at 1e-30, so a fully masked row averages v as JAX's
does (the flash kernel's three-level mask is another rule).  The
arithmetic is plain torch in float32; the ring runs on deterministic
passes only (models/attention.py).

``emulate_ring`` runs the same steps for P ranks in one process, the
transport replaced by a rotation of Python lists.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from edsnet_torch.parallel.mesh import Mesh, all_gather

NEG = -1e30


def ring_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              m: torch.Tensor, acc: torch.Tensor, mx: torch.Tensor,
              den: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge the block of the (scaled) queries ``q`` [B, H, n, D] against
    ``k`` / ``v`` [B, H, n', D] with key mask ``m`` [B, n'] into the running
    (acc [B, H, n, D], row max mx and normaliser den [B, H, n, 1])."""
    s = torch.einsum("bhid,bhjd->bhij", q, k)
    s = torch.where(m[:, None, None, :], s, NEG)
    new_mx = torch.maximum(mx, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(mx - new_mx)
    p = torch.exp(s - new_mx)
    den = den * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhij,bhjd->bhid", p, v)
    return acc, new_mx, den


def ring_init(q: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty (acc, mx, den) for queries of ``q``'s shape."""
    b, h, n, d = q.shape
    return (torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device),
            torch.full((b, h, n, 1), NEG, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device))


def ring_finish(acc: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return acc / torch.clamp(den, min=1e-30)


def rotate(tensors: Sequence[torch.Tensor], mesh: Mesh, axis: str
           ) -> List[torch.Tensor]:
    """Each tensor sent to the next rank of ``axis`` and replaced by the
    previous rank's, in one ``batch_isend_irecv``."""
    ranks = mesh.axis_ranks(axis)
    i = mesh.axis_rank(axis)
    nxt, prv = ranks[(i + 1) % len(ranks)], ranks[(i - 1) % len(ranks)]
    group = mesh.group(axis)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format)
           for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), nxt, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, o, prv, group) for o in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *, mesh: Mesh,
                   axis_name: str = "seq", batch_axis: Optional[str] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """Exact masked attention of this rank's chunk of the sequence.

    q / k / v: [B, H, N/P, D], the rank's chunk of positions (and its
    rows of ``batch_axis`` and heads of ``head_axis``, which the caller
    has already taken; no collective crosses those axes); mask: [B, N/P]
    bool or None.  Returns the whole sequence's output [B, H, N, D] in
    float32, gathered over ``axis_name``."""
    ring_attention.calls += 1
    p = mesh.shape[axis_name]
    if mask is None:
        mask = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool,
                          device=q.device)
    q = q.to(torch.float32) * q.shape[-1] ** -0.5
    # the mask travels as uint8: not every backend sends bool
    cur = [k.to(torch.float32), v.to(torch.float32), mask.to(torch.uint8)]
    state = ring_init(q)
    for step in range(p):
        state = ring_step(q, cur[0], cur[1], cur[2].bool(), *state)
        if step + 1 < p:
            cur = rotate(cur, mesh, axis_name)
    return all_gather(ring_finish(state[0], state[2]), mesh, axis_name,
                      dim=2)


ring_attention.calls = 0


def emulate_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor], p: int) -> torch.Tensor:
    """The ring of ``p`` ranks in this process: the whole q / k / v [B, H,
    N, D] cut into ``p`` chunks of positions, ``ring_step`` for every rank
    at every step, the k / v / mask chunks rotated by one list position
    (rank i takes rank i - 1's), the outputs concatenated."""
    b, h, n, d = q.shape
    if n % p:
        raise ValueError(f"N {n} does not split over {p} ranks")
    if mask is None:
        mask = torch.ones(b, n, dtype=torch.bool, device=q.device)
    qs = [c.to(torch.float32) * d ** -0.5 for c in q.chunk(p, dim=2)]
    ks = [c.to(torch.float32) for c in k.chunk(p, dim=2)]
    vs = [c.to(torch.float32) for c in v.chunk(p, dim=2)]
    ms = list(mask.chunk(p, dim=1))
    states = [ring_init(c) for c in qs]
    for step in range(p):
        states = [ring_step(qs[r], ks[r], vs[r], ms[r], *states[r])
                  for r in range(p)]
        if step + 1 < p:
            ks, vs, ms = ks[-1:] + ks[:-1], vs[-1:] + vs[:-1], \
                ms[-1:] + ms[:-1]
    return torch.cat([ring_finish(s[0], s[2]) for s in states], dim=2)
