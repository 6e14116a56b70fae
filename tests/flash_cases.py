"""Shapes, inputs and limits of the flash-attention kernels against their
plain twins on a card, read by tests/test_torch_flash_kernel.py (every
case) and chip_smoke.py (the main path's shapes it times).

Imports neither JAX nor edsnet_tpu.  Limits: at "highest" (3 TF32 passes)
1e-4, f32 with another summation order; at "default" (1 TF32 pass) 2^-8,
8 unit roundoffs of a TF32 operand.
"""
from typing import List, Tuple

import numpy as np
import torch

from edsnet_torch.kernels import flash_attention as flash

TOL = {"highest": 1e-4, "default": 2.0 ** -8}

# head dim 256: the deep anchor-free model's base_model1 at F 1024 (4
# heads) on a bucket-2304 eval batch of 4 rows, row lengths up to the
# longest synthetic video's 2100
DEEP_LENS = [2100] * 4 + [1902] * 4 + [1700] * 4 + [1500] * 4
# head dim 512: the local attentions' buffer at bucket 2304, ceil(2304 / 4)
# positions, a segment of ceil(n / 4) real in each of 4 rows x 2 heads
LOCAL_LENS = [525] * 2 + [476] * 2 + [425] * 2 + [375] * 2

# (bh, n, n_pad, d, lens) of the forward
FORWARD_CASES = [
    (4, 192, 192, 64, [150, 150, 100, 100]),
    (2, 128, 128, 128, [100, 100]),
    (2, 100, 128, 128, [100, 100]),     # N not a multiple of 64: pad keys
    (2, 256, 256, 128, [0, 256]),       # a fully-masked row
    (32, 2304, 2304, 128, [2304] * 32),  # the main path's largest shape
    (4, 128, 128, 32, [128] * 4),
    (4, 128, 128, 32, [128, 100, 64, 0]),
    # head dims 256 and 512: flash_fwd_cluster_kernel, a cluster of two
    # blocks per q tile, each owning half of the head dim, S summed from
    # their two partials, m and l written by rank 0
    (4, 192, 192, 256, [192, 150, 100, 0]),
    (16, 2304, 2304, 256, DEEP_LENS),
    (3, 192, 192, 512, [192, 150, 0]),
    (4, 192, 192, 512, [192, 150, 100, 0]),
    (2, 100, 128, 512, [100, 61]),
    (4, 2100, 2112, 512, [2100, 1700, 530, 0]),
    (8, 576, 576, 512, LOCAL_LENS),     # the local-global heads' own shape
    # 33 q tiles x 7 = 231 clusters: an odd count, and an odd last wave
    (7, 2112, 2112, 512, [2100, 1700, 530, 0, 2112, 64, 1])]

# (bh, n, n_pad, d, lens) of dq and dk/dv
BACKWARD_CASES = [(4, 192, 192, 64, [150, 150, 100, 100]),
                  (2, 128, 128, 128, [100, 0]),
                  (2, 100, 128, 128, [100, 100]),     # pad keys
                  (2, 256, 256, 128, [0, 256]),
                  (32, 2304, 2304, 128, [2304] * 32),
                  (4, 128, 128, 32, [128] * 4)]

# (b, h, n, d, lens) of one forward plus backward through flash_attention;
# the last is the largest eval batch
AUTOGRAD_CASES = [(2, 2, 100, 64, [77, 0]),
                  (4, 8, 2304, 128, [2304, 2000, 1500, 700])]

# the main path's largest shape (BH, N, D), every kernel timed there
MAIN_SHAPE = (32, 2304, 128)
# the head dims that flash_fwd_cluster_kernel takes, timed: (8, 2304, 512)
# and (16, 2304, 256) do the operations of MAIN_SHAPE; (8, 576, 512) is the
# local-global heads' own shape.  label: (bh, n, d, lens, seed)
WIDE_SHAPES = {"head dim 512": (8, 2304, 512, [2304] * 8, 7),
               "head dim 512 local": (8, 576, 512, LOCAL_LENS, 6),
               "head dim 256": (16, 2304, 256, DEEP_LENS, 8)}


def mask_levels(bh, n, lens, n_pad) -> np.ndarray:
    """[bh, n_pad] int32: 1 attend, 0 real-but-masked, -1 time pad."""
    m = np.full((bh, n_pad), -1, np.int32)
    m[:, :n] = (np.arange(n)[None, :] < np.asarray(lens)[:, None])
    return m


def forward_pairs(got, want, precision: str
                  ) -> List[Tuple[str, torch.Tensor, torch.Tensor, float,
                                  float]]:
    """(name, got, want, rtol, atol) of each output of the forward that is
    held: out, m and l within 1e-4 at "highest"; out and m + log l within
    2^-8 at "default".  One TF32 pass: m carries the rounding error of the
    row's largest score and l moves with it, so the pair is held through
    the log normaliser m + log l that it defines (and that the backward
    uses)."""
    if precision == "highest":
        return [(name, g, w, TOL[precision], TOL[precision])
                for name, g, w in zip(("out", "m", "l"), got, want)]
    tol = TOL[precision]
    return [("out", got[0], want[0], tol, tol),
            ("m + log l", got[1] + got[2].log(), want[1] + want[2].log(),
             0.0, tol)]


def grad_gap(got: torch.Tensor, want: torch.Tensor, precision: str
             ) -> Tuple[float, float]:
    """(max |got - want|, its limit TOL * max(1, max |want|)) of a
    gradient."""
    return (float((got - want).abs().max()),
            TOL[precision] * max(1.0, float(want.abs().max())))


def autograd_inputs(b, h, n, d, lens, device):
    """Seeded q, k, v and the output's gradient [b, h, n, d], and the [b, n]
    bool key mask."""
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                  .to(device) for _ in range(4))
    mask = torch.arange(n, device=device)[None, :] < torch.tensor(
        lens, device=device)[:, None]
    return q, k, v, g, mask


def autograd_grads(attention, q, k, v, g, mask, **kw):
    """dq, dk, dv of sum(attention(q, k, v, mask) * g) by autograd."""
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (attention(*leaves, mask, **kw) * g).sum().backward()
    return [t.grad for t in leaves]


def dense_attention(q, k, v, mask):
    """Dense masked attention, [B, H, N, D] with a [B, N] bool key mask:
    the oracle of flash_attention."""
    s = torch.einsum("bhnd,bhmd->bhnm", q, k)
    s = torch.where(mask[:, None, None, :], s / q.shape[-1] ** 0.5,
                    flash.NEG)
    return torch.softmax(s, -1) @ v
