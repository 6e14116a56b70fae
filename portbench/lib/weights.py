"""Model weights from a seed, made on the device in one draw, by the
(name, shape, init) list of a configuration's reference.

Inits: ("xavier2", fan_in, fan_out) is U(+-sqrt(2) sqrt(6 / (fan_in +
fan_out))), the reference trainer's re-init; ("const", c) fills c.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make_weights(spec: List[Tuple], seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    """float32 weights by name, on ``device``."""
    sizes = [math.prod(shape) for _, shape, init in spec
             if init[0] == "xavier2"]
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, offset = {}, 0
    for name, shape, init in spec:
        if init[0] == "xavier2":
            n = math.prod(shape)
            limit = math.sqrt(2.0) * math.sqrt(6.0 / (init[1] + init[2]))
            out[name] = (u[offset:offset + n] * limit).reshape(shape)
            offset += n
        elif init[0] == "const":
            out[name] = torch.full(shape, float(init[1]), device=device)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return out
