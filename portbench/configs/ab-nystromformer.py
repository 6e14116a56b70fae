"""The plain reference of ``ab-nystromformer``: its token mixer inside the
anchor-based head (``HEAD``, what the harness judges the cell by), its
weights' shapes and its forward operation count.

The mixer is lucidrains' Nystromformer as EDSNet uses it (dim_head 64,
8 heads, 64 landmarks, 6 Newton-Schulz iterations, a depthwise residual
conv of 33 over the values, no dropout), on one video without a mask:
the input is padded in front with zeros to a multiple of the landmarks,
and the output cropped to its last n rows.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.model import AnchorBased, trunk_spec


def weight_spec(cfg: Dict) -> List[Tuple]:
    f, h, dh = cfg["num_feature"], cfg["num_head"], cfg["dim_head"]
    k = cfg["residual_conv_kernel"]
    inner = h * dh
    return [("base_model.res_conv", (h, 1, k, 1), ("xavier2", k * h, h)),
            ("base_model.to_qkv.weight", (3 * inner, f),
             ("xavier2", f, 3 * inner)),
            ("base_model.to_out.weight", (f, inner), ("xavier2", inner, f)),
            ("base_model.to_out.bias", (f,), ("const", 0.1)),
            ] + trunk_spec(f, cfg["num_hidden"])


def _pinv(x: torch.Tensor, iters: int) -> torch.Tensor:
    abs_x = x.abs()
    z = x.transpose(-1, -2) / (abs_x.sum(-1).max() * abs_x.sum(-2).max())
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


def mixer(cfg: Dict, W: Dict[str, torch.Tensor], x: torch.Tensor, drop
          ) -> torch.Tensor:
    """x [n, F] -> [n, F]."""
    n = x.shape[0]
    h, dh, m = cfg["num_head"], cfg["dim_head"], cfg["num_landmarks"]
    pad = -n % m
    xp = F.pad(x, (0, 0, pad, 0))
    np_ = xp.shape[0]
    q, k, v = (xp @ W["base_model.to_qkv.weight"].T).reshape(
        np_, 3, h, dh).permute(1, 2, 0, 3)                    # [H, Np, D]
    q = q * dh ** -0.5
    l = np_ // m
    q_l = q.reshape(h, m, l, dh).sum(2) / l
    k_l = k.reshape(h, m, l, dh).sum(2) / l
    attn1 = torch.softmax(q @ k_l.transpose(-1, -2), -1)
    attn2 = torch.softmax(q_l @ k_l.transpose(-1, -2), -1)
    attn3 = torch.softmax(q_l @ k.transpose(-1, -2), -1)
    out = (attn1 @ _pinv(attn2, cfg["pinv_iterations"])) @ (attn3 @ v)
    kernel = cfg["residual_conv_kernel"]
    out = out + F.conv2d(v[None], W["base_model.res_conv"],
                         padding=(kernel // 2, 0), groups=h)[0]
    out = out.permute(1, 0, 2).reshape(np_, h * dh)
    out = out @ W["base_model.to_out.weight"].T + W["base_model.to_out.bias"]
    return out[-n:]


def forward_flops(cfg: Dict, n: int) -> float:
    """Multiply-add operations x 2 of one forward at n positions (the
    landmark padding counted, the softmaxes, norms and pools not)."""
    f, hid, h, dh = (cfg["num_feature"], cfg["num_hidden"], cfg["num_head"],
                     cfg["dim_head"])
    m, it, k = cfg["num_landmarks"], cfg["pinv_iterations"], \
        cfg["residual_conv_kernel"]
    s = len(cfg["anchor_scales"])
    np_ = -(-n // m) * m
    inner = h * dh
    mix = (2 * np_ * f * 3 * inner            # to_qkv
           + 2 * h * (np_ * m * dh            # q k_l^T
                      + m * m * dh            # q_l k_l^T
                      + m * np_ * dh          # q_l k^T
                      + it * 4 * m ** 3       # pinv: 4 products an iteration
                      + np_ * m * m           # attn1 @ pinv
                      + m * np_ * dh          # attn3 @ v
                      + np_ * m * dh          # (attn1 pinv) @ (attn3 v)
                      + np_ * k * dh)         # residual conv
           + 2 * np_ * inner * f)             # to_out
    trunk = 2 * n * (f * hid + cfg["fc_depth"] * hid * hid + s * hid * 3)
    return float(mix + trunk)


HEAD = AnchorBased(mixer)
