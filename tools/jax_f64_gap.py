"""How far the JAX package's float32 headline forward sits from float64, on
the CPU: the reference point for the port's float64 check on the card
(``chip_smoke.py``'s phase "headline path at full width").

    JAX_PLATFORMS=cpu python tools/jax_f64_gap.py [--seed 0]

Builds ``edsnet_tpu``'s anchor-based shallow DSNet with the nystromformer
backbone, anchor scale 12, F 1024, 8 heads, hidden 128, fc depth 7, from
seeded random weights; runs one padded batch of B 4 x N 2304 (lengths
2304, 2100, 1583, 963; unit-norm random features, as ``chip_smoke.py``'s
synthetic videos have) in float32 and, with the same weights and inputs
cast up, in float64; prints the largest absolute difference of pred_cls
and of the loc offsets at real positions.  Imports JAX: it is a tool of
the reference package, not of the port.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LENS = (2304, 2100, 1583, 963)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    seed = parser.parse_args().seed

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from edsnet_tpu.models.model_zoo import get_model

    model = get_model("anchor-based", base_model="nystromformer",
                      num_feature=1024, num_hidden=128, anchor_scales=[12],
                      num_head=8, fc_depth=7, pooling_type="roi",
                      model_depth="shallow", attention_depth=2,
                      encoder_type="classic", orientation="paper")
    n = max(LENS)
    rng = np.random.RandomState(seed)
    mask = np.arange(n)[None, :] < np.asarray(LENS)[:, None]
    x = rng.randn(len(LENS), n, 1024).astype(np.float32)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True) * mask[..., None]
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           jnp.asarray(mask))
    outs = {}
    for dtype in (jnp.float32, jnp.float64):
        cast = jax.tree_util.tree_map(lambda a: a.astype(dtype), variables)
        cls, loc = model.apply(cast, jnp.asarray(x, dtype), jnp.asarray(mask))
        outs[dtype] = (np.asarray(cls, np.float64), np.asarray(loc,
                                                               np.float64))
    real = mask[..., None]
    cls_err = np.abs(outs[jnp.float32][0] - outs[jnp.float64][0])
    loc_err = np.abs(outs[jnp.float32][1] - outs[jnp.float64][1])
    print(f"edsnet_tpu nystromformer head, B 4 x N {n}, lens {list(LENS)}, "
          f"on {jax.devices()[0].platform}: float32 vs float64 max abs diff "
          f"pred_cls {np.where(real, cls_err, 0).max():.3e}, loc offsets "
          f"{np.where(real[..., None], loc_err, 0).max():.3e}")


if __name__ == "__main__":
    main()
