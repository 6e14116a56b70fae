"""Model information CLI: the parameter counts of a head configuration.

Counterpart of edsnet_tpu/model_info.py, with its printed lines: the
configuration, the head's class name, the count of each flax collection
(``params``, and ``constants`` where the model has some: Performer's
``projection``, a buffer here) and their total.  The counts are the port's
own modules', built on the meta device, so nothing is allocated or
computed; an LSTM's ``bias_ih_l0``, zero and frozen because flax's cell
has one bias per gate (convert.py), is not counted, as JAX has no such
leaf.  The motion head is built at motion width F, as JAX's template
``motion`` [1, 128, F] makes it.

    python -m edsnet_torch.model_info anchor-based --model-depth deep
"""
from __future__ import annotations

import torch
from torch import nn

from edsnet_torch import config as config_lib
from edsnet_torch.convert import CONSTANT_LEAVES
from edsnet_torch.models.model_zoo import get_model


def count_collections(model: nn.Module) -> dict:
    """{"params": trainable parameter count, "constants": count of the
    ``CONSTANT_LEAVES`` buffers} (the latter only where nonzero)."""
    counts = {"params": sum(p.numel() for p in model.parameters()
                            if p.requires_grad)}
    constants = sum(b.numel() for name, b in model.named_buffers()
                    if name.rsplit(".", 1)[-1] in CONSTANT_LEAVES)
    if constants:
        counts["constants"] = constants
    return counts


def summarize(model: nn.Module) -> str:
    """The head's class name, each collection's count and the total."""
    lines = [f"{type(model).__name__}:"]
    counts = count_collections(model)
    for coll, n in counts.items():
        lines.append(f"  {coll}: {n:,}")
    lines.append(f"  total: {sum(counts.values()):,}")
    return "\n".join(lines)


def main(argv=None):
    args = config_lib.get_arguments(argv)
    with torch.device("meta"):
        model = get_model(args.model, **vars(args))
    print(f"config: model={args.model} depth={args.model_depth} "
          f"base={args.base_model} pooling={args.pooling_type}")
    print(summarize(model))


if __name__ == "__main__":
    main()
