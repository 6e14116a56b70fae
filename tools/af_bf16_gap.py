"""How far the anchor-free bf16 train step sits from float64, in the port
and in the JAX package, on the CPU: the readings behind
``tests/test_torch_anchor_free.py:test_af_bf16_step_as_close_to_f64_as_jax``.

    JAX_PLATFORMS=cpu python tools/af_bf16_gap.py [--batches 8] [BASE ...]

For each backbone (attention, linear and nystromformer by default), at the
test's widths (F 32, hidden 8, fc depth 2, 2 heads) and from the same
weights, prints per batch the gap of the port's bf16 step and of JAX's
jitted bf16 step to the port's float64 step (|loss - loss64| and the
relative L2 distance of all gradient leaves together), then the medians
the test holds.  Imports JAX and the tests: it is a tool of the
comparison, not of the port.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("bases", nargs="*",
                        default=["attention", "linear", "nystromformer"])
    parser.add_argument("--batches", type=int, default=8)
    opts = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from tests.test_torch_anchor_free import _bf16_gaps

    for base in opts.bases:
        port, ref, _, _ = _bf16_gaps(base, opts.batches)
        for seed, (p, r) in enumerate(zip(port, ref)):
            print(f"{base} batch {seed}: loss gap port {p[0]:.3e} jax "
                  f"{r[0]:.3e}; gradient rel gap port {p[1]:.3e} jax "
                  f"{r[1]:.3e}")
        got, want = np.median(port, axis=0), np.median(ref, axis=0)
        print(f"{base} median: loss gap port {got[0]:.3e} jax {want[0]:.3e}; "
              f"gradient rel gap port {got[1]:.3e} jax {want[1]:.3e}")


if __name__ == "__main__":
    main()
