"""KTS sanity demo on synthetic piecewise-constant data.

Counterpart of edsnet_tpu/kts_demo.py: prints the detected against the true
change points, and plots them into ``kts_demo.png`` only if matplotlib
imports.

    python -m edsnet_torch.kts_demo
"""
from __future__ import annotations

import numpy as np

from edsnet_torch.ops.kts import cpd_auto, cpd_nonlin


def gen_data(n: int, m: int, d: int = 1, seed: int = 0):
    """Piecewise-constant signal with m random change points."""
    rng = np.random.RandomState(seed)
    cps = np.sort(rng.choice(np.arange(n // 10, n - n // 10), m,
                             replace=False))
    bounds = np.concatenate([[0], cps, [n]])
    x = np.zeros((n, d))
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        x[lo:hi] = rng.rand(d) * 10 - 5
    x += rng.randn(n, d) * 0.2
    return x, cps


def main():
    n, m = 300, 4
    x, true_cps = gen_data(n, m)
    K = x @ x.T

    cps_fixed, _ = cpd_nonlin(K, m)
    cps_auto, _ = cpd_auto(K, n // 10, vmax=1.0)

    print(f"true change points: {true_cps.tolist()}")
    print(f"cpd_nonlin (m={m}): {cps_fixed.tolist()}")
    print(f"cpd_auto:           {cps_auto.tolist()}")

    err = max(min(abs(c - t) for t in true_cps) for c in cps_fixed)
    print(f"max deviation (fixed m): {err} frames")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.plot(x[:, 0])
        for c in true_cps:
            plt.axvline(c, color="g", ls="--")
        for c in cps_fixed:
            plt.axvline(c, color="r", ls=":")
        plt.savefig("kts_demo.png")
        print("plot saved to kts_demo.png")
    except ImportError:
        pass


if __name__ == "__main__":
    main()
