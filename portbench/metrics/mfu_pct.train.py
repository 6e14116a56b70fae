"""The whole train step's share of the chip's peak over the measured
window (no span or profiler active): the configuration's forward
operations of every trained position x 3 (forward and backward, no
recomputation), over the window's seconds, against the TF32 peak."""
from portbench.lib import peaks

PHASE = "trained"


def read(t):
    work = t.window.get(PHASE)
    if not work:
        return None
    cfg, model = t.cell.config, t.cell.model
    flops = 3 * sum(model.forward_flops(cfg, n) * c for n, c in work.items())
    return 100.0 * flops / t.window["seconds"] / peaks.TF32_FLOPS
