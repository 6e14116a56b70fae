"""The whole evaluation's share of the chip's peak over the measured
window (no span or profiler active): the configuration's forward
operations of every predicted video, over the window's seconds, against
the TF32 peak."""
from portbench.lib import peaks

PHASE = "predicted"


def read(t):
    work = t.window.get(PHASE)
    if not work:
        return None
    cfg, model = t.cell.config, t.cell.model
    flops = sum(model.forward_flops(cfg, n) * c for n, c in work.items())
    return 100.0 * flops / t.window["seconds"] / peaks.TF32_FLOPS
