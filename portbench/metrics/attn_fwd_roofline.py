"""The attention core's share of its roofline in evaluation: the least
time the chip could take over the device time of the core's kernels in
the profiled stretch.

The core is what ``models/attention.py`` calls for a deterministic pass
(``kernels/flash_attention.py:flash_attention``); its kernels are the
device operations whose name holds ``flash_fwd``.  Each call's least
time is the larger of 4 H n^2 D operations over the TF32 peak and its
bytes (q, k and v read once, the output written once, float32) over the
HBM peak, with n each video's valid length, not its bucket; no factor
for the TF32 passes of an implementation.  None when no such kernel ran.
"""
from portbench.lib import peaks

CORE = "edsnet_torch.kernels.flash_attention:flash_attention"
KERNEL = "flash_fwd"
CALLS = (CORE,)
PROFILE = True


def least_seconds(heads: int, n: int, head_dim: int) -> float:
    flops = 4.0 * heads * n * n * head_dim
    bytes_ = 4.0 * 4 * heads * n * head_dim
    return max(flops / peaks.TF32_FLOPS, bytes_ / peaks.HBM_BYTES)


def read(t):
    device = sum(b - a for name, a, b in t.kernels if KERNEL in name)
    calls = t.calls.get(CORE, [])
    if device <= 0 or not calls:
        return None
    least = 0.0
    for args, kwargs in calls:
        q = args[0]
        mask = args[3] if len(args) > 3 else kwargs.get("mask")
        _, heads, n_pad, d = q.shape
        lens = ([n_pad] * q.shape[0] if mask is None
                else mask.sum(-1).tolist())
        least += sum(least_seconds(heads, int(n), d) for n in lens)
    return 100.0 * least / device
