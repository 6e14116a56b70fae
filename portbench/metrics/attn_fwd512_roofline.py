"""The head-dim-512 attention's share of its roofline in evaluation: the
least time the chip could take for the ``flash_attention`` calls at head
dim 512 (the local-global encoder's segment attentions, 2 heads of 512)
over the device time of the forward kernel's head-dim-512 instance in the
profiled stretch.

That instance is ``flash_fwd_cluster_kernel<256, P>`` of
``csrc/flash_attention_fwd.cu`` (a cluster of two blocks, each owning a
256-wide half of the head dim), named in the trace as ``KERNEL`` starts
it; ``attn_fwd_roofline`` takes it together with every other
``flash_fwd`` kernel.  A call's least time is ``attn_fwd_roofline``'s
(4 H n^2 D operations over the TF32 peak, or q, k, v and out once over
the HBM peak, n each buffer's real positions), and a call counts only if
made while the profiler recorded.  None when no such call or kernel ran.
"""
from portbench.lib.cell import BENCH_DIR, load_module

_ATTN = load_module(BENCH_DIR / "metrics" / "attn_fwd_roofline.py",
                    "portbench_metric_attn_fwd_roofline")

CORE = _ATTN.CORE
CALLS = (CORE,)
PROFILE = True
HEAD_DIM = 512
KERNEL = "flash_fwd_cluster_kernel<256,"


def read(t):
    device = sum(b - a for name, a, b in t.kernels if KERNEL in name)
    calls = [(args, kwargs) for args, kwargs in t.calls.get(CORE, [])
             if args[0].shape[-1] == HEAD_DIM]
    if device <= 0 or not calls:
        return None
    least = 0.0
    for args, kwargs in calls:
        q = args[0]
        mask = args[3] if len(args) > 3 else kwargs.get("mask")
        _, heads, n_pad, d = q.shape
        lens = ([n_pad] * q.shape[0] if mask is None
                else mask.sum(-1).tolist())
        least += sum(_ATTN.least_seconds(heads, int(n), d) for n in lens)
    return 100.0 * least / device
