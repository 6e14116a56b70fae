"""Two checks of the local-global heads and the window poolings on one CUDA
card, at full width (F 1024, 8 heads, hidden 128, fc depth 7) with seeded
random weights, on chip_smoke.py's 8 synthetic videos.

    python3 tools/head_checks.py

1. Step determinism of the poolings' interior contraction
   (``ops/window_linear.py:windowed_linear``): nystromformer at scale 12
   with fft and flat-pooling, one ab_train_step at the largest training
   bucket three times from the same seeded model (plain, plain, --remat),
   once with the port's form (one matrix product of the shifted copies)
   and once with the convolution form that JAX runs (``F.conv1d``, cuDNN
   on the card), then the port's form again; prints the parameters whose
   updated values differ between the runs.
2. The local-global heads (anchor-free and anchor-based, attention): the
   kernel route's and the dense route's pred_cls against the same module
   run in float64 on the CPU, on every eval batch, at real positions.

Prints each reading beside the card's name and power limit; exits 2
without a CUDA card.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from edsnet_torch import config as config_lib  # noqa: E402
from edsnet_torch.evaluate import setup  # noqa: E402
from edsnet_torch.models.common import (promote,  # noqa: E402
                                        set_dropout_generator)
from edsnet_torch.models.model_zoo import get_model  # noqa: E402
from edsnet_torch.ops import window_linear as wl  # noqa: E402
from edsnet_torch.parallel import steps  # noqa: E402
from edsnet_torch.parallel.eval_device import (  # noqa: E402
    _num_scales_of, prepare_eval_batches)


def conv_form(x, slot_weights, bias=None):
    """windowed_linear with the interior as JAX computes it: one size-s
    convolution (cuDNN on the card)."""
    n = x.shape[1]
    s = slot_weights.shape[0]
    off = s // 2 - 1
    x, slot_weights = promote(x, slot_weights)
    xp = F.pad(x.transpose(1, 2), (max(off, 0), s - 1 - off))
    y = F.conv1d(xp, slot_weights.permute(2, 1, 0)).transpose(1, 2)
    if off > 0:
        head = x[:, :min(s, n), :]
        terms = torch.einsum("bjh,jho->bjo", head,
                             slot_weights[:head.shape[1]])
        fix = wl._left_edge(torch.cumsum(terms, dim=1), off, s, n)
        y = torch.cat([fix, y[:, fix.shape[1]:]], dim=1)
    if bias is not None:
        y = y + bias
    return y


def step_determinism(smi: str, train_videos, device) -> None:
    port_form = wl.windowed_linear
    try:
        for form, fn in (("product", port_form), ("conv1d", conv_form),
                         ("product", port_form)):
            wl.windowed_linear = fn
            for pooling in ("fft", "flat-pooling"):
                args = config_lib.get_arguments(
                    ["anchor-based", "--base-model", "nystromformer",
                     "--anchor-scales", "12", "--pooling-type", pooling])
                setup(args)
                big = chip_smoke.train_batches(args, train_videos,
                                               device)[-1]
                updated = []
                for remat in (False, False, True):
                    model = chip_smoke.seeded_model(args, device)
                    set_dropout_generator(
                        model, torch.Generator(device).manual_seed(1))
                    opt = steps.make_optimizer(model.parameters(), args.lr,
                                               args.weight_decay)
                    steps.ab_train_step(
                        model, opt, big, torch.Generator(device).manual_seed(2),
                        lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
                        remat=remat)
                    updated.append(dict(model.named_parameters()))
                for label, other in (("plain vs plain", updated[1]),
                                     ("plain vs --remat", updated[2])):
                    diff = [n for n, p in updated[0].items()
                            if not torch.equal(p, other[n])]
                    print(f"[{smi}] {form} form, {pooling}, {label}: "
                          f"{len(diff)} parameters differ {diff}", flush=True)
    finally:
        wl.windowed_linear = port_form


def routes_vs_f64(smi: str, records, device) -> None:
    setup(config_lib.get_arguments(["anchor-based"]))
    prepared = prepare_eval_batches(records, 4, 64, device)
    for model_type in ("anchor-free", "anchor-based"):
        args = config_lib.get_arguments(
            [model_type, "--model-depth", "local-global-attention"])
        model = chip_smoke.seeded_model(args, device).eval()
        dense = get_model(args.model, **{**vars(args), "use_pallas": False})
        dense = dense.to(device).eval()
        dense.load_state_dict(model.state_dict())
        ref = get_model(args.model, **vars(args))
        ref.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        ref = ref.double().eval()
        t0 = time.perf_counter()
        for entry in prepared:
            tb = entry["tb"]
            with torch.inference_mode():
                got = model.predict(tb["seq"], tb["mask"])[0].cpu().double()
                plain = dense.predict(tb["seq"], tb["mask"])[0].cpu().double()
                want = ref.predict(tb["seq"].cpu().double(),
                                   tb["mask"].cpu())[0]
            real = tb["mask"].cpu().repeat_interleave(_num_scales_of(model),
                                                      dim=1)

            def gap(a, b):
                return float((a - b).abs()[real].max())

            print(f"[{smi}] {model_type} local-global, bucket "
                  f"{tb['seq'].shape[1]}, lens {tb['lens'].tolist()}: "
                  f"pred_cls kernel vs float64 {gap(got, want):.3e}, dense "
                  f"vs float64 {gap(plain, want):.3e}, kernel vs dense "
                  f"{gap(got, plain):.3e}", flush=True)
        print(f"  float64 on the CPU took {time.perf_counter() - t0:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("head_checks: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi()
    device = torch.device("cuda")
    records = chip_smoke.synthetic_records(0, 1024)
    train_videos = [r for i, r in enumerate(records) if i not in (2, 5)]
    step_determinism(smi, train_videos, device)
    routes_vs_f64(smi, records, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
