"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (exit code 1 otherwise):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from the sources in this checkout,
   one nvcc per source, all started together; ptxas must report no spills
   for any kernel instance (registers and spills are printed);
3. each kernel against its plain PyTorch twin on the card, at small shapes
   (every head dim the kernels take) and at the main path's largest shape.
   The forward and dk/dv kernels run on the TF32 tensor cores at both
   precisions: "highest" (3 TF32 passes) within 1e-4 (out and m abs, l, a
   sum of up to N terms, relative), "default" (1 pass) within 2^-8, 8 unit
   roundoffs of TF32 (out and the log normaliser m + log l: m alone
   carries the rounding of the row's largest score, and l moves with it).
   The dq kernel (f32 FMAs) and the gradients: max |got - want| <= tol *
   max(1, max |want|), tol 1e-4, and 2^-8 for dk/dv at "default".  Beside
   each reading, the error of the TF32 emulation of kernels/flash_attention
   .py on the same inputs (flash_attention_tf32, flash_attention_dkv_tf32),
   with sums rounded to nearest and toward zero: one pass's error is its
   operand rounding, which both give; at three passes the card's
   accumulator, rounding toward zero after each mma step, sets it, which
   the second gives;
4. the evaluate path at full width: the evaluate entry point's default
   configuration (anchor-based DSNet, attention backbone, F 1024, 8 heads,
   hidden 128, fc depth 7, scales 4 8 16 32) with seeded random weights on
   8 synthetic eccv16-shaped videos, through evaluate_on_device with batch
   size 4; the flash kernel must launch once per eval batch, every F must
   lie in [0, 1], and the dense route (--no-pallas) must give the same
   per-video F and pred_cls within 1e-4; with --num-head 4 (head dim 256,
   which the kernels do not take) the auto route predicts through the
   dense path and --use-pallas raises a ValueError naming HEAD_DIMS;
5. the differentiable attention path, the one that runs the backward
   kernels: flash_attention(..., precision="highest").backward(g) at B 4,
   H 8, N 2304, D 128 with per-video lengths against autograd of the dense
   masked attention (the same 1e-4 limit), one launch of each backward
   kernel per backward, and bit-identical gradients from two runs; then
   the same at precision "default" within 2^-8;
6. the training path at full width: trainer.train_records, same
   configuration, 6 of the synthetic videos to train and 2 to validate,
   batch size 4, 2 epochs, batches composed per epoch from pools; every
   step's loss finite, the parameters changed, no forward-kernel launch
   inside a train step (training keeps the dense attention with dropout)
   and one per eval batch in each validation, every F in [0, 1], and the
   best checkpoint, reloaded, reproducing the recorded best F (1e-6: a
   float32 device mean against a host mean);
7. times in CUDA events after warm-up, beside the card's name and power
   limit: predict per batch, the whole evaluation, a train step per bucket
   and its stages, an epoch, and each kernel against its bound, its twin
   and the library call that computes the same function; the forward and
   dk/dv at both precisions.  A kernel's bound is the larger of its bytes
   over 3.35 TB/s and its operations times the TF32 passes (3 at
   "highest", 1 at "default"; 3 for dq, whose redesign is next) over the
   495 TFLOP/s dense TF32 rate; the f32 bound (67 TFLOP/s) is printed
   beside it.

The last lines are a JSON object describing each kernel, the nvidia-smi
line, and {"ok": true, "device": {...}}.  Without a CUDA card, or without
the rest of the repository beside this file, it exits non-zero before
printing a result.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from typing import Dict, Tuple

import numpy as np
import torch

TOL = 1e-4                    # the kernel's own arithmetic, f32 sums
TOL_DEFAULT = 2.0 ** -8       # one TF32 pass against the f32 twin (phase 3)
TOLS = {"highest": TOL, "default": TOL_DEFAULT}
F32_PEAK_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12      # H100 SXM dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def ptxas_summary(log: str):
    """(kernel<template args>, spill line, registers) per compiled entry of
    an nvcc -Xptxas -v report."""
    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+(flash_\w+?_kernel)"
                          r"I((?:Li\d+E)+)", line)
        if entry:
            args = ", ".join(re.findall(r"Li(\d+)E", entry.group(2)))
            kernel, spills = f"{entry.group(1)}<{args}>", ""
        elif kernel and "spill" in line:
            spills = line.split("stack frame, ")[-1].strip()
        elif kernel and "Used" in line and "registers" in line:
            out.append((kernel, spills,
                        int(re.search(r"Used (\d+) registers", line)[1])))
            kernel = None
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Phases:
    def __init__(self):
        self.failed = []

    def check(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def flash_case(flash, bh, n, d, lens, seed):
    """Random q/k/v [bh, n, d] with per-row real lengths (0 = fully masked
    row, keys past n padded at level -1 up to a multiple of 64)."""
    g = torch.Generator().manual_seed(seed)
    n_pad = -(-n // flash.BLOCK) * flash.BLOCK
    q, k, v = (torch.randn(bh, n_pad, d, generator=g).cuda()
               for _ in range(3))
    mask = torch.full((bh, n_pad), -1, dtype=torch.int32)
    mask[:, :n] = (torch.arange(n)[None, :]
                   < torch.as_tensor(lens)[:, None]).to(torch.int32)
    return q, k, v, mask.cuda()


FLASH_CASES = [(4, 192, 64, [150, 150, 100, 100]),
               (2, 100, 128, [100, 100]),
               (2, 256, 128, [0, 256]),
               (32, 2304, 128, [2304] * 32),
               (4, 128, 32, [128, 100, 64, 0])]


def emulated_errors(emulate, want) -> str:
    """The largest abs error against the twin of each output of a TF32
    emulation (kernels/flash_attention.py): sums rounded to nearest, then
    rounded toward zero after each mma step as the card's accumulator
    does."""
    out = []
    for toward_zero in (False, True):
        got = emulate(toward_zero=toward_zero)
        out.append(" ".join(f"{float((a - w).abs().max()):.3e}"
                            for a, w in zip(got, want)))
    return f"emulated {out[0]} (nearest), {out[1]} (toward zero)"


def forward_errors(got, want) -> Dict[str, float]:
    """Largest errors of a forward against the twin: out and m abs, l
    relative, and the log normaliser m + log l abs."""
    errs = {name: float((g - w).abs().max())
            for name, g, w in zip(("out", "m"), got, want)}
    errs["l rel"] = float(((got[2] - want[2]) / want[2]).abs().max())
    errs["m + log l"] = float(((got[1] + got[2].log())
                               - (want[1] + want[2].log())).abs().max())
    return errs


def check_flash(flash, phases: Phases) -> Dict[str, float]:
    """Forward kernel vs twin at both precisions: out, m and l (relative)
    within TOL at "highest"; out and m + log l within TOL_DEFAULT at
    "default".  Returns the largest abs error of out over all cases, per
    precision."""
    worst = {p: 0.0 for p in TOLS}
    for i, (bh, n, d, lens) in enumerate(FLASH_CASES):
        args = flash_case(flash, bh, n, d, lens, seed=i)
        want = flash.flash_attention_plain(*args)
        label = f"({bh}, {n}, {d}) lens {sorted(set(lens))}"
        for precision, tol in TOLS.items():
            passes = flash.PASSES[precision]
            got = flash.flash_attention_fwd(*args, precision=precision)
            torch.cuda.synchronize()
            errs = forward_errors(got, want)
            worst[precision] = max(worst[precision], errs["out"])
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            held = ("out", "m", "l rel") if precision == "highest" else (
                "out", "m + log l")
            for name in held:
                phases.check(errs[name] <= tol and finite,
                             f"flash {precision} {label} {name} within "
                             f"{tol:g}")
            print(f"    {precision}: " + "; ".join(
                f"{k} {e:.3e}" for k, e in errs.items()))
            print("      out m l " + emulated_errors(
                lambda **kw: flash.flash_attention_tf32(*args, passes, **kw),
                want))
    return worst


def grad_limit_ok(got: torch.Tensor, want: torch.Tensor, tol: float = TOL
                  ) -> Tuple[bool, float]:
    """max |got - want| <= tol * max(1, max |want|), and finite."""
    err = float((got - want).abs().max())
    ok = (err <= tol * max(1.0, float(want.abs().max()))
          and bool(torch.isfinite(got).all()))
    return ok, err


def check_flash_backward(flash, phases: Phases
                         ) -> Tuple[float, Dict[str, float]]:
    """dq and dk/dv kernels vs the twins on the forward's cases, dk/dv at
    both precisions; returns the largest abs error of dq and, per
    precision, of dk/dv."""
    worst_dq, worst_dkv = 0.0, {p: 0.0 for p in TOLS}
    for i, (bh, n, d, lens) in enumerate(FLASH_CASES):
        q, k, v, mask = flash_case(flash, bh, n, d, lens, seed=10 + i)
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(i)
                        ).cuda()
        out, m, l = flash.flash_attention_plain(q, k, v, mask)
        dd = (g * out).sum(-1, keepdim=True)
        args = (q, k, v, mask, g, m, l, dd)
        label = f"({bh}, {n}, {d}) lens {sorted(set(lens))}"
        dq = flash.flash_attention_dq(*args)
        torch.cuda.synchronize()
        ok, err = grad_limit_ok(dq, flash.flash_attention_dq_plain(*args))
        worst_dq = max(worst_dq, err)
        phases.check(ok, f"flash backward {label} dq")
        errs = [f"dq abs {err:.3e}"]
        want = flash.flash_attention_dkv_plain(*args)
        for precision, tol in TOLS.items():
            passes = flash.PASSES[precision]
            got = flash.flash_attention_dkv(*args, precision=precision)
            torch.cuda.synchronize()
            for name, a, w in zip(("dk", "dv"), got, want):
                ok, err = grad_limit_ok(a, w, tol)
                worst_dkv[precision] = max(worst_dkv[precision], err)
                limit = tol * max(1.0, float(w.abs().max()))
                errs.append(f"{name} {precision} abs {err:.3e} (limit "
                            f"{limit:.3e})")
                phases.check(ok, f"flash backward {precision} {label} "
                                 f"{name} within {tol:g}")
            errs.append("dk dv " + emulated_errors(
                lambda **kw: flash.flash_attention_dkv_tf32(*args, passes,
                                                            **kw), want))
        print(f"    {'; '.join(errs)}")
    return worst_dq, worst_dkv


def check_head_dim_routing(flash, get_model, args, tb, phases: Phases
                           ) -> None:
    """--num-head 4 at F 1024 (head dim 256, which the kernels do not take):
    the auto route predicts through the dense path on the card, and
    --use-pallas raises a ValueError naming HEAD_DIMS."""
    for use_pallas in (None, True):
        model = get_model(args.model, **{**vars(args), "num_head": 4,
                                         "use_pallas": use_pallas})
        model = model.cuda().eval()
        before = flash.flash_attention_fwd.launches
        try:
            with torch.inference_mode():
                pred_cls, _ = model.predict(tb["seq"], tb["mask"])
            outcome = (f"{flash.flash_attention_fwd.launches - before} "
                       f"kernel launches, finite "
                       f"{bool(torch.isfinite(pred_cls).all())}")
        except ValueError as err:
            outcome = f"ValueError: {err}"
        print(f"    --num-head 4, use_pallas {use_pallas}: {outcome}")
        want = ("0 kernel launches, finite True" if use_pallas is None
                else "ValueError: --use-pallas: head dim 256 not in "
                     "HEAD_DIMS")
        phases.check(outcome.startswith(want),
                     f"head dim 256 with use_pallas {use_pallas}: "
                     f"{'dense path' if use_pallas is None else 'raises'}")


def dense_attention(q, k, v, mask):
    """Dense masked attention, [B, H, N, D] with a [B, N] bool key mask."""
    s = torch.einsum("bhnd,bhmd->bhnm", q, k) / q.shape[-1] ** 0.5
    s = torch.where(mask[:, None, None, :], s, -1e30)
    return torch.softmax(s, dim=-1) @ v


def check_flash_autograd(flash, phases: Phases) -> Dict[str, int]:
    """The differentiable attention path at full width; returns the launch
    counts of its counted run (one forward and one backward at
    precision "highest")."""
    b, h, n, d = 4, 8, 2304, 128
    gen = torch.Generator().manual_seed(21)
    q, k, v, g = (torch.randn(b, h, n, d, generator=gen).cuda()
                  for _ in range(4))
    lens = torch.tensor([2304, 2000, 1500, 700])
    mask = (torch.arange(n)[None, :] < lens[:, None]).cuda()

    def grads(fn, **kw):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn(*leaves, mask, **kw).backward(g)
        return [t.grad for t in leaves]

    kernels = (flash.flash_attention_fwd, flash.flash_attention_dq,
               flash.flash_attention_dkv)
    want = grads(dense_attention)
    launches = None
    for precision, tol in TOLS.items():
        for fn in kernels:
            fn.launches = 0
        got = grads(flash.flash_attention, precision=precision)
        torch.cuda.synchronize()
        if launches is None:
            launches = {fn.__name__: fn.launches for fn in kernels}
        again = grads(flash.flash_attention, precision=precision)
        errs = []
        for name, a, w in zip("qkv", got, want):
            ok, err = grad_limit_ok(a, w, tol)
            errs.append(f"d{name} abs {err:.3e}")
            phases.check(ok, f"flash_attention {precision} d{name} vs dense "
                             f"autograd at ({b}, {h}, {n}, {d}), lens "
                             f"{lens.tolist()}, within {tol:g}")
        print(f"    {precision}: {'; '.join(errs)}")
        phases.check(all(torch.equal(a, c) for a, c in zip(got, again)),
                     f"two {precision} backward runs give bit-identical "
                     f"gradients")
    phases.check(launches == {"flash_attention_fwd": 1,
                              "flash_attention_dq": 1,
                              "flash_attention_dkv": 1},
                 f"launches in one forward + backward: {launches}")
    return launches


def check_training(flash, phases: Phases, train_videos, val_videos,
                   args) -> Dict[str, int]:
    """The training path at full width through trainer.train_records;
    returns the launch counts of that run."""
    from edsnet_torch import trainer
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel.eval_device import evaluate_on_device
    from edsnet_torch.utils.checkpoint import load_checkpoint

    kernels = (flash.flash_attention_fwd, flash.flash_attention_dq,
               flash.flash_attention_dkv)
    steps, evals = [], []
    real_step, real_eval = trainer.ab_train_step, trainer.eval_fscore_device

    def counted_step(*a, **kw):     # the forward launches inside one step
        before = flash.flash_attention_fwd.launches
        metrics = real_step(*a, **kw)
        steps.append((metrics["loss"],
                      flash.flash_attention_fwd.launches - before))
        return metrics

    def counted_eval(model, prepared, nms_thresh):
        before = flash.flash_attention_fwd.launches
        val_f = real_eval(model, prepared, nms_thresh)
        evals.append((flash.flash_attention_fwd.launches - before,
                      len(prepared)))
        return val_f

    trainer.ab_train_step, trainer.eval_fscore_device = (counted_step,
                                                         counted_eval)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for fn in kernels:
                fn.launches = 0
            t0 = time.perf_counter()
            best, f1s, epochs = trainer.train_records(
                args, train_videos, val_videos, f"{tmp}/best.pt")
            torch.cuda.synchronize()
            train_ms = (time.perf_counter() - t0) * 1e3
            launches = {fn.__name__: fn.launches for fn in kernels}

            fresh = get_model(args.model, **vars(args))
            init_weights(fresh, torch.Generator().manual_seed(args.seed))
            fresh = fresh.cuda()
            init = {k: v.clone() for k, v in fresh.state_dict().items()}
            load_checkpoint(fresh, f"{tmp}/best.pt")
            fresh.eval()
            reloaded_f, _ = evaluate_on_device(
                fresh, val_videos, args.nms_thresh,
                batch_size=args.batch_size, bucket_size=args.bucket_size)
    finally:
        trainer.ab_train_step, trainer.eval_fscore_device = (real_step,
                                                             real_eval)
    losses = torch.stack([loss for loss, _ in steps]).cpu()
    print(f"  {len(steps)} steps in {args.max_epoch} epochs, "
          f"{train_ms:.1f} ms in all; losses "
          f"{[round(float(x), 4) for x in losses]}")
    print(f"  validation F per epoch {f1s} (epochs {epochs}), best "
          f"{best:.6f}, reloaded best checkpoint {reloaded_f:.6f}; "
          f"launches {launches}")
    phases.check(bool(torch.isfinite(losses).all()) and len(steps) > 0,
                 "every step's loss is finite")
    changed = sum(not torch.equal(init[k], v)
                  for k, v in fresh.state_dict().items())
    phases.check(changed == len(init),
                 f"parameters changed ({changed}/{len(init)} tensors)")
    phases.check(all(n == 0 for _, n in steps),
                 "no forward-kernel launch inside a train step")
    phases.check(len(evals) == args.max_epoch
                 and all(n == b for n, b in evals),
                 f"forward-kernel launches per validation == eval batches "
                 f"{evals}")
    phases.check(launches["flash_attention_fwd"] == sum(b for _, b in evals)
                 and launches["flash_attention_dq"] == 0
                 and launches["flash_attention_dkv"] == 0,
                 f"training path launches {launches}")
    phases.check(all(0.0 <= f <= 1.0 for f in f1s), "every F in [0, 1]")
    phases.check(abs(reloaded_f - best) <= 1e-6,
                 f"reloaded best checkpoint F {reloaded_f:.7f} == recorded "
                 f"best {best:.7f}")
    return launches


def device_busy_ms(fn) -> Tuple[float, float]:
    """(wall ms, ms of CUDA kernels) of one call of ``fn``, from a
    torch.profiler trace; kernels on one stream do not overlap."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return wall_ms, busy_us / 1e3


def time_training(phases: Phases, train_videos, val_videos, args,
                  smi: str) -> None:
    """A train step per bucket, its stages at the largest bucket, one epoch
    of steps with the device's busy share, and one validation, in CUDA
    events."""
    from edsnet_torch import trainer
    from edsnet_torch.data import batching
    from edsnet_torch.models.common import (init_weights,
                                            set_dropout_generator)
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.ops import losses as L
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import (eval_fscore_device,
                                                   prepare_eval_batches)

    model = get_model(args.model, **vars(args))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.cuda()
    device = next(model.parameters()).device
    set_dropout_generator(model, torch.Generator(device).manual_seed(1))
    gen = torch.Generator(device).manual_seed(2)
    optimizer = steps.make_optimizer(model.parameters(), args.lr,
                                     args.weight_decay)
    items = batching.prepare_items(
        train_videos, args.model, anchor_scales=args.anchor_scales,
        pos_iou=args.pos_iou_thresh, neg_iou=args.neg_iou_thresh,
        inc_iou=args.incomplete_iou_thresh, bucket_size=args.bucket_size)
    batches = [trainer.to_device(b, device) for b in batching.batch_items(
        items, args.batch_size, args.bucket_size, shuffle=False)]
    kw = dict(lambda_reg=args.lambda_reg, neg_ratio=args.neg_sample_ratio,
              inc_ratio=args.incomplete_sample_ratio)
    per_bucket = {}
    for batch in sorted(batches, key=lambda b: b["seq"].shape[1]):
        per_bucket[int(batch["seq"].shape[1])] = cuda_ms(
            lambda: steps.ab_train_step(model, optimizer, batch, gen, **kw),
            iters=5, warmup=2)
    def epoch():
        return [steps.ab_train_step(model, optimizer, b, gen, **kw)
                for b in batches]

    epoch_ms = cuda_ms(epoch, iters=2, warmup=1)
    wall_ms, busy_ms = device_busy_ms(epoch)
    prepared = prepare_eval_batches(val_videos, args.batch_size,
                                    args.bucket_size, device)
    model.eval()
    val_ms = cuda_ms(lambda: eval_fscore_device(model, prepared,
                                                args.nms_thresh),
                     iters=2, warmup=1)

    batch = max(batches, key=lambda b: b["seq"].shape[1])
    model.train()

    def forward():
        label = steps.build_ab_cls_labels(batch, gen, kw["neg_ratio"],
                                          kw["inc_ratio"])
        pred_cls, pred_loc = model(batch["seq"], batch["mask"])
        w = batch["video_valid"].to(torch.float32)
        return ((L.ab_cls_loss(pred_cls, label) + kw["lambda_reg"]
                 * L.ab_loc_loss(pred_loc, batch["loc_label"], label))
                * w).sum() / torch.clamp(w.sum(), min=1.0)

    labels_ms = cuda_ms(lambda: steps.build_ab_cls_labels(
        batch, gen, kw["neg_ratio"], kw["inc_ratio"]), iters=5, warmup=2)
    fwd_ms = cuda_ms(forward, iters=5, warmup=2)
    fwd_bwd_ms = cuda_ms(lambda: forward().backward(), iters=5, warmup=2)
    opt_ms = cuda_ms(optimizer.step, iters=5, warmup=2)
    sizes = [int(b["video_valid"].sum())
             for b in sorted(batches, key=lambda b: b["seq"].shape[1])]
    print(f"  [{smi}] train step ms per bucket (batch sizes {sizes}): "
          f"{ {k: round(v, 3) for k, v in per_bucket.items()} }; one epoch "
          f"of {len(batches)} steps {epoch_ms:.3f} ms; validation of "
          f"{len(val_videos)} videos {val_ms:.1f} ms")
    busy = (f"{busy_ms:.3f} ms of CUDA kernels in {wall_ms:.3f} ms, busy "
            f"{100 * busy_ms / wall_ms:.1f} %" if busy_ms > 0 else
            "device time not measured (the profiler saw no kernels)")
    print(f"  [{smi}] one epoch of steps under torch.profiler: {busy}")
    print(f"  [{smi}] train step at bucket {int(batch['seq'].shape[1])}: "
          f"label sampling {labels_ms:.3f} ms, forward with losses "
          f"{fwd_ms - labels_ms:.3f} ms, backward {fwd_bwd_ms - fwd_ms:.3f}"
          f" ms, Adam {opt_ms:.3f} ms (whole step "
          f"{per_bucket[int(batch['seq'].shape[1])]:.3f} ms)")
    phases.check(all(t > 0 for t in per_bucket.values()), "train steps timed")


def time_kernels(flash, smi: str) -> Dict[str, dict]:
    """Each kernel at (BH, N, D) = (32, 2304, 128), the main path's largest
    shape, at each precision it takes, beside its bound, its twin and the
    library call that computes the same function (CUDA events)."""
    q, k, v, mask = flash_case(flash, 32, 2304, 128, [2304] * 32, seed=9)
    bh, n, d = q.shape
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                    ).cuda()
    out, m, l = flash.flash_attention_fwd(q, k, v, mask)
    dd = (g * out).sum(-1, keepdim=True)
    bwd_args = (q, k, v, mask, g, m, l, dd)
    attn_mask = (mask > 0)[None, :, None, :]
    lq, lk, lv = (t[None].clone().requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=attn_mask)
    # per kernel: operations per BH*N^2*D, [N, D] and [N] tensors read once
    # or written once, the call at a precision, its twin, the library call
    # and the precisions it takes (dq: f32 FMAs, bound at 3 passes)
    rows = (
        ("flash_attention_fwd", 4, 4, 3,
         lambda p: flash.flash_attention_fwd(q, k, v, mask, precision=p),
         lambda: flash.flash_attention_plain(q, k, v, mask),
         lambda: torch.nn.functional.scaled_dot_product_attention(
             q[None], k[None], v[None], attn_mask=attn_mask),
         "scaled_dot_product_attention", tuple(TOLS)),
        ("flash_attention_dq", 6, 5, 4,
         lambda p: flash.flash_attention_dq(*bwd_args),
         lambda: flash.flash_attention_dq_plain(*bwd_args),
         lambda: torch.autograd.grad(lib_out, (lq,), g[None],
                                     retain_graph=True),
         "autograd.grad of q through scaled_dot_product_attention",
         ("highest",)),
        ("flash_attention_dkv", 8, 6, 4,
         lambda p: flash.flash_attention_dkv(*bwd_args, precision=p),
         lambda: flash.flash_attention_dkv_plain(*bwd_args),
         lambda: torch.autograd.grad(lib_out, (lk, lv), g[None],
                                     retain_graph=True),
         "autograd.grad of k, v through scaled_dot_product_attention",
         tuple(TOLS)))
    timing = {}
    for name, n_ops, n_mats, n_rows, call, plain, library, lib_name, \
            precisions in rows:
        ops = n_ops * bh * n * n * d
        io_ms = 4.0 * bh * (n_mats * n * d + n_rows * n) \
            / HBM_BYTES_PER_S * 1e3
        f32_ms = ops / F32_PEAK_FLOPS * 1e3
        t = timing[name] = {
            "plain_ms": cuda_ms(plain, iters=5),
            "library_ms": cuda_ms(library),
            "f32_bound_ms": max(f32_ms, io_ms)}
        for precision in precisions:
            passes = flash.PASSES[precision]
            ops_ms = passes * ops / TF32_PEAK_FLOPS * 1e3
            t[precision] = {
                "ms": cuda_ms(lambda: call(precision)),
                "bound_ms": max(ops_ms, io_ms),
                "bound_by": "operations" if ops_ms >= io_ms else "bytes"}
            r = t[precision]
            print(f"  [{smi}] {name} (32, 2304, 128) {precision}: kernel "
                  f"{r['ms']:.4f} ms ({ops / r['ms'] / 1e9:.2f} TFLOP/s), "
                  f"twin {t['plain_ms']:.4f} ms, {lib_name} "
                  f"{t['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"(operations {ops_ms:.4f} ms at {passes} x "
                  f"{ops:.4g} on 495 TFLOP/s TF32, bytes {io_ms:.4f} ms at "
                  f"3.35 TB/s; f32 bound {t['f32_bound_ms']:.4f} ms at 67 "
                  f"TFLOP/s)")
    return timing


def synthetic_records(seed: int, num_feature: int):
    """8 eccv16-shaped videos in memory: unit-norm features, n_frames = 15
    per position, shots of 1.5-5 s at 30 fps, users' 15% keyshot
    summaries (20 users on tvsum keys, 15 on summe), uniform picks except
    on one video."""
    from edsnet_torch.data.dataset import VideoRecord

    rng = np.random.RandomState(seed)
    n_seqs = np.sort(rng.randint(200, 2101, 8))
    n_seqs[0], n_seqs[-1] = 200, 2100
    records = []
    for i, n_seq in enumerate(n_seqs):
        n_seq = int(n_seq)
        n_frames = 15 * n_seq
        feats = rng.randn(n_seq, num_feature).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        cuts = [0]
        while cuts[-1] < n_frames:
            cuts.append(min(cuts[-1] + int(rng.randint(45, 151)), n_frames))
        bounds = np.asarray(cuts, np.int32)
        cps = np.stack([bounds[:-1], bounds[1:] - 1], 1)
        nfps = (bounds[1:] - bounds[:-1]).astype(np.int32)
        if i == 3:    # irregular sampling: the searchsorted upsample path
            picks = np.sort(rng.choice(n_frames, n_seq, replace=False))
        else:
            picks = np.arange(n_seq) * 15
        tvsum = i % 2 == 0
        users = 20 if tvsum else 15
        summ = np.zeros((users, n_frames), np.float32)
        for u in range(users):
            budget = int(0.15 * n_frames)
            for s in rng.permutation(len(nfps)):
                if nfps[s] <= budget:
                    summ[u, cps[s, 0]:cps[s, 1] + 1] = 1
                    budget -= nfps[s]
        dataset = "tvsum" if tvsum else "summe"
        records.append(VideoRecord(
            key=f"datasets/eccv16_dataset_{dataset}_google_pool5.h5/video_{i}",
            seq=feats, gtscore=rng.rand(n_seq).astype(np.float32), cps=cps,
            n_frames=n_frames, nfps=nfps, picks=picks.astype(np.int32),
            user_summary=summ))
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    opts = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(f"device: {smi}")

    from edsnet_torch import config as config_lib
    from edsnet_torch.evaluate import setup
    from edsnet_torch.kernels import build
    from edsnet_torch.kernels import flash_attention as flash
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.ops.bbox import nms_masked
    from edsnet_torch.parallel.eval_device import (_eval_batch_device,
                                                   batch_eval_device,
                                                   evaluate_on_device,
                                                   prepare_eval_batches)

    phases = Phases()

    print("phase: build")
    t0 = time.perf_counter()
    reports = build.build(*KERNEL_SOURCES)
    print(f"  built {len(KERNEL_SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for kernel, spills, regs in ptxas_summary(log):
            print(f"    {name}: {kernel}: {regs} registers, {spills}")
            phases.check(spills.startswith("0 bytes spill stores, 0 bytes "
                                           "spill loads"),
                         f"ptxas: no spills in {kernel}")

    print("phase: kernels vs plain twins")
    fwd_err = check_flash(flash, phases)
    dq_err, dkv_err = check_flash_backward(flash, phases)

    print("phase: evaluate path at full width")
    args = config_lib.get_arguments(["anchor-based", "--seed",
                                     str(opts.seed)])
    device = setup(args)
    model = get_model(args.model, **vars(args))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    records = synthetic_records(opts.seed, args.num_feature)
    batch_size = 4
    n_batches = len(list(batch_eval_device(records, batch_size,
                                           args.bucket_size)))
    print(f"  {n_params} parameters; {len(records)} videos, n_seq "
          f"{[r.seq.shape[0] for r in records]}, {n_batches} eval batches")

    evaluate_on_device(model, records[:1], args.nms_thresh,
                       batch_size=batch_size, bucket_size=args.bucket_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    per_video = []
    mean_f, mean_div = evaluate_on_device(
        model, records, args.nms_thresh, batch_size=batch_size,
        bucket_size=args.bucket_size, per_video=per_video)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = flash.flash_attention_fwd.launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  mean F {mean_f:.6f}, mean diversity {mean_div:.6f}, peak "
          f"device memory {peak_gb:.2f} GiB")
    for p in per_video:
        print(f"    {p['key']}: F {p['fscore']:.6f} summary frames "
              f"{int(p['summary'].sum())}/{p['summary'].size}")
    phases.check(launches == n_batches,
                 f"flash kernel launches {launches} == eval batches "
                 f"{n_batches}")
    phases.check(all(0.0 <= p["fscore"] <= 1.0 for p in per_video)
                 and len(per_video) == len(records), "every F in [0, 1]")

    prepared = prepare_eval_batches(records, batch_size, args.bucket_size,
                                    device)
    dense = get_model(args.model, **{**vars(args), "use_pallas": False})
    dense = dense.to(device).eval()        # --no-pallas: the dense route
    dense.load_state_dict(model.state_dict())
    dense_videos = []
    evaluate_on_device(dense, records, args.nms_thresh, prepared=prepared,
                       per_video=dense_videos)
    same_f = [a["fscore"] == b["fscore"] for a, b in zip(per_video,
                                                         dense_videos)]
    phases.check(all(same_f), f"per-video F equal on kernel and dense "
                              f"routes ({sum(same_f)}/{len(same_f)})")
    cls_err = 0.0
    predict_ms = []
    with torch.inference_mode():
        for entry in prepared:
            tb = entry["tb"]
            real = tb["mask"].repeat_interleave(len(model.scales), dim=1)
            got, _ = model.predict(tb["seq"], tb["mask"])
            want, _ = dense.predict(tb["seq"], tb["mask"])
            cls_err = max(cls_err, float((got - want).abs()[real].max()))
            predict_ms.append(cuda_ms(
                lambda: model.predict(tb["seq"], tb["mask"]), iters=5))
    phases.check(cls_err <= TOL, f"pred_cls kernel vs dense route max abs "
                                 f"err {cls_err:.3e}")
    check_head_dim_routing(flash, get_model, args, prepared[-1]["tb"],
                           phases)

    # where one eval batch's time goes, on the largest bucket
    entry = prepared[-1]
    tb, scales = entry["tb"], len(model.scales)
    batch_ms = cuda_ms(lambda: _eval_batch_device(
        model, tb, scales, args.nms_thresh, entry["frame_bucket"],
        entry["uniform_rate"]), iters=2, warmup=1)
    with torch.inference_mode():
        pred_cls, boxes = model.predict(tb["seq"], tb["mask"])
        positions = torch.arange(pred_cls.shape[1], device=device) // scales
        valid = positions[None, :] < tb["lens"][:, None]
        boxes_c = torch.round(torch.minimum(
            torch.clamp(boxes, min=0.0),
            tb["lens"].to(torch.float32)[:, None, None]))
        nms_ms = cuda_ms(lambda: nms_masked(pred_cls, boxes_c,
                                            args.nms_thresh, valid),
                         iters=2, warmup=1)

    print("phase: differentiable attention path (the backward kernels)")
    bwd_launches = check_flash_autograd(flash, phases)

    print("phase: training path at full width")
    train_args = config_lib.get_arguments([
        "anchor-based", "--seed", str(opts.seed), "--batch-size", "4",
        "--max-epoch", "2"])
    val_ids = (2, 5)       # one tvsum-keyed and one summe-keyed video
    train_videos = [r for i, r in enumerate(records) if i not in val_ids]
    val_videos = [records[i] for i in val_ids]
    print(f"  train n_seq {[r.seq.shape[0] for r in train_videos]}, "
          f"validate n_seq {[r.seq.shape[0] for r in val_videos]}")
    check_training(flash, phases, train_videos, val_videos, train_args)

    print("phase: timing")
    time_training(phases, train_videos, val_videos, train_args, smi)
    timing = time_kernels(flash, smi)
    print(f"  [{smi}] predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]} (bucket lengths "
          f"{[int(e['tb']['seq'].shape[1]) for e in prepared]}); eval of "
          f"{len(records)} videos {eval_ms:.1f} ms")
    print(f"  [{smi}] eval batch at bucket {int(tb['seq'].shape[1])}: "
          f"{batch_ms:.1f} ms = predict {predict_ms[-1]:.2f} ms + NMS "
          f"({pred_cls.shape[1]} boxes) {nms_ms:.1f} ms + rasterise, "
          f"keyshot knapsack and F1 {batch_ms - predict_ms[-1] - nms_ms:.1f} "
          f"ms")
    if phases.failed:
        print(f"FAILED: {phases.failed}")
        return 1
    kernels = []
    for name, source, line, used, err, err_default in (
            ("flash_attention_fwd", "flash_attention_fwd.cu", 58, launches,
             fwd_err["highest"], fwd_err["default"]),
            ("flash_attention_dq", "flash_attention_bwd.cu", 155,
             bwd_launches["flash_attention_dq"], dq_err, None),
            ("flash_attention_dkv", "flash_attention_bwd.cu", 202,
             bwd_launches["flash_attention_dkv"], dkv_err["highest"],
             dkv_err["default"])):
        t = timing[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"edsnet_torch/csrc/{source}",
            "replaces": f"edsnet_tpu/kernels/flash_attention.py:{line}",
            "launches": used, "max_abs_err": err,
            "ms": t["highest"]["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["highest"]["bound_ms"],
            "bound_by": t["highest"]["bound_by"],
            "library_ms": t["library_ms"]}
        if err_default is not None:
            entry["default"] = {"ms": t["default"]["ms"],
                                "max_abs_err": err_default,
                                "bound_ms": t["default"]["bound_ms"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
