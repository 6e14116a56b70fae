"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Each kernel is checked against its plain twin on every case by the
``cuda`` tests; run them first:

    python3 -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py \
        tests/test_torch_nms_kernel.py tests/test_torch_knapsack_kernel.py

This run checks the paths that launch the kernels, and times the kernels,
holding each against its twin at the shapes it times.
Phases, each of which must pass (exit code 1 otherwise):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from the sources in this checkout,
   and the TF32 rate yardstick of tools/flash_fwd_yardsticks.cu, one nvcc
   per source, all started together; ptxas must report no spills for any
   kernel instance (registers and spills are printed);
3. the evaluate path at full width: the evaluate entry point's default
   configuration (anchor-based DSNet, attention backbone, F 1024, 8 heads,
   hidden 128, fc depth 7, scales 4 8 16 32) with seeded random weights on
   8 synthetic eccv16-shaped videos, through evaluate_on_device with batch
   size 4; the flash, NMS and knapsack kernels must each launch once per
   eval batch, every F must
   lie in [0, 1], and the dense route (--no-pallas) must give the same
   per-video F and pred_cls within 1e-4; with --num-head 4 (head dim 256)
   the auto route and --use-pallas each launch the forward kernel once per
   predict, the auto route's pred_cls within 1e-4 of the dense route's;
4. the training path at full width: trainer.train_records, same
   configuration, 6 of the synthetic videos to train and 2 to validate,
   batch size 4, 2 epochs, batches composed per epoch from pools; every
   step's loss finite, the parameters changed, no forward-kernel launch
   inside a train step (training keeps the dense attention with dropout)
   and one per eval batch in each validation, every F in [0, 1], and the
   best checkpoint, reloaded, reproducing the recorded best F (1e-6: a
   float32 device mean against a host mean);
5. times in CUDA events after warm-up, beside the card's name and power
   limit: predict per batch, the whole evaluation, a train step per bucket
   and its stages, an epoch, and each flash-attention kernel against its
   bound, its twin and the library call that computes the same function,
   at both precisions, at (32, 2304, 128); the cluster kernel also at
   (8, 2304, 512), (8, 576, 512) and (16, 2304, 256).  A kernel's bound is
   the larger of its bytes over 3.35 TB/s and its operations times the
   TF32 passes (3 at "highest", 1 at "default") over the 495 TFLOP/s dense
   TF32 rate; the f32 bound (67 TFLOP/s) is printed beside it.  Then the
   forward kernels' registers, shared bytes, blocks per SM and resident
   clusters, and the card's own rate of register-only mma.sync.m16n8k8
   TF32 products.  Each timed flash kernel's outputs at both precisions
   within the limits of tests/flash_cases.py of its twin's; one forward
   plus backward through flash_attention at (4, 8, 2304, 128), at both
   precisions, launching each kernel once, its gradients within those
   limits of dense autograd.  Then the NMS kernel (csrc/nms.cu through
   ops/bbox.py:nms_masked) at one 4-scale row of 1024, 2304 and 4096
   boxes, and the knapsack kernel (csrc/knapsack.cu through
   ops/knapsack.py:knapsack) on one shot row at (N, C) = (80, 1845),
   (128, 1845), (192, 3074) and (576, 8603): the call's output equal to
   the twin's bit for bit in one launch, and the kernel alone, the whole
   call and the plain twin on the card, beside its bytes over 3.35 TB/s
   (and the knapsack's N x C compare-adds at the f32 lane rate);
6. the headline path at full width: anchor-based DSNet, nystromformer,
   ROI pooling, anchor scale 12, F 1024, 8 heads, hidden 128, fc depth 7
   (2,248,843 parameters), seeded random weights, the same 8 videos:
   evaluate_on_device at batch size 4 with every F in [0, 1]; on every
   eval batch, the largest (bucket 2304, 4 rows) included, pred_cls at
   real positions within 1e-4 of the same module and weights run in
   float64 on the CPU, and the boxes within 1e-4 of max(1, max |box|);
   2 epochs through trainer.train_records as in phase 4 (losses finite,
   every parameter changed, the reloaded best checkpoint reproducing the
   best F within 1e-6); no kernel of the port launched in the whole
   phase; times as in phase 5, the eval batch's breakdown (NMS on the
   kernel route beside the plain twin) and peak device
   memory;
7. the other token mixers (fourier at the paper orientation, performer,
   linformer, dwt, linear, lstm, bilstm, gcn) at F 1024, 8 heads and the
   default scales: predict over the eval batches, each against float64 as
   in phase 6 (the gcn's float64 run takes the keep sets the card chose,
   and the phase prints how many entries its own selection would change),
   one train step per bucket (loss finite, every trainable parameter
   changed, Performer's projection buffer and the LSTMs' frozen zero
   bias_ih_l0 bit-identical), no kernel launched; predict ms per batch
   and the train step at the largest bucket;
8. the train-step flags on the headline head (nystromformer, scale 12)
   and on attention: --compute-dtype bfloat16 (one step per bucket, losses
   finite, master parameters and Adam moments float32, every parameter
   changed; step ms and peak memory against float32 at the largest
   bucket), --remat (one step equal to the plain step's updated parameters
   within 1e-6; both peak memories), trainer.train_records with both flags
   for one epoch (as in phase 4), and --matmul-precision tensorfloat32
   (both TF32 switches on during it and off after it; the headline's
   pred_cls gap to float64 and predict ms); no kernel launched;
9. the anchor-free head at full width (the CLI's defaults: F 1024, 8
   heads, hidden 128, fc depth 7, focal and soft-IoU; parameter counts
   against JAX's): attention shallow evaluated on the 8 videos on the
   kernel and the dense route (per-video F equal, pred_cls within 1e-4,
   one forward launch per eval batch, no backward launch) and trained 2
   epochs through trainer.train_records as in phase 4; nystromformer
   shallow against float64 on every eval batch as in phase 6 and one step
   per bucket under each of the four loss pairs (focal | cross-entropy x
   soft-iou | smooth-l1), deep and original predicting, a bfloat16 step at the largest bucket (finite,
   float32 masters and moments) and a --remat step whose updated
   parameters equal the plain step's bit for bit, no kernel launched;
   attention deep and original predicting over the eval batches (forward
   launches per batch: two on deep, base_model1 at head dim 256 and
   base_model2 at 128, one on original, counted by head dim; pred_cls
   within 1e-4 of the dense route) with one step per bucket; predict, NMS
   and step times;
10. the paper's poolings and the other attention heads at full width:
   anchor-based original, deep (--attention-depth 2) and local-global and
   anchor-free local-global on attention (JAX's parameter counts; the 8
   videos evaluated on the kernel and the dense route with per-video F
   equal; the kernel route's pred_cls within 1e-4 of float64 on every eval
   batch, kernel vs dense printed; forward launches per evaluation 7, 14,
   35 and 35, 28 of local-global's at head dim 512; a train step per
   bucket; the evaluated weights saved and reloaded reproducing F);
   --use-pallas on local-global and on shallow --num-head 2, each
   launching the head-dim-512 forward, pred_cls within 2^-8 of the dense
   route; nystromformer at scale 12 with fft, dwt and flat-pooling
   (JAX's parameter counts, pred_cls within 1e-4 of float64 on every eval
   batch, a step per bucket, a bf16 step, a remat step bit-equal to the
   plain one, no kernel), with the TF32 switches off as evaluate.setup
   leaves them (the poolings' product is cuBLAS's); predict and step
   times;
11. the host side at full width: the native C++ library built with g++
   from edsnet_torch/csrc/edsnet_native.cpp into the port's build cache
   and loaded; the host evaluator (--host-eval: predict and NMS on the
   card, summaries on the host) on attention and on the nystromformer
   headline, per-video F within 1e-6 of evaluate_on_device, one forward
   launch per eval batch on attention and none on nystromformer, its time
   split into predict+NMS and host summaries beside the device
   evaluator's; the knapsack audit's report line over the 8 videos (in a
   child process, stopped after AUDIT_BUDGET_S); on both heads 1 epoch
   plus a --resume to 2 (--state-save-every 1) against 2 uninterrupted
   epochs, parameters and best F bit for bit (else the ops torch names
   nondeterministic, and a gap no larger than two uninterrupted runs'),
   with the .state file's size; 2 epochs under --host-eval with the F list
   of the device path; 2 epochs under --profile with a trace holding CUDA
   kernel events, the top device ops and the fenced frames/s; KTS on the
   8 videos' unit features, the card's change points equal to the native
   float64 host route's on every video with no fallback, an unnormalised
   kernel taking the counted float64 fallback, and ms per video on each
   route;
12. the motion head (--model-depth cross-attention) at full width: F
   1024, 8 heads, hidden 128, scales 4 8 16 32, --attention-depth 2, the 8
   videos with synthetic motion features (one unit-norm row per position)
   at widths 1024 and 512; the classic and the local-global encoder at
   JAX's parameter counts (26,398,595 and 44,227,459), each evaluated on
   the kernel and the dense route (per-video F equal; forward launches per
   evaluation 7 and 35, 28 of local-global's at head dim 512), pred_cls
   within 1e-4 of float64 on every eval batch, --host-eval per-video F
   within 1e-6 of the device evaluator's; at motion width 512 the classic
   head trained 2 epochs as in phase 4, its best checkpoint through
   evaluate.eval_checkpoint (evaluate.main after the h5 read) giving the
   best F on both evaluators and raising on width-1024 videos, a step per
   bucket at f32, bf16 and --remat (the remat step's parameters within
   1e-6 of the plain one's); --matmul-precision bfloat16 bit-equal to
   default (TF32) on the headline, with its gap to float64; predict, eval
   and step times and peak memory;
13. the video pipeline on the card after decode and resize (cv2 and PIL
   are host code): GoogLeNet pool5, ConvNeXt-Base and Swin-V2-B at full
   architecture with seeded random weights under torchvision's names, at
   JAX's parameter counts (5,599,904, 87,564,416, 86,905,848), a [32, 3,
   224, 224] batch within 1e-4 of float64 (L2-normalised, TF32 off; the
   TF32 gap printed), ms per frame at batch 1 and 32; the infer path on a
   video of 2100 sampled positions made on the card: GoogLeNet features,
   KTS on the card equal to the native host's, infer.summarize_video on
   the CLI default model and the motion head (classic encoder), each
   through a saved checkpoint, bit-equal summaries on the kernel and dense
   routes with 1 and 0 forward launches; the conv3d motion net on [4, 8,
   112, 112, 3] clips within 1e-4 of float64; times of each stage;
14. parallelism on the one card, at the CLI default's full width: (a) a
   world-1 NCCL process group on cuda:0 (its TCPStore on 127.0.0.1),
   under which 2 epochs of training (--num-devices 1 --batch-size 4) give
   losses, best F and checkpoint tensors bit-equal to the same run without
   a group, and evaluate's --num-devices 0 mesh the same F with 7 forward
   launches, the all-reduces and all-gathers counted; (b) --context-
   parallel 2 on world 1: the trainer's warning, no ring, the same F; (c)
   --num-devices 2 and --tensor-parallel 2 raising JAX's ValueError texts;
   (d) emulated ranks in this process, the per-rank functions of the
   distributed route with the transport a list rotation and a sum: the
   ring at P 2 and 4 on (4, 8, 2304, 128) with the largest eval batch's
   key masks within 1e-5 of float64 and of the dense f32 route, and tp at
   P 2 on the full model's predict over every eval batch, pred_cls within
   1e-5 of max(1, |want|) of the unsharded predict with the forward
   kernel launched once per rank per attention call; ms of each.  One
   card cannot show NCCL across cards or the ring's real transport.

Where a phase launches "no kernel" or "no kernel of the port", it counts
the flash-attention kernels: the NMS and knapsack kernels run in every
evaluation.

Then the count of checks passed, a ``parallel:`` line with phase 14's
numbers, and the last lines: a JSON object describing each kernel
(``launches`` on
the phase 3 evaluate path for the forward, and in phase 5's forward plus
backward for dq and dk/dv, ``launches_anchor_free`` on each of phase 9's
evaluate paths, ``launches_motion`` on each of phase 12's,
``launches_by_path`` on each of phase 13's infer paths,
``launches_parallel`` on phase 14's emulated tp predict, and
flash_fwd_cluster_kernel as two entries: head dim 512 at (8, 576, 512)
with its launches on phase 10's anchor-based local-global evaluation and
phase 12's, and head dim 256 at (16, 2304, 256) with its
launches on phase 9's anchor-free deep predict, and the NMS and knapsack
kernels with their times by row length),
the nvidia-smi line, and {"ok": true, "device": {...}}.
Without a CUDA card, or without the rest of the repository beside this
file, it exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

TOL = 1e-4                    # the kernel's own arithmetic, f32 sums
TOL_DEFAULT = 2.0 ** -8       # one TF32 pass against the f32 twin
PRECISIONS = ("highest", "default")
F32_PEAK_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12      # H100 SXM dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
KERNEL_SOURCES = ("flash_attention_fwd", "flash_attention_bwd", "nms",
                  "knapsack")
# the TF32 rate loop, timed beside the port's kernels (never launched by
# the port)
REPO = Path(__file__).resolve().parent
YARDSTICKS = str(REPO / "tools" / "flash_fwd_yardsticks.cu")
AUDIT_BUDGET_S = 30           # the knapsack audit's child process (phase 11)


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
        entry = re.search(r"Compiling entry function '\w*?\d+"
                          r"(flash_\w+?_kernel|nms_sweep_kernel"
                          r"|knapsack_kernel)(?:I((?:L[ib]\d+E)+))?", line)
        if entry:
            args = ", ".join(re.findall(r"L[ib](\d+)E",
                                        entry.group(2) or ""))
            kernel = f"{entry.group(1)}<{args}>" if args else entry.group(1)
            spills = ""
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
        self.count = 0

    def check(self, ok: bool, what: str) -> bool:
        self.count += 1
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failed.append(what)
        return ok


def port_kernels(flash):
    """The wrappers of the port's kernels, each with its launch count."""
    return (flash.flash_attention_fwd, flash.flash_attention_dq,
            flash.flash_attention_dkv)


def launch_counts(flash) -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in port_kernels(flash)}


def reset_launches(flash) -> None:
    for fn in port_kernels(flash):
        fn.launches = 0
    flash.flash_attention_fwd.launches_by_head_dim = {}


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


def check_head_dim_routing(flash, get_model, args, tb, phases: Phases
                           ) -> None:
    """--num-head 4 at F 1024 (head dim 256): the auto route and
    --use-pallas each launch the forward kernel once per predict on the
    card, and the auto route's pred_cls is within TOL of the dense
    route's (--no-pallas)."""
    from edsnet_torch.models.common import init_weights

    preds = {}
    for use_pallas in (None, True, False):
        model = get_model(args.model, **{**vars(args), "num_head": 4,
                                         "use_pallas": use_pallas})
        init_weights(model, torch.Generator().manual_seed(args.seed))
        model = model.cuda().eval()
        before = flash.flash_attention_fwd.launches
        with torch.inference_mode():
            pred_cls, _ = model.predict(tb["seq"], tb["mask"])
        launched = flash.flash_attention_fwd.launches - before
        preds[use_pallas] = pred_cls
        print(f"    --num-head 4, use_pallas {use_pallas}: {launched} kernel "
              f"launches, finite {bool(torch.isfinite(pred_cls).all())}")
        phases.check(launched == (use_pallas is not False)
                     and bool(torch.isfinite(pred_cls).all()),
                     f"head dim 256 with use_pallas {use_pallas}: "
                     f"{'dense path' if use_pallas is False else 'kernel'}")
    real = tb["mask"].repeat_interleave(len(model.scales), dim=1)
    err = float((preds[None] - preds[False]).abs()[real].max())
    phases.check(err <= TOL, f"head dim 256: pred_cls kernel vs dense route "
                             f"max abs err {err:.3e}")


def eval_batch_breakdown(model, entry, nms_thresh: float
                         ) -> Tuple[float, Tuple[float, float], int]:
    """(ms of one ``_eval_batch_device``, ms of its NMS on the kernel route
    and on the plain twin, boxes) on the eval batch ``entry``, in CUDA
    events."""
    from edsnet_torch.ops.bbox import nms_masked, nms_masked_plain
    from edsnet_torch.parallel.eval_device import (_eval_batch_device,
                                                   _num_scales_of)

    tb, scales = entry["tb"], _num_scales_of(model)
    batch_ms = cuda_ms(lambda: _eval_batch_device(
        model, tb, scales, nms_thresh, entry["frame_bucket"],
        entry["uniform_rate"]), iters=2, warmup=1)
    with torch.inference_mode():
        pred_cls, boxes = model.predict(tb["seq"], tb["mask"])
        positions = torch.arange(pred_cls.shape[1],
                                 device=pred_cls.device) // scales
        valid = positions[None, :] < tb["lens"][:, None]
        boxes_c = torch.round(torch.minimum(
            torch.clamp(boxes, min=0.0),
            tb["lens"].to(torch.float32)[:, None, None]))
        nms_ms = tuple(cuda_ms(lambda: fn(pred_cls, boxes_c, nms_thresh,
                                          valid), iters=2, warmup=1)
                       for fn in (nms_masked, nms_masked_plain))
    return batch_ms, nms_ms, int(pred_cls.shape[1])


def print_breakdown(smi: str, label: str, entry, batch_ms: float,
                    predict_ms: float, nms_ms: Tuple[float, float],
                    n_boxes: int) -> None:
    print(f"  [{smi}] {label} eval batch at bucket "
          f"{int(entry['tb']['seq'].shape[1])}: {batch_ms:.1f} ms = predict "
          f"{predict_ms:.2f} ms + NMS ({n_boxes} boxes) {nms_ms[0]:.3f} ms "
          f"(plain twin {nms_ms[1]:.1f} ms) + rasterise, keyshot knapsack "
          f"and F1 {batch_ms - predict_ms - nms_ms[0]:.1f} ms")


NMS_TIMED = (1024, 2304, 4096)   # one 4-scale row of this many boxes


def time_nms(phases: Phases, smi: str) -> Dict[int, dict]:
    """The NMS kernel (``csrc/nms.cu`` through ``nms_masked``) at one row of
    ``NMS_TIMED`` boxes: the kernel alone, the whole ``nms_masked`` call
    and the twin, in ms, beside the kernel's bytes over 3.35 TB/s; the
    call's keep equal to the twin's bit for bit, in one launch."""
    from edsnet_torch.kernels.nms import nms_sweep
    from edsnet_torch.ops.bbox import (_alive_and_order, nms_masked,
                                       nms_masked_plain)
    from tests.nms_cases import ATTENTION, predicted

    timing = {}
    for n in NMS_TIMED:
        row = [t.cuda() for t in predicted(n, [n // 4 - 20], ATTENTION,
                                           n // 4)]
        before = nms_sweep.launches
        got = nms_masked(*row[:2], 0.5, row[2])
        launched = nms_sweep.launches - before
        want = nms_masked_plain(*row[:2], 0.5, row[2])
        phases.check(torch.equal(got, want) and launched == 1,
                     f"nms kernel == plain twin, one launch: n {n} "
                     f"({int(want.sum())} of {want.numel()} kept)")
        prepared = _alive_and_order(row[0], row[1], row[2])
        t = {"kernel_ms": cuda_ms(lambda: nms_sweep(*prepared, 0.5),
                                  iters=200, warmup=5),
             "call_ms": cuda_ms(lambda: nms_masked(*row[:2], 0.5, row[2]),
                                iters=200, warmup=5),
             "plain_ms": cuda_ms(lambda: nms_masked_plain(*row[:2], 0.5,
                                                          row[2]),
                                 iters=3, warmup=1),
             "bound_ms": 18 * n / HBM_BYTES_PER_S * 1e3}
        timing[n] = t
        print(f"  [{smi}] nms at n {n} (1 row): kernel {t['kernel_ms']:.4f} "
              f"ms, nms_masked call {t['call_ms']:.4f} ms, plain twin "
              f"{t['plain_ms']:.2f} ms, bytes bound {t['bound_ms']:.6f} ms")
    return timing


# (N, max_capacity, frames, frame bucket) of the knapsack's timed rows:
# the eval cells' (80 and 128 shots, 12288-frame bucket), train-tvsum's
# largest and a 30 min video's (take bits in global memory)
KNAPSACK_TIMED = ((80, 1844, 7000, 12288), (128, 1844, 11700, 12288),
                  (192, 3073, 18000, 20480), (576, 8602, 54000, 57344))


def time_knapsack(phases: Phases, smi: str) -> Dict[str, dict]:
    """The knapsack kernel (``csrc/knapsack.cu`` through ``knapsack``) on
    one shot row of each ``KNAPSACK_TIMED`` shape: the kernel alone, the
    whole ``knapsack`` call and the twin, in ms, beside the kernel's bytes
    over 3.35 TB/s and its compare-adds at the f32 lane rate; the call's
    selection equal to the twin's bit for bit, in one launch."""
    from edsnet_torch.kernels.knapsack import knapsack_dp
    from edsnet_torch.ops.knapsack import knapsack, knapsack_plain
    from tests.knapsack_cases import shots

    timing = {}
    for i, (n, cap_max, frames, bucket) in enumerate(KNAPSACK_TIMED):
        values, weights, capacity, got_max = shots(100 + i, [frames], n,
                                                   bucket)
        assert got_max == cap_max, (got_max, cap_max)
        args = [t.cuda().to(torch.int32) for t in (values, weights,
                                                     capacity)]
        before = knapsack_dp.launches
        got = knapsack(*args, cap_max)
        launched = knapsack_dp.launches - before
        want = knapsack_plain(*args, cap_max)
        phases.check(torch.equal(got, want) and launched == 1,
                     f"knapsack kernel == plain twin, one launch: (N, C) "
                     f"({n}, {cap_max + 1}) ({int(want.sum())} of "
                     f"{want.numel()} taken)")
        t = {"kernel_ms": cuda_ms(lambda: knapsack_dp(*args, cap_max),
                                  iters=200, warmup=5),
             "call_ms": cuda_ms(lambda: knapsack(*args, cap_max),
                                iters=200, warmup=5),
             "plain_ms": cuda_ms(lambda: knapsack_plain(*args, cap_max),
                                 iters=3, warmup=1),
             "capacity": int(capacity[0]),
             "bound_ms": max(9 * n / HBM_BYTES_PER_S,
                             n * (cap_max + 1) / (F32_PEAK_FLOPS / 2)) * 1e3}
        timing[f"{n}x{cap_max + 1}"] = t
        print(f"  [{smi}] knapsack at (N, C) ({n}, {cap_max + 1}), capacity "
              f"{t['capacity']} (1 row): kernel {t['kernel_ms']:.4f} ms, "
              f"knapsack call {t['call_ms']:.4f} ms, plain twin "
              f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.7f} ms")
    return timing


def check_training(flash, phases: Phases, train_videos, val_videos,
                   args, expect_kernels: bool = True,
                   on_checkpoint=None) -> Dict[str, int]:
    """The training path at full width through trainer.train_records (the
    step of ``args.model``); returns the launch counts of that run.
    ``expect_kernels``: the backbone is attention, whose validations launch
    the forward kernel once per eval batch; otherwise no kernel may
    launch.  ``on_checkpoint(path, best F)`` runs on the best checkpoint
    before it is deleted."""
    from edsnet_torch import trainer
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel.eval_device import evaluate_on_device
    from edsnet_torch.utils.checkpoint import load_checkpoint

    steps, evals = [], []
    step_name = ("ab_train_step" if args.model == "anchor-based"
                 else "af_train_step")
    real_step, real_eval = getattr(trainer, step_name), \
        trainer.eval_fscore_device

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

    setattr(trainer, step_name, counted_step)
    trainer.eval_fscore_device = counted_eval
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches(flash)
            t0 = time.perf_counter()
            best, f1s, epochs = trainer.train_records(
                args, train_videos, val_videos, f"{tmp}/best.pt")
            torch.cuda.synchronize()
            train_ms = (time.perf_counter() - t0) * 1e3
            launches = launch_counts(flash)

            fresh = get_model(args.model, **vars(args))
            init_weights(fresh, torch.Generator().manual_seed(args.seed))
            fresh = fresh.cuda()
            init = {k: v.clone() for k, v in fresh.state_dict().items()}
            load_checkpoint(fresh, f"{tmp}/best.pt")
            fresh.eval()
            reloaded_f, _ = evaluate_on_device(
                fresh, val_videos, args.nms_thresh,
                batch_size=args.batch_size, bucket_size=args.bucket_size)
            if on_checkpoint is not None:
                on_checkpoint(f"{tmp}/best.pt", best)
    finally:
        setattr(trainer, step_name, real_step)
        trainer.eval_fscore_device = real_eval
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
    if expect_kernels:
        phases.check(len(evals) == args.max_epoch
                     and all(n == b for n, b in evals),
                     f"forward-kernel launches per validation == eval "
                     f"batches {evals}")
        phases.check(launches["flash_attention_fwd"]
                     == sum(b for _, b in evals)
                     and launches["flash_attention_dq"] == 0
                     and launches["flash_attention_dkv"] == 0,
                     f"training path launches {launches}")
    else:
        phases.check(len(evals) == args.max_epoch,
                     f"one validation per epoch {evals}")
        phases.check(not any(launches.values()),
                     f"no kernel launch on the {args.base_model} training "
                     f"path {launches}")
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
    batches = train_batches(args, train_videos, device, args.batch_size)
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
    tag = f"{args.base_model} scales {args.anchor_scales}"
    print(f"  [{smi}] {tag}: train step ms per bucket (batch sizes "
          f"{sizes}): "
          f"{ {k: round(v, 3) for k, v in per_bucket.items()} }; one epoch "
          f"of {len(batches)} steps {epoch_ms:.3f} ms; validation of "
          f"{len(val_videos)} videos {val_ms:.1f} ms")
    busy = (f"{busy_ms:.3f} ms of CUDA kernels in {wall_ms:.3f} ms, busy "
            f"{100 * busy_ms / wall_ms:.1f} %" if busy_ms > 0 else
            "device time not measured (the profiler saw no kernels)")
    print(f"  [{smi}] {tag}: one epoch of steps under torch.profiler: "
          f"{busy}")
    print(f"  [{smi}] {tag}: train step at bucket "
          f"{int(batch['seq'].shape[1])}: "
          f"label sampling {labels_ms:.3f} ms, forward with losses "
          f"{fwd_ms - labels_ms:.3f} ms, backward {fwd_bwd_ms - fwd_ms:.3f}"
          f" ms, Adam {opt_ms:.3f} ms (whole step "
          f"{per_bucket[int(batch['seq'].shape[1])]:.3f} ms)")
    phases.check(all(t > 0 for t in per_bucket.values()), "train steps timed")


def forward_held(got, want, precision: str) -> list:
    """(output, max |got - want|, held) of each forward output that
    tests/flash_cases.py:forward_pairs holds against the twin."""
    from tests.flash_cases import forward_pairs

    return [(name, float((g - w).abs().max()),
             bool(torch.isclose(g, w, rtol=rtol, atol=atol).all()))
            for name, g, w, rtol, atol in forward_pairs(got, want, precision)]


def grads_held(got, want, precision: str) -> list:
    """(gradient, max |got - want|, held) of dq, or of dk and dv, against
    the twin: within TOL * max(1, max |want|) (tests/flash_cases.py)."""
    from tests.flash_cases import grad_gap

    if isinstance(got, torch.Tensor):
        got, want, names = (got,), (want,), ("dq",)
    else:
        names = ("dk", "dv")
    held = []
    for name, a, w in zip(names, got, want):
        err, limit = grad_gap(a, w, precision)
        held.append((name, err, err <= limit))
    return held


def time_kernel(flash, phases: Phases, name, shape, n_ops, n_mats, n_rows,
                call, plain, held, library, lib_name, smi: str,
                iters: int = 20) -> dict:
    """One kernel at ``shape`` (BH, N, D) at each precision beside its
    bound, its twin and the library call (CUDA events), and its outputs
    held against the twin's (``held(got, want, precision)``, the limits of
    tests/flash_cases.py).  The bound: its operations (``n_ops`` BH N^2 D)
    times the TF32 passes over the TF32 rate, or its bytes (``n_mats``
    [N, D] and ``n_rows`` [N] f32 tensors per BH, each read or written
    once) over the memory rate, the larger."""
    bh, n, d = shape
    ops = n_ops * bh * n * n * d
    io_ms = 4.0 * bh * (n_mats * n * d + n_rows * n) / HBM_BYTES_PER_S * 1e3
    f32_ms = ops / F32_PEAK_FLOPS * 1e3
    t = {"plain_ms": cuda_ms(plain, iters=5),
         "library_ms": cuda_ms(library, iters=iters),
         "f32_bound_ms": max(f32_ms, io_ms)}
    want = plain()
    for precision in PRECISIONS:
        passes = flash.PASSES[precision]
        ops_ms = passes * ops / TF32_PEAK_FLOPS * 1e3
        r = t[precision] = {"bound_ms": max(ops_ms, io_ms),
                            "bound_by": ("operations" if ops_ms >= io_ms
                                         else "bytes")}
        r["ms"] = cuda_ms(lambda: call(precision), iters=iters)
        print(f"  [{smi}] {name} {shape} {precision}: kernel "
              f"{r['ms']:.4f} ms ({ops / r['ms'] / 1e9:.2f} TFLOP/s), "
              f"twin {t['plain_ms']:.4f} ms, {lib_name} "
              f"{t['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"(operations {ops_ms:.4f} ms at {passes} x {ops:.4g} on 495 "
              f"TFLOP/s TF32, bytes {io_ms:.4f} ms at 3.35 TB/s; f32 bound "
              f"{t['f32_bound_ms']:.4f} ms at 67 TFLOP/s)")
        gaps = held(call(precision), want, precision)
        phases.check(all(ok for _, _, ok in gaps),
                     f"{name} {shape} {precision} vs twin: " + "; ".join(
                         f"{out} max abs {err:.3e}" for out, err, _ in gaps))
    return t


def kernel_occupancy(build, smi: str) -> Dict[str, list]:
    """Registers, shared bytes, blocks per SM and resident clusters of the
    forward kernel of each head dim at both pass counts
    (cudaFuncGetAttributes and the occupancy queries of the CUDA
    runtime)."""
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    symbol = "edsnet_flash_attention_fwd_occupancy"
    fn = getattr(build.load("flash_attention_fwd"), symbol)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for d in (128, 256, 512):
        for passes in (3, 1):
            info = (ctypes.c_int * 4)()
            err = fn(d, passes, ctypes.cast(info, ctypes.c_void_p))
            if err != 0:
                raise RuntimeError(f"{symbol}({d}, {passes}): cudaError "
                                   f"{err}")
            regs, shared, per_sm, clusters = list(info)
            out[f"flash_attention_fwd d{d} p{passes}"] = list(info)
            print(f"  [{smi}] flash_attention_fwd head dim {d}, {passes} "
                  f"pass(es): {regs} registers, {shared} shared bytes a "
                  f"block, {per_sm} block(s) per SM"
                  + (f", {clusters} clusters of 2 resident "
                     f"({clusters / sms:.2f} per SM)" if clusters else ""))
    return out


def tf32_mma_rate(build, smi: str) -> float:
    """The card's own rate of mma.sync.m16n8k8 TF32 products on registers
    (tools/flash_fwd_yardsticks.cu: 4 blocks of 8 warps per SM, 8
    independent accumulators a warp), TFLOP/s in CUDA events."""
    fn = build.load(YARDSTICKS).edsnet_tf32_mma_rate
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 1024
    out = torch.empty(blocks * 256, device="cuda")

    def run():
        err = fn(out.data_ptr(), blocks, iters,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"tf32_mma_rate launch failed: cudaError {err}")
    ms = cuda_ms(run, iters=5, warmup=2)
    flops = blocks * 8 * iters * 8 * 2 * 16 * 8 * 8
    tflops = flops / (ms * 1e-3) / 1e12
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"  [{smi}] mma.sync.m16n8k8 TF32 on registers: {tflops:.1f} "
          f"TFLOP/s ({100 * tflops * 1e12 / TF32_PEAK_FLOPS:.1f} % of the "
          f"495 dense peak; {ms:.3f} ms for {flops:.4g} operations, "
          f"finite {bool(torch.isfinite(out).all())}; sm clock, max, power "
          f"after: {clocks})")
    return tflops


def sdpa_backend(q, k, v, attn_mask) -> str:
    """The backend scaled_dot_product_attention's dispatcher picks for
    these inputs (torch's own choice function; "not measured" where this
    torch lacks it)."""
    try:
        from torch.nn.attention import SDPBackend
        choice = torch._fused_sdp_choice(q, k, v, attn_mask, 0.0, False)
        return SDPBackend(choice).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError) as err:
        return f"not measured ({type(err).__name__})"


def time_kernels(flash, build, phases: Phases, smi: str) -> Dict[str, dict]:
    """Each kernel at the main path's largest shape, (BH, N, D) = (32,
    2304, 128), and the forward at the wide head dims
    (flash_fwd_cluster_kernel) of tests/flash_cases.py, each at both
    precisions beside its bound, its twin and the library call that
    computes the same function (CUDA events), and held against its twin;
    then the kernels' occupancy and the card's own mma.sync TF32 rate."""
    from tests.flash_cases import MAIN_SHAPE, WIDE_SHAPES

    bh, n, d = MAIN_SHAPE
    q, k, v, mask = flash_case(flash, bh, n, d, [n] * bh, seed=9)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(9)
                    ).cuda()
    out, m, l = flash.flash_attention_fwd(q, k, v, mask)
    dd = (g * out).sum(-1, keepdim=True)
    bwd_args = (q, k, v, mask, g, m, l, dd)
    attn_mask = (mask > 0)[None, :, None, :]
    lq, lk, lv = (t[None].clone().requires_grad_() for t in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=attn_mask)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # per kernel: its shape, operations per BH*N^2*D, [N, D] and [N]
    # tensors read or written once, the call at a precision, its twin, the
    # outputs held against the twin's and the library call
    rows = (
        ("flash_attention_fwd", tuple(q.shape), 4, 4, 3,
         lambda p: flash.flash_attention_fwd(q, k, v, mask, precision=p),
         lambda: flash.flash_attention_plain(q, k, v, mask), forward_held,
         lambda: sdpa(q[None], k[None], v[None], attn_mask=attn_mask),
         "scaled_dot_product_attention"),
        ("flash_attention_dq", tuple(q.shape), 6, 5, 4,
         lambda p: flash.flash_attention_dq(*bwd_args, precision=p),
         lambda: flash.flash_attention_dq_plain(*bwd_args), grads_held,
         lambda: torch.autograd.grad(lib_out, (lq,), g[None],
                                     retain_graph=True),
         "autograd.grad of q through scaled_dot_product_attention"),
        ("flash_attention_dkv", tuple(q.shape), 8, 6, 4,
         lambda p: flash.flash_attention_dkv(*bwd_args, precision=p),
         lambda: flash.flash_attention_dkv_plain(*bwd_args), grads_held,
         lambda: torch.autograd.grad(lib_out, (lk, lv), g[None],
                                     retain_graph=True),
         "autograd.grad of k, v through scaled_dot_product_attention"))
    timing = {row[0]: time_kernel(flash, phases, *row, smi=smi)
              for row in rows}
    timing["flash_attention_fwd"]["library_backend"] = sdpa_backend(
        q[None], k[None], v[None], attn_mask)

    for label, (bh, n, d, lens, seed) in WIDE_SHAPES.items():
        args = flash_case(flash, bh, n, d, lens, seed=seed)
        lib_mask = (args[3] > 0)[None, :, None, :]
        name = f"flash_attention_fwd {label}"
        timing[name] = time_kernel(
            flash, phases, name, (bh, n, d), 4, 4, 3,
            lambda p, a=args: flash.flash_attention_fwd(*a, precision=p),
            lambda a=args: flash.flash_attention_plain(*a), forward_held,
            lambda a=args, lm=lib_mask: sdpa(a[0][None], a[1][None],
                                             a[2][None], attn_mask=lm),
            "scaled_dot_product_attention", smi=smi,
            iters=100 if n < 1024 else 20)
        timing[name]["library_backend"] = sdpa_backend(
            args[0][None], args[1][None], args[2][None], lib_mask)
        timing[name]["shape"] = [bh, n, d]
    for name, t in timing.items():
        if "library_backend" in t:
            print(f"  [{smi}] {name}: scaled_dot_product_attention took the "
                  f"{t['library_backend']} backend")
    timing["occupancy"] = kernel_occupancy(build, smi)
    timing["tf32_mma_tflops"] = tf32_mma_rate(build, smi)
    return timing


def check_flash_autograd(flash, phases: Phases) -> Dict[str, int]:
    """One forward plus backward through ``flash_attention`` at the largest
    eval batch, the last of tests/flash_cases.py's ``AUTOGRAD_CASES``, at
    each precision: one launch of each kernel, and dq, dk, dv within TOL of
    autograd of the dense masked attention.  Returns the launches of the
    run at "highest"."""
    from tests.flash_cases import (AUTOGRAD_CASES, TOL, autograd_grads,
                                   autograd_inputs, dense_attention)

    b, h, n, d, lens = AUTOGRAD_CASES[-1]
    q, k, v, g, mask = autograd_inputs(b, h, n, d, lens, "cuda")
    want = autograd_grads(dense_attention, q, k, v, g, mask)
    launches = {}
    for precision in PRECISIONS:
        reset_launches(flash)
        got = autograd_grads(flash.flash_attention, q, k, v, g, mask,
                             precision=precision)
        torch.cuda.synchronize()
        launches[precision] = launch_counts(flash)
        tol = TOL[precision]
        held = all(bool(torch.isclose(a, w, rtol=tol, atol=tol).all())
                   for a, w in zip(got, want))
        errs = ", ".join(f"d{name} {float((a - w).abs().max()):.3e}"
                         for name, a, w in zip("qkv", got, want))
        phases.check(held and set(launches[precision].values()) == {1},
                     f"flash_attention {precision} at ({b}, {h}, {n}, {d}) "
                     f"lens {lens}: launches {launches[precision]}, max abs "
                     f"{errs} against dense autograd, within {tol:g}")
    return launches["highest"]


HEADLINE_PARAMS = 2_248_843   # nystromformer, scale 12, F 1024, 8 heads
MIXERS = ("fourier", "performer", "linformer", "dwt", "linear", "lstm",
          "bilstm", "gcn")


def seeded_model(args, device: torch.device):
    """The CLI's model with init_weights drawn from --seed, on ``device``."""
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model

    model = get_model(args.model, **vars(args))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device)


def model_inputs(tb):
    """An eval batch's predict inputs: (seq, mask), or (seq, motion, mask,
    motion_mask) for the motion head's batches."""
    if "motion" in tb:
        return tb["seq"], tb["motion"], tb["mask"], tb["motion_mask"]
    return tb["seq"], tb["mask"]


def f64_errors(model, args, prepared, keep_from_card: bool = False):
    """pred_cls and boxes of ``model`` (eval mode, on the card) on every
    eval batch of ``prepared`` against the same module and weights run in
    float64 on the CPU, at real positions -> (pred_cls errors, box errors,
    max |box|, all finite, changed keep entries), one error per batch.
    ``keep_from_card``: the gcn's float64 run takes the keep sets the card
    chose (models/gcn.py:top_similarity_keep), and each batch counts the
    entries that float64's own selection would change."""
    from edsnet_torch.models import gcn
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel.eval_device import _num_scales_of

    ref = get_model(args.model, **{
        **vars(args), "motion_width": getattr(model, "motion_width", None)})
    ref.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref = ref.double().eval()
    real_keep = gcn.top_similarity_keep
    cls_errs, box_errs, changed, box_scale, finite = [], [], [], 1.0, True
    for entry in prepared:
        tb = entry["tb"]
        chosen, flips = [], []

        def record(*a):
            chosen.append(real_keep(*a))
            return chosen[-1]

        def replay(*a):
            own, card = real_keep(*a), chosen.pop(0).cpu()
            flips.append(int((own != card).sum()))
            return card

        try:
            with torch.inference_mode():
                if keep_from_card:
                    # an eager forward: predict may replay a CUDA graph
                    # (models/graphed.py), which calls no Python
                    gcn.top_similarity_keep = record
                    model(*model_inputs(tb))
                    gcn.top_similarity_keep = real_keep
                got_cls, got_boxes = model.predict(*model_inputs(tb))
                if keep_from_card:
                    gcn.top_similarity_keep = replay
                want_cls, want_boxes = ref.predict(*(
                    t.cpu().double() if t.is_floating_point() else t.cpu()
                    for t in model_inputs(tb)))
        finally:
            gcn.top_similarity_keep = real_keep
        changed.append(sum(flips))
        real = tb["mask"].cpu().repeat_interleave(_num_scales_of(model),
                                                  dim=1)
        got_cls, got_boxes = got_cls.cpu().double(), got_boxes.cpu().double()
        finite &= bool(torch.isfinite(got_cls[real]).all()
                       and torch.isfinite(got_boxes[real]).all())
        cls_errs.append(float((got_cls - want_cls).abs()[real].max()))
        box_errs.append(float((got_boxes - want_boxes).abs()[real].max()))
        box_scale = max(box_scale, float(want_boxes.abs()[real].max()))
    return cls_errs, box_errs, box_scale, finite, changed


def check_against_f64(model, args, prepared, phases: Phases, label: str,
                      keep_from_card: bool = False) -> Dict[str, float]:
    """``f64_errors`` printed and held: pred_cls within TOL, boxes within
    TOL * max(1, max |box|).  Returns the largest errors."""
    t0 = time.perf_counter()
    cls_errs, box_errs, box_scale, finite, changed = f64_errors(
        model, args, prepared, keep_from_card)
    largest = prepared[-1]["tb"]
    print(f"    {label} on the card vs float64 on the CPU, per eval batch "
          f"(buckets {[int(e['tb']['seq'].shape[1]) for e in prepared]}, "
          f"the last at {tuple(largest['seq'].shape[:2])} with lens "
          f"{largest['lens'].tolist()}): pred_cls max abs err "
          f"{[float(f'{e:.3e}') for e in cls_errs]}; boxes "
          f"{[float(f'{e:.3e}') for e in box_errs]} (max |box| "
          f"{box_scale:.1f}); {time.perf_counter() - t0:.1f} s")
    if keep_from_card:
        print(f"    {label}: the float64 run took the card's keep sets; its "
              f"own selection would change {changed} entries per batch")
    phases.check(finite and max(cls_errs) <= TOL,
                 f"{label}: pred_cls within {TOL:g} of float64 on every "
                 f"eval batch")
    phases.check(max(box_errs) <= TOL * box_scale,
                 f"{label}: boxes within {TOL:g} x max(1, max |box|) of "
                 f"float64 on every eval batch")
    return {"pred_cls": max(cls_errs), "boxes": max(box_errs)}


def check_headline(flash, phases: Phases, records, train_videos,
                   val_videos, seed: int, smi: str) -> None:
    """The headline path at full width: anchor-based shallow DSNet,
    nystromformer, ROI pooling, anchor scale 12, F 1024, 8 heads, hidden
    128, fc depth 7.  Evaluate (batch size 4) with F in [0, 1] and every
    eval batch against float64, train 2 epochs through
    trainer.train_records, time it, and launch no kernel of the port."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                                   prepare_eval_batches)

    flags = ["anchor-based", "--base-model", "nystromformer",
             "--anchor-scales", "12", "--seed", str(seed)]
    args = config_lib.get_arguments(flags)
    device = torch.device("cuda")
    reset_launches(flash)
    model = seeded_model(args, device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    phases.check(n_params == HEADLINE_PARAMS,
                 f"nystromformer head: {n_params} parameters")

    evaluate_on_device(model, records[:1], args.nms_thresh, batch_size=4,
                       bucket_size=args.bucket_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_video = []
    t0 = time.perf_counter()
    mean_f, mean_div = evaluate_on_device(
        model, records, args.nms_thresh, batch_size=4,
        bucket_size=args.bucket_size, per_video=per_video)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  mean F {mean_f:.6f}, mean diversity {mean_div:.6f}; F per "
          f"video {[round(p['fscore'], 6) for p in per_video]}")
    phases.check(all(0.0 <= p["fscore"] <= 1.0 for p in per_video)
                 and len(per_video) == len(records),
                 "nystromformer: every F in [0, 1]")

    prepared = prepare_eval_batches(records, 4, args.bucket_size, device)
    largest = prepared[-1]
    phases.check(tuple(largest["tb"]["seq"].shape[:2]) == (4, 2304),
                 f"largest eval batch (4, 2304): "
                 f"{tuple(largest['tb']['seq'].shape[:2])}")
    check_against_f64(model, args, prepared, phases, "nystromformer")
    with torch.inference_mode():
        predict_ms = [cuda_ms(lambda: model.predict(e["tb"]["seq"],
                                                    e["tb"]["mask"]),
                              iters=5) for e in prepared]
    batch_ms, nms_ms, n_boxes = eval_batch_breakdown(model, largest,
                                                     args.nms_thresh)

    train_args = config_lib.get_arguments(flags + ["--batch-size", "4",
                                                   "--max-epoch", "2"])
    before = launch_counts(flash)
    torch.cuda.reset_peak_memory_stats()
    check_training(flash, phases, train_videos, val_videos, train_args,
                   expect_kernels=False)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    time_training(phases, train_videos, val_videos, train_args, smi)
    after = launch_counts(flash)
    phases.check(not any(before.values()) and not any(after.values()),
                 f"no kernel of the port launched on the nystromformer path "
                 f"(eval {before}, training {after})")
    print(f"  [{smi}] nystromformer: predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]} (bucket lengths "
          f"{[int(e['tb']['seq'].shape[1]) for e in prepared]}); eval of "
          f"{len(records)} videos {eval_ms:.1f} ms; peak device memory "
          f"{eval_peak:.2f} GiB in evaluation, {train_peak:.2f} GiB in "
          f"training")
    print_breakdown(smi, "nystromformer", largest, batch_ms, predict_ms[-1],
                    nms_ms, n_boxes)


def train_batches(args, train_videos, device, batch_size: int = 4):
    """The training videos' batches per length bucket, on ``device``,
    shortest bucket first."""
    from edsnet_torch import trainer
    from edsnet_torch.data import batching

    items = batching.prepare_items(
        train_videos, args.model, anchor_scales=args.anchor_scales,
        pos_iou=args.pos_iou_thresh, neg_iou=args.neg_iou_thresh,
        inc_iou=args.incomplete_iou_thresh, bucket_size=args.bucket_size)
    return sorted((trainer.to_device(b, device) for b in
                   batching.batch_items(items, batch_size,
                                        args.bucket_size, shuffle=False)),
                  key=lambda b: b["seq"].shape[1])


def check_mixers(flash, phases: Phases, records, train_videos, seed: int,
                 smi: str) -> None:
    """Each other token mixer at F 1024, 8 heads, the CLI default scales:
    predict over the eval batches, each against float64 (the gcn's float64
    run on the card's keep sets), one train step per bucket (loss finite,
    every trainable parameter moved, frozen parameters and buffers
    bit-identical), predict and train-step times, no kernel launch."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.models.common import set_dropout_generator
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import prepare_eval_batches

    device = torch.device("cuda")
    reset_launches(flash)
    base_args = config_lib.get_arguments(["anchor-based", "--seed",
                                          str(seed)])
    prepared = prepare_eval_batches(records, 4, base_args.bucket_size,
                                    device)
    batches = train_batches(base_args, train_videos, device)
    kw = dict(lambda_reg=base_args.lambda_reg,
              neg_ratio=base_args.neg_sample_ratio,
              inc_ratio=base_args.incomplete_sample_ratio)
    for base in MIXERS:
        args = config_lib.get_arguments(["anchor-based", "--base-model", base,
                                         "--seed", str(seed)])
        model = seeded_model(args, device).eval()
        n_params = sum(p.numel() for p in model.parameters()
                       if p.requires_grad)
        with torch.inference_mode():
            cls = [model.predict(e["tb"]["seq"], e["tb"]["mask"])[0][
                e["tb"]["mask"].repeat_interleave(len(model.scales), dim=1)]
                for e in prepared]
            predict_ms = [cuda_ms(lambda: model.predict(e["tb"]["seq"],
                                                        e["tb"]["mask"]),
                                  iters=3, warmup=1) for e in prepared]
        phases.check(all(bool(((c >= 0) & (c <= 1)).all()) for c in cls),
                     f"{base} ({n_params} parameters): pred_cls in [0, 1] "
                     f"at the real positions of all {len(prepared)} eval "
                     f"batches")
        check_against_f64(model, args, prepared, phases, base,
                          keep_from_card=base == "gcn")

        set_dropout_generator(model, torch.Generator(device).manual_seed(
            seed + 1))
        gen = torch.Generator(device).manual_seed(seed + 2)
        optimizer = steps.make_optimizer(model.parameters(), args.lr,
                                         args.weight_decay)
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        fixed = {n: b.clone() for n, b in model.named_buffers()}
        fixed.update((n, p.detach().clone())
                     for n, p in model.named_parameters()
                     if not p.requires_grad)
        losses = torch.stack([steps.ab_train_step(model, optimizer, b, gen,
                                                  **kw)["loss"]
                              for b in batches]).cpu()
        trainable = [(n, p) for n, p in model.named_parameters()
                     if p.requires_grad]
        moved = sum(not torch.equal(params[n], p) for n, p in trainable)
        state = dict(model.state_dict())
        kept = all(torch.equal(fixed[n], state[n]) for n in fixed)
        want_fixed = {"performer": 1, "lstm": 1, "bilstm": 2}.get(base, 0)
        print(f"    {base}: one step per bucket "
              f"{[int(b['seq'].shape[1]) for b in batches]}, losses "
              f"{[round(float(x), 4) for x in losses]}; buffers and frozen "
              f"parameters {sorted(fixed)}")
        phases.check(bool(torch.isfinite(losses).all()),
                     f"{base}: every train step's loss is finite")
        phases.check(moved == len(trainable),
                     f"{base}: trainable parameters changed "
                     f"({moved}/{len(trainable)})")
        phases.check(kept and len(fixed) == want_fixed,
                     f"{base}: buffers and frozen parameters bit-identical "
                     f"after training {sorted(fixed)}")
        step_ms = cuda_ms(lambda: steps.ab_train_step(
            model, optimizer, batches[-1], gen, **kw), iters=5, warmup=2)
        print(f"  [{smi}] {base}: predict ms per batch "
              f"{[round(t, 3) for t in predict_ms]} (bucket lengths "
              f"{[int(e['tb']['seq'].shape[1]) for e in prepared]}); train "
              f"step at bucket {int(batches[-1]['seq'].shape[1])} "
              f"{step_ms:.3f} ms")
    counts = launch_counts(flash)
    phases.check(not any(counts.values()),
                 f"no kernel of the port launched by the other mixers "
                 f"{counts}")


def step_peak(step) -> Tuple[float, float]:
    """(ms, peak GiB allocated) of one call of ``step`` on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    return ((time.perf_counter() - t0) * 1e3,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def check_step_flags(flash, phases: Phases, records, train_videos,
                     val_videos, seed: int, smi: str) -> None:
    """The train-step flags on the headline (nystromformer, scale 12) and
    on attention, at full width: --compute-dtype bfloat16 (one step per
    bucket: losses finite, masters and Adam moments float32, every
    trainable parameter moved; step ms and peak memory against float32),
    --remat (one step at the largest bucket equal to the plain step's
    updated parameters within 1e-6, peak memories), then the trainer with
    both flags for one epoch, and --matmul-precision tensorfloat32 (TF32
    switches on for the phase and restored after it, the headline's
    pred_cls gap to float64, predict ms).  No kernel launches."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.evaluate import setup
    from edsnet_torch.models.common import set_dropout_generator
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import prepare_eval_batches

    device = torch.device("cuda")
    reset_launches(flash)
    headline = ["--base-model", "nystromformer", "--anchor-scales", "12"]
    for label, flags in (("nystromformer", headline), ("attention", [])):
        args = config_lib.get_arguments(["anchor-based", *flags, "--seed",
                                         str(seed)])
        batches = train_batches(args, train_videos, device)
        kw = dict(lambda_reg=args.lambda_reg,
                  neg_ratio=args.neg_sample_ratio,
                  inc_ratio=args.incomplete_sample_ratio)

        def trained(**flag_kw):
            """A seeded model, its optimizer and its generators."""
            model = seeded_model(args, device)
            set_dropout_generator(model, torch.Generator(device).manual_seed(
                seed + 1))
            gen = torch.Generator(device).manual_seed(seed + 2)
            opt = steps.make_optimizer(model.parameters(), args.lr,
                                       args.weight_decay)
            return model, opt, lambda b: steps.ab_train_step(
                model, opt, b, gen, **kw, **flag_kw)

        times = {}
        for dtype in ("float32", "bfloat16"):
            model, opt, step = trained(compute_dtype=dtype)
            init = {n: p.detach().clone() for n, p in model.named_parameters()}
            losses = torch.stack([step(b)["loss"] for b in batches]).cpu()
            times[dtype] = (cuda_ms(lambda: step(batches[-1]), iters=5,
                                    warmup=2),
                            step_peak(lambda: step(batches[-1]))[1])
            if dtype == "float32":
                continue
            moments = [t for st in opt.state.values()
                       for k, t in st.items() if k.startswith("exp_avg")]
            phases.check(bool(torch.isfinite(losses).all()),
                         f"{label} bfloat16: one step per bucket, losses "
                         f"{[round(float(x), 4) for x in losses]} finite")
            phases.check(all(p.dtype == torch.float32
                             for p in model.parameters())
                         and len(moments) == 2 * len(init)
                         and all(t.dtype == torch.float32 for t in moments),
                         f"{label} bfloat16: master parameters and Adam "
                         f"moments float32 ({len(moments)} moments)")
            moved = sum(not torch.equal(init[n], p)
                        for n, p in model.named_parameters())
            phases.check(moved == len(init),
                         f"{label} bfloat16: parameters changed "
                         f"({moved}/{len(init)})")
        bucket = int(batches[-1]["seq"].shape[1])
        print(f"  [{smi}] {label}: train step at bucket {bucket}, float32 "
              f"{times['float32'][0]:.3f} ms, peak {times['float32'][1]:.3f}"
              f" GiB; bfloat16 {times['bfloat16'][0]:.3f} ms, peak "
              f"{times['bfloat16'][1]:.3f} GiB")

        plain, _, plain_step = trained()
        remat, _, remat_step = trained(remat=True)
        plain_step(batches[-1])
        remat_step(batches[-1])
        gap = max(float((a - b).detach().abs().max()) for a, b in
                  zip(plain.parameters(), remat.parameters()))
        phases.check(gap <= 1e-6, f"{label} --remat: one step's updated "
                                  f"parameters within 1e-6 of the plain "
                                  f"step's ({gap:.3e})")
        remat_peak = {name: (cuda_ms(lambda: fn(batches[-1]), iters=5,
                                     warmup=1),
                             step_peak(lambda: fn(batches[-1]))[1])
                      for name, fn in (("plain", plain_step),
                                       ("--remat", remat_step))}
        print(f"  [{smi}] {label}: train step at bucket {bucket}, " + ", ".join(
            f"{name} {ms:.3f} ms, peak {peak:.3f} GiB"
            for name, (ms, peak) in remat_peak.items()))

    flags_args = config_lib.get_arguments(
        ["anchor-based", *headline, "--seed", str(seed), "--batch-size", "4",
         "--max-epoch", "1", "--compute-dtype", "bfloat16", "--remat"])
    print("  trainer.train_records with --compute-dtype bfloat16 --remat, "
          "1 epoch:")
    check_training(flash, phases, train_videos, val_videos, flags_args,
                   expect_kernels=False)

    tf32_args = config_lib.get_arguments(
        ["anchor-based", *headline, "--seed", str(seed),
         "--matmul-precision", "tensorfloat32"])
    setup(tf32_args)
    try:
        on = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
        model = seeded_model(tf32_args, device).eval()
        prepared = prepare_eval_batches(records, 4, tf32_args.bucket_size,
                                        device)
        cls_errs = f64_errors(model, tf32_args, prepared)[0]
        with torch.inference_mode():
            predict_ms = [cuda_ms(lambda: model.predict(e["tb"]["seq"],
                                                        e["tb"]["mask"]),
                                  iters=5) for e in prepared]
    finally:
        setup(config_lib.get_arguments(["anchor-based"]))
    off = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    print(f"  [{smi}] nystromformer --matmul-precision tensorfloat32: "
          f"pred_cls max abs err vs float64 per eval batch "
          f"{[float(f'{e:.3e}') for e in cls_errs]}; predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]}")
    phases.check(on == (True, True) and off == (False, False),
                 f"TF32 switches (cuBLAS, cuDNN) {on} in the phase, {off} "
                 f"after it")
    counts = launch_counts(flash)
    phases.check(not any(counts.values()),
                 f"no kernel of the port launched by the train-step flags "
                 f"{counts}")


# JAX's init on the CPU at F 1024, 8 heads, hidden 128, fc depth 7
AF_PARAMS = {("attention", "shallow"): 4_344_836,
             ("attention", "deep"): 8_539_140,
             ("attention", "original"): 4_328_324,
             ("nystromformer", "shallow"): 2_248_972,
             ("nystromformer", "deep"): 3_298_704,
             ("nystromformer", "original"): 2_232_460}
AF_LOSSES = (("focal", "soft-iou"), ("focal", "smooth-l1"),
             ("cross-entropy", "soft-iou"), ("cross-entropy", "smooth-l1"))


def check_anchor_free(flash, phases: Phases, records, train_videos,
                      val_videos, seed: int, smi: str
                      ) -> Dict[str, Dict[str, int]]:
    """The anchor-free head at full width (the CLI's defaults: F 1024, 8
    heads, hidden 128, fc depth 7, focal and soft-IoU losses), seeded
    random weights: attention shallow evaluated on the kernel and dense
    routes (per-video F equal, pred_cls within TOL, one forward launch per
    eval batch) and trained 2 epochs through trainer.train_records;
    nystromformer shallow against float64 on every eval batch and one
    step per bucket under each loss pair, deep and original predicting,
    no launch; attention deep and
    original predicting over the eval batches (forward launches per batch:
    two on deep, whose base_model1 runs at head dim 256, one on original;
    pred_cls within TOL of the dense route) with one step per bucket; on
    nystromformer at the largest bucket a bf16 step (finite, float32
    masters and moments) and a remat step bit-equal to the plain one;
    times.  Returns the launch counts of each kernel on each anchor-free
    attention evaluate path (shallow through evaluate_on_device, deep and
    original through predict over the eval batches)."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.models.common import set_dropout_generator
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                                   prepare_eval_batches)

    device = torch.device("cuda")

    def af_args(base, depth="shallow", *extra):
        return config_lib.get_arguments(
            ["anchor-free", "--base-model", base, "--model-depth", depth,
             "--seed", str(seed), *extra])

    def built(args):
        model = seeded_model(args, device).eval()
        n_params = sum(p.numel() for p in model.parameters())
        want = AF_PARAMS[(args.base_model, args.model_depth)]
        phases.check(n_params == want,
                     f"anchor-free {args.base_model} {args.model_depth}: "
                     f"{n_params} parameters (JAX's {want})")
        return model

    def dense_twin(args, model):
        dense = get_model(args.model, **{**vars(args), "use_pallas": False})
        dense = dense.to(device).eval()          # --no-pallas
        dense.load_state_dict(model.state_dict())
        return dense

    def predict_all(model):
        with torch.inference_mode():
            return [model.predict(e["tb"]["seq"], e["tb"]["mask"])
                    for e in prepared]

    def cls_gap(got, want):
        return max(float((g[0] - w[0]).abs()[e["tb"]["mask"]].max())
                   for g, w, e in zip(got, want, prepared))

    def step_fn(args, model, **flags):
        set_dropout_generator(model, torch.Generator(device).manual_seed(
            seed + 1))
        opt = steps.make_optimizer(model.parameters(), args.lr,
                                   args.weight_decay)
        kw = dict(lambda_reg=args.lambda_reg, lambda_ctr=args.lambda_ctr,
                  cls_kind=args.cls_loss, reg_kind=args.reg_loss, **flags)
        return opt, lambda b: steps.af_train_step(model, opt, b, **kw)

    def steps_per_bucket(label, args, model, batches, **flags):
        """One step per bucket: losses finite, trainable parameters moved;
        returns the step function."""
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt, step = step_fn(args, model, **flags)
        metrics = [step(b) for b in batches]
        losses = torch.stack([torch.stack([m[k] for k in sorted(m)])
                              for m in metrics]).cpu()
        moved = sum(not torch.equal(init[n], p)
                    for n, p in model.named_parameters())
        print(f"    {label}: one step per bucket "
              f"{[int(b['seq'].shape[1]) for b in batches]}, "
              f"{sorted(metrics[0])} "
              f"{[[round(float(v), 4) for v in row] for row in losses]}")
        phases.check(bool(torch.isfinite(losses).all()),
                     f"{label}: every step's losses finite")
        phases.check(moved == len(init),
                     f"{label}: parameters changed ({moved}/{len(init)})")
        return step

    # attention, shallow: the CLI default, the forward kernel in evaluation
    args = af_args("attention")
    prepared = prepare_eval_batches(records, 4, args.bucket_size, device)
    batches = train_batches(args, train_videos, device)  # labels: any base
    big = batches[-1]
    bucket = int(big["seq"].shape[1])
    model = built(args)
    evaluate_on_device(model, records[:1], args.nms_thresh, batch_size=4,
                       bucket_size=args.bucket_size)
    torch.cuda.synchronize()
    reset_launches(flash)
    per_video = []
    t0 = time.perf_counter()
    mean_f, mean_div = evaluate_on_device(
        model, records, args.nms_thresh, batch_size=4,
        bucket_size=args.bucket_size, per_video=per_video)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts(flash)
    launched = {"shallow": counts}
    print(f"  attention shallow: mean F {mean_f:.6f}, mean diversity "
          f"{mean_div:.6f}; F per video "
          f"{[round(p['fscore'], 6) for p in per_video]}")
    phases.check(counts == {"flash_attention_fwd": len(prepared),
                            "flash_attention_dq": 0,
                            "flash_attention_dkv": 0},
                 f"anchor-free attention evaluate: launches {counts}, one "
                 f"forward per eval batch ({len(prepared)})")
    phases.check(len(per_video) == len(records)
                 and all(0.0 <= p["fscore"] <= 1.0 for p in per_video),
                 "anchor-free attention: every F in [0, 1]")
    dense = dense_twin(args, model)
    dense_videos = []
    evaluate_on_device(dense, records, args.nms_thresh, prepared=prepared,
                       per_video=dense_videos)
    same_f = [a["fscore"] == b["fscore"] for a, b in zip(per_video,
                                                         dense_videos)]
    phases.check(all(same_f), f"anchor-free attention: per-video F equal "
                              f"on kernel and dense routes "
                              f"({sum(same_f)}/{len(same_f)})")
    err = cls_gap(predict_all(model), predict_all(dense))
    phases.check(err <= TOL, f"anchor-free attention: pred_cls kernel vs "
                             f"dense route max abs err {err:.3e}")
    with torch.inference_mode():
        predict_ms = [cuda_ms(lambda: model.predict(e["tb"]["seq"],
                                                    e["tb"]["mask"]),
                              iters=5) for e in prepared]
    batch_ms, nms_ms, n_boxes = eval_batch_breakdown(model, prepared[-1],
                                                     args.nms_thresh)
    print("  attention shallow: trainer.train_records, 2 epochs:")
    check_training(flash, phases, train_videos, val_videos,
                   af_args("attention", "shallow", "--batch-size", "4",
                           "--max-epoch", "2"))
    _, att_step = step_fn(args, seeded_model(args, device))
    att_step_ms = {int(b["seq"].shape[1]): cuda_ms(lambda: att_step(b),
                                                   iters=5, warmup=2)
                   for b in batches}

    # nystromformer, shallow: no kernel; float64, the four loss pairs
    ny_args = af_args("nystromformer")
    reset_launches(flash)
    ny = built(ny_args)
    check_against_f64(ny, ny_args, prepared, phases,
                      "anchor-free nystromformer")
    with torch.inference_mode():
        ny_predict_ms = [cuda_ms(lambda: ny.predict(e["tb"]["seq"],
                                                    e["tb"]["mask"]),
                                 iters=5) for e in prepared]
    ny_batch_ms, ny_nms_ms, ny_boxes = eval_batch_breakdown(
        ny, prepared[-1], ny_args.nms_thresh)
    step = None
    for cls_kind, reg_kind in AF_LOSSES:
        pair_args = af_args("nystromformer", "shallow", "--cls-loss",
                            cls_kind, "--reg-loss", reg_kind)
        pair_step = steps_per_bucket(
            f"nystromformer {cls_kind} + {reg_kind}", pair_args,
            seeded_model(pair_args, device), batches)
        step = step or pair_step        # the CLI's pair, timed below
    ny_step_ms = {int(b["seq"].shape[1]): cuda_ms(lambda: step(b), iters=5,
                                                  warmup=2)
                  for b in batches}
    ny_wall_ms, ny_busy_ms = device_busy_ms(lambda: [step(b)
                                                     for b in batches])

    def flagged(**flags):
        model = seeded_model(ny_args, device)
        return (model,) + step_fn(ny_args, model, **flags)

    for depth in ("deep", "original"):
        got = predict_all(built(af_args("nystromformer", depth)))
        phases.check(all(bool(((c >= 0) & (c <= 1)).all()) for c, _ in got),
                     f"anchor-free nystromformer {depth}: pred_cls in "
                     f"[0, 1] over the eval batches")
    bf16, bf16_opt, bf16_step = flagged(compute_dtype="bfloat16")
    bf16_losses = torch.stack(list(bf16_step(big).values())).cpu()
    moments = [t for st in bf16_opt.state.values() for k, t in st.items()
               if k.startswith("exp_avg")]
    phases.check(bool(torch.isfinite(bf16_losses).all()),
                 f"anchor-free nystromformer bfloat16 step at bucket "
                 f"{bucket}: losses "
                 f"{[round(float(v), 4) for v in bf16_losses]} finite")
    phases.check(all(p.dtype == torch.float32 for p in bf16.parameters())
                 and len(moments) == 2 * len(list(bf16.parameters()))
                 and all(t.dtype == torch.float32 for t in moments),
                 "anchor-free nystromformer bfloat16: master parameters "
                 "and Adam moments float32")
    plain, _, plain_step = flagged()
    remat, _, remat_step = flagged(remat=True)
    plain_step(big)
    remat_step(big)
    same = all(torch.equal(a, b) for a, b in zip(plain.parameters(),
                                                 remat.parameters()))
    gap = max(float((a - b).detach().abs().max())
              for a, b in zip(plain.parameters(), remat.parameters()))
    phases.check(same, f"anchor-free nystromformer --remat: updated "
                       f"parameters bit-equal to the plain step's (max gap "
                       f"{gap:.3e})")
    flag_ms = {name: cuda_ms(lambda: fn(big), iters=5, warmup=1)
               for name, fn in (("float32", plain_step),
                                ("bfloat16", bf16_step),
                                ("--remat", remat_step))}
    counts = launch_counts(flash)
    phases.check(not any(counts.values()),
                 f"no kernel launched on the anchor-free nystromformer path "
                 f"{counts}")

    # attention, deep and original: per eval batch, deep launches the
    # forward for base_model1 (4 heads, head dim 256: the cluster kernel)
    # and base_model2 (8 heads, 128), original for its one backbone
    depth_ms = {}
    for depth, dims in (("deep", (256, 128)), ("original", (128,))):
        per_batch = len(dims)
        d_args = af_args("attention", depth)
        d_model = built(d_args)
        reset_launches(flash)
        got = predict_all(d_model)
        counts = launch_counts(flash)
        by_dim = dict(flash.flash_attention_fwd.launches_by_head_dim)
        launched[depth] = {**counts, "by_head_dim": by_dim}
        phases.check(by_dim == {d: len(prepared) for d in dims},
                     f"anchor-free attention {depth} predict: forward "
                     f"launches by head dim {by_dim}")
        err = cls_gap(got, predict_all(dense_twin(d_args, d_model)))
        finite = all(bool(torch.isfinite(c[e["tb"]["mask"]]).all()
                          and ((c >= 0) & (c <= 1)).all())
                     for (c, _), e in zip(got, prepared))
        phases.check(counts == {"flash_attention_fwd":
                                per_batch * len(prepared),
                                "flash_attention_dq": 0,
                                "flash_attention_dkv": 0},
                     f"anchor-free attention {depth} predict: launches "
                     f"{counts}, {per_batch} forward per eval batch")
        phases.check(finite and err <= TOL,
                     f"anchor-free attention {depth}: pred_cls in [0, 1], "
                     f"within {TOL:g} of the dense route ({err:.3e})")
        with torch.inference_mode():
            p_ms = cuda_ms(lambda: d_model.predict(
                prepared[-1]["tb"]["seq"], prepared[-1]["tb"]["mask"]),
                iters=5)
        d_step = steps_per_bucket(f"attention {depth}", d_args, d_model,
                                  batches)
        depth_ms[depth] = (p_ms, cuda_ms(lambda: d_step(big), iters=5,
                                         warmup=1))

    buckets = [int(e["tb"]["seq"].shape[1]) for e in prepared]
    print(f"  [{smi}] anchor-free attention shallow: predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]} (bucket lengths {buckets}); "
          f"eval of {len(records)} videos {eval_ms:.1f} ms; train step ms "
          f"per bucket { {k: round(v, 3) for k, v in att_step_ms.items()} }")
    print_breakdown(smi, "anchor-free attention", prepared[-1], batch_ms,
                    predict_ms[-1], nms_ms, n_boxes)
    print(f"  [{smi}] anchor-free nystromformer: predict ms per batch "
          f"{[round(t, 3) for t in ny_predict_ms]}; train step ms per "
          f"bucket { {k: round(v, 3) for k, v in ny_step_ms.items()} }; at "
          f"bucket {bucket}: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in flag_ms.items()))
    busy = (f"{ny_busy_ms:.3f} ms of CUDA kernels in {ny_wall_ms:.3f} ms, "
            f"busy {100 * ny_busy_ms / ny_wall_ms:.1f} %" if ny_busy_ms > 0
            else "device time not measured (the profiler saw no kernels)")
    print(f"  [{smi}] anchor-free nystromformer: one epoch of "
          f"{len(batches)} steps under torch.profiler: {busy}")
    print_breakdown(smi, "anchor-free nystromformer", prepared[-1],
                    ny_batch_ms, ny_predict_ms[-1], ny_nms_ms, ny_boxes)
    for depth, (p_ms, s_ms) in depth_ms.items():
        print(f"  [{smi}] anchor-free attention {depth}: predict at bucket "
              f"{buckets[-1]} {p_ms:.3f} ms; train step at bucket {bucket} "
              f"{s_ms:.3f} ms")
    return launched


LG = "local-global-attention"
# JAX's counts (jax.eval_shape of edsnet_tpu's get_model) at F 1024, 8
# heads, hidden 128, fc depth 7, --attention-depth 2; and the forward
# launches per eval batch: original 1, deep 2 (base_model1 twice, shared),
# local-global 5 (the global attention at head dim 128, four local ones at
# 512)
HEAD_CASES = {("anchor-based", "original"): (4_328_195, 1),
              ("anchor-based", "deep"): (4_342_659, 2),
              ("anchor-based", LG): (23_221_123, 5),
              ("anchor-free", LG): (23_221_252, 5)}
POOLING_PARAMS = {"fft": 2_445_579, "dwt": 2_347_275,
                  "flat-pooling": 2_445_579}   # nystromformer, scale 12


def check_heads_and_poolings(flash, phases: Phases, records, train_videos,
                             seed: int, smi: str) -> Dict[str, dict]:
    """Phase 12 at full width (F 1024, 8 heads, hidden 128, fc depth 7,
    seeded random weights, the 8 videos):
    - the attention heads, anchor-based original, deep and local-global and
      anchor-free local-global: JAX's parameter counts; an evaluation of
      the 8 videos on the kernel route (forward launches per evaluation:
      7, 14, 35, 35, local-global's 28 at head dim 512) and on the dense
      route with the same per-video F; the kernel route's pred_cls within
      1e-4 of float64 on the CPU on every eval batch, kernel vs dense
      printed; a train step per bucket with finite losses; the evaluated
      weights saved, reloaded and reproducing the evaluation's F;
    - --use-pallas on anchor-based local-global and on shallow --num-head
      2: runs and launches the head-dim-512 instance;
    - nystromformer at scale 12 with fft, dwt and flat-pooling: JAX's
      parameter counts, pred_cls within 1e-4 of float64 on the CPU on
      every eval batch, predict ms at bucket 2304, a step per bucket, a
      bf16 step and a remat step bit-equal to the plain step; no kernel.
    The TF32 switches are set as evaluate.setup sets them (off, the
    default --matmul-precision): windowed_linear's product is cuBLAS's.
    Returns, per evaluated head, the launch counts and the forward's by
    head dim."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.evaluate import setup
    from edsnet_torch.models.common import set_dropout_generator
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import (_num_scales_of,
                                                   evaluate_on_device,
                                                   prepare_eval_batches)
    from edsnet_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    device = torch.device("cuda")
    base_args = config_lib.get_arguments(["anchor-based", "--seed",
                                          str(seed)])
    setup(base_args)
    prepared = prepare_eval_batches(records, 4, base_args.bucket_size,
                                    device)
    largest = prepared[-1]["tb"]

    def cli(*flags):
        return config_lib.get_arguments([*flags, "--seed", str(seed)])

    def real_of(model, tb):
        return tb["mask"].repeat_interleave(_num_scales_of(model), dim=1)

    def predict_all(model):
        with torch.inference_mode():
            return [model.predict(e["tb"]["seq"], e["tb"]["mask"])[0]
                    for e in prepared]

    def cls_gap(model, got, want):
        return max(float((g - w).abs()[real_of(model, e["tb"])].max())
                   for g, w, e in zip(got, want, prepared))

    def step_fn(args, model, **flags):
        set_dropout_generator(model, torch.Generator(device).manual_seed(
            seed + 1))
        opt = steps.make_optimizer(model.parameters(), args.lr,
                                   args.weight_decay)
        if args.model == "anchor-free":
            kw = dict(lambda_reg=args.lambda_reg, lambda_ctr=args.lambda_ctr,
                      cls_kind=args.cls_loss, reg_kind=args.reg_loss)
            return lambda b: steps.af_train_step(model, opt, b, **kw, **flags)
        gen = torch.Generator(device).manual_seed(seed + 2)
        kw = dict(lambda_reg=args.lambda_reg, neg_ratio=args.neg_sample_ratio,
                  inc_ratio=args.incomplete_sample_ratio)
        return lambda b: steps.ab_train_step(model, opt, b, gen, **kw, **flags)

    def steps_per_bucket(label, args, model, batches):
        step = step_fn(args, model)
        losses = torch.stack([step(b)["loss"] for b in batches]).cpu()
        print(f"    {label}: one step per bucket "
              f"{[int(b['seq'].shape[1]) for b in batches]}, losses "
              f"{[round(float(x), 4) for x in losses]}")
        phases.check(bool(torch.isfinite(losses).all()),
                     f"{label}: every step's loss finite")
        return cuda_ms(lambda: step(batches[-1]), iters=3, warmup=1)

    launched = {}
    for (model_type, depth), (want_params, per_batch) in HEAD_CASES.items():
        label = f"{model_type} attention {depth}"
        args = cli(model_type, "--model-depth", depth)
        model = seeded_model(args, device).eval()
        n_params = sum(p.numel() for p in model.parameters())
        phases.check(n_params == want_params,
                     f"{label}: {n_params} parameters (JAX's {want_params})")
        evaluate_on_device(model, records[:1], args.nms_thresh, batch_size=4,
                           bucket_size=args.bucket_size)
        torch.cuda.synchronize()
        reset_launches(flash)
        per_video = []
        t0 = time.perf_counter()
        mean_f, _ = evaluate_on_device(model, records, args.nms_thresh,
                                       prepared=prepared, per_video=per_video)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts(flash)
        by_dim = dict(flash.flash_attention_fwd.launches_by_head_dim)
        launched[label] = {"counts": counts, "by_head_dim": by_dim}
        n_batches = len(prepared)
        want_dims = ({128: n_batches, 512: 4 * n_batches} if depth == LG
                     else {128: per_batch * n_batches})
        print(f"  {label}: mean F {mean_f:.6f}; F per video "
              f"{[round(p['fscore'], 6) for p in per_video]}; launches "
              f"{counts}, forward by head dim {by_dim}")
        phases.check(counts == {"flash_attention_fwd": per_batch * n_batches,
                                "flash_attention_dq": 0,
                                "flash_attention_dkv": 0}
                     and by_dim == want_dims,
                     f"{label} evaluate: {counts['flash_attention_fwd']} "
                     f"forward launches ({per_batch} per eval batch), by "
                     f"head dim {by_dim}")
        phases.check(len(per_video) == len(records)
                     and all(0.0 <= p["fscore"] <= 1.0 for p in per_video),
                     f"{label}: every F in [0, 1]")
        dense = get_model(args.model, **{**vars(args), "use_pallas": False})
        dense = dense.to(device).eval()               # --no-pallas
        dense.load_state_dict(model.state_dict())
        dense_videos = []
        evaluate_on_device(dense, records, args.nms_thresh, prepared=prepared,
                           per_video=dense_videos)
        same_f = [a["fscore"] == b["fscore"] for a, b in zip(per_video,
                                                             dense_videos)]
        phases.check(all(same_f), f"{label}: per-video F equal on kernel and "
                                  f"dense routes ({sum(same_f)}/"
                                  f"{len(same_f)})")
        # the kernel route held to float64; kernel vs dense only printed:
        # on these heads each route sits up to ~6e-5 from float64, so two
        # f32-level routes can differ by more than 1e-4
        err = cls_gap(model, predict_all(model), predict_all(dense))
        print(f"  [{smi}] {label}: pred_cls kernel vs dense route max abs "
              f"err {err:.3e}")
        check_against_f64(model, args, prepared, phases,
                          f"{label} (kernel route)")
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(model, f"{tmp}/model.pt")
            fresh = get_model(args.model, **vars(args))
            load_checkpoint(fresh, f"{tmp}/model.pt")
        reloaded_f, _ = evaluate_on_device(fresh.to(device).eval(), records,
                                           args.nms_thresh, prepared=prepared)
        phases.check(abs(reloaded_f - mean_f) <= 1e-6,
                     f"{label}: saved and reloaded weights give F "
                     f"{reloaded_f:.7f} == {mean_f:.7f}")
        with torch.inference_mode():
            predict_ms = cuda_ms(lambda: model.predict(largest["seq"],
                                                       largest["mask"]),
                                 iters=5)
        batches = train_batches(args, train_videos, device)
        reset_launches(flash)
        step_ms = steps_per_bucket(label, args, model, batches)
        phases.check(not any(launch_counts(flash).values()),
                     f"{label}: no kernel launched in its train steps")
        print(f"  [{smi}] {label}: eval of {len(records)} videos "
              f"{eval_ms:.1f} ms; predict at bucket "
              f"{int(largest['seq'].shape[1])} {predict_ms:.3f} ms; train "
              f"step at bucket {int(batches[-1]['seq'].shape[1])} "
              f"{step_ms:.3f} ms")
        del model, dense, fresh
        torch.cuda.empty_cache()

    # --use-pallas at head dim 512: local-global's local attentions, and
    # the shallow head with 2 heads (its one attention at 512)
    for label, flags, want in (
            ("anchor-based local-global --use-pallas",
             ["--model-depth", LG], {128: 1, 512: 4}),
            ("anchor-based shallow --num-head 2 --use-pallas",
             ["--num-head", "2"], {512: 1})):
        args = cli("anchor-based", *flags, "--use-pallas")
        model = seeded_model(args, device).eval()
        dense = get_model(args.model, **{**vars(args), "use_pallas": False})
        dense = dense.to(device).eval()
        dense.load_state_dict(model.state_dict())
        reset_launches(flash)
        with torch.inference_mode():
            got = model.predict(largest["seq"], largest["mask"])[0]
            by_dim = dict(flash.flash_attention_fwd.launches_by_head_dim)
            want_cls = dense.predict(largest["seq"], largest["mask"])[0]
        err = float((got - want_cls).abs()[real_of(model, largest)].max())
        print(f"  [{smi}] {label}: predict at bucket "
              f"{int(largest['seq'].shape[1])}, forward by head dim {by_dim}; "
              f"pred_cls vs dense route (one TF32 pass) {err:.3e}")
        phases.check(by_dim == want and bool(torch.isfinite(got).all())
                     and err <= TOL_DEFAULT,
                     f"{label}: the head-dim-512 forward launched {by_dim}, "
                     f"pred_cls within {TOL_DEFAULT:g} of the dense route")
        del model, dense

    # the paper's poolings on the headline backbone, scale 12
    reset_launches(flash)
    for pooling, want_params in POOLING_PARAMS.items():
        label = f"nystromformer {pooling} scale 12"
        args = cli("anchor-based", "--base-model", "nystromformer",
                   "--anchor-scales", "12", "--pooling-type", pooling)
        setup(args)
        model = seeded_model(args, device).eval()
        n_params = sum(p.numel() for p in model.parameters())
        phases.check(n_params == want_params,
                     f"{label}: {n_params} parameters (JAX's {want_params})")
        check_against_f64(model, args, prepared, phases, label)
        with torch.inference_mode():
            predict_ms = cuda_ms(lambda: model.predict(largest["seq"],
                                                       largest["mask"]),
                                 iters=5)
        batches = train_batches(args, train_videos, device)
        step_ms = steps_per_bucket(label, args, model, batches)
        big = batches[-1]
        bf16 = seeded_model(args, device)
        bf16_losses = step_fn(args, bf16, compute_dtype="bfloat16")(big)
        bf16_losses = torch.stack(list(bf16_losses.values())).cpu()
        phases.check(bool(torch.isfinite(bf16_losses).all())
                     and all(p.dtype == torch.float32
                             for p in bf16.parameters()),
                     f"{label} bfloat16 step at bucket "
                     f"{int(big['seq'].shape[1])}: losses "
                     f"{[round(float(v), 4) for v in bf16_losses]} finite, "
                     f"masters float32")
        plain, remat = seeded_model(args, device), seeded_model(args, device)
        step_fn(args, plain)(big)
        step_fn(args, remat, remat=True)(big)
        gap = max(float((a - b).detach().abs().max())
                  for a, b in zip(plain.parameters(), remat.parameters()))
        phases.check(all(torch.equal(a, b) for a, b in
                         zip(plain.parameters(), remat.parameters())),
                     f"{label} --remat: updated parameters bit-equal to the "
                     f"plain step's (max gap {gap:.3e})")
        print(f"  [{smi}] {label}: predict at bucket "
              f"{int(largest['seq'].shape[1])} {predict_ms:.3f} ms; train "
              f"step at bucket {int(big['seq'].shape[1])} {step_ms:.3f} ms")
        del model, bf16, plain, remat
    counts = launch_counts(flash)
    phases.check(not any(counts.values()),
                 f"no kernel launched on the pooling paths {counts}")
    return launched


def _audit_worker(batches):
    """The knapsack audit over host-side predictions, in a child process:
    the native branch and bound can take exponential time on tied shot
    densities, and a child can be stopped."""
    from edsnet_torch.evaluate import KnapsackAudit, summarize_host

    audit = KnapsackAudit()
    t0 = time.perf_counter()
    summarize_host(batches, knapsack_audit=audit)
    return audit.n_videos, audit.report(), time.perf_counter() - t0


def snapshot_gap(a: Dict, b: Dict) -> float:
    """Largest parameter difference of two train-state snapshots."""
    return max(float((a["model"][k].double() - b["model"][k].double())
                     .abs().max()) for k in a["model"])


def nondeterministic_ops(args, train_videos, val_videos) -> list:
    """The ops that torch names as nondeterministic in one epoch of this
    training path (torch.use_deterministic_algorithms, warn only)."""
    import warnings

    from edsnet_torch import trainer

    one = config_args(args, max_epoch=1, resume=False, state_save_every=0)
    with tempfile.TemporaryDirectory() as tmp, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_records(one, train_videos, val_videos,
                                  f"{tmp}/x.pt")
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def config_args(args, **changes):
    """A copy of parsed CLI arguments with some fields changed."""
    out = argparse.Namespace(**vars(args))
    for k, v in changes.items():
        setattr(out, k, v)
    return out


def check_host_side(flash, phases: Phases, records, train_videos,
                    val_videos, seed: int, smi: str) -> None:
    """Phase 13, the host side at full width: the native library built from
    the port's source, the host evaluator (--host-eval) against the device
    evaluator on attention and the headline, the knapsack audit, resume
    against an uninterrupted run, training under --host-eval and
    --profile, and KTS on the card against the float64 host route."""
    import logging

    from edsnet_torch import config as config_lib
    from edsnet_torch import native, trainer
    from edsnet_torch.evaluate import (evaluate, predict_batches,
                                       summarize_host)
    from edsnet_torch.ops import kts
    from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                                   prepare_eval_batches)

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    lib = native.load()
    phases.check(lib is not None and lib.path.parent == native.BUILD_DIR
                 and native.SOURCE.parent == native.SRC_DIR,
                 f"native library built from {native.SOURCE.relative_to(REPO)}"
                 f" into {lib.path.relative_to(REPO) if lib else None} "
                 f"({(time.perf_counter() - t0) * 1e3:.0f} ms) and loaded")

    heads = {
        "attention": ["anchor-based", "--seed", str(seed)],
        "nystromformer": ["anchor-based", "--base-model", "nystromformer",
                          "--anchor-scales", "12", "--seed", str(seed)]}
    audit_batches = None
    for label, flags in heads.items():
        args = config_lib.get_arguments(flags)
        model = seeded_model(args, device).eval()
        prepared = prepare_eval_batches(records, 4, args.bucket_size, device)
        evaluate(model, records[:1], args.nms_thresh)          # warm-up
        device_videos, host_videos = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate_on_device(model, records, args.nms_thresh,
                           prepared=prepared, per_video=device_videos)
        device_ms = (time.perf_counter() - t0) * 1e3
        reset_launches(flash)
        evaluate(model, records, args.nms_thresh, prepared=prepared,
                 per_video=host_videos)
        launches = launch_counts(flash)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = predict_batches(model, prepared, args.nms_thresh)
        predict_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        summarize_host(batches)
        summ_ms = (time.perf_counter() - t0) * 1e3
        gaps = [abs(h["fscore"] - d["fscore"])
                for h, d in zip(host_videos, device_videos)]
        print(f"  {label}: host F per video "
              f"{[round(h['fscore'], 6) for h in host_videos]}")
        phases.check(len(host_videos) == len(records) and max(gaps) <= 1e-6,
                     f"{label} --host-eval: per-video F equal to the device "
                     f"evaluator's (max gap {max(gaps):.2e})")
        want = len(prepared) if label == "attention" else 0
        phases.check(launches["flash_attention_fwd"] == want
                     and launches["flash_attention_dq"] == 0
                     and launches["flash_attention_dkv"] == 0,
                     f"{label} --host-eval: forward launches "
                     f"{launches['flash_attention_fwd']} == {want}")
        print(f"  [{smi}] {label}: evaluation of {len(records)} videos, "
              f"device evaluator {device_ms:.1f} ms; host evaluator "
              f"{predict_ms + summ_ms:.1f} ms = predict+NMS on the card "
              f"{predict_ms:.1f} ms + host summaries (rasterise, knapsack, "
              f"F) {summ_ms:.1f} ms")
        if label == "attention":
            audit_batches = batches

    # the audit in a child process, stopped if the branch and bound runs
    # past its budget
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        n_audited, report, audit_s = pool.apply_async(
            _audit_worker, (audit_batches,)).get(timeout=AUDIT_BUDGET_S)
        print(f"  attention: {report} ({audit_s:.2f} s)")
        phases.check(n_audited == len(records),
                     f"knapsack audit over {n_audited} videos")
    except multiprocessing.TimeoutError:
        phases.check(False, f"knapsack audit finished within "
                            f"{AUDIT_BUDGET_S} s")
    finally:
        pool.terminate()
        pool.join()

    # resume: 1 epoch, then a resume to 2, against 2 uninterrupted epochs
    for label, flags in heads.items():
        base = config_lib.get_arguments(flags + [
            "--batch-size", "4", "--resume", "--state-save-every", "1"])
        with tempfile.TemporaryDirectory() as tmp:
            runs = {}
            for name, epochs in (("a", 2), ("b", 1), ("b", 2)):
                args = config_args(base, max_epoch=epochs,
                                   model_dir=f"{tmp}/{name}")
                t0 = time.perf_counter()
                runs[name] = trainer.train_records(
                    args, train_videos, val_videos, f"{tmp}/{name}.pt")
                run_ms = (time.perf_counter() - t0) * 1e3
            states = {n: torch.load(f"{tmp}/{n}.pt.state",
                                    map_location="cpu", weights_only=True)
                      for n in ("a", "b")}
            size_mb = Path(f"{tmp}/a.pt.state").stat().st_size / 2 ** 20
            gap = snapshot_gap(states["a"], states["b"])
            same_f = states["a"]["best_fscore"] == states["b"]["best_fscore"]
            print(f"  {label}: .state file {size_mb:.2f} MiB; resumed epoch "
                  f"2 in {run_ms:.0f} ms; best F {states['a']['best_fscore']}"
                  f" / {states['b']['best_fscore']}; parameter gap {gap:.3e}")
            if gap == 0.0 and same_f:
                phases.check(True, f"{label}: 1 epoch + --resume to 2 equals "
                                   f"2 uninterrupted epochs bit for bit")
            else:
                runs["c"] = trainer.train_records(
                    config_args(base, max_epoch=2, model_dir=f"{tmp}/c"),
                    train_videos, val_videos, f"{tmp}/c.pt")
                state_c = torch.load(f"{tmp}/c.pt.state", map_location="cpu",
                                     weights_only=True)
                floor = snapshot_gap(states["a"], state_c)
                ops = nondeterministic_ops(base, train_videos, val_videos)
                print(f"  {label}: two uninterrupted runs differ by "
                      f"{floor:.3e}; nondeterministic ops {ops}")
                phases.check(bool(ops) and gap <= floor,
                             f"{label}: resume gap {gap:.3e} <= the gap of "
                             f"two uninterrupted runs {floor:.3e}, named "
                             f"{ops}")
            if label == "attention":
                device_f1 = runs["a"][1]

    # --host-eval training, against the device path's F list (run a)
    args = config_lib.get_arguments(heads["attention"] + [
        "--batch-size", "4", "--max-epoch", "2", "--host-eval"])
    with tempfile.TemporaryDirectory() as tmp:
        _, host_f1, _ = trainer.train_records(args, train_videos, val_videos,
                                              f"{tmp}/h.pt")
    phases.check(len(host_f1) == len(device_f1) and all(
        abs(h - d) <= 1e-6 for h, d in zip(host_f1, device_f1)),
        f"attention --host-eval training: F per epoch {host_f1} == the "
        f"device path's {device_f1}")

    # --profile: a trace of epoch 1 with CUDA kernel events, fenced steps
    args = config_lib.get_arguments(heads["nystromformer"] + [
        "--batch-size", "4", "--max-epoch", "2", "--profile"])
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    root = logging.getLogger()
    root.addHandler(handler)
    old_level = root.level
    root.setLevel(logging.INFO)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            args.model_dir = tmp
            trainer.train_records(args, train_videos, val_videos,
                                  f"{tmp}/p.pt")
            traces = list(Path(tmp, "profile").glob("trace_*.json"))
            events = (json.loads(traces[0].read_text())["traceEvents"]
                      if traces else [])
    finally:
        root.removeHandler(handler)
        root.setLevel(old_level)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    top = [m for m in messages if "top device ops" in m]
    throughput = [m for m in messages if m.startswith("train throughput")]
    phases.check(len(traces) == 1 and len(kernels) > 0,
                 f"--profile: {len(traces)} trace with {len(kernels)} CUDA "
                 f"kernel events")
    print(f"  [{smi}] nystromformer --profile: {top[-1] if top else top}")
    print(f"  [{smi}] nystromformer --profile, fenced steps: "
          f"{throughput[-1] if throughput else throughput}")

    # KTS on the 8 videos' unit features: the card against the float64 host
    kts.cpd_auto_device(records[0].seq @ records[0].seq.T,
                        records[0].seq.shape[0] - 1, 1, device=device)
    before = (kts.cpd_auto_device.device_calls, kts.cpd_auto_device.fallbacks)
    host_ms, dev_ms, equal = [], [], []
    for r in records:
        n = r.seq.shape[0]
        K = r.seq @ r.seq.T
        t0 = time.perf_counter()
        host_cps, _ = kts.cpd_auto(K, n - 1, 1)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_cps, _ = kts.cpd_auto_device(K, n - 1, 1, device=device)
        dev_ms.append((time.perf_counter() - t0) * 1e3)
        equal.append(np.array_equal(host_cps, dev_cps))
    routes = (kts.cpd_auto_device.device_calls - before[0],
              kts.cpd_auto_device.fallbacks - before[1])
    print(f"  [{smi}] KTS ms per video (n {[r.seq.shape[0] for r in records]})"
          f": native float64 host {[round(t, 1) for t in host_ms]}, card "
          f"{[round(t, 1) for t in dev_ms]}")
    phases.check(all(equal) and routes == (len(records), 0),
                 f"KTS: card change points equal the host's on "
                 f"{sum(equal)}/{len(records)} videos; (device calls, "
                 f"fallbacks) {routes}")
    big = (records[0].seq * 100.0) @ (records[0].seq * 100.0).T
    n = big.shape[0]
    got, _ = kts.cpd_auto_device(big, n - 1, 1, device=device)
    fell = kts.cpd_auto_device.fallbacks - before[1]
    phases.check(fell == 1 and np.array_equal(got, kts.cpd_auto(
        big, n - 1, 1)[0]), f"KTS: the unnormalised case took the float64 "
                            f"fallback ({fell} counted)")
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")


# JAX's counts (python -m edsnet_tpu.model_info anchor-based --model-depth
# cross-attention --base-model attention [--encoder-type local-global]) at
# the CLI's defaults: F 1024, 8 heads, hidden 128, scales 4 8 16 32,
# --attention-depth 2, motion width F
MOTION_PARAMS = {"classic": 26_398_595, "local-global": 44_227_459}
MOTION_WIDTHS = (1024, 512)


def motion_records(records, width: int, seed: int):
    """The videos with synthetic motion features of ``width``, one
    unit-norm row per position."""
    rng = np.random.RandomState(seed + width)
    out = []
    for r in records:
        m = rng.randn(r.seq.shape[0], width).astype(np.float32)
        out.append(r._replace(
            motion_features=m / np.linalg.norm(m, axis=-1, keepdims=True)))
    return out


def seeded_motion_model(args, width: int, device: torch.device):
    """``seeded_model`` of the motion head built at motion width
    ``width``, as the trainer builds it for its data."""
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model

    model = get_model(args.model, **{**vars(args), "motion_width": width})
    init_weights(model, torch.Generator().manual_seed(args.seed))
    return model.to(device)


def check_motion(flash, phases: Phases, records, seed: int,
                 smi: str) -> Dict[str, dict]:
    """Phase 14, the motion head (--model-depth cross-attention) at full
    width: F 1024, 8 heads, hidden 128, scales 4 8 16 32, --attention-depth
    2, seeded random weights, the 8 videos with synthetic motion features
    of widths 1024 and 512.
    - both encoder types: JAX's parameter counts at motion width 1024; the
      8 videos evaluated on the kernel route (forward launches per
      evaluation 7 on classic, 35 on local-global, 28 of them at head dim
      512) and on the dense route with the same per-video F; pred_cls
      within 1e-4 of float64 on every eval batch (classic also at motion
      width 512); the host evaluator (--host-eval) per-video F within 1e-6
      of the device evaluator's; predict ms per batch, evaluation ms and
      peak memory;
    - classic at motion width 512: 2 epochs through trainer.train_records
      (phase 4's checks), the best checkpoint through
      evaluate.eval_checkpoint (evaluate.main's path after the h5 read;
      the videos are in memory, so h5py need not be installed) reproducing
      the best F on the device and the host evaluator, and raising
      "expects width 512" on the width-1024 videos; a step per bucket at f32, at bf16 (float32 masters) and with
      --remat (updated parameters within 1e-6 of the plain step's), step
      ms and peak memory at the largest bucket;
    - --matmul-precision bfloat16 and default: bit-equal pred_cls on the
      headline (nystromformer, scale 12), printed with its gap to float64.
    Returns, per encoder type, the launch counts of its evaluation."""
    from edsnet_torch import config as config_lib
    from edsnet_torch.evaluate import eval_checkpoint, evaluate, setup
    from edsnet_torch.models.common import set_dropout_generator
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel import steps
    from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                                   prepare_eval_batches)

    t_phase = time.perf_counter()
    device = torch.device("cuda")

    def cli(*flags):
        return config_lib.get_arguments(["anchor-based", "--model-depth",
                                         "cross-attention", *flags,
                                         "--seed", str(seed)])

    bucket = cli().bucket_size
    videos = {w: motion_records(records, w, seed) for w in MOTION_WIDTHS}
    prepared = {w: prepare_eval_batches(videos[w], 4, bucket, device,
                                        need_motion=True)
                for w in MOTION_WIDTHS}
    largest = prepared[1024][-1]["tb"]
    print(f"  motion rows per eval batch "
          f"{[int(e['tb']['motion'].shape[1]) for e in prepared[1024]]}")

    def real_of(tb):
        return tb["mask"].repeat_interleave(4, dim=1)

    def predict_all(model, width):
        with torch.inference_mode():
            return [model.predict(*model_inputs(e["tb"]))[0]
                    for e in prepared[width]]

    launched = {}
    for encoder in ("classic", "local-global"):
        label = f"motion head, {encoder} encoder"
        args = cli("--encoder-type", encoder)
        setup(args)
        model = seeded_model(args, device).eval()
        n_params = sum(p.numel() for p in model.parameters())
        want_params = MOTION_PARAMS[encoder]
        phases.check(n_params == want_params,
                     f"{label}: {n_params} parameters (JAX's {want_params})")
        evaluate_on_device(model, videos[1024][:1], args.nms_thresh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(flash)
        per_video = []
        t0 = time.perf_counter()
        mean_f, _ = evaluate_on_device(model, videos[1024], args.nms_thresh,
                                       prepared=prepared[1024],
                                       per_video=per_video)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = launch_counts(flash)
        by_dim = dict(flash.flash_attention_fwd.launches_by_head_dim)
        launched[encoder] = {"counts": counts, "by_head_dim": by_dim}
        n_batches = len(prepared[1024])
        want_dims = ({128: n_batches} if encoder == "classic"
                     else {128: n_batches, 512: 4 * n_batches})
        print(f"  {label}: mean F {mean_f:.6f}; F per video "
              f"{[round(p['fscore'], 6) for p in per_video]}; launches "
              f"{counts}, forward by head dim {by_dim}")
        phases.check(counts == {"flash_attention_fwd": sum(want_dims.values()),
                                "flash_attention_dq": 0,
                                "flash_attention_dkv": 0}
                     and by_dim == want_dims,
                     f"{label} evaluate: {counts['flash_attention_fwd']} "
                     f"forward launches, by head dim {by_dim} (want "
                     f"{want_dims})")
        phases.check(len(per_video) == len(records)
                     and all(0.0 <= p["fscore"] <= 1.0 for p in per_video),
                     f"{label}: every F in [0, 1]")
        dense = get_model(args.model, **{**vars(args), "use_pallas": False})
        dense = dense.to(device).eval()               # --no-pallas
        dense.load_state_dict(model.state_dict())
        dense_videos = []
        evaluate_on_device(dense, videos[1024], args.nms_thresh,
                           prepared=prepared[1024], per_video=dense_videos)
        same_f = [a["fscore"] == b["fscore"] for a, b in zip(per_video,
                                                             dense_videos)]
        phases.check(all(same_f), f"{label}: per-video F equal on kernel and "
                                  f"dense routes ({sum(same_f)}/"
                                  f"{len(same_f)})")
        err = max(float((g - w).abs()[real_of(e["tb"])].max())
                  for g, w, e in zip(predict_all(model, 1024),
                                     predict_all(dense, 1024),
                                     prepared[1024]))
        print(f"  [{smi}] {label}: pred_cls kernel vs dense route max abs "
              f"err {err:.3e}")
        check_against_f64(model, args, prepared[1024], phases,
                          f"{label} (kernel route, motion width 1024)")
        host_videos = []
        t0 = time.perf_counter()
        evaluate(model, videos[1024], args.nms_thresh,
                 prepared=prepared[1024], per_video=host_videos)
        host_ms = (time.perf_counter() - t0) * 1e3
        gap = max(abs(a["fscore"] - b["fscore"])
                  for a, b in zip(per_video, host_videos))
        phases.check(len(host_videos) == len(records) and gap <= 1e-6,
                     f"{label} --host-eval: per-video F within 1e-6 of the "
                     f"device evaluator (max gap {gap:.2e})")
        with torch.inference_mode():
            predict_ms = [cuda_ms(lambda: model.predict(
                *model_inputs(e["tb"])), iters=5) for e in prepared[1024]]
        print(f"  [{smi}] {label}: predict ms per batch "
              f"{[round(t, 3) for t in predict_ms]} (buckets "
              f"{[int(e['tb']['seq'].shape[1]) for e in prepared[1024]]}); "
              f"eval of {len(records)} videos {eval_ms:.1f} ms on the device "
              f"evaluator, {host_ms:.1f} ms on the host one; peak device "
              f"memory {peak:.2f} GiB")
        del model, dense
        torch.cuda.empty_cache()

    # classic at motion width 512: float64, training, the checkpoint path
    label = "motion head, classic, motion width 512"
    args = cli("--batch-size", "4", "--max-epoch", "2")
    setup(args)
    model = seeded_motion_model(args, 512, device).eval()
    check_against_f64(model, args, prepared[512], phases, label)
    val_ids = (2, 5)
    train_videos = [r for i, r in enumerate(videos[512]) if i not in val_ids]
    val_videos = [videos[512][i] for i in val_ids]

    def through_evaluate(path, best):
        fresh = get_model(args.model, **vars(args)).to(device)   # width 1024
        got = {}
        for name, fn in (("device", evaluate_on_device), ("host", evaluate)):
            got[name], _ = eval_checkpoint(args, fresh, path, val_videos,
                                           eval_fn=fn)
        phases.check(fresh.motion_width == 512
                     and all(abs(f - best) <= 1e-6 for f in got.values()),
                     f"{label}: the best checkpoint through "
                     f"evaluate.eval_checkpoint gives F {got} == best "
                     f"{best:.7f} (motion width {fresh.motion_width})")
        wide = [videos[1024][i] for i in val_ids]
        try:
            eval_checkpoint(args, fresh, path, wide)
            raised = ""
        except ValueError as e:
            raised = str(e)
        phases.check("expects width 512" in raised,
                     f"{label}: its checkpoint on width-1024 videos raises "
                     f"({raised!r})")

    torch.cuda.reset_peak_memory_stats()
    check_training(flash, phases, train_videos, val_videos, args,
                   on_checkpoint=through_evaluate)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    batches = train_batches(args, train_videos, device)
    phases.check(all("motion" in b for b in batches),
                 f"{label}: every train batch carries motion "
                 f"{[tuple(b['motion'].shape) for b in batches]}")

    def fresh_step(**flags):
        m = seeded_motion_model(args, 512, device)
        set_dropout_generator(m, torch.Generator(device).manual_seed(
            seed + 1))
        opt = steps.make_optimizer(m.parameters(), args.lr,
                                   args.weight_decay)
        gen = torch.Generator(device).manual_seed(seed + 2)
        kw = dict(lambda_reg=args.lambda_reg, neg_ratio=args.neg_sample_ratio,
                  inc_ratio=args.incomplete_sample_ratio)
        return m, lambda b: steps.ab_train_step(m, opt, b, gen, **kw,
                                                **flags)

    big = batches[-1]
    # the largest bucket first, from the seeded weights: the remat step is
    # held to the plain one there; timed after the other buckets' steps
    # have warmed this dtype's kernels up
    order = batches[-1:] + batches[:-1]
    timing = {}
    updated = {}
    for name, flags in (("f32", {}), ("bf16", {"compute_dtype": "bfloat16"}),
                        ("remat", {"remat": True})):
        m, step = fresh_step(**flags)
        losses = [step(big)["loss"]]
        updated[name] = [p.detach().clone() for p in m.parameters()]
        losses = torch.stack(losses + [step(b)["loss"]
                                       for b in order[1:]]).cpu()
        ms, gib = step_peak(lambda: step(big))
        phases.check(bool(torch.isfinite(losses).all())
                     and all(p.dtype == torch.float32 for p in m.parameters()),
                     f"{label} {name}: one step per bucket "
                     f"{[int(b['seq'].shape[1]) for b in order]}, losses "
                     f"{[round(float(x), 4) for x in losses]} finite, "
                     f"masters float32")
        timing[name] = (ms, gib)
        del m, step
    gap = max(float((a - b).abs().max())
              for a, b in zip(updated["f32"], updated["remat"]))
    phases.check(gap <= 1e-6, f"{label} --remat: the step at bucket "
                              f"{int(big['seq'].shape[1])} updates the "
                              f"parameters within 1e-6 of the plain step's "
                              f"(max gap {gap:.3e})")
    print(f"  [{smi}] {label}: train step at bucket "
          f"{int(big['seq'].shape[1])}: "
          + "; ".join(f"{k} {ms:.3f} ms, peak {gib:.2f} GiB"
                      for k, (ms, gib) in timing.items())
          + f"; peak in training {train_peak:.2f} GiB")
    del model
    torch.cuda.empty_cache()

    # --matmul-precision bfloat16 is JAX's Precision.DEFAULT: TF32 here
    head = config_lib.get_arguments(["anchor-based", "--base-model",
                                     "nystromformer", "--anchor-scales", "12",
                                     "--seed", str(seed)])
    plain = prepare_eval_batches(records, 4, head.bucket_size, device)
    model = seeded_model(head, device).eval()
    cls, tf32 = {}, {}
    for precision in ("default", "bfloat16"):
        setup(config_args(head, matmul_precision=precision))
        tf32[precision] = torch.backends.cuda.matmul.allow_tf32
        with torch.inference_mode():
            cls[precision] = [model.predict(e["tb"]["seq"],
                                            e["tb"]["mask"])[0]
                              for e in plain]
    f64 = f64_errors(model, head, plain)[0]          # still at bfloat16
    setup(head)
    print(f"  [{smi}] headline --matmul-precision default / bfloat16: cuBLAS "
          f"TF32 {tf32}; pred_cls vs float64 at bfloat16 max abs err "
          f"{max(f64):.3e}, per batch {[float(f'{e:.3e}') for e in f64]}")
    phases.check(all(torch.equal(a, b) for a, b in zip(cls["default"],
                                                       cls["bfloat16"])),
                 "--matmul-precision bfloat16 gives pred_cls bit-equal to "
                 "default on the headline")
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return launched


# phase 13: the video pipeline after decode and resize, and the frame CNNs
# torchvision's counts without the classifier, as jax.eval_shape counts
# edsnet_tpu's flax modules at 224 x 224 (GoogLeNet also holds 14,560 BN
# statistics)
CNN_PARAMS = {"google-net": 5_599_904, "convnext": 87_564_416,
              "swin-transformer": 86_905_848}
VIDEO_POSITIONS = 2100        # the longest synthetic video, at rate 15
VIDEO_RATE = 15
DEFAULT_PARAMS = 4_344_707    # the CLI default model (JAX's count)


def scene_frames(n: int, seed: int, device: torch.device):
    """[n, 3, 224, 224] preprocessed frames of a synthetic video made on
    the card: scenes of 20 to 140 positions, each a seeded low-frequency
    pattern with its own amplitude and per-channel offset, each frame that
    plus N(0, 0.1^2) noise -> (frames, the true cuts in positions)."""
    import torch.nn.functional as F

    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < n:
        lens.append(int(rng.randint(20, 141)))
    lens[-1] -= sum(lens) - n
    g = torch.Generator(device=device).manual_seed(seed)
    k = len(lens)
    base = F.interpolate(torch.randn(k, 3, 7, 7, generator=g, device=device),
                         size=(224, 224), mode="bilinear",
                         align_corners=False)
    base = (base * (0.5 + torch.rand(k, 1, 1, 1, generator=g, device=device))
            + 3.0 * torch.rand(k, 3, 1, 1, generator=g, device=device) - 1.5)
    scene = torch.from_numpy(np.repeat(np.arange(k), lens)).to(device)
    frames = base[scene] + 0.1 * torch.randn(n, 3, 224, 224, generator=g,
                                             device=device)
    return frames, np.cumsum(lens)[:-1]


def f64_gaps(model, x: torch.Tensor, tf32: bool = False):
    """max |f32 - f64| of the L2-normalised outputs of ``model`` on ``x``
    against a float64 copy of it on the card, with TF32 off, and with it
    on if ``tf32`` (else None)."""
    import copy

    from edsnet_torch.data.video import l2_normalize_rows
    from edsnet_torch.evaluate import set_tf32

    with torch.inference_mode():
        want = l2_normalize_rows(copy.deepcopy(model).double()(x.double()))
        gaps = []
        for on in (False, True)[:1 + tf32]:
            set_tf32(on)
            gaps.append(float((l2_normalize_rows(model(x)).double()
                               - want).abs().max()))
        set_tf32(False)
    return gaps[0], (gaps[1] if tf32 else None)


def check_video_pipeline(flash, phases: Phases, seed: int,
                         smi: str) -> Dict[str, dict]:
    """Phase 15, the video pipeline on the card after decode and resize
    (cv2 and PIL are host code, absent on the card machine):
    (a) GoogLeNet pool5, ConvNeXt-Base and Swin-V2-B at full architecture
        with seeded random weights under torchvision's names
        (models/common.py:randomize_cnn_): JAX's parameter counts; a
        [32, 3, 224, 224] batch made on the card -> [32, 1024], the
        L2-normalised features with TF32 off within 1e-4 of the module in
        float64 on the card, the TF32 gap beside it; ms per frame at batch
        1 (JAX's per-frame run) and 32, peak memory;
    (b) the infer path at full width: one video of 2100 sampled positions
        (31,500 frames at rate 15), its frames made on the card, through
        GoogLeNet (the default extractor, data/video.py:FrameCNNExtractor,
        32 frames a forward) and the L2 normalisation, with BN statistics
        fitted to a sample of the video (a trained extractor's statistics
        fit its inputs; drawn ones make every pooled feature nearly the
        same); KTS through h5io.segment_features on the card
        (--device-kts) and on the native host DP, equal change points;
        then infer.summarize_video on the CLI default model (4,344,707
        parameters) and on the motion head (classic encoder,
        --attention-depth 2, motion width 1024, 26,398,595; seeded
        unit-norm motion rows), each through a port-saved checkpoint and
        load_checkpoint, on the kernel route and the dense route: bit-equal
        summaries, 1 forward launch (head dim 128) on the kernel route and
        0 on the dense; ms of the features, KTS (both routes), predict+NMS
        and the summary;
    (c) data/motion.py's Conv3DMotionNet at full width on a [4, 8, 112,
        112, 3] clip batch: f32 within 1e-4 of float64 (L2-normalised);
        ms per clip.
    Returns, per infer path, the launch counts of its kernel route."""
    from edsnet_torch import config as config_lib
    from edsnet_torch import infer
    from edsnet_torch.data import h5io
    from edsnet_torch.data.motion import Conv3DMotionNet
    from edsnet_torch.data.video import FrameCNNExtractor, frame_cnn
    from edsnet_torch.evaluate import set_tf32, setup
    from edsnet_torch.models.common import randomize_cnn_
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.ops import kts
    from edsnet_torch.ops import summary as summ_ops
    from edsnet_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    set_tf32(False)

    # (a) the three CNNs
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(32, 3, 224, 224, generator=g, device=device)
    cnns = {}
    for kind, want_params in CNN_PARAMS.items():
        model, _ = frame_cnn(kind)
        randomize_cnn_(model, torch.Generator().manual_seed(seed))
        model = model.to(device).eval()
        n_params = sum(p.numel() for p in model.parameters())
        stats = sum(b.numel() for name, b in model.named_buffers()
                    if name.endswith(("running_mean", "running_var")))
        phases.check(n_params == want_params,
                     f"{kind}: {n_params} parameters (JAX's {want_params})")
        if kind == "google-net":
            phases.check(stats == 14_560,
                         f"{kind}: {stats} BN statistics (JAX's 14560)")
        with torch.inference_mode():
            out = model(x)
        phases.check(tuple(out.shape) == (32, 1024)
                     and bool(torch.isfinite(out).all()),
                     f"{kind}: [32, 1024] finite features")
        err, err_tf32 = f64_gaps(model, x, tf32=True)
        phases.check(err <= TOL, f"{kind}: L2-normalised features within "
                                 f"1e-4 of float64 ({err:.3e}; TF32 "
                                 f"{err_tf32:.3e})")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            ms1 = cuda_ms(lambda: model(x[:1]), iters=20)
            ms32 = cuda_ms(lambda: model(x), iters=5)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        cnns[kind] = {"params": n_params, "f64_err": err,
                      "tf32_err": err_tf32, "ms_frame_b1": ms1,
                      "ms_frame_b32": ms32 / 32, "peak_gib": peak}
        print(f"  [{smi}] {kind}: ms per frame {ms1:.4f} at batch 1, "
              f"{ms32 / 32:.4f} at batch 32; peak {peak:.2f} GiB")
        del model
        torch.cuda.empty_cache()

    # (b) the infer path: features, KTS on both routes, summaries
    n = VIDEO_POSITIONS
    n_frames = n * VIDEO_RATE
    frames, cuts = scene_frames(n, seed, device)
    cnn, _ = frame_cnn("google-net")
    randomize_cnn_(cnn, torch.Generator().manual_seed(seed))
    cnn = cnn.to(device)
    for m in cnn.modules():           # fit the BN statistics to the video
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
            m.momentum = None
    cnn.train()
    with torch.no_grad():
        cnn(frames[::33])
    extractor = FrameCNNExtractor(cnn, device)
    extractor.features(frames[:64])                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extractor.features(frames).cpu().numpy()
    ms_features = (time.perf_counter() - t0) * 1e3
    del frames
    torch.cuda.empty_cache()
    phases.check(feats.shape == (n, 1024) and bool(np.isfinite(feats).all())
                 and bool(np.allclose(np.linalg.norm(feats, axis=-1), 1.0,
                                      atol=1e-5)),
                 f"features [{n}, 1024], finite, unit norm")
    scene = np.repeat(np.arange(len(cuts) + 1), np.diff(np.r_[0, cuts, n]))
    off_scene = (feats @ feats.T)[scene[:, None] != scene[None, :]]
    print(f"  {len(cuts) + 1} scenes; cosine between scenes mean "
          f"{off_scene.mean():.4f} max {off_scene.max():.4f}")
    calls = kts.cpd_auto_device.device_calls
    t0 = time.perf_counter()
    dev = h5io.segment_features(feats, VIDEO_RATE, n_frames, device=device)
    ms_kts_device = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = h5io.segment_features(feats, VIDEO_RATE, n_frames)
    ms_kts_host = (time.perf_counter() - t0) * 1e3
    phases.check(kts.cpd_auto_device.device_calls == calls + 1,
                 "KTS ran on the card (no float64 fallback)")
    phases.check(all(np.array_equal(a, b) for a, b in zip(dev, host)),
                 f"KTS change points equal on the card and the host "
                 f"({len(host[0])} shots; {len(cuts)} true cuts, "
                 f"{len(set(host[0][1:, 0]) & set(cuts * VIDEO_RATE))} "
                 f"found)")
    cps, nfps, picks = host

    rng = np.random.RandomState(seed)
    motion = rng.randn(n, 1024).astype(np.float32)
    motion /= np.linalg.norm(motion, axis=-1, keepdims=True)
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, flags, want_params, mot in (
                ("infer, anchor-based attention (CLI default)", [],
                 DEFAULT_PARAMS, None),
                ("infer, motion head classic encoder",
                 ["--model-depth", "cross-attention"],
                 MOTION_PARAMS["classic"], motion)):
            args = config_lib.get_arguments(
                ["anchor-based", *flags, "--seed", str(seed)])
            setup(args)
            path = Path(tmp) / "model.pt"
            save_checkpoint(seeded_model(args, device), path)
            summaries = {}
            for route, use_pallas in (("kernel", None), ("dense", False)):
                model = get_model(args.model,
                                  **{**vars(args), "use_pallas": use_pallas})
                model = load_checkpoint(model.to(device), path).eval()
                n_params = sum(p.numel() for p in model.parameters())
                if route == "kernel":
                    phases.check(n_params == want_params,
                                 f"{label}: {n_params} parameters (JAX's "
                                 f"{want_params})")
                infer.kept_boxes(model, feats, args.nms_thresh,
                                 args.bucket_size, mot)     # warm-up
                torch.cuda.synchronize()
                reset_launches(flash)
                t0 = time.perf_counter()
                summ = infer.summarize_video(
                    model, feats, cps, n_frames, nfps, picks,
                    args.nms_thresh, bucket_size=args.bucket_size,
                    motion=mot)
                ms_total = (time.perf_counter() - t0) * 1e3
                counts = {"counts": launch_counts(flash),
                          "by_head_dim": dict(
                              flash.flash_attention_fwd.launches_by_head_dim)}
                # its stages, outside the counted run
                t0 = time.perf_counter()
                scores, boxes = infer.kept_boxes(
                    model, feats, args.nms_thresh, args.bucket_size, mot)
                t1 = time.perf_counter()
                summ_ops.bbox2summary(n, scores, boxes, cps, n_frames, nfps,
                                      picks)
                t2 = time.perf_counter()
                summaries[route] = summ
                fwd = counts["counts"]["flash_attention_fwd"]
                want = 1 if route == "kernel" else 0
                phases.check(fwd == want == sum(counts["counts"].values())
                             and counts["by_head_dim"].get(128, 0) == want,
                             f"{label}, {route} route: {fwd} forward "
                             f"launches per video ({want}, head dim 128), "
                             f"no backward launch")
                if route == "kernel":
                    launched[label] = counts
                print(f"  [{smi}] {label}, {route} route: summarize_video "
                      f"{ms_total:.1f} ms; timed apart, predict+NMS "
                      f"{(t1 - t0) * 1e3:.1f} ms ({len(scores)} kept "
                      f"boxes), summary {(t2 - t1) * 1e3:.1f} ms; "
                      f"{int(summ.sum())}/{n_frames} frames kept")
                del model
            phases.check(np.array_equal(summaries["kernel"],
                                        summaries["dense"])
                         and 0 < summaries["kernel"].sum()
                         <= 0.15 * n_frames,
                         f"{label}: summaries bit-equal on the kernel and "
                         f"dense routes")
    print(f"  [{smi}] infer path at {n} positions: features "
          f"{ms_features:.1f} ms ({ms_features / n:.4f} per frame), KTS "
          f"card {ms_kts_device:.1f} ms, host {ms_kts_host:.1f} ms")

    # (c) the conv3d motion net
    net = Conv3DMotionNet(seed=seed, device=device)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    clips = torch.rand(4, 8, 112, 112, 3, generator=g, device=device)
    err, _ = f64_gaps(net.net, clips)
    phases.check(err <= TOL, f"conv3d motion net: L2-normalised features "
                             f"within 1e-4 of float64 ({err:.3e})")
    with torch.inference_mode():
        ms4 = cuda_ms(lambda: net.net(clips), iters=10)
        ms1 = cuda_ms(lambda: net.net(clips[:1]), iters=10)
    print(f"  [{smi}] conv3d motion net: ms per clip {ms4 / 4:.4f} at "
          f"batch 4, {ms1:.4f} at batch 1")
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launched


RING_SHAPE = (4, 8, 2304, 128)   # B, H, N, D: the largest eval batch's


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_run(trainer, args, train_videos, val_videos):
    """trainer.train_records on ``args`` -> (losses [steps], best F, F per
    epoch, the best checkpoint's tensors)."""
    steps = []
    real_step = trainer.ab_train_step

    def recorded(*a, **kw):
        metrics = real_step(*a, **kw)
        steps.append(metrics["loss"])
        return metrics

    trainer.ab_train_step = recorded
    try:
        with tempfile.TemporaryDirectory() as tmp:
            best, f1s, _ = trainer.train_records(args, train_videos,
                                                 val_videos, f"{tmp}/best.pt")
            ckpt = torch.load(f"{tmp}/best.pt", map_location="cpu",
                              weights_only=True)
    finally:
        trainer.ab_train_step = real_step
    return torch.stack(steps).cpu(), best, f1s, ckpt


def counted_collectives():
    """Wrap torch.distributed's all_reduce, all_gather and broadcast with
    call counters -> (counts, restore)."""
    import torch.distributed as dist

    counts = {}
    saved = {}
    for name in ("all_reduce", "all_gather", "broadcast"):
        real = getattr(dist, name)
        saved[name] = real

        def wrapped(*a, _real=real, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **kw)

        setattr(dist, name, wrapped)

    def restore():
        for name, real in saved.items():
            setattr(dist, name, real)

    return counts, restore


def check_parallel(flash, phases: Phases, records, train_videos,
                   val_videos, seed: int, smi: str) -> Dict:
    """Phase 16, parallelism on the one card: (a) a world-1 NCCL process
    group under the training and evaluate paths, bit-equal to no group;
    (b) --context-parallel 2 on world 1 (warning, no ring, same F); (c)
    --num-devices 2 and --tensor-parallel 2 raising JAX's texts; (d) the
    ring at P 2 and 4 and tensor parallelism at P 2 as emulated ranks in
    this process (the per-rank functions of the distributed route, the
    transport a list rotation and a sum) -> the phase's numbers."""
    import logging

    import torch.distributed as dist

    from edsnet_torch import config as config_lib
    from edsnet_torch import trainer
    from edsnet_torch.evaluate import eval_mesh
    from edsnet_torch.models import base as model_base
    from edsnet_torch.models.common import masked_softmax
    from edsnet_torch.parallel import ring_attention as ring
    from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                                   prepare_eval_batches)
    from edsnet_torch.parallel.tensor_parallel import emulate_tp

    t_phase = time.perf_counter()
    out: Dict = {}
    train_args = config_lib.get_arguments([
        "anchor-based", "--seed", str(seed), "--batch-size", "4",
        "--max-epoch", "2", "--num-devices", "1"])
    eval_args = config_lib.get_arguments(["anchor-based", "--seed",
                                          str(seed), "--num-devices", "0"])
    model = seeded_model(eval_args, torch.device("cuda")).eval()
    n_batches = len(prepare_eval_batches(records, 4, eval_args.bucket_size,
                                         "cuda"))

    def evaluation(mesh):
        reset_launches(flash)
        per_video = []
        f, _ = evaluate_on_device(model, records, eval_args.nms_thresh,
                               batch_size=4,
                               bucket_size=eval_args.bucket_size,
                               per_video=per_video, mesh=mesh)
        return f, [p["fscore"] for p in per_video], \
            flash.flash_attention_fwd.launches

    ref_losses, ref_best, ref_f1s, ref_ckpt = train_run(
        trainer, train_args, train_videos, val_videos)
    ref_eval = evaluation(None)

    # (a) a world-1 NCCL group on cuda:0, its store on this host
    store = dist.TCPStore("127.0.0.1", free_port(), 1, True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    counts, restore = counted_collectives()
    try:
        t0 = time.perf_counter()
        losses, best, f1s, ckpt = train_run(trainer, train_args,
                                            train_videos, val_videos)
        train_s = time.perf_counter() - t0
        train_counts = dict(counts)
        counts.clear()
        mesh = eval_mesh(eval_args)
        got_eval = evaluation(mesh)
        eval_counts = dict(counts)
    finally:
        restore()
    same_ckpt = (sorted(ckpt) == sorted(ref_ckpt)
                 and all(torch.equal(ckpt[k], ref_ckpt[k]) for k in ckpt))
    print(f"  (a) world-1 NCCL: {len(losses)} steps, {train_s:.2f} s; "
          f"collectives in training {train_counts}, in evaluation "
          f"{eval_counts}; best F {best:.6f} (no group {ref_best:.6f}); "
          f"eval mesh {mesh}, F {got_eval[0]:.6f} (no group "
          f"{ref_eval[0]:.6f}), forward launches {got_eval[2]}")
    phases.check(dist.get_backend() == "nccl" and dist.get_world_size() == 1
                 and train_counts.get("all_reduce", 0) > 0
                 and eval_counts.get("all_gather", 0) > 0,
                 "world-1 NCCL group: the train step's all-reduces and the "
                 "evaluator's all-gathers ran through it")
    phases.check(torch.equal(losses, ref_losses) and best == ref_best
                 and f1s == ref_f1s and same_ckpt,
                 "world-1 NCCL training (--num-devices 1 --batch-size 4, 2 "
                 "epochs): losses, best F, F per epoch and every checkpoint "
                 "tensor bit-equal to no process group")
    phases.check(got_eval[0] == ref_eval[0] and got_eval[1] == ref_eval[1]
                 and got_eval[2] == ref_eval[2] == n_batches,
                 f"world-1 NCCL evaluate (--num-devices 0): F bit-equal, "
                 f"{got_eval[2]} forward launches == {n_batches} eval "
                 f"batches")

    # (b) --context-parallel 2 on world 1: the trainer's warning, no ring
    warned = []

    class Catch(logging.Handler):
        def emit(self, record):
            warned.append(record.getMessage())

    catch = Catch(level=logging.WARNING)
    logging.getLogger().addHandler(catch)
    cp_args = config_args(train_args, context_parallel=2)
    model_base.configure_context_parallel(2, cp_args.cp_min_len)
    calls = ring.ring_attention.calls
    try:
        _, cp_best, cp_f1s, _ = train_run(trainer, cp_args, train_videos,
                                          val_videos)
    finally:
        logging.getLogger().removeHandler(catch)
        model_base.set_context_parallel(0)
    ring_calls = ring.ring_attention.calls - calls
    print(f"  (b) --context-parallel 2: warnings {warned}; ring entered "
          f"{ring_calls} times; best F {cp_best:.6f}")
    phases.check(any("ring attention stays off" in w for w in warned)
                 and ring_calls == 0 and cp_best == ref_best
                 and cp_f1s == ref_f1s,
                 "--context-parallel 2 on world 1: warned, ring entered 0 "
                 "times, F per epoch equal to the run without the flag")

    # (c) what the world lacks raises JAX's texts
    for flag, want in (("num_devices", "requested 2 devices, but only 1 "
                                       "are available"),
                       ("tensor_parallel", "--tensor-parallel 2 must divide "
                                           "the device count 1")):
        try:
            trainer.training_mesh(config_args(train_args, **{flag: 2}))
            got = "no error"
        except ValueError as e:
            got = str(e)
        phases.check(got == want, f"--{flag.replace('_', '-')} 2 on world "
                                  f"1 raises {got!r}")
    dist.destroy_process_group()

    # (d) emulated ranks: the ring on the largest eval batch's key masks
    mask = prepare_eval_batches(records, 4, eval_args.bucket_size,
                                "cuda")[-1]["tb"]["mask"]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(RING_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    assert tuple(mask.shape) == (RING_SHAPE[0], RING_SHAPE[2])
    key_mask = mask[:, None, None, :]

    def dense(q, k, v):
        s = torch.einsum("bhnd,bhmd->bhnm", q, k) / RING_SHAPE[3] ** 0.5
        return torch.einsum("bhnm,bhmd->bhnd",
                            masked_softmax(s, key_mask, dim=-1), v)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            want64 = dense(q.double(), k.double(), v.double())
            want32 = dense(q, k, v)
            dense_ms = cuda_ms(lambda: dense(q, k, v), iters=5, warmup=1)
            out["ring"] = {"dense_ms": dense_ms}
            for p in (2, 4):
                got = ring.emulate_ring(q, k, v, mask, p)
                e64 = float((got.double() - want64).abs().max())
                e32 = float((got - want32).abs().max())
                ms = cuda_ms(lambda: ring.emulate_ring(q, k, v, mask, p),
                             iters=5, warmup=1)
                out["ring"][f"p{p}"] = {"ms": ms, "err_f64": e64,
                                        "err_dense_f32": e32}
                print(f"  (d) [{smi}] ring P {p} at {RING_SHAPE}: "
                      f"{ms:.3f} ms (dense f32 {dense_ms:.3f}); max abs err "
                      f"{e64:.3e} vs float64, {e32:.3e} vs dense f32")
                phases.check(e64 <= 1e-5 and e32 <= 1e-5,
                             f"emulated ring P {p}: within 1e-5 of float64 "
                             f"and of the dense f32 route")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    # (d) tensor parallelism at P 2 on the full model's predict
    prepared = prepare_eval_batches(records, 4, eval_args.bucket_size,
                                    "cuda")
    err, launches = 0.0, 0
    with torch.inference_mode():
        for entry in prepared:
            tb = entry["tb"]
            want, _ = model.predict(tb["seq"], tb["mask"])
            reset_launches(flash)
            with emulate_tp(model, 2):
                got, _ = model.predict(tb["seq"], tb["mask"])
            launches += flash.flash_attention_fwd.launches
            limit = max(1.0, float(want.abs().max()))
            err = max(err, float((got - want).abs().max()) / limit)
        tb = prepared[-1]["tb"]
        full_ms = cuda_ms(lambda: model.predict(tb["seq"], tb["mask"]),
                          iters=5, warmup=1)
        with emulate_tp(model, 2):
            tp_ms = cuda_ms(lambda: model.predict(tb["seq"], tb["mask"]),
                            iters=5, warmup=1)
    out["tp"] = {"ms": tp_ms, "full_ms": full_ms, "rel_err": err,
                 "launches": launches}
    print(f"  (d) [{smi}] tp P 2 predict at bucket "
          f"{int(tb['seq'].shape[1])}: {tp_ms:.3f} ms (unsharded "
          f"{full_ms:.3f}); pred_cls max err {err:.3e} of max(1, |want|); "
          f"forward launches {launches} over {len(prepared)} batches")
    phases.check(err <= 1e-5, "emulated tp P 2: pred_cls within 1e-5 of "
                              "max(1, |want|) of the unsharded predict")
    phases.check(launches == 2 * len(prepared),
                 f"emulated tp P 2: the forward kernel once per rank per "
                 f"attention call ({launches} == 2 x {len(prepared)})")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 14 took {out['seconds']:.1f} s")
    return out


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
    from edsnet_torch.kernels.knapsack import knapsack_dp
    from edsnet_torch.kernels.nms import nms_sweep
    from edsnet_torch.models.common import init_weights
    from edsnet_torch.models.model_zoo import get_model
    from edsnet_torch.parallel.eval_device import (batch_eval_device,
                                                   evaluate_on_device,
                                                   prepare_eval_batches)

    phases = Phases()

    print("phase: build")
    t0 = time.perf_counter()
    reports = build.build(*KERNEL_SOURCES, YARDSTICKS)
    print(f"  built {len(KERNEL_SOURCES)} kernel source(s) and the "
          f"yardstick in {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for kernel, spills, regs in ptxas_summary(log):
            print(f"    {name}: {kernel}: {regs} registers, {spills}")
            phases.check(spills.startswith("0 bytes spill stores, 0 bytes "
                                           "spill loads"),
                         f"ptxas: no spills in {kernel}")

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
    nms_before = nms_sweep.launches
    knapsack_before = knapsack_dp.launches
    t0 = time.perf_counter()
    per_video = []
    mean_f, mean_div = evaluate_on_device(
        model, records, args.nms_thresh, batch_size=batch_size,
        bucket_size=args.bucket_size, per_video=per_video)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    launches = flash.flash_attention_fwd.launches
    nms_launches = nms_sweep.launches - nms_before
    knapsack_launches = knapsack_dp.launches - knapsack_before
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  mean F {mean_f:.6f}, mean diversity {mean_div:.6f}, peak "
          f"device memory {peak_gb:.2f} GiB")
    for p in per_video:
        print(f"    {p['key']}: F {p['fscore']:.6f} summary frames "
              f"{int(p['summary'].sum())}/{p['summary'].size}")
    phases.check(launches == n_batches,
                 f"flash kernel launches {launches} == eval batches "
                 f"{n_batches}")
    phases.check(nms_launches == n_batches,
                 f"nms kernel launches {nms_launches} == eval batches "
                 f"{n_batches}")
    phases.check(knapsack_launches == n_batches,
                 f"knapsack kernel launches {knapsack_launches} == eval "
                 f"batches {n_batches}")
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
    batch_ms, nms_ms, n_boxes = eval_batch_breakdown(model, prepared[-1],
                                                     args.nms_thresh)

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
    timing = time_kernels(flash, build, phases, smi)
    autograd_launches = check_flash_autograd(flash, phases)
    nms_timing = time_nms(phases, smi)
    knapsack_timing = time_knapsack(phases, smi)
    print(f"  [{smi}] predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]} (bucket lengths "
          f"{[int(e['tb']['seq'].shape[1]) for e in prepared]}); eval of "
          f"{len(records)} videos {eval_ms:.1f} ms")
    print_breakdown(smi, "attention", prepared[-1], batch_ms, predict_ms[-1],
                    nms_ms, n_boxes)

    print("phase: headline path at full width (nystromformer, scale 12)")
    check_headline(flash, phases, records, train_videos, val_videos,
                   opts.seed, smi)
    print("phase: the other token mixers at full width")
    check_mixers(flash, phases, records, train_videos, opts.seed, smi)
    print("phase: the train-step flags at full width")
    check_step_flags(flash, phases, records, train_videos, val_videos,
                     opts.seed, smi)
    print("phase: anchor-free at full width")
    af_launches = check_anchor_free(flash, phases, records, train_videos,
                                    val_videos, opts.seed, smi)
    print("phase: the poolings and the attention heads at full width")
    head_launches = check_heads_and_poolings(flash, phases, records,
                                             train_videos, opts.seed, smi)
    print("phase: the host side at full width")
    check_host_side(flash, phases, records, train_videos, val_videos,
                    opts.seed, smi)
    print("phase: the motion head (cross-attention) at full width")
    motion_launches = check_motion(flash, phases, records, opts.seed, smi)
    print("phase: the video pipeline and the frame CNNs at full width")
    infer_launches = check_video_pipeline(flash, phases, opts.seed, smi)
    print("phase: parallelism (world-1 NCCL, emulated ring and tp ranks)")
    parallel = check_parallel(flash, phases, records, train_videos,
                              val_videos, opts.seed, smi)
    print(f"checks: {phases.count - len(phases.failed)} of {phases.count} "
          f"passed")
    if phases.failed:
        print(f"FAILED: {phases.failed}")
        return 1
    kernels = []
    # launches: the forward on the evaluate path; dq and dk/dv in the
    # counted forward plus backward at the largest eval batch
    for name, source, line, used in (
            ("flash_attention_fwd", "flash_attention_fwd.cu", 58, launches),
            ("flash_attention_dq", "flash_attention_bwd.cu", 155,
             autograd_launches["flash_attention_dq"]),
            ("flash_attention_dkv", "flash_attention_bwd.cu", 202,
             autograd_launches["flash_attention_dkv"])):
        t = timing[name]
        entry = {
            "name": name, "route": "cuda",
            "source": f"edsnet_torch/csrc/{source}",
            "replaces": f"edsnet_tpu/kernels/flash_attention.py:{line}",
            "launches": used,
            "ms": t["highest"]["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["highest"]["bound_ms"],
            "bound_by": t["highest"]["bound_by"],
            "library_ms": t["library_ms"],
            "launches_anchor_free": {
                path: counts[name] for path, counts in af_launches.items()},
            "launches_motion": {
                encoder: c["counts"][name] if name != "flash_attention_fwd"
                else c["by_head_dim"].get(128, 0)
                for encoder, c in motion_launches.items()},
            "launches_by_path": {
                path: c["counts"][name] if name != "flash_attention_fwd"
                else c["by_head_dim"].get(128, 0)
                for path, c in infer_launches.items()},
            "launches_parallel": {
                "tp 2 emulated predict, every eval batch":
                    parallel["tp"]["launches"]
                    if name == "flash_attention_fwd" else 0},
            "default": {"ms": t["default"]["ms"],
                        "bound_ms": t["default"]["bound_ms"]}}
        kernels.append(entry)
    # flash_fwd_cluster_kernel, the forward at head dims 512 and 256, each
    # at its path's shape with its launches there (phase 10's anchor-based
    # local-global evaluation, phase 9's anchor-free deep predict over the
    # eval batches)
    lg = head_launches[f"anchor-based attention {LG}"]["by_head_dim"]
    for d, label, used, by_path, extra in (
            (512, "head dim 512 local", lg.get(512, 0),
             {**{path: c["by_head_dim"].get(512, 0)
                 for path, c in head_launches.items()},
              **{f"motion head, {encoder} encoder":
                 c["by_head_dim"].get(512, 0)
                 for encoder, c in motion_launches.items()}},
             "head dim 512"),
            (256, "head dim 256",
             af_launches["deep"]["by_head_dim"].get(256, 0),
             {f"anchor-free {path}": c["by_head_dim"].get(256, 0)
              for path, c in af_launches.items() if "by_head_dim" in c},
             None)):
        t = timing[f"flash_attention_fwd {label}"]
        entry = {
            "name": f"flash_fwd_cluster_kernel<{d // 2}> "
                    f"(flash_attention_fwd, head dim {d})",
            "route": "cuda",
            "source": "edsnet_torch/csrc/flash_attention_fwd.cu",
            "replaces": "edsnet_tpu/kernels/flash_attention.py:58",
            "launches": used,
            "ms": t["highest"]["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["highest"]["bound_ms"],
            "bound_by": t["highest"]["bound_by"],
            "library_ms": t["library_ms"],
            "shape": t["shape"],
            "library_backend": t["library_backend"],
            "launches_by_path": by_path,
            "occupancy_p3":
                timing["occupancy"][f"flash_attention_fwd d{d} p3"],
            "default": {"ms": t["default"]["ms"],
                        "bound_ms": t["default"]["bound_ms"],
                        "bound_by": t["default"]["bound_by"]}}
        if extra:
            t = timing[f"flash_attention_fwd {extra}"]
            entry["at_2304"] = {
                "shape": [8, 2304, 512], "ms": t["highest"]["ms"],
                "plain_ms": t["plain_ms"], "library_ms": t["library_ms"],
                "bound_ms": t["highest"]["bound_ms"],
                "default": {"ms": t["default"]["ms"],
                            "bound_ms": t["default"]["bound_ms"]}}
        kernels.append(entry)
    kernels.append({
        "name": "nms_sweep_kernel (nms_sweep)", "route": "cuda",
        "source": "edsnet_torch/csrc/nms.cu",
        "replaces": "edsnet_tpu/ops/bbox.py:125 (nms_masked, a lax.scan)",
        "launches": nms_launches,
        "by_boxes": {str(n): t for n, t in nms_timing.items()}})
    kernels.append({
        "name": "knapsack_kernel (knapsack_dp)", "route": "cuda",
        "source": "edsnet_torch/csrc/knapsack.cu",
        "replaces": "edsnet_tpu/ops/knapsack.py:knapsack_jax (two lax.scans)",
        "launches": knapsack_launches,
        "by_shape": knapsack_timing})
    print("parallel: " + json.dumps({"device": smi, **parallel}))
    print(json.dumps({"kernels": kernels,
                      "tf32_mma_tflops": timing["tf32_mma_tflops"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
