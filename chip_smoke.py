"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py [--seed 0]

Phases, each of which must pass (exit code 1 otherwise):
1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the path from the sources in this checkout,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch twin on the card, at small shapes
   and at the main path's largest shape (tolerance 1e-4: f32, another
   summation order; l, a sum of up to N terms, relative);
4. the main path at full width: the evaluate entry point's default
   configuration (anchor-based DSNet, attention backbone, F 1024, 8 heads,
   hidden 128, fc depth 7, scales 4 8 16 32) with seeded random weights on
   8 synthetic eccv16-shaped videos, through evaluate_on_device with batch
   size 4; the flash kernel must launch once per eval batch, every F must
   lie in [0, 1], and the dense route (--no-pallas) must give the same
   per-video F and pred_cls within 1e-4;
5. times in CUDA events after warm-up, beside the card's name and power
   limit: predict per batch, the whole evaluation, and each kernel against
   its bound, its twin and the library call that computes the same function.

The last lines are a JSON object describing each kernel, the nvidia-smi
line, and {"ok": true, "device": {...}}.  Without a CUDA card, or without
the rest of the repository beside this file, it exits non-zero before
printing a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-4
F32_PEAK_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
KERNEL_SOURCES = ("flash_attention_fwd",)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


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


def check_flash(flash, phases: Phases) -> float:
    """Kernel vs twin; returns the largest abs error of out over all cases."""
    worst = 0.0
    cases = [(4, 192, 64, [150, 150, 100, 100]),
             (2, 100, 128, [100, 100]),
             (2, 256, 128, [0, 256]),
             (32, 2304, 128, [2304] * 32)]
    for i, (bh, n, d, lens) in enumerate(cases):
        args = flash_case(flash, bh, n, d, lens, seed=i)
        got = flash.flash_attention_fwd(*args)
        torch.cuda.synchronize()
        want = flash.flash_attention_plain(*args)
        errs = []
        for name, g, w in zip(("out", "m", "l"), got, want):
            diff = (g - w).abs()
            abs_err = float(diff.max())
            rel_err = float((diff / w.abs().clamp(min=1.0)).max())
            errs.append(f"{name} abs {abs_err:.3e} rel {rel_err:.3e}")
            if name == "out":
                worst = max(worst, abs_err)
            ok = rel_err <= TOL if name == "l" else abs_err <= TOL
            phases.check(ok and bool(torch.isfinite(g).all()),
                         f"flash ({bh}, {n}, {d}) lens {sorted(set(lens))} "
                         f"{name}")
        print(f"    {'; '.join(errs)}")
    return worst


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("phase: kernels vs plain twins")
    max_abs_err = check_flash(flash, phases)

    print("phase: main path at full width")
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

    print("phase: timing")
    q, k, v, mask = flash_case(flash, 32, 2304, 128, [2304] * 32, seed=9)
    kernel_ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, mask))
    plain_ms = cuda_ms(lambda: flash.flash_attention_plain(q, k, v, mask))
    attn_mask = (mask > 0)[None, :, None, :]
    library_ms = cuda_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             q[None], k[None], v[None], attn_mask=attn_mask))
    bh, n, d = q.shape
    flops = 4.0 * bh * n * n * d
    nbytes = 4.0 * bh * (4 * n * d + 3 * n)
    flop_ms = flops / F32_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    print(f"  [{smi}] predict ms per batch "
          f"{[round(t, 3) for t in predict_ms]} (bucket lengths "
          f"{[int(e['tb']['seq'].shape[1]) for e in prepared]}); eval of "
          f"{len(records)} videos {eval_ms:.1f} ms")
    print(f"  [{smi}] eval batch at bucket {int(tb['seq'].shape[1])}: "
          f"{batch_ms:.1f} ms = predict {predict_ms[-1]:.2f} ms + NMS "
          f"({pred_cls.shape[1]} boxes) {nms_ms:.1f} ms + rasterise, "
          f"keyshot knapsack and F1 {batch_ms - predict_ms[-1] - nms_ms:.1f} "
          f"ms")
    print(f"  [{smi}] flash_attention_fwd (32, 2304, 128): kernel "
          f"{kernel_ms:.4f} ms ({flops / kernel_ms / 1e9:.2f} TFLOP/s), "
          f"twin {plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms (operations "
          f"{flop_ms:.4f} ms at 67 TFLOP/s f32, bytes {byte_ms:.4f} ms at "
          f"3.35 TB/s)")

    if phases.failed:
        print(f"FAILED: {phases.failed}")
        return 1
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "edsnet_torch/csrc/flash_attention_fwd.cu",
        "replaces": "edsnet_tpu/kernels/flash_attention.py:58",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": library_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
