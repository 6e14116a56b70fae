"""Evaluation: checkpoint -> predict -> NMS -> keyshot summary -> F-score,
per split, on the device evaluator (parallel/eval_device.py) or on the host.

Counterpart of edsnet_tpu/evaluate.py: ``main``, ``eval_fold_from_checkpoint``
(the h5 read, then ``eval_checkpoint`` on the videos in memory),
the host ``evaluate`` (``--host-eval``; predict and NMS on the device,
shared with the device evaluator as ``predict_nms``, then the kept boxes
sorted by score, rasterised and packed on the host) and ``KnapsackAudit``
(``--knapsack-audit``, which rides the host path).  Same flags, the same
``{model_dir}/checkpoint/{split}.{idx}.pt`` contract (torch or flax
checkpoints), the same printed lines, ``avg`` F over users on tvsum keys
and ``max`` elsewhere.

    python -m edsnet_torch.evaluate anchor-based --splits splits/x.yml \
        --model-dir MODEL_DIR --data-root DATA_DIR [--host-eval]
    python -m edsnet_torch.evaluate anchor-free --model-depth deep ...
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from edsnet_torch import config as config_lib
from edsnet_torch.data.dataset import (AverageMeter, VideoDataset,
                                       VideoRecord, get_ckpt_path, load_yaml)
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.native import load as _native_load
from edsnet_torch.ops import summary as summ_ops
from edsnet_torch.parallel.eval_device import (_device_of, _num_scales_of,
                                               checkpoint_motion_width,
                                               evaluate_on_device,
                                               gather_rows,
                                               model_needs_motion,
                                               predict_nms,
                                               prepare_eval_batches,
                                               summary_diversity)
from edsnet_torch.parallel.mesh import (init_distributed, is_writer,
                                        local_rank, make_mesh, torchrun_env)
from edsnet_torch.utils import checkpoint as ckpt_lib

logger = logging.getLogger()


def resolve_device(name: str) -> torch.device:
    """``auto`` and ``gpu`` mean CUDA and raise without a GPU (under
    ``torchrun``, the card ``LOCAL_RANK``, made current); ``cpu`` is for
    tests."""
    if name == "cpu":
        return torch.device("cpu")
    if name in ("auto", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA GPU found (pass "
                               f"--device cpu to run on the CPU)")
        if not torchrun_env():
            return torch.device("cuda")
        device = torch.device("cuda", local_rank())
        torch.cuda.set_device(device)
        return device
    raise ValueError(f"--device {name} is not served by the PyTorch port "
                     f"(choose auto, gpu or cpu)")


def as_device(device: Optional[str | torch.device]) -> torch.device:
    """A module's ``device=`` argument: None is ``resolve_device("auto")``
    (the card, and a raise without one), a ``--device`` name resolves as
    in the CLIs, anything else is a torch device."""
    if device is None:
        return resolve_device("auto")
    if isinstance(device, str) and device in ("auto", "gpu", "cpu"):
        return resolve_device(device)
    return torch.device(device)


def check_supported(args) -> None:
    """``setup``'s check of the flags: every flag of edsnet_tpu's CLIs is
    served, so nothing raises here.  The device-layout flags raise JAX's
    ValueErrors where their mesh is built, when the world lacks the
    ranks they ask for."""


# the train CLI serves the same flags as the evaluate CLI
check_train_supported = check_supported


# --matmul-precision values that allow TF32 (JAX's jax_default_matmul_
# precision on the GPU); float32, highest and no flag keep full f32.
# JAX maps "bfloat16" to Precision.DEFAULT, the entry of "default"
# (jax._src.lax.lax._precision_strings), so on the GPU it is TF32 too:
# its one bf16 pass exists only on a TPU
TF32_PRECISIONS = ("tensorfloat32", "high", "default", "bfloat16")


def setup(args, check=check_supported) -> torch.device:
    """Entry-point setup shared by the CLIs: the CLI's ``check`` of its
    flags, the device, the process group under ``torchrun``
    (parallel/mesh.py:init_distributed), and the precision of f32 products
    from ``--matmul-precision``: cuBLAS's and cuDNN's TF32 switches both
    on for ``TF32_PRECISIONS``, both off otherwise, so that results compare
    with f32 references.  The flash kernels keep their own
    ``precision``."""
    check(args)
    device = resolve_device(args.device)
    init_distributed(device)
    set_tf32(args.matmul_precision in TF32_PRECISIONS)
    return device


def set_tf32(enabled: bool) -> None:
    """cuBLAS's and cuDNN's TF32 switches, both to ``enabled``; the CLIs
    without ``--matmul-precision`` (make_dataset, data/motion.py) keep
    full f32."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


class KnapsackAudit:
    """Tie-selection audit: the shipped summary against the one the native
    branch and bound packs.

    Both solvers are exact on the value, but tied optima admit several item
    sets and the two break ties differently; a flip changes the summary.
    Per video it solves the summary once more with ``solver="bnb"`` and
    records whether the summaries differ, and the F-score delta."""

    def __init__(self):
        self.n_videos = 0
        self.n_diverged = 0
        self.abs_df: List[float] = []
        self.available = _native_load() is not None

    def check(self, record: VideoRecord, kept_cls, kept_boxes,
              eval_metric: str, pred_summ: np.ndarray) -> None:
        """Compare ``pred_summ`` (the default solver's) with the forced
        branch-and-bound selection."""
        if not self.available:
            return
        self.n_videos += 1
        seq_len = record.seq.shape[0]
        summ_bnb = summ_ops.bbox2summary(
            seq_len, kept_cls, kept_boxes, record.cps, record.n_frames,
            record.nfps, record.picks, solver="bnb")
        if np.array_equal(pred_summ, summ_bnb):
            return
        self.n_diverged += 1
        f_dp = summ_ops.get_summ_f1score(pred_summ, record.user_summary,
                                         eval_metric)
        f_bnb = summ_ops.get_summ_f1score(summ_bnb, record.user_summary,
                                          eval_metric)
        self.abs_df.append(abs(f_dp - f_bnb))
        logger.info("knapsack tie divergence on %s: F(dp)=%.4f F(bnb)=%.4f",
                    record.key, f_dp, f_bnb)

    def report(self) -> str:
        if not self.available:
            return "knapsack audit: native B&B unavailable, audit skipped"
        if not self.n_diverged:
            return (f"knapsack audit: 0/{self.n_videos} videos diverged "
                    f"(DP and B&B selections identical)")
        return (f"knapsack audit: {self.n_diverged}/{self.n_videos} videos "
                f"diverged; |dF| mean {np.mean(self.abs_df):.4f} "
                f"max {np.max(self.abs_df):.4f}")


def predict_batches(model, prepared: List[Dict], nms_thresh: float):
    """Predict and NMS every prepared eval batch on the model's device,
    then fetch them -> [(pred_cls, boxes, keep, records)] numpy per batch,
    padding rows included (every rank's, under a mesh)."""
    num_scales = _num_scales_of(model)
    pending = [(gather_rows(e, *predict_nms(
                    model, e["tb"]["seq"], e["tb"]["mask"], e["tb"]["lens"],
                    num_scales, nms_thresh, e["tb"].get("motion"),
                    e["tb"].get("motion_mask"))),
                e["records"]) for e in prepared]
    return [tuple(t.cpu().numpy() for t in out) + (records,)
            for out, records in pending]


def summarize_host(batches, knapsack_audit: Optional[KnapsackAudit] = None,
                   per_video: Optional[List[Dict]] = None):
    """Host summaries of ``predict_batches``' output -> (mean F, mean
    diversity): each video's kept boxes sorted stably by score (highest
    first), rasterised and packed by ``bbox2summary``, scored against its
    users."""
    stats = AverageMeter("fscore", "diversity")
    for pred_cls, boxes, keeps, records in batches:
        for i, record in enumerate(records):
            seq_len = record.seq.shape[0]
            keep_idx = np.where(keeps[i])[0]
            order = np.argsort(pred_cls[i][keep_idx], kind="stable")[::-1]
            keep_idx = keep_idx[order]
            kept_cls = pred_cls[i][keep_idx]
            kept_boxes = boxes[i][keep_idx].round().astype(np.int32)

            pred_summ = summ_ops.bbox2summary(
                seq_len, kept_cls, kept_boxes, record.cps, record.n_frames,
                record.nfps, record.picks)
            eval_metric = "avg" if "tvsum" in record.key else "max"
            if knapsack_audit is not None:
                knapsack_audit.check(record, kept_cls, kept_boxes,
                                     eval_metric, pred_summ)
            fscore = summ_ops.get_summ_f1score(
                pred_summ, record.user_summary, eval_metric)
            diversity = summary_diversity(pred_summ, record.seq)
            stats.update(fscore=fscore, diversity=diversity)
            if per_video is not None:
                per_video.append({"key": record.key, "fscore": fscore,
                                  "diversity": diversity,
                                  "summary": pred_summ})
    return stats.fscore, stats.diversity


def evaluate(model, records: List[VideoRecord], nms_thresh: float,
             batch_size: int = 4, bucket_size: int = 64,
             prepared: Optional[List[Dict]] = None,
             knapsack_audit: Optional[KnapsackAudit] = None,
             per_video: Optional[List[Dict]] = None):
    """Host evaluator -> (mean F, mean diversity).

    The batches are the device evaluator's (``prepared``, or padded from
    ``records``), predicted and NMS'd on the device; the summaries and
    scores are made on the host in float64 (``summarize_host``).  A list
    given as ``per_video`` receives one dict per video, as
    ``evaluate_on_device``'s does."""
    if prepared is None:
        prepared = prepare_eval_batches(records, batch_size, bucket_size,
                                        _device_of(model),
                                        model_needs_motion(model))
    return summarize_host(predict_batches(model, prepared, nms_thresh),
                          knapsack_audit, per_video)


def eval_mesh(args):
    """The mesh the device evaluator splits rows over (JAX's
    ``make_mesh(--num-devices)``, with its ValueError), or the ring mesh
    that ``configure_context_parallel`` registered, whose seq ranks share
    their rows."""
    from edsnet_torch.models.base import RING_DISABLED, get_ring_mesh
    mesh = make_mesh(args.num_devices)
    ring = get_ring_mesh()
    return mesh if ring is None or ring is RING_DISABLED else ring[0]


def main(argv=None):
    args = config_lib.get_arguments(argv)
    device = setup(args)
    if args.context_parallel:
        from edsnet_torch.models.base import configure_context_parallel
        configure_context_parallel(args.context_parallel, args.cp_min_len)
    writer = is_writer()
    if writer:
        config_lib.init_logger(args.model_dir, args.log_file)
    config_lib.set_random_seed(args.seed)
    logger.info(vars(args))

    model = get_model(args.model, **vars(args)).to(device).eval()
    mesh = None      # the device evaluator's, built at its first use

    for split_path in args.splits:
        split_path = Path(split_path)
        splits = load_yaml(split_path)
        stats = AverageMeter("fscore", "diversity")

        for split_idx, split in enumerate(splits):
            # the audit compares host solvers, so it rides the host path
            audit = KnapsackAudit() if args.knapsack_audit else None
            if audit is not None or args.host_eval:
                eval_fn, eval_kwargs = evaluate, {"knapsack_audit": audit}
            else:
                mesh = mesh or eval_mesh(args)
                eval_fn, eval_kwargs = evaluate_on_device, {"mesh": mesh}
            fscore, diversity = eval_fold_from_checkpoint(
                args, model, split_path, split_idx, split["test_keys"],
                eval_fn=eval_fn, **eval_kwargs)
            if audit is not None:
                _report(audit.report(), writer)
            stats.update(fscore=fscore, diversity=diversity)
            _report(f"{split_path.stem} split {split_idx}: diversity: "
                    f"{diversity:.4f}, F-score: {fscore:.4f}", writer)

        _report(f"{split_path.stem}: diversity: {stats.diversity:.4f}, "
                f"F-score: {stats.fscore:.4f}", writer)


def _report(msg: str, writer: bool) -> None:
    """Log and print a result line (rank 0 only under a mesh)."""
    if writer:
        logger.info(msg)
        print(msg)


def eval_fold_from_checkpoint(args, model, split_path, fold_idx: int,
                              test_keys, eval_fn=evaluate_on_device,
                              **eval_kwargs):
    """Restore one fold's checkpoint into ``model`` and evaluate it on its
    test keys, read from the h5 files (``eval_checkpoint``) ->
    ``(fscore, diversity)``."""
    val_set = VideoDataset(test_keys, args.data_root)
    try:
        records = [val_set[i] for i in range(len(val_set))]
    finally:
        val_set.close()
    return eval_checkpoint(args, model,
                           get_ckpt_path(args.model_dir, split_path,
                                         fold_idx),
                           records, eval_fn, **eval_kwargs)


def eval_checkpoint(args, model, ckpt_path, records: List[VideoRecord],
                    eval_fn=evaluate_on_device, **eval_kwargs):
    """Restore the checkpoint at ``ckpt_path`` into ``model`` and evaluate
    it on ``records`` with ``eval_fn`` (the device evaluator, or the host
    ``evaluate``) -> ``(fscore, diversity)``.  A motion head takes the
    checkpoint's motion width, and raises if the videos' differs."""
    ckpt_lib.load_checkpoint(model, ckpt_path)
    model.eval()
    if model_needs_motion(model):
        # a clear message instead of a shape error in the key projection
        widths = {r.motion_features.shape[-1] for r in records
                  if r.motion_features is not None}
        w_ckpt = checkpoint_motion_width(model.state_dict())
        if widths and widths != {w_ckpt}:
            raise ValueError(
                f"h5 motion_features are {sorted(widths)}-wide but the "
                f"checkpoint's cross-attention expects width {w_ckpt}")
    return eval_fn(model, records, args.nms_thresh,
                   batch_size=max(args.batch_size, 1),
                   bucket_size=args.bucket_size, **eval_kwargs)


if __name__ == "__main__":
    main()
