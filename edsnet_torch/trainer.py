"""Training loop on one device, for both heads.

Counterpart of edsnet_tpu/trainer.py:train, without a mesh, resume or the
host evaluator:
- every video's labels are prepared once (data/batching.py); the videos are
  uploaded once, grouped by length bucket into pools, and each epoch's
  batches are composed on the device by a gather (``compose_epoch``), or
  frozen with ``--static-batches``;
- the step (parallel/steps.py: ``ab_train_step`` or ``af_train_step``, by
  the model type) queues its work and returns device tensors;
- every ``--eval-every`` epochs the device evaluator scores the validation
  videos (the model in eval mode, so the attention backbone takes the flash
  kernel on CUDA); the best parameters are kept on the device, and the host
  waits for the device only at logging epochs (every 30 anchor-based, 20
  anchor-free, as in JAX) and at the end,
  where the best checkpoint is written to
  ``{model_dir}/checkpoint/{split}.{idx}.pt``.

``train`` reads a split's videos from the h5 files; ``train_records`` takes
the videos in memory.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from edsnet_torch.data import batching
from edsnet_torch.data.dataset import AverageMeter, VideoDataset, VideoRecord
from edsnet_torch.evaluate import check_train_supported, setup
from edsnet_torch.models.common import init_weights, set_dropout_generator
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel.eval_device import (eval_fscore_device,
                                               prepare_eval_batches)
from edsnet_torch.parallel.steps import (ab_train_step, af_train_step,
                                         make_optimizer)
from edsnet_torch.utils import checkpoint as ckpt_lib
from edsnet_torch.utils.profiling import StepTimer

logger = logging.getLogger()

# epochs between host syncs (logging, checkpoint flush), per model type
LOG_EVERY = {"anchor-based": 30, "anchor-free": 20}


def _read_records(keys, data_root) -> List[VideoRecord]:
    dataset = VideoDataset(keys, data_root)
    try:
        return [dataset[i] for i in range(len(dataset))]
    finally:
        dataset.close()


def to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The numpy arrays of a batch as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def train(args, split, save_path) -> Tuple[float, List[float], List[int]]:
    """Train one split read from the h5 files -> (max_val_fscore, f1_list,
    epoch_list)."""
    return train_records(args, _read_records(split["train_keys"],
                                             args.data_root),
                         _read_records(split["test_keys"], args.data_root),
                         save_path)


def train_records(args, train_videos: Sequence[VideoRecord],
                  val_videos: Sequence[VideoRecord], save_path
                  ) -> Tuple[float, List[float], List[int]]:
    """Train on ``train_videos``, validate on ``val_videos`` and write the
    best checkpoint to ``save_path`` -> (max_val_fscore, f1_list,
    epoch_list)."""
    device = setup(args, check_train_supported)
    # --compute-dtype auto means float32 here: the TPU package picks bf16
    # only on a TPU backend
    compute_dtype = ("float32" if args.compute_dtype == "auto"
                     else args.compute_dtype)
    if compute_dtype != "float32":
        logger.info(f"compute dtype: {compute_dtype} "
                    f"(--compute-dtype float32 to opt out)")
    model = get_model(args.model, **vars(args))
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)

    items = batching.prepare_items(
        train_videos, args.model, anchor_scales=args.anchor_scales,
        pos_iou=args.pos_iou_thresh, neg_iou=args.neg_iou_thresh,
        inc_iou=args.incomplete_iou_thresh, bucket_size=args.bucket_size)
    skipped = len(train_videos) - len(items)
    if skipped:
        logger.info(f"skipped {skipped} videos (NaN gtscore / empty target)")
    if not items:
        raise ValueError(
            "no trainable videos: every video was skipped (NaN gtscore or "
            "empty keyshot target at the 15% budget)")
    prepared_eval = prepare_eval_batches(
        list(val_videos), max(args.batch_size, 1), args.bucket_size, device)

    rng = np.random.RandomState(args.seed)
    set_dropout_generator(
        model, torch.Generator(device=device).manual_seed(args.seed + 1))
    label_gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    pad_to = max(args.pad_batch_to, 1)   # batch rows, a multiple of this

    if args.static_batches:
        device_batches = [
            (to_device(b, device), int(b["mask"].sum()))
            for b in batching.batch_items(items, args.batch_size,
                                          args.bucket_size, shuffle=False,
                                          pad_batch_to=pad_to)]
    else:
        pools = batching.pool_items(items, args.bucket_size)
        pool_lengths = [p["mask"].sum(axis=1) for p in pools]
        device_pools = [to_device(p, device) for p in pools]

    def compose_epoch():
        """Host plan of an epoch: (pool id, gather_idx, video_valid,
        frames) per batch, each pool's videos reshuffled."""
        plan = []
        for pi, pool in enumerate(pools):
            count = pool["video_valid"].shape[0]
            perm = rng.permutation(count)
            for lo in range(0, count, args.batch_size):
                chunk = perm[lo:lo + args.batch_size]
                b_pad = -(-len(chunk) // pad_to) * pad_to
                idx = np.zeros(b_pad, np.int64)
                idx[:len(chunk)] = chunk
                valid = np.zeros(b_pad, bool)
                valid[:len(chunk)] = True
                plan.append((pi, idx, valid,
                             int(pool_lengths[pi][chunk].sum())))
        rng.shuffle(plan)
        return plan

    best_state = {k: v.detach().clone()
                  for k, v in model.state_dict().items()}
    best_f = torch.tensor(-1.0, device=device)
    flushed_best = -1.0   # best F already written to disk
    fscore_hist: List[torch.Tensor] = []
    epoch_list: List[int] = []
    time_list: List[float] = []
    epoch_metrics: List[Dict[str, torch.Tensor]] = []
    timer = StepTimer()
    last_sync_t, last_sync_epoch = time.time(), -1
    eval_every = max(args.eval_every, 1)

    for epoch in range(args.max_epoch):
        start = time.time()
        if args.static_batches:
            todo = [device_batches[i]
                    for i in rng.permutation(len(device_batches))]
        else:
            todo = [({"pool": device_pools[pi],
                      "gather_idx": torch.from_numpy(idx).to(device),
                      "video_valid": torch.from_numpy(valid).to(device)},
                     frames)
                    for pi, idx, valid, frames in compose_epoch()]
        for batch, frames in todo:
            timer.start()
            if args.model == "anchor-based":
                metrics = ab_train_step(
                    model, optimizer, batch, label_gen,
                    lambda_reg=args.lambda_reg,
                    neg_ratio=args.neg_sample_ratio,
                    inc_ratio=args.incomplete_sample_ratio, remat=args.remat,
                    compute_dtype=compute_dtype)
            else:
                metrics = af_train_step(
                    model, optimizer, batch, lambda_reg=args.lambda_reg,
                    lambda_ctr=args.lambda_ctr, cls_kind=args.cls_loss,
                    reg_kind=args.reg_loss, remat=args.remat,
                    compute_dtype=compute_dtype)
            epoch_metrics.append(metrics)
            timer.stop(frames)

        time_list.append(time.time() - start)
        if epoch < 3 or (epoch + 1) % 50 == 0:
            logger.info(f"epoch {epoch} dispatched in {time_list[-1]:.2f}s")
        if (epoch + 1) % eval_every and epoch + 1 != args.max_epoch:
            continue

        # device eval and best-parameter update; nothing waits here
        model.eval()
        val_f = eval_fscore_device(model, prepared_eval, args.nms_thresh)
        improved = val_f > best_f
        with torch.no_grad():
            for k, v in model.state_dict().items():
                best_state[k].copy_(torch.where(improved, v, best_state[k]))
        best_f = torch.maximum(val_f, best_f)
        fscore_hist.append(val_f)
        epoch_list.append(epoch)

        log_every = max(LOG_EVERY[args.model], eval_every)
        if epoch % log_every < eval_every:
            stats = AverageMeter("loss", "cls_loss", "loc_loss", "ctr_loss")
            for m in epoch_metrics:
                stats.update(**{k: float(v) for k, v in m.items()})
            epoch_metrics.clear()
            best = float(best_f)   # waits for the device through the eval
            now = time.time()
            span = epoch - last_sync_epoch
            device_avg = (now - last_sync_t) / max(span, 1)
            last_sync_t, last_sync_epoch = now, epoch
            logger.info(
                f"Epoch: {epoch}/{args.max_epoch} "
                f"Loss: {stats.cls_loss:.4f}/{stats.loc_loss:.4f}"
                f"/{stats.loss:.4f} "
                f"F-score cur/max: {float(val_f):.4f}/{best:.4f} "
                f"Dispatch: {time_list[-1]:.2f}s "
                f"Device: {device_avg:.2f}s/epoch (fenced, avg of {span})")
            if best > flushed_best:
                ckpt_lib.save_checkpoint(best_state, save_path)
                flushed_best = best

    f1_list = [float(v) for v in fscore_hist]
    best = float(best_f)
    if best > flushed_best:
        ckpt_lib.save_checkpoint(best_state, save_path)
    if time_list:
        t = np.asarray(time_list)
        logger.info(f"avg time taken: {t.mean():.3f} "
                    f"max time taken: {t.max():.3f} "
                    f"min time taken: {t.min():.3f}")
    logger.info(f"train throughput: {timer.summary()}")
    return best, f1_list, epoch_list
