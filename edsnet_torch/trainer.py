"""Training loop on one device, for both heads.

Counterpart of edsnet_tpu/trainer.py:train, without a mesh:
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
  ``{model_dir}/checkpoint/{split}.{idx}.pt``;
- ``--host-eval`` validates through the host evaluator instead, every eval
  epoch, and writes the checkpoint whenever the F-score improves;
- ``--resume`` restores ``{checkpoint}.state`` (utils/checkpoint.py: the
  model, Adam, the epoch, the best F-score and all three RNG streams) and
  goes on from its epoch; the snapshot is written at every logging epoch
  (every eval epoch on the host path), every ``--state-save-every`` epochs
  and at the end, and the best F-score it records never runs ahead of the
  checkpoint on disk;
- the motion head (``--model-depth cross-attention``) is built at the
  width of the training videos' motion features, which every training
  video must have; a model without motion drops them from its batches;
- ``--profile`` traces epoch 1 with ``torch.profiler`` into
  ``{model_dir}/profile`` and waits for the device after every step, so the
  frames/s it logs are fenced.

``train`` reads a split's videos from the h5 files; ``train_records`` takes
the videos in memory.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from edsnet_torch.data import batching
from edsnet_torch.data.dataset import AverageMeter, VideoDataset, VideoRecord
from edsnet_torch.evaluate import check_train_supported, evaluate, setup
from edsnet_torch.models.common import init_weights, set_dropout_generator
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel.eval_device import (eval_fscore_device,
                                               model_needs_motion,
                                               prepare_eval_batches)
from edsnet_torch.parallel.steps import (ab_train_step, af_train_step,
                                         make_optimizer)
from edsnet_torch.utils import checkpoint as ckpt_lib
from edsnet_torch.utils.profiling import StepTimer, maybe_trace

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
    need_motion = model_needs_motion(model)

    items = batching.prepare_items(
        train_videos, args.model, anchor_scales=args.anchor_scales,
        pos_iou=args.pos_iou_thresh, neg_iou=args.neg_iou_thresh,
        inc_iou=args.incomplete_iou_thresh, bucket_size=args.bucket_size,
        need_motion=need_motion)
    skipped = len(train_videos) - len(items)
    if skipped:
        logger.info(f"skipped {skipped} videos (NaN gtscore / empty target)")
    if not items:
        raise ValueError(
            "no trainable videos: every video was skipped (NaN gtscore or "
            "empty keyshot target at the 15% budget)")
    if need_motion:
        missing = [it.key for it in items if it.motion is None]
        if missing:
            raise ValueError(
                f"model-depth cross-attention needs 'motion_features' in "
                f"the h5 for every video; missing for {missing[:3]}...")
        # the data's motion width, which flax reads at init
        model.set_motion_width(items[0].motion.shape[-1])
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model = model.to(device)
    prepared_eval = prepare_eval_batches(
        list(val_videos), max(args.batch_size, 1), args.bucket_size, device,
        need_motion)

    rng = np.random.RandomState(args.seed)
    generators = {
        "dropout": torch.Generator(device=device).manual_seed(args.seed + 1),
        "label": torch.Generator(device=device).manual_seed(args.seed + 2)}
    set_dropout_generator(model, generators["dropout"])
    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    pad_to = max(args.pad_batch_to, 1)   # batch rows, a multiple of this

    max_val_fscore = -1.0
    start_epoch = 0
    state_path = Path(str(save_path) + ".state")
    if args.resume and state_path.exists():
        start_epoch, max_val_fscore, extras = ckpt_lib.load_train_state(
            model, optimizer, state_path)
        if "np_rng" in extras:
            ckpt_lib.restore_np_rng(rng, extras["np_rng"])
        for name, state in extras.get("generators", {}).items():
            generators[name].set_state(state)
        logger.info(f"resumed from {state_path} at epoch {start_epoch} "
                    f"(best F-score {max_val_fscore:.4f})")

    def save_state(epoch: int, best: float) -> None:
        ckpt_lib.save_train_state(model, optimizer, epoch, best, state_path,
                                  np_rng=rng, generators=generators)

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
    best_f = torch.tensor(max_val_fscore, device=device)
    flushed_best = max_val_fscore   # best F already written to disk
    fscore_hist: List[torch.Tensor] = []
    f1_list: List[float] = []       # the host path's F-scores
    epoch_list: List[int] = []
    time_list: List[float] = []
    epoch_metrics: List[Dict[str, torch.Tensor]] = []
    timer = StepTimer()
    last_sync_t, last_sync_epoch = time.time(), start_epoch - 1
    eval_every = max(args.eval_every, 1)
    profile_dir = str(Path(args.model_dir) / "profile")

    for epoch in range(start_epoch, args.max_epoch):
        start = time.time()
        with maybe_trace(args.profile and epoch == 1, profile_dir):
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
                        model, optimizer, batch, generators["label"],
                        lambda_reg=args.lambda_reg,
                        neg_ratio=args.neg_sample_ratio,
                        inc_ratio=args.incomplete_sample_ratio,
                        remat=args.remat, compute_dtype=compute_dtype)
                else:
                    metrics = af_train_step(
                        model, optimizer, batch, lambda_reg=args.lambda_reg,
                        lambda_ctr=args.lambda_ctr, cls_kind=args.cls_loss,
                        reg_kind=args.reg_loss, remat=args.remat,
                        compute_dtype=compute_dtype)
                epoch_metrics.append(metrics)
                timer.stop(frames,
                           sync=metrics["loss"] if args.profile else None)

        time_list.append(time.time() - start)
        if epoch < 3 or (epoch + 1) % 50 == 0:
            verb = "trained" if args.host_eval else "dispatched"
            logger.info(f"epoch {epoch} {verb} in {time_list[-1]:.2f}s")
        if (not args.host_eval and args.resume and args.state_save_every > 0
                and (epoch + 1) % args.state_save_every == 0):
            # a tighter crash window than the logging epochs': the snapshot
            # every N epochs, whatever the eval cadence, after flushing the
            # best checkpoint if the device-side best advanced, so that the
            # best F it records has its parameters on disk
            best = float(best_f)
            if best > flushed_best:
                ckpt_lib.save_checkpoint(best_state, save_path)
                flushed_best = best
            save_state(epoch + 1, best)
        if (epoch + 1) % eval_every and epoch + 1 != args.max_epoch:
            continue

        log_every = max(LOG_EVERY[args.model], eval_every)
        should_log = epoch % log_every < eval_every
        model.eval()
        if args.host_eval:
            # the synchronous host path
            stats = AverageMeter("loss", "cls_loss", "loc_loss", "ctr_loss")
            for m in epoch_metrics:
                stats.update(**{k: float(v) for k, v in m.items()})
            epoch_metrics.clear()
            val_f, _ = evaluate(model, list(val_videos), args.nms_thresh,
                                prepared=prepared_eval)
            f1_list.append(val_f)
            epoch_list.append(epoch)
            if max_val_fscore < val_f:
                max_val_fscore = val_f
                ckpt_lib.save_checkpoint(model, save_path)
            if args.resume:
                save_state(epoch + 1, max_val_fscore)
            if should_log:
                logger.info(f"Epoch: {epoch}/{args.max_epoch} "
                            f"Loss: {stats.cls_loss:.4f}/{stats.loc_loss:.4f}"
                            f"/{stats.loss:.4f} "
                            f"F-score cur/max: {val_f:.4f}/"
                            f"{max_val_fscore:.4f} "
                            f"Time: {time_list[-1]:.2f}s")
            continue

        # device eval and best-parameter update; nothing waits here
        val_f = eval_fscore_device(model, prepared_eval, args.nms_thresh)
        improved = val_f > best_f
        with torch.no_grad():
            for k, v in model.state_dict().items():
                best_state[k].copy_(torch.where(improved, v, best_state[k]))
        best_f = torch.maximum(val_f, best_f)
        fscore_hist.append(val_f)
        epoch_list.append(epoch)

        if should_log:
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
            if args.resume:
                save_state(epoch + 1, best)

    if not args.host_eval:
        # the one end-of-training sync of the device path
        f1_list = [float(v) for v in fscore_hist]
        best = float(best_f)
        max_val_fscore = max(max_val_fscore, best)
        if best > flushed_best:
            ckpt_lib.save_checkpoint(best_state, save_path)
        if args.resume:
            save_state(args.max_epoch, max_val_fscore)
    if time_list:
        t = np.asarray(time_list)
        logger.info(f"avg time taken: {t.mean():.3f} "
                    f"max time taken: {t.max():.3f} "
                    f"min time taken: {t.min():.3f}")
    logger.info(f"train throughput: {timer.summary()}")
    return max_val_fscore, f1_list, epoch_list
