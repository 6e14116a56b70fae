"""Training loop, for both heads, on one device or over a mesh of ranks.

Counterpart of edsnet_tpu/trainer.py:train:
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
- ``--profile`` turns the tracer (utils/profiling.py) on for each fold and
  traces epoch 1 with ``torch.profiler`` into ``{model_dir}/profile``,
  the program's spans in the trace; nothing waits for the device per step:
  the frames/s it logs are over the train steps' fenced device time, and a
  line of every span's and counter's totals follows.

The tracer's spans here: ``trainer/fold`` (a ``train_records`` call),
``trainer/setup`` (up to the first epoch; children ``.items``, ``.model``,
``.eval_batches``, ``.pools``), ``trainer/epoch_plan`` and
``trainer/validation`` (fenced); the counters ``steps.steps`` and
``steps.positions`` (valid positions) per train step.

``train`` reads a split's videos from the h5 files; ``train_records`` takes
the videos in memory.

The mesh block is JAX's (parallel/mesh.py): ``--num-devices`` ranks on a
``('data',)`` mesh, or ``('data', 'model')`` with ``--tensor-parallel``
(the attention heads split, parallel/tensor_parallel.py), and
``--context-parallel`` registers a ``('data', 'seq'[, 'model'])`` ring
mesh over the same ranks for the validation's attention, clamped to the
ranks tp leaves, and off with a warning below 2.  Batches pad to a
multiple of the data axis (``--pad-batch-to`` above it keeps shapes and
random streams whatever the mesh); each rank steps on its block of rows
and evaluates its block of the validation rows.  Every rank composes the
same epochs from the same seeds; rank 0 writes the checkpoint and the
``.state`` file, which hold the full ``state_dict`` under any mesh.
Without a process group the mesh is this process alone and every step is
the one-device step.
"""
from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from edsnet_torch.data import batching
from edsnet_torch.data.dataset import AverageMeter, VideoDataset, VideoRecord
from edsnet_torch.evaluate import check_train_supported, evaluate, setup
from edsnet_torch.models.common import (init_weights, set_dropout_generator,
                                        shard_dropout_rows)
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel.eval_device import (eval_fscore_device,
                                               model_needs_motion,
                                               prepare_eval_batches)
from edsnet_torch.parallel.mesh import (Mesh, make_dp_tp_mesh, make_mesh,
                                        make_ring_mesh, replicate,
                                        shard_batch, shard_rows, world)
from edsnet_torch.parallel.steps import (ab_train_step, af_train_step,
                                         data_rows, make_optimizer)
from edsnet_torch.parallel.tensor_parallel import shard_params_tp
from edsnet_torch.utils import checkpoint as ckpt_lib
from edsnet_torch.utils import profiling
from edsnet_torch.utils.profiling import maybe_trace

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


def training_mesh(args) -> Tuple[Mesh, Mesh]:
    """(the training mesh, the mesh validation rows split over): JAX's
    mesh block, with its warnings and ValueError texts.  The second is
    the registered ring mesh when ``--context-parallel`` gets one (rows
    over its ``data`` axis, replicated within a seq group), else the
    training mesh."""
    from edsnet_torch.models.base import (disable_ring_attention,
                                          set_ring_mesh)
    tp = int(args.tensor_parallel or 0)
    if tp > 1:
        total = args.num_devices or world()[1]
        if total % tp:
            raise ValueError(f"--tensor-parallel {tp} must divide the "
                             f"device count {total}")
        mesh = make_dp_tp_mesh(total // tp, tp)
    else:
        mesh = make_mesh(args.num_devices)
    cp = int(args.context_parallel or 0)
    if not cp:
        return mesh, mesh
    seq_cap = mesh.size // max(tp, 1)   # ranks left for the ring
    cp_eff = min(cp, seq_cap) if cp > 0 else seq_cap
    if cp_eff < 2:
        logger.warning(
            f"--context-parallel {cp}: ring attention needs >=2 "
            f"sequence-axis devices but only {mesh.size} device(s) "
            f"are available" + (f" with --tensor-parallel {tp}"
                                if tp > 1 else "")
            + "; ring attention stays off")
        disable_ring_attention()
        return mesh, mesh
    if 0 < cp != cp_eff:
        logger.warning(f"--context-parallel {cp} clamped to {cp_eff} "
                       f"({mesh.size} device(s)"
                       + (f", {tp} on the tensor axis" if tp > 1 else "")
                       + ")")
    ring = make_ring_mesh(cp_eff, tp, num_devices=mesh.size)
    set_ring_mesh(ring, "seq", batch_axis="data",
                  head_axis="model" if tp > 1 else None)
    return mesh, ring


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
    # --profile traces the fold, unless the tracer is on already
    owned = args.profile and not profiling.enabled()
    if owned:
        profiling.reset()
        profiling.enable()
    try:
        with profiling.span("trainer/fold"), contextlib.ExitStack() as phase:
            phase.enter_context(profiling.span("trainer/setup"))
            out = _train_fold(args, train_videos, val_videos, save_path,
                              phase.close)
        if args.profile:
            snap = profiling.snapshot()
            logger.info(f"train throughput: {_throughput(snap)}")
            logger.info(f"trace: {profiling.summary(snap)}")
        return out
    finally:
        if owned:
            profiling.disable()


def _throughput(snap: Dict) -> Dict[str, float]:
    """Frames (valid positions) trained per second of the train steps'
    fenced time, from a tracer snapshot."""
    frames = snap["counters"].get("steps.positions", 0)
    seconds = snap["spans"].get("steps/train_step",
                                {"fenced_ms": 0.0})["fenced_ms"] / 1e3
    return {"frames": frames, "seconds": round(seconds, 4),
            "steps": snap["counters"].get("steps.steps", 0),
            "frames_per_sec": round(frames / seconds if seconds else 0.0, 2)}


def _train_fold(args, train_videos: Sequence[VideoRecord],
                val_videos: Sequence[VideoRecord], save_path, setup_done
                ) -> Tuple[float, List[float], List[int]]:
    """``train_records``' work; ``setup_done()`` ends the set-up span."""
    device = setup(args, check_train_supported)
    # --compute-dtype auto means float32 here: the TPU package picks bf16
    # only on a TPU backend
    compute_dtype = ("float32" if args.compute_dtype == "auto"
                     else args.compute_dtype)
    if compute_dtype != "float32":
        logger.info(f"compute dtype: {compute_dtype} "
                    f"(--compute-dtype float32 to opt out)")
    with profiling.span("trainer/setup.model"):
        model = get_model(args.model, **vars(args))
    need_motion = model_needs_motion(model)

    with profiling.span("trainer/setup.items"):
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
    mesh, eval_mesh = training_mesh(args)
    with profiling.span("trainer/setup.model"):
        init_weights(model, torch.Generator().manual_seed(args.seed))
        model = model.to(device)
        replicate(list(model.state_dict().values()), mesh)
        layout = None
        tp = int(args.tensor_parallel or 0)
        if tp > 1:
            layout = shard_params_tp(model, mesh, args.num_head)
            if not layout.specs:
                logger.warning(f"--tensor-parallel {tp} has no effect: base "
                               f"model '{args.base_model}' has no attention "
                               f"modules")
    rows = data_rows(mesh)
    if rows is not None:
        shard_dropout_rows(model, *rows)
    with profiling.span("trainer/setup.eval_batches"):
        prepared_eval = prepare_eval_batches(
            list(val_videos), max(args.batch_size, 1), args.bucket_size,
            device, need_motion, mesh=eval_mesh)

    rng = np.random.RandomState(args.seed)
    generators = {
        "dropout": torch.Generator(device=device).manual_seed(args.seed + 1),
        "label": torch.Generator(device=device).manual_seed(args.seed + 2)}
    set_dropout_generator(model, generators["dropout"])
    optimizer = make_optimizer(model.parameters(), args.lr, args.weight_decay)
    # batch rows, a multiple of this: the data axis, or the multiple of it
    # that --pad-batch-to fixes above it
    mesh_n = mesh.shape["data"]
    pad_to = -(-max(args.pad_batch_to, mesh_n) // mesh_n) * mesh_n
    # without a process group the step is the one-device step
    step_mesh = {"mesh": mesh} if mesh.distributed else {}

    max_val_fscore = -1.0
    start_epoch = 0
    state_path = Path(str(save_path) + ".state")
    if args.resume and state_path.exists():
        start_epoch, max_val_fscore, extras = ckpt_lib.load_train_state(
            model, optimizer, state_path, layout)
        if "np_rng" in extras:
            ckpt_lib.restore_np_rng(rng, extras["np_rng"])
        for name, state in extras.get("generators", {}).items():
            generators[name].set_state(state)
        logger.info(f"resumed from {state_path} at epoch {start_epoch} "
                    f"(best F-score {max_val_fscore:.4f})")

    def whole(state):
        """What a checkpoint holds of a module or a state_dict: the full
        state_dict, gathered over the model ranks under tp."""
        if layout is None:
            return state
        if isinstance(state, torch.nn.Module):
            state = state.state_dict()
        return layout.gather_state(state)

    def save_state(epoch: int, best: float) -> None:
        ckpt_lib.save_train_state(model, optimizer, epoch, best, state_path,
                                  np_rng=rng, generators=generators,
                                  layout=layout)

    with profiling.span("trainer/setup.pools"):
        if args.static_batches:
            device_batches = [
                (shard_batch(to_device(b, device), mesh),
                 int(b["mask"].sum()))
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
    last_sync_t, last_sync_epoch = time.time(), start_epoch - 1
    eval_every = max(args.eval_every, 1)
    profile_dir = str(Path(args.model_dir) / "profile")
    setup_done()

    for epoch in range(start_epoch, args.max_epoch):
        start = time.time()
        with maybe_trace(args.profile and epoch == 1, profile_dir):
            with profiling.span("trainer/epoch_plan"):
                if args.static_batches:
                    todo = [device_batches[i]
                            for i in rng.permutation(len(device_batches))]
                else:
                    todo = [({"pool": device_pools[pi],
                              "gather_idx": shard_rows(
                                  torch.from_numpy(idx), mesh).to(device),
                              "video_valid": shard_rows(
                                  torch.from_numpy(valid), mesh).to(device)},
                             frames)
                            for pi, idx, valid, frames in compose_epoch()]
            for batch, frames in todo:
                if args.model == "anchor-based":
                    metrics = ab_train_step(
                        model, optimizer, batch, generators["label"],
                        lambda_reg=args.lambda_reg,
                        neg_ratio=args.neg_sample_ratio,
                        inc_ratio=args.incomplete_sample_ratio,
                        remat=args.remat, compute_dtype=compute_dtype,
                        **step_mesh)
                else:
                    metrics = af_train_step(
                        model, optimizer, batch, lambda_reg=args.lambda_reg,
                        lambda_ctr=args.lambda_ctr, cls_kind=args.cls_loss,
                        reg_kind=args.reg_loss, remat=args.remat,
                        compute_dtype=compute_dtype, **step_mesh)
                epoch_metrics.append(metrics)
                profiling.count("steps.steps", 1)
                profiling.count("steps.positions", frames)

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
                ckpt_lib.save_checkpoint(whole(best_state), save_path)
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
                ckpt_lib.save_checkpoint(whole(model), save_path)
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
        with profiling.span("trainer/validation", fence=device):
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
                ckpt_lib.save_checkpoint(whole(best_state), save_path)
                flushed_best = best
            if args.resume:
                save_state(epoch + 1, best)

    if not args.host_eval:
        # the one end-of-training sync of the device path
        f1_list = [float(v) for v in fscore_hist]
        best = float(best_f)
        max_val_fscore = max(max_val_fscore, best)
        if best > flushed_best:
            ckpt_lib.save_checkpoint(whole(best_state), save_path)
        if args.resume:
            save_state(args.max_epoch, max_val_fscore)
    if time_list:
        t = np.asarray(time_list)
        logger.info(f"avg time taken: {t.mean():.3f} "
                    f"max time taken: {t.max():.3f} "
                    f"min time taken: {t.min():.3f}")
    return max_val_fscore, f1_list, epoch_list
