"""Evaluation CLI: checkpoint -> predict -> NMS -> keyshot summary ->
F-score, per split.

Counterpart of edsnet_tpu/evaluate.py:main and eval_fold_from_checkpoint on
the device evaluator (parallel/eval_device.py).  Same flags, the same
``{model_dir}/checkpoint/{split}.{idx}.pt`` contract (torch or flax
checkpoints), the same printed lines, ``avg`` F over users on tvsum keys
and ``max`` elsewhere.

    python -m edsnet_torch.evaluate anchor-based --splits splits/x.yml \
        --model-dir MODEL_DIR --data-root DATA_DIR
    python -m edsnet_torch.evaluate anchor-free --model-depth deep ...
"""
from __future__ import annotations

import logging
from pathlib import Path

import torch

from edsnet_torch import config as config_lib
from edsnet_torch.data.dataset import (AverageMeter, VideoDataset,
                                       get_ckpt_path, load_yaml)
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel.eval_device import evaluate_on_device
from edsnet_torch.utils import checkpoint as ckpt_lib

logger = logging.getLogger()


def resolve_device(name: str) -> torch.device:
    """``auto`` and ``gpu`` mean CUDA and raise without a GPU; ``cpu`` is
    for tests."""
    if name == "cpu":
        return torch.device("cpu")
    if name in ("auto", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA GPU found (pass "
                               f"--device cpu to run on the CPU)")
        return torch.device("cuda")
    raise ValueError(f"--device {name} is not served by the PyTorch port "
                     f"(choose auto, gpu or cpu)")


def _todo(flag, item):
    raise NotImplementedError(f"{flag} is not ported yet (ROADMAP.md Queue "
                              f"A item {item})")


def check_model_supported(args) -> None:
    """Raise for model, precision and device-layout flags that no CLI of
    this port serves yet."""
    if args.context_parallel:
        _todo("--context-parallel", 13)
    if args.tensor_parallel > 1:
        _todo("--tensor-parallel", 13)
    if args.num_devices > 1:
        _todo("--num-devices > 1", 13)
    if args.model == "anchor-based" and args.model_depth == "cross-attention":
        # the motion head; anchor-free has no such depth (get_model's
        # ValueError, as in JAX)
        _todo("--model-depth cross-attention", 10)
    if args.matmul_precision == "bfloat16":
        _todo("--matmul-precision bfloat16", 14)


def check_supported(args) -> None:
    """Raise for flags whose paths the evaluate CLI does not serve yet."""
    check_model_supported(args)
    if args.host_eval:
        _todo("--host-eval", 6)
    if args.knapsack_audit:
        _todo("--knapsack-audit", 6)


def check_train_supported(args) -> None:
    """Raise for flags whose paths the train CLI does not serve yet."""
    check_model_supported(args)
    if args.resume:
        _todo("--resume", 6)
    if args.state_save_every:
        _todo("--state-save-every", 6)
    if args.profile:
        _todo("--profile", 7)
    if args.host_eval:
        _todo("--host-eval", 6)


# --matmul-precision values that allow TF32 (JAX's jax_default_matmul_
# precision on the GPU); float32, highest and no flag keep full f32
TF32_PRECISIONS = ("tensorfloat32", "high", "default")


def setup(args, check=check_supported) -> torch.device:
    """Entry-point setup shared by the CLIs: the CLI's ``check`` of its
    flags, the device, and the precision of f32 products from
    ``--matmul-precision``: cuBLAS's and cuDNN's TF32 switches both on for
    ``TF32_PRECISIONS``, both off otherwise, so that results compare with
    f32 references.  The flash kernels keep their own ``precision``."""
    check(args)
    device = resolve_device(args.device)
    tf32 = args.matmul_precision in TF32_PRECISIONS
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return device


def main(argv=None):
    args = config_lib.get_arguments(argv)
    device = setup(args)
    config_lib.init_logger(args.model_dir, args.log_file)
    config_lib.set_random_seed(args.seed)
    logger.info(vars(args))

    model = get_model(args.model, **vars(args)).to(device).eval()

    for split_path in args.splits:
        split_path = Path(split_path)
        splits = load_yaml(split_path)
        stats = AverageMeter("fscore", "diversity")

        for split_idx, split in enumerate(splits):
            fscore, diversity = eval_fold_from_checkpoint(
                args, model, split_path, split_idx, split["test_keys"])
            stats.update(fscore=fscore, diversity=diversity)
            msg = (f"{split_path.stem} split {split_idx}: diversity: "
                   f"{diversity:.4f}, F-score: {fscore:.4f}")
            logger.info(msg)
            print(msg)

        msg = (f"{split_path.stem}: diversity: {stats.diversity:.4f}, "
               f"F-score: {stats.fscore:.4f}")
        logger.info(msg)
        print(msg)


def eval_fold_from_checkpoint(args, model, split_path, fold_idx: int,
                              test_keys):
    """Restore one fold's checkpoint into ``model`` and evaluate it on its
    test keys -> ``(fscore, diversity)``."""
    ckpt_path = get_ckpt_path(args.model_dir, split_path, fold_idx)
    ckpt_lib.load_checkpoint(model, ckpt_path)
    model.eval()
    val_set = VideoDataset(test_keys, args.data_root)
    try:
        records = [val_set[i] for i in range(len(val_set))]
    finally:
        val_set.close()
    return evaluate_on_device(model, records, args.nms_thresh,
                              batch_size=max(args.batch_size, 1),
                              bucket_size=args.bucket_size)


if __name__ == "__main__":
    main()
