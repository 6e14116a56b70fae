"""Train CLI: every fold of every split file, with the F-scores recorded.

Counterpart of edsnet_tpu/train.py: the flags snapshot in
``{model_dir}/args.yml``, one best checkpoint per fold under
``{model_dir}/checkpoint/{split}.{idx}.pt``, and ``{model_dir}/{stem}.yml``
with each fold's best F-score and their mean.  Runs on CUDA unless
``--device cpu``; under ``torchrun`` one rank per card (``gloo`` ranks
with ``--device cpu``), each rank a device of the mesh that
``--num-devices``, ``--tensor-parallel`` and ``--context-parallel`` lay
out (trainer.py); rank 0 writes the files and prints.

    python -m edsnet_torch.train anchor-based --splits splits/x.yml \
        --model-dir MODEL_DIR --data-root DATA_DIR
    torchrun --nproc-per-node 4 -m edsnet_torch.train anchor-based \
        --splits splits/x.yml --model-dir MODEL_DIR --data-root DATA_DIR \
        --num-devices 4 [--tensor-parallel 2] [--context-parallel 2]
"""
from __future__ import annotations

import logging
from pathlib import Path

from edsnet_torch import config as config_lib
from edsnet_torch.data.dataset import (dump_yaml, get_ckpt_dir, get_ckpt_path,
                                       load_yaml)
from edsnet_torch.evaluate import check_train_supported, setup
from edsnet_torch.parallel.mesh import is_writer
from edsnet_torch.trainer import train

logger = logging.getLogger()


def train_split_file(args, split_path: Path) -> dict:
    """Train every fold of one split yaml -> {split<i>: F, mean: F}."""
    folds = load_yaml(split_path)
    scores = []
    for fold_idx, fold in enumerate(folds):
        logger.info(f"[{split_path.stem}] training fold "
                    f"{fold_idx + 1}/{len(folds)}")
        ckpt_path = get_ckpt_path(args.model_dir, split_path, fold_idx)
        best_fscore, _, _ = train(args, fold, ckpt_path)
        logger.info(f"[{split_path.stem}] fold {fold_idx} best F-score "
                    f"{best_fscore:.4f}")
        scores.append(float(best_fscore))

    results = {f"split{i}": s for i, s in enumerate(scores)}
    results["mean"] = sum(scores) / max(len(scores), 1)
    return results


def main(argv=None):
    args = config_lib.get_arguments(argv)
    setup(args, check_train_supported)
    if args.context_parallel:
        # the trainer registers its own tp-aware ring mesh; this bakes the
        # flag into the attention modules built from here on
        from edsnet_torch.models.base import configure_context_parallel
        configure_context_parallel(args.context_parallel, args.cp_min_len)
    writer = is_writer()
    if writer:
        config_lib.init_logger(args.model_dir, args.log_file)
    config_lib.set_random_seed(args.seed)
    logger.info(vars(args))

    model_dir = Path(args.model_dir)
    if writer:
        get_ckpt_dir(model_dir).mkdir(parents=True, exist_ok=True)
        dump_yaml(vars(args), model_dir / "args.yml")

    for split_path in map(Path, args.splits):
        results = train_split_file(args, split_path)
        if writer:
            dump_yaml(results, model_dir / f"{split_path.stem}.yml")
            msg = (f"{split_path.stem}: sweep finished, mean F-score "
                   f"{results['mean']:.4f}")
            logger.info(msg)
            print(msg)


if __name__ == "__main__":
    main()
