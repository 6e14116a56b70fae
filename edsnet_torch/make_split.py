"""Train/test split generator over an h5 dataset.

Counterpart of edsnet_tpu/make_split.py, the same flags and the same yaml
for the same ``--seed``: ``--num-splits`` random 80/20 shuffles (``--method
random``) or a cross-validation partition whose test chunks cover every
video (``--method cross``); with ``--extra-datasets`` every fold's train
side also takes all the videos of the extra h5 files (the reference's aug
and transfer settings), shuffled in.  The draws come from an isolated
``random.Random(--seed)``.  ``yaml`` is imported when the file is written.

    python -m edsnet_torch.make_split --dataset DATA.h5 --save-path x.yml \
        [--method cross] [--extra-datasets A.h5 B.h5] [--seed 0]
"""
from __future__ import annotations

import argparse
import random
from pathlib import Path
from typing import Dict, List

from edsnet_torch.data.h5io import dataset_keys


def _fold(universe: List[str], test_keys: List[str]) -> Dict[str, list]:
    return {"train_keys": sorted(set(universe) - set(test_keys)),
            "test_keys": list(test_keys)}


def random_folds(keys: List[str], n_test: int, n_folds: int,
                 rng: random.Random) -> List[Dict[str, list]]:
    """Independent shuffles; the first ``n_test`` of each are the test
    side."""
    folds = []
    pool = list(keys)
    for _ in range(n_folds):
        rng.shuffle(pool)
        folds.append(_fold(pool, pool[:n_test]))
    return folds


def crossval_folds(keys: List[str], n_test: int,
                   rng: random.Random) -> List[Dict[str, list]]:
    """One shuffle, then disjoint test chunks of ``n_test`` covering every
    video."""
    pool = list(keys)
    rng.shuffle(pool)
    return [_fold(pool, pool[lo:lo + n_test])
            for lo in range(0, len(pool), n_test)]


def augment_train_side(folds: List[Dict[str, list]],
                       extra_keys: List[str], rng: random.Random) -> None:
    """Append ``extra_keys`` to every fold's train side, then shuffle it."""
    for fold in folds:
        fold["train_keys"] = fold["train_keys"] + list(extra_keys)
        rng.shuffle(fold["train_keys"])


def main(argv=None):
    import yaml

    parser = argparse.ArgumentParser(
        description="Generate train/test split yaml for an h5 dataset")
    parser.add_argument("--dataset", type=str, required=True,
                        help="Path to h5 dataset")
    parser.add_argument("--extra-datasets", type=str, nargs="+", default=[],
                        help="Extra h5 files merged into every train side")
    parser.add_argument("--save-path", type=str, required=True,
                        help="Where to write the split yaml")
    parser.add_argument("--num-splits", type=int, default=5)
    parser.add_argument("--train-ratio", type=float, default=0.8)
    parser.add_argument("--method", type=str, default="random",
                        choices=["random", "cross"])
    parser.add_argument("--seed", type=int, default=None)
    args = parser.parse_args(argv)

    rng = random.Random(args.seed)
    keys = dataset_keys(args.dataset)
    n_test = len(keys) - round(len(keys) * args.train_ratio)

    if args.method == "random":
        folds = random_folds(keys, n_test, args.num_splits, rng)
    else:
        folds = crossval_folds(keys, n_test, rng)

    extra = [k for path in args.extra_datasets for k in dataset_keys(path)]
    if extra:
        augment_train_side(folds, extra, rng)

    out = Path(args.save_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(yaml.dump(folds))
    print(f"Wrote {len(folds)} folds ({len(keys)} videos, "
          f"{n_test} test each) -> {out}")


if __name__ == "__main__":
    main()
