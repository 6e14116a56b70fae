"""Paper-benchmark sweep runner: the canonical, augmented and transfer
settings of the reference's experiment matrix.

Counterpart of edsnet_tpu/sweep.py, with its flags and its frozen JSON
schema: ``config`` (model, paper_config, max_epoch, extra) and
``settings`` -> setting -> split file stem -> ``status`` and either
``fscores`` (per fold and mean), ``diversity``, ``fscores_from_ckpt`` and
``wall_clock_s``, or ``missing`` (the absent h5 files).  Each split file
trains through ``train.train_split_file`` with the paper's headline
configuration (anchor-based, nystromformer, ROI pooling, scale 12) plus
the flags after ``--extra`` (``--device cpu`` among them to run on the
CPU), then every fold's best checkpoint is evaluated once more through
``evaluate.eval_fold_from_checkpoint`` for its diversity and, as a check
that the checkpoint on disk reproduces it, its F-score.  Split files whose
yaml or datasets are missing are reported and skipped.

    python -m edsnet_torch.sweep --data-root /path/to/datasets \
        --output results/paper_sweep.json
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

SETTING_SPLITS = {
    "canonical": ["tvsum.yml", "summe.yml"],
    "aug": ["tvsum_aug.yml", "summe_aug.yml"],
    "transfer": ["tvsum_trans.yml", "summe_trans.yml"],
}

# the paper's headline configuration
PAPER_CONFIG = ["--base-model", "nystromformer", "--pooling-type", "roi",
                "--anchor-scales", "12"]


def missing_datasets(split_path: Path, data_root: str):
    """The h5 files that a split references and ``data_root`` lacks."""
    from edsnet_torch.data.dataset import _resolve_h5, load_yaml

    missing = set()
    for fold in load_yaml(split_path):
        for key in fold.get("train_keys", []) + fold.get("test_keys", []):
            try:
                _resolve_h5(key, data_root)
            except FileNotFoundError:
                missing.add(str(Path(key).parent.name))
    return sorted(missing)


def eval_diversity(train_args, split_path: Path) -> tuple:
    """Per-fold summary diversity of the best checkpoints, and the F-score
    the same pass computes (``fscores_from_ckpt``) -> (diversity with its
    mean, F-scores), each keyed ``split<i>``."""
    from edsnet_torch.data.dataset import load_yaml
    from edsnet_torch.evaluate import eval_fold_from_checkpoint, setup
    from edsnet_torch.models.model_zoo import get_model

    device = setup(train_args)
    model = get_model(train_args.model, **vars(train_args)).to(device)
    divs, ckpt_fs = {}, {}
    for fold_idx, fold in enumerate(load_yaml(split_path)):
        fscore, diversity = eval_fold_from_checkpoint(
            train_args, model, split_path, fold_idx, fold["test_keys"])
        divs[f"split{fold_idx}"] = float(diversity)
        ckpt_fs[f"split{fold_idx}"] = float(fscore)
    vals = list(divs.values())
    divs["mean"] = sum(vals) / max(len(vals), 1)
    return divs, ckpt_fs


def run_sweep(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Run the paper's canonical/aug/transfer benchmark "
                    "matrix and record a results JSON")
    parser.add_argument("--data-root", type=str, required=True,
                        help="directory holding the eccv16 h5 datasets")
    parser.add_argument("--splits-dir", type=str,
                        default=str(Path(__file__).resolve().parent.parent
                                    / "splits"))
    parser.add_argument("--output", type=str,
                        default="paper_sweep_results.json")
    parser.add_argument("--model-root", type=str, default="sweep_models")
    parser.add_argument("--settings", type=str, nargs="+",
                        default=["canonical", "aug", "transfer"],
                        choices=list(SETTING_SPLITS))
    parser.add_argument("--max-epoch", type=int, default=300)
    parser.add_argument("--extra", type=str, nargs=argparse.REMAINDER,
                        default=[],
                        help="extra flags forwarded to the trainer (after "
                             "--extra)")
    args = parser.parse_args(argv)

    from edsnet_torch import config as config_lib
    from edsnet_torch.data.dataset import get_ckpt_dir
    from edsnet_torch.train import train_split_file

    splits_dir = Path(args.splits_dir)
    report = {
        "config": {"model": "anchor-based", "paper_config": PAPER_CONFIG,
                   "max_epoch": args.max_epoch, "extra": args.extra},
        "settings": {},
    }

    for setting in args.settings:
        report["settings"][setting] = {}
        for split_name in SETTING_SPLITS[setting]:
            split_path = splits_dir / split_name
            entry: dict = {}
            report["settings"][setting][split_path.stem] = entry
            if not split_path.exists():
                entry["status"] = f"missing split file {split_path}"
                print(f"[{setting}/{split_path.stem}] SKIP: no split file")
                continue
            absent = missing_datasets(split_path, args.data_root)
            if absent:
                entry["status"] = "missing datasets"
                entry["missing"] = absent
                print(f"[{setting}/{split_path.stem}] SKIP: missing "
                      f"{', '.join(absent)}")
                continue

            model_dir = Path(args.model_root) / setting / split_path.stem
            train_args = config_lib.get_arguments(
                ["anchor-based", "--data-root", args.data_root,
                 "--model-dir", str(model_dir),
                 "--max-epoch", str(args.max_epoch)]
                + PAPER_CONFIG + list(args.extra))
            get_ckpt_dir(model_dir).mkdir(parents=True, exist_ok=True)

            print(f"[{setting}/{split_path.stem}] training "
                  f"({args.max_epoch} epochs per fold)")
            t0 = time.time()
            results = train_split_file(train_args, split_path)
            entry["status"] = "ok"
            entry["fscores"] = results
            entry["diversity"], entry["fscores_from_ckpt"] = \
                eval_diversity(train_args, split_path)
            entry["wall_clock_s"] = round(time.time() - t0, 1)
            print(f"[{setting}/{split_path.stem}] mean F-score "
                  f"{results['mean']:.4f} diversity "
                  f"{entry['diversity']['mean']:.4f} "
                  f"in {entry['wall_clock_s']}s")

    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"sweep report -> {out}")
    return report


def main(argv=None):
    run_sweep(argv)


if __name__ == "__main__":
    main()
