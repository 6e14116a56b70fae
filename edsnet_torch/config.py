"""CLI / config surface: the edsnet_tpu parser, flag for flag.

Counterpart of edsnet_tpu/config.py.  Every flag parses; the evaluate entry
point raises NotImplementedError for the ones this port does not serve yet
(see evaluate.py:check_supported).  ``--device auto`` and ``--device gpu``
mean CUDA, ``--device cpu`` the CPU (tests).
"""
from __future__ import annotations

import argparse
import logging
import random
from pathlib import Path

import numpy as np


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def init_logger(log_dir: str, log_file: str) -> logging.Logger:
    logger = logging.getLogger()
    format_str = r"[%(asctime)s] %(message)s"
    logging.basicConfig(level=logging.INFO, datefmt=r"%Y/%m/%d %H:%M:%S",
                        format=format_str)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(str(log_dir / log_file))
    fh.setFormatter(logging.Formatter(format_str))
    logger.addHandler(fh)
    return logger


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()

    # model type
    parser.add_argument("model", type=str,
                        choices=("anchor-based", "anchor-free"))
    parser.add_argument("--model-depth", type=str, default="shallow",
                        choices=["shallow", "deep", "local-global-attention",
                                 "original", "cross-attention"])
    parser.add_argument("--fft-attention-orientation", dest="orientation",
                        type=str,
                        choices=["paper", "temporal", "feature_wise"],
                        default="paper")
    parser.add_argument("--pooling-type", type=str, default="roi",
                        choices=["roi", "flat-pooling", "fft", "dwt"])

    # training & evaluation
    parser.add_argument("--device", type=str, default="auto",
                        choices=("auto", "tpu", "cpu", "gpu"))
    parser.add_argument("--seed", type=int, default=12345)
    parser.add_argument("--splits", type=str, nargs="+", default=[])
    parser.add_argument("--max-epoch", type=int, default=300)
    parser.add_argument("--model-dir", type=str, default="../models/model")
    parser.add_argument("--log-file", type=str, default="log.txt")
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--weight-decay", type=float, default=1e-5)
    parser.add_argument("--lambda-reg", type=float, default=1.0)
    parser.add_argument("--nms-thresh", type=float, default=0.5)
    parser.add_argument("--fc-depth", type=int, default=7)
    parser.add_argument("--attention-depth", type=int, default=2)
    parser.add_argument("--encoder-type", type=str, default="classic",
                        choices=["classic", "local-global"])

    # inference
    parser.add_argument("--ckpt-path", type=str, default=None)
    parser.add_argument("--sample-rate", type=int, default=15)
    parser.add_argument("--source", type=str, default=None)
    parser.add_argument("--save-path", type=str, default=None)
    parser.add_argument("--feature-extractor", type=str, default="google-net",
                        choices=["google-net", "swin-transformer",
                                 "convnext", "random"])
    parser.add_argument("--motion-feature", type=str, default=None,
                        help="infer: precomputed motion features (.npy, "
                             "one row per sampled frame — data/motion.py "
                             "CLI output) for --source; required only by "
                             "motion models (--model-depth "
                             "cross-attention) and computed on the fly "
                             "with --motion-backend when omitted")
    parser.add_argument("--motion-backend", type=str, default="flowdiff",
                        choices=["flowdiff", "conv3d"],
                        help="on-the-fly motion extractor for infer when "
                             "no --motion-feature .npy is given")

    # common model config
    parser.add_argument("--base-model", type=str, default="attention",
                        choices=["attention", "lstm", "linear", "bilstm",
                                 "gcn", "nystromformer", "fourier",
                                 "linformer", "performer", "dwt"])
    parser.add_argument("--num-head", type=int, default=8)
    parser.add_argument("--num-feature", type=int, default=1024)
    parser.add_argument("--num-hidden", type=int, default=128)

    # anchor based
    parser.add_argument("--neg-sample-ratio", type=float, default=2.0)
    parser.add_argument("--incomplete-sample-ratio", type=float, default=1.0)
    parser.add_argument("--pos-iou-thresh", type=float, default=0.6)
    parser.add_argument("--neg-iou-thresh", type=float, default=0.0)
    parser.add_argument("--incomplete-iou-thresh", type=float, default=0.3)
    parser.add_argument("--anchor-scales", type=int, nargs="+",
                        default=[4, 8, 16, 32])

    # anchor free
    parser.add_argument("--lambda-ctr", type=float, default=1.0)
    parser.add_argument("--cls-loss", type=str, default="focal",
                        choices=["focal", "cross-entropy"])
    parser.add_argument("--reg-loss", type=str, default="soft-iou",
                        choices=["soft-iou", "smooth-l1"])

    parser.add_argument("--where", type=str, choices=["kaggle", "local"],
                        default="local",
                        help="accepted for reference-CLI compatibility and "
                             "IGNORED: the reference used it to switch "
                             "hard-coded kaggle/local path roots "
                             "(data_helper.py:44-56); use --data-root")

    # TPU-native additions
    parser.add_argument("--data-root", type=str, default=None,
                        help="directory containing the .h5 dataset files; "
                             "split keys are resolved against it")
    parser.add_argument("--batch-size", type=int, default=1,
                        help="videos per train step (1 = reference parity; "
                             "larger batches data-parallelize across the "
                             "device mesh)")
    parser.add_argument("--bucket-size", type=int, default=64,
                        help="sequence lengths are padded up to a multiple "
                             "of this (64 aligns nystromformer landmarks "
                             "and TPU lanes)")
    parser.add_argument("--num-devices", type=int, default=0,
                        help="data-parallel mesh size (0 = all local "
                             "devices)")
    parser.add_argument("--tensor-parallel", type=int, default=0,
                        help="shard attention heads over a 'model' mesh "
                             "axis of this size (Megatron-style, "
                             "parallel/tensor_parallel.py), combined with "
                             "the data axis: devices = dp x this. "
                             "--num-head must be a multiple; 0/1 = off")
    parser.add_argument("--pad-batch-to", type=int, default=0,
                        help="pad every batch's video axis to a multiple "
                             "of this (0 = mesh size); fixing it keeps "
                             "batch shapes (and so compiles and RNG "
                             "streams) identical across mesh sizes")
    parser.add_argument("--untie-fc-blocks", action="store_true",
                        help="use independent weights per fc_block instead "
                             "of the reference's shared-weight trunk")
    parser.add_argument("--profile", action="store_true",
                        help="emit jax profiler traces + per-step timings")
    parser.add_argument("--eval-every", type=int, default=1,
                        help="validate every N epochs (reference: every "
                             "epoch; eval dominates wall-clock on small "
                             "datasets)")
    parser.add_argument("--device-eval", action="store_true",
                        help="deprecated no-op: device eval is the default "
                             "since round 2 (see --host-eval)")
    parser.add_argument("--host-eval", action="store_true",
                        help="assemble summaries on the host (native C++ "
                             "knapsack) instead of the default fully "
                             "on-device eval pipeline")
    parser.add_argument("--knapsack-audit", action="store_true",
                        help="during evaluation, solve each video's shot "
                             "knapsack with BOTH the DP and the C++ "
                             "branch&bound and report tie-selection "
                             "divergence (count + F-score impact); "
                             "implies host-path summary assembly")
    parser.add_argument("--matmul-precision", type=str, default=None,
                        choices=["default", "high", "highest", "bfloat16",
                                 "tensorfloat32", "float32"],
                        help="jax default matmul precision (TPU MXU runs "
                             "bf16-ish by 'default'; 'highest' forces f32)")
    parser.add_argument("--device-kts", action="store_true",
                        help="run KTS change-point detection (scatter "
                             "matrix + DP + model selection) as one jitted "
                             "program on the accelerator instead of the "
                             "host C++/NumPy path")
    parser.add_argument("--static-batches", action="store_true",
                        help="freeze batch compositions across epochs "
                             "(round-1 behavior); default recomposes "
                             "batches per epoch on device, matching the "
                             "reference's per-epoch video reshuffle")
    parser.add_argument("--resume", action="store_true",
                        help="resume training from the saved train state "
                             "(model + optimizer + epoch) if present")
    parser.add_argument("--state-save-every", type=int, default=0,
                        help="with --resume, additionally persist the "
                             "resumable train state every N epochs. 0 "
                             "(default) saves only at logging epochs on "
                             "the async path, where the host sync is "
                             "already paid; N>0 trades extra syncs for a "
                             "tighter crash-replay window")
    parser.add_argument("--context-parallel", type=int, default=0,
                        help="shard the attention backbone's sequence "
                             "axis over N devices via ring attention "
                             "(ppermute K/V rotation + online-softmax "
                             "merge) on deterministic passes; 0 = off, "
                             "-1 = all local devices. Applies to "
                             "sequences >= --cp-min-len that divide the "
                             "mesh size. Composes with --tensor-parallel "
                             "(one ('data','seq','model') mesh)")
    parser.add_argument("--cp-min-len", type=int, default=1024,
                        help="minimum sequence length for "
                             "--context-parallel routing")
    parser.add_argument("--use-pallas", action="store_true", default=None,
                        dest="use_pallas",
                        help="route every deterministic pass of the "
                             "attention backbone through the flash-attention "
                             "kernel, on any device (on the CPU its plain "
                             "twin). Unset = auto: the kernel on CUDA, the "
                             "dense path on the CPU")
    parser.add_argument("--no-pallas", action="store_false", default=None,
                        dest="use_pallas",
                        help="always use the dense attention path")
    parser.add_argument("--compute-dtype", type=str, default="auto",
                        choices=["auto", "float32", "bfloat16"],
                        help="training forward/backward dtype; bfloat16 "
                             "keeps f32 master params and f32 losses/"
                             "optimizer (mixed precision) and roughly "
                             "halves the HBM-bound step's traffic. "
                             "'auto' (default) = bfloat16 on real TPU "
                             "backends — a repeatable ~12%% step win with "
                             "converged F-scores equal to f32's "
                             "(benchmarks/RESULTS.md traffic-levers "
                             "study) — and float32 elsewhere (CPU test "
                             "parity)")
    parser.add_argument("--remat", action="store_true",
                        help="rematerialize forward activations in the "
                             "backward (jax.checkpoint) instead of saving "
                             "them — for memory-pressured configs (large "
                             "per-chip batches / long sequences); at the "
                             "paper config it measures within platform "
                             "noise of the default")
    return parser


def get_arguments(args=None) -> argparse.Namespace:
    return get_parser().parse_args(args)
