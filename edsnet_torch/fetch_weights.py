"""Pretrained-weight fetcher for the frame and motion feature extractors.

Counterpart of edsnet_tpu/fetch_weights.py, with the same ``WEIGHTS``
(URLs, sha256 prefixes), cache layout, printed lines and return codes.
The frame CNNs (GoogLeNet pool5, the default; Swin-V2-B; ConvNeXt-Base)
read torchvision's released checkpoints, which are not shipped with the
repository: this tool downloads them into the torch hub cache where a
network is reachable, after which ``edsnet_torch.infer`` and
``edsnet_torch.make_dataset`` run their pretrained extractors offline.
Integrity: every torchvision file name carries the first 8 hex digits of
its sha256, which torch.hub checks on download; ``--verify`` re-hashes the
cached files.

    python -m edsnet_torch.fetch_weights                 # google-net only
    python -m edsnet_torch.fetch_weights --all           # + swin/convnext/i3d
    python -m edsnet_torch.fetch_weights --verify        # check cached hashes
    python -m edsnet_torch.fetch_weights --all --pin     # print full sha256s

After a networked ``--verify --pin``, paste the printed full digests into
``WEIGHTS[...]["sha256_full"]`` to upgrade the 32-bit prefix pin to the
full 256-bit one; ``--verify`` checks ``sha256_full`` whenever it is set.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
from pathlib import Path

# torchvision release URLs; the 8-hex suffix is the sha256 prefix that
# torch.hub checks after download.  ``sha256_full`` is filled from a
# networked `--verify --pin` run.
WEIGHTS = {
    "google-net": {
        "url": "https://download.pytorch.org/models/googlenet-1378be20.pth",
        "sha256_prefix": "1378be20",
        "sha256_full": None,
    },
    "swin-transformer": {
        "url": "https://download.pytorch.org/models/"
               "swin_v2_b-781e5279.pth",
        "sha256_prefix": "781e5279",
        "sha256_full": None,
    },
    "convnext": {
        "url": "https://download.pytorch.org/models/"
               "convnext_base-6075fbad.pth",
        "sha256_prefix": "6075fbad",
        "sha256_full": None,
    },
    # I3D RGB (Kinetics + ImageNet init), the standard PyTorch port of the
    # reference's TF1 checkpoint (feature_extractor.py:28-112)
    "i3d-rgb": {
        "url": "https://github.com/piergiaj/pytorch-i3d/raw/master/"
               "models/rgb_imagenet.pt",
        "sha256_prefix": None,   # upstream publishes no digest
        "sha256_full": None,     # pin via --verify --pin on first fetch
    },
}


def hub_dir() -> Path:
    try:
        import torch
        return Path(torch.hub.get_dir()) / "checkpoints"
    except ImportError:
        # torch.hub.get_dir()'s documented default chain, so that cache
        # probes work without torch: $TORCH_HOME, else
        # $XDG_CACHE_HOME/torch, else ~/.cache/torch
        base = os.environ.get("TORCH_HOME")
        if base is None:
            xdg = os.environ.get(
                "XDG_CACHE_HOME",
                os.path.join(os.path.expanduser("~"), ".cache"))
            base = os.path.join(xdg, "torch")
        return Path(base) / "hub" / "checkpoints"


def cached_path(name: str) -> Path:
    return hub_dir() / WEIGHTS[name]["url"].rsplit("/", 1)[-1]


def verify(name: str, pin: bool = False) -> bool:
    """Re-hash a cached file against the strongest recorded digest:
    ``sha256_full`` when pinned, else the torchvision 8-hex prefix.
    ``pin=True`` also prints the full digest as a paste-ready WEIGHTS
    line."""
    path = cached_path(name)
    if not path.exists():
        print(f"{name}: not cached ({path})")
        return False
    spec = WEIGHTS[name]
    with path.open("rb") as f:
        # streamed: these checkpoints are hundreds of MB
        digest = hashlib.file_digest(f, "sha256").hexdigest()
    if pin:
        print(f'        "sha256_full": "{digest}",   # {name}')
    if spec.get("sha256_full"):
        ok = digest == spec["sha256_full"]
        print(f"{name}: {'OK (full pin)' if ok else 'HASH MISMATCH'} "
              f"({digest[:8]}…)")
        return ok
    if spec["sha256_prefix"] is None:
        print(f"{name}: cached, no published digest to check "
              f"(sha256 {digest[:8]}…; pin it with --pin)")
        return True
    ok = digest.startswith(spec["sha256_prefix"])
    print(f"{name}: {'OK' if ok else 'HASH MISMATCH'} "
          f"({digest[:8]} vs {spec['sha256_prefix']})")
    return ok


def fetch(name: str) -> bool:
    import torch

    spec = WEIGHTS[name]
    try:
        # download only: load_state_dict_from_url would also unpickle the
        # file; the extractors later read it with weights_only=True
        hub_dir().mkdir(parents=True, exist_ok=True)
        torch.hub.download_url_to_file(
            spec["url"], str(cached_path(name)), progress=True,
            hash_prefix=spec["sha256_prefix"])
    except Exception as e:   # no egress, bad proxy, upstream moved...
        print(f"{name}: download failed ({type(e).__name__}: "
              f"{str(e)[:120]})")
        return False
    return verify(name)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Download pretrained extractor weights into the torch "
                    "hub cache")
    parser.add_argument("--models", type=str, nargs="+",
                        default=["google-net"], choices=list(WEIGHTS))
    parser.add_argument("--all", action="store_true",
                        help="fetch every known weight file")
    parser.add_argument("--verify", action="store_true",
                        help="only check hashes of already-cached files")
    parser.add_argument("--pin", action="store_true",
                        help="with --verify: also print each cached "
                             "file's FULL sha256 as a paste-ready "
                             "sha256_full line for WEIGHTS")
    args = parser.parse_args(argv)

    names = list(WEIGHTS) if args.all else args.models
    if args.verify:
        results = {name: verify(name, pin=args.pin) for name in names}
    else:
        results = {name: fetch(name) for name in names}
        if args.pin:   # pin straight after the first fetch
            results = {name: results[name] and verify(name, pin=True)
                       for name in names}
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
