"""Shared helpers of the benchmark's own tests: cells cut to a size the
CPU runs in seconds (the widths of a test, never of a benchmark cell)."""
from __future__ import annotations

import pytest
import torch

from portbench.lib.cell import load_cell


def tiny_cell(name: str, num_feature: int = 32, num_head: int = 2):
    """The cell with its configuration at a test's width and its traffic
    at 10 videos of 40-150 positions, 2 epochs."""
    cell = load_cell(name)
    cfg = dict(cell.config)
    args = list(cfg["args"])
    args[args.index("--num-feature") + 1] = str(num_feature)
    args[args.index("--num-head") + 1] = str(num_head)
    cfg.update(args=args, num_feature=num_feature, num_head=num_head)
    cell.config = cfg
    traffic = dict(cell.traffic, videos=10, positions=[40, 150], held_out=2)
    if "max_epoch" in traffic["program"]:
        traffic["program"] = dict(traffic["program"], max_epoch=2)
    cell.traffic = traffic
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    """The first CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
