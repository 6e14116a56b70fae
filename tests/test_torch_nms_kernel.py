"""The CUDA NMS kernel (``csrc/nms.cu`` through ``ops/bbox.py:nms_masked``)
against its plain twin ``nms_masked_plain``, on a card.

Imports neither JAX nor edsnet_tpu, so it also runs where only the port is
installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_nms_kernel.py

Without a CUDA device every case skips.  Keep must equal the twin's bit
for bit: the kernel computes the same float32 IoU with a round-to-nearest
division.  The twin runs on the card too, where its [B, N, N] suppression
matrix fits at N = 30000.
"""
import pytest
import torch

from edsnet_torch.kernels import nms as nms_kernel
from edsnet_torch.ops import bbox
from edsnet_torch.utils import profiling
from tests.nms_cases import CASES, LONG_CASES, THRESHOLDS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("case", sorted(CASES) + sorted(LONG_CASES))
def test_kernel_matches_twin_on_card(cuda_device, case, thresh):
    scores, boxes, valid = (t.to(cuda_device)
                            for t in {**CASES, **LONG_CASES}[case]())
    profiling.reset()
    profiling.enable()
    try:
        before = nms_kernel.nms_sweep.launches
        got = bbox.nms_masked(scores, boxes, thresh, valid)
        torch.cuda.synchronize()
        assert nms_kernel.nms_sweep.launches == before + 1
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counters["nms.rows"] == len(scores)
    want = bbox.nms_masked_plain(scores, boxes, thresh, valid)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
