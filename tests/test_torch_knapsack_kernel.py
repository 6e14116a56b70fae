"""The CUDA knapsack kernel (``csrc/knapsack.cu`` through
``ops/knapsack.py:knapsack``) against its plain twin ``knapsack_plain``, on
a card.

Imports neither JAX nor edsnet_tpu, so it also runs where only the port is
installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_knapsack_kernel.py

Without a CUDA device every case skips.  The selection must equal the
twin's bit for bit: both compute the same int32 DP with the same tie rule
and backtrack.  The twin runs on the card too.
"""
import pytest
import torch

from edsnet_torch.kernels import knapsack as knapsack_kernel
from edsnet_torch.ops import knapsack
from edsnet_torch.utils import profiling
from tests.knapsack_cases import CASES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_twin_on_card(cuda_device, case):
    values, weights, capacity, max_capacity = CASES[case]()
    values, weights, capacity = (t.to(cuda_device)
                                 for t in (values, weights, capacity))
    profiling.reset()
    profiling.enable()
    try:
        before = knapsack_kernel.knapsack_dp.launches
        got = knapsack.knapsack(values, weights, capacity, max_capacity)
        torch.cuda.synchronize()
        assert knapsack_kernel.knapsack_dp.launches == before + 1
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    assert counters["knapsack.rows"] == len(values)
    want = knapsack.knapsack_plain(values, weights, capacity, max_capacity)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())
    # the global-memory paths are the cases named for them
    words = knapsack_kernel._library().edsnet_knapsack_scratch_words(
        values.shape[1], max_capacity)
    assert (words > 0) == case.startswith("global-"), words


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    values, weights, capacity, max_capacity = CASES["mixed-b8"]()
    v, w, c = (t.to(torch.int32) for t in (values, weights, capacity))
    with pytest.raises(ValueError, match="no kernel for cpu"):
        knapsack_kernel.knapsack_dp(v, w, c, max_capacity)
    v, w, c = (t.to(cuda_device) for t in (v, w, c))
    for args in ((v.long(), w, c), (v, w.float(), c), (v, w, c[:-1]),
                 (v, w[:, :-1], c), (v[0], w[0], c[:1]), (v, w.cpu(), c)):
        with pytest.raises(ValueError, match="knapsack_dp"):
            knapsack_kernel.knapsack_dp(*args, max_capacity)
    with pytest.raises(ValueError, match="knapsack_dp"):
        knapsack_kernel.knapsack_dp(v, w, c, -1)
    empty = knapsack_kernel.knapsack_dp(v[:, :0], w[:, :0], c, max_capacity)
    assert empty.shape == (8, 0) and empty.dtype == torch.bool
