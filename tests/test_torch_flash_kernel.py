"""The CUDA flash-attention kernel vs its plain twin, on a card.

Imports neither JAX nor edsnet_tpu, so it also runs where only the port is
installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py

Without a CUDA device every case skips.  Tolerance 1e-4: f32 with another
summation order (l, a sum of up to N terms, relative).
"""
import numpy as np
import pytest
import torch

from edsnet_torch.kernels import flash_attention as flash


def _mask_levels(bh, n, lens, n_pad):
    """[bh, n_pad] int32: 1 attend, 0 real-but-masked, -1 time pad."""
    m = np.full((bh, n_pad), -1, np.int32)
    m[:, :n] = (np.arange(n)[None, :] < np.asarray(lens)[:, None])
    return m


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,d,lens", [
    (4, 192, 64, [150, 150, 100, 100]), (2, 128, 128, [100, 100]),
    (2, 256, 128, [0, 256]), (4, 128, 32, [128] * 4)])
def test_kernel_matches_twin_on_card(cuda_device, bh, n, d, lens):
    rng = np.random.RandomState(bh + n + d)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for _ in range(3))
    mask = _mask_levels(bh, n, lens, n)
    args = [torch.from_numpy(t).to(cuda_device) for t in (q, k, v, mask)]
    before = flash.flash_attention_fwd.launches
    got = flash.flash_attention_fwd(*args)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    want = flash.flash_attention_plain(*args)
    for name, g, w in zip(("out", "m", "l"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda_device):
    q = torch.zeros(2, 100, 64, device=cuda_device)
    mask = torch.ones(2, 100, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash.flash_attention_fwd(q, q, q, mask)
    q = torch.zeros(2, 64, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_fwd(q, q, q, mask[:, :64])
