"""The CUDA flash-attention kernels (forward, dq, dk/dv) vs their plain
twins, on a card.

Imports neither JAX nor edsnet_tpu, so it also runs where only the port is
installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py

Without a CUDA device every case skips.  All three kernels run at both
precisions.  Tolerance at "highest" (3 TF32 passes) 1e-4: f32 with another
summation order (l, a sum of up to N terms, relative; the gradients
relative to max(1, max|want|)).  At "default" (1 TF32 pass, unit
roundoff 2^-11 on each operand) 2^-8, 8 unit roundoffs, with the same
scaling: one pass reads up to 1.6e-3 on the small cases below (dq at
D = 32), as its emulation does (PERF.md).  A NaN in any input reaches the
kernels' outputs wherever it reaches the twins'.  The cases run from the
smallest shapes to the main path's largest: (32, 2304, 128) for every
kernel, the deep anchor-free model's (16, 2304, 256) and the local-global
heads' (8, 576, 512) for the forward, and autograd at (4, 8, 2304, 128).
The cases and limits are in tests/flash_cases.py; ``chip_smoke.py``
reads it for the main path's shapes, which it times and holds against the
twins there too.
"""
import numpy as np
import pytest
import torch

from edsnet_torch.kernels import flash_attention as flash
from tests.flash_cases import (AUTOGRAD_CASES, BACKWARD_CASES,
                               FORWARD_CASES, TOL, autograd_grads,
                               autograd_inputs, dense_attention,
                               forward_pairs, grad_gap, mask_levels)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _assert_forward_close(got, want, precision):
    """The outputs that ``forward_pairs`` holds, each within its limit."""
    for name, g, w, rtol, atol in forward_pairs(got, want, precision):
        torch.testing.assert_close(g, w, rtol=rtol, atol=atol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("bh,n,n_pad,d,lens", FORWARD_CASES)
def test_kernel_matches_twin_on_card(cuda_device, bh, n, n_pad, d, lens,
                                     precision):
    rng = np.random.RandomState(bh + n + d)
    q, k, v = (rng.randn(bh, n_pad, d).astype(np.float32) for _ in range(3))
    mask = mask_levels(bh, n, lens, n_pad)
    args = [torch.from_numpy(t).to(cuda_device) for t in (q, k, v, mask)]
    before = flash.flash_attention_fwd.launches_by_head_dim.get(d, 0)
    got = flash.flash_attention_fwd(*args, precision=precision)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches_by_head_dim[d] == before + 1
    _assert_forward_close(got, flash.flash_attention_plain(*args), precision)


def _carries_nan_like_twin(device, d, k_col, v_col, precision):
    """A NaN made on the card in q's first half, in k's second half (the
    other block's partial of S) and in v's second half (the other block's
    columns of O), one head each, the last head clean."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(4, 128, d).astype(np.float32))
               .to(device) for _ in range(3))
    mask = torch.from_numpy(mask_levels(4, 128, [128, 90, 128, 128],
                                        128)).to(device)
    nan = torch.zeros((), device=device) / 0
    q[0, 5, 3], k[1, 9, k_col], v[2, 7, v_col] = nan, -nan, nan
    got = flash.flash_attention_fwd(q, k, v, mask, precision=precision)
    want = flash.flash_attention_plain(q, k, v, mask)
    for name, a, w in (("out", got[0], want[0]),
                       ("m + log l", got[1] + got[2].log(),
                        want[1] + want[2].log())):
        assert bool(w[:3].isnan().any()) or name != "out", name
        assert torch.equal(a.isnan(), w.isnan()), name
        assert bool(a[3].isfinite().all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_dim_512_carries_nan_like_twin_on_card(cuda_device, precision):
    _carries_nan_like_twin(cuda_device, 512, 300, 400, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_head_dim_256_carries_nan_like_twin_on_card(cuda_device, precision):
    _carries_nan_like_twin(cuda_device, 256, 172, 144, precision)


def _backward_inputs(device, bh, n, d, lens, seed, n_pad=None):
    n_pad = n if n_pad is None else n_pad
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, n_pad, d).astype(np.float32))
                  .to(device) for _ in range(4))
    mask = torch.from_numpy(mask_levels(bh, n, lens, n_pad)).to(device)
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    return q, k, v, mask, out, m, l, g


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("bh,n,n_pad,d,lens", BACKWARD_CASES)
def test_backward_kernels_match_twin_on_card(cuda_device, bh, n, n_pad, d,
                                             lens, precision):
    q, k, v, mask, out, m, l, g = _backward_inputs(
        cuda_device, bh, n, d, lens, seed=bh + n + d, n_pad=n_pad)
    dd = (g * out).sum(-1, keepdim=True)
    before = (flash.flash_attention_dq.launches,
              flash.flash_attention_dkv.launches)
    got = (flash.flash_attention_dq(q, k, v, mask, g, m, l, dd,
                                    precision=precision),
           *flash.flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                      precision=precision))
    torch.cuda.synchronize()
    assert (flash.flash_attention_dq.launches,
            flash.flash_attention_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err, limit = grad_gap(a, w, precision)
        assert err <= limit, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_backward_is_bit_identical_across_runs(cuda_device, precision):
    args = _backward_inputs(cuda_device, 2, 256, 128, [200, 256], seed=7)
    first = flash.flash_attention_bwd(*args, precision=precision)
    second = flash.flash_attention_bwd(*args, precision=precision)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("b,h,n,d,lens", AUTOGRAD_CASES)
def test_autograd_matches_dense_oracle_on_card(cuda_device, b, h, n, d, lens,
                                               precision):
    """One forward plus backward through ``flash_attention`` launches each
    of the three kernels once, and its gradients match autograd of the
    dense masked attention."""
    q, k, v, g, mask = autograd_inputs(b, h, n, d, lens, cuda_device)
    kernels = (flash.flash_attention_fwd, flash.flash_attention_dq,
               flash.flash_attention_dkv)
    before = [fn.launches for fn in kernels]
    got = autograd_grads(flash.flash_attention, q, k, v, g, mask,
                         precision=precision)
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(kernels, before)] == [1, 1, 1]
    want = autograd_grads(dense_attention, q, k, v, g, mask)
    for name, a, w in zip("qkv", got, want):
        torch.testing.assert_close(a, w, rtol=TOL[precision],
                                   atol=TOL[precision], msg=f"d{name}")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_kernels_carry_nan_like_twin_on_card(cuda_device, precision):
    """A NaN made on the card (0 / 0, and its negation) in q, k, v or g of
    one head each, the last head clean: NaN where the twins give NaN."""
    q, k, v, mask, out, m, l, g = _backward_inputs(cuda_device, 5, 64, 64,
                                                   [64, 50, 64, 40, 64],
                                                   seed=11)
    nan = torch.zeros((), device=cuda_device) / 0
    q[0, 5, 3], k[1, 9, 0], v[2, 7, 2], g[3, 4, 1] = nan, -nan, -nan, nan
    got = flash.flash_attention_fwd(q, k, v, mask, precision=precision)
    want = flash.flash_attention_plain(q, k, v, mask)
    for name, a, w in (("out", got[0], want[0]),
                       ("m + log l", got[1] + got[2].log(),
                        want[1] + want[2].log())):
        assert torch.equal(a.isnan(), w.isnan()), name
        assert bool(a[4].isfinite().all()), name
    out, m, l = want
    dd = (g * out).sum(-1, keepdim=True)
    got = (flash.flash_attention_dq(q, k, v, mask, g, m, l, dd,
                                    precision=precision),
           *flash.flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                      precision=precision))
    want = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(w[:4].isnan().any()), name
        assert torch.equal(a.isnan(), w.isnan()), name
        assert bool(a[4].isfinite().all()), name


@pytest.mark.cuda
def test_kernel_rejects_bad_shapes(cuda_device):
    q = torch.zeros(2, 100, 64, device=cuda_device)
    mask = torch.ones(2, 100, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        flash.flash_attention_fwd(q, q, q, mask)
    q = torch.zeros(2, 64, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_fwd(q, q, q, mask[:, :64])
    rows = torch.zeros(2, 64, 1, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash.flash_attention_dq(q, q, q, mask[:, :64], q, rows, rows, rows)
    for d in (256, 512):                                # forward only
        q = torch.zeros(2, 64, d, device=cuda_device)
        with pytest.raises(ValueError, match=f"head dim {d}"):
            flash.flash_attention_dkv(q, q, q, mask[:, :64], q, rows, rows,
                                      rows)
    q = torch.zeros(2, 64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="dd must be"):
        flash.flash_attention_dkv(q, q, q, mask[:, :64], q, rows, rows,
                                  rows[:, :32])
    with pytest.raises(ValueError, match="precision must be one of"):
        flash.flash_attention_dq(q, q, q, mask[:, :64], q, rows, rows, rows,
                                 precision="tf32")
