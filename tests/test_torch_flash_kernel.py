"""The CUDA flash-attention kernels (forward, dq, dk/dv) vs their plain
twins, on a card.

Imports neither JAX nor edsnet_tpu, so it also runs where only the port is
installed:

    python3 -m pytest --noconftest -m cuda tests/test_torch_flash_kernel.py

Without a CUDA device every case skips.  The forward and dk/dv kernels run
at both precisions.  Tolerance at "highest" (3 TF32 passes) and for dq
(f32 FMAs) 1e-4: f32 with another summation order (l, a sum of up to N
terms, relative; the gradients relative to max(1, max|want|)).  At
"default" (1 TF32 pass, unit roundoff 2^-11 on each operand) 2^-8, 8 unit
roundoffs, with the same scaling: one pass reads up to 1.3e-3 on
chip_smoke.py's cases, as its emulation does (PERF.md).  A NaN in any
input reaches the kernels' outputs wherever it reaches the twins'.
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


TOL = {"highest": 1e-4, "default": 2.0 ** -8}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("bh,n,d,lens", [
    (4, 192, 64, [150, 150, 100, 100]), (2, 128, 128, [100, 100]),
    (2, 256, 128, [0, 256]), (4, 128, 32, [128] * 4)])
def test_kernel_matches_twin_on_card(cuda_device, bh, n, d, lens, precision):
    rng = np.random.RandomState(bh + n + d)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for _ in range(3))
    mask = _mask_levels(bh, n, lens, n)
    args = [torch.from_numpy(t).to(cuda_device) for t in (q, k, v, mask)]
    before = flash.flash_attention_fwd.launches
    got = flash.flash_attention_fwd(*args, precision=precision)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    want = flash.flash_attention_plain(*args)
    if precision == "highest":
        for name, g, w in zip(("out", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
        return
    # One TF32 pass: m carries the rounding error of the row's largest
    # score and l moves with it, so the pair is held through the log
    # normaliser m + log l that it defines (and that the backward uses).
    tol = TOL["default"]
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol,
                               msg="out")
    torch.testing.assert_close(got[1] + got[2].log(), want[1] + want[2].log(),
                               rtol=0, atol=tol, msg="m + log l")


def _backward_inputs(device, bh, n, d, lens, seed):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32))
                  .to(device) for _ in range(4))
    mask = torch.from_numpy(_mask_levels(bh, n, lens, n)).to(device)
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    return q, k, v, mask, out, m, l, g


BACKWARD_CASES = [(4, 192, 64, [150, 150, 100, 100]), (2, 128, 128, [100, 0]),
                  (2, 256, 128, [0, 256]), (4, 128, 32, [128] * 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("bh,n,d,lens", BACKWARD_CASES)
def test_backward_kernels_match_twin_on_card(cuda_device, bh, n, d, lens,
                                             precision):
    q, k, v, mask, out, m, l, g = _backward_inputs(cuda_device, bh, n, d,
                                                   lens, seed=bh + n + d)
    dd = (g * out).sum(-1, keepdim=True)
    before = (flash.flash_attention_dq.launches,
              flash.flash_attention_dkv.launches)
    got = (flash.flash_attention_dq(q, k, v, mask, g, m, l, dd),
           *flash.flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                      precision=precision))
    torch.cuda.synchronize()
    assert (flash.flash_attention_dq.launches,
            flash.flash_attention_dkv.launches) == (before[0] + 1,
                                                    before[1] + 1)
    want = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, g)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        tol = 1e-4 if name == "dq" else TOL[precision]
        err = float((a - w).abs().max())
        assert err <= tol * max(1.0, float(w.abs().max())), (name, err)


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
def test_autograd_matches_dense_oracle_on_card(cuda_device, precision):
    rng = np.random.RandomState(3)
    b, h, n, d = 2, 2, 100, 64
    q, k, v, g = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
                  .to(cuda_device) for _ in range(4))
    mask = torch.arange(n, device=cuda_device)[None, :] < torch.tensor(
        [[77], [0]], device=cuda_device)
    grads = []
    for use_kernel in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if use_kernel:
            out = flash.flash_attention(*leaves, mask, precision=precision)
        else:
            s = torch.einsum("bhnd,bhmd->bhnm", leaves[0], leaves[1])
            s = torch.where(mask[:, None, None, :], s / d ** 0.5, flash.NEG)
            out = torch.softmax(s, -1) @ leaves[2]
        (out * g).sum().backward()
        grads.append([t.grad for t in leaves])
    tol = TOL[precision]
    for name, a, w in zip("qkv", *grads):
        torch.testing.assert_close(a, w, rtol=tol, atol=tol, msg=f"d{name}")


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
    got = flash.flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                    precision=precision)
    want = flash.flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    for name, a, w in zip(("dk", "dv"), got, want):
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
    q = torch.zeros(2, 64, 64, device=cuda_device)
    with pytest.raises(ValueError, match="dd must be"):
        flash.flash_attention_dkv(q, q, q, mask[:, :64], q, rows, rows,
                                  rows[:, :32])
