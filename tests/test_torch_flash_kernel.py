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
scaling: one pass reads up to 1.6e-3 on chip_smoke.py's cases (dq at
D = 32), as its emulation does (PERF.md).  A NaN in any input reaches the
kernels' outputs wherever it reaches the twins'.
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
    (2, 256, 128, [0, 256]), (4, 128, 32, [128] * 4),
    (4, 192, 256, [192, 150, 100, 0])])
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


def _assert_forward_close(got, want, precision):
    """out, m and l within 1e-4 at "highest"; out and m + log l within 2^-8
    at "default" (the pair through the log normaliser it defines)."""
    if precision == "highest":
        for name, g, w in zip(("out", "m", "l"), got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=name)
        return
    tol = TOL["default"]
    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol,
                               msg="out")
    torch.testing.assert_close(got[1] + got[2].log(), want[1] + want[2].log(),
                               rtol=0, atol=tol, msg="m + log l")


# the local attentions' buffer at bucket 2304: ceil(2304 / 4) positions,
# a segment of ceil(n / 4) real in each of 4 rows x 2 heads
LOCAL_LENS = [525] * 2 + [476] * 2 + [425] * 2 + [375] * 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("bh,n,n_pad,lens", [
    (3, 192, 192, [192, 150, 0]),     # a fully-masked row
    (2, 100, 128, [100, 61]),         # N not a multiple of 64: pad keys
    (4, 2100, 2112, [2100, 1700, 530, 0]),
    (8, 576, 576, LOCAL_LENS),        # the local-global heads' own shape
    # 33 q tiles x 7 = 231 clusters: an odd count, and an odd last wave
    (7, 2112, 2112, [2100, 1700, 530, 0, 2112, 64, 1])])
def test_head_dim_512_matches_twin_on_card(cuda_device, bh, n, n_pad, lens,
                                           precision):
    """Head dim 512, the local attentions of the local-global heads at
    F 1024 (2 heads): flash_fwd_cluster_kernel, a cluster of two blocks
    per q tile, each owning half of the head dim, S summed from their two
    partials, m and l written by rank 0."""
    rng = np.random.RandomState(bh + n)
    q, k, v = (rng.randn(bh, n_pad, 512).astype(np.float32)
               for _ in range(3))
    mask = _mask_levels(bh, n, lens, n_pad)
    args = [torch.from_numpy(t).to(cuda_device) for t in (q, k, v, mask)]
    before = flash.flash_attention_fwd.launches_by_head_dim.get(512, 0)
    got = flash.flash_attention_fwd(*args, precision=precision)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches_by_head_dim[512] == before + 1
    _assert_forward_close(got, flash.flash_attention_plain(*args), precision)


def _carries_nan_like_twin(device, d, k_col, v_col, precision):
    """A NaN made on the card in q's first half, in k's second half (the
    other block's partial of S) and in v's second half (the other block's
    columns of O), one head each, the last head clean."""
    rng = np.random.RandomState(12)
    q, k, v = (torch.from_numpy(rng.randn(4, 128, d).astype(np.float32))
               .to(device) for _ in range(3))
    mask = torch.from_numpy(_mask_levels(4, 128, [128, 90, 128, 128],
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
        err = float((a - w).abs().max())
        assert err <= TOL[precision] * max(1.0, float(w.abs().max())), (
            name, err)


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
