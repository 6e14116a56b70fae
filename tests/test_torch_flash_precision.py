"""The arithmetic of the TF32 tensor-core kernels, emulated on the CPU.

``tf32_round``, ``tf32_matmul``, ``flash_attention_tf32`` and
``flash_attention_dkv_tf32`` (edsnet_torch/kernels/flash_attention.py)
repeat the operand arithmetic of the forward and dk/dv kernels: every
operand rounded to TF32 (to nearest, ties away from zero), then 3 products
(precision "highest") or 1 ("default").  They sum those products as an
f32 matmul does, rounded to nearest, unless ``toward_zero`` asks for the
card's accumulation (8 terms a step, rounded toward zero after each).
- 1 pass: operand rounding sets the error, and the emulation gives the
  card's readings on ``chip_smoke.py``'s inputs to about three digits
  (PERF.md); it is held here, at those shapes and at 4 heads, N 256,
  D 128 from seeded numpy, to the 2^-8 (gradients: 2^-8 * max(1,
  max|want|)) that the card holds "default" to against the twins;
- 3 passes: products within 1e-6 of f64; on the card the accumulator's
  rounding toward zero, not the split, sets the error of long sums, which
  ``toward_zero`` shows against the 1e-4 that the card holds "highest" to.
On the CPU the kernel wrappers run the exact twins at either precision.
"""
import numpy as np
import pytest
import torch

from edsnet_torch.kernels import flash_attention as flash

BH, N, D = 4, 256, 128
TOL_DEFAULT = 2.0 ** -8       # one TF32 pass vs the f32 twins, as on the card
LENS = [256, 200, 0, 130]     # a fully-masked row, and pad keys past 230


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (torch.from_numpy(rng.randn(BH, N, D).astype(np.float32))
                  for _ in range(4))
    mask = (np.arange(N)[None, :] < np.asarray(LENS)[:, None]).astype(
        np.int32)
    mask[:, 230:] = -1
    return q, k, v, g, torch.from_numpy(mask)


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        np.float32) * 10.0 ** np.random.RandomState(2).randint(-30, 30, 4096))
    r = flash.tf32_round(x)
    assert r.dtype == torch.float32
    assert not bool((r.view(torch.int32) & 0x1FFF).any())
    assert bool(((x - r).abs() <= x.abs() * 2.0 ** -11).all())


def test_tf32_round_is_idempotent_and_exact_on_tf32_values():
    rng = np.random.RandomState(3)
    bits = rng.randint(-2 ** 31, 2 ** 31, 4096, dtype=np.int64)
    tf32 = torch.from_numpy((bits & ~0x1FFF).astype(np.int32)).view(
        torch.float32)
    tf32 = tf32[torch.isfinite(tf32)]
    assert torch.equal(flash.tf32_round(tf32), tf32)
    x = torch.from_numpy(rng.randn(4096).astype(np.float32))
    once = flash.tf32_round(x)
    assert torch.equal(flash.tf32_round(once), once)


def test_tf32_round_ties_away_from_zero_and_overflows_to_inf():
    one = torch.tensor([1.0, -1.0])
    tie = (one.view(torch.int32) | 0x1000).view(torch.float32)
    below = (one.view(torch.int32) | 0x0FFF).view(torch.float32)
    ulp = 2.0 ** -10
    assert flash.tf32_round(tie).tolist() == [1.0 + ulp, -1.0 - ulp]
    assert flash.tf32_round(below).tolist() == [1.0, -1.0]
    big = torch.tensor([torch.finfo(torch.float32).max, float("inf")])
    assert flash.tf32_round(big).tolist() == [float("inf")] * 2


def test_three_pass_product_is_f32_exact():
    """Within 1e-6 of the f64 product relative to sum |a_i b_i| (the scale
    of any f32 dot product's rounding), and no coarser than an f32 bmm."""
    q, k, *_ = _inputs()
    a, b = q * D ** -0.5, k.transpose(1, 2)
    want = torch.bmm(a.double(), b.double())
    scale = torch.bmm(a.double().abs(), b.double().abs())

    def err(passes):
        return (flash.tf32_matmul(a, b, passes).double() - want).abs()

    assert float((err(3) / scale).max()) <= 1e-6
    f32_err = float((torch.bmm(a, b).double() - want).abs().max())
    assert float(err(3).max()) <= 1.5 * f32_err
    assert float((err(1) / scale).max()) > 1e-5   # one pass is coarser
    with pytest.raises(ValueError, match="1 or 3"):
        flash.tf32_matmul(a, b, 2)


@pytest.mark.parametrize("passes,tol", [(3, 1e-5), (1, TOL_DEFAULT)],
                         ids=["highest", "default"])
def test_emulated_forward_within_card_tolerance(passes, tol):
    q, k, v, _, mask = _inputs(4)
    out, m, l = flash.flash_attention_tf32(q, k, v, mask, passes)
    w_out, w_m, w_l = flash.flash_attention_plain(q, k, v, mask)
    assert float((out - w_out).abs().max()) <= tol
    lse = (m + l.log()) - (w_m + w_l.log())
    assert float(lse.abs().max()) <= tol
    if passes == 3:              # "highest" holds m and l one by one
        assert float((m - w_m).abs().max()) <= tol
        assert float(((l - w_l) / w_l).abs().max()) <= tol
    # the fully-masked row averages v over its 230 real keys
    torch.testing.assert_close(out[2], v[2, :230].mean(0).expand(N, D),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("passes,tol", [(3, 1e-5), (1, TOL_DEFAULT)],
                         ids=["highest", "default"])
def test_emulated_dkv_within_card_tolerance(passes, tol):
    q, k, v, g, mask = _inputs(5)
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    dd = (g * out).sum(-1, keepdim=True)
    got = flash.flash_attention_dkv_tf32(q, k, v, mask, g, m, l, dd, passes)
    want = flash.flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    for name, a, w in zip(("dk", "dv"), got, want):
        err = float((a - w).abs().max())
        assert err <= tol * max(1.0, float(w.abs().max())), (name, err)


@pytest.mark.parametrize("bh,n,d,lens", [
    (4, 192, 64, [150, 150, 100, 100]), (2, 128, 128, [100, 100]),
    (2, 256, 128, [0, 256]), (4, 128, 32, [128, 100, 64, 0])])
def test_emulated_one_pass_on_smoke_shapes_within_card_tolerance(bh, n, d,
                                                                 lens):
    """chip_smoke.py's small cases at "default": short rows (100-150 real
    keys) concentrate P, which gives one pass its largest dk error there
    (PERF.md), still inside 2^-8 * max(1, max|want|)."""
    rng = np.random.RandomState(n + d)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32))
                  for _ in range(4))
    mask = torch.from_numpy(
        (np.arange(n)[None, :] < np.asarray(lens)[:, None]).astype(np.int32))
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    got = flash.flash_attention_tf32(q, k, v, mask, 1)
    assert float((got[0] - out).abs().max()) <= TOL_DEFAULT
    dd = (g * out).sum(-1, keepdim=True)
    got = flash.flash_attention_dkv_tf32(q, k, v, mask, g, m, l, dd, 1)
    want = flash.flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    for name, a, w in zip(("dk", "dv"), got, want):
        err = float((a - w).abs().max())
        limit = TOL_DEFAULT * max(1.0, float(w.abs().max()))
        assert err <= limit, (name, err)


def test_toward_zero_accumulation_sets_three_pass_error_of_long_sums():
    """dv = P^T g over 2304 rows at 3 passes: summed as the card's mma
    steps do (rounded toward zero), the error is a bias that grows with the
    number of steps, an order above f32 sums rounded to nearest, and stays
    inside the 1e-4 that the card holds "highest" to."""
    rng = np.random.RandomState(9)
    s = torch.from_numpy(rng.randn(1, 64, 2304).astype(np.float32))
    pt = torch.softmax(s, dim=-1)        # 64 keys' P^T over 2304 q rows
    g = torch.from_numpy(rng.randn(1, 2304, 128).astype(np.float32))
    want = torch.bmm(pt.double(), g.double())

    def err(**kw):
        return float((flash.tf32_matmul(pt, g, 3, **kw).double() - want)
                     .abs().max())

    nearest, toward_zero = err(), err(toward_zero=True)
    assert 10 * nearest < toward_zero <= 1e-4 * max(1.0, float(
        want.abs().max()))


def test_tf32_round_keeps_nan():
    nan = torch.zeros(2) / 0                 # 0x7fffffff and its negation
    nan[1] = -nan[1]
    payload = torch.tensor([0x7F800001], dtype=torch.int32).view(
        torch.float32)                       # a NaN in the low 13 bits
    r = flash.tf32_round(torch.cat([nan, payload]))
    assert r.view(torch.int32).tolist() == [0x7FFFE000] * 3
    a = torch.ones(1, 2, 8)
    a[0, 1, 3] = nan[1]
    for passes in (1, 3):
        got = flash.tf32_matmul(a, torch.ones(1, 8, 2), passes)
        assert got[0, 1].isnan().all() and not got[0, 0].isnan().any()


@pytest.mark.parametrize("precision", flash.PRECISIONS)
def test_cpu_wrappers_run_the_exact_twins_at_either_precision(precision):
    q, k, v, g, mask = _inputs(6)
    fwd = flash.flash_attention_fwd(q, k, v, mask, precision=precision)
    want = flash.flash_attention_plain(q, k, v, mask)
    assert all(torch.equal(a, b) for a, b in zip(fwd, want))
    out, m, l = want
    dd = (g * out).sum(-1, keepdim=True)
    got = flash.flash_attention_dkv(q, k, v, mask, g, m, l, dd,
                                    precision=precision)
    want = flash.flash_attention_dkv_plain(q, k, v, mask, g, m, l, dd)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    grads = flash.flash_attention_bwd(q, k, v, mask, out, m, l, g,
                                      precision=precision)
    assert all(torch.equal(a, b) for a, b in zip(
        grads, flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, g)))


def test_flash_attention_carries_precision_through_autograd():
    q, k, v, _, _ = _inputs(7)
    mask = torch.arange(N)[None, :] < torch.tensor([[256], [100]])
    q, k, v = (t.reshape(2, 2, N, D) for t in (q, k, v))
    grads = {}
    for precision in flash.PRECISIONS:
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        flash.flash_attention(*leaves, mask,
                              precision=precision).square().sum().backward()
        grads[precision] = [t.grad for t in leaves]
    for a, b in zip(grads["default"], grads["highest"]):
        assert torch.equal(a, b)          # on the CPU: the same f32 twins


def test_unknown_precision_raises():
    q, k, v, g, mask = _inputs(8)
    for fn, args in ((flash.flash_attention_fwd, (q, k, v, mask)),
                     (flash.flash_attention_dkv,
                      (q, k, v, mask, g, q[..., :1], q[..., :1],
                       q[..., :1]))):
        with pytest.raises(ValueError, match="precision must be one of"):
            fn(*args, precision="tf32")
