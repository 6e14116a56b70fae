"""Flash-attention backward on the CPU: gradients of the port's
``flash_attention`` (``_FlashAttention``, whose backward runs the plain
twins of the dq and dk/dv kernels here) vs ``jax.grad`` of the edsnet_tpu
``flash_attention`` (Pallas in interpret mode, blocks of 64), on the cases
of tests/models/test_flash_attention.py, to rtol 1e-4 / atol 1e-4 as the
JAX tests hold their kernels to their oracle.  The twin of the whole
backward is also held against autograd of a dense masked oracle (atol
1e-5).  The dq path at precision "highest" is also held directly against
``_flash_backward`` (the Pallas ``_dq_kernel`` in interpret mode): the
port's dq wrapper and the 3-pass TF32 emulation of its kernel.  The CUDA
kernels vs the twins are in test_torch_flash_kernel.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.kernels import flash_attention as jax_flash
from edsnet_torch.kernels import flash_attention as flash

TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(b, h, n, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, n, d).astype(np.float32) for _ in range(3)]


def _lens_mask(n, lens):
    return None if lens is None else \
        np.arange(n)[None, :] < np.asarray(lens)[:, None]


def _port_grads(q, k, v, mask, loss_fn, precision="default"):
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = flash.flash_attention(
        *leaves, None if mask is None else torch.from_numpy(mask),
        precision=precision)
    loss_fn(out).backward()
    return [t.grad.numpy() for t in leaves]


def _jax_grads(q, k, v, mask, loss_fn, precision="default"):
    def loss(q, k, v):
        out = jax_flash.flash_attention(
            q, k, v, None if mask is None else jnp.asarray(mask),
            block_q=64, block_k=64, precision=precision)
        return loss_fn(out)
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (q, k, v)))


@pytest.mark.parametrize("case", [
    dict(shape=(1, 1, 64, 64), lens=None, seed=3),               # one block
    dict(shape=(2, 2, 192, 64), lens=[150, 100], seed=4,
         row_weight=True),                                        # multi-block
    dict(shape=(1, 2, 100, 64), lens=None, seed=6),              # 100 -> 128
    dict(shape=(2, 2, 128, 64), lens=[96, 0], seed=5),           # dead row
    dict(shape=(2, 2, 100, 64), lens=[77, 0], seed=5),           # dead + pad
    dict(shape=(2, 2, 160, 64), lens=[160, 123], seed=0,
         precision="highest"),
], ids=["single_block", "masked_multiblock", "n100_padded",
        "fully_masked_128", "fully_masked_100", "highest"])
def test_gradients_match_jax(case):
    b, h, n, d = case["shape"]
    q, k, v = _qkv(b, h, n, d, case["seed"])
    mask = _lens_mask(n, case["lens"])
    weight = np.ones((b, 1, n, 1), np.float32)
    if case.get("row_weight"):     # the loss sees real query rows only
        weight = (np.arange(n)[None, None, :, None]
                  < np.asarray(case["lens"])[:, None, None, None]
                  ).astype(np.float32)
    precision = case.get("precision", "default")
    got = _port_grads(q, k, v, mask,
                      lambda o: ((o * torch.from_numpy(weight)) ** 2).sum(),
                      precision)
    want = _jax_grads(q, k, v, mask,
                      lambda o: jnp.sum((o * weight) ** 2), precision)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), err_msg=f"d{name}",
                                   **TOL)


@pytest.mark.parametrize("bh,n,d,lens", [(2, 128, 64, [128, 77]),
                                         (3, 192, 32, [0, 150, 192])])
def test_dq_matches_jax_flash_backward_at_highest(bh, n, d, lens):
    rng = np.random.RandomState(bh + n + d)
    q, k, v, g = (rng.randn(bh, n, d).astype(np.float32) for _ in range(4))
    mask = np.where(np.arange(n)[None, :] < np.asarray(lens)[:, None], 1, 0
                    ).astype(np.int32)
    mask[:, n - 9:] = -1     # time-axis pad keys
    jm = jnp.asarray(mask[:, None, :])
    out, m, l = jax_flash._flash_forward(
        *(jnp.asarray(t) for t in (q, k, v)), jm, 64, 64, "highest")
    want, _, _ = jax_flash._flash_backward(
        *(jnp.asarray(t) for t in (q, k, v)), jm, out, m, l, jnp.asarray(g),
        64, 64, "highest")
    tq, tk, tv, tg, to, tm, tl = (torch.from_numpy(np.array(t))
                                  for t in (q, k, v, g, out, m, l))
    args = (tq, tk, tv, torch.from_numpy(mask), tg, tm, tl,
            (tg * to).sum(-1, keepdim=True))
    for name, got in (
            ("wrapper", flash.flash_attention_dq(*args, precision="highest")),
            ("3-pass emulation", flash.flash_attention_dq_tf32(*args, 3))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)


def _dense_oracle(q, k, v, mask):
    """Dense masked attention on [BH, N, D] with a [BH, N] 1/0/-1 key mask:
    masked keys at -1e30, pad keys at -2e30 (the kernels' levels)."""
    s = torch.einsum("bnd,bmd->bnm", q, k) / q.shape[-1] ** 0.5
    km = mask[:, None, :]
    s = torch.where(km > 0, s, torch.where(km == 0, flash.NEG, 2 * flash.NEG))
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("bh,n,d,lens", [
    (4, 192, 64, [150, 150, 100, 100]), (2, 128, 32, [128, 0]),
    (3, 64, 128, [64, 17, 0])])
def test_backward_twin_matches_dense_autograd(bh, n, d, lens):
    rng = np.random.RandomState(bh + n)
    q, k, v, g = (torch.from_numpy(rng.randn(bh, n, d).astype(np.float32))
                  for _ in range(4))
    mask = torch.from_numpy(np.where(
        np.arange(n)[None, :] < np.asarray(lens)[:, None], 1, 0
    ).astype(np.int32))
    mask[:, n - 5:] = -1     # time-axis pad keys
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (_dense_oracle(*leaves, mask) * g).sum().backward()
    out, m, l = flash.flash_attention_plain(q, k, v, mask)
    got = flash.flash_attention_bwd_plain(q, k, v, mask, out, m, l, g)
    assert torch.equal(torch.stack(got), torch.stack(
        flash.flash_attention_bwd(q, k, v, mask, out, m, l, g)))
    for name, a, leaf in zip("qkv", got, leaves):
        np.testing.assert_allclose(a.numpy(), leaf.grad.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


def test_cpu_backward_counts_no_launch_and_mask_has_no_grad():
    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv(1, 2, 64, 32, seed=1))
    mask = torch.ones(1, 64, dtype=torch.bool)
    before = [f.launches for f in (flash.flash_attention_fwd,
                                   flash.flash_attention_dq,
                                   flash.flash_attention_dkv)]
    flash.flash_attention(q, k, v, mask).sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    assert [f.launches for f in (flash.flash_attention_fwd,
                                 flash.flash_attention_dq,
                                 flash.flash_attention_dkv)] == before
