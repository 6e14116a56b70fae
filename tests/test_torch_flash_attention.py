"""Flash-attention forward: the port's plain twin vs the edsnet_tpu Pallas
kernel (interpret mode on the CPU).  out, m and l agree to 1e-5 (f32,
different summation order).  The CUDA kernel vs the twin is in
test_torch_flash_kernel.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.kernels import flash_attention as jax_flash
from edsnet_torch.kernels import flash_attention as flash

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _mask_levels(bh, n, lens, n_pad):
    """[bh, n_pad] int32: 1 attend, 0 real-but-masked, -1 time pad."""
    m = np.full((bh, n_pad), -1, np.int32)
    m[:, :n] = (np.arange(n)[None, :] < np.asarray(lens)[:, None])
    return m


@pytest.mark.parametrize("case", [
    dict(bh=4, n=192, d=64, lens=[192] * 4),            # unmasked
    dict(bh=4, n=192, d=64, lens=[150, 150, 100, 100]),  # per-video masks
    dict(bh=2, n=100, d=32, lens=[100, 100]),           # N not a 64 multiple
    dict(bh=4, n=100, d=64, lens=[100, 0, 60, 0]),      # fully-masked rows
    # the head dims of the cluster kernel, flash_fwd_cluster_kernel
    dict(bh=2, n=128, d=256, lens=[128, 70]),
    dict(bh=2, n=100, d=512, lens=[100, 0]),
], ids=["unmasked", "masked", "n100", "fully_masked", "d256", "d512"])
def test_twin_matches_pallas_forward(case):
    bh, n, d = case["bh"], case["n"], case["d"]
    n_pad = -(-n // 64) * 64
    q, k, v = _qkv((bh, n_pad, d), seed=n + d)
    mask = _mask_levels(bh, n, case["lens"], n_pad)
    want = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask[:, None, :]), 64, 64, "highest")
    got = flash.flash_attention_fwd(*(torch.from_numpy(t)
                                      for t in (q, k, v, mask)))
    for name, g, w in zip(("out", "m", "l"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("n,lens", [(192, None), (192, [150, 100]),
                                    (100, None), (100, [100, 0])],
                         ids=["unmasked", "masked", "n100", "fully_masked"])
def test_wrapper_matches_jax_flash_attention(n, lens):
    q, k, v = _qkv((2, 2, n, 64), seed=n)
    mask = None if lens is None else \
        np.arange(n)[None, :] < np.asarray(lens)[:, None]
    want = np.asarray(jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), block_q=64, block_k=64,
        precision="highest"))
    got = flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 2, n, 64)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if lens is not None and 0 in lens:
        # a fully-masked row averages v over the real keys only
        np.testing.assert_allclose(got[1].numpy(),
                                   np.broadcast_to(v[1].mean(1, keepdims=True),
                                                   (2, n, 64)), **TOL)


def test_wrapper_counts_no_launch_on_cpu():
    before = flash.flash_attention_fwd.launches
    q, k, v = _qkv((1, 1, 64, 32), seed=0)
    flash.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    assert flash.flash_attention_fwd.launches == before
    with pytest.raises(ValueError):
        flash.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                              precision="bf16")


def test_build_takes_a_source_outside_csrc_by_its_path():
    """chip_smoke.py builds tools/flash_fwd_yardsticks.cu, which includes
    csrc/tf32_mma.cuh: named by its path, keyed like the port's sources,
    built beside the port's libraries."""
    from edsnet_torch.kernels import build
    tool = build.PKG.parent / "tools" / "flash_fwd_yardsticks.cu"
    assert build._source("flash_attention_fwd") == (
        build.SRC_DIR / "flash_attention_fwd.cu")
    assert build._source(str(tool)) == tool
    lib = build._lib_path(str(tool))
    assert lib.parent == build.BUILD_DIR
    assert lib.name.startswith("libflash_fwd_yardsticks-")
    assert lib != build._lib_path("flash_attention_fwd")
    assert '#include "tf32_mma.cuh"' in tool.read_text()
