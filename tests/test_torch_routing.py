"""The attention backbone's flash routing
(edsnet_torch/models/attention.py:flash_route): which passes take the CUDA
kernel, at which precision, and which head dims fall back to the dense
path.  The rule is decided from shapes alone, so it is tested here on the
CPU; the AttentionExtractor at a head dim the kernels do not take is held
against edsnet_tpu (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.models.attention import AttentionExtractor as JaxAttention
from edsnet_torch.convert import flax_to_state_dict
from edsnet_torch.kernels import flash_attention as flash
from edsnet_torch.models.attention import AttentionExtractor, flash_route


@pytest.mark.parametrize("head_dim,want", [
    (16, None), (32, "highest"), (64, "highest"), (128, "highest"),
    (256, None)])
def test_auto_route_on_cuda_takes_kernel_head_dims_only(head_dim, want):
    assert flash_route(True, False, 2304, head_dim, None) == want


@pytest.mark.parametrize("head_dim", [16, 128, 256])
def test_auto_route_off_cuda_is_dense(head_dim):
    assert flash_route(False, False, 2304, head_dim, None) is None


@pytest.mark.parametrize("use_pallas", [None, True, False])
@pytest.mark.parametrize("on_cuda", [True, False])
def test_training_always_takes_dense_path(use_pallas, on_cuda):
    assert flash_route(on_cuda, True, 2304, 128, use_pallas) is None


def test_use_pallas_route_precision_and_no_pallas():
    assert flash_route(True, False, 2304, 128, True) == "default"
    # on the CPU --use-pallas runs the plain twin, which takes any D
    assert flash_route(False, False, 100, 256, True) == "default"
    assert flash_route(True, False, 2304, 128, False) is None


@pytest.mark.parametrize("head_dim", [16, 256])
def test_use_pallas_with_unsupported_head_dim_raises_on_cuda(head_dim):
    with pytest.raises(ValueError, match=rf"head dim {head_dim} not in "
                                         rf"HEAD_DIMS \(32, 64, 128\)"):
        flash_route(True, False, 2304, head_dim, True)


def test_route_follows_the_kernels_head_dims():
    assert flash.HEAD_DIMS == (32, 64, 128)
    for d in flash.HEAD_DIMS:
        assert flash_route(True, False, 64, d, None) == "highest"


def test_four_heads_at_full_width_match_jax_under_auto_rule():
    """F 1024 and 4 heads (D = 256, `--num-head 4`): the auto rule keeps
    the dense path (and would on the card), equal to JAX's output."""
    rng = np.random.RandomState(5)
    b, n, f = 2, 40, 1024
    x = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray([40, 27])[:, None]
    jmodel = JaxAttention(num_head=4, num_feature=f)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mask)))
    model = AttentionExtractor(4, f).eval()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert flash_route(True, model.training, n, f // 4,
                            model.use_flash) is None
    before = flash.flash_attention_fwd.launches
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert flash.flash_attention_fwd.launches == before
    for i, n_real in enumerate([40, 27]):
        np.testing.assert_allclose(got[i, :n_real], want[i, :n_real],
                                   rtol=1e-5, atol=1e-5)
