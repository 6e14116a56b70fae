"""edsnet_torch models vs edsnet_tpu on the same weights (through the
weight bridge) and numpy-seeded inputs: forward and predict to 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.models.attention import AttentionExtractor as JaxAttention
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.kernels import flash_attention as flash
from edsnet_torch.models.attention import AttentionExtractor
from edsnet_torch.models.model_zoo import get_model

TOL = dict(rtol=1e-5, atol=1e-5)
SMALL = dict(base_model="attention", num_feature=64, num_hidden=16,
             anchor_scales=[4, 8], num_head=2, fc_depth=2,
             pooling_type="roi")


def _jax_kwargs(**kw):
    return dict(model_depth="shallow", attention_depth=2,
                encoder_type="classic", orientation="paper", **kw)


def _inputs(b, n, f, lens, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lens)[:, None]
    x = x * mask[..., None]
    return x, mask


def _init_jax(model, x, mask):
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return model.init(rngs, jnp.asarray(x), jnp.asarray(mask))


def _port(kwargs, variables):
    model = get_model("anchor-based", **kwargs)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_bridge_round_trip_full_width():
    full = dict(base_model="attention", num_feature=1024, num_hidden=128,
                anchor_scales=[4, 8, 16, 32], num_head=8, fc_depth=7,
                pooling_type="roi")
    x, mask = _inputs(1, 16, 1024, [16])
    variables = _init_jax(jax_get_model("anchor-based", **_jax_kwargs(**full)),
                          x, mask)
    model = _port(full, variables)
    assert sum(p.numel() for p in model.parameters()) == 4_344_707
    params = jax.device_get(variables["params"])
    want = dict(_leaves(params))
    got = dict(_leaves(state_dict_to_flax(model.state_dict())))
    assert sorted(got) == sorted(want)
    assert want["base_model/Q/kernel"].shape == (1024, 1024)
    assert want["trunk/fc1/kernel"].shape == (1024, 128)
    assert want["heads/fc_loc/kernel"].shape == (128, 2)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["dense", "flash_twin"])
def test_attention_extractor_matches_jax(use_pallas):
    x, mask = _inputs(2, 64, 64, [64, 41], seed=1)
    jmodel = JaxAttention(num_head=2, num_feature=64, use_pallas=use_pallas,
                          pallas_min_len=0, pallas_precision="highest")
    variables = _init_jax(jmodel, x, mask)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mask)))
    model = AttentionExtractor(2, 64, use_flash=use_pallas).eval()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    before = flash.flash_attention_fwd.launches
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert flash.flash_attention_fwd.launches == before   # CPU: the twin
    # compare real query rows; padded rows are discarded downstream
    for i, n in enumerate([64, 41]):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)


def _dsnet_pair(lens, bucket, seed):
    x, mask = _inputs(len(lens), bucket, 64, lens, seed=seed)
    jmodel = jax_get_model("anchor-based", **_jax_kwargs(**SMALL))
    variables = _init_jax(jmodel, x, mask)
    return jmodel, variables, x, mask


def _check_dsnet(jmodel, variables, model, x, mask, lens):
    xs, ms = jnp.asarray(x), jnp.asarray(mask)
    want_cls, want_loc = jmodel.apply(variables, xs, ms)
    want_pc, want_boxes = jmodel.apply(variables, xs, ms, method="predict")
    with torch.no_grad():
        tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
        cls, loc = model(tx, tm)
        pc, boxes = model.predict(tx, tm)
    scales = len(SMALL["anchor_scales"])
    for i, n in enumerate(lens):
        np.testing.assert_allclose(cls[i, :n].numpy(),
                                   np.asarray(want_cls)[i, :n], **TOL)
        np.testing.assert_allclose(loc[i, :n].numpy(),
                                   np.asarray(want_loc)[i, :n], **TOL)
        np.testing.assert_allclose(pc[i, :n * scales].numpy(),
                                   np.asarray(want_pc)[i, :n * scales], **TOL)
        np.testing.assert_allclose(boxes[i, :n * scales].numpy(),
                                   np.asarray(want_boxes)[i, :n * scales],
                                   **TOL)


def test_dsnet_forward_and_predict_match_jax():
    lens = [64, 50, 23]
    jmodel, variables, x, mask = _dsnet_pair(lens, 64, seed=2)
    _check_dsnet(jmodel, variables, _port(SMALL, variables), x, mask, lens)


def test_dsnet_flash_route_matches_jax():
    """--use-pallas: the kernel route (the CPU twin) against JAX's dense
    route."""
    lens = [64, 37]
    jmodel, variables, x, mask = _dsnet_pair(lens, 64, seed=3)
    model = _port({**SMALL, "use_pallas": True}, variables)
    assert model.base_model.use_flash is True
    _check_dsnet(jmodel, variables, model, x, mask, lens)


@pytest.mark.parametrize("n_real", [21, 32])
def test_dsnet_padded_equals_unpadded(n_real):
    jmodel, variables, x, mask = _dsnet_pair([n_real], 64, seed=4)
    model = _port(SMALL, variables)
    with torch.no_grad():
        pad_cls, pad_loc = model(torch.from_numpy(x), torch.from_numpy(mask))
        cls, loc = model(torch.from_numpy(x[:, :n_real]))
    np.testing.assert_allclose(pad_cls[0, :n_real].numpy(), cls[0].numpy(),
                               **TOL)
    np.testing.assert_allclose(pad_loc[0, :n_real].numpy(), loc[0].numpy(),
                               **TOL)


def test_unported_options_raise():
    """No depth is left unported (the motion head, cross-attention, was
    the last); a window pooling at more than one anchor scale is refused,
    as JAX asserts."""
    model = get_model("anchor-based", model_depth="cross-attention", **SMALL)
    assert type(model).__name__ == "DSNetMotionFeatures"
    for pooling in ("dwt", "fft", "flat-pooling"):
        with pytest.raises(ValueError, match="single scale"):
            get_model("anchor-based", **{**SMALL, "pooling_type": pooling})
    with pytest.raises(ValueError, match="Invalid pooling type"):
        get_model("anchor-based", **{**SMALL, "anchor_scales": [4],
                                     "pooling_type": "avg"})
