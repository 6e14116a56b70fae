"""edsnet_torch token mixers vs edsnet_tpu on the same weights (through the
weight bridge) and numpy-seeded inputs, to 1e-5: each backbone module
masked and unmasked, its ops (pseudo-inverse, depthwise conv and its
gradients, the Fourier mix, the Haar DWT), padded == unpadded, DSNet
forward and predict with each backbone, the full-width bridge round trip
with ``constants`` and JAX's parameter counts, and the init of each new
leaf."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.models.base import build_base_model as jax_build
from edsnet_tpu.models.fnet import fft_mix as jax_fft_mix
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.models.nystromformer import moore_penrose_pinv as jax_pinv
from edsnet_tpu.ops import depthwise_conv as jax_dconv
from edsnet_tpu.ops.dwt import haar_dwt as jax_dwt
from edsnet_tpu.ops.dwt import haar_idwt as jax_idwt
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_variables
from edsnet_torch.models.base import build_base_model
from edsnet_torch.models.common import init_weights
from edsnet_torch.models.fnet import fft_mix
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.models.nystromformer import moore_penrose_pinv
from edsnet_torch.models.performer import orthogonal_gaussian
from edsnet_torch.ops.depthwise_conv import depthwise_time_conv
from edsnet_torch.ops.dwt import haar_dwt, haar_idwt

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT, HEADS = 32, 2
# (base_model, orientation): every --base-model besides attention, fourier
# at each orientation
BACKBONES = [("nystromformer", "paper"), ("fourier", "temporal"),
             ("fourier", "feature_wise"), ("fourier", "paper"),
             ("performer", "paper"), ("linformer", "paper"),
             ("dwt", "paper"), ("linear", "paper"), ("lstm", "paper"),
             ("bilstm", "paper"), ("gcn", "paper")]
IDS = [b if b != "fourier" else f"fourier-{o}" for b, o in BACKBONES]
# B 3: a full row, a length that is odd and not a multiple of 64, and an
# all-padding row
BUCKET, LENS = 128, [128, 77, 0]


def _inputs(b, n, f, lens, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, f).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lens)[:, None]
    return x * mask[..., None], mask


def _init_jax(model, *args):
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    return model.init(rngs, *map(jnp.asarray, args))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _pair(base, orientation, x, mask):
    """The JAX backbone, its variables, and the port's module on them."""
    jmodel = jax_build(base, FEAT, HEADS, orientation)
    variables = _init_jax(jmodel, x, mask)
    model = build_base_model(base, FEAT, HEADS, orientation=orientation)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("base,orientation", BACKBONES, ids=IDS)
def test_backbone_matches_jax(base, orientation):
    x, mask = _inputs(3, BUCKET, FEAT, LENS, seed=1)
    # unmasked: no zero rows (a constant row is ill-conditioned under a
    # LayerNorm, whatever the implementation)
    x_full, _ = _inputs(3, BUCKET, FEAT, [BUCKET] * 3, seed=11)
    jmodel, variables, model = _pair(base, orientation, x, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        got_full = model(torch.from_numpy(x_full)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mask)))
    want_full = np.asarray(jmodel.apply(variables, jnp.asarray(x_full)))
    assert np.isfinite(got).all() and got.shape == want.shape
    for i, n in enumerate(LENS):
        np.testing.assert_allclose(got[i, :n], want[i, :n], **TOL)
    np.testing.assert_allclose(got_full, want_full, **TOL)


@pytest.mark.parametrize("n", [100, 77])
def test_nystrom_unmasked_front_pad_and_crop(n):
    """n % 64 != 0 without a mask: front-padded to a multiple of 64, the
    last n rows kept."""
    x, mask = _inputs(2, n, FEAT, [n, n], seed=2)
    jmodel, variables, model = _pair("nystromformer", "paper", x, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    assert got.shape == (2, n, FEAT)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("base,orientation", BACKBONES, ids=IDS)
def test_backbone_padded_equals_unpadded(base, orientation):
    n_real = 45
    x, mask = _inputs(1, 64, FEAT, [n_real], seed=3)
    _, _, model = _pair(base, orientation, x, mask)
    with torch.no_grad():
        padded = model(torch.from_numpy(x), torch.from_numpy(mask))
        exact = model(torch.from_numpy(x[:, :n_real]))
    np.testing.assert_allclose(padded[0, :n_real].numpy(), exact[0].numpy(),
                               **TOL)


def test_moore_penrose_pinv_matches_jax():
    """Heads whose scales differ by 10x: z0's scale is the max over the
    video's heads and landmarks, not per head."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 3, 16, 16).astype(np.float32)
    x = x / x.sum(-1, keepdims=True)
    x[:, 1] *= 10.0
    for iters in (0, 1, 6):
        got = moore_penrose_pinv(torch.from_numpy(x), iters).numpy()
        want = np.asarray(jax_pinv(jnp.asarray(x), iters))
        np.testing.assert_allclose(got, want, **TOL)
    # z0 = x^T / (max row sum * max column sum), each max per video over
    # heads and landmarks: head 0 takes head 1's larger sums
    rows = np.abs(x).sum(-1).max(axis=(1, 2))
    cols = np.abs(x).sum(-2).max(axis=(1, 2))
    z0 = np.swapaxes(x, -1, -2) / (rows * cols)[:, None, None, None]
    np.testing.assert_allclose(
        moore_penrose_pinv(torch.from_numpy(x), 0).numpy(), z0, rtol=1e-6)
    alone = moore_penrose_pinv(torch.from_numpy(x[:, :1]), 0).numpy()
    assert (alone > 50 * z0[:, :1]).all()


def test_depthwise_time_conv_matches_jax_vjp():
    rng = np.random.RandomState(5)
    v = rng.randn(2, 3, 50, 8).astype(np.float32)
    w = rng.randn(3, 33).astype(np.float32) * 0.2
    g = rng.randn(2, 3, 50, 8).astype(np.float32)
    want, vjp = jax.vjp(jax_dconv.depthwise_time_conv, jnp.asarray(v),
                        jnp.asarray(w))
    want_dv, want_dw = vjp(jnp.asarray(g))
    tv, tw = (torch.from_numpy(a).requires_grad_() for a in (v, w))
    flag = torch.backends.cudnn.allow_tf32
    got = depthwise_time_conv(tv, tw)
    got.backward(torch.from_numpy(g))
    assert torch.backends.cudnn.allow_tf32 == flag   # left as found
    for a, b in ((got, want), (tv.grad, want_dv), (tw.grad, want_dw)):
        # dw sums B*T*D = 800 products per entry: its f32 rounding is
        # relative to the largest entry, so 1e-5 * max(1, max |want|)
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("orientation", ["temporal", "feature_wise", "paper"])
def test_fft_mix_matches_jax(orientation):
    x, mask = _inputs(3, 40, 16, [40, 27, 0], seed=6)
    for m in (None, mask):
        got = fft_mix(torch.from_numpy(x), orientation,
                      None if m is None else torch.from_numpy(m)).numpy()
        want = np.asarray(jax_fft_mix(jnp.asarray(x), orientation,
                                      None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n", [10, 11])
def test_haar_dwt_matches_jax(n):
    x = np.random.RandomState(n).randn(2, n, 5).astype(np.float32)
    ca, cd = haar_dwt(torch.from_numpy(x), dim=1)
    want_a, want_d = jax_dwt(jnp.asarray(x), axis=1)
    np.testing.assert_allclose(ca.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(cd.numpy(), np.asarray(want_d), **TOL)
    np.testing.assert_allclose(haar_idwt(ca, cd, dim=1).numpy(),
                               np.asarray(jax_idwt(want_a, want_d, axis=1)),
                               **TOL)
    if n % 2 == 0:
        np.testing.assert_allclose(haar_idwt(ca, cd, dim=1).numpy(), x,
                                   **TOL)


def _kwargs(base, orientation, **kw):
    return dict(base_model=base, orientation=orientation, num_feature=FEAT,
                num_hidden=16, anchor_scales=[4, 8], num_head=HEADS,
                fc_depth=2, pooling_type="roi", **kw)


@pytest.mark.parametrize("base,orientation", BACKBONES, ids=IDS)
def test_dsnet_forward_and_predict_match_jax(base, orientation):
    lens = [64, 50, 23]
    x, mask = _inputs(3, 64, FEAT, lens, seed=7)
    kwargs = _kwargs(base, orientation)
    jmodel = jax_get_model("anchor-based", model_depth="shallow",
                           attention_depth=2, encoder_type="classic",
                           **kwargs)
    variables = _init_jax(jmodel, x, mask)
    model = get_model("anchor-based", **kwargs)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    xs, ms = jnp.asarray(x), jnp.asarray(mask)
    want = (*jmodel.apply(variables, xs, ms),
            *jmodel.apply(variables, xs, ms, method="predict"))
    with torch.no_grad():
        tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
        got = (*model(tx, tm), *model.predict(tx, tm))
    for i, n in enumerate(lens):
        for name, a, b, rows in zip(("cls", "loc", "pred_cls", "boxes"), got,
                                    want, (n, n, 2 * n, 2 * n)):
            np.testing.assert_allclose(a[i, :rows].numpy(),
                                       np.asarray(b)[i, :rows], err_msg=name,
                                       **TOL)


# full-width parameter counts of the JAX init (CLI default scales), the
# params collection only; the port's trainable parameters (an LSTM's frozen
# zero bias_ih_l0 is not one)
FULL_PARAMS = {"nystromformer": 2_248_843, "fourier": 1_204_099,
               "performer": 4_353_411, "linformer": 14_351_875,
               "dwt": 1_202_054, "linear": 1_200_003, "lstm": 8_543_107,
               "bilstm": 6_445_955, "gcn": 1_200_003}


@pytest.mark.parametrize("base", sorted(FULL_PARAMS))
def test_bridge_round_trip_full_width(base):
    kwargs = dict(base_model=base, orientation="paper", num_feature=1024,
                  num_hidden=128, anchor_scales=[4, 8, 16, 32], num_head=8,
                  fc_depth=7, pooling_type="roi")
    x, mask = _inputs(1, 16, 1024, [16], seed=8)
    variables = _init_jax(jax_get_model(
        "anchor-based", model_depth="shallow", attention_depth=2,
        encoder_type="classic", **kwargs), x, mask)
    model = get_model("anchor-based", **kwargs)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert sum(p.numel() for p in model.parameters()
               if p.requires_grad) == FULL_PARAMS[base]
    got = state_dict_to_variables(model.state_dict())
    assert sorted(got) == sorted(variables)
    for collection in variables:
        want = dict(_leaves(jax.device_get(variables[collection])))
        have = dict(_leaves(got[collection]))
        assert sorted(have) == sorted(want), collection
        for key in want:
            np.testing.assert_array_equal(have[key], want[key], err_msg=key)
    if base == "performer":
        assert list(got["constants"]["base_model"]["attn_0"]) == [
            "projection"]
        assert got["constants"]["base_model"]["attn_0"][
            "projection"].shape == (266, 64)
        assert "base_model.attn_0.projection" not in dict(
            model.named_parameters())


def test_init_weights_new_leaves():
    """Each raw leaf drawn as the flax init draws it, from the generator."""
    def init(base, seed):
        model = get_model("anchor-based", **_kwargs(base, "paper"))
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.base_model.requires_grad_(False)

    h = HEADS
    res_conv = init("nystromformer", 0).res_conv
    limit = math.sqrt(12.0 / (34 * h))           # fan_in 33h, fan_out h
    assert res_conv.shape == (h, 1, 33, 1)
    assert 0.8 * limit < float(res_conv.abs().max()) <= limit

    dwt = init("dwt", 0)
    assert float(dwt.transconv_kernel.abs().max()) <= math.sqrt(3.0)
    assert dwt.transconv_kernel.shape == (2, 1, 1)
    assert float(dwt.transconv_bias) == pytest.approx(0.1)

    attn = init("linformer", 0).attn_0
    for proj in (attn.proj_k, attn.proj_v):
        assert proj.shape == (5000, 1000)
        assert 0.99 / math.sqrt(1000) < float(proj.abs().max()) \
            <= 1 / math.sqrt(1000)
    assert not torch.equal(attn.proj_k, attn.proj_v)

    proj = init("performer", 0).attn_0.projection
    again = init("performer", 0).attn_0.projection
    other = init("performer", 1).attn_0.projection
    assert proj.shape == (266, 64)
    assert torch.equal(proj, again) and not torch.equal(proj, other)
    # rows within each 64-row block are orthogonal: an orthogonal matrix
    # scaled by per-row gaussian norms
    unit = proj / proj.norm(dim=1, keepdim=True)
    for lo in range(0, 256, 64):
        gram = unit[lo:lo + 64] @ unit[lo:lo + 64].T
        np.testing.assert_allclose(gram.numpy(), np.eye(64), atol=1e-5)
    assert 4.0 < float(proj.norm(dim=1).mean()) < 12.0   # ~sqrt(64)
    # 10 rows of 4 columns: two full QR blocks and half of a third
    direct = orthogonal_gaussian(torch.Generator().manual_seed(3), 10, 4)
    unit = direct / direct.norm(dim=1, keepdim=True)
    np.testing.assert_allclose((unit[8:] @ unit[8:].T).numpy(), np.eye(2),
                               atol=1e-6)
