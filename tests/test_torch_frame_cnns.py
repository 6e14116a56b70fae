"""edsnet_torch's frame CNNs (GoogLeNet pool5, ConvNeXt-Base, Swin-V2-B)
vs edsnet_tpu's flax modules on the CPU.

Each port module gets seeded random weights (``randomize_cnn_``: BN
running variances drawn positive, running means nonzero, as chip_smoke.py
draws them); its own ``state_dict`` goes through JAX's
``convert_torch_state_dict`` into the jitted flax ``apply`` on the same
NHWC input, and the port's NCHW output must lie within 1e-4 *
max(1, max|want|).  Sizes: GoogLeNet at 224x224 and at 97x131 (the
ceil-mode drop rule), ConvNeXt at 112x112, Swin at 112x112 (stages 28,
14, 7 and 4: padded and shifted at 14, the clamped shift at 7 and 4);
batch 2.  Also: parameter counts equal the flax trees' (and
torchvision's), ``flax_to_torch_cnn`` inverts each converter exactly,
the Swin buffers equal JAX's tables, and ``preprocess_frame`` is JAX's
bit for bit.  No flax ``init`` is called (its variables come from the
converter)."""
import jax
import numpy as np
import pytest
import torch

from edsnet_torch.convert import flax_to_torch_cnn
from edsnet_torch.data.video import frame_cnn
from edsnet_torch.models.common import randomize_cnn_
from edsnet_torch.models.googlenet import preprocess_frame
from edsnet_torch.models.swin import shift_attn_mask
from edsnet_tpu.models import convnext as jax_convnext
from edsnet_tpu.models import googlenet as jax_googlenet
from edsnet_tpu.models import swin as jax_swin

JAX_MODULES = {
    "google-net": (jax_googlenet.GoogLeNetPool5,
                   jax_googlenet.convert_torch_state_dict),
    "convnext": (jax_convnext.ConvNeXtBaseFeatures,
                 jax_convnext.convert_torch_state_dict),
    "swin-transformer": (jax_swin.SwinV2BFeatures,
                         jax_swin.convert_torch_state_dict),
}
# torchvision's parameter counts without the classifier (fc; classifier;
# head), as jax.eval_shape counts the flax modules
PARAM_COUNTS = {"google-net": 5_599_904, "convnext": 87_564_416,
                "swin-transformer": 86_905_848}


@pytest.fixture(scope="module")
def nets():
    """kind -> (port module, its state_dict, JAX's variables), built once
    per kind on first use."""
    cache = {}

    def get(kind):
        if kind not in cache:
            model, _ = frame_cnn(kind)
            randomize_cnn_(model, torch.Generator().manual_seed(0))
            model.eval()
            sd = model.state_dict()
            cache[kind] = (model, sd, JAX_MODULES[kind][1](sd))
        return cache[kind]
    return get


@pytest.mark.parametrize("kind,hw", [("google-net", (224, 224)),
                                     ("google-net", (97, 131)),
                                     ("convnext", (112, 112)),
                                     ("swin-transformer", (112, 112))])
def test_cnn_matches_flax(nets, kind, hw):
    model, _, variables = nets(kind)
    x = np.random.RandomState(1).randn(2, 3, *hw).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(JAX_MODULES[kind][0]().apply)(
        variables, x.transpose(0, 2, 3, 1)))
    assert got.shape == want.shape == (2, 1024)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("kind", sorted(JAX_MODULES))
def test_param_counts_equal_flax(nets, kind):
    model, _, variables = nets(kind)
    n_flax = sum(np.asarray(leaf).size
                 for leaf in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_flax \
        == PARAM_COUNTS[kind]
    if kind == "google-net":   # BN statistics: 14,560
        assert sum(np.asarray(leaf).size for leaf in jax.tree_util.
                   tree_leaves(variables["batch_stats"])) == 14_560


@pytest.mark.parametrize("kind", sorted(JAX_MODULES))
def test_bridge_inverts_jax_converter(nets, kind):
    """flax_to_torch_cnn(JAX convert(sd)) == sd, buffers included, and it
    loads strictly."""
    model, sd, variables = nets(kind)
    back = flax_to_torch_cnn(kind, variables)
    assert set(back) == set(sd)
    for key, value in sd.items():
        assert back[key].dtype == value.dtype, key
        assert torch.equal(back[key], value), key
    model.load_state_dict(back, strict=True)


def test_swin_buffers_equal_jax_tables():
    model, _ = frame_cnn("swin-transformer")
    attn = model.features[5][3].attn
    np.testing.assert_array_equal(
        attn.relative_coords_table.numpy().reshape(-1, 2),
        jax_swin._relative_coords_table(jax_swin.WINDOW))
    np.testing.assert_array_equal(
        attn.relative_position_index.numpy(),
        jax_swin._relative_position_index(jax_swin.WINDOW).reshape(-1))
    for ph, pw, sh, sw in ((16, 16, 4, 4), (8, 16, 0, 4), (16, 8, 4, 0)):
        np.testing.assert_array_equal(
            shift_attn_mask(ph, pw, 8, sh, sw),
            jax_swin._shift_attn_mask(ph, pw, 8, sh, sw))


@pytest.mark.parametrize("h,w", [(240, 320), (320, 240)])
def test_preprocess_frame_bit_equal(h, w):
    img = (np.random.RandomState(h).rand(h, w, 3) * 255).astype(np.uint8)
    got = preprocess_frame(img)
    want = jax_googlenet.preprocess_frame(img)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (224, 224, 3)
    np.testing.assert_array_equal(got, want)
