"""edsnet_torch's motion head (``--model-depth cross-attention``) vs
edsnet_tpu on the CPU, on the same numpy-seeded inputs and weights through
the weight bridge: the flax MHA port (an all-padding row with an all-False
motion mask), flax's default init of its DenseGeneral projections, the
bridge's round trip, DSNetMotionFeatures' forward and predict (both
encoders, a motion width other than F, the fused heads and the oracle),
the motion batches, the per-video F of the device evaluator, one
ab_train_step (f32 to 1e-5, remat, and bf16 held to JAX's jitted step by
the distance to float64), and the contracts of tests/test_motion_training.py
on the port's CLIs.

Widths: F 64 (the decoder's 8 heads are 8 wide), --num-head 2, hidden 8,
motion widths 64 and 48, lengths 20 to 28."""
import copy

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import linen as fnn

from edsnet_tpu import evaluate as jax_evaluate
from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.dsnet import DSNetMotionFeatures as JaxMotion
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import eval_device as jax_eval
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.config import get_arguments
from edsnet_torch.convert import (flax_to_state_dict, state_dict_to_flax,
                                  state_dict_to_variables)
from edsnet_torch.data import batching
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.common import Dropout, init_weights
from edsnet_torch.models.dsnet import DSNetMotionFeatures
from edsnet_torch.models.mha import DenseGeneral, MultiHeadDotProductAttention
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import eval_device as port_eval
from edsnet_torch.parallel import steps
from tests.test_torch_train import _leaves

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT = 64
LR, WD = 5e-5, 1e-5
# id -> (encoder type, motion width, attention depth, fused ROI heads)
CASES = {"classic-64-d1": ("classic", 64, 1, True),
         "classic-48-d2": ("classic", 48, 2, True),
         "local-global-64-d2": ("local-global", 64, 2, True),
         "local-global-48-d1": ("local-global", 48, 1, True),
         "classic-48-d1-oracle": ("classic", 48, 1, False)}


def _kwargs(encoder="classic", depth=1):
    return dict(base_model="attention", num_feature=FEAT, num_hidden=8,
                anchor_scales=[4, 8], num_head=2, fc_depth=1,
                attention_depth=depth, encoder_type=encoder,
                orientation="paper", pooling_type="roi",
                model_depth="cross-attention")


def _pair(case, x, motion, mask, motion_mask):
    """JAX's module and variables, and the port's module on them."""
    encoder, width, depth, fused = CASES[case]
    kw = _kwargs(encoder, depth)
    jmodel = JaxMotion("attention", FEAT, 8, (4, 8), 2, depth, encoder,
                       fused_roi_head=fused)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            *map(jnp.asarray, (x, motion, mask,
                                               motion_mask)))
    model = DSNetMotionFeatures("attention", FEAT, 8, [4, 8], 2, depth,
                                encoder, fused_roi_head=fused,
                                motion_width=width)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    assert type(get_model("anchor-based", **kw)) is DSNetMotionFeatures
    return jmodel, variables, model


def _inputs(width, seed=0):
    """B 3 at bucket 32 of unit-norm features: lengths 28 and 21 with
    motion of 27 and 21 rows, and a row of padding (both masks all
    False)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 32, FEAT).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mask = np.arange(32)[None, :] < np.array([[28], [21], [0]])
    motion = rng.randn(3, 32, width).astype(np.float32)
    motion_mask = np.arange(32)[None, :] < np.array([[27], [21], [0]])
    return (x * mask[..., None], motion * motion_mask[..., None], mask,
            motion_mask)


# ------------------------------------------------------------ the modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_matches_flax_on_an_all_masked_row(dtype):
    """A row whose keys are all masked gets flax's uniform weights over
    them (SDPA with a boolean mask gives zeros there in this torch, NaN in
    others); the other rows equal flax's, at float32 to 1e-5 and at
    bfloat16 within two bfloat16 spacings of the output's scale."""
    rng = np.random.RandomState(1)
    q = rng.randn(3, 20, FEAT).astype(np.float32)
    kv = rng.randn(3, 24, 48).astype(np.float32)
    mask = np.arange(24)[None, :] < np.array([[24], [9], [0]])
    flax_mha = fnn.MultiHeadDotProductAttention(num_heads=8)
    variables = flax_mha.init(jax.random.PRNGKey(0), q, kv,
                              mask=mask[:, None, None, :])
    mha = MultiHeadDotProductAttention(8, FEAT, 48)
    mha.load_state_dict(flax_to_state_dict(variables), strict=True)
    jdt = jnp.dtype(dtype)
    params = jax.tree.map(lambda a: a.astype(jdt), variables)
    want = np.asarray(flax_mha.apply(params, q.astype(jdt), kv.astype(jdt),
                                     mask=mask[:, None, None, :]),
                      np.float32)
    tdt = getattr(torch, dtype)
    with torch.no_grad():
        got = mha.to(tdt)(torch.from_numpy(q).to(tdt),
                          torch.from_numpy(kv).to(tdt),
                          torch.from_numpy(mask)).float().numpy()
    assert np.isfinite(got).all()
    tol = 1e-5 if dtype == "float32" else 2 * 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if dtype == "float32":
        # the all-masked row attends to every key alike
        with torch.no_grad():
            uniform = mha.out(mha.value(torch.from_numpy(kv[2])).mean(0))
        np.testing.assert_allclose(got[2], np.broadcast_to(
            uniform.numpy(), got[2].shape), rtol=0, atol=tol)
    # flax's weights average the values (all ones here); SDPA's do not
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        torch.zeros(1, 1, 2, 8), torch.zeros(1, 1, 3, 8),
        torch.ones(1, 1, 3, 8), attn_mask=torch.zeros(1, 1, 1, 3,
                                                      dtype=torch.bool))
    assert not torch.allclose(sdpa, torch.ones(()))


def test_dense_general_init_is_flax_lecun_normal():
    """The projections' draws have flax's distribution: std sqrt(1 /
    fan_in) with fan_in the product of the contracted axes, no draw past
    2 sigma of the untruncated normal, zero bias; init_weights draws
    them so, and the Linears as before."""
    gen = torch.Generator().manual_seed(0)
    for in_shape, out_shape in (((256,), (8, 64)), ((8, 64), (256,))):
        layer = DenseGeneral(in_shape, out_shape)
        with torch.no_grad():
            layer.bias.fill_(1.0)
        layer.init_leaves(gen)
        fan_in = int(np.prod(in_shape))
        flax_draw = np.asarray(fnn.DenseGeneral(
            out_shape, axis=tuple(range(-len(in_shape), 0))).init(
            jax.random.PRNGKey(0), jnp.zeros((1,) + in_shape))["params"]
            ["kernel"])
        w = layer.weight.detach().numpy()
        assert w.shape == flax_draw.shape
        limit = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        for draws in (w, flax_draw):
            assert abs(draws.std() / np.sqrt(1.0 / fan_in) - 1) < 0.02
            assert np.abs(draws).max() <= limit
            assert np.abs(draws).max() > 0.95 * limit
        assert not layer.bias.detach().numpy().any()
    model = get_model("anchor-based", motion_width=48, **_kwargs())
    init_weights(model, torch.Generator().manual_seed(3))
    key = model.decoder_0.cross_attn.key
    assert key.weight.shape == (48, 8, 8) and not key.bias.detach().any()
    limit = 2 * np.sqrt(1 / 48) / 0.8796
    assert float(key.weight.detach().abs().max()) <= limit
    assert torch.all(model.decoder_0.ff1.bias == 0.1)


@pytest.mark.parametrize("case", ["classic-48-d2", "local-global-64-d2"])
def test_bridge_round_trip_with_dense_general(case):
    """flax -> torch -> flax gives back every leaf, DenseGeneral kernels
    [in, H, D] and [H, D, F] untransposed."""
    jmodel, variables, model = _pair(case, *_inputs(CASES[case][1]))
    back = state_dict_to_variables(model.state_dict())
    assert sorted(back) == ["params"]
    want = dict(_leaves(jax.tree.map(np.asarray, variables["params"])))
    got = dict(_leaves(back["params"]))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape and np.array_equal(got[name], w), \
            name
    assert got["decoder_0/cross_attn/key/kernel"].shape == (
        CASES[case][1], 8, 8)
    assert got["decoder_0/self_attn/out/kernel"].shape == (8, 8, FEAT)
    assert sorted(variables["params"])[:3] == ["decoder_0", "decoder_1",
                                               "encoder"]
    assert {"fc_cls", "fc_loc"} <= set(variables["params"])


@pytest.mark.parametrize("case", list(CASES))
def test_motion_forward_and_predict_match_jax(case):
    inputs = _inputs(CASES[case][1], seed=len(case))
    jmodel, variables, model = _pair(case, *inputs)
    want = jmodel.apply(variables, *map(jnp.asarray, inputs))
    want_pred = jmodel.apply(variables, *map(jnp.asarray, inputs),
                             method="predict")
    model.eval()
    with torch.no_grad():
        got = model(*map(torch.from_numpy, inputs))
        got_pred = model.predict(*map(torch.from_numpy, inputs))
    for name, g, w in zip(("cls", "loc", "pred_cls", "boxes"),
                          got + got_pred, want + want_pred):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(np.abs(w)
                                                              .max())))
    assert np.isfinite(got[0].numpy()).all()


def test_set_motion_width_rebuilds_only_the_memory_projections():
    model = get_model("anchor-based", **_kwargs(depth=2))
    assert model.motion_width == FEAT
    before = {k: v.shape for k, v in model.state_dict().items()}
    model.set_motion_width(48)
    after = {k: v.shape for k, v in model.state_dict().items()}
    changed = sorted(k for k in before if before[k] != after[k])
    assert changed == [f"decoder_{i}.cross_attn.{p}.weight" for i in (0, 1)
                       for p in ("key", "value")]
    assert model.motion_width == 48
    assert port_eval.checkpoint_motion_width(model.state_dict()) == 48
    with pytest.raises(ValueError, match="no cross_attn"):
        port_eval.checkpoint_motion_width(get_model(
            "anchor-based", **{**_kwargs(), "model_depth": "deep"})
            .state_dict())


# ------------------------------------------------------------ batching

def _video(rng, key, n_seq, width, users=3, motion=True):
    n_frames = n_seq * 15
    feats = rng.randn(n_seq, FEAT).astype(np.float32)
    bounds = np.linspace(0, n_frames, 11, dtype=np.int32)
    return dict(key=key,
                seq=feats / np.linalg.norm(feats, axis=-1, keepdims=True),
                gtscore=rng.rand(n_seq).astype(np.float32),
                cps=np.stack([bounds[:-1], bounds[1:] - 1], 1),
                n_frames=n_frames,
                nfps=(bounds[1:] - bounds[:-1]).astype(np.int32),
                picks=np.arange(n_seq, dtype=np.int32) * 15,
                user_summary=(rng.rand(users, n_frames) > 0.8
                              ).astype(np.float32),
                motion_features=(rng.randn(n_seq, width).astype(np.float32)
                                 if motion else None))


def _records(width, lengths=(20, 24, 28, 21, 26), seed=0):
    rng = np.random.RandomState(seed)
    return [_video(rng, f"d/tvsum_{i}" if i % 2 else f"d/summe_{i}", n,
                   width) for i, n in enumerate(lengths)]


def test_motion_batches_match_jax():
    """Train batches, pools and eval batches carry JAX's motion arrays
    (M rounded to 16, padding rows empty); need_motion=False drops them;
    a chunk with motion on some videos only raises in both packages."""
    videos = _records(48)
    items = batching.prepare_items([VideoRecord(**v) for v in videos],
                                   "anchor-based", [4, 8], bucket_size=16)
    jitems = jax_batching.prepare_items([JaxRecord(**v) for v in videos],
                                        "anchor-based", [4, 8],
                                        bucket_size=16)
    assert len(items) == len(jitems) == 5
    pairs = list(zip(batching.batch_items(items, 2, 16, False,
                                          pad_batch_to=3),
                     jax_batching.batch_items(jitems, 2, 16, False,
                                              pad_batch_to=3)))
    pairs += list(zip(batching.pool_items(items, 16),
                      jax_batching.pool_items(jitems, 16)))
    for got, want in pairs:
        assert got["motion"].shape[1] % 16 == 0
        for k in ("motion", "motion_mask", "seq", "mask"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    plain = batching.prepare_items([VideoRecord(**v) for v in videos],
                                   "anchor-based", [4, 8], bucket_size=16,
                                   need_motion=False)
    assert "motion" not in next(batching.batch_items(plain, 2, 16, False))

    records = [VideoRecord(**v) for v in videos]
    jrecords = [JaxRecord(**v) for v in videos]
    for need in (None, True):
        got = list(port_eval.batch_eval_device(records, 2, 32, need))
        want = list(jax_eval.batch_eval_device(jrecords, 2, 32, need))
        for g, w in zip(got, want):
            for k in ("motion", "motion_mask"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert all("motion" not in b for b in port_eval.batch_eval_device(
        records, 2, 32, need_motion=False))

    partial = [VideoRecord(**{**v, "motion_features": None}) if i == 1
               else VideoRecord(**v) for i, v in enumerate(videos)]
    jpartial = [JaxRecord(**r._asdict()) for r in partial]
    for need in (None, True):
        with pytest.raises(ValueError, match="motion_features missing"):
            list(port_eval.batch_eval_device(partial, 2, 32, need))
        with pytest.raises(ValueError, match="motion_features missing"):
            list(jax_eval.batch_eval_device(jpartial, 2, 32, need))
    part_items = batching.prepare_items(partial, "anchor-based", [4, 8],
                                        bucket_size=64)
    with pytest.raises(ValueError, match="motion_features missing"):
        batching.pool_items(part_items, 64)
    for need in (True, None, False):
        assert batching.resolve_build_motion(records[:2], need) == \
            jax_batching.resolve_build_motion(jrecords[:2], need)


class _Given:
    """A stand-in for a flax module whose predict returns the
    predictions it is given as its variables."""

    def apply(self, variables, *args, method=None):
        return variables


@pytest.mark.parametrize("case", ["classic-48-d2", "local-global-64-d2"])
def test_motion_eval_matches_jax_per_video(case):
    """On converted weights and JAX's motion eval batches: pred_cls and
    boxes within 1e-5 of JAX's; JAX's eval program (NMS, rasterisation,
    knapsack, F) run on the port's predictions gives the port's per-video
    F and summaries exactly; and the port's per-video F equals JAX's whole
    program on every video whose JAX scores hold no exact tie.  A tie
    comes from rows that a dead ReLU zeroes at hidden 8: their pooled
    scores are equal in JAX's arithmetic and 1 ulp apart in the port's
    (each package's cumsum leaves its own rounding residue), so NMS may
    keep the other box of the tie.  The host evaluator gives the device
    evaluator's per-video F."""
    width = CASES[case][1]
    videos = _records(width, lengths=(20, 24, 28, 21, 26, 22), seed=2)
    records = [VideoRecord(**v) for v in videos]
    jrecords = [JaxRecord(**v) for v in videos]
    jbatches = jax_eval.prepare_eval_batches(jrecords, 4, 32,
                                             need_motion=True)
    jb = jbatches[0]["jb"]
    jmodel, variables, model = _pair(case, jb["seq"], jb["motion"],
                                     jb["mask"], jb["motion_mask"])
    model.eval()
    batches = port_eval.prepare_eval_batches(records, 4, 32, "cpu",
                                             need_motion=True)
    untied = 0
    for jbatch, tbatch in zip(jbatches, batches):
        jb, tb = jbatch["jb"], tbatch["tb"]
        want = [np.asarray(t) for t in jmodel.apply(
            variables, jb["seq"], jb["motion"], jb["mask"], jb["motion_mask"],
            method="predict")]
        with torch.no_grad():
            got = [t.numpy() for t in model.predict(
                tb["seq"], tb["motion"], tb["mask"], tb["motion_mask"])]
        real = np.repeat(np.asarray(jb["mask"]), 2, axis=1)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[real], w[real], rtol=0, atol=1e-5 *
                                       max(1.0, float(np.abs(w).max())))
        post = [(_Given(), tuple(map(jnp.asarray, got))),
                (jmodel, variables)]
        (given_f, given_s), (want_f, want_s) = (
            jax_eval._eval_batch_device(
                m, v, jb, 2, 0.5, jbatch["frame_bucket"],
                uniform_rate=jbatch["uniform_rate"]) for m, v in post)
        got_f, got_s = port_eval._eval_batch_device(
            model, tb, 2, 0.5, tbatch["frame_bucket"],
            uniform_rate=tbatch["uniform_rate"])
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(given_s))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(given_f))
        for j, lens in enumerate(np.asarray(jb["lens"])):
            scores = want[0][j, :2 * lens]
            if lens and np.unique(scores).size == scores.size:
                untied += 1
                assert abs(float(got_f[j]) - float(want_f[j])) <= 1e-6
    assert untied >= 4
    device_videos, host_videos = [], []
    port_eval.evaluate_on_device(model, records, 0.5, batch_size=4,
                                 bucket_size=32, per_video=device_videos)
    port_evaluate.evaluate(model, records, 0.5, batch_size=4, bucket_size=32,
                           per_video=host_videos)
    assert len(device_videos) == len(host_videos) == len(records)
    for d, h in zip(device_videos, host_videos):
        assert abs(d["fscore"] - h["fscore"]) <= 1e-6


# ------------------------------------------------------------ the train step

def _step_batch(width, seed=4):
    """Two videos (21 and 28 positions) in one bucket of 32 and a third
    row of padding, with JAX's sampled cls labels."""
    videos = _records(width, lengths=(21, 28), seed=seed)
    jitems = [jax_batching.prepare_ab_item(
        JaxRecord(**v), anchor_scales=[4, 8], pos_iou=0.6, neg_iou=0.0,
        inc_iou=0.3, bucket_size=32) for v in videos]
    batch = next(jax_batching.batch_items(jitems, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    label = np.array(jax_steps.build_ab_cls_labels(
        {k: jnp.asarray(batch[k]) for k in ("cls_pos", "neg_eligible",
                                            "inc_eligible", "num_pos")},
        jax.random.PRNGKey(3), 2.0, 1.0))
    return batch, label


STEP_KEYS = ("seq", "motion", "mask", "motion_mask", "loc_label",
             "video_valid", "num_pos")


def _jax_grad_fn(jmodel, dtype=jnp.float32, remat=False):
    """JAX's jitted ((loss, (cls, loc)), gradients) of ab_train_step's
    motion branch (steps.py:155-159) at deterministic=True, as a function
    of the params, a batch of STEP_KEYS arrays and the cls labels."""
    def loss_fn(p, batch, label):
        def fwd(p):
            if dtype != jnp.float32:
                p = jax_steps._cast_floats(p, dtype)
            out = jmodel.apply({"params": p}, batch["seq"].astype(dtype),
                               batch["motion"].astype(dtype), batch["mask"],
                               batch["motion_mask"], deterministic=True)
            return jax.tree.map(lambda t: t.astype(jnp.float32), out)

        pred_cls, pred_loc = (jax.checkpoint(fwd) if remat else fwd)(p)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, batch["loc_label"],
                                               label)
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, label)
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).astype(
            jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        return jnp.sum((cls + loc) * w) / denom, (
            jnp.sum(cls * w) / denom, jnp.sum(loc * w) / denom)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_step(jmodel, params, batch, label, remat=False):
    """JAX's losses, gradients and Adam-updated params of one step."""
    (loss, parts), grads = _jax_grad_fn(jmodel, remat=remat)(
        params, {k: batch[k] for k in STEP_KEYS}, label)
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    return ((float(loss),) + tuple(map(float, parts)), grads,
            optax.apply_updates(params, updates))


# the key projections' biases: a bias on the keys adds q . b to every
# logit of a query, which the softmax ignores, so their exact gradient is 0
# and the f32 one rounding noise, which Adam turns into a step of up to lr
# whose sign is the noise's
KEY_BIASES = ("self_attn/key/bias", "cross_attn/key/bias")


def _port_step(model, batch, label, **flags):
    for module in model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    optimizer = steps.make_optimizer(model.parameters(), LR, WD)
    metrics = steps.ab_train_step(
        model, optimizer, trainer.to_device(batch, torch.device("cpu")),
        None, lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
        cls_label=torch.from_numpy(label), **flags)
    grads = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})))
    params = dict(_leaves(state_dict_to_flax(model.state_dict())))
    return metrics, grads, params, optimizer


@pytest.mark.parametrize("case,remat", [("classic-48-d2", False),
                                        ("local-global-64-d2", False),
                                        ("classic-48-d1-oracle", True)])
def test_motion_train_step_matches_jax(case, remat):
    """Losses, every gradient leaf (within 1e-5 x max(1, max |leaf|)) and
    every Adam-updated parameter equal JAX's; under remat the motion is an
    input of the recomputed forward, as in JAX."""
    batch, label = _step_batch(CASES[case][1])
    assert (label == 1).any() and (label == -1).any()
    jmodel, variables, model = _pair(case, batch["seq"], batch["motion"],
                                     batch["mask"], batch["motion_mask"])
    want, grads, new_params = _jax_step(jmodel, variables["params"], batch,
                                        label, remat=remat)
    metrics, got_grads, got_params, _ = _port_step(model, batch, label,
                                                   remat=remat)
    for name, w in zip(("loss", "cls_loss", "loc_loss"), want):
        np.testing.assert_allclose(float(metrics[name]), w, err_msg=name,
                                   **TOL)
    want_grads = dict(_leaves(jax.tree.map(np.asarray, grads)))
    assert sorted(got_grads) == sorted(want_grads)
    for name, w in want_grads.items():
        np.testing.assert_allclose(got_grads[name], w, err_msg=name,
                                   rtol=1e-5, atol=1e-5 * max(
                                       1.0, float(np.abs(w).max())))
    old = dict(_leaves(jax.tree.map(np.asarray, variables["params"])))
    n_key_biases = 0
    for name, w in _leaves(jax.tree.map(np.asarray, new_params)):
        if name.endswith(KEY_BIASES):
            n_key_biases += 1
            for g in (got_grads[name], want_grads[name]):
                assert np.abs(g).max() <= 1e-6, name
            for p in (got_params[name], w):
                assert np.abs(p - old[name]).max() <= LR * (1 + 1e-5), name
            continue
        np.testing.assert_allclose(got_params[name], w, err_msg=name, **TOL)
    assert n_key_biases == 2 * CASES[case][2]
    moved = [n for n, w in _leaves(variables["params"])
             if not np.array_equal(np.asarray(w), got_params[n])]
    assert len(moved) == len(got_params)


BF16_BATCHES = 8


def test_motion_bf16_step_as_close_to_f64_as_jax():
    """The port's bf16 step (motion cast with seq) against JAX's jitted
    bf16 step, each by its distance to the port's float64 step over 8
    batches (the first 8 seeds whose videos hold a positive anchor: a
    batch without one has a zero loss and no gradient): the median loss
    gap within 2x JAX's plus 1e-6, the median relative L2 gap of all
    gradient leaves within 2x JAX's;
    masters and Adam moments stay float32.  The median, as in the
    anchor-free bf16 test: at hidden 8 one bf16 rounding that lets a ReLU
    through before the LayerNorm of a near-constant row moves either
    package's step far past its typical gap on some batches."""
    batch, label = _step_batch(48)
    jmodel, variables, model0 = _pair("classic-48-d2", batch["seq"],
                                      batch["motion"], batch["mask"],
                                      batch["motion_mask"])
    grad_fn = _jax_grad_fn(jmodel, jnp.bfloat16)
    port, ref = [], []
    seeds = (seed for seed in range(100)
             if (_step_batch(48, seed)[1] == 1).any())
    for seed in [next(seeds) for _ in range(BF16_BATCHES)]:
        batch, label = _step_batch(48, seed)
        model = copy.deepcopy(model0)
        f64 = copy.deepcopy(model0).double()
        metrics, grads, _, optimizer = _port_step(model, batch, label,
                                                  compute_dtype="bfloat16")
        batch64 = {**batch, "seq": batch["seq"].astype(np.float64),
                   "motion": batch["motion"].astype(np.float64)}
        metrics64, grads64, _, _ = _port_step(f64, batch64, label)
        (loss, _), jax_grads = grad_fn(
            variables["params"], {k: batch[k] for k in STEP_KEYS}, label)
        names = sorted(grads64)
        jax_grads = dict(_leaves(jax.tree.map(np.asarray, jax_grads)))
        assert sorted(grads) == sorted(jax_grads) == names

        def flat(tree):
            return np.concatenate([np.asarray(tree[n], np.float64).ravel()
                                   for n in names])

        want, loss64 = flat(grads64), float(metrics64["loss"])
        for out, got_loss, got in ((port, float(metrics["loss"]), grads),
                                   (ref, float(loss), jax_grads)):
            out.append((abs(got_loss - loss64),
                        np.linalg.norm(flat(got) - want)
                        / np.linalg.norm(want)))
    port, ref = np.asarray(port), np.asarray(ref)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    got, want = np.median(port, axis=0), np.median(ref, axis=0)
    assert got[0] <= 2 * want[0] + 1e-6, (got, want)
    assert got[1] <= 2 * want[1], (got, want)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for st in optimizer.state.values()
               for t in st.values() if t.dim())


# ------------------------------------------------------------ the CLIs

def _write_motion_h5(tmp_path, seed, motion_dim=FEAT, motion=True):
    """tests/test_motion_training.py's h5 at F 64: three videos (20, 24
    and 28 positions), two to train and one to test."""
    rng = np.random.RandomState(seed)
    with h5py.File(tmp_path / "mock_tvsum.h5", "w") as f:
        for i, n_seq in enumerate([20, 24, 28]):
            v = _video(rng, "", n_seq, motion_dim, users=2, motion=motion)
            g = f.create_group(f"video_{i}")
            g["features"] = v["seq"]
            g["gtscore"] = v["gtscore"]
            g["change_points"] = v["cps"]
            g["n_frame_per_seg"] = v["nfps"]
            g["n_frames"] = v["n_frames"]
            g["picks"] = v["picks"]
            g["user_summary"] = v["user_summary"]
            if motion:
                g["motion_features"] = v["motion_features"]
    keys = [f"d/mock_tvsum.h5/video_{i}" for i in range(3)]
    split = tmp_path / "mock.yml"
    split.write_text(yaml.dump([{"train_keys": keys[:2],
                                 "test_keys": keys[2:]}]))
    return split


MOTION_ARGS = ["anchor-based", "--device", "cpu", "--model-depth",
               "cross-attention", "--base-model", "attention",
               "--max-epoch", "1", "--num-feature", str(FEAT),
               "--num-hidden", "8", "--fc-depth", "1",
               "--attention-depth", "1", "--num-head", "2",
               "--bucket-size", "32", "--batch-size", "2",
               "--anchor-scales", "4"]


def _printed_f(out):
    line = [ln for ln in out.splitlines() if ln.startswith("mock:")][-1]
    return float(line.rsplit("F-score:", 1)[1])


@pytest.mark.parametrize("width,encoder", [(FEAT, "classic"),
                                           (48, "classic"),
                                           (48, "local-global")])
def test_train_evaluate_cli_motion_round_trip(tmp_path, capsys, width,
                                              encoder):
    """Train one epoch, then evaluate (device and --host-eval) the best
    checkpoint: the trained F, at motion width F and at another one."""
    split = _write_motion_h5(tmp_path, 1, width)
    argv = MOTION_ARGS + ["--encoder-type", encoder, "--splits", str(split),
                          "--data-root", str(tmp_path), "--model-dir",
                          str(tmp_path / "m")]
    port_train.main(argv)
    train_f = yaml.safe_load((tmp_path / "m" / "mock.yml").read_text())[
        "mean"]
    assert 0.0 <= train_f <= 1.0
    state = torch.load(tmp_path / "m" / "checkpoint" / "mock.yml.0.pt",
                       weights_only=True)
    assert port_eval.checkpoint_motion_width(state) == width
    capsys.readouterr()
    for extra in ([], ["--host-eval"]):
        port_evaluate.main(argv + extra)
        assert abs(_printed_f(capsys.readouterr().out) - train_f) < 1e-3


def test_evaluate_cli_reads_jax_motion_checkpoint(tmp_path, capsys):
    """A JAX-written checkpoint of the motion head at motion width 48:
    both evaluate CLIs print the same lines, on the device evaluator and
    on the host one."""
    split = _write_motion_h5(tmp_path, 5, 48)
    argv = MOTION_ARGS + ["--attention-depth", "2", "--splits", str(split),
                          "--data-root", str(tmp_path), "--model-dir",
                          str(tmp_path / "model")]
    jmodel = JaxMotion("attention", FEAT, 8, (4,), 2, 2)
    variables = jmodel.init({"params": jax.random.PRNGKey(2),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, FEAT)), jnp.zeros((1, 32, 48)),
                            jnp.ones((1, 32), bool), jnp.ones((1, 32), bool))
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    for extra in ([], ["--host-eval"]):
        jax_evaluate.main(argv + extra)
        want = capsys.readouterr().out.strip().splitlines()
        port_evaluate.main(argv + extra)
        got = capsys.readouterr().out.strip().splitlines()
        assert len(want) == 2 and "F-score" in want[-1]
        assert got == want


def test_non_motion_model_ignores_motion_h5(tmp_path):
    split = _write_motion_h5(tmp_path, 2)
    port_train.main(["anchor-based", "--device", "cpu", "--base-model",
                     "linear", "--splits", str(split), "--data-root",
                     str(tmp_path), "--model-dir", str(tmp_path / "plain"),
                     "--max-epoch", "1", "--num-feature", str(FEAT),
                     "--num-hidden", "8", "--fc-depth", "1", "--num-head",
                     "2", "--bucket-size", "32", "--batch-size", "2",
                     "--anchor-scales", "4"])
    results = yaml.safe_load((tmp_path / "plain" / "mock.yml").read_text())
    assert 0.0 <= results["mean"] <= 1.0


def test_motion_cli_raises_on_width_mismatch_and_missing_motion(tmp_path):
    """A width-48 checkpoint on a width-64 h5 raises "expects width 48";
    training the motion head on an h5 without motion raises."""
    a, b, c = (tmp_path / n for n in "abc")
    for d in (a, b, c):
        d.mkdir()
    split_a = _write_motion_h5(a, 3, 48)
    port_train.main(MOTION_ARGS + ["--splits", str(split_a), "--data-root",
                                   str(a), "--model-dir", str(a / "m")])
    split_b = _write_motion_h5(b, 3, FEAT)
    with pytest.raises(ValueError, match="expects width 48"):
        port_evaluate.main(MOTION_ARGS + ["--splits", str(split_b),
                                          "--data-root", str(b),
                                          "--model-dir", str(a / "m")])
    split_c = _write_motion_h5(c, 3, motion=False)
    with pytest.raises(ValueError, match="needs 'motion_features'"):
        port_train.main(MOTION_ARGS + ["--splits", str(split_c),
                                       "--data-root", str(c),
                                       "--model-dir", str(c / "m")])
    args = get_arguments(MOTION_ARGS)
    with pytest.raises(ValueError, match="motion_features missing"):
        trainer.train_records(
            args, [VideoRecord(**_video(np.random.RandomState(0), "d/x", 20,
                                        FEAT))],
            [VideoRecord(**_video(np.random.RandomState(1), "d/y", 20, FEAT,
                                  motion=False))], tmp_path / "x.pt")
