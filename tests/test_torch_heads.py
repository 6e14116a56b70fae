"""edsnet_torch's anchor-based heads with a window pooling, its original,
deep and local-global heads, and the anchor-free local-global head, vs
edsnet_tpu on the CPU on the same numpy-seeded inputs and weights (through
the weight bridge): forward and predict to 1e-5 on a batch of mixed
lengths with an all-padding row and a length below the 4 segments, one
ab_train_step / af_train_step to 1e-5 (each gradient leaf to 1e-5 x
max(1, max |leaf|): its sums over every position round in another order),
finite gradients where a local path's rows are all zero, the evaluate CLI
on JAX-written checkpoints, and JAX's parameter counts at full width.

Widths: F 32, hidden 16, 4 heads (2 in each local attention).  At hidden 8
the anchor-free local-global step's gradients sit about 3e-5 (relative)
from float64 in both packages alike (its LayerNorms normalise near-constant
rows), so no f32 comparison can resolve 1e-5 there."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edsnet_tpu import evaluate as jax_evaluate
from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import trainer
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import steps
from tests.test_torch_anchor_free import (STEP_KEYS, _af_batch,
                                          _jax_af_grad_fn, _no_dropout,
                                          _port_af_step)
from tests.test_torch_eval import _videos, _write_dataset
from tests.test_torch_train import _leaves, _video

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT = 32
LR, WD = 5e-5, 1e-5
LG = "local-global-attention"
# id -> (model type, depth, base model, pooling, anchor scales,
#        attention depth)
HEADS = {
    "fft": ("anchor-based", "shallow", "attention", "fft", [12], 2),
    "dwt": ("anchor-based", "shallow", "attention", "dwt", [12], 2),
    "flat": ("anchor-based", "shallow", "attention", "flat-pooling", [12],
             2),
    "original": ("anchor-based", "original", "attention", "roi", [4, 8], 2),
    "deep2": ("anchor-based", "deep", "attention", "roi", [4, 8], 2),
    "deep3": ("anchor-based", "deep", "attention", "roi", [4, 8], 3),
    "lg-attention": ("anchor-based", LG, "attention", "roi", [4, 8], 2),
    "lg-nystromformer": ("anchor-based", LG, "nystromformer", "roi", [4, 8],
                         2),
    "lg-lstm": ("anchor-based", LG, "lstm", "roi", [4, 8], 2),
    "af-lg-attention": ("anchor-free", LG, "attention", "roi", [4], 2),
    "af-lg-nystromformer": ("anchor-free", LG, "nystromformer", "roi", [4],
                            2),
    "af-lg-lstm": ("anchor-free", LG, "lstm", "roi", [4], 2),
}
NAMES = {"shallow": ["base_model", "heads", "layer_norm", "pooling", "trunk"],
         "original": ["base_model", "fc1", "fc1_norm", "fc_cls", "fc_loc",
                      "layer_norm"],
         "deep": ["base_model1", "heads", "trunk"],
         LG: ["heads", "multiattentionblock", "trunk"]}


def _kwargs(head, num_feature=FEAT, num_hidden=16, num_head=4, fc_depth=2):
    model_type, depth, base, pooling, scales, att_depth = HEADS[head]
    return model_type, dict(
        base_model=base, model_depth=depth, pooling_type=pooling,
        anchor_scales=scales, attention_depth=att_depth,
        encoder_type="classic", orientation="paper", num_feature=num_feature,
        num_hidden=num_hidden, num_head=num_head, fc_depth=fc_depth)


def _pair(head, x, mask, **overrides):
    """JAX's module and variables, and the port's module on them."""
    model_type, kw = _kwargs(head)
    kw.update(overrides)
    jmodel = jax_get_model(model_type, **kw)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(mask))
    model = get_model(model_type, **kw)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model


def _inputs(seed=0):
    """B 4 at bucket 80 of unit-norm features: a full row, a length not
    divisible by 4, an all-padding row, and a length of 3, whose 4th
    segment is empty."""
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 80, FEAT).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mask = np.arange(80)[None, :] < np.array([[80], [57], [0], [3]])
    return x * mask[..., None], mask


@pytest.mark.parametrize("head", list(HEADS))
def test_head_forward_and_predict_match_jax(head):
    x, mask = _inputs(seed=len(head))
    jmodel, variables, model = _pair(head, x, mask)
    model_type, kw = _kwargs(head)
    if model_type == "anchor-based":
        want_names = NAMES[kw["model_depth"]]
        if kw["model_depth"] == "shallow":
            assert model.pooling.scale == 12
        assert sorted(variables["params"]) == want_names
    else:
        assert sorted(variables["params"]) == ["heads", "multiattention",
                                               "trunk"]
    xs, ms = jnp.asarray(x), jnp.asarray(mask)
    want = jmodel.apply(variables, xs, ms)
    want_pred = jmodel.apply(variables, xs, ms, method="predict")
    model.eval()
    with torch.no_grad():
        tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
        got = model(tx, tm)
        got_pred = model.predict(tx, tm)
    assert len(got) == len(want)
    if model_type == "anchor-based":
        # the trunk's output is masked: every position compares
        for name, g, w in zip(("cls", "loc"), got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **TOL)
        for name, g, w in zip(("pred_cls", "boxes"), got_pred, want_pred):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, rtol=1e-5,
                                       atol=1e-5 * max(1.0, float(
                                           np.abs(w).max())))
        return
    # anchor-free: real positions (past the mask the unmasked trunk is
    # noise in both packages); loc = exp(fc_loc) held through its log
    got = (got[0], torch.log(got[1]), got[2])
    want = (want[0], jnp.log(want[1]), want[2])
    for i, n in enumerate(mask.sum(1)):
        for name, g, w in zip(("cls", "log loc", "ctr"), got, want):
            np.testing.assert_allclose(g[i, :n].numpy(),
                                       np.asarray(w)[i, :n],
                                       err_msg=name, **TOL)
    np.testing.assert_allclose(got_pred[0].numpy(),
                               np.asarray(want_pred[0]), **TOL)
    boxes = np.asarray(want_pred[1])[mask]
    np.testing.assert_allclose(got_pred[1].numpy()[mask], boxes, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(boxes)
                                                          .max())))
    assert torch.equal(got_pred[0][2], torch.zeros(80))   # padding row


def _ab_batch(scales):
    """Two videos (40 and 53 positions) in one bucket of 64 and a third
    row of padding, with JAX's sampled cls labels."""
    rng = np.random.RandomState(0)
    videos = [_video(rng, f"d/tvsum_{i}", n) for i, n in enumerate([40, 53])]
    items = [jax_batching.prepare_ab_item(
        JaxRecord(**v), anchor_scales=scales, pos_iou=0.6, neg_iou=0.0,
        inc_iou=0.3, bucket_size=32) for v in videos]
    batch = next(jax_batching.batch_items(items, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    label = np.array(jax_steps.build_ab_cls_labels(
        {k: jnp.asarray(batch[k]) for k in ("cls_pos", "neg_eligible",
                                            "inc_eligible", "num_pos")},
        jax.random.PRNGKey(3), 2.0, 1.0))
    assert (label == 1).any() and (label == -1).any()
    return batch, label


def _adam(params, grads):
    """JAX's params after one step of edsnet_tpu's optimizer."""
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def _jax_ab_step(jmodel, params, batch, label):
    """JAX's losses and gradients of ab_train_step (steps.py) at
    deterministic=True."""
    def loss_fn(p):
        pred_cls, pred_loc = jmodel.apply({"params": p}, batch["seq"],
                                          batch["mask"], deterministic=True)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, batch["loc_label"],
                                               label)
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, label)
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).astype(
            jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        return jnp.sum((cls + loc) * w) / denom, (
            jnp.sum(cls * w) / denom, jnp.sum(loc * w) / denom)

    (loss, parts), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return (float(loss),) + tuple(map(float, parts)), grads


def _assert_trees_close(tree, got, scaled=False):
    """Leaf by leaf within TOL, or with ``scaled`` (gradients) within 1e-5
    x max(1, max |leaf|)."""
    want = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        atol = 1e-5 * max(1.0, float(np.abs(w).max())) if scaled else 1e-5
        np.testing.assert_allclose(got[name], w, err_msg=name, rtol=1e-5,
                                   atol=atol)


@pytest.mark.parametrize("head", ["fft", "dwt", "flat", "original", "deep3",
                                  "lg-attention", "af-lg-attention"])
def test_one_train_step_matches_jax(head):
    model_type, kw = _kwargs(head)
    if model_type == "anchor-free":
        batch = _af_batch()
        jmodel, variables, model = _pair(head, batch["seq"], batch["mask"])
        grad_fn = _jax_af_grad_fn(jmodel, "focal", "soft-iou", 0.7, 1.3)
        (loss, parts), grads = grad_fn(variables["params"],
                                       {k: batch[k] for k in STEP_KEYS})
        want = (float(loss),) + tuple(map(float, parts))
        metrics, got_grads, got_params, _ = _port_af_step(
            _no_dropout(model), batch, "focal", "soft-iou", 0.7, 1.3)
    else:
        # scale 12 has no positive label on these short shots
        scales = kw["anchor_scales"] if kw["pooling_type"] == "roi" else [4]
        batch, label = _ab_batch(scales)
        jmodel, variables, model = _pair(head, batch["seq"], batch["mask"],
                                         anchor_scales=scales)
        want, grads = _jax_ab_step(jmodel, variables["params"], batch, label)
        optimizer = steps.make_optimizer(model.parameters(), LR, WD)
        metrics = steps.ab_train_step(
            _no_dropout(model), optimizer,
            trainer.to_device(batch, torch.device("cpu")), None,
            lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
            cls_label=torch.from_numpy(label))
        got_grads = dict(_leaves(state_dict_to_flax(
            {n: p.grad for n, p in model.named_parameters()})))
        got_params = dict(_leaves(state_dict_to_flax(model.state_dict())))
    for name, w in zip(("loss", "cls_loss", "loc_loss", "ctr_loss"), want):
        np.testing.assert_allclose(float(metrics[name]), w, err_msg=name,
                                   **TOL)
    _assert_trees_close(grads, got_grads, scaled=True)
    _assert_trees_close(_adam(variables["params"], grads), got_params)
    moved = [n for n, w in _leaves(variables["params"])
             if not np.array_equal(w, got_params[n])]
    assert len(moved) == len(got_params)


@pytest.mark.parametrize("head", ["lg-attention", "af-lg-attention"])
def test_gradients_finite_with_all_zero_local_rows(head):
    """The shared fc's bias at -100: relu zeroes the global path and every
    local one, so l2_normalize sees all-zero rows everywhere (and the
    all-padding row's segments have every key masked).  The gradient of
    the summed outputs is finite and equals JAX's (each leaf within 1e-5 x
    max(1, max |leaf|): without a residual the anchor-free trunk
    normalises a constant row, which scales its gradient up by
    1/sqrt(eps))."""
    x, mask = _inputs(seed=2)
    jmodel, variables, model = _pair(head, x, mask)
    enc = "multiattentionblock" if head.startswith("lg") else \
        "multiattention"
    params = jax.tree.map(np.asarray, variables["params"])
    params[enc]["multi_attention"]["fc"]["bias"] = np.full(FEAT, -100.0,
                                                           np.float32)
    model.load_state_dict(flax_to_state_dict({"params": params}),
                          strict=True)

    def jax_sum(p):
        return sum(jnp.sum(o) for o in jmodel.apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(mask)))

    model.eval()
    sum(o.sum() for o in model(torch.from_numpy(x),
                               torch.from_numpy(mask))).backward()
    got = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})))
    assert all(np.isfinite(g).all() for g in got.values())
    assert not np.abs(got[f"{enc}/multi_attention/fc/kernel"]).any()
    _assert_trees_close(jax.grad(jax_sum)(params), got, scaled=True)


@pytest.mark.parametrize("flags", [
    ["--model-depth", LG], ["--pooling-type", "fft", "--anchor-scales", "12"],
    ["--pooling-type", "dwt", "--anchor-scales", "12"]])
def test_evaluate_cli_reads_jax_checkpoint_new_heads(tmp_path, capsys,
                                                     flags):
    """A JAX-written checkpoint of a new depth and of new poolings through
    both evaluate CLIs: the same printed lines."""
    split = _write_dataset(tmp_path, _videos())
    argv = ["anchor-based", "--device", "cpu", "--splits", str(split),
            "--data-root", str(tmp_path), "--model-dir",
            str(tmp_path / "model"), "--num-feature", str(FEAT),
            "--num-head", "2", "--num-hidden", "8", "--fc-depth", "2",
            "--bucket-size", "32", "--batch-size", "2", *flags]
    args = port_evaluate.config_lib.get_arguments(argv)
    jmodel = jax_get_model("anchor-based", **{
        k: v for k, v in vars(args).items() if k != "model"})
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, FEAT)), jnp.ones((1, 32), bool))
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    jax_evaluate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    port_evaluate.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 2 and "F-score" in want[-1]
    assert got == want


# JAX's counts at F 1024, hidden 128, fc depth 7, 8 heads, attention
# depth 2 (jax.eval_shape of edsnet_tpu's get_model)
FULL_WIDTH_PARAMS = [
    ("anchor-based", "original", "attention", "roi", [4, 8, 16, 32],
     4_328_195),
    ("anchor-based", "deep", "attention", "roi", [4, 8, 16, 32], 4_342_659),
    ("anchor-based", LG, "attention", "roi", [4, 8, 16, 32], 23_221_123),
    ("anchor-based", LG, "nystromformer", "roi", [12], 6_449_555),
    ("anchor-based", "shallow", "nystromformer", "fft", [12], 2_445_579),
    ("anchor-based", "shallow", "nystromformer", "dwt", [12], 2_347_275),
    ("anchor-based", "shallow", "nystromformer", "flat-pooling", [12],
     2_445_579),
    ("anchor-free", LG, "attention", "roi", [4], 23_221_252),
    ("anchor-free", LG, "nystromformer", "roi", [4], 6_449_684)]


@pytest.mark.parametrize("model_type,depth,base,pooling,scales,count",
                         FULL_WIDTH_PARAMS)
def test_full_width_parameter_counts_match_jax(model_type, depth, base,
                                               pooling, scales, count):
    kw = dict(base_model=base, model_depth=depth, pooling_type=pooling,
              anchor_scales=scales, attention_depth=2,
              encoder_type="classic", orientation="paper", num_feature=1024,
              num_hidden=128, num_head=8, fc_depth=7)
    jmodel = jax_get_model(model_type, **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 1024)), jnp.ones((1, 64), bool)))
    jax_count = sum(int(np.prod(s.shape))
                    for s in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        model = get_model(model_type, **kw)
    assert sum(p.numel() for p in model.parameters()) == jax_count == count
