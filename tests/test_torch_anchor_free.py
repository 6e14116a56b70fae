"""edsnet_torch's anchor-free path vs edsnet_tpu on the same numpy-seeded
inputs and weights (through the weight bridge), on the CPU: the loc / ctr
labels and offset2bbox exactly; the five losses, values and gradients, to
1e-6 (f32, the same formulas; p at 0 and 1 and infinite extents included,
inf or NaN where JAX gives them); the three heads' forward and predict to 1e-5;
one af_train_step to 1e-5 under each loss pair (bf16 held to JAX's jitted
step by the median distance to float64 over 8 batches, remat equal to the
plain step); item preparation,
batches and pools exactly; per-video F of the device evaluator exactly;
a JAX-written checkpoint through the evaluate CLI; and the train ->
evaluate CLI round trip at every served depth."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from edsnet_tpu import evaluate as jax_evaluate
from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.ops import anchor_free as jax_af
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import eval_device as jax_eval
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.data import batching
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.common import Dropout, set_dropout_generator
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.ops import anchor_free as af
from edsnet_torch.ops import losses
from edsnet_torch.parallel import eval_device as port_eval
from edsnet_torch.parallel import steps
from tests.test_torch_backbones import BACKBONES, IDS
from tests.test_torch_eval import _videos, _write_dataset
from tests.test_torch_train import _leaves, _video, _write_mock

TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-6, atol=1e-6)
FEAT = 32
LR, WD = 5e-5, 1e-5
DEPTHS = ("shallow", "deep", "original")


def _kwargs(base="attention", depth="shallow", orientation="paper"):
    return dict(base_model=base, model_depth=depth, orientation=orientation,
                num_feature=FEAT, num_hidden=8, num_head=2, fc_depth=2)


def _jax_init(jmodel, x, mask):
    return jmodel.init({"params": jax.random.PRNGKey(0),
                        "dropout": jax.random.PRNGKey(1)},
                       jnp.asarray(x), jnp.asarray(mask))


def _port(variables, **kw):
    model = get_model("anchor-free", **_kwargs(**kw))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def _no_dropout(model):
    for module in model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    return model


# -------------------------------------------------------------- labels

TARGETS = [[1, 1, 0, 0, 1, 1, 1], [0, 0, 0, 0], [1], [1, 1, 1, 1],
           [0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 1, 0], "fuzz"]


@pytest.mark.parametrize("target", TARGETS,
                         ids=["both-ends", "empty", "one", "full", "runs",
                              "fuzz"])
def test_loc_ctr_labels_match_jax(target):
    """Host and device labels against JAX's, a row padded with zeros
    (segments at both ends of the real part, and of the padded row)."""
    if target == "fuzz":
        target = (np.random.RandomState(0).rand(61) > 0.4).astype(np.int32)
    target = np.asarray(target, np.int32)
    want_loc = np.asarray(jax_af.get_loc_label(target))
    want_ctr = np.asarray(jax_af.get_ctr_label(target, want_loc))
    got_loc = af.get_loc_label_np(target)
    got_ctr = af.get_ctr_label_np(target, got_loc)
    assert got_loc.dtype == want_loc.dtype and got_ctr.dtype == np.float32
    np.testing.assert_array_equal(got_loc, want_loc)
    np.testing.assert_array_equal(got_ctr, want_ctr)
    np.testing.assert_array_equal(got_loc, jax_af.get_loc_label_np(target))
    np.testing.assert_array_equal(got_ctr, jax_af.get_ctr_label_np(
        target, want_loc))

    padded = np.zeros((2, target.size + 5), np.int32)
    padded[0, :target.size] = target
    padded[1, 5:] = target
    t_loc = af.get_loc_label(torch.from_numpy(padded))
    t_ctr = af.get_ctr_label(torch.from_numpy(padded), t_loc)
    assert t_loc.dtype == torch.float32 and t_loc.shape == padded.shape + (2,)
    for row, t_l, t_c in zip(padded, t_loc, t_ctr):
        row_loc = np.asarray(jax_af.get_loc_label(row))
        np.testing.assert_array_equal(t_l.numpy(), row_loc)
        np.testing.assert_array_equal(t_c.numpy(), np.asarray(
            jax_af.get_ctr_label(row, row_loc)))


def test_offset2bbox_matches_jax():
    rng = np.random.RandomState(1)
    off = np.abs(rng.randn(37, 2)).astype(np.float32) * 5
    off[3] = [np.inf, 0.0]
    np.testing.assert_array_equal(
        af.offset2bbox(torch.from_numpy(off)).numpy(),
        np.asarray(jax_af.offset2bbox(off)))
    # the heads' batched decode, row by row, and integer offsets
    batch = np.stack([off, off[::-1] * 2])
    got = af.offset2bbox(torch.from_numpy(batch)).numpy()
    for row, want in zip(got, batch):
        np.testing.assert_array_equal(row, np.asarray(
            jax_af.offset2bbox(want)))
    ints = rng.randint(0, 9, (11, 2)).astype(np.int32)
    got = af.offset2bbox(torch.from_numpy(ints))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_af.offset2bbox(ints)))


# -------------------------------------------------------------- losses

def _loss_inputs(seed):
    """[B 3, N 40] predictions, 0/1 targets, masks and (l, r) extents; on
    seed 0 p at exactly 0 and 1 (and 1e-8, the clip's lower bound), an
    infinite predicted extent on a positive and on a negative, and a video
    with no positives."""
    rng = np.random.RandomState(seed)
    b, n = 3, 40
    pred = rng.uniform(0, 1, (b, n)).astype(np.float32)
    ctr_pred = rng.uniform(0, 1, (b, n)).astype(np.float32)
    target = (rng.rand(b, n) < 0.4).astype(np.int32)
    mask = np.arange(n)[None, :] < np.array([[40], [33], [25]])
    target &= mask
    pred_loc = np.exp(rng.randn(b, n, 2)).astype(np.float32) * 3
    test_loc = np.stack([af.get_loc_label_np(t) for t in target])
    test_ctr = np.stack([af.get_ctr_label_np(t, l)
                         for t, l in zip(target, test_loc)])
    if seed == 0:
        target[0, :6] = [1, 1, 0, 0, 1, 0]
        pred[0, :6] = [0.0, 1.0, 0.0, 1.0, 1e-8, 1e-12]
        ctr_pred[1, :3] = [0.0, 1e-8, 0.5]
        target[2] = 0
    if seed == 1:
        ctr_pred[0, np.argmax(target[0])] = 1.0     # JAX's inf
        pred_loc[1, np.argmax(target[1]), 0] = np.inf
        pred_loc[1, np.argmin(target[1]), 1] = np.inf
    return pred, ctr_pred, target, mask, pred_loc, test_loc, test_ctr


def _jax_af_losses(pred, ctr_pred, target, mask, pred_loc, test_loc,
                   test_ctr, cls_kind, reg_kind):
    return (jax.vmap(lambda p, t, m: jax_losses.af_cls_loss(
                p, t, cls_kind, m))(pred, target, mask),
            jax.vmap(lambda p, t, c: jax_losses.af_loc_loss(
                p, t, c, reg_kind))(pred_loc, test_loc, target),
            jax.vmap(jax_losses.af_ctr_loss)(ctr_pred, test_ctr, target))


def _port_af_losses(pred, ctr_pred, target, mask, pred_loc, test_loc,
                    test_ctr, cls_kind, reg_kind):
    return (losses.af_cls_loss(pred, target, cls_kind, mask),
            losses.af_loc_loss(pred_loc, test_loc, target, reg_kind),
            losses.af_ctr_loss(ctr_pred, test_ctr, target))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cls_kind,reg_kind", [
    ("focal", "soft-iou"), ("cross-entropy", "smooth-l1")])
def test_af_losses_and_gradients_match_jax(seed, cls_kind, reg_kind):
    inputs = _loss_inputs(seed)
    pred, ctr_pred, target, mask, pred_loc, test_loc, test_ctr = inputs
    want = _jax_af_losses(*inputs, cls_kind, reg_kind)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (pred, ctr_pred, pred_loc)]
    got = _port_af_losses(leaves[0], leaves[1], torch.from_numpy(target),
                          torch.from_numpy(mask), leaves[2],
                          torch.from_numpy(test_loc),
                          torch.from_numpy(test_ctr), cls_kind, reg_kind)
    for name, g, w in zip(("cls", "loc", "ctr"), got, want):
        assert g.shape == (3,)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=name, **LOSS_TOL)
    if seed == 1:
        assert not np.isfinite(np.asarray(want[2])[0])
        assert np.isfinite(np.asarray(want[1])[1]) == (reg_kind ==
                                                       "soft-iou")

    # gradients of each loss summed over videos, one input at a time
    for i, (name, wrt) in enumerate((("cls", 0), ("loc", 4), ("ctr", 1))):
        def jax_sum(x):
            args = list(inputs)
            args[wrt] = x
            return jnp.sum(_jax_af_losses(*args, cls_kind, reg_kind)[i])

        want_grad = np.asarray(jax.grad(jax_sum)(inputs[wrt]))
        leaf = leaves[{0: 0, 1: 1, 4: 2}[wrt]]
        leaf.grad = None
        got[i].sum().backward(retain_graph=True)
        np.testing.assert_allclose(leaf.grad.numpy(), want_grad,
                                   err_msg=f"d{name}", **LOSS_TOL)


def test_focal_loss_and_iou_match_jax():
    rng = np.random.RandomState(4)
    x = rng.uniform(0, 1, (2, 20, 2)).astype(np.float32)
    x[0, :2] = [[0.0, 1.0], [1.0, 0.0]]
    y = rng.randint(0, 2, (2, 20)).astype(np.int32)
    w = (rng.rand(2, 20) > 0.3).astype(np.float32)
    got = losses.focal_loss(torch.from_numpy(x), torch.from_numpy(y),
                            weight=torch.from_numpy(w))
    want = jax.vmap(lambda a, b, c: jax_losses.focal_loss(a, b, weight=c))(
        x, y, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    np.testing.assert_allclose(
        losses.focal_loss(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jax.vmap(jax_losses.focal_loss)(x, y)), **LOSS_TOL)
    with pytest.raises(ValueError, match="Invalid loss type"):
        losses.af_cls_loss(torch.from_numpy(x[..., 1]), torch.from_numpy(y),
                           "hinge", torch.ones(2, 20, dtype=torch.bool))
    a = np.abs(rng.randn(30, 2)).astype(np.float32)
    b = np.abs(rng.randn(30, 2)).astype(np.float32)
    a[0], b[1], a[2], b[2] = [np.inf, 1.0], [0.0, 0.0], [0, 0], [0, 0]
    np.testing.assert_allclose(
        losses.iou_offset(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_losses.iou_offset(a, b)), **LOSS_TOL)


# -------------------------------------------------------------- heads

def _head_inputs(seed):
    """B 3 at bucket 64 of unit-norm features (as the eccv16 h5s hold): a
    full row, a padded row and an all-zero padding row, as an eval batch
    has."""
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 64, FEAT).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mask = np.arange(64)[None, :] < np.array([[64], [37], [0]])
    return x * mask[..., None], mask


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("base", ["linear", "attention", "nystromformer"])
def test_af_heads_match_jax(base, depth):
    x, mask = _head_inputs(seed=DEPTHS.index(depth))
    jmodel = jax_get_model("anchor-free", **_kwargs(base, depth))
    variables = _jax_init(jmodel, x, mask)
    model = _port(variables, base=base, depth=depth).eval()
    names = {"shallow": ["base_model", "heads", "layer_norm", "trunk"],
             "deep": ["base_model1", "base_model2", "heads", "layer_norm",
                      "trunk"],
             "original": ["base_model", "fc1", "fc1_norm", "heads",
                          "layer_norm"]}[depth]
    assert sorted(variables["params"]) == names
    assert sorted(variables["params"]["heads"]) == ["fc_cls", "fc_ctr",
                                                    "fc_loc"]
    xs, ms = jnp.asarray(x), jnp.asarray(mask)
    want = jmodel.apply(variables, xs, ms)
    want_pred = jmodel.apply(variables, xs, ms, method="predict")
    with torch.no_grad():
        tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
        got = model(tx, tm)
        got_pred = model.predict(tx, tm)
    # loc = exp(fc_loc): its linear output (log loc) is held to 1e-5
    got = (got[0], torch.log(got[1]), got[2])
    want = (want[0], jnp.log(want[1]), want[2])
    for i, n in enumerate([64, 37]):
        for name, g, w in zip(("cls", "log loc", "ctr"), got, want):
            np.testing.assert_allclose(g[i, :n].numpy(), np.asarray(w)[i, :n],
                                       err_msg=name, **TOL)
    # pred_cls everywhere (0 past the mask); boxes at real positions within
    # 1e-5 x max(1, max |box|), an extent's relative error at the box's
    # scale: past the mask the LayerNorm of a constant row amplifies
    # rounding, unmasked in both packages, and the evaluator drops those
    np.testing.assert_allclose(got_pred[0].numpy(), np.asarray(want_pred[0]),
                               **TOL)
    want_boxes = np.asarray(want_pred[1])[mask]
    np.testing.assert_allclose(
        got_pred[1].numpy()[mask], want_boxes, rtol=0,
        atol=1e-5 * max(1.0, float(np.abs(want_boxes).max())))
    assert torch.equal(got_pred[0][2], torch.zeros(64))   # padding row: 0
    assert torch.equal(got_pred[0][1, 37:], torch.zeros(27))
    model.train()
    with pytest.raises(RuntimeError, match="eval"):
        model.predict(tx, tm)


def test_unported_af_depths_raise():
    """Every anchor-free depth of JAX's factory is served (local-global
    since the local-global encoder was ported); cross-attention is no
    anchor-free depth in either package."""
    model = get_model("anchor-free", **_kwargs(depth="local-global-attention"))
    assert type(model).__name__ == "DSNetAFMultiAttention"
    with pytest.raises(ValueError, match="Invalid model depth"):
        get_model("anchor-free", **_kwargs(depth="cross-attention"))
    with pytest.raises(ValueError, match="Invalid model depth"):
        jax_get_model("anchor-free", **_kwargs(depth="cross-attention"))


# -------------------------------------------------------------- train step

def _af_batch(seed=0):
    """Two videos in one bucket of 64 and a third row of padding."""
    rng = np.random.RandomState(seed)
    videos = [_video(rng, f"d/tvsum_{i}", n) for i, n in enumerate([40, 53])]
    jitems = [jax_batching.prepare_af_item(JaxRecord(**v)) for v in videos]
    batch = next(jax_batching.batch_items(jitems, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    assert batch["video_valid"].tolist() == [True, True, False]
    return batch


STEP_KEYS = ("seq", "mask", "target", "af_loc", "af_ctr", "video_valid")


def _jax_af_grad_fn(jmodel, cls_kind, reg_kind, lambda_reg, lambda_ctr,
                    dtype=jnp.float32, remat=False):
    """JAX's jitted (loss, (cls, loc, ctr)) and gradients of af_train_step
    (steps.py:215-228) at deterministic=True, computed in ``dtype``, as a
    function of the params and a batch of STEP_KEYS arrays."""
    def loss_fn(p, batch):
        def fwd(p):
            if dtype != jnp.float32:
                p = jax_steps._cast_floats(p, dtype)
            out = jmodel.apply({"params": p},
                               jnp.asarray(batch["seq"], dtype),
                               batch["mask"], deterministic=True)
            return jax.tree.map(lambda t: t.astype(jnp.float32), out)

        pred_cls, pred_loc, pred_ctr = (jax.checkpoint(fwd) if remat
                                        else fwd)(p)
        cls, loc, ctr = _jax_af_losses(
            pred_cls, pred_ctr, batch["target"], batch["mask"], pred_loc,
            batch["af_loc"], batch["af_ctr"], cls_kind, reg_kind)
        w = batch["video_valid"].astype(jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        loss = jnp.sum((cls + lambda_reg * loc + lambda_ctr * ctr) * w) / denom
        return loss, tuple(jnp.sum(v * w) / denom for v in (cls, loc, ctr))

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_af_step(base, batch, cls_kind, reg_kind, lambda_reg, lambda_ctr,
                 dtype=jnp.float32, remat=False):
    """JAX's losses, gradients and Adam-updated params for one step at
    deterministic=True, in ``dtype``, as af_train_step computes them
    (jitted, as edsnet_tpu runs it)."""
    jmodel = jax_get_model("anchor-free", **_kwargs(base))
    variables = _jax_init(jmodel, batch["seq"], batch["mask"])
    params = variables["params"]
    grad_fn = _jax_af_grad_fn(jmodel, cls_kind, reg_kind, lambda_reg,
                              lambda_ctr, dtype, remat)
    (loss, parts), grads = grad_fn(params, {k: batch[k] for k in STEP_KEYS})
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    return (variables, (float(loss),) + tuple(map(float, parts)), grads,
            optax.apply_updates(params, updates))


def _port_af_step(model, batch, cls_kind, reg_kind, lambda_reg, lambda_ctr,
                  **flags):
    optimizer = steps.make_optimizer(model.parameters(), LR, WD)
    metrics = steps.af_train_step(
        model, optimizer, trainer.to_device(batch, torch.device("cpu")),
        lambda_reg=lambda_reg, lambda_ctr=lambda_ctr, cls_kind=cls_kind,
        reg_kind=reg_kind, **flags)
    grads = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})))
    params = dict(_leaves(state_dict_to_flax(model.state_dict())))
    return metrics, grads, params, optimizer


@pytest.mark.parametrize("cls_kind,reg_kind", [
    ("focal", "soft-iou"), ("focal", "smooth-l1"),
    ("cross-entropy", "soft-iou"), ("cross-entropy", "smooth-l1")])
def test_af_train_step_matches_jax(cls_kind, reg_kind):
    batch = _af_batch()
    variables, want, grads, new_params = _jax_af_step(
        "attention", batch, cls_kind, reg_kind, 0.7, 1.3)
    model = _no_dropout(_port(variables))
    metrics, got_grads, got_params, _ = _port_af_step(
        model, batch, cls_kind, reg_kind, 0.7, 1.3)
    assert sorted(metrics) == ["cls_loss", "ctr_loss", "loc_loss", "loss"]
    for name, w in zip(("loss", "cls_loss", "loc_loss", "ctr_loss"), want):
        np.testing.assert_allclose(float(metrics[name]), w, err_msg=name,
                                   **TOL)
    for tree, got in ((grads, got_grads), (new_params, got_params)):
        want_leaves = dict(_leaves(tree))
        assert sorted(got) == sorted(want_leaves)
        for name in want_leaves:
            np.testing.assert_allclose(got[name], want_leaves[name],
                                       err_msg=name, **TOL)
    moved = [n for n, w in _leaves(variables["params"])
             if not np.array_equal(w, got_params[n])]
    assert len(moved) == len(got_params)


BF16_BATCHES = 8


def _bf16_gaps(base, n_batches=BF16_BATCHES):
    """Per batch (seeds 0 .. n_batches - 1, one bucket of 64), the gap to
    the port's float64 step of the port's bf16 step and of JAX's jitted
    bf16 step (edsnet_tpu's af_train_step runs jitted), from the same
    weights: |loss - loss64| and the relative L2 distance of all gradient
    leaves together.  -> (port [n, 2], jax [n, 2]); the last port bf16
    model and optimizer ride along for the dtype checks."""
    batch = _af_batch()
    jmodel = jax_get_model("anchor-free", **_kwargs(base))
    variables = _jax_init(jmodel, batch["seq"], batch["mask"])
    grad_fn = _jax_af_grad_fn(jmodel, "focal", "soft-iou", 1.0, 1.0,
                              dtype=jnp.bfloat16)
    port, ref = [], []
    for seed in range(n_batches):
        batch = _af_batch(seed)
        model = _no_dropout(_port(variables, base=base))
        f64 = copy.deepcopy(model).double()
        metrics, grads, _, optimizer = _port_af_step(
            model, batch, "focal", "soft-iou", 1.0, 1.0,
            compute_dtype="bfloat16")
        batch64 = {**batch, "seq": batch["seq"].astype(np.float64)}
        metrics64, grads64, _, _ = _port_af_step(f64, batch64, "focal",
                                                 "soft-iou", 1.0, 1.0)
        (loss, _), jax_grads = grad_fn(variables["params"],
                                       {k: batch[k] for k in STEP_KEYS})
        names = sorted(grads64)
        assert sorted(grads) == sorted(dict(_leaves(jax_grads))) == names

        def flat(tree):
            return np.concatenate([np.asarray(tree[n], np.float64).ravel()
                                   for n in names])

        want, loss64 = flat(grads64), float(metrics64["loss"])
        for out, got_loss, got in ((port, float(metrics["loss"]), grads),
                                   (ref, float(loss),
                                    dict(_leaves(jax_grads)))):
            out.append((abs(got_loss - loss64),
                        np.linalg.norm(flat(got) - want)
                        / np.linalg.norm(want)))
    return np.asarray(port), np.asarray(ref), model, optimizer


@pytest.mark.parametrize("base", ["attention", "linear", "nystromformer"])
def test_af_bf16_step_as_close_to_f64_as_jax(base):
    """The port's bf16 step against JAX's jitted bf16 step, each by its
    distance to the port's float64 step over 8 batches: the median loss
    gap within 2x JAX's plus 1e-6, and the median relative gradient gap
    (all leaves) within 2x JAX's; masters and Adam moments float32.  The
    median, because at these widths (hidden 8) a bf16 rounding that lets
    a ReLU through before the LayerNorm of a near-constant row moves
    either step by 10x-1000x its typical gap on some batches (either
    package's, on its own batches), and the mean or one batch would read
    that instead of the precision."""
    port, ref, model, optimizer = _bf16_gaps(base)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    got, want = np.median(port, axis=0), np.median(ref, axis=0)
    assert got[0] <= 2 * want[0] + 1e-6, (got, want)
    assert got[1] <= 2 * want[1], (got, want)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for st in optimizer.state.values()
               for t in st.values() if t.ndim)


def test_af_remat_matches_jax_and_plain():
    batch = _af_batch()
    variables, want, grads, _ = _jax_af_step(
        "nystromformer", batch, "focal", "soft-iou", 1.0, 1.0, remat=True)
    model = _port(variables, base="nystromformer")
    plain, again = copy.deepcopy(model), copy.deepcopy(model)
    metrics, got_grads, _, _ = _port_af_step(
        _no_dropout(model), batch, "focal", "soft-iou", 1.0, 1.0, remat=True)
    np.testing.assert_allclose(float(metrics["loss"]), want[0], **TOL)
    for name, w in _leaves(grads):
        np.testing.assert_allclose(got_grads[name], w, err_msg=name, **TOL)

    # dropout on: the recomputation replays the first pass's masks
    for m in (plain, again):
        set_dropout_generator(m, torch.Generator().manual_seed(9))
    (a, ga, pa, _), (b, gb, pb, _) = (
        _port_af_step(m, batch, "focal", "soft-iou", 1.0, 1.0, remat=r)
        for m, r in ((plain, False), (again, True)))
    assert float(a["loss"]) == float(b["loss"])
    for x, y in ((ga, gb), (pa, pb)):
        for name in x:
            np.testing.assert_array_equal(y[name], x[name], err_msg=name)


# -------------------------------------------------------------- batching

def test_af_items_batches_and_pools_match_jax():
    from tests.test_torch_train_ops import _record

    rng = np.random.RandomState(7)
    recs = [_record(rng, n, key=f"d/v{i}")
            for i, n in enumerate([40, 70, 45, 90, 60])]
    recs.append(_record(rng, 40, key="d/empty",
                        gtscore=np.zeros(40, np.float32)))
    items = batching.prepare_items([VideoRecord(**r) for r in recs],
                                   "anchor-free")
    jitems = [it for it in (jax_batching.prepare_af_item(JaxRecord(**r))
                            for r in recs) if it is not None]
    assert [it.key for it in items] == [it.key for it in jitems] == [
        f"d/v{i}" for i in range(5)]
    for got, want in zip(items, jitems):
        assert got.cls_pos is None and got.num_pos == 0
        for name in ("seq", "target", "af_loc", "af_ctr"):
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for got_list, want_list in (
            (batching.batch_items(items, 2, 32, shuffle=True,
                                  rng=np.random.RandomState(0),
                                  pad_batch_to=4),
             jax_batching.batch_items(jitems, 2, 32, shuffle=True,
                                      rng=np.random.RandomState(0),
                                      pad_batch_to=4)),
            (batching.pool_items(items, 32),
             jax_batching.pool_items(jitems, 32))):
        got_list, want_list = list(got_list), list(want_list)
        assert len(got_list) == len(want_list)
        for got, want in zip(got_list, want_list):
            assert sorted(got) == sorted(want) == [
                "af_ctr", "af_loc", "keys", "mask", "seq", "target",
                "video_valid"]
            for key in got:
                if key == "keys":
                    assert got[key] == want[key]
                else:
                    assert got[key].dtype == want[key].dtype, key
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)


# -------------------------------------------------------------- evaluation

def test_af_device_eval_matches_jax_per_video():
    videos = _videos()
    jmodel = jax_get_model("anchor-free", **_kwargs())
    variables = _jax_init(jmodel, np.zeros((1, 32, FEAT), np.float32),
                          np.ones((1, 32), bool))
    model = _port(variables).eval()
    assert port_eval._num_scales_of(model) == 1
    jrecords = [JaxRecord(**v) for v in videos]
    records = [VideoRecord(**v) for v in videos]
    jbatches = jax_eval.prepare_eval_batches(jrecords, 2, 32)
    batches = port_eval.prepare_eval_batches(records, 2, 32, "cpu")
    for jb, tb in zip(jbatches, batches):
        want_f, want_s = jax_eval._eval_batch_device(
            jmodel, variables, jb["jb"], 1, 0.5, jb["frame_bucket"],
            uniform_rate=jb["uniform_rate"])
        got_f, got_s = port_eval._eval_batch_device(
            model, tb["tb"], 1, 0.5, tb["frame_bucket"],
            uniform_rate=tb["uniform_rate"])
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
        assert np.asarray(want_s).any()
    per_video = []
    got = port_eval.evaluate_on_device(model, records, 0.5, batch_size=2,
                                       bucket_size=32, per_video=per_video)
    want = jax_eval.evaluate_on_device(jmodel, variables, jrecords, 0.5,
                                       batch_size=2, bucket_size=32)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    assert float(port_eval.eval_fscore_device(model, batches, 0.5)) == \
        pytest.approx(got[0], rel=1e-6)


@pytest.mark.parametrize("depth", DEPTHS)
def test_evaluate_cli_reads_jax_af_checkpoint(tmp_path, capsys, depth):
    split = _write_dataset(tmp_path, _videos())
    jmodel = jax_get_model("anchor-free", **_kwargs(depth=depth))
    variables = _jax_init(jmodel, np.zeros((1, 32, FEAT), np.float32),
                          np.ones((1, 32), bool))
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    argv = ["anchor-free", "--device", "cpu", "--model-depth", depth,
            "--splits", str(split),
            "--data-root", str(tmp_path), "--model-dir",
            str(tmp_path / "model"), "--num-feature", str(FEAT),
            "--num-head", "2", "--num-hidden", "8", "--fc-depth", "2",
            "--bucket-size", "32", "--batch-size", "2"]
    jax_evaluate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    port_evaluate.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 2 and "F-score" in want[-1]
    assert got == want


@pytest.mark.parametrize("depth", DEPTHS)
def test_af_cli_round_trip(tmp_path, capsys, caplog, depth):
    """train -> evaluate through the port's CLIs with anchor-free on the
    verify recipe's mock h5: the checkpoint contract, the F that evaluate
    prints equal to the one train recorded, the step's ctr loss reached,
    and --untie-fc-blocks / --pooling-type accepted and left out of the
    model, as JAX's get_anchor_free does."""
    split = _write_mock(tmp_path)
    model_dir = tmp_path / "model"
    argv = ["anchor-free", "--device", "cpu", "--model-depth", depth,
            "--splits", str(split), "--data-root", str(tmp_path),
            "--model-dir", str(model_dir), "--num-feature", str(FEAT),
            "--num-hidden", "8", "--fc-depth", "2", "--num-head", "2",
            "--bucket-size", "32", "--batch-size", "2",
            "--pooling-type", "dwt"]
    caplog.set_level("WARNING")
    port_train.main(argv + ["--max-epoch", "2", "--untie-fc-blocks"])
    trained = capsys.readouterr().out
    assert "mock: sweep finished, mean F-score" in trained
    results = yaml.safe_load((model_dir / "mock.yml").read_text())
    assert 0.0 <= results["split0"] == results["mean"] <= 1.0
    state = torch.load(model_dir / "checkpoint" / "mock.yml.0.pt",
                       weights_only=True)
    assert set(state) == set(get_model(
        "anchor-free", **_kwargs(depth=depth)).state_dict())
    if depth != "original":
        assert sorted({k.split(".")[1] for k in state
                       if k.startswith("trunk.")}) == ["fc1", "fc_block"]
    assert any("--untie-fc-blocks: the trunk stays tied" in r.getMessage()
               for r in caplog.records)

    port_evaluate.main(argv)
    evaluated = capsys.readouterr().out.strip().splitlines()
    assert evaluated[-1].endswith(f"F-score: {results['split0']:.4f}")


def test_trainer_dispatches_af_step(tmp_path, monkeypatch):
    """train_records runs af_train_step with the CLI's loss kinds and
    weights, --remat and --compute-dtype; it draws no labels."""
    seen = []
    real = trainer.af_train_step

    def spy(*a, **kw):
        seen.append(kw)
        metrics = real(*a, **kw)
        assert sorted(metrics) == ["cls_loss", "ctr_loss", "loc_loss",
                                   "loss"]
        return metrics

    monkeypatch.setattr(trainer, "af_train_step", spy)
    monkeypatch.setattr(trainer, "ab_train_step", None)
    rng = np.random.RandomState(4)
    train = [VideoRecord(**_video(rng, f"d/tvsum_{i}", n))
             for i, n in enumerate([20, 40, 24])]
    val = [VideoRecord(**_video(rng, "d/summe_0", 30, users=5))]
    args = port_evaluate.config_lib.get_arguments([
        "anchor-free", "--device", "cpu", "--base-model", "linear",
        "--num-feature", str(FEAT), "--num-hidden", "8", "--fc-depth", "1",
        "--bucket-size", "32", "--batch-size", "2", "--max-epoch", "2",
        "--cls-loss", "cross-entropy", "--reg-loss", "smooth-l1",
        "--lambda-ctr", "0.5", "--remat", "--compute-dtype", "bfloat16"])
    best, f1s, epochs = trainer.train_records(args, train, val,
                                              tmp_path / "best.pt")
    assert len(seen) == 4 and epochs == [0, 1]
    assert all(kw == dict(lambda_reg=1.0, lambda_ctr=0.5,
                          cls_kind="cross-entropy", reg_kind="smooth-l1",
                          remat=True, compute_dtype="bfloat16")
               for kw in seen)
    assert best == max(f1s) and 0.0 <= best <= 1.0


@pytest.mark.parametrize("base,orientation", BACKBONES, ids=IDS)
def test_af_every_backbone_trains_and_predicts(base, orientation):
    """Each depth on each other backbone: one step with dropout (finite
    losses, every trainable parameter moved, buffers and frozen parameters
    unchanged) and a finite predict on an eval-shaped batch."""
    batch = trainer.to_device(_af_batch(), torch.device("cpu"))
    x, mask = _head_inputs(seed=5)
    for depth in DEPTHS:
        model = get_model("anchor-free", **_kwargs(base, depth, orientation))
        set_dropout_generator(model, torch.Generator().manual_seed(3))
        before = {n: t.clone() for n, t in model.state_dict().items()}
        optimizer = steps.make_optimizer(model.parameters(), LR, WD)
        metrics = steps.af_train_step(model, optimizer, batch,
                                      lambda_reg=1.0, lambda_ctr=1.0,
                                      cls_kind="focal", reg_kind="soft-iou")
        assert all(np.isfinite(float(v)) for v in metrics.values()), depth
        for n, p in model.named_parameters():
            assert torch.equal(p, before[n]) != p.requires_grad, (depth, n)
        for n, b in model.named_buffers():
            assert torch.equal(b, before[n]), (depth, n)
        with torch.no_grad():
            cls, boxes = model.eval().predict(torch.from_numpy(x),
                                              torch.from_numpy(mask))
        assert cls.shape == (3, 64) and boxes.shape == (3, 64, 2)
        assert bool(torch.isfinite(cls).all()) and float(cls.max()) <= 1.0
