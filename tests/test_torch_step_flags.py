"""edsnet_torch train-step flags vs edsnet_tpu, on the CPU:
``--matmul-precision`` (each value's TF32 switches, or a raise; the
depthwise conv following the matmul switch), ``--compute-dtype bfloat16``
(every backbone's output, trunk and product dtypes equal to what JAX's
bf16 trace gives; one bf16 step of nystromformer and attention as close to
the port's float64 step as twice JAX's bf16 step is, plus 1e-6; masters and
Adam float32), ``--remat`` (equal to JAX's remat step to 1e-5 and to the
port's plain step, dropout on, to 1e-6), the untied trunk against JAX's
module to 1e-5, and ``--untie-fc-blocks`` leaving the CLI's trunk tied, as
edsnet_tpu's does."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.dsnet import DSNet as JaxDSNet
from edsnet_tpu.models.dsnet import _FcTrunk as JaxTrunk
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.config import get_arguments
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.common import Dropout, set_dropout_generator
from edsnet_torch.models.dsnet import DSNet, _FcTrunk
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.ops import depthwise_conv
from edsnet_torch.parallel import steps
from tests.test_torch_backbones import BACKBONES, IDS
from tests.test_torch_train import _leaves, _video, _write_mock

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT = 32
LR, WD = 5e-5, 1e-5
ALL = [("attention", "paper")] + BACKBONES
ALL_IDS = ["attention"] + IDS


def _kwargs(base, orientation="paper"):
    return dict(base_model=base, orientation=orientation, num_feature=FEAT,
                num_hidden=8, anchor_scales=[4, 8], num_head=2, fc_depth=2,
                pooling_type="roi")


def _jax_model(base, orientation="paper"):
    return jax_get_model("anchor-based", model_depth="shallow",
                         attention_depth=2, encoder_type="classic",
                         **_kwargs(base, orientation))


@pytest.fixture
def tf32_switches():
    """Restore both TF32 switches after the test."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = saved


@pytest.mark.parametrize("precision,tf32", [
    (None, False), ("float32", False), ("highest", False),
    ("tensorfloat32", True), ("high", True), ("default", True),
    ("bfloat16", True)])
def test_matmul_precision_sets_tf32(precision, tf32, tf32_switches):
    flags = [] if precision is None else ["--matmul-precision", precision]
    for check in (port_evaluate.check_supported,
                  port_evaluate.check_train_supported):
        args = get_arguments(["anchor-based", "--device", "cpu", *flags])
        torch.backends.cuda.matmul.allow_tf32 = not tf32
        torch.backends.cudnn.allow_tf32 = not tf32
        port_evaluate.setup(args, check)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32


@pytest.mark.parametrize("tf32", [False, True])
def test_depthwise_conv_follows_matmul_switch(tf32, tf32_switches,
                                              monkeypatch):
    """Forward and both backward convs run with cuDNN's switch set to
    cuBLAS's, and cuDNN's is restored after."""
    seen = []

    def spy(fn):
        def wrapped(*a, **kw):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(depthwise_conv, "_correlate",
                        spy(depthwise_conv._correlate))
    monkeypatch.setattr(torch.nn.grad, "conv2d_weight",
                        spy(torch.nn.grad.conv2d_weight))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = not tf32
    v = torch.randn(1, 2, 9, 3, requires_grad=True)
    w = torch.randn(2, 5, requires_grad=True)
    depthwise_conv.depthwise_time_conv(v, w).sum().backward()
    assert seen == [tf32] * 3
    assert torch.backends.cudnn.allow_tf32 is (not tf32)


def _jax_product_dtypes(jaxpr, out):
    """Output dtypes of every product (dot_general, conv, fft) in a jaxpr
    and its sub-jaxprs, complex as its real part."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated",
                                  "fft"):
            dtype = eqn.outvars[0].aval.dtype
            out.add("float32" if dtype == jnp.complex64 else str(dtype))
        for param in eqn.params.values():
            for sub in (param if isinstance(param, (list, tuple))
                        else [param]):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _jax_product_dtypes(sub, out)
    return out


class _Products(TorchDispatchMode):
    """Output dtypes of the matrix products, convs and FFTs dispatched."""
    OPS = ("mm", "bmm", "addmm", "baddbmm", "convolution", "_fft_r2c",
           "_fft_c2c")

    def __init__(self):
        super().__init__()
        self.dtypes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in self.OPS:
            self.dtypes.add(str(out.real.dtype if out.is_complex()
                                else out.dtype).split(".")[1])
        return out


@pytest.mark.parametrize("base,orientation", ALL, ids=ALL_IDS)
def test_bf16_dtypes_match_jax(base, orientation):
    """Under bf16 the backbone's output, the trunk's output and the set of
    product dtypes are JAX's.  One deliberate gap: the LSTMs' input
    projection, a bf16 product in JAX, runs inside the port's f32
    recurrence (its operands are the same bf16 values)."""
    x = np.random.RandomState(0).randn(2, 64, FEAT).astype(np.float32)
    mask = np.arange(64)[None, :] < np.array([[64], [40]])
    jmodel = _jax_model(base, orientation)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(x), jnp.asarray(mask))
    constants = {k: v for k, v in variables.items() if k != "params"}

    def fwd(params):
        return jmodel.apply(
            {"params": jax_steps._cast_floats(params, jnp.bfloat16),
             **constants}, jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
            deterministic=False, rngs={"dropout": jax.random.PRNGKey(2)},
            capture_intermediates=True, mutable=["intermediates"])

    want = _jax_product_dtypes(jax.make_jaxpr(fwd)(variables["params"]).jaxpr,
                               set())
    inter = jax.eval_shape(fwd, variables["params"])[1]["intermediates"]
    want_base = str(inter["base_model"]["__call__"][0].dtype)
    want_trunk = str(inter["trunk"]["__call__"][0].dtype)

    model = get_model("anchor-based", **_kwargs(base, orientation))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    outs = {}
    model.base_model.register_forward_hook(
        lambda m, i, o: outs.__setitem__("base", o.dtype))
    model.trunk.register_forward_hook(
        lambda m, i, o: outs.__setitem__("trunk", o.dtype))
    model.train()
    with _Products() as products:
        cls, loc = steps.train_forward(model, torch.from_numpy(x),
                                       torch.from_numpy(mask),
                                       compute_dtype="bfloat16")
    assert cls.dtype == loc.dtype == torch.float32
    assert str(outs["base"]).split(".")[1] == want_base
    assert str(outs["trunk"]).split(".")[1] == want_trunk
    if base in ("lstm", "bilstm"):
        want = want - {"bfloat16"}
    assert products.dtypes == want
    assert want_base == ("float32" if base in ("lstm", "bilstm", "performer")
                         or (base == "fourier" and orientation != "temporal")
                         else "bfloat16")


def _batch():
    """Two videos in one bucket of 64 and a third row of padding, with
    labels sampled by JAX."""
    rng = np.random.RandomState(0)
    videos = [_video(rng, f"d/tvsum_{i}", n) for i, n in enumerate([40, 53])]
    jitems = [jax_batching.prepare_ab_item(
        JaxRecord(**v), anchor_scales=[4, 8], pos_iou=0.6, neg_iou=0.0,
        inc_iou=0.3, bucket_size=32) for v in videos]
    batch = next(jax_batching.batch_items(jitems, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    cls_label = np.array(jax_steps.build_ab_cls_labels(
        {k: jnp.asarray(batch[k]) for k in ("cls_pos", "neg_eligible",
                                            "inc_eligible", "num_pos")},
        jax.random.PRNGKey(3), 2.0, 1.0))
    return batch, cls_label


def _jax_step(base, batch, cls_label, dtype=jnp.float32, remat=False):
    """JAX's loss, gradients and Adam-updated params for one step at
    deterministic=True, in ``dtype`` as ab_train_step computes it."""
    jmodel = _jax_model(base)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(batch["seq"]),
                            jnp.asarray(batch["mask"]))
    params = variables["params"]
    constants = {k: v for k, v in variables.items() if k != "params"}

    def fwd(p):
        if dtype != jnp.float32:
            p = jax_steps._cast_floats(p, dtype)
        out = jmodel.apply({"params": p, **constants},
                           jnp.asarray(batch["seq"], dtype), batch["mask"],
                           deterministic=True)
        return jax.tree.map(lambda t: t.astype(jnp.float32), out)

    if remat:
        fwd = jax.checkpoint(fwd)

    def loss_fn(p):
        pred_cls, pred_loc = fwd(p)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, batch["loc_label"],
                                               cls_label)
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, cls_label)
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).astype(
            jnp.float32)
        return jnp.sum((cls + loc) * w) / jnp.maximum(w.sum(), 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    return variables, float(loss), grads, optax.apply_updates(params, updates)


def _port_step(model, batch, cls_label, dropout=False, **flags):
    """One port step -> (loss, flax-named gradients, flax-named params,
    optimizer)."""
    if not dropout:
        for module in model.modules():
            if isinstance(module, Dropout):
                module.p = 0.0
    optimizer = steps.make_optimizer(model.parameters(), LR, WD)
    metrics = steps.ab_train_step(
        model, optimizer, trainer.to_device(batch, torch.device("cpu")),
        None, lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
        cls_label=torch.from_numpy(cls_label), **flags)
    grads = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters() if p.requires_grad})))
    params = dict(_leaves(state_dict_to_flax(model.state_dict())))
    return float(metrics["loss"]), grads, params, optimizer


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values (8 significant bits) at |x|."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7) if x else 0.0


@pytest.mark.parametrize("base", ["nystromformer", "attention"])
def test_bf16_step_as_close_to_f64_as_jax(base):
    """The loss within 2x JAX's bf16 error to the port's float64 step plus
    1e-6; each gradient leaf within 2x JAX's plus 1e-6 plus one bfloat16
    spacing at the leaf's largest entry: a leaf is a bfloat16 value in both
    packages, and a one-element leaf that JAX happens to round onto (a
    2.5e-6 error at 0.17) leaves an equally exact port one grid step off."""
    batch, cls_label = _batch()
    variables, jax_loss, jax_grads, _ = _jax_step(base, batch, cls_label,
                                                  jnp.bfloat16)
    model = get_model("anchor-based", **_kwargs(base))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = copy.deepcopy(model).double()
    loss, grads, params, optimizer = _port_step(model, batch, cls_label,
                                                compute_dtype="bfloat16")
    batch64 = {**batch, "seq": batch["seq"].astype(np.float64)}
    loss64, grads64, _, _ = _port_step(ref, batch64, cls_label)

    def gap(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max())

    assert gap(loss, loss64) <= 2 * gap(jax_loss, loss64) + 1e-6
    want = dict(_leaves(jax_grads))
    assert sorted(grads) == sorted(want)
    for name in want:
        assert gap(grads[name], grads64[name]) <= 2 * gap(
            want[name], grads64[name]) + 1e-6 + _bf16_ulp(
                np.abs(grads64[name]).max()), name
    moments = [t for st in optimizer.state.values() for k, t in st.items()
               if k.startswith("exp_avg")]
    assert len(moments) == 2 * len(grads)
    assert all(t.dtype == torch.float32 for t in moments)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moved = [n for n, w in _leaves(variables["params"])
             if not np.array_equal(w, params[n])]
    assert len(moved) == len(params)


@pytest.mark.parametrize("base,orientation", ALL, ids=ALL_IDS)
def test_bf16_step_trains_every_backbone(base, orientation):
    """A bf16 step with dropout: finite loss, float32 masters and Adam
    moments, every trainable parameter moved, frozen ones and buffers
    unchanged."""
    batch, cls_label = _batch()
    model = get_model("anchor-based", **_kwargs(base, orientation))
    set_dropout_generator(model, torch.Generator().manual_seed(5))
    before = {n: t.clone() for n, t in model.state_dict().items()}
    loss, _, _, optimizer = _port_step(model, batch, cls_label, dropout=True,
                                       compute_dtype="bfloat16")
    assert np.isfinite(loss)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p, before[n]) != p.requires_grad, n
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n
    for state in optimizer.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype \
            == torch.float32


@pytest.mark.parametrize("base", ["attention", "nystromformer"])
def test_remat_step_matches_jax_and_plain(base):
    batch, cls_label = _batch()
    variables, jax_loss, jax_grads, jax_params = _jax_step(
        base, batch, cls_label, remat=True)
    model = get_model("anchor-based", **_kwargs(base))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    plain, again = copy.deepcopy(model), copy.deepcopy(model)
    loss, grads, params, _ = _port_step(model, batch, cls_label, remat=True)
    np.testing.assert_allclose(loss, jax_loss, **TOL)
    for tree, got in ((jax_grads, grads), (jax_params, params)):
        want = dict(_leaves(tree))
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                       **TOL)

    # with dropout on, the recomputation replays the masks of the first pass
    gens = []
    for m in (plain, again):
        gens.append(torch.Generator().manual_seed(9))
        set_dropout_generator(m, gens[-1])
    results = [_port_step(m, batch, cls_label, dropout=True, remat=remat)
               for m, remat in ((plain, False), (again, True))]
    (loss_a, grads_a, params_a, _), (loss_b, grads_b, params_b, _) = results
    assert loss_a == pytest.approx(loss_b, rel=1e-6, abs=1e-6)
    for a, b in ((grads_a, grads_b), (params_a, params_b)):
        for name in a:
            np.testing.assert_allclose(b[name], a[name], rtol=1e-6,
                                       atol=1e-6, err_msg=name)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    if base == "attention":       # dropout drew from the generator
        assert not torch.equal(gens[0].get_state(),
                               torch.Generator().manual_seed(9).get_state())


def test_untied_trunk_matches_jax():
    """_FcTrunk and DSNet with tie_fc_blocks=False against JAX's modules,
    with fc_block_{i} names through the bridge."""
    rng = np.random.RandomState(6)
    h = rng.randn(2, 20, FEAT).astype(np.float32)
    jtrunk = JaxTrunk(8, 3, tie_fc_blocks=False)
    tv = jtrunk.init(jax.random.PRNGKey(0), jnp.asarray(h))
    trunk = _FcTrunk(FEAT, 8, 3, tie_fc_blocks=False)
    trunk.load_state_dict(flax_to_state_dict(tv), strict=True)
    assert sorted(n for n, _ in trunk.named_children()) == [
        "fc1", "fc_block_0", "fc_block_1", "fc_block_2"]
    with torch.no_grad():
        got = trunk.eval()(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtrunk.apply(
        tv, jnp.asarray(h))), **TOL)

    lens = [40, 23]
    x = rng.randn(2, 40, FEAT).astype(np.float32)
    mask = np.arange(40)[None, :] < np.asarray(lens)[:, None]
    kw = _kwargs("nystromformer")
    jmodel = JaxDSNet(kw["base_model"], FEAT, 8, (4, 8), 2, fc_depth=2,
                      tie_fc_blocks=False)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    assert sorted(variables["params"]["trunk"]) == ["fc1", "fc_block_0",
                                                    "fc_block_1"]
    model = DSNet(kw["base_model"], FEAT, 8, [4, 8], 2, fc_depth=2,
                  tie_fc_blocks=False)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    with torch.no_grad():
        got = model.predict(torch.from_numpy(x), torch.from_numpy(mask))
    want = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                        method="predict")
    for i, n in enumerate(lens):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a[i, :2 * n].numpy(),
                                       np.asarray(b)[i, :2 * n], **TOL)


def test_untie_flag_trains_tied_trunk(tmp_path, caplog):
    """--untie-fc-blocks reaches no model, in edsnet_tpu's factory and in
    the port's train CLI, which writes the tied trunk and logs it."""
    jmodel = jax_get_model("anchor-based", model_depth="shallow",
                           attention_depth=2, encoder_type="classic",
                           untie_fc_blocks=True, **_kwargs("linear"))
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, FEAT)),
                          jnp.ones((1, 8), bool))["params"]
    assert sorted(jparams["trunk"]) == ["fc1", "fc_block"]

    split = _write_mock(tmp_path)
    model_dir = tmp_path / "model"
    caplog.set_level("WARNING")
    port_train.main([
        "anchor-based", "--device", "cpu", "--base-model", "linear",
        "--splits", str(split), "--data-root", str(tmp_path), "--model-dir",
        str(model_dir), "--num-feature", str(FEAT), "--num-hidden", "8",
        "--fc-depth", "2", "--num-head", "2", "--bucket-size", "32",
        "--batch-size", "2", "--anchor-scales", "4", "8", "--max-epoch", "1",
        "--untie-fc-blocks"])
    state = torch.load(model_dir / "checkpoint" / "mock.yml.0.pt",
                       weights_only=True)
    trunk = sorted({k.split(".")[1] for k in state if k.startswith("trunk.")})
    assert trunk == ["fc1", "fc_block"]
    assert any("--untie-fc-blocks: the trunk stays tied" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("depth", ["shallow", "deep"])
def test_untie_flag_keeps_af_trunk_tied(depth, caplog):
    """The same on anchor-free: edsnet_tpu's get_anchor_free never passes
    tie_fc_blocks either, so the port logs the flag and builds one tied
    trunk/fc_block."""
    kw = dict(base_model="linear", num_feature=FEAT, num_hidden=8,
              num_head=2, fc_depth=3, orientation="paper",
              model_depth=depth, untie_fc_blocks=True)
    jparams = jax_get_model("anchor-free", **kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, FEAT)),
        jnp.ones((1, 8), bool))["params"]
    assert sorted(jparams["trunk"]) == ["fc1", "fc_block"]
    caplog.set_level("WARNING")
    model = get_model("anchor-free", **kw)
    assert sorted(n for n, _ in model.trunk.named_children()) == [
        "fc1", "fc_block"]
    assert len(model.trunk.blocks) == 3
    assert sorted(state_dict_to_flax(model.state_dict())["trunk"]) == [
        "fc1", "fc_block"]
    assert any("--untie-fc-blocks: the trunk stays tied" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("flags,want", [
    ([], dict(remat=False, compute_dtype="float32")),
    (["--compute-dtype", "bfloat16", "--remat"],
     dict(remat=True, compute_dtype="bfloat16"))])
def test_trainer_passes_step_flags(flags, want, tmp_path, monkeypatch,
                                   caplog):
    """train_records resolves --compute-dtype (auto is float32 off a TPU)
    and hands it and --remat to every step."""
    seen = []
    real = trainer.ab_train_step

    def spy(*a, **kw):
        seen.append({k: kw[k] for k in want})
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "ab_train_step", spy)
    caplog.set_level("INFO")
    rng = np.random.RandomState(4)
    train = [VideoRecord(**_video(rng, f"d/tvsum_{i}", n))
             for i, n in enumerate([20, 40, 24])]
    val = [VideoRecord(**_video(rng, "d/summe_0", 30, users=5))]
    args = get_arguments([
        "anchor-based", "--device", "cpu", "--base-model", "nystromformer",
        "--num-feature", str(FEAT), "--num-hidden", "8", "--fc-depth", "1",
        "--num-head", "2", "--bucket-size", "32", "--batch-size", "2",
        "--anchor-scales", "4", "--max-epoch", "2", *flags])
    best, f1s, _ = trainer.train_records(args, train, val,
                                         tmp_path / "best.pt")
    assert seen and all(s == want for s in seen)
    assert 0.0 <= best <= 1.0 and len(f1s) == 2
    logged = any("compute dtype: bfloat16" in r.getMessage()
                 for r in caplog.records)
    assert logged == (want["compute_dtype"] == "bfloat16")
