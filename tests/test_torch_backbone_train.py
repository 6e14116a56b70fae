"""edsnet_torch training and evaluation with each new token mixer vs
edsnet_tpu: one anchor-based train step from the same weights and the same
injected labels (loss, every gradient and every updated parameter to
1e-5; Performer's ``projection`` untouched), per-video F of the device
evaluator, the evaluate CLI on a JAX-written checkpoint (``constants`` and
LSTM cells included), and the CLI train -> evaluate round trip on the
nystromformer head."""
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
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import eval_device as jax_eval
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_tpu.utils.checkpoint import save_checkpoint
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.common import Dropout
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import eval_device as port_eval
from edsnet_torch.parallel import steps
from tests.test_torch_backbones import BACKBONES, IDS
from tests.test_torch_eval import _videos, _write_dataset
from tests.test_torch_train import _leaves, _video, _write_mock

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT = 32
LR, WD = 5e-5, 1e-5


def _kwargs(base, orientation="paper"):
    return dict(base_model=base, orientation=orientation, num_feature=FEAT,
                num_hidden=8, anchor_scales=[4, 8], num_head=2, fc_depth=2,
                pooling_type="roi")


def _jax_model(base, orientation="paper"):
    return jax_get_model("anchor-based", model_depth="shallow",
                         attention_depth=2, encoder_type="classic",
                         **_kwargs(base, orientation))


@pytest.mark.parametrize("base,orientation", BACKBONES, ids=IDS)
def test_train_step_matches_jax(base, orientation):
    rng = np.random.RandomState(0)
    videos = [_video(rng, f"d/tvsum_{i}", n) for i, n in enumerate([40, 53])]
    kwargs = dict(anchor_scales=[4, 8], pos_iou=0.6, neg_iou=0.0,
                  inc_iou=0.3, bucket_size=32)
    jitems = [jax_batching.prepare_ab_item(JaxRecord(**v), **kwargs)
              for v in videos]
    # one bucket of 64 positions, a third row of padding
    batch = next(jax_batching.batch_items(jitems, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    cls_label = np.array(jax_steps.build_ab_cls_labels(
        {k: jnp.asarray(batch[k]) for k in ("cls_pos", "neg_eligible",
                                            "inc_eligible", "num_pos")},
        jax.random.PRNGKey(3), 2.0, 1.0))

    jmodel = _jax_model(base, orientation)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.asarray(batch["seq"]),
                            jnp.asarray(batch["mask"]))
    params = variables["params"]
    constants = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(p):   # steps.py at deterministic=True
        pred_cls, pred_loc = jmodel.apply({"params": p, **constants},
                                          batch["seq"], batch["mask"],
                                          deterministic=True)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, batch["loc_label"],
                                               cls_label)
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, cls_label)
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).astype(
            jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        return jnp.sum((cls + loc) * w) / denom

    loss, grads = jax.value_and_grad(loss_fn)(params)
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    model = get_model("anchor-based", **_kwargs(base, orientation))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    assert sorted(buffers) == (["base_model.attn_0.projection"]
                               if base == "performer" else [])
    for module in model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    optimizer = steps.make_optimizer(model.parameters(), LR, WD)
    metrics = steps.ab_train_step(
        model, optimizer, trainer.to_device(batch, torch.device("cpu")),
        None, lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
        cls_label=torch.from_numpy(cls_label))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss), **TOL)

    got_grads = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()
         if p.requires_grad})))
    got_params = dict(_leaves(state_dict_to_flax(model.state_dict())))
    for tree, got in ((grads, got_grads), (new_params, got_params)):
        want = dict(_leaves(tree))
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                       **TOL)
    moved = [n for n, w in _leaves(params) if not np.array_equal(
        w, got_params[n])]
    assert len(moved) == len(got_params)
    for name, b in model.named_buffers():
        assert torch.equal(b, buffers[name]), name


def _records(videos, cls):
    return [cls(**v) for v in videos]


@pytest.mark.parametrize("base", ["nystromformer", "performer", "lstm",
                                  "gcn"])
def test_device_eval_matches_jax_per_video(base):
    videos = _videos()
    jmodel = _jax_model(base)
    variables = jmodel.init({"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 32, FEAT)), jnp.ones((1, 32), bool))
    model = get_model("anchor-based", **_kwargs(base))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    jrecords, records = (_records(videos, JaxRecord),
                         _records(videos, VideoRecord))
    for jb, tb in zip(jax_eval.prepare_eval_batches(jrecords, 2, 32),
                      port_eval.prepare_eval_batches(records, 2, 32, "cpu")):
        want_f, want_s = jax_eval._eval_batch_device(
            jmodel, variables, jb["jb"], 2, 0.5, jb["frame_bucket"],
            uniform_rate=jb["uniform_rate"])
        got_f, got_s = port_eval._eval_batch_device(
            model, tb["tb"], 2, 0.5, tb["frame_bucket"],
            uniform_rate=tb["uniform_rate"])
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    got = port_eval.evaluate_on_device(model, records, 0.5, batch_size=2,
                                       bucket_size=32)
    want = jax_eval.evaluate_on_device(jmodel, variables, jrecords, 0.5,
                                       batch_size=2, bucket_size=32)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("base", ["nystromformer", "performer", "lstm",
                                  "bilstm", "gcn"])
def test_evaluate_cli_reads_jax_checkpoint(base, tmp_path, capsys):
    split = _write_dataset(tmp_path, _videos())
    variables = _jax_model(base).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, FEAT)), jnp.ones((1, 32), bool))
    assert ("constants" in variables) == (base == "performer")
    save_checkpoint(variables, tmp_path / "model" / "checkpoint"
                    / "mock.yml.0.pt")
    argv = ["anchor-based", "--device", "cpu", "--base-model", base,
            "--splits", str(split), "--data-root", str(tmp_path),
            "--model-dir", str(tmp_path / "model"), "--num-feature",
            str(FEAT), "--num-head", "2", "--num-hidden", "8", "--fc-depth",
            "2", "--anchor-scales", "4", "8", "--bucket-size", "32",
            "--batch-size", "2"]
    jax_evaluate.main(argv)
    want = capsys.readouterr().out.strip().splitlines()
    port_evaluate.main(argv)
    got = capsys.readouterr().out.strip().splitlines()
    assert len(want) == 2 and "F-score" in want[-1]
    assert got == want


def test_train_cli_round_trip_nystromformer(tmp_path, capsys):
    """The verify recipe's CPU train -> evaluate run with --base-model
    nystromformer: evaluate prints the F the train run recorded."""
    split = _write_mock(tmp_path)
    model_dir = tmp_path / "model"
    argv = ["anchor-based", "--device", "cpu", "--base-model",
            "nystromformer", "--splits", str(split), "--data-root",
            str(tmp_path), "--model-dir", str(model_dir), "--num-feature",
            str(FEAT), "--num-hidden", "8", "--fc-depth", "2", "--num-head",
            "2", "--bucket-size", "32", "--batch-size", "2",
            "--anchor-scales", "4", "8"]
    port_train.main(argv + ["--max-epoch", "2"])
    trained = capsys.readouterr().out
    results = yaml.safe_load((model_dir / "mock.yml").read_text())
    assert 0.0 <= results["split0"] == results["mean"] <= 1.0
    assert trained.strip().endswith(f"mean F-score {results['mean']:.4f}")
    state = torch.load(model_dir / "checkpoint" / "mock.yml.0.pt",
                       weights_only=True)
    assert state["base_model.res_conv"].shape == (2, 1, 33, 1)
    port_evaluate.main(argv)
    evaluated = capsys.readouterr().out.strip().splitlines()
    assert evaluated[-1].endswith(f"F-score: {results['split0']:.4f}")
