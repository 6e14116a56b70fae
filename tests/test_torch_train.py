"""edsnet_torch training vs edsnet_tpu: one anchor-based train step from the
same weights and the same injected labels (loss, every gradient and every
updated parameter to 1e-5: f32, another summation order), dropout with an
explicit generator, the train CLI's flag checks, and the train -> evaluate
round trip of the CLIs on a mock h5."""
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.config import get_arguments
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.data import batching
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models.common import Dropout, set_dropout_generator
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import steps

TOL = dict(rtol=1e-5, atol=1e-5)
FEAT = 32
SMALL = dict(base_model="attention", num_feature=FEAT, num_hidden=8,
             anchor_scales=[4, 8], num_head=2, fc_depth=2,
             pooling_type="roi")
LR, WD = 5e-5, 1e-5


def _video(rng, key, n_seq, users=3, shots=10):
    """The verify recipe's mock video: unit-norm features, equal shots."""
    n_frames = n_seq * 15
    feats = rng.randn(n_seq, FEAT).astype(np.float32)
    bounds = np.linspace(0, n_frames, shots + 1, dtype=np.int32)
    return dict(key=key,
                seq=feats / np.linalg.norm(feats, axis=-1, keepdims=True),
                gtscore=rng.rand(n_seq).astype(np.float32),
                cps=np.stack([bounds[:-1], bounds[1:] - 1], 1),
                n_frames=n_frames,
                nfps=(bounds[1:] - bounds[:-1]).astype(np.int32),
                picks=np.arange(n_seq, dtype=np.int32) * 15,
                user_summary=(rng.rand(users, n_frames) > 0.8
                              ).astype(np.float32))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_train_step_matches_jax():
    rng = np.random.RandomState(0)
    videos = [_video(rng, f"d/tvsum_{i}", n) for i, n in enumerate([40, 52])]
    kwargs = dict(anchor_scales=[4, 8], pos_iou=0.6, neg_iou=0.0,
                  inc_iou=0.3, bucket_size=32)
    jitems = [jax_batching.prepare_ab_item(JaxRecord(**v), **kwargs)
              for v in videos]
    # one bucket of 64 positions, a third row of padding
    batch = next(jax_batching.batch_items(jitems, 2, 32, shuffle=False,
                                          pad_batch_to=3))
    assert batch["video_valid"].tolist() == [True, True, False]
    cls_label = np.array(jax_steps.build_ab_cls_labels(
        {k: jnp.asarray(batch[k]) for k in ("cls_pos", "neg_eligible",
                                            "inc_eligible", "num_pos")},
        jax.random.PRNGKey(3), 2.0, 1.0))
    assert (cls_label == -1).any() and (cls_label == 1).any()

    jmodel = jax_get_model("anchor-based", model_depth="shallow",
                           attention_depth=2, encoder_type="classic",
                           orientation="paper", **SMALL)
    params = jmodel.init({"params": jax.random.PRNGKey(0),
                          "dropout": jax.random.PRNGKey(1)},
                         jnp.asarray(batch["seq"]),
                         jnp.asarray(batch["mask"]))["params"]

    def loss_fn(p):   # steps.py:171-183 at deterministic=True
        pred_cls, pred_loc = jmodel.apply({"params": p}, batch["seq"],
                                          batch["mask"], deterministic=True)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, batch["loc_label"],
                                               cls_label)
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, cls_label)
        w = (batch["video_valid"] & (batch["num_pos"] > 0)).astype(
            jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        return jnp.sum((cls + loc) * w) / denom, (
            jnp.sum(cls * w) / denom, jnp.sum(loc * w) / denom)

    (loss, (cls_loss, loc_loss)), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    model = get_model("anchor-based", **SMALL)
    model.load_state_dict(flax_to_state_dict({"params": params}),
                          strict=True)
    for module in model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    optimizer = steps.make_optimizer(model.parameters(), LR, WD)
    metrics = steps.ab_train_step(
        model, optimizer, trainer.to_device(batch, torch.device("cpu")),
        None, lambda_reg=1.0, neg_ratio=2.0, inc_ratio=1.0,
        cls_label=torch.from_numpy(cls_label))
    for name, want in (("loss", loss), ("cls_loss", cls_loss),
                       ("loc_loss", loc_loss)):
        np.testing.assert_allclose(float(metrics[name]), float(want),
                                   err_msg=name, **TOL)

    got_grads = dict(_leaves(state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})))
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


def test_dropout_follows_its_generator():
    drop = Dropout(0.5)
    x = torch.ones(4, 256)
    masks = []
    for _ in range(2):
        set_dropout_generator(drop, torch.Generator().manual_seed(11))
        masks.append(drop(x))
    assert torch.equal(masks[0], masks[1])
    assert set(masks[0].unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((masks[0] == 0).float().mean()) < 0.6
    drop.eval()
    assert torch.equal(drop(x), x)


@pytest.mark.parametrize("flags", [
    ["--compute-dtype", "bfloat16"], ["--remat"], ["--resume"],
    ["--state-save-every", "5"], ["--profile"], ["--host-eval"],
    ["--base-model", "lstm"], ["--tensor-parallel", "2"]])
def test_train_flags_not_served_raise(flags):
    args = get_arguments(["anchor-based", "--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_evaluate.setup(args, port_evaluate.check_train_supported)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_evaluate.check_train_supported(get_arguments(
            ["anchor-free", "--device", "cpu"]))


def test_each_cli_rejects_only_its_own_flags():
    args = get_arguments(["anchor-based", "--device", "cpu", "--remat",
                          "--compute-dtype", "bfloat16", "--profile"])
    port_evaluate.check_supported(args)       # evaluate ignores them
    args = get_arguments(["anchor-based", "--device", "cpu",
                          "--knapsack-audit", "--compute-dtype", "float32"])
    port_evaluate.check_train_supported(args)  # train ignores the audit


def _write_mock(tmp_path):
    """The verify recipe's mock h5 (5 videos, 10 equal shots each) and a
    split with 4 train and 1 test key."""
    rng = np.random.RandomState(0)
    with h5py.File(tmp_path / "mock_tvsum.h5", "w") as f:
        for i, n_seq in enumerate([20, 24, 20, 28, 24]):
            v = _video(rng, "", n_seq)
            g = f.create_group(f"video_{i}")
            g["features"] = v["seq"]
            g["gtscore"] = v["gtscore"]
            g["change_points"] = v["cps"]
            g["n_frame_per_seg"] = v["nfps"]
            g["n_frames"] = v["n_frames"]
            g["picks"] = v["picks"]
            g["user_summary"] = v["user_summary"]
    keys = [f"../datasets/mock_tvsum.h5/video_{i}" for i in range(5)]
    split = tmp_path / "mock.yml"
    with open(split, "w") as f:
        yaml.dump([{"train_keys": keys[:4], "test_keys": keys[4:]}], f)
    return split


def test_train_cli_round_trip(tmp_path, capsys):
    split = _write_mock(tmp_path)
    model_dir = tmp_path / "model"
    argv = ["anchor-based", "--device", "cpu", "--splits", str(split),
            "--data-root", str(tmp_path), "--model-dir", str(model_dir),
            "--num-feature", str(FEAT), "--num-hidden", "8", "--fc-depth",
            "2", "--num-head", "2", "--bucket-size", "32", "--batch-size",
            "2", "--anchor-scales", "4", "8"]
    port_train.main(argv + ["--max-epoch", "2"])
    trained = capsys.readouterr().out
    assert "mock: sweep finished, mean F-score" in trained
    assert (model_dir / "checkpoint" / "mock.yml.0.pt").is_file()
    assert yaml.safe_load((model_dir / "args.yml").read_text())[
        "max_epoch"] == 2
    results = yaml.safe_load((model_dir / "mock.yml").read_text())
    assert sorted(results) == ["mean", "split0"]
    assert 0.0 <= results["split0"] == results["mean"] <= 1.0
    assert trained.strip().endswith(f"mean F-score {results['mean']:.4f}")

    port_evaluate.main(argv)
    evaluated = capsys.readouterr().out.strip().splitlines()
    assert evaluated[-1].endswith(f"F-score: {results['split0']:.4f}")


def test_train_records_static_batches_and_eval_every(tmp_path):
    rng = np.random.RandomState(4)
    train = [VideoRecord(**_video(rng, f"d/tvsum_{i}", n))
             for i, n in enumerate([20, 40, 24])]
    val = [VideoRecord(**_video(rng, "d/summe_0", 30, users=5))]
    args = get_arguments([
        "anchor-based", "--device", "cpu", "--num-feature", str(FEAT),
        "--num-hidden", "8", "--fc-depth", "1", "--num-head", "2",
        "--bucket-size", "32", "--batch-size", "2", "--anchor-scales", "4",
        "--max-epoch", "3", "--eval-every", "2", "--static-batches"])
    items = batching.prepare_items(train, "anchor-based", [4],
                                   bucket_size=32)
    assert len(items) == 3
    best, f1s, epochs = trainer.train_records(args, train, val,
                                              tmp_path / "best.pt")
    state = torch.load(tmp_path / "best.pt", weights_only=True)
    assert epochs == [1, 2] and len(f1s) == 2      # every 2nd and the last
    assert best == max(f1s) and 0.0 <= best <= 1.0
    assert set(state) == set(get_model("anchor-based", **{
        **SMALL, "fc_depth": 1, "anchor_scales": [4]}).state_dict())
