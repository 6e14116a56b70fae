"""edsnet_torch resumable training, as tests/test_resume.py holds edsnet_tpu
to it: training continues from the ``.state`` snapshot, a resumed run
equals an uninterrupted one bit for bit on both heads (the snapshot carries
the batch-composition RandomState and the dropout and label generators), a
crash leaves the best checkpoint, ``--state-save-every`` tightens the crash
window and a mid-cadence snapshot never records a best F whose parameters
are not on disk.  Also ``--host-eval`` training against the device path and
the ``--profile`` trace."""
import json
import re

import h5py
import numpy as np
import pytest
import torch
import yaml

from edsnet_torch import train as port_train
from edsnet_torch import trainer
from edsnet_torch.config import get_arguments
from edsnet_torch.data.dataset import load_yaml
from edsnet_torch.utils import checkpoint as ckpt_lib


def _make_mock_h5(tmp_path):
    """tests/test_resume.py's data: 3 videos, 16-d unit features, 10 equal
    shots; 2 train keys and 1 test key; and 24-wide motion features, one
    row per position, from a stream of their own (the heads without motion
    ignore them)."""
    rng = np.random.RandomState(0)
    motion_rng = np.random.RandomState(1)
    with h5py.File(tmp_path / "mock_tvsum.h5", "w") as f:
        for i, n_seq in enumerate([20, 24, 28]):
            n_frames = n_seq * 15
            g = f.create_group(f"video_{i}")
            feats = rng.randn(n_seq, 16).astype(np.float32)
            g["features"] = feats / np.linalg.norm(feats, -1, keepdims=True)
            g["gtscore"] = rng.rand(n_seq).astype(np.float32)
            b = np.linspace(0, n_frames, 11, dtype=np.int32)
            g["change_points"] = np.stack([b[:-1], b[1:] - 1], 1)
            g["n_frame_per_seg"] = b[1:] - b[:-1]
            g["n_frames"] = n_frames
            g["picks"] = np.arange(n_seq, dtype=np.int32) * 15
            g["user_summary"] = (rng.rand(2, n_frames) > 0.8).astype(
                np.float32)
            g["motion_features"] = motion_rng.randn(n_seq, 24).astype(
                np.float32)
    keys = [f"d/mock_tvsum.h5/video_{i}" for i in range(3)]
    split_path = tmp_path / "mock.yml"
    with open(split_path, "w") as f:
        yaml.dump([{"train_keys": keys[:2], "test_keys": keys[2:]}], f)
    return split_path


FLAGS = ["--device", "cpu", "--num-feature", "16", "--num-hidden", "8",
         "--fc-depth", "1", "--num-head", "2", "--bucket-size", "32",
         "--batch-size", "2"]
HEADS = {
    "anchor-based linear": ["anchor-based", "--base-model", "linear",
                            "--anchor-scales", "4"],
    "anchor-based attention": ["anchor-based", "--base-model", "attention",
                               "--anchor-scales", "4"],
    "anchor-free attention": ["anchor-free", "--base-model", "attention"],
    "motion head": ["anchor-based", "--model-depth", "cross-attention",
                    "--base-model", "attention", "--anchor-scales", "4",
                    "--attention-depth", "1"],
}


def _args(tmp_path, model_dir, max_epoch, head="anchor-based linear",
          extra=("--resume",)):
    return get_arguments(HEADS[head] + FLAGS + [
        "--data-root", str(tmp_path), "--model-dir",
        str(tmp_path / model_dir), "--max-epoch", str(max_epoch), *extra])


def _state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_resume_continues_training(tmp_path):
    split_path = _make_mock_h5(tmp_path)
    argv = HEADS["anchor-based linear"] + FLAGS + [
        "--splits", str(split_path), "--data-root", str(tmp_path),
        "--model-dir", str(tmp_path / "m"), "--resume"]
    port_train.main(argv + ["--max-epoch", "2"])
    state_path = tmp_path / "m" / "checkpoint" / "mock.yml.0.pt.state"
    assert _state(state_path)["epoch"] == 2
    # resume to epoch 4; the snapshot must advance
    port_train.main(argv + ["--max-epoch", "4"])
    assert _state(state_path)["epoch"] == 4


@pytest.mark.parametrize("head,extra", [
    ("anchor-based attention", ()), ("anchor-free attention", ()),
    ("anchor-based attention", ("--host-eval",)),
    ("motion head", ("--host-eval",))],
    ids=["anchor-based", "anchor-free", "anchor-based-host-eval",
         "motion-head-host-eval"])
def test_resume_matches_uninterrupted(tmp_path, head, extra):
    """2 epochs + resume to 4 equals an uninterrupted 4-epoch run bit for
    bit: the anchor-based step draws from the label generator, the
    attention backbone from the dropout generator, and the batches from
    the RandomState."""
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    extra = ("--resume", *extra)
    trainer.train(_args(tmp_path, "a", 4, head, extra), split,
                  tmp_path / "a.pt")
    trainer.train(_args(tmp_path, "b", 2, head, extra), split,
                  tmp_path / "b.pt")
    assert _state(tmp_path / "b.pt.state")["epoch"] == 2
    trainer.train(_args(tmp_path, "b", 4, head, extra), split,
                  tmp_path / "b.pt")

    raw_a = _state(tmp_path / "a.pt.state")
    raw_b = _state(tmp_path / "b.pt.state")
    assert raw_a["epoch"] == raw_b["epoch"] == 4
    assert raw_a["best_fscore"] == raw_b["best_fscore"]
    assert raw_a["model"].keys() == raw_b["model"].keys()
    for k in raw_a["model"]:
        assert torch.equal(raw_a["model"][k], raw_b["model"][k]), k
    for sa, sb in zip(raw_a["optimizer"]["state"].values(),
                      raw_b["optimizer"]["state"].values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for name in ("dropout", "label"):
        assert torch.equal(raw_a["generators"][name],
                           raw_b["generators"][name])
    assert torch.equal(raw_a["np_rng"]["keys"], raw_b["np_rng"]["keys"])
    best_a = torch.load(tmp_path / "a.pt", weights_only=True)
    best_b = torch.load(tmp_path / "b.pt", weights_only=True)
    assert all(torch.equal(best_a[k], best_b[k]) for k in best_a)


def test_async_crash_leaves_best_checkpoint(tmp_path, monkeypatch):
    """A crash mid-run leaves the best-so-far checkpoint: the device path
    flushes it at logging epochs (0 and 30), so a death at epoch 35 loses
    at most one logging window."""
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    calls = {"n": 0}
    real = trainer.eval_fscore_device

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 35:
            raise RuntimeError("simulated crash")
        return real(*a, **kw)

    monkeypatch.setattr(trainer, "eval_fscore_device", dying)
    with pytest.raises(RuntimeError, match="simulated crash"):
        trainer.train(_args(tmp_path, "c", 60, extra=()), split,
                      tmp_path / "c.pt")
    assert calls["n"] == 36, calls
    assert (tmp_path / "c.pt").exists()
    assert "heads.fc_cls.weight" in torch.load(tmp_path / "c.pt",
                                               weights_only=True)
    assert not (tmp_path / "c.pt.state").exists()   # no --resume


def test_state_save_every_tightens_crash_window(tmp_path, monkeypatch):
    """--state-save-every N writes the snapshot between logging epochs: a
    crash at a non-logging epoch resumes from that epoch, not from the
    last logging one."""
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    real = trainer.eval_fscore_device

    def run(model_dir, state_save_every):
        calls = {"n": 0}

        def dying(*a, **kw):
            calls["n"] += 1
            if calls["n"] > 5:   # die at epoch 5's eval
                raise RuntimeError("simulated crash")
            return real(*a, **kw)

        monkeypatch.setattr(trainer, "eval_fscore_device", dying)
        args = _args(tmp_path, model_dir, 60, extra=(
            "--resume", "--state-save-every", str(state_save_every)))
        with pytest.raises(RuntimeError, match="simulated crash"):
            trainer.train(args, split, tmp_path / f"{model_dir}.pt")
        return _state(tmp_path / f"{model_dir}.pt.state")["epoch"]

    # default: the last snapshot was the logging epoch 0's (records 1)
    assert run("defcad", 0) == 1
    # every epoch, before the eval gate: epoch 5 trained and saved, then
    # its eval crashed -> the resume starts at epoch 6
    assert run("tight", 1) == 6


def test_mid_cadence_save_never_outruns_checkpoint(tmp_path, monkeypatch):
    """Every best F that a --state-save-every snapshot records has its
    parameters in the checkpoint on disk already."""
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    calls = {"n": 0}
    events = []   # ("ckpt", evals done at the flush) / ("state", best F)
    real_ckpt = ckpt_lib.save_checkpoint
    real_state = ckpt_lib.save_train_state

    def rising_eval(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 5:  # crash at epoch 5's eval, after its mid-save
            raise RuntimeError("simulated crash")
        return torch.tensor(0.1 * calls["n"])

    def spy_ckpt(state, path):
        events.append(("ckpt", calls["n"]))
        return real_ckpt(state, path)

    def spy_state(model, optimizer, epoch, best_fscore, path, **kw):
        events.append(("state", best_fscore))
        return real_state(model, optimizer, epoch, best_fscore, path, **kw)

    monkeypatch.setattr(trainer, "eval_fscore_device", rising_eval)
    monkeypatch.setattr(ckpt_lib, "save_checkpoint", spy_ckpt)
    monkeypatch.setattr(ckpt_lib, "save_train_state", spy_state)
    args = _args(tmp_path, "outrun", 60,
                 extra=("--resume", "--state-save-every", "2"))
    with pytest.raises(RuntimeError, match="simulated crash"):
        trainer.train(args, split, tmp_path / "outrun.pt")

    flushed = 0.0
    for kind, val in events:
        if kind == "ckpt":
            flushed = max(flushed, 0.1 * val)
        else:
            assert val <= flushed + 1e-6, (
                f"state save recorded best F={val} but only F={flushed} "
                f"was ever flushed to disk: {events}")
    # the epoch-5 mid-save saw the best through epoch 4 (0.5) and flushed
    assert abs(_state(tmp_path / "outrun.pt.state")["best_fscore"]
               - 0.5) < 1e-6
    assert (tmp_path / "outrun.pt").exists()


@pytest.mark.parametrize("head", ["anchor-based attention",
                                  "anchor-free attention", "motion head"])
def test_host_eval_training_matches_device_path(tmp_path, head):
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    dev = trainer.train(_args(tmp_path, "d", 4, head, extra=()), split,
                        tmp_path / "d.pt")
    host = trainer.train(_args(tmp_path, "h", 4, head,
                               extra=("--host-eval",)), split,
                         tmp_path / "h.pt")
    assert host[2] == dev[2] == [0, 1, 2, 3]
    assert host[1] == pytest.approx(dev[1], abs=1e-6)
    assert host[0] == pytest.approx(dev[0], abs=1e-6)
    assert max(dev[1]) > 0
    best_d = torch.load(tmp_path / "d.pt", weights_only=True)
    best_h = torch.load(tmp_path / "h.pt", weights_only=True)
    assert best_d.keys() == best_h.keys()
    assert all(torch.equal(best_d[k], best_h[k]) for k in best_d)


def test_profile_traces_epoch_one_and_counts_frames(tmp_path, caplog):
    split = load_yaml(_make_mock_h5(tmp_path))[0]
    caplog.set_level("INFO")
    trainer.train(_args(tmp_path, "p", 3, extra=("--profile",)), split,
                  tmp_path / "p.pt")
    traces = list((tmp_path / "p" / "profile").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    line = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("train throughput: ")]
    summary = yaml.safe_load(re.sub(r"^train throughput: ", "", line[-1]))
    # 3 epochs over the two train videos' 20 + 24 positions
    assert summary["frames"] == 3 * (20 + 24)
    assert summary["steps"] >= 3 and summary["frames_per_sec"] > 0
    assert any("top device ops" in r.getMessage() for r in caplog.records)
