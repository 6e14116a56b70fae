"""edsnet_torch's video pipeline vs edsnet_tpu's on the CPU, on the same
synthetic mp4s (JAX's fixtures of tests/data/) and the same weights:

- data/video.py: ``VideoPreprocessor.run`` with the ``random`` extractor
  on host and device KTS equal to JAX's (n_frames, features, cps, nfps,
  picks); a cached GoogLeNet ``.pth`` under a temporary TORCH_HOME read
  by the port's module gives JAX's flax extractor's features within 1e-4,
  and the chunked route (``CHUNK`` frames a forward) the per-frame one's;
  without a cache each CNN raises the RuntimeError naming
  ``edsnet_torch.fetch_weights``; the default device is the card;
- infer.py: ``summarize_video`` equal to JAX's on bridged weights for the
  linear and attention backbones and the motion head; the CLI end to end
  (``--device cpu``, both ``--device-kts``, a motion model on a .npy) on a
  JAX-written checkpoint writes as many frames as JAX's CLI; the three
  errors of ``_load_motion`` and the non-motion ``--motion-feature``
  raise;
- make_dataset.py: the h5 equal to JAX's field for field (plain, both trim
  directions, both motion-dump conventions, a short dump raising);
- data/motion.py: ``flowdiff`` bit-equal, ``conv3d`` on a JAX-written
  msgpack within 1e-5 (two clip sizes, and through
  ``extract_motion_features``), streaming equal to buffered."""
import json
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.hub

from edsnet_torch import infer, make_dataset
from edsnet_torch.convert import flax_to_state_dict
from edsnet_torch.data import motion, video
from edsnet_torch.data.h5io import shot_table
from edsnet_torch.fetch_weights import cached_path
from edsnet_torch.models.common import randomize_cnn_
from edsnet_torch.models.googlenet import GoogLeNetPool5
from edsnet_torch.models.model_zoo import get_model
from edsnet_tpu import infer as jax_infer
from edsnet_tpu import make_dataset as jax_make_dataset
from edsnet_tpu.data import motion as jax_motion
from edsnet_tpu.data import video as jax_video
from edsnet_tpu.models.model_zoo import get_model as jax_get_model
from edsnet_tpu.utils.checkpoint import save_checkpoint as jax_save

cv2 = pytest.importorskip("cv2")

from tests.data.test_infer_motion import (_motion_args,  # noqa: E402
                                          _write_video as write_scenes)
from tests.data.test_infer_video import tiny_mp4  # noqa: E402,F401
from tests.data.test_make_dataset import _write_mp4  # noqa: E402
from tests.data.test_motion_extract import (_buffered_oracle,  # noqa: E402
                                            _write_video)


@pytest.fixture
def empty_hub(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch"))
    monkeypatch.setattr(torch.hub, "_hub_dir", None, raising=False)


# ------------------------------------------------------------ data/video.py

@pytest.mark.parametrize("device_kts", [False, True])
def test_video_preprocessor_random_equals_jax(tiny_mp4, device_kts):
    got = video.VideoPreprocessor(15, "random", device_kts=device_kts,
                                  device="cpu").run(tiny_mp4)
    want = jax_video.VideoPreprocessor(
        15, "random", device_kts=device_kts).run(tiny_mp4)
    assert got[0] == want[0] == 300
    assert got[1].dtype == np.float32 and got[1].shape == (20, 1024)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_default_device_is_the_card():
    """None resolves as --device auto: the card, and a raise without
    one."""
    if torch.cuda.is_available():
        assert video.VideoPreprocessor(15, "random").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            video.VideoPreprocessor(15, "random")


@pytest.fixture
def googlenet_hub(empty_hub):
    """A seeded GoogLeNet checkpoint in the hub cache, with aux and fc
    entries as torchvision's file has."""
    model = GoogLeNetPool5()
    randomize_cnn_(model, torch.Generator().manual_seed(3))
    state = dict(model.state_dict())
    g = torch.Generator().manual_seed(4)
    state["fc.weight"] = torch.randn(1000, 1024, generator=g)
    state["fc.bias"] = torch.randn(1000, generator=g)
    state["aux1.conv.conv.weight"] = torch.randn(128, 512, 1, 1, generator=g)
    path = cached_path("google-net")
    path.parent.mkdir(parents=True)
    torch.save(state, path)


def test_cached_googlenet_equals_jax_extractor(googlenet_hub):
    fe = video.FeatureExtractor("google-net", device="cpu")
    assert isinstance(fe._impl, video.FrameCNNExtractor)
    jax_fe = jax_video.FeatureExtractor("google-net")
    assert isinstance(jax_fe._impl, jax_video._FlaxGoogLeNetExtractor)
    rng = np.random.RandomState(0)
    frames = [(rng.rand(*hw, 3) * 255).astype(np.uint8)
              for hw in ((240, 320), (360, 480), (320, 240))]
    got = fe.run_batch(frames)
    want = np.stack([jax_fe.run(f) for f in frames])
    assert got.shape == (3, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_chunked_features_equal_per_frame(googlenet_hub, tiny_mp4,
                                          monkeypatch):
    """20 sampled frames through chunks of 8, 8 and 4 against the port's
    per-frame route and JAX's."""
    monkeypatch.setattr(video, "CHUNK", 8)
    proc = video.VideoPreprocessor(15, "google-net", device="cpu")
    n_frames, got = proc.get_features(tiny_mp4)
    cap = cv2.VideoCapture(str(tiny_mp4))
    per_frame = []
    for i in range(n_frames):
        ok, frame = cap.read()
        assert ok
        if i % 15 == 0:
            per_frame.append(proc.model.run(
                cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)))
    cap.release()
    assert got.shape == (20, 1024)
    np.testing.assert_allclose(got, np.stack(per_frame), rtol=0, atol=1e-4)
    _, want = jax_video.VideoPreprocessor(15, "google-net").get_features(
        tiny_mp4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", video.FRAME_CNNS)
def test_uncached_cnn_raises_fetch_advice(empty_hub, kind):
    with pytest.raises(RuntimeError) as got:
        video.FeatureExtractor(kind, device="cpu")
    with pytest.raises(RuntimeError) as want:
        jax_video.FeatureExtractor(kind)
    assert "python -m edsnet_torch.fetch_weights" in str(got.value)
    assert str(got.value) == str(want.value).replace("edsnet_tpu",
                                                     "edsnet_torch")


# ---------------------------------------------------------------- infer.py

MODELS = {
    "linear": dict(base_model="linear", num_feature=32, num_head=2),
    "attention": dict(base_model="attention", num_feature=32, num_head=2),
    "motion": dict(base_model="attention", num_feature=32, num_head=2,
                   model_depth="cross-attention"),
}
MOTION_WIDTH = 24


def _model_kwargs(name):
    kw = dict(model_depth="shallow", num_hidden=8, anchor_scales=(4, 8),
              fc_depth=1, attention_depth=1, encoder_type="classic",
              orientation="paper", pooling_type="roi")
    kw.update(MODELS[name])
    return kw


def _pair(name, length=20):
    """JAX's model and variables, and the port's model on them (CPU)."""
    kw = _model_kwargs(name)
    jmodel = jax_get_model("anchor-based", **kw)
    rngs = {"params": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1)}
    x = jnp.zeros((1, length, kw["num_feature"]))
    mask = jnp.ones((1, length), bool)
    if name == "motion":
        variables = jmodel.init(rngs, x,
                                jnp.zeros((1, length, MOTION_WIDTH)),
                                mask, mask)
    else:
        variables = jmodel.init(rngs, x, mask)
    model = get_model("anchor-based", **kw, motion_width=MOTION_WIDTH)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return jmodel, variables, model.eval()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_summarize_video_equals_jax(name):
    jmodel, variables, model = _pair(name)
    rng = np.random.RandomState(5)
    for seq_len in (20, 70):     # buckets 64 and 128
        seq = rng.randn(seq_len, 32).astype(np.float32)
        seq /= np.linalg.norm(seq, axis=-1, keepdims=True)
        n_frames = seq_len * 15
        bounds = np.sort(rng.choice(np.arange(1, seq_len), seq_len // 4,
                                    replace=False))
        cps, nfps = shot_table(bounds, 15, n_frames)
        picks = np.arange(seq_len) * 15
        mot = None
        if name == "motion":
            mot = rng.randn(seq_len, MOTION_WIDTH).astype(np.float32)
        got = infer.summarize_video(model, seq, cps, n_frames, nfps, picks,
                                    0.5, motion=mot)
        want = jax_infer.summarize_video(jmodel, variables, seq, cps,
                                         n_frames, nfps, picks, 0.5,
                                         motion=mot)
        assert got.dtype == bool and got.shape == (n_frames,)
        assert 0 < got.sum() <= int(0.15 * n_frames)
        np.testing.assert_array_equal(got, want)


def _count_frames(path):
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:   # CAP_PROP_FRAME_COUNT is unreliable on mp4v
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("case", ["host-kts", "device-kts", "motion-npy"])
def test_infer_cli_equals_jax(tmp_path, monkeypatch, case):
    """The port's CLI on a JAX-written (flax msgpack) checkpoint writes as
    many frames as JAX's CLI (the 10-scene video of test_infer_cli)."""
    src = tmp_path / "source.mp4"
    write_scenes(src, np.random.RandomState(0))
    kw = dict(model_depth="shallow", base_model="linear", num_feature=1024,
              num_hidden=8, anchor_scales=(4,), num_head=2, fc_depth=1,
              attention_depth=1, encoder_type="classic",
              orientation="paper", pooling_type="roi")
    argv = ["anchor-based", "--base-model", "linear", "--num-hidden", "8",
            "--anchor-scales", "4", "--num-head", "2", "--fc-depth", "1",
            "--source", str(src), "--feature-extractor", "random"]
    example = (jnp.zeros((1, 20, 1024)), jnp.ones((1, 20), bool))
    if case == "motion-npy":
        kw.update(model_depth="cross-attention", base_model="attention")
        argv[2] = "attention"
        argv += ["--model-depth", "cross-attention", "--attention-depth",
                 "1"]
        example = (example[0], jnp.zeros((1, 20, 1024)), example[1],
                   example[1])
        npy = tmp_path / "source.npy"
        np.save(npy, jax_motion.extract_motion_features(src, sample_rate=15))
        argv += ["--motion-feature", str(npy)]
    if case == "device-kts":
        argv.append("--device-kts")
    variables = jax_get_model("anchor-based", **kw).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *example)
    ckpt = tmp_path / "model.pt"
    jax_save(variables, ckpt)
    argv += ["--ckpt-path", str(ckpt)]

    monkeypatch.setattr(sys, "argv", ["infer.py"] + argv + [
        "--save-path", str(tmp_path / "jax.mp4")])
    jax_infer.main()
    infer.main(argv + ["--save-path", str(tmp_path / "port.mp4"),
                       "--device", "cpu"])
    n_port = _count_frames(tmp_path / "port.mp4")
    assert 0 < n_port <= 0.2 * 300 + 30
    assert n_port == _count_frames(tmp_path / "jax.mp4")


@pytest.mark.parametrize("case", ["ok", "width", "too-many", "too-few",
                                  "surplus", "emits-1024"])
def test_load_motion_equals_jax(tmp_path, case):
    rng = np.random.RandomState(0)
    rows, seq_len, width = {"ok": (20, 20, 16), "width": (20, 20, 32),
                            "too-many": (60, 20, 16),
                            "too-few": (20, 24, 16),
                            "surplus": (21, 20, 16),
                            "emits-1024": (None, 20, 512)}[case]
    args = _motion_args()
    if rows is not None:
        npy = tmp_path / "m.npy"
        np.save(npy, rng.randn(rows, 16).astype(np.float32))
        args = _motion_args(motion_feature=str(npy))
    try:
        want = jax_infer._load_motion(args, seq_len, width)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            infer._load_motion(args, seq_len, width)
        assert str(got.value) == str(e)
        return
    assert case in ("ok", "surplus")
    np.testing.assert_array_equal(infer._load_motion(args, seq_len, width),
                                  want)


def test_motion_feature_with_non_motion_model_raises(tmp_path):
    with pytest.raises(ValueError, match="cross-attention"):
        infer.main(["anchor-based", "--base-model", "linear",
                    "--num-hidden", "8", "--anchor-scales", "4",
                    "--fc-depth", "1", "--device", "cpu",
                    "--ckpt-path", str(tmp_path / "none.pt"),
                    "--source", str(tmp_path / "none.mp4"),
                    "--save-path", str(tmp_path / "out.mp4"),
                    "--motion-feature", str(tmp_path / "none.npy")])


# --------------------------------------------------------- make_dataset.py

def _read_h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        for name, group in f.items():
            out[name] = {k: group[k][()] for k in group}
    return out


@pytest.mark.parametrize("case", ["plain", "label-shorter", "label-longer",
                                  "motion-sampled", "motion-per-frame",
                                  "motion-short"])
def test_make_dataset_equals_jax(tmp_path, case):
    videos, labels, dumps = (tmp_path / d for d in ("v", "l", "m"))
    for d in (videos, labels, dumps):
        d.mkdir()
    n_frames = _write_mp4(videos / "clip.mp4", n_frames=150)
    label_frames = {"label-shorter": 147, "label-longer": 152}.get(case, 150)
    summary = np.random.RandomState(1).rand(3, label_frames) > 0.8
    (labels / "clip.json").write_text(
        json.dumps({"user_summary": summary.astype(int).tolist()}))
    argv = ["--video-dir", str(videos), "--label-dir", str(labels),
            "--feature-extractor", "random"]
    rows = {"motion-sampled": 10, "motion-per-frame": n_frames,
            "motion-short": 7}.get(case)
    if rows:
        np.save(dumps / "clip.npy",
                np.random.RandomState(2).randn(rows, 8).astype(np.float32))
        argv += ["--motion-feature", str(dumps)]
    if case == "motion-short":
        with pytest.raises(ValueError) as got:
            make_dataset.main(argv + ["--save-path", str(tmp_path / "p.h5"),
                                      "--device", "cpu"])
        with pytest.raises(ValueError) as want:
            jax_make_dataset.main(argv + ["--save-path",
                                          str(tmp_path / "j.h5")])
        assert str(got.value) == str(want.value)
        return
    make_dataset.main(argv + ["--save-path", str(tmp_path / "p.h5"),
                              "--device", "cpu"])
    jax_make_dataset.main(argv + ["--save-path", str(tmp_path / "j.h5")])
    got, want = _read_h5(tmp_path / "p.h5"), _read_h5(tmp_path / "j.h5")
    assert list(got) == list(want) == ["clip"]
    assert sorted(got["clip"]) == sorted(want["clip"])
    for key, value in want["clip"].items():
        assert np.asarray(got["clip"][key]).dtype == \
            np.asarray(value).dtype, key
        np.testing.assert_array_equal(got["clip"][key], value, err_msg=key)
    assert int(got["clip"]["n_frames"]) == min(n_frames, label_frames)
    assert ("motion_features" in got["clip"]) == bool(rows)


# --------------------------------------------------------- data/motion.py

def test_flowdiff_bit_equal():
    clip = np.random.RandomState(0).randint(0, 256, (8, 112, 112, 3)) / 255.0
    np.testing.assert_array_equal(motion.FlowDiffMotion()(clip),
                                  jax_motion.FlowDiffMotion()(clip))


@pytest.fixture(scope="module")
def conv3d_msgpack(tmp_path_factory):
    """JAX's conv3d net (seed 3) and its variables as a flax msgpack."""
    from flax import serialization

    net = jax_motion.Conv3DMotionNet(seed=3)
    path = tmp_path_factory.mktemp("conv3d") / "net.msgpack"
    path.write_bytes(serialization.to_bytes(net.variables))
    return net, path


@pytest.mark.parametrize("shape", [(8, 112, 112), (5, 57, 46)])
def test_conv3d_on_jax_weights(conv3d_msgpack, shape):
    """SAME padding on even and odd sides."""
    jax_net, path = conv3d_msgpack
    net = motion.Conv3DMotionNet(weights=str(path), device="cpu")
    rng = np.random.RandomState(sum(shape))
    for _ in range(2):
        clip = rng.rand(*shape, 3)
        np.testing.assert_allclose(net(clip), jax_net(clip), rtol=0,
                                   atol=1e-5)


def test_conv3d_extraction_on_jax_weights(conv3d_msgpack, tmp_path):
    _, path = conv3d_msgpack
    src = tmp_path / "clip.mp4"
    _write_video(src, np.random.RandomState(3), 40)
    got = motion.extract_motion_features(src, backend="conv3d",
                                         weights=str(path), device="cpu")
    want = jax_motion.extract_motion_features(src, backend="conv3d",
                                              weights=str(path))
    assert got.shape == want.shape == (3, 1024)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_conv3d_seeded_init_without_weights():
    """The port's own init: seeded, finite, unit-norm features."""
    a = motion.Conv3DMotionNet(seed=0, device="cpu")
    b = motion.Conv3DMotionNet(seed=0, device="cpu")
    clip = np.random.RandomState(0).rand(8, 112, 112, 3)
    np.testing.assert_array_equal(a(clip), b(clip))
    assert abs(np.linalg.norm(a(clip)) - 1.0) < 1e-5
    assert not any(p.detach().any() for n, p in a.net.named_parameters()
                   if n.endswith("bias"))


@pytest.mark.parametrize("n_frames,rate", [(95, 15), (40, 7), (6, 15)])
def test_streaming_matches_buffered(tmp_path, n_frames, rate):
    src = tmp_path / f"clip_{n_frames}_{rate}.mp4"
    _write_video(src, np.random.RandomState(n_frames), n_frames)
    net = motion.make_motion_net("flowdiff")
    got = motion.extract_motion_features(src, clip_len=8, sample_rate=rate,
                                         net=net)
    want = _buffered_oracle(src, clip_len=8, sample_rate=rate, net=net)
    assert got.shape == want.shape == (-(-n_frames // rate), 1024)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got, jax_motion.extract_motion_features(
        src, clip_len=8, sample_rate=rate))
