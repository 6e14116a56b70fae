"""edsnet_torch's parallel slice against edsnet_tpu, on one process and on
a world of 2 gloo ranks.

The ranks run under ``torch.multiprocessing.spawn`` with a ``file://``
store in the test's tmp dir; one spawn runs every world-2 leg (the rank
functions are at module level, and JAX is imported inside test bodies
only, so a rank never imports it).  JAX runs in the test process on its 8
virtual CPU devices (tests/conftest.py).  The inputs and weights are made
from numpy / torch seeds and cross through convert.py.

Cases: the ring (P 2, three masks) against edsnet_tpu's ``ring_attention``
within 1e-5, and its in-process emulation; ``tp_shardings``' structure
and JAX's ValueError texts; the head-sharded AttentionExtractor and
full model at tp 2 (on the ranks and emulated) against JAX's replicated
forward within 1e-5; a deterministic anchor-based step at dp 2 against
JAX's step on a 2-device mesh within test_torch_train.py's 1e-5; 3
dropout steps at dp 2 against the port's world 1 (rtol 1e-4, atol 1e-5);
mesh-sharded evaluation equal to unsharded; the train CLI at world 2 equal
to world 1, its checkpoint through a world-1 evaluate; evaluate with
--context-parallel 2; --context-parallel off with its warning and at 1;
--resume under --tensor-parallel 2.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import io
import re
from pathlib import Path
from types import SimpleNamespace

import h5py
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import yaml
from torch import nn

from edsnet_torch import evaluate as port_evaluate
from edsnet_torch import train as port_train
from edsnet_torch import trainer as port_trainer
from edsnet_torch.convert import state_dict_to_variables
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.models import base as port_base
from edsnet_torch.models.attention import AttentionExtractor
from edsnet_torch.models.common import (Dropout, init_weights,
                                        set_dropout_generator,
                                        shard_dropout_rows)
from edsnet_torch.models.model_zoo import get_model
from edsnet_torch.parallel import ring_attention as port_ring
from edsnet_torch.parallel.eval_device import (evaluate_on_device,
                                               prepare_eval_batches)
from edsnet_torch.parallel.mesh import (Mesh, make_dp_tp_mesh, make_mesh,
                                        make_ring_mesh, shard_rows)
from edsnet_torch.parallel.steps import (ab_train_step, data_rows,
                                         make_optimizer)
from edsnet_torch.parallel.tensor_parallel import (emulate_tp,
                                                   shard_params_tp,
                                                   tp_shardings)

TOL = dict(rtol=1e-5, atol=1e-5)
DROPOUT_TOL = dict(rtol=1e-4, atol=1e-5)   # JAX's dp x tp vs dp
LR, WD = 5e-5, 1e-5
RING_SHAPE = (2, 4, 64, 16)                # B, H, N, D
RING_MASKS = ("none", "lengths", "empty row")
TP_FEAT, TP_HEADS = 16, 2
STEP_SMALL = dict(base_model="attention", num_feature=32, num_hidden=8,
                  anchor_scales=[4, 8], num_head=2, fc_depth=1,
                  pooling_type="roi")
MOCK_FEAT = 32
CLI = ["anchor-based", "--device", "cpu", "--base-model", "attention",
       "--num-feature", str(MOCK_FEAT), "--num-hidden", "8",
       "--fc-depth", "1", "--num-head", "2", "--bucket-size", "64",
       "--batch-size", "2", "--anchor-scales", "8"]


# ---------------------------------------------------------------------------
# inputs, shared with test_torch_parallel_world4.py


def ring_inputs(masks: str):
    """q, k, v [B, H, N, D] and the key mask [B, N] of one mask case."""
    b, h, n, d = RING_SHAPE
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(b, h, n, d).astype(np.float32))
               for _ in range(3))
    if masks == "none":
        mask = torch.ones(b, n, dtype=torch.bool)
    else:
        mask = torch.arange(n)[None, :] < torch.tensor([50, 33])[:, None]
        if masks == "empty row":
            mask[1] = False
    return q, k, v, mask


@functools.lru_cache(maxsize=None)
def _jax_ring_fn(p: int):
    import jax

    from edsnet_tpu.parallel import make_mesh as jax_make_mesh
    from edsnet_tpu.parallel.ring_attention import ring_attention

    return jax.jit(functools.partial(ring_attention, mesh=jax_make_mesh(p)))


def jax_ring(q, k, v, mask, p: int) -> np.ndarray:
    """edsnet_tpu's ring_attention over a ('data',) mesh of ``p``
    devices (jitted once per ``p``)."""
    import jax.numpy as jnp

    return np.asarray(_jax_ring_fn(p)(
        *(jnp.asarray(t.numpy()) for t in (q, k, v, mask))))


def ring_rank(mesh: Mesh, q, k, v, mask, head_axis=None) -> torch.Tensor:
    """This rank's ring_attention call on its chunk of positions (and its
    heads of ``head_axis``), as the attention module makes it."""
    p = mesh.shape["seq"]
    n = q.shape[2] // p
    lo = mesh.axis_rank("seq") * n
    if head_axis is not None:
        hp = q.shape[1] // mesh.shape[head_axis]
        h0 = mesh.axis_rank(head_axis) * hp
        q, k, v = (t[:, h0:h0 + hp] for t in (q, k, v))
    return port_ring.ring_attention(
        q[:, :, lo:lo + n], k[:, :, lo:lo + n], v[:, :, lo:lo + n],
        mask[:, lo:lo + n], mesh=mesh, axis_name="seq",
        head_axis=head_axis)


def step_batch(lengths=(40, 52), pad_to: int = 2):
    """An anchor-based batch of mock videos (one bucket of 64 positions,
    rows padded to a multiple of ``pad_to``), from the port's batching."""
    from edsnet_torch.data import batching

    rng = np.random.RandomState(0)
    videos = [mock_record(rng, f"d/tvsum_{i}", n, STEP_SMALL["num_feature"])
              for i, n in enumerate(lengths)]
    items = batching.prepare_items(
        videos, "anchor-based", anchor_scales=STEP_SMALL["anchor_scales"],
        pos_iou=0.6, neg_iou=0.0, inc_iou=0.3, bucket_size=32)
    return next(batching.batch_items(items, len(lengths), 32, shuffle=False,
                                     pad_batch_to=pad_to))


def step_model() -> nn.Module:
    model = get_model("anchor-based", **STEP_SMALL)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def dp_step_inputs():
    """3 videos in 4 rows and labels drawn once from a seeded generator."""
    from edsnet_torch.parallel.steps import build_ab_cls_labels

    batch = step_batch((40, 52, 36), pad_to=4)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    labels = build_ab_cls_labels(tb, torch.Generator().manual_seed(3),
                                 2.0, 1.0)
    return batch, labels


def deterministic_dp_step(mesh):
    """One anchor-based step without dropout on the rank's rows, labels
    injected -> (metrics, gradients, updated parameters) as numpy."""
    batch, labels = dp_step_inputs()
    model = step_model()
    for module in model.modules():
        if isinstance(module, Dropout):
            module.p = 0.0
    optimizer = make_optimizer(model.parameters(), LR, WD)
    local = {k: shard_rows(torch.from_numpy(v), mesh)
             for k, v in batch.items() if isinstance(v, np.ndarray)}
    metrics = ab_train_step(
        model, optimizer, local, None, lambda_reg=1.0, neg_ratio=2.0,
        inc_ratio=1.0, cls_label=shard_rows(labels, mesh), mesh=mesh)
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.numpy().copy() for n, p in model.named_parameters()},
            {k: v.numpy().copy() for k, v in model.state_dict().items()})


def dropout_steps(mesh, tp: int = 0, steps: int = 3):
    """``steps`` anchor-based steps with dropout and drawn labels on the
    rank's rows (and heads, with ``tp``) -> (losses, parameter shapes, the
    full state_dict after the steps)."""
    batch = step_batch()
    model = step_model()
    layout = (shard_params_tp(model, mesh, STEP_SMALL["num_head"])
              if tp > 1 else None)
    rows = data_rows(mesh)
    if rows is not None:
        shard_dropout_rows(model, *rows)
    set_dropout_generator(model, torch.Generator().manual_seed(1))
    label = torch.Generator().manual_seed(2)
    optimizer = make_optimizer(model.parameters(), LR, WD)
    local = {k: shard_rows(torch.from_numpy(v), mesh)
             for k, v in batch.items() if isinstance(v, np.ndarray)}
    losses = [float(ab_train_step(model, optimizer, local, label,
                                  lambda_reg=1.0, neg_ratio=2.0,
                                  inc_ratio=1.0, mesh=mesh)["loss"])
              for _ in range(steps)]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    state = model.state_dict()
    if layout is not None:
        state = layout.gather_state(state)
    return losses, shapes, {k: v.clone() for k, v in state.items()}


def mock_record(rng, key, n_seq, feat, shots=10, users=3) -> VideoRecord:
    """The verify recipe's mock video: unit-norm features, equal shots."""
    n_frames = n_seq * 15
    feats = rng.randn(n_seq, feat).astype(np.float32)
    bounds = np.linspace(0, n_frames, shots + 1, dtype=np.int32)
    return VideoRecord(
        key=key, seq=feats / np.linalg.norm(feats, axis=-1, keepdims=True),
        gtscore=rng.rand(n_seq).astype(np.float32),
        cps=np.stack([bounds[:-1], bounds[1:] - 1], 1), n_frames=n_frames,
        nfps=(bounds[1:] - bounds[:-1]).astype(np.int32),
        picks=np.arange(n_seq, dtype=np.int32) * 15,
        user_summary=(rng.rand(users, n_frames) > 0.8).astype(np.float32))


def write_mock(root: Path) -> Path:
    """JAX's context-parallel mock (tests/parallel/test_context_parallel.py):
    3 videos of 56-64 positions, 12 shots, 2 to train and 1 to test."""
    rng = np.random.RandomState(0)
    with h5py.File(root / "mock_tvsum.h5", "w") as f:
        for i, n_seq in enumerate([56, 64, 60]):
            n_frames = n_seq * 15
            g = f.create_group(f"video_{i}")
            feats = rng.randn(n_seq, MOCK_FEAT).astype(np.float32)
            g["features"] = feats / np.linalg.norm(feats, -1, keepdims=True)
            g["gtscore"] = rng.rand(n_seq).astype(np.float32)
            b = np.linspace(0, n_frames, 13, dtype=np.int32)
            g["change_points"] = np.stack([b[:-1], b[1:] - 1], 1)
            g["n_frame_per_seg"] = b[1:] - b[:-1]
            g["n_frames"] = n_frames
            g["picks"] = np.arange(n_seq, dtype=np.int32) * 15
            g["user_summary"] = (rng.rand(2, n_frames) > 0.8).astype(
                np.float32)
    keys = [f"d/mock_tvsum.h5/video_{i}" for i in range(3)]
    split = root / "mock.yml"
    with open(split, "w") as f:
        yaml.dump([{"train_keys": keys[:2], "test_keys": keys[2:]}], f)
    return split


def cli_args(root: Path, name: str, *extra: str):
    return CLI + ["--splits", str(root / "mock.yml"), "--data-root",
                  str(root), "--model-dir", str(root / name), *extra]


def train_cli(root: Path, name: str, *extra: str) -> float:
    """The train CLI's best F (the yml rank 0 writes)."""
    with contextlib.redirect_stdout(io.StringIO()):
        port_train.main(cli_args(root, name, "--max-epoch", "2", *extra))
    if dist.is_initialized():
        dist.barrier()
    with open(root / name / "mock.yml") as f:
        return float(yaml.safe_load(f)["split0"])


def evaluate_cli(root: Path, name: str, *extra: str) -> float:
    """The evaluate CLI's printed F of the checkpoint under ``name``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_evaluate.main(cli_args(root, name, *extra))
    found = re.findall(r"F-score: ([0-9.]+)", out.getvalue())
    return float(found[-1]) if found else float("nan")


def spawn(fn, world: int, root: Path) -> list:
    """``fn(rank, world, root)`` on ``world`` gloo ranks -> each rank's
    saved result."""
    store = root / "store"
    mp.spawn(_rank_main, args=(fn, world, root, str(store)), nprocs=world,
             join=True)
    return [torch.load(root / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _rank_main(rank: int, fn, world: int, root: Path, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.save(fn(rank, world, root), root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def count_ring_calls(fn):
    """(fn's result, ring_attention calls during it)."""
    before = port_ring.ring_attention.calls
    out = fn()
    return out, port_ring.ring_attention.calls - before


# ---------------------------------------------------------------------------
# the world of 2


def tp_inputs():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 48, TP_FEAT).astype(np.float32))
    mask = torch.from_numpy(rng.rand(2, 48) < 0.9)
    attn = AttentionExtractor(TP_HEADS, TP_FEAT)
    init_weights(attn, torch.Generator().manual_seed(5))
    full = get_model("anchor-based", base_model="attention",
                     num_feature=TP_FEAT, num_hidden=8, anchor_scales=[4],
                     num_head=TP_HEADS, fc_depth=1, pooling_type="roi")
    init_weights(full, torch.Generator().manual_seed(6))
    x1 = torch.from_numpy(rng.randn(1, 32, TP_FEAT).astype(np.float32))
    mask1 = torch.from_numpy(rng.rand(1, 32) < 0.9)
    return attn.eval(), x, mask, full.eval(), x1, mask1


def eval_records():
    rng = np.random.RandomState(3)
    return [mock_record(rng, f"x/tvsum_{i}", n, TP_FEAT, users=4)
            for i, n in enumerate([20, 24, 28])]


def _world2(rank: int, world: int, root: Path) -> dict:
    out = {}
    mesh = make_ring_mesh(2)
    for masks in RING_MASKS:
        out[f"ring {masks}"] = ring_rank(mesh, *ring_inputs(masks))

    attn, x, mask, full, x1, mask1 = tp_inputs()
    tp_mesh = make_dp_tp_mesh(1, 2)
    out["tp specs"] = tp_shardings(full, tp_mesh, TP_HEADS)
    shard_params_tp(attn, tp_mesh, TP_HEADS)
    shard_params_tp(full, tp_mesh, TP_HEADS)
    out["tp Q shape"] = tuple(attn.Q.weight.shape)
    out["tp fc shape"] = tuple(attn.fc.weight.shape)
    with torch.no_grad():
        out["tp attention"] = attn(x, mask)
        out["tp full model"] = full(x1, mask1)

    dp = make_mesh(2)
    out["dp step"] = deterministic_dp_step(dp)
    out["dropout steps"] = dropout_steps(dp)

    model = get_model("anchor-based", base_model="attention",
                      num_feature=TP_FEAT, num_hidden=8, anchor_scales=[4, 8],
                      num_head=TP_HEADS, fc_depth=1, pooling_type="roi")
    init_weights(model, torch.Generator().manual_seed(7))
    model.eval()
    records = eval_records()
    prepared = prepare_eval_batches(records, 1, 32, "cpu", mesh=dp)
    per_video = []
    out["sharded eval"] = (
        evaluate_on_device(model, records, 0.5, prepared=prepared,
                           per_video=per_video),
        [p["fscore"] for p in per_video],
        [tuple(e["tb"]["seq"].shape) for e in prepared])

    out["cli w2"] = train_cli(root, "w2", "--pad-batch-to", "2")
    out["cli eval cp2"] = count_ring_calls(lambda: evaluate_cli(
        root, "w2", "--context-parallel", "2", "--cp-min-len", "64"))
    port_base.set_context_parallel(0)
    out["cli cp1"] = count_ring_calls(lambda: train_cli(
        root, "cp1", "--context-parallel", "1", "--cp-min-len", "64"))
    port_base.set_context_parallel(0)

    tp = ("--tensor-parallel", "2", "--num-devices", "2", "--resume",
          "--state-save-every", "1")
    seen = []
    real_step = port_trainer.ab_train_step

    def spy(model, *a, **kw):
        if not seen:
            seen.append({n: tuple(p.shape)
                         for n, p in model.named_parameters()})
        return real_step(model, *a, **kw)

    train_cli(root, "tp_resume", *tp)
    port_trainer.ab_train_step = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            port_train.main(cli_args(root, "tp_resume", "--max-epoch", "3",
                                     *tp))
    finally:
        port_trainer.ab_train_step = real_step
    with contextlib.redirect_stdout(io.StringIO()):
        port_train.main(cli_args(root, "tp_unbroken", "--max-epoch", "3",
                                 *tp))
    out["tp resume shapes"] = seen[0]
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = tmp_path_factory.mktemp("world2")
    write_mock(root)
    return root, spawn(_world2, 2, root)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _flax_leaves(arrays) -> dict:
    """A state_dict of numpy arrays as flax params leaves."""
    return dict(_leaves(state_dict_to_variables(
        {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}
    )["params"]))


@pytest.mark.parametrize("masks", RING_MASKS)
def test_ring_ranks_match_jax(world2, masks):
    want = jax_ring(*ring_inputs(masks), p=2)
    for rank in world2[1]:
        np.testing.assert_allclose(rank[f"ring {masks}"].numpy(), want,
                                   **TOL)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("masks", RING_MASKS)
def test_emulated_ring_matches_jax(p, masks):
    got = port_ring.emulate_ring(*ring_inputs(masks), p)
    np.testing.assert_allclose(got.numpy(),
                               jax_ring(*ring_inputs(masks), p=p), **TOL)


def test_tp_shardings_structure(world2):
    """Q / K / V weights split by rows (flax's column spec), fc by
    columns, rank-1 leaves and everything else replicated; each rank
    holds whole heads."""
    mesh = SimpleNamespace(shape={"model": 2})
    biased = nn.Module()
    biased.attn = nn.Module()
    for name in ("Q", "K", "V", "fc"):
        setattr(biased.attn, name, nn.Linear(8, 8))
    biased.head = nn.Linear(8, 3)
    specs = tp_shardings(biased, mesh, num_heads=2)
    assert specs == {"attn.Q.weight": 0, "attn.Q.bias": None,
                     "attn.K.weight": 0, "attn.K.bias": None,
                     "attn.V.weight": 0, "attn.V.bias": None,
                     "attn.fc.weight": 1, "attn.fc.bias": None,
                     "head.weight": None, "head.bias": None}
    full = world2[1][0]["tp specs"]
    assert {k: d for k, d in full.items() if d is not None} == {
        "base_model.Q.weight": 0, "base_model.K.weight": 0,
        "base_model.V.weight": 0, "base_model.fc.weight": 1}
    for rank in world2[1]:
        assert rank["tp Q shape"] == (TP_FEAT // 2, TP_FEAT)
        assert rank["tp fc shape"] == (TP_FEAT, TP_FEAT // 2)


def test_tp_rejects_split_heads():
    import jax
    import jax.numpy as jnp

    from edsnet_tpu.models.attention import AttentionExtractor as JaxAttn
    from edsnet_tpu.parallel.tensor_parallel import (make_model_mesh,
                                                     shard_params_tp as jsp)

    jmodel = JaxAttn(num_head=1, num_feature=8)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 16, 8)), jnp.ones((1, 16), bool))
    with pytest.raises(ValueError) as want:
        jsp(variables, make_model_mesh(2), num_heads=1)
    attn = AttentionExtractor(1, 8)
    with pytest.raises(ValueError) as got:
        tp_shardings(attn, SimpleNamespace(shape={"model": 2}), num_heads=1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="whole heads"):
        with emulate_tp(attn, 2):
            pass


def _numbers_out(msg: str) -> str:
    return re.sub(r"\d+", "N", msg)


def test_oversized_requests_raise_jax_texts():
    """make_mesh, make_ring_mesh, make_dp_tp_mesh and the trainer's
    --tensor-parallel check refuse what the world lacks with JAX's texts
    (JAX asked at 9 of its 8 devices, the port at 2 of its 1 rank)."""
    import jax

    from edsnet_tpu.parallel import mesh as jax_mesh
    from edsnet_tpu.parallel import tensor_parallel as jax_tp

    n = len(jax.devices())
    cases = [(lambda: make_mesh(2), lambda: jax_mesh.make_mesh(n + 1)),
             (lambda: make_ring_mesh(2, tp=1, num_devices=2),
              lambda: jax_mesh.make_ring_mesh(2, tp=1, num_devices=n + 1)),
             (lambda: make_ring_mesh(1),
              lambda: jax_mesh.make_ring_mesh(1)),
             (lambda: make_dp_tp_mesh(1, 2),
              lambda: jax_tp.make_dp_tp_mesh(n, 2))]
    for port_fn, jax_fn in cases:
        with pytest.raises(ValueError) as got:
            port_fn()
        with pytest.raises(ValueError) as want:
            jax_fn()
        assert _numbers_out(str(got.value)) == _numbers_out(str(want.value))
    args = port_evaluate.config_lib.get_arguments(
        ["anchor-based", "--device", "cpu", "--tensor-parallel", "2"])
    with pytest.raises(ValueError, match="--tensor-parallel 2 must divide "
                                         "the device count 1"):
        port_trainer.training_mesh(args)


def _jax_attention_forward(attn, x, mask):
    import jax.numpy as jnp

    from edsnet_tpu.models.attention import AttentionExtractor as JaxAttn

    jmodel = JaxAttn(num_head=TP_HEADS, num_feature=TP_FEAT)
    return np.asarray(jmodel.apply(
        state_dict_to_variables(attn.state_dict()),
        jnp.asarray(x.numpy()), jnp.asarray(mask.numpy())))


def _jax_model_forward(full, x, mask):
    import jax.numpy as jnp

    from edsnet_tpu.models.model_zoo import get_model as jax_get_model

    jmodel = jax_get_model(
        "anchor-based", model_depth="shallow", base_model="attention",
        num_feature=TP_FEAT, num_hidden=8, anchor_scales=(4,),
        num_head=TP_HEADS, fc_depth=1, attention_depth=2,
        encoder_type="classic", orientation="paper", pooling_type="roi")
    return [np.asarray(t) for t in jmodel.apply(
        state_dict_to_variables(full.state_dict()),
        jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()))]


def test_tp_attention_matches_jax(world2):
    attn, x, mask, *_ = tp_inputs()
    want = _jax_attention_forward(attn, x, mask)
    with torch.no_grad(), emulate_tp(attn, 2):
        emulated = attn(x, mask)
    np.testing.assert_allclose(emulated.numpy(), want, **TOL)
    for rank in world2[1]:
        np.testing.assert_allclose(rank["tp attention"].numpy(), want, **TOL)


def test_tp_full_model_matches_jax(world2):
    *_, full, x, mask = tp_inputs()
    want = _jax_model_forward(full, x, mask)
    with torch.no_grad(), emulate_tp(full, 2) as modules:
        emulated = full(x, mask)
    assert len(modules) == 1
    for got in [emulated] + [r["tp full model"] for r in world2[1]]:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_dp_step_matches_jax(world2):
    """One deterministic step at dp 2 (3 videos in 4 rows, 2 a rank)
    equals JAX's step on a 2-device mesh: losses, gradients, updated
    parameters."""
    import jax
    import jax.numpy as jnp
    import optax

    from edsnet_tpu.models.model_zoo import get_model as jax_get_model
    from edsnet_tpu.ops import losses as jax_losses
    from edsnet_tpu.parallel import make_mesh as jax_make_mesh
    from edsnet_tpu.parallel import shard_batch
    from edsnet_tpu.parallel import steps as jax_steps

    batch, labels = dp_step_inputs()
    jmodel = jax_get_model("anchor-based", model_depth="shallow",
                           attention_depth=2, encoder_type="classic",
                           orientation="paper", **STEP_SMALL)
    params = state_dict_to_variables(step_model().state_dict())["params"]
    keys = ("seq", "mask", "loc_label", "video_valid", "num_pos")
    dev = shard_batch({**{k: batch[k] for k in keys},
                       "cls_label": labels.numpy()}, jax_make_mesh(2))

    def loss_fn(p, b):   # steps.py:171-183 at deterministic=True
        pred_cls, pred_loc = jmodel.apply({"params": p}, b["seq"],
                                          b["mask"], deterministic=True)
        loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, b["loc_label"],
                                               b["cls_label"])
        cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, b["cls_label"])
        w = (b["video_valid"] & (b["num_pos"] > 0)).astype(jnp.float32)
        denom = jnp.maximum(w.sum(), 1.0)
        return jnp.sum((cls + loc) * w) / denom, (
            jnp.sum(cls * w) / denom, jnp.sum(loc * w) / denom)

    (loss, (cls_loss, loc_loss)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, dev)
    tx = jax_steps.make_optimizer(LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)
    for rank in world2[1]:
        metrics, got_grads, got_params = rank["dp step"]
        for name, want in (("loss", loss), ("cls_loss", cls_loss),
                           ("loc_loss", loc_loss)):
            np.testing.assert_allclose(metrics[name], float(want),
                                       err_msg=name, **TOL)
        for tree, got in ((grads, got_grads), (new_params, got_params)):
            want = dict(_leaves(tree))
            got = _flax_leaves(got)
            assert sorted(got) == sorted(want)
            for name in want:
                np.testing.assert_allclose(got[name], want[name],
                                           err_msg=name, **TOL)


def test_dropout_steps_dp2_match_world1(world2):
    """3 steps with dropout and drawn labels: dp 2 draws the global masks
    and labels and keeps its rows, so its losses and parameters are world
    1's."""
    losses, _, state = dropout_steps(None)
    for rank in world2[1]:
        got_losses, _, got_state = rank["dropout steps"]
        np.testing.assert_allclose(got_losses, losses, **DROPOUT_TOL)
        for k, v in state.items():
            np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                       err_msg=k, **DROPOUT_TOL)


def test_mesh_sharded_eval_matches_unsharded(world2):
    """Batch size 1 rounds up to the 2 data ranks, one row a rank; mean
    F, mean diversity and every video's F equal the unsharded run's."""
    model = get_model("anchor-based", base_model="attention",
                      num_feature=TP_FEAT, num_hidden=8, anchor_scales=[4, 8],
                      num_head=TP_HEADS, fc_depth=1, pooling_type="roi")
    init_weights(model, torch.Generator().manual_seed(7))
    model.eval()
    per_video = []
    want = evaluate_on_device(model, eval_records(), 0.5, batch_size=1,
                              bucket_size=32, per_video=per_video)
    for rank in world2[1]:
        (f, div), fs, shapes = rank["sharded eval"]
        assert abs(f - want[0]) < 1e-6 and abs(div - want[1]) < 1e-6
        np.testing.assert_allclose(fs, [p["fscore"] for p in per_video],
                                   atol=1e-6)
        assert shapes == [(1, 256, TP_FEAT)] * 2


def test_train_cli_world2_matches_world1(world2):
    """The same padded batches (--pad-batch-to 2) on 2 ranks and on one
    give the same best F, and the world-2 checkpoint gives it again
    through a world-1 evaluate."""
    root, ranks = world2
    assert ranks[0]["cli w2"] == ranks[1]["cli w2"]
    want = train_cli(root, "w1", "--pad-batch-to", "2")
    assert abs(ranks[0]["cli w2"] - want) <= 1e-6, (ranks[0]["cli w2"], want)
    assert abs(evaluate_cli(root, "w2") - want) <= 5e-5


def test_evaluate_cli_context_parallel_matches(world2):
    """evaluate --context-parallel 2 at world 2 runs the ring (mesh data
    1, seq 2) and reports world 1's F (JAX's tolerance)."""
    root, ranks = world2
    want = evaluate_cli(root, "w2")
    assert all(rank["cli eval cp2"][1] > 0 for rank in ranks), \
        "ring attention was never invoked"
    f = ranks[0]["cli eval cp2"][0]       # rank 0 prints
    assert f == pytest.approx(want, abs=2e-4), (f, want)


def test_train_cli_cp_too_few_devices_stays_off(tmp_path, caplog):
    """--context-parallel 2 on one process: JAX's warning, no ring."""
    write_mock(tmp_path)
    try:
        f, calls = count_ring_calls(lambda: train_cli(
            tmp_path, "cp_off", "--context-parallel", "2",
            "--cp-min-len", "64"))
    finally:
        port_base.set_context_parallel(0)
    assert np.isfinite(f)
    assert calls == 0
    assert ("--context-parallel 2: ring attention needs >=2 sequence-axis "
            "devices but only 1 device(s) are available; ring attention "
            "stays off") in caplog.text


def test_train_cli_cp1_is_noop(world2):
    for rank in world2[1]:
        f, calls = rank["cli cp1"]
        assert np.isfinite(f) and calls == 0


def test_tp_resume_keeps_head_slices(world2):
    """--resume under --tensor-parallel 2: the resumed step sees this
    rank's heads, the .state and the checkpoint hold the full tensors, the
    resumed run equals an unbroken one, and the checkpoint evaluates at
    world 1 to the F the run recorded."""
    root, ranks = world2
    q = "base_model.Q.weight"
    for rank in ranks:
        shapes = rank["tp resume shapes"]
        assert shapes[q] == (MOCK_FEAT // 2, MOCK_FEAT)
        assert shapes["base_model.fc.weight"] == (MOCK_FEAT, MOCK_FEAT // 2)
    ckpt = root / "tp_resume" / "checkpoint" / "mock.yml.0.pt"
    state = torch.load(str(ckpt) + ".state", weights_only=True)
    assert state["epoch"] == 3
    assert tuple(state["model"][q].shape) == (MOCK_FEAT, MOCK_FEAT)
    names = [n for n, _ in step_model().named_parameters()]
    moments = state["optimizer"]["state"][names.index(
        "base_model.fc.weight")]
    assert tuple(moments["exp_avg"].shape) == (MOCK_FEAT, MOCK_FEAT)
    assert tuple(torch.load(ckpt, weights_only=True)[q].shape) == (
        MOCK_FEAT, MOCK_FEAT)
    with open(root / "tp_resume" / "mock.yml") as f:
        resumed = yaml.safe_load(f)["split0"]
    with open(root / "tp_unbroken" / "mock.yml") as f:
        assert yaml.safe_load(f)["split0"] == resumed
    assert abs(evaluate_cli(root, "tp_resume") - resumed) <= 5e-5
