"""edsnet_torch's parallel slice on a world of 4 gloo ranks, against
edsnet_tpu and the port's world 1: the ring at P 4 (three masks) and the
2 x 2 (seq, model) composition against edsnet_tpu's ``ring_attention``
within 1e-5; 3 dropout steps at dp 2 x tp 2 against world 1 (JAX's rtol
1e-4, atol 1e-5; tests/test_torch_parallel.py holds dp 2 to world 1), the
parameters still head-sliced after them; the train CLI's ring on a ('data',
'seq') mesh of 2 x 2 and --context-parallel 8 --tensor-parallel 2 clamped
to a (data 1, seq 2, model 2) ring mesh, each with world 1's best F.  One
spawn runs every leg; the helpers are test_torch_parallel.py's."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from edsnet_torch.models import base as port_base
from edsnet_torch.parallel.mesh import make_dp_tp_mesh, make_ring_mesh
from tests.test_torch_parallel import (DROPOUT_TOL, RING_MASKS, TOL,
                                       count_ring_calls, dropout_steps,
                                       jax_ring, ring_inputs, ring_rank,
                                       spawn, train_cli, write_mock)

PAD = ("--pad-batch-to", "4")      # the same padded batches on any mesh


def _ring_cli(root: Path, name: str, *flags: str):
    """(best F, ring calls, the registered ring mesh's shape)."""
    try:
        f, calls = count_ring_calls(lambda: train_cli(
            root, name, "--cp-min-len", "64", *PAD, *flags))
        return f, calls, port_base.get_ring_mesh()[0].shape
    finally:
        port_base.set_context_parallel(0)


def _world4(rank: int, world: int, root: Path) -> dict:
    out = {}
    mesh = make_ring_mesh(4)
    for masks in RING_MASKS:
        out[f"ring {masks}"] = ring_rank(mesh, *ring_inputs(masks))
    out["ring seq x model"] = ring_rank(make_ring_mesh(2, tp=2),
                                       *ring_inputs("lengths"),
                                       head_axis="model")
    out["dropout steps"] = dropout_steps(make_dp_tp_mesh(2, 2), tp=2)
    out["cli cp2"] = _ring_cli(root, "cp2", "--context-parallel", "2")
    out["cli clamp"] = _ring_cli(root, "clamp", "--context-parallel", "8",
                                 "--tensor-parallel", "2")
    return out


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    root = tmp_path_factory.mktemp("world4")
    write_mock(root)
    return root, spawn(_world4, 4, root)


@pytest.mark.parametrize("masks", RING_MASKS)
def test_ring_p4_matches_jax(world4, masks):
    want = jax_ring(*ring_inputs(masks), p=4)
    for rank in world4[1]:
        np.testing.assert_allclose(rank[f"ring {masks}"].numpy(), want,
                                   **TOL)


def test_ring_composes_seq_and_model(world4):
    """Mesh (data 1, seq 2, model 2): each rank's ring runs its 2 of the
    4 heads over the seq pair and returns them whole."""
    want = jax_ring(*ring_inputs("lengths"), p=2)
    for rank, got in enumerate(r["ring seq x model"] for r in world4[1]):
        m = rank % 2
        np.testing.assert_allclose(got.numpy(), want[:, 2 * m:2 * m + 2],
                                   **TOL)


def test_dropout_steps_dp2_tp2_match_world1(world4):
    losses, _, state = dropout_steps(None)
    for rank in world4[1]:
        got_losses, shapes, got_state = rank["dropout steps"]
        np.testing.assert_allclose(got_losses, losses, **DROPOUT_TOL)
        assert shapes["base_model.Q.weight"] == (16, 32)
        assert shapes["base_model.fc.weight"] == (32, 16)
        for k, v in state.items():
            np.testing.assert_allclose(got_state[k].numpy(), v.numpy(),
                                       err_msg=k, **DROPOUT_TOL)


@pytest.mark.parametrize("leg,shape", [
    ("cli cp2", {"data": 2, "seq": 2}),
    ("cli clamp", {"data": 1, "seq": 2, "model": 2})])
def test_train_cli_ring_matches_world1(world4, leg, shape):
    """The validation's ring runs on the trainer's ring mesh, and the best
    F is world 1's on the same padded batches (JAX's tolerance)."""
    root, ranks = world4
    want = train_cli(root, f"w1 {leg}", *PAD)
    for rank in ranks:
        f, calls, got_shape = rank[leg]
        assert calls > 0, "ring attention never ran"
        assert got_shape == shape
        assert f == pytest.approx(want, abs=2e-4), (f, want)
    if leg == "cli clamp":
        log = (root / "clamp" / "log.txt").read_text()
        assert ("--context-parallel 8 clamped to 2 (4 device(s), 2 on the "
                "tensor axis)") in log
