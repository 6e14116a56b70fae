"""edsnet_torch lstm, bilstm and gcn backbones vs edsnet_tpu, on the CPU:
the whole masked output (padded positions and an all-padding row
included: zeros for the LSTMs, ``bias`` for the gcn) to 1e-5, the gcn's
top-similarity selection bit for bit against JAX's radix select on the
same sim (planted ties, +-0.0, k = 0, an all-padding row, float32 and
bfloat16), the in-length reversal of the backward direction, the LSTM
weight bridge both ways, and the flax initializers of the new leaves.
Module, DSNet, step, F, checkpoint and full-width bridge checks of the
three run in the other backbone tests, which list them too."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.models import gcn as jax_gcn
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.models.common import init_weights
from edsnet_torch.models.gcn import top_similarity_keep
from edsnet_torch.models.lstm import BiLSTMExtractor, reverse_within
from edsnet_torch.models.model_zoo import get_model
from tests.test_torch_backbones import FEAT, _inputs, _kwargs, _pair

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("base", ["lstm", "bilstm", "gcn"])
def test_whole_masked_output_matches_jax(base):
    """Every position of a masked batch, padding included: B 3 with a full
    row, a row of 37 and a row of length 0."""
    lens = [48, 37, 0]
    x, mask = _inputs(3, 48, FEAT, lens, seed=21)
    jmodel, variables, model = _pair(base, "paper", x, mask)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                   jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **TOL)
    if base == "gcn":
        bias = model.bias.detach().numpy()
        np.testing.assert_array_equal(got[2], np.broadcast_to(bias, (48, FEAT)))
        np.testing.assert_array_equal(got[1, 37:], np.broadcast_to(
            bias, (11, FEAT)))
    else:
        assert not got[2].any() and not got[1, 37:].any()


def _jax_keep(sim, lengths, keep_ratio=0.3):
    """edsnet_tpu/models/gcn.py:79-88 on a given sim."""
    b, n, _ = sim.shape
    flat = sim.reshape(b, n * n)
    k = (keep_ratio * (lengths.astype(jnp.float32) ** 2)).astype(jnp.int32)
    kth, mono = jax_gcn._kth_largest_bits(flat, k)
    above = mono > kth[:, None]
    ties = mono == kth[:, None]
    slots = k - jnp.sum(above, axis=-1)
    tie_rank = jnp.cumsum(ties.astype(jnp.int32), axis=-1)
    return (above | (ties & (tie_rank <= slots[:, None]))).reshape(b, n, n)


def _planted_sim(n, lens, seed):
    """sim [B, n, n] with -inf outside each video's valid square, values on
    a coarse grid (many ties), and runs of +0.0 and -0.0."""
    rng = np.random.RandomState(seed)
    sim = rng.randint(-3, 2, size=(len(lens), n, n)).astype(np.float32) / 4
    zeros = rng.rand(*sim.shape) < 0.3
    sign = np.where(rng.rand(*sim.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    sim = np.where(zeros, np.float32(0.0) * sign, sim)
    valid = np.arange(n)[None, :] < np.asarray(lens)[:, None]
    return np.where(valid[:, :, None] & valid[:, None, :], sim, -np.inf
                    ).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_selection_matches_jax_bit_for_bit(dtype):
    # 16: k = 76 of 256; 11: k = 36; 1: k = int(0.3) = 0; 0: all padding
    lens = np.array([16, 11, 1, 0])
    sim = _planted_sim(16, lens, seed=3)
    assert (np.signbit(sim) & (sim == 0)).any() and (sim == 0).any()
    jsim = jnp.asarray(sim, dtype)
    tsim = torch.from_numpy(sim).to(getattr(torch, dtype))
    want = np.asarray(_jax_keep(jsim, jnp.asarray(lens)))
    got = top_similarity_keep(tsim, torch.from_numpy(lens), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.reshape(4, -1).sum(-1).tolist() == [76, 36, 0, 0]
    # ranking the float values instead puts -0.0 and +0.0 level, and the
    # planted case then keeps another set
    flat = tsim.to(torch.float32).reshape(4, -1)
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices
    ranked = torch.arange(256)[None, :] < torch.tensor([76, 36, 0, 0])[:, None]
    by_value = torch.zeros_like(ranked).scatter_(1, order, ranked)
    assert not np.array_equal(by_value.reshape(4, 16, 16).numpy(), want)


def test_reverse_within_length():
    x = torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5, 1)
    lens = torch.tensor([3, 0])
    got = reverse_within(x, lens)
    assert got[0, :, 0].tolist() == [2.0, 1.0, 0.0, 3.0, 4.0]
    assert torch.equal(got[1], x[1])
    assert torch.equal(reverse_within(got, lens), x)


def test_bilstm_odd_feature_raises():
    with pytest.raises(ValueError, match="even num_feature"):
        BiLSTMExtractor(33)


def test_lstm_bridge_both_ways():
    """flax per-gate leaves <-> the stacked nn.LSTM leaves, gate order i, f,
    g, o; bias_ih_l0 zero and frozen; gradients without it map back."""
    x, mask = _inputs(1, 8, FEAT, [8], seed=4)
    _, variables, model = _pair("bilstm", "paper", x, mask)
    h = FEAT // 2
    for i, cell in enumerate((model.OptimizedLSTMCell_0,
                              model.OptimizedLSTMCell_1)):
        flax_cell = variables["params"][f"OptimizedLSTMCell_{i}"]
        for g, gate in enumerate("ifgo"):
            rows = slice(g * h, (g + 1) * h)
            np.testing.assert_array_equal(
                cell.weight_ih_l0[rows].detach().numpy(),
                np.asarray(flax_cell[f"i{gate}"]["kernel"]).T)
            np.testing.assert_array_equal(
                cell.weight_hh_l0[rows].detach().numpy(),
                np.asarray(flax_cell[f"h{gate}"]["kernel"]).T)
            np.testing.assert_array_equal(
                cell.bias_hh_l0[rows].detach().numpy(),
                np.asarray(flax_cell[f"h{gate}"]["bias"]))
        assert not cell.bias_ih_l0.requires_grad
        assert not cell.bias_ih_l0.detach().any()
    back = state_dict_to_flax(model.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(variables["params"]))
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert len(trainable) == 6
    grads = state_dict_to_flax(trainable)
    assert sorted(grads["OptimizedLSTMCell_1"]) == sorted(
        ["hf", "hg", "hi", "ho", "if", "ig", "ii", "io"])
    assert flax_to_state_dict(variables).keys() == model.state_dict().keys()


def test_init_weights_rnn_and_gcn_leaves():
    """The LSTM cells draw flax's OptimizedLSTMCell initializers (lecun
    normal truncated at 2 stddev, orthogonal per gate, zero biases), not
    XAVIER2; the gcn's ``bias`` is 0.1."""
    def init(base, seed):
        model = get_model("anchor-based", **_kwargs(base, "paper"))
        init_weights(model, torch.Generator().manual_seed(seed))
        return model.base_model.requires_grad_(False)

    std = math.sqrt(1.0 / FEAT) / .87962566103423978
    for base, h in (("lstm", FEAT), ("bilstm", FEAT // 2)):
        cells = [c for c in init(base, 0).children()]
        assert len(cells) == (1 if base == "lstm" else 2)
        for cell in cells:
            w = cell.weight_ih_l0
            assert w.shape == (4 * h, FEAT)
            assert float(w.abs().max()) <= 2 * std
            assert 0.7 * std < float(w.std()) < 1.0 * std   # truncation
            for g in range(4):
                block = cell.weight_hh_l0[g * h:(g + 1) * h]
                np.testing.assert_allclose((block @ block.T).numpy(),
                                           np.eye(h), atol=1e-5)
            assert not cell.bias_ih_l0.any() and not cell.bias_hh_l0.any()
        again = [c for c in init(base, 0).children()]
        other = [c for c in init(base, 1).children()]
        assert torch.equal(cells[0].weight_hh_l0, again[0].weight_hh_l0)
        assert not torch.equal(cells[0].weight_hh_l0, other[0].weight_hh_l0)
    if len(cells) == 2:
        assert not torch.equal(cells[0].weight_ih_l0, cells[1].weight_ih_l0)

    gcn = init("gcn", 0)
    assert torch.equal(gcn.bias, torch.full((FEAT,), 0.1))
    limit = math.sqrt(2.0) * math.sqrt(6.0 / (2 * FEAT))
    assert 0.9 * limit < float(gcn.lin.weight.abs().max()) <= limit
