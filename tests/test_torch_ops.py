"""edsnet_torch ops vs the edsnet_tpu functions they port, on the same
numpy-seeded inputs.  Every result is compared exactly."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.ops import anchors as jax_anchors
from edsnet_tpu.ops import bbox as jax_bbox
from edsnet_tpu.ops import knapsack as jax_knapsack
from edsnet_tpu.ops import summary as jax_summary
from edsnet_torch.kernels import knapsack as knapsack_kernel
from edsnet_torch.kernels import nms as nms_kernel
from edsnet_torch.ops import anchors, bbox, knapsack, summary
from tests.knapsack_cases import CASES as KNAPSACK_CASES
from tests.nms_cases import CASES, THRESHOLDS


def test_get_anchors():
    got = anchors.get_anchors(37, [4, 8, 16, 32])
    want = np.asarray(jax_anchors.get_anchors(37, [4, 8, 16, 32]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert anchors.anchor_scales_list(12) == [12]


def test_iou_lr():
    rng = np.random.RandomState(0)
    a = np.round(rng.uniform(-5, 40, (64, 2)), 1).astype(np.float32)
    b = np.round(rng.uniform(-5, 40, (64, 2)), 1).astype(np.float32)
    b[:8] = a[:8]                      # identical boxes
    b[8:16, 1] = b[8:16, 0]            # zero-width boxes
    got = bbox.iou_lr(torch.from_numpy(a)[:, None],
                      torch.from_numpy(b)[None])
    want = np.asarray(jax_bbox.iou_lr(a[:, None], b[None]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_masked_ties_and_invalid_boxes(seed):
    rng = np.random.RandomState(seed)
    b, n = 3, 96
    # coarse scores force many exact ties; rounded boxes overlap often
    scores = (rng.randint(0, 6, (b, n)) / 5.0).astype(np.float32)
    left = np.round(rng.uniform(0, 40, (b, n)))
    width = np.round(rng.uniform(-3, 12, (b, n)))   # width <= 0: dropped
    boxes = np.stack([left, left + width], -1).astype(np.float32)
    valid = rng.rand(b, n) > 0.15
    got = bbox.nms_masked(torch.from_numpy(scores), torch.from_numpy(boxes),
                          0.5, torch.from_numpy(valid))
    want = np.stack([np.asarray(jax_bbox.nms_masked(scores[i], boxes[i], 0.5,
                                                    valid[i]))
                     for i in range(b)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_plain_twin_matches_jax(case, thresh):
    scores, boxes, valid = CASES[case]()
    got = bbox.nms_masked_plain(scores, boxes, thresh, valid)
    want = np.stack([np.asarray(jax_bbox.nms_masked(
        scores[i].numpy(), boxes[i].numpy(), thresh, valid[i].numpy()))
        for i in range(scores.shape[0])])
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_masked_on_cpu_takes_the_twin():
    scores, boxes, valid = CASES["attention-300-b4"]()
    before = nms_kernel.nms_sweep.launches
    got = bbox.nms_masked(scores, boxes, 0.5, valid)
    assert nms_kernel.nms_sweep.launches == before
    want = bbox.nms_masked_plain(scores, boxes, 0.5, valid)
    assert got.dtype == torch.bool and got.shape == scores.shape
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.any() and not want.all()
    with pytest.raises(ValueError, match="no kernel for cpu"):
        nms_kernel.nms_sweep(boxes, valid, torch.zeros_like(scores).long(),
                             0.5)


def test_knapsack_same_selected_set_fuzz():
    max_capacity, n, rows = 60, 12, 16
    solve = jax.jit(jax.vmap(partial(jax_knapsack.knapsack_jax,
                                     max_capacity=max_capacity)))
    for seed in range(6):
        rng = np.random.RandomState(seed)
        # small value range -> many tied optima, where only the shared
        # backtrack order makes the selected sets agree
        values = rng.randint(0, 5, (rows, n)).astype(np.int32)
        weights = rng.randint(0, 25, (rows, n)).astype(np.int32)
        capacity = rng.randint(0, max_capacity + 1, rows).astype(np.int32)
        got = knapsack.knapsack(torch.from_numpy(values),
                                torch.from_numpy(weights),
                                torch.from_numpy(capacity), max_capacity)
        want = np.asarray(solve(values, weights, capacity))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{seed}")


@pytest.mark.parametrize("case", sorted(KNAPSACK_CASES))
def test_knapsack_cases_same_selected_set(case):
    """The shared cases (the cells' shapes, the kernel's global-memory
    paths, the edge cases) through ``knapsack`` on the CPU, which takes
    the plain twin, against ``knapsack_jax`` row by row."""
    values, weights, capacity, max_capacity = KNAPSACK_CASES[case]()
    got = knapsack.knapsack(values, weights, capacity, max_capacity)
    solve = jax.jit(jax.vmap(partial(jax_knapsack.knapsack_jax,
                                     max_capacity=max_capacity)))
    want = np.asarray(solve(values.numpy().astype(np.int32),
                            weights.numpy().astype(np.int32),
                            capacity.numpy().astype(np.int32)))
    assert got.dtype == torch.bool and got.shape == values.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert ((weights * got).sum(dim=1) <= capacity).all()


def test_knapsack_on_cpu_takes_the_twin():
    values, weights, capacity, max_capacity = KNAPSACK_CASES["mixed-b8"]()
    before = knapsack_kernel.knapsack_dp.launches
    got = knapsack.knapsack(values, weights, capacity, max_capacity)
    assert knapsack_kernel.knapsack_dp.launches == before
    want = knapsack.knapsack_plain(values, weights, capacity, max_capacity)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError, match="no kernel for cpu"):
        knapsack_kernel.knapsack_dp(values.int(), weights.int(),
                                    capacity.int(), max_capacity)


def _summ_inputs(rng, uniform):
    b, n_seq, rate, s_max, fr_max = 3, 48, 15, 16, 1024
    lens = np.asarray([48, 40, 31])
    pred = rng.rand(b, n_seq).astype(np.float32)
    picks = np.zeros((b, n_seq), np.int32)
    cps = np.zeros((b, s_max, 2), np.int32)
    nfps = np.zeros((b, s_max), np.int32)
    seg_valid = np.zeros((b, s_max), bool)
    n_frames = np.zeros(b, np.int32)
    for j, n in enumerate(lens):
        nf = n * rate - (j * 4 if uniform else 0)
        if uniform:
            picks[j, :n] = np.arange(n) * rate
        else:   # irregular picks that start after frame 0
            picks[j, :n] = np.sort(rng.choice(np.arange(3, nf), n, False))
        picks[j, n:] = nf + 1
        bounds = np.unique(np.concatenate(
            [[0], np.sort(rng.choice(np.arange(1, nf), 11, False)), [nf]]))
        ns = len(bounds) - 1
        cps[j, :ns] = np.stack([bounds[:-1], bounds[1:] - 1], 1)
        nfps[j, :ns] = bounds[1:] - bounds[:-1]
        seg_valid[j, :ns] = True
        n_frames[j] = nf
    return (pred, picks, cps, nfps, seg_valid, n_frames), fr_max


@pytest.mark.parametrize("uniform", [True, False])
def test_keyshot_summ(uniform):
    rng = np.random.RandomState(7)
    args, fr_max = _summ_inputs(rng, uniform)
    rate = 15 if uniform else 0
    got = summary.keyshot_summ(*(torch.from_numpy(a) for a in args),
                               max_frames=fr_max, uniform_sample_rate=rate)
    fn = jax.vmap(partial(jax_summary.keyshot_summ_jax, max_frames=fr_max,
                          uniform_sample_rate=rate))
    want = np.asarray(fn(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_f1_score():
    rng = np.random.RandomState(5)
    pred = rng.rand(4, 6, 300) > 0.7
    test = rng.rand(4, 6, 300) > 0.8
    pred[0, 0] = False                 # empty prediction -> F 0
    test[1, 1] = ~pred[1, 1]           # no overlap -> F 0
    got = summary.f1_score(torch.from_numpy(pred), torch.from_numpy(test))
    want = np.asarray(jax_summary.f1_score_jax(pred, test))
    np.testing.assert_array_equal(got.numpy(), want)
