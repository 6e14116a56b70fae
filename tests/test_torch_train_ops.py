"""edsnet_torch training-label ops, losses, batching and negative sampling
vs the edsnet_tpu functions they port, on the same numpy-seeded inputs.
Labels, summaries, knapsack sets and batches are compared exactly; losses
to 1e-6 (f32, the same formula)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.data import batching as jax_batching
from edsnet_tpu.data.dataset import VideoRecord as JaxRecord
from edsnet_tpu.ops import anchors as jax_anchors
from edsnet_tpu.ops import bbox as jax_bbox
from edsnet_tpu.ops import knapsack as jax_knapsack
from edsnet_tpu.ops import losses as jax_losses
from edsnet_tpu.ops import summary as jax_summary
from edsnet_tpu.parallel import steps as jax_steps
from edsnet_torch.data import batching
from edsnet_torch.data.dataset import VideoRecord
from edsnet_torch.ops import anchors, bbox, knapsack, losses, summary
from edsnet_torch.parallel import steps

LOSS_TOL = dict(rtol=1e-6, atol=1e-6)


def test_offsets_round_trip_and_match_jax():
    rng = np.random.RandomState(0)
    anc = np.stack([rng.randint(0, 50, 40), rng.choice([4, 8, 16], 40)],
                   -1).astype(np.int32)
    boxes = np.stack([rng.uniform(0, 50, 40), rng.uniform(1, 30, 40)],
                     -1).astype(np.float32)
    off = anchors.bbox2offset(torch.from_numpy(boxes), torch.from_numpy(anc))
    np.testing.assert_allclose(off.numpy(), np.asarray(
        jax_anchors.bbox2offset(boxes, anc)), rtol=1e-6, atol=1e-6)
    back = anchors.offset2bbox(off, torch.from_numpy(anc))
    np.testing.assert_allclose(back.numpy(), np.asarray(
        jax_anchors.offset2bbox(np.asarray(off), anc)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(back.numpy(), boxes, rtol=1e-5, atol=1e-4)


def test_lr_cw_conversions_match_jax():
    rng = np.random.RandomState(1)
    lr = np.sort(rng.uniform(-5, 60, (33, 2)), axis=1).astype(np.float32)
    cw = bbox.lr2cw(torch.from_numpy(lr))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jax_bbox.lr2cw(lr)))
    np.testing.assert_array_equal(bbox.cw2lr(cw).numpy(),
                                  np.asarray(jax_bbox.cw2lr(np.asarray(cw))))


@pytest.mark.parametrize("seq", [
    [], [0, 0, 0], [1], [1, 1, 0, 1], [0, 1, 1, 1, 0, 0, 1, 1],
    "fuzz0", "fuzz1", "fuzz2"])
def test_seq2bbox_matches_jax(seq):
    if isinstance(seq, str):
        seq = np.random.RandomState(int(seq[-1])).rand(97) > 0.6
    got = bbox.seq2bbox(seq)
    want = jax_bbox.seq2bbox(seq)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_pos_labels_match_jax(seed):
    rng = np.random.RandomState(seed)
    n, scales = 45, [4, 8, 16]
    t = rng.randint(0, 6)
    targets = np.zeros((8, 2), np.float32)
    targets[:, 1] = 1.0
    targets[:t, 0] = rng.uniform(0, n, t)
    targets[:t, 1] = rng.randint(1, 12, t)
    valid = np.arange(8) < t
    anc = anchors.get_anchors_np(n, scales)
    np.testing.assert_array_equal(anc, jax_anchors.get_anchors_np(n, scales))
    for thresh in (0.0, 0.3, 0.6):
        got = anchors.get_pos_label_np(anc, targets, thresh, valid)
        want = jax_anchors.get_pos_label_np(anc, targets, thresh, valid)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    # no targets at all
    got = anchors.get_pos_label_np(anc, np.zeros((0, 2)), 0.5)
    want = jax_anchors.get_pos_label_np(anc, np.zeros((0, 2)), 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pos_label_overlapping_targets_take_the_last():
    """An anchor positive to two targets takes the offset to the later one
    (the reference's loop order), as the jnp version does."""
    anc = anchors.get_anchors_np(12, [8])
    targets = np.asarray([[5.0, 8.0], [6.0, 8.0]], np.float32)
    cls, loc = anchors.get_pos_label_np(anc, targets, 0.5)
    want_cls, want_loc = jax_anchors.get_pos_label(anc, targets, 0.5)
    np.testing.assert_array_equal(cls, np.asarray(want_cls))
    np.testing.assert_allclose(loc, np.asarray(want_loc), rtol=1e-6)
    assert loc[6, 0, 0] == 0.0 and cls[5, 0] == 1


@pytest.mark.parametrize("seed", range(4))
def test_host_knapsack_matches_jax_set(seed):
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 30)
    # few distinct values and weights: many tied optima
    values = rng.randint(0, 4, n) * 100
    weights = rng.randint(1, 6, n) * 15
    cap = int(rng.randint(0, weights.sum() + 1))
    got = knapsack.knapsack_host(values, weights, cap)
    assert got == jax_knapsack.knapsack(values, weights, cap, solver="dp")
    assert got == jax_knapsack.knapsack(values, weights, cap)


@pytest.mark.parametrize("values,weights,cap,want", [
    ([3, 4], [1, 1], 1, [1]), ([], [], 5, []), ([5, 5], [2, 2], 0, []),
    ([0, 7], [1, 9], 8, [])])
def test_host_knapsack_edges(values, weights, cap, want):
    assert knapsack.knapsack_host(values, weights, cap) == want
    assert jax_knapsack.knapsack(values, weights, cap, solver="dp") == want


def _record(rng, n_seq, key="d/tvsum_0", uniform=True, nan=False,
            gtscore=None, feat=16):
    n_frames = n_seq * 15
    bounds = np.unique(np.concatenate(
        [[0], np.sort(rng.choice(np.arange(10, n_frames - 10), 11,
                                 replace=False)), [n_frames]]))
    if uniform:
        picks = np.arange(n_seq, dtype=np.int32) * 15
    else:
        picks = np.sort(rng.choice(np.arange(2, n_frames), n_seq,
                                   replace=False)).astype(np.int32)
    gt = rng.rand(n_seq).astype(np.float32) if gtscore is None else gtscore
    if nan:
        gt = gt.copy()
        gt[3] = np.nan
    return dict(key=key, seq=rng.randn(n_seq, feat).astype(np.float32),
                gtscore=gt, cps=np.stack([bounds[:-1], bounds[1:] - 1],
                                         1).astype(np.int32),
                n_frames=n_frames,
                nfps=(bounds[1:] - bounds[:-1]).astype(np.int32),
                picks=picks, user_summary=None)


@pytest.mark.parametrize("seed,uniform", [(0, True), (1, False), (2, True)])
def test_keyshot_summ_and_labels_match_jax(seed, uniform):
    rng = np.random.RandomState(seed)
    rec = _record(rng, 70 + 9 * seed, uniform=uniform)
    np.testing.assert_array_equal(
        summary.get_keyshot_summ(rec["gtscore"], rec["cps"],
                                 rec["n_frames"], rec["nfps"],
                                 rec["picks"]),
        jax_summary.get_keyshot_summ(rec["gtscore"], rec["cps"],
                                     rec["n_frames"], rec["nfps"],
                                     rec["picks"]))
    np.testing.assert_array_equal(
        batching.make_target(VideoRecord(**rec)),
        jax_batching.make_target(JaxRecord(**rec)))
    got = batching.prepare_ab_item(VideoRecord(**rec), [4, 8, 16], 0.6, 0.0,
                                   0.3, bucket_size=32)
    want = jax_batching.prepare_ab_item(JaxRecord(**rec), [4, 8, 16], 0.6,
                                        0.0, 0.3, bucket_size=32)
    assert got.num_pos == want.num_pos > 0 and got.key == want.key
    for name in ("seq", "target", "cls_pos", "loc_label", "neg_eligible",
                 "inc_eligible"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_skipped_videos_and_nan():
    rng = np.random.RandomState(5)
    nan_rec = _record(rng, 40, nan=True)
    with pytest.raises(ValueError, match="NaN"):
        summary.get_keyshot_summ(nan_rec["gtscore"], nan_rec["cps"],
                                 nan_rec["n_frames"], nan_rec["nfps"],
                                 nan_rec["picks"])
    empty_rec = _record(rng, 40, gtscore=np.zeros(40, np.float32))
    for rec in (nan_rec, empty_rec):
        assert batching.make_target(VideoRecord(**rec)) is None
        assert jax_batching.make_target(JaxRecord(**rec)) is None
    good = _record(rng, 40)
    items = batching.prepare_items(
        [VideoRecord(**r) for r in (nan_rec, good, empty_rec)],
        "anchor-based", anchor_scales=[4, 8])
    assert [it.key for it in items] == [good["key"]]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        batching.prepare_items([VideoRecord(**good)], "anchor-free")


def test_batches_and_pools_match_jax():
    rng = np.random.RandomState(7)
    recs = [_record(rng, n, key=f"d/v{i}")
            for i, n in enumerate([40, 70, 45, 90, 60])]
    kwargs = dict(anchor_scales=[4, 8], pos_iou=0.6, neg_iou=0.0,
                  inc_iou=0.3, bucket_size=32)
    items = [batching.prepare_ab_item(VideoRecord(**r), **kwargs)
             for r in recs]
    jitems = [jax_batching.prepare_ab_item(JaxRecord(**r), **kwargs)
              for r in recs]
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
            assert sorted(got) == sorted(k for k in want)
            for key in got:
                if key == "keys":
                    assert got[key] == want[key]
                else:
                    assert got[key].dtype == want[key].dtype, key
                    np.testing.assert_array_equal(got[key], want[key],
                                                  err_msg=key)


@pytest.mark.parametrize("seed", range(3))
def test_losses_match_jax(seed):
    rng = np.random.RandomState(seed)
    b, n, s = 3, 40, 4
    pred_cls = rng.uniform(0, 1, (b, n, s)).astype(np.float32)
    pred_cls[0, :2] = [0.0, 1.0, 1e-12, 1 - 1e-9]   # the eps guards
    pred_loc = rng.randn(b, n, s, 2).astype(np.float32) * 2
    test_loc = rng.randn(b, n, s, 2).astype(np.float32) * 2
    label = rng.choice([-1, 0, 1], (b, n, s)).astype(np.int32)
    label[2] = 0                          # no positives and no negatives
    got_loc = losses.ab_loc_loss(torch.from_numpy(pred_loc),
                                 torch.from_numpy(test_loc),
                                 torch.from_numpy(label))
    got_cls = losses.ab_cls_loss(torch.from_numpy(pred_cls),
                                 torch.from_numpy(label))
    want_loc = jax.vmap(jax_losses.ab_loc_loss)(pred_loc, test_loc, label)
    want_cls = jax.vmap(jax_losses.ab_cls_loss)(pred_cls, label)
    np.testing.assert_allclose(got_loc.numpy(), np.asarray(want_loc),
                               **LOSS_TOL)
    np.testing.assert_allclose(got_cls.numpy(), np.asarray(want_cls),
                               **LOSS_TOL)
    l1 = losses.ab_loc_loss(torch.from_numpy(pred_loc),
                            torch.from_numpy(test_loc),
                            torch.from_numpy(label), use_smooth=False)
    np.testing.assert_allclose(
        l1.numpy(), np.asarray(jax.vmap(
            lambda p, t, c: jax_losses.ab_loc_loss(p, t, c, False))(
                pred_loc, test_loc, label)), **LOSS_TOL)


@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_sample_marks_match_jax_draws(n):
    rng = np.random.RandomState(n)
    for trial in range(3):
        eligible = rng.rand(n) < rng.uniform(0.05, 0.95)
        n_eligible = int(eligible.sum())
        for num in sorted({0, 1, n_eligible // 2, n_eligible,
                           n_eligible + 5}):
            key = jax.random.PRNGKey(trial * 100 + num)
            u = np.array(jax.random.uniform(key, (n,)))
            want = np.asarray(jax_steps._sample_marks(
                jnp.asarray(eligible), jnp.int32(num), key))
            got = steps._sample_marks(
                torch.from_numpy(eligible)[None],
                torch.tensor([num], dtype=torch.int32),
                torch.from_numpy(u)[None])[0].numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"n={n} num={num}")
            assert got.sum() == min(num, n_eligible)


def test_sample_marks_ties_break_by_index_per_row():
    u = torch.tensor([[0.5, 0.25, 0.5, 0.125, 0.5, 0.5, 0.9, 0.5],
                      [0.5] * 8])
    eligible = torch.ones(2, 8, dtype=torch.bool)
    eligible[1, 0] = False
    got = steps._sample_marks(eligible, torch.tensor([4, 3]), u)
    assert got[0].tolist() == [True] * 4 + [False] * 4
    assert got[1].tolist() == [False, True, True, True] + [False] * 4


def test_build_ab_cls_labels_counts():
    rng = np.random.RandomState(3)
    b, n, s = 3, 50, 4
    cls_pos = (rng.rand(b, n, s) < 0.05).astype(np.int32)
    neg = (rng.rand(b, n, s) < 0.6) & (cls_pos == 0)
    inc = (rng.rand(b, n, s) < 0.5) & (cls_pos == 0) & ~neg
    batch = {"cls_pos": torch.from_numpy(cls_pos),
             "neg_eligible": torch.from_numpy(neg),
             "inc_eligible": torch.from_numpy(inc),
             "num_pos": torch.from_numpy(cls_pos.sum((1, 2)).astype(
                 np.int32))}
    gen = torch.Generator().manual_seed(0)
    label = steps.build_ab_cls_labels(batch, gen, 2.0, 1.0).numpy()
    for i in range(b):
        p = int(cls_pos[i].sum())
        assert (label[i] == 1).sum() == p
        assert ((label[i] == -1) & neg[i]).sum() == min(2 * p, neg[i].sum())
        assert ((label[i] == -1) & inc[i]).sum() == min(p, inc[i].sum())
    again = steps.build_ab_cls_labels(
        batch, torch.Generator().manual_seed(0), 2.0, 1.0).numpy()
    np.testing.assert_array_equal(label, again)
