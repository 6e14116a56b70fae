"""The data maker: the published sizes, the folds, and the same work for
every seed."""
import numpy as np
import pytest
import torch

from portbench.lib import data
from portbench.lib.cell import load_cell

MIXES = ["train-tvsum", "eval-summe"]


def _traffic(mix):
    cells = {"train-tvsum": "ab-nystromformer.train-tvsum",
             "eval-summe": "ab-nystromformer.eval-summe"}
    return load_cell(cells[mix]).traffic


@pytest.mark.parametrize("mix", MIXES)
def test_published_lengths_and_folds(mix):
    traffic = _traffic(mix)
    small = dict(traffic)
    videos = data.make_videos(small, 2 ** 33 + 5, 8, torch.device("cpu"))
    lo, hi = traffic["positions"]
    ns = [len(v.seq) for v in videos]
    assert len(videos) == traffic["videos"]
    assert min(ns) == lo and max(ns) == hi
    for v in videos:
        assert v.n_frames == len(v.seq) * traffic["frames_per_position"]
        assert v.user_summary.shape == (traffic["users"], v.n_frames)
        assert (v.user_summary.sum(1) <= 0.15 * v.n_frames).all()
        lengths = v.nfps[:-1] / traffic["fps"]
        assert (lengths >= traffic["shot_seconds"][0]).all()
        assert (lengths <= traffic["shot_seconds"][1]).all()
        assert v.nfps.sum() == v.n_frames
        np.testing.assert_allclose(np.linalg.norm(v.seq, axis=1), 1,
                                   rtol=1e-5)
    folds = data.make_folds(traffic, videos, 7)
    assert len(folds) == traffic["folds"]
    tested = sorted(v.key for f in folds for v in f.test)
    assert tested == sorted(v.key for v in videos)
    for f in folds:
        assert len(f.test) == traffic["held_out"]
        assert len(f.train) == traffic["videos"] - traffic["held_out"]


@pytest.mark.parametrize("mix", MIXES)
def test_seed_changes_data_not_work(mix):
    traffic = _traffic(mix)
    a = data.make_videos(traffic, 1, 8, torch.device("cpu"))
    b = data.make_videos(traffic, 2, 8, torch.device("cpu"))
    a2 = data.make_videos(traffic, 1, 8, torch.device("cpu"))
    assert [len(v.seq) for v in a] == [len(v.seq) for v in b]
    assert not np.array_equal(a[0].seq, b[0].seq)
    for x, y in zip(a, a2):
        np.testing.assert_array_equal(x.seq, y.seq)
        np.testing.assert_array_equal(x.cps, y.cps)
    fa = data.make_folds(traffic, a, 1)
    fb = data.make_folds(traffic, b, 2)
    for x, y in zip(fa, fb):
        assert sorted(len(v.seq) for v in x.test) == \
            sorted(len(v.seq) for v in y.test)
