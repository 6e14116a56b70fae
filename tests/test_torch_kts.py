"""edsnet_torch KTS, shot tables and the shot tools vs edsnet_tpu: the
float64 host path with the native DP and with its numpy twin, the float32
device path on the CPU (change points equal to JAX's device path and to
the host's, bucket-independent, the float64 fallback past the bound and
counted, the ncp and lmax clamps), ``segment_features``, the
``make_shots`` output file field by field, and ``kts_demo``'s lines."""
import h5py
import numpy as np
import pytest
import torch

from edsnet_tpu import kts_demo as jax_demo
from edsnet_tpu import make_shots as jax_make_shots
from edsnet_tpu.data import h5io as jax_h5io
from edsnet_tpu.ops import kts as jk
from edsnet_torch import kts_demo as port_demo
from edsnet_torch import make_shots as port_make_shots
from edsnet_torch.data import h5io as port_h5io
from edsnet_torch.ops import kts as pk

CPU = torch.device("cpu")


def _synthetic_kernel(seed=0, n=60, segs=3):
    rng = np.random.RandomState(seed)
    means = rng.randn(segs, 8) * 3
    X = np.concatenate([means[i] + 0.1 * rng.randn(n // segs, 8)
                        for i in range(segs)])
    return X @ X.T


def _normalised_video(rng, n, n_segments, width=16):
    """tests/ops/test_kts_dwt.py's videos: piecewise-constant unit features
    with noise."""
    bounds = np.sort(rng.choice(np.arange(10, n - 10), n_segments - 1,
                                replace=False))
    feats = np.concatenate([np.tile(rng.randn(1, width), (len(s), 1))
                            for s in np.split(np.arange(n), bounds)])
    feats += 0.05 * rng.randn(n, width)
    return feats / np.linalg.norm(feats, axis=-1, keepdims=True)


@pytest.fixture(params=["native", "numpy"])
def host_dp(request, monkeypatch):
    """The host DP through the native library, and through its numpy twin
    (both packages' libraries switched off)."""
    if request.param == "numpy":
        monkeypatch.setattr(pk, "_native_load", lambda: None)
        monkeypatch.setattr(jk, "_native_load", lambda: None)
    else:
        assert pk._native_load() is not None
    return request.param


def _f32_bound(K):
    """float32 rounding of the scatters' prefix sums: eps n^2 max|K|."""
    return np.finfo(np.float32).eps * K.shape[0] ** 2 * np.abs(K).max()


def test_calc_scatters_equals_jax():
    for seed in range(3):
        K = _synthetic_kernel(seed)
        f64 = pk.calc_scatters(K)
        np.testing.assert_array_equal(f64, jk.calc_scatters(K))
        K32 = K.astype(np.float32)
        got = pk.calc_scatters_device(torch.from_numpy(K32)).numpy()
        want = np.asarray(jk.calc_scatters_jax(K32))
        assert np.abs(got - f64).max() <= _f32_bound(K)
        assert np.abs(want - f64).max() <= _f32_bound(K)


@pytest.mark.parametrize("ncp,lmin,lmax", [(2, 1, 100000), (5, 1, 100000),
                                           (4, 5, 30)])
def test_cpd_nonlin_equals_jax(host_dp, ncp, lmin, lmax):
    K = _synthetic_kernel(seed=3)
    got_cps, got_scores = pk.cpd_nonlin(K, ncp, lmin=lmin, lmax=lmax)
    want_cps, want_scores = jk.cpd_nonlin(K, ncp, lmin=lmin, lmax=lmax)
    np.testing.assert_array_equal(got_cps, want_cps)
    np.testing.assert_array_equal(got_scores, want_scores)
    scatters = [None]
    pk.cpd_nonlin(K, ncp, lmin=lmin, lmax=lmax, backtrack=False,
                  out_scatters=scatters)
    np.testing.assert_array_equal(scatters[0], pk.calc_scatters(K))


@pytest.mark.parametrize("seed", [1, 2])
def test_cpd_auto_equals_jax(host_dp, seed):
    K = _synthetic_kernel(seed=seed)
    for ncp, vmax in ((K.shape[0] - 1, 1), (10, 0.5)):
        got_cps, got_scores = pk.cpd_auto(K, ncp, vmax)
        want_cps, want_scores = jk.cpd_auto(K, ncp, vmax)
        np.testing.assert_array_equal(got_cps, want_cps)
        np.testing.assert_array_equal(got_scores, want_scores)
        assert len(got_cps) >= 2


def test_native_and_numpy_dp_agree():
    J = pk.calc_scatters(_synthetic_kernel(seed=4, n=45))
    for m, lmin, lmax in ((44, 1, 46), (10, 2, 20)):
        got = pk._native_load().kts_dp(J, m, lmin, lmax, True)
        want = pk._kts_dp_numpy(J, m, lmin, lmax, True)
        np.testing.assert_array_equal(got[0], want[0])
        for k in range(1, m + 1):    # the columns the native DP writes
            np.testing.assert_array_equal(got[1][k][(k + 1) * lmin:],
                                          want[1][k][(k + 1) * lmin:])


@pytest.mark.parametrize("n,n_segments", [(200, 7), (437, 12)])
def test_cpd_auto_device_equals_jax_and_host(n, n_segments):
    rng = np.random.RandomState(42)
    if n == 437:      # the second video of tests/ops/test_kts_dwt.py
        _normalised_video(rng, 200, 7)
    K = (lambda f: f @ f.T)(_normalised_video(rng, n, n_segments))
    before = (pk.cpd_auto_device.device_calls, pk.cpd_auto_device.fallbacks)
    got_cps, got_scores = pk.cpd_auto_device(K, n - 1, 1, device=CPU)
    assert (pk.cpd_auto_device.device_calls,
            pk.cpd_auto_device.fallbacks) == (before[0] + 1, before[1])
    want_cps, want_scores = jk.cpd_auto_device(K, n - 1, 1)
    host_cps, host_scores = pk.cpd_auto(K, n - 1, 1)
    np.testing.assert_array_equal(got_cps, want_cps)
    np.testing.assert_array_equal(got_cps, host_cps)
    assert got_cps.dtype == np.int64 and len(got_cps) >= n_segments - 2
    np.testing.assert_allclose(got_scores, host_scores, rtol=0,
                               atol=_f32_bound(K))


def test_kts_dp_device_equals_jax_scan():
    K = _synthetic_kernel(seed=2, n=40)        # 3 x 13 positions
    n = K.shape[0]
    J = pk.calc_scatters(K).astype(np.float32)
    m_max = 8
    scores, path = pk.kts_dp_device(torch.from_numpy(J), n, m_max)
    want_scores, want_path = jk.kts_dp_jax(J, m_max)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(want_scores))
    want_path = np.asarray(want_path)
    for k in range(1, m_max + 1):
        live = np.arange(n + 1) >= (k + 1)   # columns feasible at k
        np.testing.assert_array_equal(path.numpy()[k][live],
                                      want_path[k][live])
    for m_best in (2, 5):
        cps, valid = jk.kts_backtrack_jax(want_path, m_best, m_max, n)
        np.testing.assert_array_equal(
            pk.kts_backtrack_device(path, m_best, n).numpy(),
            np.asarray(cps)[np.asarray(valid)])


def test_cpd_auto_device_bucket_independent():
    rng = np.random.RandomState(3)
    n = 100
    feats = np.repeat(rng.randn(5, 8), 20, axis=0) + 0.05 * rng.randn(n, 8)
    K = (feats @ feats.T).astype(np.float32)
    small, _ = pk.cpd_auto_device(K, n - 1, 1, bucket_size=50, device=CPU)
    large, _ = pk.cpd_auto_device(K, n - 1, 1, bucket_size=128, device=CPU)
    np.testing.assert_array_equal(small, large)
    np.testing.assert_array_equal(small, jk.cpd_auto_device(
        K, n - 1, 1, bucket_size=128)[0])


def test_cpd_auto_device_falls_back_past_the_bound():
    rng = np.random.RandomState(11)
    n = 600
    feats = np.repeat(rng.randn(10, 16), 60, axis=0) + 0.05 * rng.randn(n, 16)
    feats *= 30.0
    K = feats @ feats.T
    assert n * n * np.abs(K).max() > pk._DEVICE_F32_CRIT
    before = (pk.cpd_auto_device.device_calls, pk.cpd_auto_device.fallbacks)
    got_cps, got_scores = pk.cpd_auto_device(K, n - 1, 1, device=CPU)
    assert (pk.cpd_auto_device.device_calls,
            pk.cpd_auto_device.fallbacks) == (before[0], before[1] + 1)
    want_cps, want_scores = jk.cpd_auto_device(K, n - 1, 1)
    np.testing.assert_array_equal(got_cps, want_cps)
    np.testing.assert_array_equal(got_scores, want_scores)


def test_cpd_auto_device_clamps_like_jax():
    rng = np.random.RandomState(0)
    n = 40
    f = rng.randn(n, 4)
    K = (f @ f.T) / n
    big = K * 1e7        # past the bound: the float64 fallback
    for kernel in (K, big):
        for kwargs in (dict(ncp=n + 5, vmax=1.0), dict(ncp=n - 1, vmax=1.0,
                                                       lmin=2),
                       dict(ncp=2, vmax=1.0, lmax=5)):
            got = pk.cpd_auto_device(kernel, device=CPU, **kwargs)
            want = jk.cpd_auto_device(kernel, **kwargs)
            np.testing.assert_array_equal(got[0], want[0])
            if "lmax" in kwargs:    # infeasible: no change points
                assert len(got[0]) == 0 and np.isinf(got[1]).all()
            elif "lmin" in kwargs and kernel is big:
                assert len(got[0]) >= 1 and (np.diff(got[0]) >= 2).all()


@pytest.mark.parametrize("route", ["host", "device"])
def test_segment_features_equals_jax(route):
    rng = np.random.RandomState(5)
    feats = _normalised_video(rng, 150, 6, width=32).astype(np.float32)
    device = CPU if route == "device" else None
    got = port_h5io.segment_features(feats, 15, device=device)
    want = jax_h5io.segment_features(feats, 15, device=route == "device")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cps, nfps, picks = got
    assert cps[0, 0] == 0 and cps[-1, 1] == 150 * 15 - 2
    assert nfps.sum() == 150 * 15 - 1 and (picks == np.arange(150) * 15).all()


def _write_dataset(path, rng, extra=True):
    with h5py.File(path, "w") as f:
        for i, n in enumerate((60, 95, 130)):
            g = f.create_group(f"video_{i}")
            g["features"] = _normalised_video(rng, n, 4 + i).astype(
                np.float32)
            g["gtscore"] = rng.rand(n).astype(np.float32)
            if extra and i != 1:
                g["user_summary"] = (rng.rand(3, n * 15) > 0.8).astype(
                    np.float32)
                g["gtsummary"] = (rng.rand(n) > 0.8).astype(np.float32)


@pytest.mark.parametrize("route", ["host", "device"])
def test_make_shots_writes_jax_file(tmp_path, route, monkeypatch):
    src = tmp_path / "data.h5"
    _write_dataset(src, np.random.RandomState(9))
    count = port_make_shots.regenerate_shots(
        str(src), str(tmp_path / "port.h5"), 15,
        device=CPU if route == "device" else None)
    want = jax_make_shots.regenerate_shots(
        str(src), str(tmp_path / "jax.h5"), 15,
        device_kts=route == "device")
    assert count == want == 3
    with h5py.File(tmp_path / "port.h5") as got_f, \
            h5py.File(tmp_path / "jax.h5") as want_f:
        assert sorted(got_f) == sorted(want_f)
        for name in want_f:
            assert sorted(got_f[name]) == sorted(want_f[name])
            for field in want_f[name]:
                a, b = got_f[name][field][()], want_f[name][field][()]
                assert np.asarray(a).dtype == np.asarray(b).dtype, field
                np.testing.assert_array_equal(a, b, err_msg=field)
    assert port_h5io.dataset_keys(tmp_path / "port.h5") == \
        jax_h5io.dataset_keys(tmp_path / "port.h5")


def test_make_shots_cli(tmp_path, capsys, monkeypatch):
    src = tmp_path / "data.h5"
    _write_dataset(src, np.random.RandomState(2), extra=False)
    port_make_shots.main(["--dataset", str(src)])
    assert capsys.readouterr().out.strip() == \
        f"Re-segmented 3 videos -> {src}.custom"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_make_shots.main(["--dataset", str(src), "--device-kts"])


def test_kts_demo_prints_jax_lines(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jax_demo.main()
    want = capsys.readouterr().out
    (tmp_path / "kts_demo.png").unlink()
    port_demo.main()
    assert capsys.readouterr().out == want
    assert "plot saved to kts_demo.png" in want
    assert (tmp_path / "kts_demo.png").is_file()
