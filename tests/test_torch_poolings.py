"""edsnet_torch's window poolings vs edsnet_tpu on the CPU, on the same
numpy-seeded inputs and weights: the weight folds, windowed_linear, the
coarse maps and the Pooling module against JAX's fused form and its
gather-the-windows oracle (fused=False), at sequences shorter than the
left reach s//2 - 1, at n = 1, and at odd and even scales; the fc leaves
through the weight bridge.  Tolerance 1e-5 (f32, another summation
order), 1e-6 for the folds (the same products)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edsnet_tpu.models.poolings import Pooling as JaxPooling
from edsnet_tpu.ops import window_linear as jax_wl
from edsnet_torch.convert import flax_to_state_dict, state_dict_to_flax
from edsnet_torch.models.poolings import Pooling
from edsnet_torch.ops import window_linear as wl

TOL = dict(rtol=1e-5, atol=1e-5)
H, O = 8, 6
FOLDS = {"fft": "fft_weight_fold", "dwt": "dwt_weight_fold",
         "flat-pooling": "flat_weight_fold"}
# (scale, n): the left reach s//2 - 1 is 5 at scale 12, so n 3 and 1 are
# shorter than it; n 1 is a single position; odd scales fold for fft and
# flat only
CASES = [(12, 40), (12, 3), (12, 1), (4, 1), (2, 9), (3, 7), (5, 2), (8, 8)]


def _x(b, n, lens, seed):
    """[b, n, H] with zeros past each row's length (padded positions)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, n, H).astype(np.float32)
    mask = np.arange(n)[None, :] < np.asarray(lens)[:, None]
    return x * mask[..., None]


def _kernel(kind, scale, seed):
    slots = scale // 2 if kind == "dwt" else scale
    rng = np.random.RandomState(seed)
    return (rng.randn(slots * H, O) / np.sqrt(slots * H)).astype(np.float32), \
        rng.randn(O).astype(np.float32)


def _cases():
    for kind in FOLDS:
        for scale, n in CASES:
            if kind != "dwt" or scale % 2 == 0:
                yield kind, scale, n


@pytest.mark.parametrize("kind,scale,n", list(_cases()))
def test_folds_windowed_linear_and_coarse_match_jax(kind, scale, n):
    w, bias = _kernel(kind, scale, seed=scale)
    x = _x(2, n, [n, max(n - 2, 0)], seed=n)
    want_fold = getattr(jax_wl, FOLDS[kind])(jnp.asarray(w), scale)
    got_fold = getattr(wl, FOLDS[kind])(torch.from_numpy(w), scale)
    assert tuple(got_fold.shape) == (scale, H, O)
    np.testing.assert_allclose(got_fold.numpy(), np.asarray(want_fold),
                               rtol=1e-6, atol=1e-6)
    want = jax_wl.windowed_linear(jnp.asarray(x), want_fold,
                                  jnp.asarray(bias))
    got = wl.windowed_linear(torch.from_numpy(x), got_fold,
                             torch.from_numpy(bias))
    assert got.shape == want.shape == (2, n, O)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("fft_coarse", "dwt_coarse"):
        if name == "dwt_coarse" and scale % 2:
            continue
        want = getattr(jax_wl, name)(jnp.asarray(x), scale)
        got = getattr(wl, name)(torch.from_numpy(x), scale)
        assert got.shape == want.shape == x.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("kind,scale,n", list(_cases()))
def test_pooling_matches_jax_fused_and_oracle(kind, scale, n):
    """The port's Pooling (fused) against JAX's fused Pooling and its
    gather-the-windows oracle, coarse and fine, with the same fc leaves;
    and with emit_coarse off, the fine tensor alone.  At an odd scale the
    reference's window [i - s//2 + 1, i + s//2] holds s - 1 positions and
    the oracle zeroes slot s - 1, while JAX's fused form, the one its CLIs
    run, reads x[i + s//2 + 1] there: the port follows the fused form, so
    the fine tensor is held to the oracle at even scales only (and the
    two JAX forms are checked to differ at odd ones)."""
    x = _x(3, n, [n, max(n - 1, 0), 0], seed=scale + n)
    w, bias = _kernel(kind, scale, seed=7)
    variables = {"params": {"fc_kernel": w, "fc_bias": bias}}
    port = Pooling([scale], kind, H, O)
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for fused in (True, False):
        want = JaxPooling([scale], kind, O, fused=fused).apply(
            variables, jnp.asarray(x))
        assert len(got) == len(want) == (1 if kind == "flat-pooling" else 2)
        for name, g, w_ in zip(("coarse", "fine")[-len(got):], got, want):
            if name == "fine" and not fused and scale % 2:
                if n > scale // 2 + 1:   # a window reaches slot s - 1
                    assert not np.allclose(g.numpy(), np.asarray(w_),
                                           **TOL)
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                       err_msg=f"{name} fused={fused}",
                                       **TOL)
    port.emit_coarse = False
    with torch.no_grad():
        (fine,) = port(torch.from_numpy(x))
    torch.testing.assert_close(fine, got[-1], rtol=0, atol=0)


def test_dwt_odd_scale_raises_in_both():
    with pytest.raises(ValueError, match="even --anchor-scales"):
        Pooling([5], "dwt", H, O)
    with pytest.raises(ValueError, match="even --anchor-scales"):
        JaxPooling([5], "dwt", O).init({}, jnp.zeros((1, 8, H)))


def test_pooling_leaves_round_trip_untransposed():
    """fc_kernel [s*H, O] and fc_bias go through the bridge's raw-leaf
    rule: not transposed, the same names both ways."""
    port = Pooling([12], "fft", H, O)
    variables = {"params": {k: v.detach().numpy() for k, v in
                            port.state_dict().items()}}
    tree = state_dict_to_flax(port.state_dict())
    assert sorted(tree) == ["fc_bias", "fc_kernel"]
    assert tree["fc_kernel"].shape == (12 * H, O)
    back = flax_to_state_dict(variables)
    for name, t in port.state_dict().items():
        assert torch.equal(back[name], t)
        np.testing.assert_array_equal(tree[name], t.numpy())
