"""edsnet_torch's build of the native C++ host library and the host knapsack
vs edsnet_tpu: the library builds from the port's own copy of the source
into its build cache, its two entry points equal edsnet_tpu.native's on
fuzzed inputs, and ``knapsack_host`` packs JAX's ``knapsack`` selection
under each solver, ties included."""
import numpy as np
import pytest

from edsnet_tpu import native as jax_native
from edsnet_tpu.ops import knapsack as jax_knapsack
from edsnet_torch import native
from edsnet_torch.kernels.build import BUILD_DIR
from edsnet_torch.ops import knapsack as port_knapsack


def test_library_builds_from_the_ports_source():
    lib = native.load()
    assert lib is not None
    assert lib.path == native.lib_path()
    assert lib.path.parent == BUILD_DIR and lib.path.is_file()
    assert native.SOURCE.parent.name == "csrc"
    assert native.SOURCE.parent.parent.name == "edsnet_torch"
    # the same C++ as the TPU package's, apart from the header comment
    body = native.SOURCE.read_text().split("#include", 1)[1]
    jax_src = jax_native._SRC.read_text().split("#include", 1)[1]
    assert body == jax_src


def test_no_native_env_and_failed_build_give_none(monkeypatch):
    monkeypatch.setattr(native, "_cached", None)
    monkeypatch.setenv("EDSNET_NO_NATIVE", "1")
    assert native.load() is None
    monkeypatch.delenv("EDSNET_NO_NATIVE")
    monkeypatch.setattr(native, "_build", lambda: None)
    assert native.load() is None
    assert native._failed
    monkeypatch.setattr(native, "_failed", False)


def _tie_inputs(rng):
    """tests/ops/test_knapsack_audit.py's inputs: small values and weights,
    so tied optima are common."""
    n = int(rng.randint(3, 12))
    return rng.randint(1, 6, n), rng.randint(1, 6, n), int(rng.randint(3, 15))


def _shot_inputs(rng):
    """Shot-knapsack-like inputs: int(1000 * mean) values, shot lengths."""
    n = int(rng.randint(1, 40))
    values = rng.randint(0, 1000, n)
    weights = rng.randint(1, 150, n)
    return values, weights, int(rng.randint(0, weights.sum() + 2))


@pytest.mark.parametrize("make", [_tie_inputs, _shot_inputs],
                         ids=["ties", "shots"])
@pytest.mark.parametrize("seed", range(4))
def test_entry_points_equal_jax_library(make, seed):
    ours, theirs = native.load(), jax_native.load()
    assert theirs is not None
    rng = np.random.RandomState(seed)
    for _ in range(25):
        values, weights, cap = make(rng)
        assert ours.knapsack(values, weights, cap) == \
            theirs.knapsack(values, weights, cap)
    n = int(rng.randint(5, 40))
    J = np.triu(rng.rand(n, n) * n)
    for m, lmin, lmax, back in ((n - 1, 1, n + 1, True),
                                (max(n // 3 - 1, 1), 2, n, True),
                                (3, 1, n + 1, False)):
        got = ours.kts_dp(J, m, lmin, lmax, back)
        want = theirs.kts_dp(J, m, lmin, lmax, back)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("solver", ["dp", "bnb", "auto"])
@pytest.mark.parametrize("make", [_tie_inputs, _shot_inputs],
                         ids=["ties", "shots"])
def test_knapsack_host_equals_jax_selection(solver, make):
    rng = np.random.RandomState(7)
    for _ in range(50):
        values, weights, cap = make(rng)
        got = port_knapsack.knapsack_host(values, weights, cap, solver=solver)
        want = jax_knapsack.knapsack(values, weights, cap, solver=solver)
        assert got == want
        assert sum(weights[i] for i in got) <= cap


def test_auto_takes_branch_and_bound_past_the_table_bound(monkeypatch):
    rng = np.random.RandomState(3)
    values = rng.randint(1, 1000, 60)
    weights = rng.randint(10_000, 100_000, 60)
    cap = 1_000_000                  # 6e7 table cells, past 5e7
    calls = []
    lib = native.load()
    real = lib.knapsack

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(lib, "knapsack", spy)
    got = port_knapsack.knapsack_host(values, weights, cap)
    assert len(calls) == 1
    assert got == jax_knapsack.knapsack(values, weights, cap)
    assert got == port_knapsack.knapsack_host(values, weights, cap,
                                              solver="bnb")
    # without the library, auto takes the DP at any size
    monkeypatch.setattr(port_knapsack, "_native_load", lambda: None)
    dp = port_knapsack.knapsack_host(values, weights, cap)
    assert sum(values[i] for i in dp) == sum(values[i] for i in got)
    assert len(calls) == 2           # the bnb call above


def test_unknown_solver_raises():
    with pytest.raises(ValueError, match="unknown knapsack solver"):
        port_knapsack.knapsack_host([1], [1], 1, solver="ortools")


def test_bnb_without_library_raises(monkeypatch):
    monkeypatch.setattr(port_knapsack, "_native_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        port_knapsack.knapsack_host([1, 2], [1, 1], 1, solver="bnb")
    assert port_knapsack.knapsack_host([1, 2], [1, 1], 1, solver="dp") == [1]
