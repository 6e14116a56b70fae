"""edsnet_torch.fetch_weights vs edsnet_tpu.fetch_weights, offline: the
same WEIGHTS, the same cache path (with and without torch), and the same
printed lines and return codes of ``--verify`` (and ``--pin``) on an
uncached file and on a fake cached one whose recorded digest is made to
match and to mismatch.  Nothing is downloaded."""
import hashlib
import sys

import pytest
import torch.hub

from edsnet_torch import fetch_weights
from edsnet_tpu import fetch_weights as jax_fetch_weights


@pytest.fixture
def empty_hub(tmp_path, monkeypatch):
    """An empty torch hub cache under a temporary TORCH_HOME."""
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.setattr(torch.hub, "_hub_dir", None, raising=False)
    return tmp_path


def test_weights_equal_jax():
    assert fetch_weights.WEIGHTS == jax_fetch_weights.WEIGHTS


@pytest.mark.parametrize("name", sorted(fetch_weights.WEIGHTS))
def test_known_urls_carry_hash_prefixes(name):
    spec = fetch_weights.WEIGHTS[name]
    assert spec["url"].startswith("https://")
    if spec["sha256_prefix"] is not None:
        # torchvision convention: hash prefix embedded in the filename
        assert spec["sha256_prefix"] in spec["url"], name


@pytest.mark.parametrize("env", ["torch_home", "xdg", "home"])
def test_hub_dir_without_torch_equals_jax(tmp_path, monkeypatch, env):
    """torch.hub's default chain, computed when torch does not import."""
    for var in ("TORCH_HOME", "XDG_CACHE_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if env == "torch_home":
        monkeypatch.setenv("TORCH_HOME", str(tmp_path / "th"))
    elif env == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.setitem(sys.modules, "torch", None)   # import torch fails
    got = fetch_weights.hub_dir()
    assert got == jax_fetch_weights.hub_dir()
    assert str(got).startswith(str(tmp_path))
    assert got.parts[-2:] == ("hub", "checkpoints")


def test_cached_path_follows_torch_home(empty_hub):
    path = fetch_weights.cached_path("google-net")
    assert path == empty_hub / "hub" / "checkpoints" / "googlenet-1378be20.pth"
    assert path == jax_fetch_weights.cached_path("google-net")


@pytest.mark.parametrize("argv", [["--verify"], ["--verify", "--all"]])
def test_verify_reports_uncached(empty_hub, capsys, argv):
    rc = fetch_weights.main(argv)
    out = capsys.readouterr().out
    assert rc == 1
    assert "not cached" in out
    assert jax_fetch_weights.main(argv) == rc
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("kind,outcome", [
    ("prefix", "match"), ("prefix", "mismatch"), ("full", "match"),
    ("full", "mismatch"), ("none", "match")])
def test_verify_fake_cached_file(empty_hub, monkeypatch, capsys, kind,
                                 outcome):
    """--verify --pin on a fake cached file, its recorded digest patched
    to match or not (the same patch on both packages' WEIGHTS)."""
    payload = b"not a real checkpoint"
    digest = hashlib.sha256(payload).hexdigest()
    path = fetch_weights.cached_path("google-net")
    path.parent.mkdir(parents=True)
    path.write_bytes(payload)
    spec = {"url": fetch_weights.WEIGHTS["google-net"]["url"],
            "sha256_prefix": None, "sha256_full": None}
    wrong = "0" * 64 if digest[0] != "0" else "f" * 64
    if kind == "prefix":
        spec["sha256_prefix"] = (digest if outcome == "match" else wrong)[:8]
    elif kind == "full":
        spec["sha256_full"] = digest if outcome == "match" else wrong
    for module in (fetch_weights, jax_fetch_weights):
        monkeypatch.setitem(module.WEIGHTS, "google-net", dict(spec))

    rc = fetch_weights.main(["--verify", "--pin"])
    out = capsys.readouterr().out
    assert rc == (1 if outcome == "mismatch" else 0)
    assert f'"sha256_full": "{digest}"' in out
    assert ("HASH MISMATCH" in out) == (outcome == "mismatch")
    assert jax_fetch_weights.main(["--verify", "--pin"]) == rc
    assert capsys.readouterr().out == out
