"""The import guard and the refusals of a run that cannot measure."""
import shutil
import subprocess
import sys

import pytest

from portbench import run as bench
from portbench.lib.cell import ROOT


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert bench.banned_modules() == []
    for name in ("edsnet_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, object())
    assert bench.banned_modules() == []
    monkeypatch.setitem(sys.modules, "edsnet_tpu.kernels", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert bench.banned_modules() == ["edsnet_tpu", "jax"]


def test_the_program_never_loads_jax(cpu):
    """A whole run of every cell's program path, in this process, leaves
    no banned module behind."""
    from portbench.tests.conftest import tiny_cell
    if bench.banned_modules():
        pytest.skip("this process already holds JAX (another test file)")
    for name in ("ab-nystromformer.train-tvsum", "ab-attention.eval-summe"):
        cell = tiny_cell(name)
        bench.run_cell(name, 3, 0.1, False, device=cpu, cell=cell)
    assert bench.banned_modules() == []


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ab-nystromformer.eval-summe", "--seed", "5", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_no_program_no_result(tmp_path):
    """In a directory with the benchmark alone, a run fails and prints
    nothing on standard output."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_no_card_no_result():
    """Without a CUDA device a run fails and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr
