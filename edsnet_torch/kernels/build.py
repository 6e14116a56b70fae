"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``kernels/_build/lib<name>-<hash>.so`` (a
plain C interface, no PyTorch headers), keyed by the content of the source
and of the ``csrc/*.cuh`` headers, so an edited source or header rebuilds.
A source outside ``csrc/`` is named by its path (``tools/x.cu``) and
compiled with ``csrc/`` on the include path.  The build runs at first use; ``build(*names)``
starts one nvcc per missing library, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parent.parent
SRC_DIR = PKG / "csrc"
BUILD_DIR = PKG / "kernels" / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _source(name: str) -> Path:
    """``csrc/<name>.cu``, or ``name`` itself where it is a .cu path."""
    return Path(name) if name.endswith(".cu") else SRC_DIR / f"{name}.cu"


def _lib_path(name: str) -> Path:
    """Keyed by the source, every header in csrc/ and the flags."""
    source = _source(name)
    deps = sorted(SRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(source.read_bytes()
                            + b"".join(p.read_bytes() for p in deps)
                            + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{source.stem}-{digest[:16]}.so"


def build(*names: str) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.

    Returns each name's ptxas report (registers, shared memory, spills);
    empty for a library that was already built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(SRC_DIR),
               "-o", str(tmp), str(_source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    reports = {name: "" for name in names}
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        tmp.replace(target)
        reports[name] = log
    return reports


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (or the .cu path
    ``name``), building it if needed."""
    if name not in _loaded:
        build(name)
        _loaded[name] = ctypes.CDLL(str(_lib_path(name)))
    return _loaded[name]
