"""A cell of ``BENCHMARK.json`` and the files it is made of, found by
name: its configuration (``configs/<config>.json`` and the reference
beside it, ``configs/<config>.py``), its traffic (``traffic/<mix>.json``),
the driver that its traffic's ``kind`` names (``drivers/<kind>.py``), its
metrics (``metrics/<metric>.py``) and its limits (``limits/<cell>.json``).
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    """A file of the benchmark as a module (file names may hold '-' and
    '.', so not by ``import``)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict                      # configs/<config>.json
    model: ModuleType                 # configs/<config>.py
    traffic: Dict                     # traffic/<mix>.json
    driver: ModuleType                # drivers/<kind>.py
    end_to_end: List[Dict]            # the cell's end-to-end metrics
    per_layer: List[Dict]             # the cell's per-layer metrics
    limits: Dict[str, float]
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    def program_args(self, *extra: str) -> List[str]:
        """The port's CLI arguments: the configuration's, the traffic's
        ``program`` settings (each key a flag), then ``extra``."""
        flags = []
        for key, value in self.traffic.get("program", {}).items():
            flags += [f"--{key.replace('_', '-')}", str(value)]
        return list(self.config["args"]) + flags + list(extra)


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    bench = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    config = _json(BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = _json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    cell = Cell(
        name=name, chips=int(w["chips"]), config=config,
        model=load_module(BENCH_DIR / "configs" / f"{w['config']}.py",
                          f"portbench_config_{w['config']}"),
        traffic=traffic,
        driver=load_module(BENCH_DIR / "drivers" / f"{traffic['kind']}.py",
                           f"portbench_driver_{traffic['kind']}"),
        end_to_end=e2e, per_layer=layer,
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"))
    for m in layer:
        cell.readers[m["name"]] = load_module(
            BENCH_DIR / "metrics" / f"{m['name']}.py",
            f"portbench_metric_{m['name']}")
    return cell
