"""What a run reads from its checkout, found by name: the cell in
``BENCHMARK.json``, its configuration file, its traffic mix
(``perfbench/traffic/<mix>.json``), its limits
(``perfbench/limits/<cell>.json``), the family's plain reference
(``perfbench/reference/<family>.py``), every kernel file
(``perfbench/kernels/*.py``) and a reader a per-layer metric
(``perfbench/metrics/<metric>.py``).  Adding any of them is adding a file
and an entry: nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    reference: ModuleType
    kernels: List[ModuleType]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with everything it
    names; raises KeyError for a cell that is not there."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    pb = root / "perfbench"
    traffic = json.loads((pb / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((pb / "limits" / f"{name}.json").read_text())
    reference = load_module(pb / "reference" / f"{config['family']}.py",
                            f"perfbench_reference_{config['family']}")
    kernels = [load_module(p, f"perfbench_kernel_{p.stem}")
               for p in sorted((pb / "kernels").glob("*.py"))]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    readers = {m["name"]: load_module(pb / "metrics" / f"{m['name']}.py",
                                      f"perfbench_metric_{m['name'].replace('.', '_')}")
               for m in per_layer}
    return Cell(w, config, traffic, limits, reference, kernels, e2e, per_layer, readers)
