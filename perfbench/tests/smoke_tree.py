"""A checkout-shaped tree for the CPU tests: this ``BENCHMARK.json`` and
``perfbench/`` data, with every configuration cut to its port's smoke size
and every traffic mix to a few tokens, so that a whole run fits the CPU.

The smoke sizes are data, found by name beside this file:

  ``smoke/configs/<config>.json``  ``config``: the configuration file's keys
                                   to set, which reach the port's
                                   ``port.replace`` through the file's own
                                   ``port.sizes``; ``limits``: the check's
                                   limits for every cell of the configuration
                                   at these sizes;
  ``smoke/traffic/<mix>.json``     the mix's keys to set (``lengths``,
                                   ``trace_slice``, and ``batch`` or
                                   ``batch_tokens`` where they change).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Tuple

ROOT = Path(__file__).resolve().parents[2]
SMOKE = Path("perfbench") / "tests" / "smoke"


def cells(root: Path = ROOT) -> Tuple[str, ...]:
    """The names of the workloads in ``root/BENCHMARK.json``."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    return tuple(w["name"] for w in bench["workloads"])


def _smoke(root: Path, kind: str, name: str) -> dict:
    rel = SMOKE / kind / f"{name}.json"
    if not (root / rel).is_file():
        raise FileNotFoundError(f"no smoke sizes for {kind} {name!r}: add {rel}")
    return json.loads((root / rel).read_text())


def smoke_tree(dst: Path, root: Path = ROOT) -> Path:
    """Copy the benchmark of the checkout ``root`` into ``dst`` at smoke
    size; -> ``dst``.  Raises FileNotFoundError, naming the file to add,
    for a configuration or mix of ``BENCHMARK.json`` without smoke sizes."""
    dst, root = Path(dst), Path(root)
    shutil.copy(root / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(root / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    limits = {}
    for c in bench["configs"]:
        small = _smoke(root, "configs", c["name"])
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        cfg.update(small["config"])
        repl = cfg["port"]["replace"]
        for field, key in cfg["port"]["sizes"].items():
            if key in small["config"]:
                *group, leaf = field.split(".")
                into = repl
                for part in group:
                    into = into.setdefault(part, {})
                into[leaf] = small["config"][key]
        path.write_text(json.dumps(cfg))
        limits[c["name"]] = small["limits"]
    for w in bench["workloads"]:
        (dst / "perfbench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps({"limits": limits[w["config"]]}))
    for name in {w["traffic"] for w in bench["workloads"]}:
        path = dst / "perfbench" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(_smoke(root, "traffic", name))
        path.write_text(json.dumps(mix))
    return dst
