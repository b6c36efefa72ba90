"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its ``configs`` entry names, its
traffic mix ``benchmark/traffic/<traffic>.json``.  The code a mix or a
configuration names is a module of its own, loaded by :func:`plugin`: the
entry point a mix drives (``entries/<entry>.py``), its label source
(``labels/<labels>.py``) and the configuration's mesh kind
(``meshes/<kind>.py``).  Each per-layer metric is read by
``metrics/<name>.py``, or, where there is no such file, by the reader of
the name with its last dotted parts taken off (``device.idle_share.render``
by ``metrics/device.idle_share.py``).  Adding a cell, a configuration, a
mix, an entry, a label source, a mesh kind or a metric adds files and
entries; no file already there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

_LOADED = {}  # path -> module: a module is loaded once, so a test can patch it


@dataclasses.dataclass
class Cell:
    """One workload: its entry of ``BENCHMARK.json``, its configuration and
    traffic as read, and the metrics it reports (entries of
    ``end_to_end`` and ``per_layer``)."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, cell: str, e2e_names=()) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or the metric lists none and moves an end-to-end metric
    in ``e2e_names``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; ``KeyError`` when
    there is none."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, int(entry["chips"]), config, traffic, e2e, per_layer)


def plugin(kind: str, name: str, root: Path = ROOT):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``, loaded once."""
    path = (root / "benchmark" / kind / f"{name}.py").resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise KeyError(f"no {kind} {name!r}: {path} does not exist")
        tag = re.sub(r"\W", "_", f"{kind}_{name}")
        module_name = f"_bench_{tag}_{len(_LOADED)}"
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``metric``'s reader: ``metrics/<metric>.py``,
    else the reader of ``metric`` with its last dotted parts taken off."""
    name = metric
    while not (root / "benchmark" / "metrics" / f"{name}.py").is_file() and "." in name:
        name = name.rsplit(".", 1)[0]
    return plugin("metrics", name, root).read


def entry(traffic: dict, root: Path = ROOT):
    """The entry module that ``traffic`` drives: its ``Entry`` class and
    its ``LIMITS``."""
    return plugin("entries", traffic["entry"], root)
