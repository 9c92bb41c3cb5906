"""``BENCHMARK.json`` and the files it names, each found by name.

- a configuration: the ``file`` its entry in ``configs`` gives;
- a traffic mix: ``mixes/<traffic>.json``, whose ``driver`` names
  ``drivers/<driver>.py``;
- a metric: ``metrics/<metric name>.py``, with ``read(run)``;
- a cell's limits for its correctness check: ``limits/<cell name>.json``.

Adding one of these is adding a file and an entry in ``BENCHMARK.json``;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

#: the checkout's root: the folder that holds ``BENCHMARK.json`` and this
#: package
ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "portbench"

NAME_RX = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RX = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "config")
    with open(Path(root) / entry["file"]) as f:
        return json.load(f)


def _data(root: Path, folder: str, name: str) -> dict:
    if not NAME_RX.match(name):
        raise ValueError(f"not a name: {name!r}")
    with open(Path(root) / PACKAGE / folder / f"{name}.json") as f:
        return json.load(f)


def load_mix(traffic: str, root: Path = ROOT) -> dict:
    return _data(root, "mixes", traffic)


def load_limits(cell_name: str, root: Path = ROOT) -> dict:
    return _data(root, "limits", cell_name)


def _module(root: Path, folder: str, name: str) -> ModuleType:
    if not NAME_RX.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = Path(root) / PACKAGE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}._{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(driver: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "drivers", driver)


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "metrics", name)


def metrics_of(bench: dict, cell_name: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that a cell reports:
    those whose ``workloads`` list it, or that have no such list."""
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]
