"""The benchmark's files, found by the names in ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json`` (whose ``runner``
names a module of ``runners/``), ``workloads/<cell>.json`` (the cell's
limits of the comparisons that decide ``correct``) and
``metrics/<metric>.py`` (a per-layer metric's reader). The reference finds
each camera's encoder by the ``_name_`` in a configuration:
``reference/port/models/encoders/<_name_>.py``
(``reference/port/models/build.build_camera_encoder``)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(ValueError):
    """A benchmark file that is missing or malformed."""


def _name(value, what: str) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise SpecError(f"{what} {value!r} is not a valid name")
    return value


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} is missing") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{path} is not JSON: {e}") from None


def load_benchmark(root: Path) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def find_cell(bench: dict, name: str) -> dict:
    cells = [w for w in bench.get("workloads", []) if w.get("name") == name]
    if len(cells) != 1:
        raise SpecError(f"workload {name!r} is not in BENCHMARK.json once")
    return cells[0]


def load_cell(bench: dict, name: str, folder: Path = HERE) -> dict:
    """The cell's BENCHMARK.json entry, its configuration, its traffic mix and
    its limits: {"entry", "config", "traffic", "limits"}."""
    entry = find_cell(bench, _name(name, "workload"))
    config = _json(folder / "configs" / f"{_name(entry['config'], 'config')}.json")
    traffic = _json(folder / "traffic" / f"{_name(entry['traffic'], 'traffic')}.json")
    cell = _json(folder / "workloads" / f"{name}.json")
    for what, d, keys in (("config", config, ("config",)), ("traffic", traffic, ("runner",)),
                          ("workload", cell, ("limits",))):
        missing = [k for k in keys if k not in d]
        if missing:
            raise SpecError(f"{what} file of {name!r} lacks {missing}")
    _name(traffic["runner"], "runner")
    if entry.get("chips") not in (1, 4):
        raise SpecError(f"workload {name!r}: chips must be 1 or 4")
    return {"entry": entry, "config": config, "traffic": traffic, "limits": cell["limits"]}


def runner(traffic: dict):
    return importlib.import_module(f"portbench.runners.{traffic['runner']}")


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench.get("per_layer", [])
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench.get("end_to_end", []) if cell in m.get("workloads", [cell])]


def reader(name: str, folder: Path = HERE):
    """``read(record)`` of ``metrics/<name>.py``."""
    path = folder / "metrics" / f"{_name(name, 'metric')}.py"
    if not path.is_file():
        raise SpecError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(metrics: List[dict]) -> Dict[str, object]:
    return {m["name"]: reader(m["name"]) for m in metrics}
