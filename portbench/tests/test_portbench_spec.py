"""The harness finds every file of the benchmark by its name and refuses a
bad one; BENCHMARK.json keeps the contract's shape."""
import json
import re
import shutil

import pytest

from portbench.harness import spec
from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    loaded = spec.load_cell(BENCH, cell)
    assert loaded["entry"]["name"] == cell
    assert spec.runner(loaded["traffic"]).run
    for m in spec.per_layer(BENCH, cell):
        assert callable(spec.reader(m["name"]))
    names = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer(BENCH, cell)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert UNIT.match(m["unit"])
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_unknown_and_malformed_files_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.load_cell(BENCH, "no.such.cell")
    with pytest.raises(spec.SpecError):
        spec.load_cell(BENCH, "bad name/with slash")
    folder = tmp_path / "bench"
    shutil.copytree(ROOT / "portbench", folder, ignore=shutil.ignore_patterns("__pycache__"))
    cell = BENCH["workloads"][0]
    (folder / "traffic" / f"{cell['traffic']}.json").write_text("{not json")
    with pytest.raises(spec.SpecError, match="not JSON"):
        spec.load_cell(BENCH, cell["name"], folder)
    (folder / "traffic" / f"{cell['traffic']}.json").write_text("{}")
    with pytest.raises(spec.SpecError, match="runner"):
        spec.load_cell(BENCH, cell["name"], folder)
    (folder / "workloads" / f"{cell['name']}.json").unlink()
    with pytest.raises(spec.SpecError, match="missing"):
        spec.load_cell(BENCH, cell["name"], folder)
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric", folder)
