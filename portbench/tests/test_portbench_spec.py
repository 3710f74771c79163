"""``BENCHMARK.json`` against its contract, the files it names, and what the benchmark imports."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_units_and_keys(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names))
    for entry in SPEC[section]:
        assert set(entry) <= KEYS[section], entry
        assert NAME.fullmatch(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.fullmatch(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in entry:
                assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] and "\t" not in entry[text]


def test_cells_name_files_that_exist():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for cell in SPEC["workloads"]:
        assert cell["chips"] == 1
        assert len(cell["why"]) <= 200
        used.add(cell["config"])
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
        config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
        assert set(configs[cell["config"]]["reduced"]) <= set(config)
    assert used == set(configs)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in SPEC["per_layer"] if cell in m.get("workloads", cells)]
        assert layers and all(m["moves"] in e2e for m in layers)
    for metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.0 < metric["bound"] <= 0.25


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(section):
    """``portbench/metrics/<name>.py``, or the file named without the last dotted part."""
    for metric in SPEC[section]:
        name = metric["name"]
        assert any((BENCH / "metrics" / f"{stem}.py").is_file() for stem in (name, name.rsplit(".", 1)[0])), name


def test_every_named_input_kind_has_its_module():
    """Scenes, receiver layouts, candidate kinds, solvers and entries are files found by name."""
    inputs = BENCH / "inputs"
    for config in SPEC["configs"]:
        data = json.loads((ROOT / config["file"]).read_text())
        assert (inputs / "scenes" / f"{data['scene']}.py").is_file()
        for grid in data["grids"].values():
            assert (inputs / "receivers" / f"{grid['kind']}.py").is_file()
    for path in sorted((BENCH / "traffic").glob("*.json")):
        traffic = json.loads(path.read_text())
        assert (BENCH / "entries" / f"{traffic['entry']}.py").is_file()
        for order in traffic["orders"]:
            assert (inputs / "candidates" / f"{order['candidates']['kind']}.py").is_file()
        if "solver" in traffic:
            assert (inputs / "solvers" / f"{traffic['solver']['kind']}.py").is_file()


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere_and_no_port_in_the_reference(path):
    names = _imports(path)
    assert not names & {"jax", "jaxlib", "flax", "differt_tpu"}, names
    if "reference" in path.parts:
        assert "differt_tpu_torch" not in names, names
