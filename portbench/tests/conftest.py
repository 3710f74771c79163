"""The benchmark's CPU tests: the port's plain versions at tiny sizes.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
"""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WORKLOADS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])
# Cells whose files are in place but which BENCHMARK.json leaves out (PERF.md, section 7): (config, traffic).
PARKED = {"urban24_cov_o2": ("urban24", "map_o0_2")}


def cell_files(workload: str) -> dict:
    """:func:`portbench.harness.cell_files`, for the parked cells too (with the metrics of a map cell)."""
    from portbench import harness

    if workload not in PARKED:
        return harness.cell_files(workload)
    config, traffic = PARKED[workload]
    files = harness.cell_files("urban24_hybrid_o1")
    files["config"] = harness.load_json(ROOT / "portbench" / "configs" / f"{config}.json")
    files["traffic"] = harness.load_json(ROOT / "portbench" / "traffic" / f"{traffic}.json")
    files["limits"] = harness.load_json(ROOT / "portbench" / "limits" / f"{workload}.json")
    return files


def tiny_files(workload: str) -> dict:
    """The cell's files at a size a test holds: a 4 x 4 city, small grids, chunks and shards.

    On the CPU every call of the port runs its plain versions, so the limit
    on plain calls (0 on the card) is lifted; every other limit is the cell's.
    """
    files = copy.deepcopy(cell_files(workload))
    config, traffic = files["config"], files["traffic"]
    config["city"].update(num_blocks_x=4, num_blocks_y=4)
    config["num_triangles"] = 4 * 4 * 36 + 2
    for grid in config["grids"].values():
        if grid["kind"] == "square":
            grid.update(n=12, half_m=90.0)
        else:
            grid.update(nx=4, ny=2)
    for order in traffic["orders"]:
        cands = order["candidates"]
        if "size" in cands:
            cands["size"] = min(cands["size"], 600)
        if cands["kind"] == "near_then_strided":  # enough pairs near the TX to light a few pixels
            cands.update(pool=60, size=4096)
        if cands["kind"] == "block":
            cands["blocks"] = [[1, 1], [1, 2], [2, 1], [2, 2]]
    if "solver" in traffic:
        traffic["solver"]["num_rays"] = 4000
    traffic.update(candidate_chunk=128, rx_chunk=16)
    if "inputs" in traffic:
        traffic["inputs"] = 2
    files["limits"]["plain_calls"] = 10**9
    return files


@pytest.fixture(params=WORKLOADS + tuple(PARKED))
def workload(request) -> str:
    return request.param


@pytest.fixture
def tiny():
    """:func:`tiny_files`, for the tests."""
    return tiny_files
