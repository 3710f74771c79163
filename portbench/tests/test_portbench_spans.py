"""The span metrics' readers on synthetic span lists, and on the spans of a CPU run of a cell."""

import pytest
import torch

from differt_tpu_torch import profiling
from portbench import harness

CPU = torch.device("cpu")


def span(name, parent=None, device_ms=None, host_ms=1.0) -> dict:
    return {"name": name, "parent": parent, "device_ms": device_ms, "host_ms": host_ms}


# Two requests: a map of two tiles, its visibility and DFS; then a step-like tree.
MAP = [
    span("coverage.map", None, 100.0),  # 0
    span("visibility", 0, 30.0),  # 1
    span("kernel.closest", 1, 20.0),  # 2
    span("dfs", 0, 2.0, host_ms=4.0),  # 3
    span("tile", 0, 10.0),  # 4
    span("kernel.trace", 4, 1.0),  # 5
    span("em", 4, 6.0),  # 6
    span("tile", 0, 12.0),  # 7
    span("kernel.trace", 7, 1.5),  # 8
    span("em", 7, 7.0),  # 9
    span("coverage.map", None, 90.0),  # 10
    span("visibility", 10, 50.0),  # 11
    span("kernel.closest", 11, 40.0),  # 12
    span("dfs", 10, 1.0, host_ms=6.0),  # 13
]
STEP = [
    span("step", None, 200.0),  # 0
    span("step.pass1", 0, 60.0),  # 1
    span("tile", 1, 25.0),  # 2
    span("kernel.trace", 2, 2.0),  # 3
    span("em", 2, 20.0),  # 4
    span("step.pass3", 0, 130.0),  # 5
    span("tile", 5, 35.0),  # 6
    span("kernel.trace", 6, 2.5),  # 7
    span("em", 6, 30.0),  # 8
    span("step.backward", 5, 90.0),  # 9
    span("em", 0, 1000.0),  # outside any tile: counted by the EM metric, not taken from the glue
]


@pytest.fixture
def spans(monkeypatch):
    """Hand the readers ``value`` as the program's spans."""

    def give(value):
        monkeypatch.setattr(profiling, "spans", lambda: value)

    return give


def read(name: str, trace: dict):
    return harness.metric_reader(name)(trace)


def test_map_readers(spans):
    spans(MAP)
    trace = {"counters": {"trace": 2, "closest": 3}, "bounds_s": {"trace": 5e-4, "closest": 6e-3}}
    assert read("em.span_ms_per_tile.map", trace) == pytest.approx((6.0 + 7.0) / 2)
    assert read("tile.glue_ms_per_tile.map", trace) == pytest.approx((10.0 - 1.0 - 6.0 + 12.0 - 1.5 - 7.0) / 2)
    assert read("trace.span_roofline.map", trace) == pytest.approx(100.0 * 5e-4 / 2.5e-3)
    assert read("closest.span_roofline.map", trace) == pytest.approx(100.0 * 6e-3 / 60e-3)
    assert read("visibility.device_ms.map", trace) == pytest.approx((30.0 + 50.0) / 2)  # per request
    assert read("dfs.host_ms.map", trace) == pytest.approx((4.0 + 6.0) / 2)  # host time, not device


def test_step_readers(spans):
    spans(STEP)
    trace = {"counters": {"trace": 2}, "bounds_s": {"trace": 1e-3}}
    assert read("pass1.device_ms.step", trace) == pytest.approx(60.0)
    assert read("backward.device_ms.step", trace) == pytest.approx(90.0)
    assert read("em.span_ms_per_tile.step", trace) == pytest.approx((20.0 + 30.0 + 1000.0) / 2)
    assert read("tile.glue_ms_per_tile.step", trace) == pytest.approx((25.0 - 2.0 - 20.0 + 35.0 - 2.5 - 30.0) / 2)
    assert read("trace.span_roofline.step", trace) == pytest.approx(100.0 * 1e-3 / 4.5e-3)


NAMES = (
    "em.span_ms_per_tile.map", "tile.glue_ms_per_tile.step", "trace.span_roofline.map", "closest.span_roofline.map",
    "visibility.device_ms.map", "dfs.host_ms.map", "pass1.device_ms.step", "backward.device_ms.step",
)
TRACE = {"counters": {"trace": 2, "closest": 3}, "bounds_s": {"trace": 1e-3, "closest": 1e-3}}


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_their_spans(spans, monkeypatch, name):
    spans([])  # a session with no span
    assert read(name, TRACE) is None
    spans([span("other", None, 1.0)])  # spans, but none this reader needs
    assert read(name, TRACE) is None
    spans([{**s, "device_ms": None} for s in MAP + STEP])  # no CUDA events: device metrics read nothing
    if name != "dfs.host_ms.map":
        assert read(name, TRACE) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert read(name, TRACE) is None


@pytest.mark.parametrize("name", ["em.span_ms_per_tile.map", "tile.glue_ms_per_tile.map", "trace.span_roofline.map"])
def test_readers_read_nothing_without_launches_or_bounds(spans, name):
    spans(MAP)
    assert read(name, {"counters": {"trace": 0}, "bounds_s": {"trace": 0.0}}) is None


def test_the_hybrid_cell_on_the_cpu_gives_its_host_spans(tiny):
    """The cell's own map on the CPU, under the profiler: the DFS's host time reads, the device metrics do not."""
    from differt_tpu_torch import native

    files = tiny("urban24_hybrid_o1")
    entry = harness.make_entry(files, CPU)
    entry.setup(7)
    entry.warm()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        entry.call(0)
        entry.call(1)
    names = [s["name"] for s in profiling.spans()]
    assert names.count("coverage.map") == 2 and names.count("visibility") == 2 and "tile" in names
    dfs = read("dfs.host_ms.map", TRACE)
    assert (dfs is not None and dfs > 0.0) if native.is_available() else dfs is None
    assert read("visibility.device_ms.map", TRACE) is None  # no CUDA events on the CPU
