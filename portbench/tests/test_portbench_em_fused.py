"""The ``em.fused_pct`` reader on synthetic span lists: the share of tiles whose EM chain ran as one kernel."""

import pytest

from differt_tpu_torch import profiling
from portbench import harness


def span(name, parent=None) -> dict:
    return {"name": name, "parent": parent, "device_ms": 1.0, "host_ms": 1.0}


MAP = [  # two tiles, both fused
    span("coverage.map"),  # 0
    span("tile", 0),  # 1
    span("kernel.trace", 1),  # 2
    span("em", 1),  # 3
    span("kernel.em", 3),  # 4
    span("tile", 0),  # 5
    span("kernel.trace", 5),  # 6
    span("em", 5),  # 7
    span("kernel.em", 7),  # 8
]
STEP = [  # pass 1's two tiles fused, pass 3's two on the plain chain
    span("step"),  # 0
    span("step.pass1", 0),  # 1
    span("tile", 1),  # 2
    span("em", 2),  # 3
    span("kernel.em", 3),  # 4
    span("tile", 1),  # 5
    span("em", 5),  # 6
    span("kernel.em", 6),  # 7
    span("step.pass3", 0),  # 8
    span("tile", 8),  # 9
    span("em", 9),  # 10
    span("tile", 8),  # 11
    span("em", 11),  # 12
    span("step.backward", 8),  # 13
]
TRACE = {"counters": {"trace": 4}, "bounds_s": {"trace": 1e-3}}


@pytest.fixture
def spans(monkeypatch):
    def give(value):
        monkeypatch.setattr(profiling, "spans", lambda: value)

    return give


@pytest.mark.parametrize(("name", "tree", "want"), [("em.fused_pct.map", MAP, 100.0), ("em.fused_pct.step", STEP, 50.0)])
def test_share_of_fused_tiles(spans, name, tree, want):
    spans(tree)
    assert harness.metric_reader(name)(TRACE) == pytest.approx(want)


def test_a_kernel_span_outside_any_tile_fuses_no_tile(spans):
    spans([*STEP, span("kernel.em", 0)])
    assert harness.metric_reader("em.fused_pct.step")(TRACE) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["em.fused_pct.map", "em.fused_pct.step"])
def test_reads_nothing_without_the_kernel_span(spans, monkeypatch, name):
    reader = harness.metric_reader(name)
    spans([s for s in STEP if s["name"] != "kernel.em"])  # a program without the fused kernel (the parent)
    assert reader(TRACE) is None
    spans([])
    assert reader(TRACE) is None
    spans([span("kernel.em")])  # no tile
    assert reader(TRACE) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert reader(TRACE) is None
