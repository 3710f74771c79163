"""The ``tile.prep_reuse`` reader on synthetic span lists: fused tiles per plan of a candidate set."""

import pytest

from differt_tpu_torch import profiling
from portbench import harness


def span(name, parent=None) -> dict:
    return {"name": name, "parent": parent, "device_ms": 1.0, "host_ms": 1.0}


MAP = [  # one plan, three fused tiles
    span("coverage.map"),  # 0
    span("tile.prep", 0),  # 1
    *[s for t in (2, 6, 10) for s in (
        span("tile", 0),  # t
        span("kernel.trace", t),
        span("em", t),
        span("kernel.em", t + 2),
    )],
]
STEP = [  # pass 1: a plan for each of two sets, three fused tiles; pass 3: two plain tiles
    span("step"),  # 0
    span("step.pass1", 0),  # 1
    span("tile.prep", 1),  # 2
    span("tile.prep", 1),  # 3
    span("tile", 1),  # 4
    span("em", 4),  # 5
    span("kernel.em", 5),  # 6
    span("tile", 1),  # 7
    span("em", 7),  # 8
    span("kernel.em", 8),  # 9
    span("tile", 1),  # 10
    span("em", 10),  # 11
    span("kernel.em", 11),  # 12
    span("step.pass3", 0),  # 13
    span("tile", 13),  # 14
    span("em", 14),  # 15
    span("tile", 13),  # 16
    span("em", 16),  # 17
    span("kernel.em", 0),  # outside any tile: fuses no tile
]
TRACE = {"counters": {"trace": 5}, "bounds_s": {"trace": 1e-3}}


@pytest.fixture
def spans(monkeypatch):
    def give(value):
        monkeypatch.setattr(profiling, "spans", lambda: value)

    return give


@pytest.mark.parametrize(("name", "tree", "want"), [("tile.prep_reuse.map", MAP, 3.0), ("tile.prep_reuse.step", STEP, 1.5)])
def test_fused_tiles_per_plan(spans, name, tree, want):
    spans(tree)
    assert harness.metric_reader(name)(TRACE) == pytest.approx(want)


@pytest.mark.parametrize("name", ["tile.prep_reuse.map", "tile.prep_reuse.step"])
def test_reads_nothing_without_the_prep_span(spans, monkeypatch, name):
    reader = harness.metric_reader(name)
    spans([s for s in STEP if s["name"] != "tile.prep"])  # a program that lays out each tile's inputs (the parent)
    assert reader(TRACE) is None
    spans([])
    assert reader(TRACE) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert reader(TRACE) is None


def test_a_plan_whose_tiles_took_the_plain_chain_reads_zero(spans):
    spans([span("coverage.map"), span("tile.prep", 0), span("tile", 0), span("em", 2)])
    assert harness.metric_reader("tile.prep_reuse.map")(TRACE) == 0.0
