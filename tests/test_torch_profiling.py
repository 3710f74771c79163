"""The port's ``profiling`` module against the JAX package's."""

import json

import jax.numpy as jnp
import pytest
import torch

from differt_tpu import profiling as jax_profiling
from differt_tpu_torch import profiling
from differt_tpu_torch.geometry import Mesh, Scene

from . import torch_parity  # noqa: F401  (its first calls of the CPU math)

torch.set_num_threads(1)


def test_timeit_keys_and_order_match_jax() -> None:
    calls = []

    def fn() -> torch.Tensor:
        calls.append(1)
        return torch.ones(8).sum()

    got = profiling.timeit(fn, repeats=3, warmup=2)
    want = jax_profiling.timeit(lambda: jnp.ones(8).sum(), repeats=3, warmup=2)
    assert sorted(got) == sorted(want) == ["max", "mean", "min", "repeats"]
    assert len(calls) == 5 and got["repeats"] == want["repeats"] == 3.0
    assert 0.0 <= got["min"] <= got["mean"] <= got["max"]


def test_synchronize_returns_its_input() -> None:
    scene = Scene(transmitters=torch.zeros((1, 3)), mesh=Mesh.box(device="cpu"))
    for tree in (torch.ones(3), (torch.ones(2), {"a": [torch.zeros(1)], "b": None}), scene, 1.5):
        assert profiling.synchronize(tree) is tree


def test_trace_writes_the_annotated_region(tmp_path) -> None:
    with profiling.trace(tmp_path) as prof, profiling.annotate("differt_region"):
        torch.ones(64).cumsum(0)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(event.get("name") == "differt_region" for event in events)
    assert any(row.key == "differt_region" for row in prof.key_averages())


@pytest.fixture(autouse=True)
def _no_spans_left() -> None:
    profiling.clear_spans()


def _tree(spans: list[dict]) -> dict[str, list[str]]:
    """Each span's name -> the names of its ancestors, innermost first (the last span of each name)."""
    out = {}
    for s in spans:
        chain, parent = [], s["parent"]
        while parent is not None:
            chain.append(spans[parent]["name"])
            parent = spans[parent]["parent"]
        out[s["name"]] = chain
    return out


def test_annotate_is_a_shared_no_op_without_a_profiler(monkeypatch) -> None:
    made = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw))
    profiling.clear_spans()
    span = profiling.annotate("a")
    assert span is profiling.annotate("b")
    with span, profiling.annotate("c"):
        torch.ones(4).sum()
    assert profiling.spans() == [] and made == []


def test_spans_nest_per_thread_under_the_profiler() -> None:
    import threading

    def worker() -> None:
        with profiling.annotate("side"), profiling.annotate("side.inner"):
            torch.ones(4).sum()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("request"):
            with profiling.annotate("outer"):
                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=60)
                with profiling.annotate("inner"):
                    torch.ones(4).sum()
            with profiling.annotate("sibling"):
                pass
        with profiling.annotate("second"):
            pass
    assert not thread.is_alive()
    spans = profiling.spans()
    index = {s["name"]: i for i, s in enumerate(spans)}
    assert sorted(index) == ["inner", "outer", "request", "second", "sibling", "side", "side.inner"]
    parent = {s["name"]: None if s["parent"] is None else spans[s["parent"]]["name"] for s in spans}
    root = {s["name"]: spans[s["root"]]["name"] for s in spans}
    assert parent == {
        "request": None, "outer": "request", "inner": "outer", "sibling": "request",
        "side": None, "side.inner": "side", "second": None,
    }
    assert root == {
        "request": "request", "outer": "request", "inner": "request", "sibling": "request",
        "side": "side", "side.inner": "side", "second": "second",
    }
    assert spans[index["side"]]["thread"] != spans[index["request"]]["thread"]
    for s in spans:
        assert s["device_ms"] is None  # no CUDA on the CPU
        assert s["end_ns"] >= s["start_ns"] and s["host_ms"] == (s["end_ns"] - s["start_ns"]) * 1e-6
    assert profiling.spans() == spans  # reading does not consume
    profiling.clear_spans()
    assert profiling.spans() == []


def test_spans_are_those_of_the_newest_session() -> None:
    def session(name: str) -> None:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), profiling.annotate(name):
            pass

    session("first")
    with profiling.annotate("off"):  # the profiler is off: no span, and the next one starts a session
        pass
    session("second")
    assert [s["name"] for s in profiling.spans()] == ["second"]
    session("third")  # after a read with the profiler off
    assert [s["name"] for s in profiling.spans()] == ["third"]
    session("fourth")
    profiling.clear_spans()
    assert profiling.spans() == []


def test_span_stamps_bracket_their_profiler_events() -> None:
    """Spans stamp ``time.time_ns()``, the clock of Kineto's events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in ("first", "second", "third"):
            with profiling.annotate(name):
                torch.ones(64).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name() in ("first", "second", "third")}
    spans = profiling.spans()
    assert [s["name"] for s in spans] == ["first", "second", "third"]
    for s in spans:
        event = events[s["name"]]
        assert s["start_ns"] <= event.start_ns() <= event.end_ns() <= s["end_ns"]
    assert spans[0]["end_ns"] <= events["second"].start_ns()


def test_spans_time_cuda_events_where_cuda_is_initialised(monkeypatch) -> None:
    class FakeEvent:
        clock = 0.0

        def __init__(self, enable_timing: bool) -> None:
            assert enable_timing
            self.at = None

        def record(self) -> None:
            FakeEvent.clock += 1.5
            self.at = FakeEvent.clock

        def elapsed_time(self, end) -> float:
            return end.at - self.at

    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.annotate("outer"), profiling.annotate("inner"):
            pass
    first = profiling.spans()
    assert [s["device_ms"] for s in first] == [4.5, 1.5]
    assert profiling.spans() == first and len(syncs) == 1  # one synchronise, at the first read


def _scene(rx: tuple[int, int] = (4, 2)) -> Scene:
    mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu").set_materials("Concrete")
    scene = Scene(transmitters=torch.tensor([[-5.0, 0.5, 1.0]]), mesh=mesh)
    return scene.with_receivers_grid(*rx, height=1.0)


def test_power_map_chunked_spans_each_layer() -> None:
    from differt_tpu_torch import native
    from differt_tpu_torch.coverage import power_map_chunked
    from differt_tpu_torch.rt import HybridPathTracer

    scene = _scene()
    solver = HybridPathTracer(num_rays=2000)
    num_candidates = solver.generate_path_candidates(scene, 1)[0].shape[0]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        power_map_chunked(
            scene, 2.4e9, order=1, solver=solver, candidate_chunk=4, rx_chunk=3,
            eta_r=torch.tensor([5.0]), conductivity=torch.tensor([0.1]),
        )
    spans = profiling.spans()
    names = [s["name"] for s in spans]
    tiles = -(-8 // 3) * -(-num_candidates // 4)
    assert names.count("coverage.map") == 1 and names.count("visibility") == 1
    assert names.count("tile") == names.count("em") == tiles > 1
    assert names.count("dfs") == (1 if native.is_available() else 0)
    tree = _tree(spans)
    assert tree["visibility"] == tree["tile"] == ["coverage.map"] and tree["em"] == ["tile", "coverage.map"]
    if native.is_available():
        assert tree["dfs"] == ["coverage.map"]
    assert all(spans[s["root"]]["name"] == "coverage.map" for s in spans)


def test_streamed_placement_step_spans_its_passes() -> None:
    from differt_tpu_torch.geometry import generate_path_candidates
    from differt_tpu_torch.parallel import streamed_placement_step

    scene = _scene()
    candidates = [generate_path_candidates(scene.mesh.num_triangles, k, device="cpu") for k in (1, 2)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        streamed_placement_step(
            scene, 2.4e9, tx=scene.transmitters, eta_r=torch.tensor([5.24]), conductivity=torch.tensor([0.1]),
            path_candidates=candidates, candidate_chunk=64, rx_chunk=3,
        )
    spans = profiling.spans()
    tiles = -(-8 // 3) * sum(-(-c.shape[0] // 64) for c in candidates)
    by_pass = {"step.pass1": 0, "step.pass3": 0}
    for s in spans:
        if s["name"] == "tile":
            by_pass[spans[s["parent"]]["name"]] += 1
    assert by_pass == {"step.pass1": tiles, "step.pass3": tiles}
    names = [s["name"] for s in spans]
    assert names.count("step") == names.count("step.pass1") == names.count("step.pass3") == 1
    assert names.count("step.backward") == tiles and names.count("em") == 2 * tiles
    tree = _tree(spans)
    assert tree["step.pass1"] == tree["step.pass3"] == ["step"]
    assert tree["step.backward"] == ["step.pass3", "step"]
    assert all(spans[s["root"]]["name"] == "step" for s in spans)


def test_a_span_open_across_sessions_is_no_parent() -> None:
    profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    profiler.start()
    with profiling.annotate("outer"):
        profiler.stop()
        assert [s["name"] for s in profiling.spans()] == ["outer"]  # read with the profiler off
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        profiler.start()
        with profiling.annotate("inner"):
            pass
    profiler.stop()
    assert [(s["name"], s["parent"], s["root"]) for s in profiling.spans()] == [("inner", None, 0)]
