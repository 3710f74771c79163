"""The port's ``profiling`` module against the JAX package's."""

import json

import jax.numpy as jnp
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
