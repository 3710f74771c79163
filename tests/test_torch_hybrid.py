"""Parity of the port's hybrid tracer with the JAX package: visibility, the candidate DFS, and ``Scene.trace_paths``.

Scenes cross over through ``interop``; random masks come from
``numpy.random.default_rng``. Tolerances:

- visibility masks, candidates and path masks: equal. The visibility test
  runs the JAX side under ``jax.disable_jit()``, op by op as the port runs
  (the lattice and the closest-hit scan of both packages then take the same
  roundings, whatever the scene); the hybrid tests run it jitted, which on
  these scenes marks the same triangles;
- vertices of valid paths: ``atol=1e-4``;
- power maps: within 0.1 dB (``assert_maps_close``).
"""

import dataclasses
import doctest
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differt_tpu.native as jax_native
from differt_tpu import coverage as jax_coverage
from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import concatenate_paths as jax_concatenate_paths
from differt_tpu.rt import HybridPathTracer as JaxHybrid
from differt_tpu_torch import coverage, native
from differt_tpu_torch.geometry import (
    SizedIterator,
    TracedPaths,
    concatenate_paths,
    generate_filtered_path_candidates,
    generate_path_candidates,
)
from differt_tpu_torch.ops import _closest
from differt_tpu_torch.rt import ExhaustivePathTracer, HybridPathTracer
from differt_tpu_torch.rt._solvers import _SOLVER_REGISTRY, SBRPathLauncher

from .torch_parity import assert_maps_close, to_torch_scene

torch.set_num_threads(1)

FREQUENCY = 2.4e9
NUM_RAYS = 4000


def canyon() -> JaxScene:
    """The street canyon (26 triangles), a TX above the street and four receivers in it."""
    return JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]),
        receivers=jnp.array([[x, y, 1.5] for x in (-20.0, 25.0) for y in (-4.0, 3.0)]),
        mesh=jax_scenes.street_canyon_scene().mesh,
    )


def corridor(*, quads: bool = False) -> JaxScene:
    """An open-ended box corridor along x (``tests/test_solvers.py``), TX and RX inside."""
    mesh = JaxMesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
    if quads:
        mesh = mesh.set_assume_quads()
    return JaxScene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0]]),
        receivers=jnp.array([[4.0, 0.0, 0.0], [3.0, 0.5, 0.3]]),
        mesh=mesh,
    )


def with_mask(scene: JaxScene, seed: int) -> JaxScene:
    mask = np.random.default_rng(seed).random(scene.mesh.num_triangles) >= 0.25
    return dataclasses.replace(scene, mesh=scene.mesh.set_mask(jnp.asarray(mask)))


SCENES = {
    "canyon": canyon,
    "canyon_masked": lambda: with_mask(canyon(), 3),
    "corridor": corridor,
    "canyon_quads": lambda: dataclasses.replace(canyon(), mesh=canyon().mesh.set_assume_quads()),
}


# -- Visibility -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["canyon", "canyon_masked", "corridor"])
def test_visibility_masks_equal(name: str) -> None:
    scene = SCENES[name]()
    vertices = np.array([[-30.0, 0.0, 20.0], [10.0, 3.0, 1.5], [0.0, -8.0, 30.0]], np.float32)
    if name == "corridor":
        vertices = np.array([[-4.0, 0.1, 0.2], [4.0, 0.0, 0.0], [0.0, 0.0, 10.0]], np.float32)
    with jax.disable_jit():
        want = np.asarray(scene.mesh.triangles_visible_from_vertex(jnp.asarray(vertices), num_rays=NUM_RAYS))
    mesh = to_torch_scene(scene).mesh
    calls = _closest.REFERENCE_CALLS
    got = mesh.triangles_visible_from_vertex(torch.from_numpy(vertices), num_rays=NUM_RAYS)
    assert _closest.REFERENCE_CALLS == calls + 1  # the plain scan, counted once per call
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any(axis=-1).all() and not want.all()
    # One vertex at a time gives each row of the batch.
    single = mesh.triangles_visible_from_vertex(torch.from_numpy(vertices[1]), num_rays=NUM_RAYS)
    np.testing.assert_array_equal(single.numpy(), want[1])


def test_visibility_cuts_the_graph_and_handles_tiles() -> None:
    mesh = to_torch_scene(canyon()).mesh
    vertex = torch.tensor([[-30.0, 0.0, 20.0]], requires_grad=True)
    vertices = mesh.vertices.clone().requires_grad_()
    moved = dataclasses.replace(mesh, vertices=vertices)
    got = moved.triangles_visible_from_vertex(vertex, num_rays=1000)
    assert not got.requires_grad
    # The ray tiles do not change the result.
    whole = moved.triangles_visible_from_vertex(vertex, num_rays=1000, batch_size=None)
    tiled = moved.triangles_visible_from_vertex(vertex, num_rays=1000, batch_size=97)
    assert torch.equal(whole, got) and torch.equal(tiled, got)


def test_visibility_groups_cover_every_vertex() -> None:
    from differt_tpu_torch.ops._dispatch import VISIBILITY_RAYS, visibility_groups

    for num_vertices, num_rays in ((1, 1_000_000), (129, 1_000_000), (5, 10), (3, VISIBILITY_RAYS * 2)):
        groups = visibility_groups(num_vertices, num_rays)
        assert groups[0][0] == 0 and groups[-1][1] == num_vertices
        assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
        assert all(hi > lo for lo, hi in groups)
        assert all((hi - lo) * num_rays <= max(VISIBILITY_RAYS, num_rays) for lo, hi in groups)


# -- The candidate DFS --------------------------------------------------------------


@pytest.mark.parametrize("filters", ["all", "from_to", "mask_only", "none"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_native_dfs_matches_jax_and_fallback(order: int, filters: str) -> None:
    rng = np.random.default_rng(10 * order + len(filters))
    num = 11
    masks = {key: rng.random(num) >= 0.4 for key in ("from_adjacency", "to_adjacency", "node_mask")}
    if filters == "from_to":
        masks["node_mask"] = None
    elif filters == "mask_only":
        masks["from_adjacency"] = masks["to_adjacency"] = None
    elif filters == "none":
        masks = dict.fromkeys(masks)
    want = jax_native.filtered_path_candidates(num, order, **masks)
    port_masks = {k: None if v is None else torch.from_numpy(v) for k, v in masks.items()}
    assert native.is_available()
    calls = native.CALLS
    got = native.filtered_path_candidates(num, order, **port_masks, device="cpu")
    assert native.CALLS == calls + 1
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    fallbacks = native.FALLBACK_CALLS
    plain = native.filtered_path_candidates_chunked(num, order, **port_masks, device="cpu", chunk_size=37)
    assert native.FALLBACK_CALLS == fallbacks + 1
    np.testing.assert_array_equal(plain.numpy(), want)
    if filters == "none":  # no filter: the exhaustive decode
        np.testing.assert_array_equal(got.numpy(), generate_path_candidates(num, order, device="cpu").numpy())


def test_native_builds_from_the_source_into_build_native() -> None:
    path = native.library_path()
    assert native.is_available() and path.is_file()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.library_path() == path  # keyed on the source's hash


def test_filtered_candidates_warn_above_the_limit() -> None:
    with pytest.warns(UserWarning, match="exhaustive chunked enumeration"):
        got = generate_filtered_path_candidates(6, 2, lambda c: c[:, 0] == c[:, 1] + 1, warn_above=10, device="cpu")
    assert got.tolist() == [[1, 0], [2, 1], [3, 2], [4, 3], [5, 4]]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        generate_filtered_path_candidates(6, 2, lambda c: c[:, 0] > 3, warn_above=30, device="cpu")
    full = generate_path_candidates(12, 3, device="cpu")
    small_chunks = generate_filtered_path_candidates(12, 3, lambda c: c[:, 0] % 2 == 0, chunk_size=97, device="cpu")
    assert torch.equal(small_chunks, full[full[:, 0] % 2 == 0])


# -- The hybrid tracer --------------------------------------------------------------


@pytest.mark.parametrize("name", ["canyon", "canyon_masked", "canyon_quads"])
@pytest.mark.parametrize("order", [1, 2])
def test_hybrid_candidates_equal(name: str, order: int, monkeypatch) -> None:
    scene = SCENES[name]()
    want, want_types = JaxHybrid(num_rays=NUM_RAYS).generate_path_candidates(scene, order)
    tracer = HybridPathTracer(num_rays=NUM_RAYS)
    port = to_torch_scene(scene)
    calls, fallbacks = native.CALLS, native.FALLBACK_CALLS
    got, types = tracer.generate_path_candidates(port, order)
    assert (native.CALLS, native.FALLBACK_CALLS) == (calls + 1, fallbacks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(types.numpy(), np.asarray(want_types))
    assert 0 < got.shape[0] < ExhaustivePathTracer().generate_path_candidates(port, order)[0].shape[0]
    # Without the DFS, the chunked fallback gives the same rows, counted.
    monkeypatch.setattr(native, "is_available", lambda: False)
    plain, _ = tracer.generate_path_candidates(port, order)
    assert native.FALLBACK_CALLS == fallbacks + 1
    assert torch.equal(plain, got)


@pytest.mark.parametrize("name", ["canyon", "corridor"])
def test_hybrid_paths_match_jax_and_are_exhaustive_paths(name: str) -> None:
    scene = SCENES[name]()
    want = scene.trace_paths(order=1, solver="hybrid", num_rays=NUM_RAYS)
    port = to_torch_scene(scene)
    got = port.trace_paths(order=1, solver="hybrid", num_rays=NUM_RAYS)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.objects.numpy(), np.asarray(want.objects))
    valid = np.asarray(want.mask)
    np.testing.assert_allclose(got.vertices.numpy()[valid], np.asarray(want.vertices)[valid], atol=1e-4)
    # Every valid hybrid path is a valid exhaustive path (JAX tests/test_solvers.py).
    exhaustive = port.trace_paths(order=1)
    hybrid_rows = {tuple(r) for r in got.masked_objects.tolist()}
    exhaustive_rows = {tuple(r) for r in exhaustive.masked_objects.tolist()}
    assert hybrid_rows and hybrid_rows <= exhaustive_rows
    ex_points = exhaustive.masked_vertices[:, 1]
    for point in got.masked_vertices[:, 1]:
        assert float((ex_points - point).abs().amax(dim=-1).min()) < 1e-3


def test_hybrid_needs_an_order_and_warns_about_smoothing() -> None:
    port = to_torch_scene(canyon())
    with pytest.raises(ValueError, match="needs an explicit 'order'"):
        port.trace_paths(path_candidates=torch.zeros((1, 1), dtype=torch.int64), solver="hybrid")
    with pytest.warns(UserWarning, match="smoothing_factor"):
        port.trace_paths(order=1, solver="hybrid", num_rays=500, smoothing_factor=10.0)
    with pytest.raises(ValueError, match="conflict"):
        port.trace_paths(order=1, solver=HybridPathTracer(num_rays=500), num_rays=10)
    with pytest.raises(ValueError, match="No solver is registered"):
        port.trace_paths(order=1, solver="fermat")
    assert _SOLVER_REGISTRY == {
        "exhaustive": ExhaustivePathTracer, "hybrid": HybridPathTracer, "sbr": SBRPathLauncher,
    }


@pytest.mark.parametrize("entry", ["power_map", "power_map_chunked"])
def test_hybrid_maps_match_jax(entry: str) -> None:
    scene = JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]), mesh=jax_scenes.street_canyon_scene().mesh
    ).with_receivers_grid(6, 6)
    port = to_torch_scene(scene)
    kw = {"order": 1, "solver": "hybrid", "num_rays": 3000}
    if entry == "power_map":
        want = jax_coverage.power_map(scene, FREQUENCY, **kw)
    else:
        want = jax_coverage.power_map_chunked(
            scene, FREQUENCY, order=1, solver=JaxHybrid(num_rays=3000), candidate_chunk=8, rx_chunk=12
        )
    if entry == "power_map":
        got = coverage.power_map(port, FREQUENCY, **kw)
    else:
        got = coverage.power_map_chunked(
            port, FREQUENCY, order=1, solver=HybridPathTracer(num_rays=3000), candidate_chunk=8, rx_chunk=12
        )
    assert_maps_close(got.numpy(), np.asarray(want))
    # Pruning only drops paths: no pixel of the incoherent map gains power.
    kw["coherent"] = False
    pruned = coverage.power_map(port, FREQUENCY, **kw)
    exhaustive = coverage.power_map(port, FREQUENCY, order=1, coherent=False)
    assert bool((pruned <= exhaustive * (1 + 1e-5)).all()) and bool((pruned > 0).any())


# -- Scene.trace_paths ----------------------------------------------------------------


def test_trace_paths_sequence_of_orders() -> None:
    scene = corridor()
    port = to_torch_scene(scene)
    per_order = port.trace_paths(order=[0, 1, 2])
    assert isinstance(per_order, SizedIterator) and len(per_order) == 3
    batches = list(per_order)
    assert [b.order for b in batches] == [0, 1, 2]
    for o, batch in enumerate(batches):
        single = port.trace_paths(order=o)
        assert torch.equal(batch.mask, single.mask) and torch.equal(batch.vertices, single.vertices)
    # Merged: one container padded to order 2, equal to JAX's.
    merged = port.trace_paths(order=[0, 1, 2], merge_orders=True)
    want = jax_concatenate_paths(list(scene.trace_paths(order=[0, 1, 2])))
    assert isinstance(merged, TracedPaths) and merged.order == 2
    assert merged.shape == tuple(want.shape)
    np.testing.assert_array_equal(merged.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(merged.objects.numpy(), np.asarray(want.objects))
    np.testing.assert_array_equal(merged.interaction_types.numpy(), np.asarray(want.interaction_types))
    valid = np.asarray(want.mask)
    np.testing.assert_allclose(merged.vertices.numpy()[valid], np.asarray(want.vertices)[valid], atol=1e-4)
    assert merged.num_valid_paths == sum(b.num_valid_paths for b in batches)
    # A merged map equals the sum of the per-order maps: padding is a no-op for the EM chain.
    kw = {"eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}
    merged_power = coverage.received_power(merged, port, FREQUENCY, coherent=False, **kw)
    summed = sum(coverage.received_power(b, port, FREQUENCY, coherent=False, **kw) for b in batches)
    torch.testing.assert_close(merged_power, summed, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("solver", ["exhaustive", "hybrid"])
def test_trace_paths_chunks_give_the_same_paths(solver: str) -> None:
    port = to_torch_scene(corridor())
    kw = {"num_rays": 2000} if solver == "hybrid" else {}
    whole = port.trace_paths(order=2, solver=solver, **kw)
    chunks = port.trace_paths(order=2, solver=solver, chunk_size=7, **kw)
    assert isinstance(chunks, SizedIterator)
    num_chunks = len(chunks)
    parts = list(chunks)
    assert len(parts) == num_chunks == -(-whole.shape[-1] // 7)
    assert torch.equal(torch.cat([p.mask for p in parts], dim=-1), whole.mask)
    assert torch.equal(torch.cat([p.objects for p in parts], dim=-2), whole.objects)
    # Several orders with a chunk size: the chunks of each order in turn.
    chained = list(port.trace_paths(order=[1, 2], solver=solver, chunk_size=7, **kw))
    assert sum(p.shape[-1] for p in chained) == sum(
        port.trace_paths(order=o, solver=solver, **kw).shape[-1] for o in (1, 2)
    )


@pytest.mark.parametrize("solver", ["exhaustive", "hybrid"])
def test_tracer_trace_paths_matches_jax(solver: str) -> None:
    """The tracer's own ``trace_paths`` (the dispatch under ``Scene.trace_paths``) against JAX's."""
    from differt_tpu.rt import ExhaustivePathTracer as JaxExhaustive

    scene = corridor()
    port = to_torch_scene(scene)
    if solver == "hybrid":
        want_tracer, tracer = JaxHybrid(num_rays=NUM_RAYS), HybridPathTracer(num_rays=NUM_RAYS)
    else:
        want_tracer, tracer = JaxExhaustive(), ExhaustivePathTracer()
    want = list(want_tracer.trace_paths(scene, [0, 1]))
    got = tracer.trace_paths(port, [0, 1])
    assert isinstance(got, SizedIterator) and len(got) == 2
    got = list(got)
    assert [p.order for p in got] == [0, 1]
    for g, w in zip(got, want, strict=True):
        assert g.shape == tuple(w.shape)
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        np.testing.assert_array_equal(g.objects.numpy(), np.asarray(w.objects))
        valid = np.asarray(w.mask)
        np.testing.assert_allclose(g.vertices.numpy()[valid], np.asarray(w.vertices)[valid], atol=1e-4)
    # One order in chunks: a SizedIterator of the same paths.
    chunks = tracer.trace_paths(port, 1, chunk_size=7)
    assert isinstance(chunks, SizedIterator) and len(chunks) == -(-got[1].shape[-1] // 7)
    assert torch.equal(torch.cat([c.mask for c in chunks], dim=-1), got[1].mask)


def test_exhaustive_multi_order_and_disconnect_inactive_triangles() -> None:
    scene = with_mask(corridor(), 5)
    port = to_torch_scene(scene)
    tracer = ExhaustivePathTracer(disconnect_inactive_triangles=True)
    cands, types = tracer.generate_path_candidates(port, (1, 2))
    want, _ = scene_tracer_candidates(scene, (1, 2))
    assert isinstance(cands, tuple) and len(cands) == 2 and len(types) == 2
    for c, w in zip(cands, want):
        np.testing.assert_array_equal(c.numpy(), np.asarray(w))
    mask = port.mesh.mask
    assert bool(mask[cands[1]].all())
    # The disconnected trace keeps every valid path of the full one.
    full = port.trace_paths(order=2)
    pruned = port.trace_paths(order=2, disconnect_inactive_triangles=True)
    assert pruned.shape[-1] < full.shape[-1] and pruned.num_valid_paths == full.num_valid_paths
    traced = tracer.trace_path_candidates(port, cands, types)
    assert traced.order == 2 and traced.shape[-1] == sum(c.shape[0] for c in cands)
    # The default chunk iterator of the base class: padded tails.
    chunks = list(tracer.generate_path_candidates_chunks_iter(port, 1, chunk_size=4, pad_chunks=True))
    assert all(c.shape[0] == 4 for c, _ in chunks) and int((chunks[-1][0] == -1).sum()) >= 0


def scene_tracer_candidates(scene, orders):
    from differt_tpu.rt import ExhaustivePathTracer as JaxExhaustive

    return JaxExhaustive(disconnect_inactive_triangles=True).generate_path_candidates(scene, orders)


def test_masked_paths_and_compute_paths_alias() -> None:
    scene = corridor()
    port = to_torch_scene(scene)
    paths = port.trace_paths(order=1)
    want = scene.trace_paths(order=1).masked()
    masked = paths.masked()
    assert masked.shape == (paths.num_valid_paths,) and bool(masked.mask.all())
    np.testing.assert_allclose(paths.masked_vertices.numpy(), np.asarray(want.vertices), atol=1e-4)
    np.testing.assert_array_equal(paths.masked_objects.numpy(), np.asarray(want.objects))
    with pytest.warns(DeprecationWarning, match="compute_paths"):
        alias = port.compute_paths(order=1)
    assert torch.equal(alias.mask, paths.mask)
    with pytest.warns(DeprecationWarning):
        launched = port.compute_paths(order=1, method="sbr", num_rays=200)
    assert launched.masks.shape[-1] == 2
    with pytest.raises(ValueError, match="Cannot pad"):
        paths.pad_order(0)
    with pytest.raises(ValueError, match="at least one"):
        concatenate_paths([])


@pytest.mark.parametrize(
    "name",
    [
        "differt_tpu_torch.native",
        "differt_tpu_torch.geometry._candidates",
        "differt_tpu_torch.geometry._paths",
        "differt_tpu_torch.geometry._mesh",
        "differt_tpu_torch.rt._scan",
        "differt_tpu_torch.ops._dispatch",
    ],
)
def test_doctests(name: str) -> None:
    result = doctest.testmod(importlib.import_module(name), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
