"""Parity of the port's first-order diffraction (``rt/_diffraction.py``, ``power_map(with_diffraction=True)``) with the JAX package.

Two scenes cross over through ``interop``: the single-wedge occluder box of
``tests/test_diffraction.py`` (a metal box under an elevated TX) with 8
receivers around its shadow, and the street canyon with 8 receivers in the
street. Tolerances: masks, objects and interaction types equal; vertices
``atol=1e-5`` m; amplitudes, PEC and lossy, within 1e-4 of the largest
(the same paths in both packages); power maps within 0.01 dB; TX gradients
``rtol=1e-3``.

The amplitudes' JAX side runs op by op (``jax.disable_jit()``, as the port
runs, and without ``jax_debug_nans``: the reference's discarded ``where``
branches compute NaN): XLA's fusion of the jitted transition function costs
it up to 5e-4 (``tests/test_torch_utd.py``).
"""

import contextlib
import dataclasses
import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import coverage as jax_coverage
from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.rt import diffraction_amplitudes as jax_diffraction_amplitudes
from differt_tpu.rt import diffraction_point_on_edge as jax_point_on_edge
from differt_tpu_torch import coverage
from differt_tpu_torch.geometry import TracedPaths
from differt_tpu_torch.rt import DiffractionPathTracer, diffraction_amplitudes, diffraction_point_on_edge

from .torch_parity import assert_maps_close, to_torch_scene

FREQUENCY = 2.4e9
VERTEX_ATOL = 1e-5
AMPLITUDE_RTOL = 1e-4
MAP_TOL_DB = 0.01
GRAD_RTOL = 1e-3


@contextlib.contextmanager
def _op_by_op():
    with jax.disable_jit(), jax.debug_nans(False):
        yield


def _occluder() -> JaxScene:
    # The elevated TX looks down past the box's far top edge; the receivers
    # sit in its shadow, on its boundary and in the lit region beside it.
    rx = np.array(
        [[10, 0, -3], [10, 0, -2.27], [10, 0, 0], [10, 2, -1], [8, -1, -2.5], [12, 1, -2], [5, 0, -3], [10, -4, -2]],
        dtype=np.float32,
    )
    return JaxScene(
        transmitters=jnp.array([[-10.0, 0.0, 5.0]]),
        receivers=jnp.asarray(rx),
        mesh=JaxMesh.box(2.0, 6.0, 2.0, with_top=True).set_materials("Metal"),
    )


def _canyon() -> JaxScene:
    rx = np.array([[x, y, 1.5] for x in (-20.0, 0.0, 20.0, 35.0) for y in (-3.0, 3.0)], dtype=np.float32)
    scene = jax_scenes.street_canyon_scene()
    return JaxScene(transmitters=jnp.array([[-30.0, 0.0, 20.0]]), receivers=jnp.asarray(rx), mesh=scene.mesh)


SCENES = ("occluder", "canyon")


@functools.cache
def _scene(name: str) -> JaxScene:
    """The JAX scene of the parity tests named ``name``, built at first use."""
    return {"occluder": _occluder, "canyon": _canyon}[name]()


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_err(port, ref) -> float:
    port, ref = _np(port), _np(ref)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def test_point_on_edge_matches() -> None:
    rng = np.random.default_rng(0)
    args = [rng.uniform(-20.0, 20.0, (500, 3)).astype(np.float32) for _ in range(4)]
    point, t = diffraction_point_on_edge(*(torch.from_numpy(a) for a in args))
    ref_point, ref_t = jax_point_on_edge(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(_np(point), _np(ref_point), atol=VERTEX_ATOL, rtol=1e-6)
    np.testing.assert_allclose(_np(t), _np(ref_t), atol=1e-5, rtol=1e-6)
    # The Keller condition: equal angles with the edge on both sides.
    e = torch.nn.functional.normalize(torch.from_numpy(args[3]), dim=-1)
    k_in = torch.nn.functional.normalize(point - torch.from_numpy(args[0]), dim=-1)
    k_out = torch.nn.functional.normalize(torch.from_numpy(args[1]) - point, dim=-1)
    torch.testing.assert_close((k_in * e).sum(-1), (k_out * e).sum(-1), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", SCENES)
def test_trace_diffraction_paths_match(name: str) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    ref = ref_scene.trace_diffraction_paths()
    paths = scene.trace_diffraction_paths()
    assert paths.shape == ref.mask.shape
    np.testing.assert_array_equal(_np(paths.mask), _np(ref.mask))
    np.testing.assert_array_equal(_np(paths.objects), _np(ref.objects))
    np.testing.assert_array_equal(_np(paths.interaction_types), _np(ref.interaction_types))
    np.testing.assert_allclose(_np(paths.vertices), _np(ref.vertices), atol=VERTEX_ATOL, rtol=0)
    assert paths.mask.any() and not paths.mask.all()


def test_tracer_options_reach_the_trace() -> None:
    scene = to_torch_scene(_scene("occluder"))
    paths = scene.trace_diffraction_paths()
    # A minimum length beyond every segment leaves no valid path.
    assert not scene.trace_diffraction_paths(min_len=1e6).mask.any()
    assert DiffractionPathTracer(hit_tol=1e-4).trace_paths(scene).mask.any()
    # Deduplicated vertices come in another order, and so do the edges: the
    # same valid paths, in another order.
    unique = dataclasses.replace(scene, mesh=scene.mesh.dedup_vertices()).trace_diffraction_paths()
    rows = lambda p: np.unique(np.round(_np(p.masked().vertices).reshape(-1, 9), 4), axis=0)  # noqa: E731
    np.testing.assert_array_equal(rows(unique), rows(paths))


def _edges_info(mesh):
    mesh = mesh if mesh.assume_unique_vertices else mesh.dedup_vertices()
    return dict(zip(("edges", "adjacent_triangles", "wedge_n"), mesh._diffraction_edges_info()))


@pytest.mark.parametrize("lossy", [False, True], ids=["pec", "lossy"])
@pytest.mark.parametrize("name", SCENES)
def test_diffraction_amplitudes_match(name: str, lossy: bool) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    ref_paths = ref_scene.trace_diffraction_paths()
    # The same paths in both packages: the amplitudes alone are compared.
    paths = dataclasses.replace(
        scene.trace_diffraction_paths(), vertices=torch.from_numpy(np.array(ref_paths.vertices))
    )
    num_materials = max(len(ref_scene.mesh.material_names), 1)
    materials = {}
    if lossy:
        materials = {
            "eta_r": np.linspace(3.0, 6.0, num_materials, dtype=np.float32),
            "conductivity": np.linspace(0.01, 0.2, num_materials, dtype=np.float32),
        }
    a = diffraction_amplitudes(
        paths, scene, FREQUENCY, **_edges_info(scene.mesh), **{k: torch.from_numpy(v) for k, v in materials.items()}
    )
    with _op_by_op():
        ref = jax_diffraction_amplitudes(
            ref_paths, ref_scene, FREQUENCY, **_edges_info(ref_scene.mesh), **{k: jnp.asarray(v) for k, v in materials.items()}
        )
    assert a.dtype == torch.complex64 and a.shape == paths.shape
    assert torch.isfinite(torch.view_as_real(a)).all()
    assert _rel_err(a, ref) <= AMPLITUDE_RTOL
    assert (a[~paths.mask] == 0).all() and (a[paths.mask] != 0).all()


def test_amplitudes_weight_by_a_confidence() -> None:
    """A float mask weights each path, as in the reference: a path below the
    confidence threshold runs on the dummy path, times its confidence."""
    scene = to_torch_scene(_scene("occluder"))
    paths = scene.trace_diffraction_paths()
    info = _edges_info(scene.mesh)
    hard = diffraction_amplitudes(paths, scene, FREQUENCY, **info)
    confidence = torch.where(paths.mask, 0.75, 0.25)
    soft = diffraction_amplitudes(dataclasses.replace(paths, mask=confidence), scene, FREQUENCY, **info)
    torch.testing.assert_close(soft[paths.mask], 0.75 * hard[paths.mask])
    dummy = diffraction_amplitudes(
        dataclasses.replace(paths, mask=torch.full_like(confidence, 0.25)), scene, FREQUENCY, **info
    )
    torch.testing.assert_close(soft[~paths.mask], dummy[~paths.mask])


@pytest.mark.parametrize("coherent", [True, False], ids=["coherent", "incoherent"])
@pytest.mark.parametrize("name", SCENES)
def test_power_map_with_diffraction_matches(name: str, coherent: bool) -> None:
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    power = coverage.power_map(scene, FREQUENCY, order=1, with_diffraction=True, coherent=coherent)
    ref = jax_coverage.power_map(ref_scene, FREQUENCY, order=1, with_diffraction=True, coherent=coherent)
    assert power.shape == ref.shape
    assert_maps_close(_np(power), _np(ref), tol_db=MAP_TOL_DB)
    # Diffraction lights receivers that order 1 leaves dark, or adds to them.
    specular = coverage.power_map(scene, FREQUENCY, order=1, coherent=coherent)
    assert not torch.equal(power, specular)


@pytest.mark.parametrize("name", SCENES)
def test_power_map_tx_gradient_matches(name: str) -> None:
    """The TX gradient of the map's total power. The specular half's walls
    are a concrete-like dielectric here: with the ITU metal, both packages'
    slab branch overflows, and its discarded backward sends NaN to the TX."""
    ref_scene = _scene(name)
    scene = to_torch_scene(ref_scene)
    num_materials = max(len(ref_scene.mesh.material_names), 1)
    materials = {"eta_r": np.full(num_materials, 5.24, np.float32), "conductivity": np.full(num_materials, 0.1, np.float32)}
    tx = scene.transmitters.clone().requires_grad_()
    power = coverage.power_map(
        dataclasses.replace(scene, transmitters=tx), FREQUENCY, order=1, with_diffraction=True,
        **{k: torch.from_numpy(v) for k, v in materials.items()},
    )
    scale = float(power.detach().sum())
    (power.sum() / scale).backward()

    def loss(tx):
        scene = JaxScene(transmitters=tx, receivers=ref_scene.receivers, mesh=ref_scene.mesh)
        power = jax_coverage.power_map(
            scene, FREQUENCY, order=1, with_diffraction=True, **{k: jnp.asarray(v) for k, v in materials.items()}
        )
        return jnp.sum(power) / scale

    with jax.debug_nans(False):  # NaN in the reference's discarded branches
        ref = _np(jax.grad(loss)(ref_scene.transmitters))
    grad = _np(tx.grad)
    assert np.isfinite(grad).all() and np.abs(grad).max() > 0
    assert np.linalg.norm(grad - ref) <= GRAD_RTOL * np.linalg.norm(ref)


def test_power_map_without_the_flag_is_unchanged() -> None:
    scene = to_torch_scene(_scene("canyon"))
    materials = coverage.resolve_materials(scene, torch.tensor(FREQUENCY), None, None, None)
    eta_r, conductivity, thickness = materials
    want = coverage.received_power(
        scene.trace_paths(order=1), scene, torch.tensor(FREQUENCY), eta_r=eta_r, conductivity=conductivity, thickness=thickness
    )
    assert torch.equal(coverage.power_map(scene, FREQUENCY, order=1), want)
    assert torch.equal(coverage.power_map(scene, FREQUENCY, order=1, with_diffraction=False), want)


@pytest.mark.parametrize("option", ["scattering", "mixed"])
def test_power_map_options_add_their_parts(option: str) -> None:
    """``with_scattering`` and ``mixed_signatures`` are taken (they raised
    until they were ported), and the map is the sum of its parts."""
    from differt_tpu_torch.em import z_0
    from differt_tpu_torch.rt import mixed_amplitudes, scattering_amplitudes

    scene = to_torch_scene(_scene("canyon"))
    materials = {"eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}
    frequency = torch.tensor(FREQUENCY)
    eta_r, conductivity, thickness = coverage.resolve_materials(scene, frequency, materials["eta_r"], materials["conductivity"], None)
    a_spec = coverage.complex_amplitudes(
        scene.trace_paths(order=1), scene, frequency, eta_r=eta_r, conductivity=conductivity, thickness=thickness
    )
    if option == "scattering":
        power = coverage.power_map(scene, FREQUENCY, order=1, coherent=False, with_scattering=True, scattering_coefficient=0.3, **materials)
        paths = scene.trace_scattering_paths()
        a_extra = scattering_amplitudes(paths, scene, frequency, scattering_coefficient=0.3, **materials)
        a_spec = a_spec * (1.0 - 0.3**2) ** 0.5
    else:
        power = coverage.power_map(scene, FREQUENCY, order=1, coherent=False, mixed_signatures=[(0, 1)], **materials)
        paths = scene.trace_mixed_paths((0, 1))
        a_extra = mixed_amplitudes(paths, scene, frequency, **_edges_info(scene.mesh), **materials)
    assert paths.mask.any()
    parts = (torch.abs(a_spec) ** 2).sum(-1) / z_0 + (torch.abs(a_extra) ** 2).sum(-1).reshape(a_spec.shape[:-1]) / z_0
    torch.testing.assert_close(power, parts.reshape(power.shape), rtol=1e-5, atol=0.0)


def test_traced_paths_are_diffraction_paths() -> None:
    scene = to_torch_scene(_scene("occluder"))
    paths = scene.trace_diffraction_paths()
    assert isinstance(paths, TracedPaths) and paths.order == 1
    assert (paths.interaction_types == 1).all()
    edges = scene.mesh.diffraction_edges
    assert paths.shape == (1, 8, edges.shape[0])


def test_doctests() -> None:
    result = doctest.testmod(importlib.import_module("differt_tpu_torch.rt._diffraction"), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
