"""Parity of the port's mixed reflection/diffraction paths (``rt/_mixed.py``) with the JAX package.

Three scenes cross over through ``interop``, with two receivers each: the
knife edge and the corridor of ``tests/test_mixed.py`` and
``urban_scene(2, 2)`` (146 triangles, 144 edges). Tolerances:

- candidates, objects and interaction types equal;
- masks: the reference's mask takes its blockage op by op (XLA's fused
  any-hit, under ``jit``, flips segments that graze a face: the FMA of
  ``o + t d``); given the reference's points, the port's checks and
  blockage give that mask exactly; on its own points, the port's mask
  equals it wherever the two packages' Fermat points agree within
  ``1e-4`` m;
- vertices of the paths valid in both: within ``1e-4`` m plus the float32
  resolution of the Fermat objective (``torch_parity.fermat_resolution``:
  each package's line search stops where its float32 length no longer
  falls, millimetres to centimetres from the optimum at city scale);
- the amplitudes and maps: ``tests/test_torch_mixed_maps.py``.
"""

import dataclasses
import doctest
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.rt import MixedPathTracer as JaxMixedPathTracer
from differt_tpu.rt import count_mixed_path_candidates as jax_count
from differt_tpu.rt import generate_mixed_path_candidates as jax_generate
from differt_tpu_torch.em import InteractionType
from differt_tpu_torch.rt import (
    MixedPathTracer,
    count_mixed_path_candidates,
    generate_mixed_path_candidates,
    mixed_amplitudes,
)
from differt_tpu_torch.rt import _mixed

from .torch_parity import fermat_resolution, to_torch_scene

R, D = int(InteractionType.REFLECTION), int(InteractionType.DIFFRACTION)
FREQUENCY = 2.4e9
VERTEX_ATOL = 1e-4
NO_BLOCKAGE = 0.5  # hit_tol: origins move half a segment, and the threshold is 0


def _knife() -> JaxScene:
    ground = JaxMesh.plane(jnp.array([0.0, 0.0, 0.0]), normal=jnp.array([0.0, 0.0, 1.0]), side_length=40.0)
    box = JaxMesh.box(2.0, 6.0, 3.0, with_top=True).translate(jnp.array([0.0, 0.0, 1.5]))
    mesh = (ground + box).dedup_vertices().set_materials("Concrete")
    # Above the roof, where one diffraction and reflect-then-diffract reach;
    # in the deep shadow, where double diffraction does.
    return JaxScene(
        transmitters=jnp.array([[-8.0, 0.0, 1.6]]), receivers=jnp.array([[8.0, 0.0, 5.0], [8.0, 0.0, 1.4]]), mesh=mesh
    )


def _corridor() -> JaxScene:
    mesh = JaxMesh.box(10.0, 3.0, 2.0, with_top=True).set_materials("Concrete")
    return JaxScene(
        transmitters=jnp.array([[-4.0, 0.0, 0.0]]), receivers=jnp.array([[4.0, 0.0, 0.0], [3.0, 1.0, 0.5]]), mesh=mesh
    )


def _urban() -> JaxScene:
    # The TX above the central crossing, the receivers in two streets.
    return JaxScene(
        transmitters=jnp.array([[0.0, 0.0, 40.0]]),
        receivers=jnp.array([[50.0, 0.0, 1.5], [0.0, -50.0, 1.5]]),
        mesh=jax_scenes.urban_scene(2, 2).mesh,
    )


SCENES = ("knife", "corridor", "urban")
SIGNATURES = {"R": (R,), "D": (D,), "RD": (R, D), "DR": (D, R), "DD": (D, D)}


@functools.cache
def _scene(name: str) -> JaxScene:
    return {"knife": _knife, "corridor": _corridor, "urban": _urban}[name]()


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize(
    ("slot_sizes", "start", "size"),
    [
        ((3, 2, 4), 0, None),
        ((5, 3), 4, 4),
        ((5, 3), 13, None),
        ((4, 0), 0, None),
        ((4, 0), 0, 5),
        ((), 0, None),
        ((7,), 2, 0),
        ((100_003, 100_019, 100_043), 2**48 + 12_345, 9),
    ],
    ids=["product", "range", "tail", "zero-slot", "zero-slot-sized", "empty", "size-0", "big-start"],
)
def test_candidates_match(slot_sizes: tuple, start: int, size) -> None:
    assert count_mixed_path_candidates(slot_sizes) == jax_count(slot_sizes)
    got = generate_mixed_path_candidates(slot_sizes, start=start, size=size, device="cpu")
    ref = _np(jax_generate(slot_sizes, start=start, size=size))
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(_np(got), ref)


@functools.cache
def _reference(name: str, signature: str):
    """The JAX paths, their mask without blockage, and their blockage taken op by op."""
    ref_scene = _scene(name)
    paths = JaxMixedPathTracer(hit_tol=NO_BLOCKAGE).trace_paths(ref_scene, SIGNATURES[signature])
    mesh = ref_scene.mesh if ref_scene.mesh.assume_unique_vertices else ref_scene.mesh.dedup_vertices()
    v = paths.vertices
    blocked = _np(mesh.ray_intersect_any_triangle(v[..., :-1, :], v[..., 1:, :] - v[..., :-1, :])).any(axis=-1)
    return paths, _np(paths.mask) & ~blocked


def _object_vectors(scene, paths, signature: str) -> np.ndarray:
    mesh = scene.mesh.dedup_vertices()
    edges = mesh._diffraction_edges_info()[0]
    candidates = paths.objects[0, 0, :, 1:-1]
    is_reflection = [t == R for t in SIGNATURES[signature]]
    return _np(_mixed._linear_objects(mesh, edges, candidates, is_reflection)[1])


@pytest.mark.parametrize("signature", SIGNATURES)
@pytest.mark.parametrize("name", SCENES)
def test_trace_mixed_paths_match(name: str, signature: str, monkeypatch) -> None:
    ref, ref_mask = _reference(name, signature)
    scene = to_torch_scene(_scene(name))
    paths = scene.trace_mixed_paths(SIGNATURES[signature])
    assert paths.shape == ref_mask.shape
    np.testing.assert_array_equal(_np(paths.objects), _np(ref.objects))
    np.testing.assert_array_equal(_np(paths.interaction_types), _np(ref.interaction_types))

    # The checks and the blockage, on the reference's points: the same mask.
    ref_points = torch.from_numpy(np.array(ref.vertices[..., 1:-1, :]))
    monkeypatch.setattr(_mixed, "fermat_path_on_linear_objects", lambda *args, **kwargs: ref_points)
    np.testing.assert_array_equal(_np(scene.trace_mixed_paths(SIGNATURES[signature]).mask), ref_mask)
    monkeypatch.undo()

    # On the port's own points: the same mask wherever the points agree.
    mask, vertices = _np(paths.mask), _np(paths.vertices)
    apart = np.abs(vertices - _np(ref.vertices)).max(axis=(-1, -2)) > VERTEX_ATOL
    np.testing.assert_array_equal(mask[~apart], ref_mask[~apart])
    both = mask & ref_mask
    if both.any():
        bound = VERTEX_ATOL + fermat_resolution(
            _np(ref.vertices)[both], _object_vectors(scene, paths, signature)[np.nonzero(both)[-1]], len(signature) + 2
        )
        err = np.abs(vertices[both] - _np(ref.vertices)[both]).max(axis=(-1, -2))
        assert (err <= bound).all(), f"worst {err.max()} m"


def test_every_scene_has_valid_mixed_paths() -> None:
    """The parity cases are not vacuous: each scene has valid two-interaction paths, in both packages."""
    for name in SCENES:
        counts = [int(_reference(name, s)[1].sum()) for s in ("RD", "DR", "DD")]
        assert sum(counts) > 0, name


def test_tracer_rejects_what_the_reference_rejects() -> None:
    scene = to_torch_scene(_scene("corridor"))
    with pytest.raises(ValueError, match="triangle mesh"):
        dataclasses.replace(scene, mesh=scene.mesh.set_assume_quads()).trace_mixed_paths([R])
    with pytest.raises(ValueError, match="REFLECTION and DIFFRACTION"):
        MixedPathTracer().trace_paths(scene, [R, 2])


def _edges_info(mesh):
    mesh = mesh if mesh.assume_unique_vertices else mesh.dedup_vertices()
    return dict(zip(("edges", "adjacent_triangles", "wedge_n"), mesh._diffraction_edges_info()))


def test_mixed_amplitudes_check_the_signature_length() -> None:
    scene = to_torch_scene(_scene("knife"))
    paths = scene.trace_mixed_paths([R, D])
    with pytest.raises(ValueError, match="2"):
        mixed_amplitudes(paths, scene, FREQUENCY, **_edges_info(scene.mesh), eta_r=[5.24], conductivity=[0.1], types=(R,))


def test_doctests() -> None:
    result = doctest.testmod(importlib.import_module("differt_tpu_torch.rt._mixed"), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
