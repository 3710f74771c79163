"""Parity of the port's core containers and candidates with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry._candidates import (
    _decode_range as jax_decode_range,
    count_path_candidates as jax_count,
)
from differt_tpu_torch import scenes
from differt_tpu_torch.geometry import Mesh, Scene, count_path_candidates
from differt_tpu_torch.geometry._candidates import _decode_range
from differt_tpu_torch.interop import scene_from_numpy, scene_to_numpy

from .torch_parity import jax_scene_fields, to_torch_scene

torch.set_num_threads(1)

N_CITY = 20_738  # urban_scene(24, 24)


@pytest.mark.parametrize(
    ("num_primitives", "order", "start", "size"),
    [
        (26, 0, 0, 1),
        (26, 1, 0, 26),
        (26, 2, 0, 26 * 25),
        (N_CITY, 0, 0, 1),
        (N_CITY, 1, 0, N_CITY),
        (N_CITY, 2, 0, 4096),
        (N_CITY, 2, 123_456_789, 5000),
        (N_CITY, 2, N_CITY * (N_CITY - 1) - 3000, 3000),
        (N_CITY, 3, 3_000_000_000, 4096),  # a chunk start above 2**31
    ],
)
def test_decode_range_rows_equal(num_primitives, order, start, size) -> None:
    ours = _decode_range(start, size, num_primitives, order)
    ref = np.asarray(jax_decode_range(start, size, num_primitives, order))
    assert ours.dtype == torch.int64
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize(
    ("num_primitives", "order"),
    [(0, 1), (1, 0), (1, 3), (26, 0), (26, 1), (26, 2), (N_CITY, 2), (N_CITY, 3)],
)
def test_count_path_candidates(num_primitives, order) -> None:
    assert count_path_candidates(num_primitives, order) == jax_count(num_primitives, order)


def test_street_canyon_builds_the_same_mesh() -> None:
    ours = scenes.street_canyon_scene(device="cpu").mesh
    ref = jax_scenes.street_canyon_scene().mesh
    assert ours.num_triangles == ref.num_triangles == 26
    np.testing.assert_array_equal(ours.vertices.numpy(), np.asarray(ref.vertices))
    np.testing.assert_array_equal(ours.triangles.numpy(), np.asarray(ref.triangles))
    np.testing.assert_array_equal(
        ours.object_bounds.numpy(), np.asarray(ref.object_bounds)
    )
    assert ours.material_names == ref.material_names == ("Concrete",)


def test_urban_scene_triangle_count() -> None:
    ours = scenes.urban_scene(24, 24, device="cpu").mesh
    assert ours.num_triangles == N_CITY
    assert ours.num_triangles == jax_scenes.urban_scene(24, 24).mesh.num_triangles
    # Seeded: the same city every time.
    torch.testing.assert_close(
        ours.vertices, scenes.urban_scene(24, 24, device="cpu").mesh.vertices, rtol=0, atol=0
    )


@pytest.mark.parametrize("quads", [False, True])
def test_mesh_geometry_matches(quads: bool) -> None:
    ref = jax_scenes.urban_scene(2, 2)
    if quads:
        ref = ref.set_assume_quads()
    ours = to_torch_scene(ref).mesh
    assert ours.num_primitives == ref.mesh.num_primitives
    np.testing.assert_allclose(
        ours.triangle_vertices.numpy(), np.asarray(ref.mesh.triangle_vertices), atol=1e-6
    )
    np.testing.assert_allclose(
        ours.normals.numpy(), np.asarray(ref.mesh.normals), atol=1e-6
    )
    np.testing.assert_allclose(
        ours.bounding_box.numpy(), np.asarray(ref.mesh.bounding_box), atol=1e-6
    )


def test_append_merges_materials_and_masks() -> None:
    a = Mesh.box(2.0, 2.0, 2.0, device="cpu").set_materials("Concrete")
    b = Mesh.plane([0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0], device="cpu").set_materials("Glass", "Concrete")
    b = b.set_face_materials(torch.tensor([1, 0])).set_mask(torch.tensor([True, False]))
    merged = a + b
    assert merged.material_names == ("Concrete", "Glass")
    assert merged.face_materials[-2:].tolist() == [0, 1]
    assert merged.mask.tolist() == [True] * 10 + [True, False]
    assert merged.object_bounds[-1].tolist() == [10, 12]


@pytest.mark.parametrize(("m", "n"), [(16, 16), (16, 8), (5, None)])
def test_receivers_grid_matches(m, n) -> None:
    ref = jax_scenes.street_canyon_scene()
    ref = JaxScene(mesh=ref.mesh).with_receivers_grid(m, n, height=1.5)
    ours = Scene(mesh=scenes.street_canyon_scene(device="cpu").mesh).with_receivers_grid(m, n, height=1.5)
    assert tuple(ours.receivers.shape) == ref.receivers.shape
    np.testing.assert_allclose(ours.receivers.numpy(), np.asarray(ref.receivers), atol=1e-5)


def test_interop_round_trip() -> None:
    ref = jax_scenes.urban_scene(2, 2)
    mask = np.ones(ref.mesh.num_triangles, dtype=bool)
    mask[::7] = False
    ref = JaxScene(
        transmitters=jnp.array([[0.0, 0.0, 40.0]]),
        receivers=jnp.array([[1.0, 2.0, 1.5], [3.0, -4.0, 1.5]]),
        mesh=ref.mesh.set_mask(jnp.asarray(mask)),
    )
    fields = jax_scene_fields(ref)
    scene = scene_from_numpy(fields, device="cpu")
    assert scene.mesh.mask.dtype == torch.bool
    assert scene.mesh.triangles.dtype == torch.int64
    back = scene_to_numpy(scene)
    for key in ("transmitters", "receivers"):
        np.testing.assert_array_equal(back[key], fields[key])
    for key, value in fields["mesh"].items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(back["mesh"][key], value)
        else:
            assert back["mesh"][key] == value


@pytest.mark.parametrize(
    "name",
    [
        "differt_tpu_torch.utils",
        "differt_tpu_torch.geometry._vectors",
        "differt_tpu_torch.geometry._lattice",
        "differt_tpu_torch.geometry._mesh",
        "differt_tpu_torch.geometry._candidates",
        "differt_tpu_torch.em._fresnel",
        "differt_tpu_torch.em._material",
        "differt_tpu_torch.rt._triangle",
        "differt_tpu_torch.rt._image_method",
        "differt_tpu_torch.rt._scan",
        "differt_tpu_torch.rt._mlm",
        "differt_tpu_torch.ops._rt",
        "differt_tpu_torch.ops._bvh",
        "differt_tpu_torch.ops._dispatch",
        "differt_tpu_torch.coverage",
        "differt_tpu_torch.parallel._sharding",
        "differt_tpu_torch.scenes",
        "differt_tpu_torch.profiling",
        "differt_tpu_torch.plotting._utils",
        "differt_tpu_torch.plotting._core",
    ],
)
def test_doctests(name: str) -> None:
    import doctest
    import importlib

    result = doctest.testmod(importlib.import_module(name), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0
    assert result.failed == 0
