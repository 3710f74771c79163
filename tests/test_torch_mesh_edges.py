"""Parity of the port's ``Mesh`` structure and diffraction-edge surface with the JAX package.

Meshes cross over through ``interop`` (the flags with them); random masks
and triangle picks come from ``numpy.random.default_rng``. Tolerances:
edges, adjacency, the per-half-edge mask and every integer field are
equal; wedge parameters ``atol=1e-6``; vertex coordinates equal (the
operations only gather and round them). The JAX edge extraction runs
eagerly and compiles each of its operations for each new mesh size, so the
meshes here share few sizes.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import scenes as jax_scenes
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu_torch.geometry import Mesh
from differt_tpu_torch.interop import mesh_from_numpy, mesh_to_numpy
from .torch_parity import jax_scene_fields

WEDGE_ATOL = 1e-6


def _jax_mesh_fields(mesh) -> dict:
    return jax_scene_fields(type("S", (), {"mesh": mesh, "transmitters": None, "receivers": None})())["mesh"]


def _to_torch(mesh) -> Mesh:
    return mesh_from_numpy(_jax_mesh_fields(mesh), device="cpu")


def _masked(mesh, seed: int):
    return mesh.set_mask(jnp.asarray(np.random.default_rng(seed).random(mesh.num_triangles) >= 0.2))


_BUILDERS = {
    "box closed": lambda: JaxMesh.box(2.0, 3.0, 4.0, with_top=True),
    "box open top": lambda: JaxMesh.box(2.0, 3.0, 4.0),
    "box quads": lambda: _mesh("box closed").set_assume_quads(),
    "box masked": lambda: _masked(_mesh("box closed"), 1),
    "plane": lambda: JaxMesh.plane(jnp.array([1.0, 2.0, 0.5]), normal=jnp.array([0.0, 0.6, 0.8])),
    "two boxes appended": lambda: _mesh("box closed")
    + JaxMesh.box(1.0, 1.0, 1.0).translate(jnp.array([0.0, 0.0, 2.5])),
    "canyon": lambda: jax_scenes.street_canyon_scene().mesh,
    "canyon quads masked": lambda: _masked(_mesh("canyon").set_assume_quads(), 2),
    "urban 2x2": lambda: jax_scenes.urban_scene(2, 2, key=jax.random.key(7)).mesh,
    "urban 2x2 masked": lambda: _masked(_mesh("urban 2x2"), 3),
}


@functools.cache
def _mesh(name: str):
    """The JAX mesh of the parity tests named ``name``, built at first use."""
    return _BUILDERS[name]()


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_mesh_equal(port: Mesh, ref) -> None:
    """Every field of the port's mesh equals the JAX mesh's."""
    np.testing.assert_array_equal(_np(port.vertices), _np(ref.vertices))
    np.testing.assert_array_equal(_np(port.triangles), _np(ref.triangles))
    for name in ("face_materials", "mask", "object_bounds"):
        p, r = getattr(port, name), getattr(ref, name)
        assert (p is None) == (r is None), name
        if p is not None:
            np.testing.assert_array_equal(_np(p), _np(r))
    assert port.material_names == ref.material_names
    assert port.assume_quads == ref.assume_quads
    assert port.assume_unique_vertices == ref.assume_unique_vertices


@pytest.mark.parametrize("name", [name for name in _BUILDERS if name != "two boxes appended"])
def test_diffraction_edges_match(name: str) -> None:
    ref = _mesh(name)
    port = _to_torch(ref)
    assert port.assume_unique_vertices == ref.assume_unique_vertices
    unique = ref if ref.assume_unique_vertices else ref.dedup_vertices()
    edges, adjacent, wedge_n = unique._diffraction_edges_info()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # none of these meshes has a non-manifold edge
        np.testing.assert_array_equal(_np(port.diffraction_edges_mask), _np(unique.diffraction_edges_mask))
        np.testing.assert_array_equal(_np(port.diffraction_edges), _np(edges))
        np.testing.assert_array_equal(_np(port.diffraction_edges_to_triangles), _np(adjacent))
        np.testing.assert_allclose(_np(port.wedge_parameters), _np(wedge_n), atol=WEDGE_ATOL, rtol=0)
        np.testing.assert_allclose(_np(port.wedge_angles), _np(unique.wedge_angles), atol=WEDGE_ATOL, rtol=0)
    assert edges.shape[0] > 0 or name == "plane"


@pytest.mark.parametrize("name", ["box closed", "box quads", "canyon quads masked", "urban 2x2"])
def test_connectivity_matches(name: str) -> None:
    ref = _mesh(name)
    ref = ref if ref.assume_unique_vertices else ref.dedup_vertices()
    port = _to_torch(ref)
    for p, r in zip(port._connectivity(), ref._connectivity()):
        np.testing.assert_array_equal(_np(p), _np(r))


def test_box_wedges_are_right_angles() -> None:
    box = Mesh.box(2.0, 3.0, 4.0, with_top=True, device="cpu")
    assert box.diffraction_edges.shape == (12, 2, 3)
    assert (box.diffraction_edges_to_triangles >= 0).all()
    torch.testing.assert_close(box.wedge_parameters, torch.full((12,), 1.5), atol=WEDGE_ATOL, rtol=0)


def test_non_manifold_edges_warn_with_their_count() -> None:
    # The closed box with its last triangle turned into a fin on the edge
    # (0, 1), which three faces then share: it is excluded, and both
    # packages say so. (The box's sizes: the JAX side compiles nothing new.)
    box = _mesh("box closed")
    triangles = np.asarray(box.triangles).copy()
    triangles[-1] = [0, 1, 5]
    ref = JaxMesh(vertices=box.vertices, triangles=jnp.asarray(triangles), assume_unique_vertices=True)
    port = _to_torch(ref)
    with pytest.warns(UserWarning, match="Mesh contains 1 non-manifold edge"):
        port_mask = port.diffraction_edges_mask
    with pytest.warns(UserWarning, match="Mesh contains 1 non-manifold edge"):
        ref_mask = ref.diffraction_edges_mask
    np.testing.assert_array_equal(_np(port_mask), _np(ref_mask))
    assert not port_mask[0, 1] and not port_mask[7, 2]  # the two box faces on (0, 1)


def test_empty_mesh_has_no_edges() -> None:
    empty = Mesh.empty(device="cpu").set_assume_unique_vertices()
    assert empty.diffraction_edges_mask.shape == (0, 3)
    assert empty.diffraction_edges.shape == (0, 2, 3)
    assert empty.diffraction_edges_to_triangles.shape == (0, 2)
    assert empty.wedge_parameters.shape == (0,)


@pytest.mark.parametrize("num_decimals", [None, 0, 2])
@pytest.mark.parametrize("name", ["two boxes appended", "urban 2x2 masked"])
def test_dedup_vertices_matches(name: str, num_decimals) -> None:
    ref = _mesh(name)
    if num_decimals is not None:  # near-duplicates that only rounding merges
        noise = np.random.default_rng(5).uniform(-1e-3, 1e-3, ref.vertices.shape).astype(np.float32)
        ref = ref.translate(jnp.asarray(noise))
    port = _to_torch(ref)
    _assert_mesh_equal(port.dedup_vertices(num_decimals), ref.dedup_vertices(num_decimals))


def test_dedup_treats_negative_zero_as_zero() -> None:
    vertices = np.array([[0.0, 1, 0], [-0.0, 1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    triangles = np.array([[1, 2, 3], [0, 3, 2]], dtype=np.int32)
    ref = JaxMesh(vertices=jnp.asarray(vertices), triangles=jnp.asarray(triangles))
    port = Mesh(torch.from_numpy(vertices), torch.from_numpy(triangles).long())
    _assert_mesh_equal(port.dedup_vertices(), ref.dedup_vertices())
    assert port.dedup_vertices().vertices.shape[0] == 3


def test_dedup_hands_over_a_current_bvh_only() -> None:
    mesh = (Mesh.box(device="cpu") + Mesh.box(device="cpu").translate([0.0, 0.0, 1.0])).set_assume_quads()
    bvh = mesh.bvh
    assert mesh.dedup_vertices().bvh is bvh
    assert mesh.dedup_vertices(num_decimals=3).bvh is not bvh
    mesh.vertices.add_(1.0)  # an in-place edit makes the cached structure stale
    assert mesh.dedup_vertices().bvh is not bvh


@pytest.mark.parametrize("name", ["two boxes appended", "urban 2x2 masked", "canyon quads masked"])
def test_structure_ops_match(name: str) -> None:
    ref = _mesh(name)
    port = _to_torch(ref)
    n = ref.num_triangles
    rng = np.random.default_rng(11)
    picks = rng.choice(n, size=n // 2, replace=False)
    bool_key = rng.random(n) >= 0.5
    assert port.num_objects == ref.num_objects
    np.testing.assert_array_equal(_np(port.triangle_edges), _np(ref.triangle_edges))
    _assert_mesh_equal(port[2:7], ref[2:7])
    _assert_mesh_equal(port[torch.from_numpy(picks)], ref[jnp.asarray(picks)])
    _assert_mesh_equal(port[torch.from_numpy(bool_key)], ref[jnp.asarray(bool_key)])
    _assert_mesh_equal(port.masked(), ref.masked())
    _assert_mesh_equal(port.drop_unused_vertices(), ref.drop_unused_vertices())
    _assert_mesh_equal(port[2:7].drop_unused_vertices(), ref[2:7].drop_unused_vertices())
    objects = list(port.iter_objects())
    ref_objects = list(ref.iter_objects())
    assert len(objects) == len(ref_objects) == ref.num_objects
    for p, r in zip(objects, ref_objects):
        _assert_mesh_equal(p, r)


def test_drop_duplicates_matches() -> None:
    ref = _mesh("box closed")
    rows = np.array([0, 3, 1, 0, 5, 3, 2], dtype=np.int64)
    # Repeats, one of them with its corners in another order.
    triangles = np.asarray(ref.triangles)[rows]
    triangles[3] = triangles[3][[1, 2, 0]]
    ref = JaxMesh(vertices=ref.vertices, triangles=jnp.asarray(triangles), assume_unique_vertices=True)
    port = _to_torch(ref)
    _assert_mesh_equal(port.drop_duplicates(), ref.drop_duplicates())
    assert port.drop_duplicates().num_triangles == 5


def test_flags_follow_the_reference() -> None:
    box = Mesh.box(device="cpu")
    assert box.assume_unique_vertices and Mesh.plane([0, 0, 0], normal=[0, 0, 1], device="cpu").assume_unique_vertices
    assert not (box + box).assume_unique_vertices
    assert (box + box).dedup_vertices().assume_unique_vertices
    assert not box.set_assume_unique_vertices(False).assume_unique_vertices
    fields = mesh_to_numpy(box.set_assume_unique_vertices(False))
    assert mesh_from_numpy(fields, device="cpu").assume_unique_vertices is False
    assert mesh_from_numpy(mesh_to_numpy(box), device="cpu").assume_unique_vertices is True
    assert box.num_objects == 5 and box[0:2].num_objects == 1
