"""Parity of the port's ``Mesh`` and ``Scene`` edits with the JAX package.

Transforms, constructors, clipping and ``at[...]`` vertex edits take the
same numpy inputs in both packages and must agree in float32 (masks
exactly). ``sample``, ``shuffle``, ``set_face_colors(generator=...)`` and
``sample_points_in_bounding_box`` draw from a ``torch.Generator`` where the
JAX package draws from a key, so their semantics are tested, not values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import min_distance_between_cells as jax_min_distance_between_cells
from differt_tpu.geometry import _vectors as jax_vectors
from differt_tpu_torch.geometry import (
    Mesh,
    Scene,
    TriangleScene,
    min_distance_between_cells,
    rotation_matrix_along_axis,
    rotation_matrix_along_x_axis,
    rotation_matrix_along_y_axis,
    rotation_matrix_along_z_axis,
)
from differt_tpu_torch.interop import mesh_from_numpy, mesh_to_numpy
from differt_tpu_torch.utils import sample_points_in_bounding_box

from .torch_parity import jax_scene_fields, to_torch_scene

torch.set_num_threads(1)


def close(got, want, **kw) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=kw.get("rtol", 1e-6), atol=kw.get("atol", 1e-6))


def both_boxes():
    """A box with colours, two materials and a mask, in both packages."""
    ref = JaxMesh.box(3.0, 2.0, 1.5, with_top=True).translate(jnp.array([1.0, -2.0, 0.5]))
    ref = ref.set_materials("A", "B").set_face_materials(jnp.arange(12) % 2)
    ref = ref.set_face_colors(jnp.arange(36, dtype=jnp.float32).reshape(12, 3) / 36.0)
    ref = ref.set_mask(jnp.arange(12) % 5 != 0)
    return ref, to_torch_scene(JaxScene(mesh=ref)).mesh


AXIS = np.array([0.48, 0.6, 0.64], np.float32)


@pytest.mark.parametrize(
    "name", ["rotation_matrix_along_x_axis", "rotation_matrix_along_y_axis", "rotation_matrix_along_z_axis", "axis"]
)
def test_rotation_matrices_match_jax(name: str) -> None:
    angle = np.float32(0.7)
    if name == "axis":
        got = rotation_matrix_along_axis(torch.tensor(angle), torch.from_numpy(AXIS))
        want = jax_vectors.rotation_matrix_along_axis(angle, jnp.asarray(AXIS))
    else:
        got = {"x": rotation_matrix_along_x_axis, "y": rotation_matrix_along_y_axis, "z": rotation_matrix_along_z_axis}[
            name[-6]
        ](torch.tensor(angle))
        want = getattr(jax_vectors, name)(angle)
    assert got.dtype == torch.float32
    close(got, want)
    close(got @ got.T, np.eye(3), atol=1e-6)


def test_transforms_match_jax() -> None:
    ref, mesh = both_boxes()
    rot = jax_vectors.rotation_matrix_along_axis(0.7, jnp.asarray(AXIS))
    close(mesh.rotate(torch.from_numpy(np.array(rot))).vertices, ref.rotate(rot).vertices)
    close(mesh.scale(2.5).vertices, ref.scale(2.5).vertices)
    close(mesh.translate([0.5, 1.0, -3.0]).vertices, ref.translate(jnp.array([0.5, 1.0, -3.0])).vertices)
    (centred, offset), (want_centred, want_offset) = mesh.center(), ref.center()
    close(centred.vertices, want_centred.vertices)
    close(offset, want_offset)
    close(centred.bounding_box.mean(dim=0), np.zeros(3))
    # Edits keep everything else and start without a BVH.
    _ = mesh.bvh
    for edited in (mesh.rotate(torch.eye(3)), mesh.scale(1.0), centred):
        assert edited._bvh is None
        assert torch.equal(edited.face_colors, mesh.face_colors) and torch.equal(edited.mask, mesh.mask)


@pytest.mark.parametrize("form", ["normal", "vertices", "rotated"])
def test_plane_matches_jax(form: str) -> None:
    a, b, c = np.array([1.0, 2.0, 0.5]), np.array([2.0, 2.5, 0.5]), np.array([1.0, 3.0, 1.5])
    normal = np.array([0.0, 0.6, 0.8])
    kw = {"side_length": 3.0}
    if form == "normal":
        want = JaxMesh.plane(jnp.asarray(a), normal=jnp.asarray(normal), **kw)
        got = Mesh.plane(a, normal=normal, device="cpu", **kw)
    elif form == "vertices":
        want = JaxMesh.plane(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), **kw)
        got = Mesh.plane(a, b, c, device="cpu", **kw)
    else:
        want = JaxMesh.plane(jnp.asarray(a), normal=jnp.asarray(normal), rotate=0.4, **kw)
        got = Mesh.plane(a, normal=normal, rotate=0.4, device="cpu", **kw)
    close(got.vertices, want.vertices, atol=2e-6)
    np.testing.assert_array_equal(got.triangles.numpy(), np.asarray(want.triangles))
    with pytest.raises(ValueError, match="vertex_c"):
        Mesh.plane(a, b, normal=normal, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        Mesh.plane(a, b, c, normal=normal, device="cpu")


@pytest.mark.parametrize(("side_length", "elevation"), [(None, 0.0), (7.0, -1.5)])
def test_add_ground_matches_jax(side_length, elevation: float) -> None:
    ref, mesh = both_boxes()
    want = ref.add_ground(side_length, elevation=elevation)
    got = mesh.add_ground(side_length, elevation=elevation)
    close(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.triangles.numpy(), np.asarray(want.triangles))
    np.testing.assert_array_equal(got.face_materials.numpy(), np.asarray(want.face_materials))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.object_bounds.numpy(), np.asarray(want.object_bounds))
    close(got.face_colors, want.face_colors)


def test_clip_and_keep_within_match_jax() -> None:
    ref, mesh = both_boxes()
    box = np.array([[0.0, -3.0, -1.0], [3.0, 0.0, 2.0]], np.float32)
    cases = [
        (mesh.clip(x_min=0.5, z_max=1.0), ref.clip(x_min=0.5, z_max=1.0)),
        (mesh.clip(y_max=-2.0), ref.clip(y_max=-2.0)),
        (mesh.keep_all_within(box), ref.keep_all_within(jnp.asarray(box))),
        (mesh.keep_any_within(box), ref.keep_any_within(jnp.asarray(box))),
        (mesh.set_mask(None).keep_any_within(box), ref.set_mask(None).keep_any_within(jnp.asarray(box))),
    ]
    for got, want in cases:
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(cases[2][0].num_active_triangles) < int(cases[3][0].num_active_triangles) < 12


def test_counts_match_jax() -> None:
    ref, mesh = both_boxes()
    for got, want in ((mesh, ref), (mesh.set_assume_quads(), ref.set_assume_quads()), (mesh.set_mask(None), ref.set_mask(None))):
        assert int(got.num_active_triangles) == int(want.num_active_triangles)
        assert got.num_primitives == want.num_primitives
        assert int(got.num_active_primitives) == int(want.num_active_primitives)
        if got.assume_quads:
            assert got.num_quads == want.num_quads == 6
            assert int(got.num_active_quads) == int(want.num_active_quads)
        assert got.is_empty == want.is_empty is False
    assert Mesh.empty(device="cpu").is_empty
    for name in ("num_quads", "num_active_quads"):
        with pytest.raises(ValueError, match="assume_quads"):
            getattr(mesh, name)


SELECTIONS = {"slice": slice(0, 2), "repeats": [0, 0, 1, 7], "scalar": 3}
UPDATES = {
    "set": np.array([0.5, -1.0, 2.0], np.float32),
    "add": np.array([0.5, -1.0, 2.0], np.float32),
    "sub": np.array([0.5, -1.0, 2.0], np.float32),
    "mul": np.array([1.5, -1.0, 2.0], np.float32),
    "div": np.array([1.5, -1.0, 2.0], np.float32),
    "pow": np.float32(2.0),
    "min": np.array([0.0, -2.5, 1.0], np.float32),
    "max": np.array([0.0, -2.5, 1.0], np.float32),
}


@pytest.mark.parametrize("selection", list(SELECTIONS))
@pytest.mark.parametrize("op", [*UPDATES, "apply"])
def test_at_updates_match_jax(op: str, selection: str) -> None:
    ref, mesh = both_boxes()
    sel = SELECTIONS[selection]
    jax_sel = jnp.asarray(sel) if isinstance(sel, list) else sel
    torch_sel = torch.tensor(sel) if isinstance(sel, list) else sel
    if op == "apply":
        want = ref.at[jax_sel].apply(jnp.sin)
        got = mesh.at[torch_sel].apply(torch.sin)
    else:
        want = getattr(ref.at[jax_sel], op)(jnp.asarray(UPDATES[op]))
        got = getattr(mesh.at[torch_sel], op)(torch.from_numpy(np.asarray(UPDATES[op])))
    close(got.vertices, want.vertices)
    assert not torch.equal(got.vertices, mesh.vertices)
    assert got._bvh is None and torch.equal(got.triangles, mesh.triangles)
    np.testing.assert_array_equal(mesh.at[torch_sel].get().numpy(), np.asarray(ref.at[jax_sel].get()))


def test_at_gradients_match_jax() -> None:
    ref, mesh = both_boxes()
    direction = np.array([0.0, 0.0, 1.0], np.float32)

    def jax_height(shift):
        return (ref.at[0:2].add(jnp.asarray(direction) * shift).vertices[:, 2] ** 2).sum()

    shift = torch.tensor(0.3, requires_grad=True)
    height = (mesh.at[0:2].add(torch.from_numpy(direction) * shift).vertices[:, 2] ** 2).sum()
    (grad,) = torch.autograd.grad(height, shift)
    close(grad, jax.grad(jax_height)(jnp.float32(0.3)), rtol=1e-5)
    # A quad touches 4 vertices, each moved once: d(sum z)/d(shift) = 4.
    shifted = mesh.at[torch.tensor([0, 1, 1, 0])].add(torch.from_numpy(direction) * shift)
    (grad,) = torch.autograd.grad(shifted.vertices[:, 2].sum(), shift)
    assert float(grad) == 4.0
    with pytest.raises(ValueError, match="1-D"):
        mesh.at[torch.zeros((2, 2), dtype=torch.int64)]


def test_set_face_colors() -> None:
    ref, mesh = both_boxes()
    close(mesh.set_face_colors([0.1, 0.2, 0.3]).face_colors, ref.set_face_colors(jnp.array([0.1, 0.2, 0.3])).face_colors)
    colours = mesh.set_face_colors(generator=torch.Generator().manual_seed(3)).face_colors
    again = mesh.set_face_colors(generator=torch.Generator().manual_seed(3)).face_colors
    assert torch.equal(colours, again) and colours.shape == (12, 3)
    assert bool(((colours >= 0) & (colours < 1)).all())
    # One colour per object (the box's six faces, two triangles each).
    for start, end in mesh.object_bounds.tolist():
        assert bool((colours[start:end] == colours[start]).all())
    assert len({tuple(c) for c in colours.tolist()}) == 6
    whole = mesh.set_mask(None)
    whole = Mesh(vertices=whole.vertices, triangles=whole.triangles)
    assert len({tuple(c) for c in whole.set_face_colors(generator=torch.Generator()).face_colors.tolist()}) == 1
    for kw in ({}, {"colors": [0.0, 0.0, 0.0], "generator": torch.Generator()}):
        with pytest.raises(ValueError, match="one of"):
            mesh.set_face_colors(**kw)


def test_face_colors_follow_the_mesh() -> None:
    ref, mesh = both_boxes()
    plain = Mesh.box(device="cpu")
    joined, want = mesh + plain, ref + JaxMesh.box()
    close(joined.face_colors, want.face_colors)
    assert bool((joined.face_colors[12:] == 0).all())
    assert torch.equal(mesh[3:7].face_colors, mesh.face_colors[3:7])
    assert torch.equal(mesh.masked().face_colors, mesh.face_colors[mesh.mask])
    assert torch.equal(mesh.dedup_vertices().face_colors, mesh.face_colors)
    assert torch.equal(mesh.drop_unused_vertices().face_colors, mesh.face_colors)
    assert torch.equal(mesh_from_numpy(mesh_to_numpy(mesh), device="cpu").face_colors, mesh.face_colors)
    # Colours are not geometry: the BVH key ignores them.
    assert mesh.set_face_colors([1.0, 0.0, 0.0])._bvh_key() == mesh._bvh_key()


def test_sample_and_shuffle_semantics() -> None:
    _, mesh = both_boxes()
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    rows = {tuple(r) for r in mesh.triangle_vertices.reshape(12, -1).tolist()}

    picked = mesh.sample(5, generator=gen())
    assert picked.num_triangles == 5 and picked.object_bounds is None
    picked_rows = [tuple(r) for r in picked.triangle_vertices.reshape(5, -1).tolist()]
    assert len(set(picked_rows)) == 5 and set(picked_rows) <= rows
    assert torch.equal(picked.triangles, mesh.sample(5, generator=gen()).triangles)
    with pytest.raises(ValueError, match="without replacement"):
        mesh.sample(13, generator=gen())
    assert mesh.sample(30, replace=True, generator=gen()).num_triangles == 30

    masked = mesh.sample(5, by_masking=True, generator=gen())
    assert masked.num_triangles == 12 and int(masked.mask.sum()) == 5
    kept = mesh.sample(5, by_masking=True, preserve=True, generator=gen())
    assert not bool((kept.mask & ~mesh.mask).any())
    assert int(mesh.sample(4, replace=True, by_masking=True, generator=gen()).mask.sum()) <= 4
    assert int(mesh.sample(0, by_masking=True, generator=gen()).mask.sum()) == 0

    shuffled = mesh.shuffle(generator=gen())
    original = {
        tuple(tv.reshape(-1).tolist()): (int(m), tuple(c.tolist()), bool(k))
        for tv, m, c, k in zip(mesh.triangle_vertices, mesh.face_materials, mesh.face_colors, mesh.mask)
    }
    assert len(original) == 12
    for tv, m, c, k in zip(shuffled.triangle_vertices, shuffled.face_materials, shuffled.face_colors, shuffled.mask):
        assert original[tuple(tv.reshape(-1).tolist())] == (int(m), tuple(c.tolist()), bool(k))
    assert not torch.equal(shuffled.triangles, mesh.triangles)


def test_sample_points_in_bounding_box() -> None:
    box = torch.tensor([[-1.0, 2.0, 0.0], [3.0, 2.5, 10.0]])
    points = sample_points_in_bounding_box(box, (50, 4), generator=torch.Generator().manual_seed(1))
    assert points.shape == (50, 4, 3) and points.dtype == torch.float32
    assert bool(((points >= box[0]) & (points <= box[1])).all())
    assert torch.equal(points, sample_points_in_bounding_box(box, (50, 4), generator=torch.Generator().manual_seed(1)))
    assert float(points[..., 2].std()) > 1.0
    assert sample_points_in_bounding_box(box).shape == (3,)


def test_min_distance_between_cells_matches_jax() -> None:
    rng = np.random.default_rng(4)
    vertices = rng.uniform(-5.0, 5.0, (6, 7, 3)).astype(np.float32)
    ids = rng.integers(0, 4, (6, 7))
    got = min_distance_between_cells(torch.from_numpy(vertices), torch.from_numpy(ids), chunk=5)
    close(got, jax_min_distance_between_cells(jnp.asarray(vertices), jnp.asarray(ids)), rtol=1e-6)
    single = min_distance_between_cells(torch.from_numpy(vertices), torch.zeros((6, 7), dtype=torch.int64))
    assert bool(torch.isinf(single).all())


def test_scene_edits_match_jax() -> None:
    ref = JaxScene(
        transmitters=jnp.array([[1.0, 2.0, 3.0], [0.0, -1.0, 5.0]]),
        receivers=jnp.array([[[4.0, 4.0, 1.5]]]),
        mesh=JaxMesh.box(10.0, 6.0, 4.0, with_top=True),
    )
    scene = to_torch_scene(ref)
    rot = jax_vectors.rotation_matrix_along_axis(0.3, jnp.asarray(AXIS))
    pairs = [
        (scene.rotate(torch.from_numpy(np.array(rot))), ref.rotate(rot)),
        (scene.scale(1.5), ref.scale(1.5)),
        (scene.translate([1.0, 0.0, -2.0]), ref.translate(jnp.array([1.0, 0.0, -2.0]))),
        (scene.with_transmitters_grid(4, 3, height=2.0), ref.with_transmitters_grid(4, 3, height=2.0)),
        (scene.with_transmitters_grid(3, None), ref.with_transmitters_grid(3, None)),
    ]
    for got, want in pairs:
        for name in ("transmitters", "receivers"):
            assert tuple(getattr(got, name).shape) == np.shape(getattr(want, name)), name
            close(getattr(got, name), getattr(want, name), atol=2e-6)
        close(got.mesh.vertices, want.mesh.vertices, atol=2e-6)
        assert got.num_transmitters == want.num_transmitters
    quads = scene.set_assume_quads()
    assert quads.mesh.assume_quads and quads.mesh.num_primitives == ref.set_assume_quads().mesh.num_primitives
    with pytest.warns(DeprecationWarning, match="TriangleScene"):
        alias = TriangleScene(transmitters=scene.transmitters, receivers=scene.receivers, mesh=scene.mesh)
    assert isinstance(alias, Scene) and alias.num_transmitters == 2
    fields = jax_scene_fields(ref)
    assert fields["mesh"]["face_colors"] is None


def test_from_mitsuba_and_from_sionna_need_their_packages() -> None:
    class SionnaScene:
        mi_scene = object()

    with pytest.raises(ImportError):
        Scene.from_mitsuba(SionnaScene.mi_scene, device="cpu")
    with pytest.raises(ImportError):
        Scene.from_sionna(SionnaScene(), device="cpu")
