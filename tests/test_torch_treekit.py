"""Checkpoints of the port (``differt_tpu_torch.treekit``) against the JAX package's, in both directions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import treekit as jax_treekit
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu_torch import scenes, treekit
from differt_tpu_torch.geometry import Mesh, Scene
from differt_tpu_torch.parallel import placement_training_step

from . import torch_parity  # noqa: F401  (its first calls of the CPU math functions)

torch.set_num_threads(1)


def jax_scene(scale: float) -> JaxScene:
    return JaxScene(
        transmitters=jnp.array([[1.0, 2.0, 3.0]]) * scale,
        receivers=jnp.array([[4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]) * scale,
        mesh=JaxMesh.box(2.0 * scale, 3.0, 4.0).set_materials("Concrete"),
    )


def port_scene(scale: float) -> Scene:
    return Scene(
        transmitters=torch.tensor([[1.0, 2.0, 3.0]]) * scale,
        receivers=torch.tensor([[4.0, 5.0, 6.0], [7.0, 8.0, 9.0]]) * scale,
        mesh=Mesh.box(2.0 * scale, 3.0, 4.0, device="cpu").set_materials("Concrete"),
    )


def _scene_arrays(scene) -> dict:
    mesh = scene.mesh
    names = ("vertices", "triangles", "face_materials", "object_bounds")
    out = {name: np.asarray(getattr(mesh, name)) for name in names}
    out["transmitters"] = np.asarray(scene.transmitters)
    out["receivers"] = np.asarray(scene.receivers)
    return out


def _assert_scenes_equal(got, want) -> None:
    got, want = _scene_arrays(got), _scene_arrays(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_jax_scene_loads_in_the_port(tmp_path) -> None:
    path = tmp_path / "scene.npz"
    jax_treekit.tree_serialise_leaves(path, jax_scene(2.0))
    like = port_scene(1.0)
    like.mesh.bvh  # a cached BVH is derived state: not written, not kept
    restored = treekit.tree_deserialise_leaves(path, like)
    _assert_scenes_equal(restored, jax_scene(2.0))
    assert restored.mesh.triangles.dtype == torch.int64  # the template's dtype, not the file's int32
    assert restored.mesh.material_names == ("Concrete",) and restored.mesh._bvh is None


def test_port_scene_loads_in_jax(tmp_path) -> None:
    path = tmp_path / "scene.npz"
    scene = port_scene(2.0)
    scene.mesh.bvh
    treekit.tree_serialise_leaves(path, scene)
    assert len(np.load(path).files) == 6  # the init fields' tensors only
    restored = jax_treekit.tree_deserialise_leaves(path, jax_scene(1.0))
    _assert_scenes_equal(restored, scene)
    assert restored.mesh.triangles.dtype == jnp.int32


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dict_keys_cross_packages_in_sorted_order(writer: str, tmp_path) -> None:
    # jax.tree flattens a dict by sorted key: the port's walk must too.
    rng = np.random.default_rng(11)
    values = {"zeta": rng.standard_normal(3), "alpha": rng.standard_normal((2, 2)), "mid": np.arange(4)}
    path = tmp_path / "tree.npz"
    if writer == "jax":
        jax_treekit.tree_serialise_leaves(path, {k: jnp.asarray(v, jnp.float32) for k, v in values.items()})
        like = {k: torch.zeros(v.shape) for k, v in values.items()}
        got = treekit.tree_deserialise_leaves(path, like)
        assert list(got) == list(like)  # the template's own key order
    else:
        treekit.tree_serialise_leaves(path, {k: torch.tensor(v, dtype=torch.float32) for k, v in values.items()})
        got = jax_treekit.tree_deserialise_leaves(path, {k: jnp.zeros(v.shape) for k, v in values.items()})
    for key, value in values.items():
        np.testing.assert_array_equal(np.asarray(got[key]), value.astype(np.float32))


def test_shape_mismatch_and_extra_leaves_raise(tmp_path) -> None:
    path = tmp_path / "x.npz"
    treekit.tree_serialise_leaves(path, {"a": torch.zeros(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="Shape mismatch"):
        treekit.tree_deserialise_leaves(path, {"a": torch.zeros(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="1 extra leaves"):
        treekit.tree_deserialise_leaves(path, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="2 leaves, the template 3"):
        treekit.tree_deserialise_leaves(path, {"a": torch.zeros(3), "b": torch.ones(2), "c": torch.ones(1)})


def test_bare_path_gets_the_npz_suffix(tmp_path) -> None:
    tree = (torch.arange(5.0), [np.ones((2, 2)), "static"], None)
    treekit.tree_serialise_leaves(tmp_path / "ckpt", tree)
    assert (tmp_path / "ckpt.npz").is_file()
    got = treekit.tree_deserialise_leaves(tmp_path / "ckpt", (torch.zeros(5), [np.zeros((2, 2)), "static"], None))
    assert torch.equal(got[0], tree[0]) and isinstance(got[1][0], np.ndarray)
    np.testing.assert_array_equal(got[1][0], tree[1][0])
    assert got[1][1] == "static" and got[2] is None


def test_resumed_placement_step_equals_two_steps(tmp_path) -> None:
    """One step, a checkpoint of the scene and the materials, a load into fresh templates and
    one more step: bit for bit the two uninterrupted steps."""

    def make_state():
        scene = Scene(
            transmitters=torch.tensor([[-30.0, 0.5, 20.0]]),
            mesh=scenes.street_canyon_scene(device="cpu").mesh,
        ).with_receivers_grid(6, 5)
        return {"scene": scene, "eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}

    def step(state):
        tx, eta, loss = placement_training_step(
            state["scene"], 2.4e9, order=1, tx=state["scene"].transmitters,
            eta_r=state["eta_r"], conductivity=state["conductivity"],
        )
        scene = dataclasses.replace(state["scene"], transmitters=tx)
        return {**state, "scene": scene, "eta_r": eta}, loss

    once, _ = step(make_state())
    twice, loss = step(once)
    treekit.tree_serialise_leaves(tmp_path / "step1", once)
    fresh = make_state()
    fresh = {**fresh, "scene": dataclasses.replace(fresh["scene"], transmitters=torch.zeros(1, 3))}
    resumed, resumed_loss = step(treekit.tree_deserialise_leaves(tmp_path / "step1", fresh))
    assert not torch.equal(twice["scene"].transmitters, once["scene"].transmitters)
    assert torch.equal(resumed["scene"].transmitters, twice["scene"].transmitters)
    assert torch.equal(resumed["eta_r"], twice["eta_r"]) and torch.equal(resumed_loss, loss)


def test_doctests() -> None:
    import doctest

    result = doctest.testmod(treekit, optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
