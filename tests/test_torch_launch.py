"""Parity of the port's ray launching (SBR ``launch_paths``) and MLM with the JAX package.

Inputs cross over as numpy arrays: scenes through ``interop``, and the ray
directions of the JAX launcher where a test says "carried across", so that
both packages bounce the same rays. Tolerances:

- masks, objects, hashes and maps: equal. The JAX launches run under
  ``jax.disable_jit()``, op by op as the port runs: under ``jit`` XLA fuses
  ``o + t d`` into an FMA, and a bounce point an ulp away can fall on the
  other side of the wall it left (SBR adds no offset after a bounce), so
  that one package hits that wall again and the other does not;
- vertices: ``atol=1e-4`` where the paths are valid (float32 hit points
  after up to three reflections, a few ulps of 100 m);
- ``compute_tx_mlm`` end to end: equal when the port's lattice is swapped
  for JAX's (the lattices agree to ``1e-6``, ``test_torch_lattice.py``);
  with each package's own lattice, at most 0.1% of the cells may differ,
  because an ulp of a direction can move a plane crossing across a cell
  edge. Not on masked meshes: there rays enter the buildings through the
  holes and bounce inside closed boxes, where ulps grow from bounce to
  bounce (about 1% of the 2,000 rays end in another cell).
"""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import scenes as jax_scenes
from differt_tpu import treekit as tk
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.rt import _mlm as jax_mlm
from differt_tpu.rt._solvers import SBRPathLauncher as JaxSBR
from differt_tpu_torch import ops
from differt_tpu_torch.geometry import LaunchedPaths
from differt_tpu_torch.ops import _closest
from differt_tpu_torch.rt import SBRPathLauncher
from differt_tpu_torch.rt import _mlm

from .torch_parity import to_torch_scene

torch.set_num_threads(1)


# -- Hashes -----------------------------------------------------------------


def test_hashes_bit_equal() -> None:
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    a[:4] = [0, 1, 2**31, 2**32 - 1]
    ours_h = _mlm._hash_int(torch.from_numpy(a.astype(np.int64)))
    ref_h = np.asarray(jax_mlm._hash_int(jnp.asarray(a)))
    np.testing.assert_array_equal(ours_h.numpy(), ref_h.astype(np.int64))
    ours_c = _mlm._combine_hashes(
        torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b.astype(np.int64))
    )
    ref_c = np.asarray(jax_mlm._combine_hashes(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(ours_c.numpy(), ref_c.astype(np.int64))
    # The doctest values, and int32 faces of -1 wrapping as astype(uint32) does.
    assert int(_mlm._hash_int(torch.tensor(0))) == 0
    assert int(_mlm._combine_hashes(torch.tensor(1), torch.tensor(2))) == 2654435834
    assert int(_mlm._hash_int(torch.tensor(-1))) == int(jax_mlm._hash_int(jnp.int32(-1)))
    # The final int32 keeps the bit pattern.
    bits = _mlm._to_int32_bits(torch.from_numpy(a.astype(np.int64)))
    np.testing.assert_array_equal(bits.numpy(), a.view(np.int32))


# -- MLM ----------------------------------------------------------------------


def _canyon():
    scene = jax_scenes.street_canyon_scene()
    return tk.tree_at(lambda s: s.transmitters, scene, jnp.array([[0.0, 0.0, 20.0]]))


def _city():
    scene = jax_scenes.urban_scene(2, 2)
    return tk.tree_at(
        lambda s: s.transmitters, scene, jnp.array([[0.0, 0.0, 40.0], [20.0, -5.0, 8.0]])
    )


def _variant(scene, variant: str):
    if variant == "masked":
        mask = jnp.asarray(np.arange(scene.mesh.num_triangles) % 5 != 1)
        return tk.tree_at(lambda s: s.mesh, scene, scene.mesh.set_mask(mask))
    if variant == "quads":
        return tk.tree_at(lambda s: s.mesh, scene, scene.mesh.set_assume_quads())
    return scene


MLM_KW = {"order": 2, "receiver_plane_z": 1.5, "grid_size": (32, 32)}


@pytest.mark.parametrize("variant", ["plain", "masked", "quads"])
@pytest.mark.parametrize("min_order", [0, 1])
@pytest.mark.parametrize("make", [_canyon, _city], ids=["canyon", "city"])
def test_mlm_with_carried_rays_equal(make, min_order: int, variant: str) -> None:
    ref_scene = _variant(make(), variant)
    scene = to_torch_scene(ref_scene)
    num_tx = scene.transmitters.shape[0]
    from differt_tpu.geometry import fibonacci_lattice

    directions = np.stack([np.asarray(fibonacci_lattice(3000))] * num_tx)
    directions[..., 2] = -np.abs(directions[..., 2])  # mostly downward
    bbox = np.asarray(ref_scene.mesh.bounding_box)
    ref = jax_mlm._compute_tx_mlm(
        ref_scene.mesh,
        ref_scene.transmitters.reshape(-1, 3),
        jnp.asarray(directions),
        jnp.asarray(1.5),
        jnp.asarray(bbox[0, :2]),
        jnp.asarray(bbox[1, :2]),
        order=2,
        min_order=min_order,
        grid_size=(32, 32),
        assume_quads=ref_scene.mesh.assume_quads,
    )
    ours = _mlm._compute_tx_mlm(
        scene.mesh,
        scene.transmitters.reshape(-1, 3),
        torch.from_numpy(directions),
        1.5,
        torch.from_numpy(bbox[0, :2].copy()),
        torch.from_numpy(bbox[1, :2].copy()),
        order=2,
        min_order=min_order,
        grid_size=(32, 32),
        assume_quads=scene.mesh.assume_quads,
    )
    assert ours.dtype == torch.int32 and ours.shape == (num_tx, 32, 32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert len(np.unique(ours.numpy())) > 3


def _cells_differ(ours: torch.Tensor, ref) -> float:
    return float(np.mean(ours.numpy() != np.asarray(ref)))


@pytest.fixture
def jax_lattice(monkeypatch):
    """Swap the port MLM's lattice for JAX's (same frustum, JAX's ulps)."""
    from differt_tpu.geometry import fibonacci_lattice

    def lattice(n, *, frustum):
        out = fibonacci_lattice(n, frustum=jnp.asarray(frustum.numpy()))
        return torch.from_numpy(np.array(out))

    def swap():
        monkeypatch.setattr(_mlm, "fibonacci_lattice", lattice)

    return swap


def _check_end_to_end(ref_scene, kw: dict, jax_lattice, *, own_lattice: bool) -> torch.Tensor:
    ref = ref_scene.compute_tx_mlm(**kw)
    torch_kw = {**kw, "grid_bounds": None if kw.get("grid_bounds") is None else np.array(kw["grid_bounds"])}
    scene = to_torch_scene(ref_scene)
    ours = scene.compute_tx_mlm(**torch_kw)
    assert ours.shape == ref.shape and ours.dtype == torch.int32
    if own_lattice:
        assert _cells_differ(ours, ref) <= 1e-3
    jax_lattice()
    np.testing.assert_array_equal(scene.compute_tx_mlm(**torch_kw).numpy(), np.asarray(ref))
    return ours


@pytest.mark.parametrize("variant", ["plain", "masked", "quads"])
@pytest.mark.parametrize("min_order", [0, 1])
@pytest.mark.parametrize("make", [_canyon, _city], ids=["canyon", "city"])
def test_mlm_end_to_end_matches(make, min_order: int, variant: str, jax_lattice) -> None:
    kw = {"num_rays": 2000, "min_order": min_order, **MLM_KW}
    ours = _check_end_to_end(
        _variant(make(), variant), kw, jax_lattice, own_lattice=variant != "masked"
    )
    assert len(np.unique(ours.numpy())) > 3


def test_mlm_map_runs(jax_lattice) -> None:
    # The settings of tests/test_scenes.py::test_mlm_map_runs.
    ours = _check_end_to_end(_canyon(), {"num_rays": 2000, **MLM_KW}, jax_lattice, own_lattice=True)
    assert ours.shape == (1, 32, 32)
    assert len(np.unique(ours.numpy())) > 3


def test_mlm_grid_bounds(jax_lattice) -> None:
    kw = {"num_rays": 2000, "grid_bounds": jnp.array([[-30.0, -40.0], [50.0, 20.0]]), **MLM_KW}
    _check_end_to_end(_city(), kw, jax_lattice, own_lattice=True)


# -- SBR ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CarriedLauncher(SBRPathLauncher):
    """An SBR launcher that launches the rays it is given."""

    directions: np.ndarray | None = None

    def launch_rays(self, scene):
        tx = scene.transmitters.reshape(-1, 3)
        directions = torch.from_numpy(self.directions).to(tx.device)
        return tx[:, None, :].expand_as(directions), directions


class JaxCarriedLauncher(JaxSBR):
    """The same in the JAX package (its own launcher recomputes the lattice
    under ``jit``, which moves directions by an ulp from the eager call)."""

    directions: Any = None

    def launch_rays(self, scene):
        tx = scene.transmitters.reshape(-1, 3)
        return jnp.broadcast_to(tx[:, None, :], self.directions.shape), self.directions


def _corridor() -> JaxScene:
    # The corridor_scene of tests/test_solvers.py.
    return JaxScene(
        transmitters=jnp.array([-4.0, 0.0, 0.0]),
        receivers=jnp.array([4.0, 0.0, 0.0]),
        mesh=JaxMesh.box(length=10.0, width=3.0, height=2.0, with_top=True),
    )


def _launch_city() -> JaxScene:
    scene = jax_scenes.urban_scene(2, 2)
    scene = tk.tree_at(lambda s: s.transmitters, scene, jnp.array([[0.0, 0.0, 40.0]]))
    return scene.with_receivers_grid(3, 2, height=1.5)


SBR_CASES = {
    "corridor": (_corridor, {"num_rays": 20_000, "max_dist": 1e-2}),
    "city": (_launch_city, {"num_rays": 20_000, "max_dist": 5.0}),
}


@pytest.fixture(scope="module", params=list(SBR_CASES))
def launched(request):
    """Both packages' order-3 launches of the same rays."""
    make, kw = SBR_CASES[request.param]
    ref_scene = make()
    directions = np.array(JaxSBR(**kw).launch_rays(ref_scene)[1])
    with jax.disable_jit():
        ref = ref_scene.launch_paths(
            order=3, solver=JaxCarriedLauncher(directions=jnp.asarray(directions), **kw)
        )
    scene = to_torch_scene(ref_scene)
    ours = scene.launch_paths(order=3, solver=CarriedLauncher(directions=directions, **kw))
    return ref_scene, scene, kw, directions, ref, ours


def _assert_paths_equal(ours, ref) -> None:
    assert tuple(ours.shape) == tuple(ref.shape)
    mask = ours.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.objects.numpy(), np.asarray(ref.objects))
    np.testing.assert_array_equal(
        ours.interaction_types.numpy(), np.asarray(ref.interaction_types)
    )
    np.testing.assert_allclose(
        ours.vertices.numpy()[mask], np.asarray(ref.vertices)[mask], atol=1e-4, rtol=0
    )


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_launch_paths_with_carried_rays_equal(launched, order: int) -> None:
    *_, ref, ours = launched
    assert isinstance(ours, LaunchedPaths)
    assert ours.order == 3 and ours.path_length == 5
    np.testing.assert_array_equal(ours.masks.numpy(), np.asarray(ref.masks))
    np.testing.assert_array_equal(ours.objects.numpy(), np.asarray(ref.objects))
    _assert_paths_equal(ours.get_paths(order), ref.get_paths(order))
    assert bool(ours.masks[..., 0].any()) and bool(ours.masks[..., 1:].any())


@pytest.mark.parametrize("order", [0, 1, 2])
def test_launch_paths_of_lower_order_equal(launched, order: int) -> None:
    # Launching at a lower order gives the first masks of the higher one.
    ref_scene, scene, kw, directions, ref, ours_3 = launched
    ours = scene.launch_paths(order=order, solver=CarriedLauncher(directions=directions, **kw))
    assert ours.order == order
    np.testing.assert_array_equal(ours.masks.numpy(), ours_3.masks[..., : order + 1].numpy())
    _assert_paths_equal(ours.get_paths(order), ref.get_paths(order))


def test_launch_rays_match(launched) -> None:
    ref_scene, scene, kw, *_ = launched
    ref_o, ref_d = JaxSBR(**kw).launch_rays(ref_scene)
    o, d = SBRPathLauncher(**kw).launch_rays(scene)
    np.testing.assert_array_equal(o.numpy(), np.asarray(ref_o))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-6, rtol=0)


def test_launched_paths_reshape_and_squeeze(launched) -> None:
    *_, ours = launched
    flat = ours.reshape(-1)
    assert flat.shape == (int(np.prod(ours.shape)),)
    assert torch.equal(flat.masks, ours.masks.reshape(-1, 4))
    squeezed = ours.squeeze()
    assert 1 not in squeezed.shape and squeezed.vertices.shape[-2:] == (5, 3)
    with pytest.raises(ValueError, match="between 0 and 3"):
        ours.get_paths(4)


def test_launch_paths_end_to_end_runs() -> None:
    # The port's own lattice, through the solver shortcut, counted.
    scene = to_torch_scene(_launch_city())
    calls = _closest.REFERENCE_CALLS
    paths = scene.launch_paths(order=2, num_rays=5000, max_dist=5.0)
    assert _closest.REFERENCE_CALLS == calls + 3  # order + 1 closest-hit queries
    assert paths.shape == (1, 2, 3, 5000)
    assert bool(paths.masks[..., 0].any()) and bool(paths.masks[..., 1:].any())
    with pytest.raises(ValueError, match="No solver"):
        scene.launch_paths(order=1, solver="exhaustive")
    with pytest.raises(ValueError, match="conflict"):
        scene.launch_paths(order=1, solver=SBRPathLauncher(), num_rays=10)
    with pytest.raises(ValueError, match="order"):
        scene.launch_paths()


def test_torch_backend_is_counted() -> None:
    scene = to_torch_scene(_canyon())
    calls = _closest.REFERENCE_CALLS
    try:
        ops.set_backend("torch")
        scene.compute_tx_mlm(num_rays=500, **MLM_KW)
    finally:
        ops.set_backend("auto")
    assert _closest.REFERENCE_CALLS == calls + 3
