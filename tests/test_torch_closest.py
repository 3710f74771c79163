"""Parity of the port's closest-hit path with the JAX package.

- The plain scan (``rt.first_triangle_hit_by_ray``) against JAX's: indices
  equal, ``t`` within ``1e-6`` (float32 Möller–Trumbore, op for op).
- The wrapper's CPU path (the kernel's plain version) against the Pallas
  kernel run in interpret mode: ``t`` within ``1e-6``; indices equal except
  on exact ties, which the sorted kernel may break another way; and the
  card kernel's tie key picks the Pallas kernel's index on every ray.
- The differentiable distance of ``Mesh.first_triangle_hit_by_ray``
  against ``jax.grad``: ``rtol=1e-5`` (``atol=1e-6`` for entries near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import rt as jax_rt
from differt_tpu import scenes as jax_scenes
from differt_tpu import treekit as tk
from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import fibonacci_lattice as jax_lattice
from differt_tpu.ops._pallas_rt import pallas_first_triangle_hit_by_ray
from differt_tpu_torch import ops, rt
from differt_tpu_torch.geometry import Mesh, fibonacci_lattice
from differt_tpu_torch.interop import mesh_from_numpy
from differt_tpu_torch.ops import _closest
from differt_tpu_torch.ops._bvh import build_bvh

from .torch_parity import jax_scene_fields

torch.set_num_threads(1)

T_ATOL = 1e-6


def _to_torch_mesh(mesh) -> Mesh:
    return mesh_from_numpy(jax_scene_fields(jax_scenes.Scene(mesh=mesh))["mesh"], device="cpu")


def _box_rays():
    """The ``box_rays`` inputs of ``tests/test_pallas.py``."""
    mesh = JaxMesh.box(2.0, 1.5, 1.0, with_top=True)
    origins = jax.random.uniform(jax.random.key(0), (200, 3), minval=-0.3, maxval=0.3)
    directions = jax_lattice(200) * 3.0
    return mesh, origins, directions


def _many_boxes():
    """60 stacked boxes (720 triangles, coincident walls: many exact ties)."""
    mesh = JaxMesh.box(1.0, 1.0, 1.0, with_top=True)
    for i in range(1, 60):
        mesh = mesh + JaxMesh.box(1.0 + 0.1 * i, 1.0, 1.0, with_top=True)
    origins = jax.random.uniform(jax.random.key(3), (64, 3), minval=-0.3, maxval=0.3)
    return mesh, origins, jax_lattice(64) * 3.0


def _city():
    """``urban_scene(4, 4)`` (578 triangles) and lattice rays from above a street."""
    mesh = jax_scenes.urban_scene(4, 4).mesh
    origins = jnp.broadcast_to(jnp.array([25.0, 0.0, 30.0]), (500, 3))
    return mesh, origins, jax_lattice(500) * 300.0


CASES = {"box": _box_rays, "boxes60": _many_boxes, "city4x4": _city}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    mesh, origins, directions = CASES[request.param]()
    torch_mesh = _to_torch_mesh(mesh)
    o = torch.from_numpy(np.array(origins))
    d = torch.from_numpy(np.array(directions))
    return request.param, mesh, origins, directions, torch_mesh, o, d


def _mask(num: int) -> np.ndarray:
    return np.arange(num) % 3 != 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch_size", [512, None, 3])
def test_plain_scan_matches_jax(case, masked: bool, batch_size) -> None:
    _, mesh, origins, directions, torch_mesh, o, d = case
    tv = mesh.triangle_vertices
    active = _mask(mesh.num_triangles) if masked else None
    idx_ref, t_ref = jax_rt.first_triangle_hit_by_ray(
        origins, directions, tv, None if active is None else jnp.asarray(active),
        batch_size=batch_size,
    )
    idx, t = rt.first_triangle_hit_by_ray(
        o, d, torch_mesh.triangle_vertices,
        None if active is None else torch.from_numpy(active),
        batch_size=batch_size,
    )
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=T_ATOL, rtol=0)
    assert (idx >= 0).any() and bool(torch.isinf(t[idx < 0]).all())


@pytest.mark.parametrize("masked", [False, True])
def test_wrapper_matches_pallas_interpret(case, masked: bool) -> None:
    name, mesh, origins, directions, torch_mesh, o, d = case
    tv = mesh.triangle_vertices
    active = _mask(mesh.num_triangles) if masked else None
    idx_ref, t_ref = pallas_first_triangle_hit_by_ray(
        origins, directions, tv, None if active is None else jnp.asarray(active)
    )
    idx_ref, t_ref = np.asarray(idx_ref), np.asarray(t_ref)
    torch_tv = torch_mesh.triangle_vertices.contiguous()
    torch_active = None if active is None else torch.from_numpy(active)
    launches, calls = _closest.LAUNCHES, _closest.REFERENCE_CALLS
    idx, t = _closest.first_triangle_hit_by_ray_cuda(o, d, torch_tv, torch_active)
    # On CPU tensors the wrapper runs the plain version and launches nothing.
    assert (_closest.LAUNCHES, _closest.REFERENCE_CALLS) == (launches, calls + 1)
    np.testing.assert_allclose(t.numpy(), t_ref, atol=T_ATOL, rtol=0)
    differ = idx.numpy() != idx_ref
    if name == "box":
        assert not differ.any()  # no ray of these hits an edge
    # Where the indices differ (coincident walls, shared edges), the Pallas
    # kernel's triangle is a true tie: the plain t for it is the best t.
    rays = np.flatnonzero(differ)
    if rays.size:
        t_of, hit = rt.ray_intersect_triangle(
            o[rays], d[rays], torch_tv[torch.from_numpy(idx_ref[rays])]
        )
        assert bool(hit.all())
        np.testing.assert_array_equal(t_of.numpy(), t.numpy()[rays])
    # The card kernel's tie key (larger Morton chunk, then smaller Morton
    # position) is the Pallas kernel's rule: its winner is the Pallas index
    # on every ray.
    positions = build_bvh(torch_tv, torch_active).positions
    winner = _closest.tie_key_winner(o, d, torch_tv, torch_active, t, positions)
    np.testing.assert_array_equal(winner.numpy(), idx_ref)


def test_wrapper_on_cpu_equals_reference(case) -> None:
    *_, torch_mesh, o, d = case
    tv = torch_mesh.triangle_vertices.contiguous()
    got = ops.first_triangle_hit_by_ray_cuda(o, d, tv)
    want = ops.first_triangle_hit_by_ray_reference(o, d, tv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_reference_blocks_many_rays(monkeypatch) -> None:
    # The plain version runs rays in blocks of _MAX_PAIRS // 512; blocks of
    # 5 rays give the same answers as one block.
    mesh, origins, directions = _box_rays()
    tv = _to_torch_mesh(mesh).triangle_vertices
    o, d = torch.from_numpy(np.array(origins)), torch.from_numpy(np.array(directions))
    whole = _closest.first_triangle_hit_by_ray_reference(o, d, tv)
    monkeypatch.setattr(_closest, "_MAX_PAIRS", 5 * 512)
    blocked = _closest.first_triangle_hit_by_ray_reference(o, d, tv)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


def test_mesh_method_matches_jax(case) -> None:
    _, mesh, origins, directions, torch_mesh, o, d = case
    idx_ref, t_ref = mesh.first_triangle_hit_by_ray(origins, directions)
    idx, t = torch_mesh.first_triangle_hit_by_ray(o, d)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), atol=T_ATOL, rtol=0)
    # Rays broadcast: one origin against many directions.
    idx_b, t_b = torch_mesh.first_triangle_hit_by_ray(o[0], d[:7])
    idx_1, t_1 = torch_mesh.first_triangle_hit_by_ray(o[0].expand(7, 3), d[:7])
    assert torch.equal(idx_b, idx_1) and torch.equal(t_b, t_1)


def test_empty_mesh_misses() -> None:
    idx, t = Mesh.empty(device="cpu").first_triangle_hit_by_ray(torch.zeros(4, 3), torch.ones(4, 3))
    assert idx.tolist() == [-1] * 4 and bool(torch.isinf(t).all())


def test_closest_hit_distance_gradient() -> None:
    # Port of tests/test_rays.py::test_closest_hit_distance_gradient.
    mesh = Mesh.box(with_top=True, device="cpu")
    origin = torch.zeros(3, requires_grad=True)
    _, t = mesh.first_triangle_hit_by_ray(origin, torch.tensor([1.0, 0.0, 0.0]))
    (g,) = torch.autograd.grad(t, origin)
    # t = 0.5 - x0: dt/dx0 = -1.
    torch.testing.assert_close(g, torch.tensor([-1.0, 0.0, 0.0]), atol=1e-5, rtol=0)


def test_distance_gradients_match_jax() -> None:
    rng = np.random.default_rng(11)
    mesh = JaxMesh.box(2.0, 1.5, 1.0, with_top=True)
    # 48 rays from inside (all hit) and 16 from outside looking away (miss).
    inside = rng.uniform(-0.3, 0.3, (48, 3))
    outside = np.array([0.0, 0.0, 5.0]) + rng.uniform(-0.3, 0.3, (16, 3))
    origins = np.concatenate((inside, outside)).astype(np.float32)
    directions = rng.normal(size=(64, 3)).astype(np.float32)
    directions[48:, 2] = np.abs(directions[48:, 2]) + 0.5
    weights = rng.uniform(0.5, 1.5, 64).astype(np.float32)

    def jax_loss(vertices, o, d):
        m = tk.tree_at(lambda x: x.vertices, mesh, vertices)
        _, t = m.first_triangle_hit_by_ray(o, d)
        # t * t: the misses' cotangent is inf, which the backward zeroes.
        return jnp.sum(weights * t * t)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        mesh.vertices, jnp.asarray(origins), jnp.asarray(directions)
    )
    torch_mesh = _to_torch_mesh(mesh)
    inputs = [
        torch_mesh.vertices.clone().requires_grad_(True),
        torch.from_numpy(origins).requires_grad_(True),
        torch.from_numpy(directions).requires_grad_(True),
    ]
    idx, t = Mesh(vertices=inputs[0], triangles=torch_mesh.triangles).first_triangle_hit_by_ray(
        inputs[1], inputs[2]
    )
    assert not idx.requires_grad and bool((idx[:48] >= 0).all()) and bool((idx[48:] < 0).all())
    loss = (torch.from_numpy(weights) * t * t).sum()
    grads = torch.autograd.grad(loss, inputs)
    for ours, want in zip(grads, ref, strict=True):
        assert bool(torch.isfinite(ours).all())
        np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(grads[1][48:].abs().max()) == 0.0  # misses carry no gradient


@pytest.fixture
def backend():
    yield ops.set_backend
    ops.set_backend("auto")


def test_backend_switch(backend) -> None:
    mesh = Mesh.box(with_top=True, device="cpu")
    o, d = torch.zeros(5, 3), torch.ones(5, 3)
    assert ops.get_backend() == "auto"
    assert ops.get_backend(torch.device("cpu")) == "torch"
    backend("torch")
    calls = _closest.REFERENCE_CALLS
    mesh.first_triangle_hit_by_ray(o, d)
    assert _closest.REFERENCE_CALLS == calls + 1
    backend("cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        mesh.first_triangle_hit_by_ray(o, d)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mesh.ray_intersect_any_triangle(o, d)
    with pytest.raises(ValueError, match="Unknown backend"):
        backend("pallas")


# The visibility launch's lattice: slot order, the plain twin, the CPU path.

SLOT_SIZES = [1, 2, 31, 5_000, 1_000_000]


def _slot_indices(slots: torch.Tensor) -> torch.Tensor:
    """Each slot's lattice index, read back from its ``step = i / (n - 1)``."""
    n = slots.shape[0]
    return torch.round(slots[:, 0] * max(n - 1, 1)).long()


@pytest.mark.parametrize("n", SLOT_SIZES)
def test_lattice_slots_are_a_permutation(n: int) -> None:
    from differt_tpu_torch.geometry._lattice import _lattice_fractions, lattice_slots

    slots = lattice_slots(n, torch.device("cpu"))
    assert slots.dtype == torch.float32 and tuple(slots.shape) == (n, 4) and slots.is_contiguous()
    idx = _slot_indices(slots)
    assert torch.equal(idx.sort().values, torch.arange(n))
    # Each row holds its index's terms as fibonacci_lattice computes them.
    _, step, frac = _lattice_fractions(n, "cpu")
    assert torch.equal(slots, torch.stack((step, 1.0 - step, frac, 1.0 - frac), dim=-1)[idx])
    assert lattice_slots(n, torch.device("cpu")) is slots  # built once


def test_lattice_slots_reject_an_empty_lattice() -> None:
    from differt_tpu_torch.geometry._lattice import lattice_slots

    with pytest.raises(ValueError, match="strictly positive"):
        lattice_slots(0, torch.device("cpu"))


def _frustums() -> torch.Tensor:
    """``[4, 2, 3]``: a full circle, a narrow frustum, a degenerate polar band, and the
    frustum ``viewing_frustum`` widens from one (a plane seen edge-on)."""
    from differt_tpu_torch.rt._scan import visibility_frustums

    pi = torch.pi
    by_hand = torch.tensor(
        [
            [[0.0, 0.05, -pi], [0.0, 3.0, pi]],
            [[0.0, 1.2, 0.3], [0.0, 1.25, 0.35]],
            [[0.0, 1.0, -1.0], [0.0, 1.0, 1.5]],
        ]
    )
    plane = Mesh.plane(torch.zeros(3), normal=torch.tensor([0.0, 0.0, 1.0]), side_length=4.0, device="cpu")
    widened = visibility_frustums(torch.tensor([[6.0, 1.0, 0.0]]), plane.triangle_vertices, None)
    assert float(widened[0, 0, 1]) != float(widened[0, 1, 1])
    return torch.cat((by_hand, widened))


@pytest.mark.parametrize("n", [1, 2, 31, 5_000, 200_000])
def test_lattice_directions_are_the_lattice_in_slot_order(n: int) -> None:
    from differt_tpu_torch.geometry._lattice import frustum_terms, lattice_slots

    frusta = _frustums()
    slots = lattice_slots(n, torch.device("cpu"))
    got = _closest.lattice_directions(frustum_terms(frusta), slots)
    want = fibonacci_lattice(n, frustum=frusta)[:, _slot_indices(slots)]
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [5_000, 1_000_000])
def test_slot_runs_are_compact_patches(n: int) -> None:
    # Over the whole sphere, each warp's 32 rays in slot order lie within a
    # few lattice spacings (sqrt(4 pi / n) rad) of the warp's first ray; the
    # runs near the poles, where a band of cos(polar) is wide in angle, lie
    # within a few tens. 32 consecutive indices lie on a ring over the whole
    # azimuth span.
    from differt_tpu_torch.geometry._lattice import frustum_terms, lattice_slots

    sphere = torch.tensor([[[0.0, 0.0, -torch.pi], [0.0, torch.pi, torch.pi]]])
    runs = n // 32 * 32

    def radius(directions: torch.Tensor) -> torch.Tensor:
        d = directions[:runs].reshape(-1, 32, 3).double()
        cos = (d * d[:, :1]).sum(-1).clamp(-1.0, 1.0)
        return torch.arccos(cos).amax(dim=-1) / (4.0 * torch.pi / n) ** 0.5

    slots = lattice_slots(n, torch.device("cpu"))
    coherent = radius(_closest.lattice_directions(frustum_terms(sphere), slots)[0])
    in_index_order = radius(fibonacci_lattice(n, frustum=sphere)[0])
    assert float(coherent.median()) < 8.0 and float(coherent.quantile(0.99)) < 40.0
    assert float(in_index_order.median()) > 4.0 * float(coherent.median())


@pytest.mark.parametrize("masked", [False, True])
def test_lattice_visibility_on_cpu_is_the_composition(masked: bool) -> None:
    # The wrapper's CPU path, its plain version: the lattice, the plain
    # closest hit, the marks; the order of the rays cannot change a mark.
    from differt_tpu_torch import scenes
    from differt_tpu_torch.geometry._lattice import frustum_terms, lattice_slots
    from differt_tpu_torch.rt._scan import mark_visible, visibility_frustums

    mesh = scenes.urban_scene(4, 4, device="cpu").mesh
    if masked:
        mesh = mesh.set_mask(torch.from_numpy(_mask(mesh.num_triangles)))
    tv = mesh.triangle_vertices.contiguous()
    vertices = torch.tensor([[0.0, 0.0, 40.0], [25.0, 0.0, 1.5], [-50.0, 25.0, 1.5], [60.0, 60.0, 100.0]])
    n = 3_000
    frustum = visibility_frustums(vertices, tv, mesh.mask)
    got = torch.zeros((4, mesh.num_triangles + 1), dtype=torch.bool)
    launches = (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES)
    _closest.lattice_visibility_cuda(
        vertices, frustum_terms(frustum), lattice_slots(n, torch.device("cpu")), tv, mesh.mask, got
    )
    assert (_closest.LAUNCHES, _closest.LATTICE_LAUNCHES) == launches
    d = fibonacci_lattice(n, frustum=frustum)
    idx, _ = _closest.first_triangle_hit_by_ray_reference(
        vertices[:, None].expand_as(d).reshape(-1, 3), d.reshape(-1, 3), tv, mesh.mask
    )
    want = mark_visible(torch.zeros_like(got), idx.reshape(4, n))
    assert torch.equal(got, want)
    assert bool(got[:, :-1].any(dim=-1).all()) and not bool(got[:, :-1].all())


def test_visibility_dispatch_card_branch_on_cpu(monkeypatch) -> None:
    # The card's branch of the dispatch (groups of vertices, their frustum
    # terms, the slots) run on CPU tensors, where the launch's wrapper takes
    # its plain version: the marks of the lattice rays in index order.
    from differt_tpu_torch import scenes
    from differt_tpu_torch.ops import _dispatch
    from differt_tpu_torch.rt._scan import mark_visible, visibility_frustums

    mesh = scenes.urban_scene(4, 4, device="cpu").mesh
    vertices = torch.tensor([[0.0, 0.0, 40.0], [25.0, 0.0, 1.5], [-50.0, 25.0, 1.5]])
    n = 2_000
    monkeypatch.setattr(_dispatch, "get_backend", lambda device=None: "cuda")
    monkeypatch.setattr(_dispatch, "VISIBILITY_RAYS", 2 * n)  # vertices 0-1, then 2
    calls = _closest.REFERENCE_CALLS
    got = mesh.triangles_visible_from_vertex(vertices, num_rays=n)
    assert _closest.REFERENCE_CALLS == calls + 2  # the plain version once a group
    tv = mesh.triangle_vertices
    d = fibonacci_lattice(n, frustum=visibility_frustums(vertices, tv, None))
    idx, _ = _closest.first_triangle_hit_by_ray_reference(vertices[:, None].expand_as(d).reshape(-1, 3), d.reshape(-1, 3), tv)
    want = mark_visible(torch.zeros((3, mesh.num_triangles + 1), dtype=torch.bool), idx.reshape(3, n))
    assert torch.equal(got, want[:, :-1])
