"""Parity of the port's any-hit path with the JAX package, and its kernel with its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu import rt as jax_rt
from differt_tpu import scenes as jax_scenes
from differt_tpu.ops import _pallas_rt as jax_prt
from differt_tpu.ops._dispatch import dispatch_ray_intersect_any_triangle as jax_dispatch
from differt_tpu_torch import rt
from differt_tpu_torch.ops import _rt
from differt_tpu_torch.ops import dispatch_ray_intersect_any_triangle
from differt_tpu_torch.ops._bvh import build_bvh

from .torch_parity import HIT_TOL, random_segments, to_torch_scene, triangle_mask

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def city():
    """A small city (146 triangles) in both packages."""
    ref = jax_scenes.urban_scene(2, 2)
    return ref, to_torch_scene(ref)


@pytest.mark.parametrize("num_points", [4, 257, 20_738])
def test_morton_permutation_equal(num_points: int) -> None:
    rng = np.random.default_rng(num_points)
    points = rng.uniform(-300.0, 300.0, (num_points, 3)).astype(np.float32)
    points[: num_points // 4] = points[0]  # ties keep the stable order
    ours = _rt.morton_perm_points(torch.from_numpy(points))
    ref = np.asarray(jax_prt.morton_perm_points(jnp.asarray(points)))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_morton_triangle_permutation_equal() -> None:
    ref = jax_scenes.urban_scene(24, 24).mesh
    tv = np.asarray(ref.triangle_vertices)
    ours = _rt._morton_perm(torch.from_numpy(np.array(tv)))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jax_prt._morton_perm(jnp.asarray(tv))))


@pytest.mark.parametrize("masked", [False, True])
def test_chunk_and_tile_aabbs_match(city, masked: bool) -> None:
    ref, _ = city
    tv = np.asarray(ref.mesh.triangle_vertices)
    num = tv.shape[0]
    padded = -(-num // 64) * 64
    soa = np.concatenate((tv[:, 0], tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), -1).T
    soa = np.pad(soa, ((0, 0), (0, padded - num)))
    active = triangle_mask(num, 3) if masked else np.ones(num, dtype=bool)
    active[-64:] = False  # one fully inactive chunk
    active = np.pad(active.astype(np.int32), (0, padded - num))[None]
    ours = _rt._chunk_aabbs(torch.from_numpy(soa), torch.from_numpy(active))
    want = np.asarray(jax_prt._chunk_aabbs(jnp.asarray(soa), jnp.asarray(active)))
    np.testing.assert_allclose(ours.numpy(), want, atol=1e-6)
    # The tile fold, on a whole number of tiles.
    chunks = np.concatenate([want] * 4, axis=1)
    tiles = _rt._tile_aabbs(torch.from_numpy(chunks), 2)
    np.testing.assert_allclose(
        tiles.numpy(), np.asarray(jax_prt._tile_aabbs(jnp.asarray(chunks), 128)), atol=1e-6
    )


def test_slab_overlap_matches(city) -> None:
    ref, _ = city
    bbox = np.asarray(ref.mesh.bounding_box)
    start, direction, _ = random_segments(bbox, 512, 5)
    direction[:16, 0] = 0.0  # axis-parallel segments take the tiny clamp
    box = [-20.0, -30.0, 0.0, 25.0, 10.0, 30.0]
    o = [start[:, c][None] for c in range(3)]
    d = [direction[:, c][None] for c in range(3)]
    want = np.asarray(
        jax_prt._slab_overlap([jnp.asarray(x) for x in o], [jnp.asarray(x) for x in d], box, 1.0)
    )
    ours = _rt._slab_overlap(
        [torch.from_numpy(x) for x in o], [torch.from_numpy(x) for x in d], box, 1.0
    )
    np.testing.assert_array_equal(ours.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("masked", [False, True])
def test_anyhit_reference_matches_pallas_and_scan(city, masked: bool) -> None:
    ref, ours = city
    tv = np.asarray(ref.mesh.triangle_vertices)
    start, direction, active_rays = random_segments(np.asarray(ref.mesh.bounding_box), 1024, 7)
    active_tris = triangle_mask(tv.shape[0], 11) if masked else None
    thresh = np.where(active_rays, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)

    got = _rt.ray_intersect_any_triangle_reference(
        torch.from_numpy(start),
        torch.from_numpy(direction),
        ours.mesh.triangle_vertices,
        None if active_tris is None else torch.from_numpy(active_tris),
        hit_threshold=torch.from_numpy(thresh),
    ).numpy()
    pallas = np.asarray(
        jax_prt.pallas_ray_intersect_any_triangle(
            jnp.asarray(start),
            jnp.asarray(direction),
            jnp.asarray(tv),
            None if active_tris is None else jnp.asarray(active_tris),
            hit_threshold=jnp.asarray(thresh),
        )
    )
    scan = np.asarray(
        jax_rt.ray_intersect_any_triangle(
            jnp.asarray(start),
            jnp.asarray(direction),
            jnp.asarray(tv),
            None if active_tris is None else jnp.asarray(active_tris),
            hit_tol=2.0 * HIT_TOL,
        )
    ) & active_rays
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, scan)
    assert 0 < got.sum() < active_rays.sum()

    # The port's own scan form agrees too.
    port_scan = rt.ray_intersect_any_triangle(
        torch.from_numpy(start),
        torch.from_numpy(direction),
        ours.mesh.triangle_vertices,
        None if active_tris is None else torch.from_numpy(active_tris),
        hit_tol=2.0 * HIT_TOL,
        batch_size=37,
    ).numpy()
    np.testing.assert_array_equal(port_scan & active_rays, got)


@pytest.mark.parametrize("masked", [False, True])
def test_dispatch_matches_jax(city, masked: bool) -> None:
    ref, ours = city
    mesh_ref, mesh = ref.mesh, ours.mesh
    if masked:
        mask = triangle_mask(mesh.num_triangles, 13)
        mesh_ref = mesh_ref.set_mask(jnp.asarray(mask))
        mesh = mesh.set_mask(torch.from_numpy(mask))
    start, direction, active_rays = random_segments(np.asarray(ref.mesh.bounding_box), 600, 17)
    start, direction = start.reshape(20, 30, 3), direction.reshape(20, 30, 3)
    direction[0, :5] = np.inf  # wild segments of inactive rays are sanitized
    active_rays = active_rays.reshape(20, 30)
    active_rays[0, :5] = False
    got = dispatch_ray_intersect_any_triangle(
        mesh,
        torch.from_numpy(start),
        torch.from_numpy(direction),
        active_rays=torch.from_numpy(active_rays),
    )
    want = jax_dispatch(
        mesh_ref,
        jnp.asarray(start),
        jnp.asarray(direction),
        active_rays=jnp.asarray(active_rays),
    )
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any()


def test_dispatch_empty_mesh_blocks_nothing() -> None:
    from differt_tpu_torch.geometry import Mesh

    out = dispatch_ray_intersect_any_triangle(Mesh.empty(device="cpu"), torch.zeros(4, 3), torch.ones(4, 3))
    assert out.shape == (4,) and not out.any()


@pytest.mark.parametrize("masked", [False, True])
def test_prepare_mesh_layout(city, masked: bool) -> None:
    """The kernels' BVH holds every active triangle, in Morton order, inside its leaf's box."""
    _, ours = city
    tv = ours.mesh.triangle_vertices
    active = torch.from_numpy(triangle_mask(tv.shape[0], 19)) if masked else None
    bvh = build_bvh(tv, active)
    num = tv.shape[0]
    perm = _rt._morton_perm(tv)
    assert torch.equal(bvh.perm, perm)
    tris = bvh.triangles
    pos = tris.view(torch.int32)[:, 10].long()
    live = tris[:, 9] > 0
    want_active = torch.ones(num, dtype=torch.bool) if active is None else active[perm]
    index = torch.arange(tris.shape[0])
    real = (index < num - bvh.num_large) | (index >= bvh.large_begin)  # not leaf padding
    assert torch.equal(torch.sort(pos[real]).values, torch.arange(num))
    assert torch.equal(live, want_active[pos] & real)
    torch.testing.assert_close(tris[live, :3], tv[perm[pos[live]], 0], rtol=0, atol=0)
    # Every active tree triangle lies inside its leaf's box.
    leaves = bvh.nodes[-(1 << bvh.depth) :]
    corners = torch.stack(
        (tris[:, :3], tris[:, :3] + tris[:, 3:6], tris[:, :3] + tris[:, 6:9]), dim=1
    )[: bvh.large_begin][live[: bvh.large_begin]]
    box = leaves[torch.nonzero(live[: bvh.large_begin]).squeeze(-1) // bvh.leaf_size]
    assert (corners >= box[:, None, :3]).all() and (corners <= box[:, None, 4:7]).all()


def test_wrapper_rejects_other_devices_and_bad_inputs() -> None:
    tv = torch.zeros(2, 3, 3)
    rays = torch.zeros(4, 3)
    thresh = torch.ones(4)
    with pytest.raises(ValueError, match="CUDA"):
        _rt.ray_intersect_any_triangle_cuda(
            rays.to("meta"), rays.to("meta"), tv.to("meta"), hit_threshold=thresh.to("meta")
        )
    before = _rt.REFERENCE_CALLS
    _rt.ray_intersect_any_triangle_cuda(rays, rays, tv, hit_threshold=thresh)
    assert _rt.REFERENCE_CALLS == before + 1
