"""Parity of the port's fused trace and trace pipeline with the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.geometry import Mesh as JaxMesh
from differt_tpu.geometry import Scene as JaxScene
from differt_tpu.geometry import generate_all_path_candidates
from differt_tpu.ops._pallas_trace import pallas_trace_specular
from differt_tpu.rt import trace_path_candidates as jax_trace_path_candidates
from differt_tpu_torch.ops import _trace
from differt_tpu_torch.rt import trace_path_candidates

from .torch_parity import EPSILON, HIT_TOL, to_torch_scene

torch.set_num_threads(1)

MIN_LEN = EPSILON  # 10 * eps(float32), the trace's default


def box_scene(*, quads=False, masked=False, grid=False) -> JaxScene:
    """The scenes of tests/test_pallas_trace.py."""
    if grid:
        mesh = JaxMesh.box(length=20.0, width=8.0, height=6.0, with_top=True)
        tx = jnp.array([[-6.0, 0.0, 0.0], [6.0, 1.0, 1.0]])
        rx = jnp.array([[x, y, 0.0] for x in (-3.0, 0.0, 3.0) for y in (-1.0, 1.0)])
    else:
        mesh = JaxMesh.box(length=10.0, width=3.0, height=2.0, with_top=True)
        tx = jnp.array([[-4.0, 0.0, 0.0], [0.0, 1.0, 0.5]] if quads else [[-4.0, 0.0, 0.0]])
        rx = jnp.array([[4.0, 0.0, 0.0]] if masked else [[4.0, 0.0, 0.0], [3.0, 0.5, 0.3]])
    if quads:
        mesh = mesh.set_assume_quads()
    if masked:
        mesh = mesh.set_mask(jnp.ones(mesh.num_triangles, dtype=bool).at[:2].set(False))
    return JaxScene(transmitters=tx, receivers=rx, mesh=mesh)


CASES = {
    "order1": (box_scene(), 1),
    "order2": (box_scene(), 2),
    "masked": (box_scene(masked=True), 1),
    "multi_tx_rx": (box_scene(grid=True), 1),
    "quads1": (box_scene(quads=True), 1),
    "quads2": (box_scene(quads=True), 2),
}


def kernel_inputs(scene: JaxScene, order: int) -> dict:
    """The fused kernel's inputs as numpy arrays, prepared as the trace prepares them."""
    mesh = scene.mesh
    cands = np.asarray(generate_all_path_candidates(mesh.num_primitives, order))
    k = 2 if mesh.assume_quads else 1
    if mesh.assume_quads:
        cands = np.repeat(2 * cands, 2, axis=-1)
        cands[..., 1::2] += 1
    verts = np.asarray(mesh.vertices)
    tris = np.asarray(mesh.triangles)[cands]
    cand_tv = verts[tris]
    return {
        "tx": np.asarray(scene.transmitters).reshape(-1, 3),
        "rx": np.asarray(scene.receivers).reshape(-1, 3),
        "mv": np.ascontiguousarray(cand_tv[:, ::k, 0, :]),
        "mn": np.asarray(mesh.normals)[cands[:, ::k]],
        "ct": cand_tv,
        "tv": np.asarray(mesh.triangle_vertices),
        "active": None if mesh.mask is None else np.asarray(mesh.mask),
    }


def _as(module, arrays: dict, device="cpu"):
    if module is torch:
        return [None if a is None else torch.from_numpy(np.array(a)).to(device) for a in arrays.values()]
    return [None if a is None else jnp.asarray(a) for a in arrays.values()]


def assert_paths_match(mask, verts, want_mask, want_verts) -> None:
    mask, want_mask = np.asarray(mask), np.asarray(want_mask)
    np.testing.assert_array_equal(mask, want_mask)
    valid = want_mask
    assert valid.sum() > 0
    np.testing.assert_allclose(np.asarray(verts)[valid], np.asarray(want_verts)[valid], atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_trace_reference_matches_pallas(case: str) -> None:
    scene, order = CASES[case]
    inputs = kernel_inputs(scene, order)
    kw = {"order": order, "epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": MIN_LEN}
    verts, mask = _trace.trace_specular_reference(*_as(torch, inputs), **kw)
    want_verts, want_mask = pallas_trace_specular(*_as(jnp, inputs), **kw)
    assert tuple(verts.shape) == want_verts.shape and tuple(mask.shape) == want_mask.shape
    assert_paths_match(mask, verts.numpy(), want_mask, want_verts)


@pytest.mark.parametrize("megakernel", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_trace_path_candidates_matches_jax(case: str, megakernel: bool) -> None:
    scene, order = CASES[case]
    ours = to_torch_scene(scene)
    cands = generate_all_path_candidates(scene.mesh.num_primitives, order)
    if scene.mesh.assume_quads:
        cands = 2 * cands
    want = jax_trace_path_candidates(
        scene.mesh,
        scene.transmitters.reshape(-1, 3),
        scene.receivers.reshape(-1, 3),
        cands,
        jnp.zeros_like(cands),
        megakernel=megakernel,
    )
    got = trace_path_candidates(
        ours.mesh,
        ours.transmitters.reshape(-1, 3),
        ours.receivers.reshape(-1, 3),
        torch.from_numpy(np.array(cands)).to(torch.int64),
        torch.zeros(cands.shape, dtype=torch.int32),
        megakernel=megakernel,
    )
    assert got.shape == want.shape
    assert_paths_match(got.mask, got.vertices.numpy(), want.mask, want.vertices)
    np.testing.assert_array_equal(got.objects.numpy(), np.asarray(want.objects))


def test_canyon_trace_paths_orders() -> None:
    """Scene.trace_paths on the street canyon, orders 0-2, against the JAX pipeline."""
    from differt_tpu import scenes as jax_scenes

    ref = jax_scenes.street_canyon_scene()
    ref = JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]), mesh=ref.mesh
    ).with_receivers_grid(6, 5)
    ours = to_torch_scene(ref)
    for order in (0, 1, 2):
        want = ref.trace_paths(order=order, megakernel=False)
        got = ours.trace_paths(order=order, megakernel=False)
        assert got.shape == want.shape
        assert_paths_match(got.mask, got.vertices.numpy(), want.mask, want.vertices)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_unfused_blockage_inputs_give_the_jax_masks(order: int) -> None:
    """The unfused pipeline's blockage inputs, blocked through the any-hit
    segments the dispatch hands the kernel, give the masks of
    ``trace_path_candidates(megakernel=False)`` and of the JAX pipeline."""
    from differt_tpu import scenes as jax_scenes
    from differt_tpu_torch.ops import _rt
    from differt_tpu_torch.ops._dispatch import anyhit_segments
    from differt_tpu_torch.rt._solvers import candidate_geometry, unfused_blockage_inputs

    ref = JaxScene(
        transmitters=jnp.array([[-30.0, 0.0, 20.0]]), mesh=jax_scenes.street_canyon_scene().mesh
    ).with_receivers_grid(6, 5)
    ours = to_torch_scene(ref)
    mesh = ours.mesh
    tx, rx = ours.transmitters.reshape(-1, 3), ours.receivers.reshape(-1, 3)
    cands = torch.from_numpy(
        np.array(generate_all_path_candidates(mesh.num_primitives, order))
    ).to(torch.int64)
    _, tris, mv, mn = candidate_geometry(mesh, cands)
    _, origins, directions, alive = unfused_blockage_inputs(
        tx, rx, tris, mv, mn, 1, epsilon=None, min_len=MIN_LEN
    )
    *segments, thresh = anyhit_segments(origins, directions, active_rays=alive[..., None])
    assert thresh.shape == (alive.numel() * (order + 1),)
    assert torch.equal(thresh >= 0, alive[..., None].expand(*alive.shape, order + 1).reshape(-1))
    blocked = _rt.ray_intersect_any_triangle_reference(
        *segments, mesh.triangle_vertices, hit_threshold=thresh
    ).reshape(*alive.shape, order + 1)
    mask = alive & ~blocked.any(dim=-1)
    got = trace_path_candidates(mesh, tx, rx, cands, megakernel=False)
    want = jax_trace_path_candidates(
        ref.mesh,
        ref.transmitters.reshape(-1, 3),
        ref.receivers.reshape(-1, 3),
        jnp.asarray(cands.numpy()),
        megakernel=False,
    )
    np.testing.assert_array_equal(got.mask.numpy(), mask.numpy())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want.mask))
    assert 0 < int(mask.sum()) < int(alive.sum()) or order == 0


def test_trace_kernel_needs_order_one() -> None:
    scene = to_torch_scene(box_scene())
    with pytest.raises(ValueError, match="order >= 1"):
        trace_path_candidates(
            scene.mesh,
            scene.transmitters,
            scene.receivers,
            torch.zeros((1, 0), dtype=torch.int64),
            megakernel=True,
        )
