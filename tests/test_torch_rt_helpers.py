"""The ``rt`` helpers the JAX package exports beside its solvers, against it, on seeded numpy inputs.

``image_of_vertex_with_respect_to_mirror`` and ``intersection_of_ray_with_plane``
(the two steps of the port's image method) and
``triangle_contains_vertex_assuming_inside_same_plane``; also the last public
names: ``rt.AbstractPathSolver`` as the common base of tracers and
launchers, and ``em.ItuProperties``.
"""

import jax
import numpy as np
import pytest
import torch

from differt_tpu import rt as jax_rt
from differt_tpu_torch import em, rt

from . import torch_parity  # noqa: F401  (its first calls of the CPU math)

torch.set_num_threads(1)


def _unit(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_image_of_vertex_matches_jax() -> None:
    rng = np.random.default_rng(11)
    vertex = rng.normal(size=(64, 3)).astype(np.float32)
    mirror_vertex = rng.normal(size=(64, 3)).astype(np.float32)
    normal = _unit(rng.normal(size=(64, 3)))
    got = rt.image_of_vertex_with_respect_to_mirror(*map(torch.from_numpy, (vertex, mirror_vertex, normal)))
    want = jax_rt.image_of_vertex_with_respect_to_mirror(vertex, mirror_vertex, normal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # Broadcast: one mirror for every vertex; the image of the image is the vertex.
    back = rt.image_of_vertex_with_respect_to_mirror(got, torch.from_numpy(mirror_vertex), torch.from_numpy(normal))
    np.testing.assert_allclose(back.numpy(), vertex, atol=1e-5)


def test_intersection_of_ray_with_plane_matches_jax() -> None:
    rng = np.random.default_rng(12)
    origin = rng.normal(size=(64, 3)).astype(np.float32)
    direction = rng.normal(size=(64, 3)).astype(np.float32)
    plane_vertex = rng.normal(size=(64, 3)).astype(np.float32)
    normal = _unit(rng.normal(size=(64, 3)))
    # Two rays parallel to their plane: one off it (inf), one in it (its origin).
    for i, offset in ((0, 1.0), (1, 0.0)):
        normal[i] = (0.0, 0.0, 1.0)
        direction[i, 2] = 0.0
        origin[i] = plane_vertex[i] + offset * normal[i]
    args = (origin, direction, plane_vertex, normal)
    got = rt.intersection_of_ray_with_plane(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jax_rt.intersection_of_ray_with_plane(*args))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want).all(-1)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5, atol=1e-5)


def test_image_method_is_the_two_steps() -> None:
    """The port's image method runs on the two helpers: its points are theirs, bit for bit."""
    rng = np.random.default_rng(13)
    tx, rx = (torch.from_numpy(rng.normal(size=(16, 3)).astype(np.float32)) for _ in range(2))
    mv = torch.from_numpy(rng.normal(size=(16, 1, 3)).astype(np.float32))
    mn = torch.from_numpy(_unit(rng.normal(size=(16, 1, 3))))
    image = rt.image_of_vertex_with_respect_to_mirror(tx, mv[:, 0], mn[:, 0])
    point = rt.intersection_of_ray_with_plane(rx, image - rx, mv[:, 0], mn[:, 0])
    assert torch.equal(rt.image_method(tx, rx, mv, mn)[:, 0], point)


@pytest.mark.parametrize("coplanar", [True, False], ids=["in_plane", "off_plane"])
def test_triangle_contains_vertex_matches_jax(coplanar: bool) -> None:
    rng = np.random.default_rng(14)
    tri = rng.normal(size=(256, 3, 3)).astype(np.float32)
    w = rng.uniform(-0.5, 1.2, (256, 3)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    vertex = np.einsum("nk,nkd->nd", w, tri).astype(np.float32)  # in each plane (barycentric)
    if not coplanar:
        vertex = rng.normal(size=(256, 3)).astype(np.float32)
    got = rt.triangle_contains_vertex_assuming_inside_same_plane(torch.from_numpy(tri), torch.from_numpy(vertex))
    with jax.disable_jit():  # the same-side dots op by op: XLA's fused multiply-adds move them by an ulp
        want = jax_rt.triangle_contains_vertex_assuming_inside_same_plane(tri, vertex)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if coplanar:
        inside = (w >= 1e-3).all(-1)
        outside = (w <= -1e-3).any(-1)
        assert got.numpy()[inside].all() and not got.numpy()[outside].any()
        assert 0 < int(got.sum()) < 256


def test_last_public_names() -> None:
    for cls in (rt.AbstractPathTracer, rt.AbstractPathLauncher, rt.ExhaustivePathTracer, rt.SBRPathLauncher):
        assert issubclass(cls, rt.AbstractPathSolver)
    assert rt.ExhaustivePathTracer().epsilon is None and rt.SBRPathLauncher().hit_tol is None
    row = em.materials["Concrete"].rows[0]
    assert len(row) == len(em.ItuProperties.__args__) == 5
    for name in (
        "AbstractPathSolver",
        "image_of_vertex_with_respect_to_mirror",
        "intersection_of_ray_with_plane",
        "triangle_contains_vertex_assuming_inside_same_plane",
    ):
        assert name in rt.__all__ and hasattr(jax_rt, name)
    assert "ItuProperties" in em.__all__
