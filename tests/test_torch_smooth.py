"""Parity of the port's sigmoid-smoothed ray primitives with the JAX package.

Values and gradients: the same numpy inputs go through the JAX function
(plain JAX: the smoothed pipeline reaches no Pallas kernel) and its
counterpart in the port, on the CPU. The smoothed trace built on them is
held against JAX in ``tests/test_torch_smooth_trace.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.rt import (
    consecutive_vertices_are_on_same_side_of_mirror as jax_same_side,
)
from differt_tpu.rt import ray_intersect_any_triangle as jax_any_hit
from differt_tpu.rt import ray_intersect_triangle as jax_ray_intersect_triangle
from differt_tpu.utils import smoothing_function as jax_smoothing_function
from differt_tpu_torch.rt import (
    consecutive_vertices_are_on_same_side_of_mirror,
    ray_intersect_any_triangle,
    ray_intersect_triangle,
)
from differt_tpu_torch.utils import max_with_initial, min_with_initial, smoothing_function

torch.set_num_threads(1)

ALPHA = 50.0


def _t(x, grad: bool = False) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _close(got, want, *, rtol=1e-5, atol=1e-5) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _rays_and_triangles(seed: int, num_rays: int = 40, num_triangles: int = 12):
    """Random float32 segments and triangles of a 4 m cube, most rays crossing some triangle."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-2.0, 2.0, (num_rays, 3)).astype(np.float32)
    directions = rng.uniform(-4.0, 4.0, (num_rays, 3)).astype(np.float32)
    triangles = rng.uniform(-2.0, 2.0, (num_triangles, 3, 3)).astype(np.float32)
    return origins, directions, triangles


@pytest.mark.parametrize("alpha", [1.0, 7.5, 50.0])
def test_smoothing_function(alpha: float) -> None:
    x = np.linspace(-3.0, 3.0, 41).astype(np.float32)
    xt = _t(x, grad=True)
    got = smoothing_function(xt, alpha)
    _close(got, jax_smoothing_function(jnp.asarray(x), alpha))
    (grad,) = torch.autograd.grad(got.sum(), xt)
    want = jax.grad(lambda v: jax_smoothing_function(v, alpha).sum())(jnp.asarray(x))
    _close(grad, want)
    assert float(smoothing_function(torch.tensor(0.0))) == 0.5


def test_min_max_with_initial_follow_jax_at_ties_and_on_empty_axes() -> None:
    # Two equal minima share the gradient; a minimum equal to `initial`
    # shares it with the constant; an empty axis gives `initial`.
    x = np.array([[0.2, 0.2, 0.9], [1.0, 1.0, 1.0], [0.3, 0.6, 0.4]], dtype=np.float32)
    xt = _t(x, grad=True)
    weights = torch.tensor([1.0, 2.0, 4.0])
    (grad,) = torch.autograd.grad((min_with_initial(xt, -1, 1.0) * weights).sum(), xt)
    want = jax.grad(lambda v: (v.min(axis=-1, initial=1.0) * jnp.asarray(weights.numpy())).sum())(
        jnp.asarray(x)
    )
    _close(grad, want)
    (grad,) = torch.autograd.grad((max_with_initial(xt, -1, 0.0) * weights).sum(), xt)
    want = jax.grad(lambda v: (v.max(axis=-1, initial=0.0) * jnp.asarray(weights.numpy())).sum())(
        jnp.asarray(x)
    )
    _close(grad, want)
    empty = torch.zeros((4, 0))
    assert min_with_initial(empty, -1, 1.0).tolist() == [1.0] * 4
    assert max_with_initial(empty, -1, 0.0).tolist() == [0.0] * 4


@pytest.mark.parametrize("seed", [0, 1])
def test_smoothed_ray_intersect_triangle(seed: int) -> None:
    origins, directions, triangles = _rays_and_triangles(seed)
    o, d, tv = (_t(x, grad=True) for x in (origins, directions, triangles))
    t, hit = ray_intersect_triangle(o[:, None], d[:, None], tv, smoothing_factor=ALPHA)
    assert hit.dtype == torch.float32 and hit.shape == (40, 12)

    def jax_fn(o_, d_, tv_):
        return jax_ray_intersect_triangle(o_[:, None], d_[:, None], tv_, smoothing_factor=ALPHA)

    want_t, want_hit = jax_fn(*(jnp.asarray(x) for x in (origins, directions, triangles)))
    _close(hit, want_hit)
    _close(t, want_t, rtol=1e-4, atol=1e-5)
    assert float(hit.min()) < 0.1 and float(hit.max()) > 0.5
    grads = torch.autograd.grad(hit.sum(), (o, d, tv))
    want = jax.grad(lambda *a: jax_fn(*a)[1].sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (origins, directions, triangles))
    )
    for g, w in zip(grads, want):
        _close(g, w, rtol=1e-4, atol=1e-5)


def test_smoothed_ray_parallel_to_the_triangle() -> None:
    # det == 0: the JAX package sets it to inf, so its |det| check reads 1.
    tri = np.array([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]], dtype=np.float32)
    o = np.array([[0.2, 0.2, 1.0]], dtype=np.float32)
    d = np.array([[1.0, 0.0, 0.0]], dtype=np.float32)
    _, hit = ray_intersect_triangle(_t(o), _t(d), _t(tri), smoothing_factor=ALPHA)
    _, want = jax_ray_intersect_triangle(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tri), smoothing_factor=ALPHA
    )
    _close(hit, want)


def test_smoothed_same_side_check() -> None:
    rng = np.random.default_rng(3)
    vertices = rng.normal(size=(6, 5, 4, 3)).astype(np.float32)
    mirror_vertices = rng.normal(size=(5, 2, 3)).astype(np.float32)
    normals = rng.normal(size=(5, 2, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    got = consecutive_vertices_are_on_same_side_of_mirror(
        _t(vertices), _t(mirror_vertices), _t(normals), smoothing_factor=ALPHA
    )
    want = jax_same_side(
        jnp.asarray(vertices), jnp.asarray(mirror_vertices), jnp.asarray(normals),
        smoothing_factor=ALPHA,
    )
    assert got.dtype == torch.float32
    _close(got, want)
    hard = consecutive_vertices_are_on_same_side_of_mirror(
        _t(vertices), _t(mirror_vertices), _t(normals)
    )
    np.testing.assert_array_equal((got >= 0.5).numpy(), hard.numpy())
    # sign() passes no gradient, in either package.
    v = _t(vertices, grad=True)
    out = consecutive_vertices_are_on_same_side_of_mirror(
        v, _t(mirror_vertices), _t(normals), smoothing_factor=ALPHA
    )
    (grad,) = torch.autograd.grad(out.sum(), v)
    assert not grad.any()


@pytest.mark.parametrize("batch_size", [None, 512, 5, 4, 1])
@pytest.mark.parametrize("active", ["none", "per_triangle", "per_ray"])
def test_smoothed_any_hit_scan(active: str, batch_size: int | None) -> None:
    # 12 triangles: tiles of 5 do not divide them, tiles of 4 do.
    origins, directions, triangles = _rays_and_triangles(7)
    rng = np.random.default_rng(11)
    mask = {
        "none": None,
        "per_triangle": rng.random(12) >= 0.3,
        "per_ray": rng.random((40, 12)) >= 0.3,
    }[active]
    alpha = 4.0  # soft enough for several triangles to share a ray's sum
    o, d, tv = (_t(x, grad=True) for x in (origins, directions, triangles))
    got = ray_intersect_any_triangle(
        o, d, tv, None if mask is None else _t(mask), smoothing_factor=alpha, batch_size=batch_size
    )

    def jax_fn(o_, d_, tv_):
        return jax_any_hit(
            o_, d_, tv_, None if mask is None else jnp.asarray(mask),
            smoothing_factor=alpha, batch_size=batch_size,
        )

    args = tuple(jnp.asarray(x) for x in (origins, directions, triangles))
    _close(got, jax_fn(*args))
    assert float(got.max()) == 1.0 and 0.0 < float(got.min()) < 0.9  # clipped and unclipped sums
    weights = rng.random(40).astype(np.float32)
    grads = torch.autograd.grad((got * _t(weights)).sum(), (o, d, tv))
    want = jax.grad(lambda *a: (jax_fn(*a) * weights).sum(), argnums=(0, 1, 2))(*args)
    for g, w in zip(grads, want):
        _close(g, w, rtol=1e-4, atol=1e-5)


def test_hard_any_hit_scan_takes_a_mask_per_ray() -> None:
    origins, directions, triangles = _rays_and_triangles(13)
    mask = np.random.default_rng(17).random((40, 12)) >= 0.5
    got = ray_intersect_any_triangle(_t(origins), _t(directions), _t(triangles), _t(mask), batch_size=5)
    want = jax_any_hit(
        jnp.asarray(origins), jnp.asarray(directions), jnp.asarray(triangles), jnp.asarray(mask),
        batch_size=5,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
