"""Parity of the port's Fermat solver (``rt/_fermat.py``) with the JAX package.

The same seeded numpy inputs go through both packages. Tolerances:

- The closed-form gradient and Hessian-vector product of the path length
  against ``jax.grad`` and ``jax.jvp``: ``rtol=1e-5``. Conjugate gradients,
  stopped path by path: ``atol=1e-5``.
- Vertices, on the paths where the reference reached the optimum (its
  length within ``k`` float32 ulps of a float64 solve's): the port's
  length as close, and its points within ``1e-4`` m plus the float32
  resolution of the Fermat objective (``torch_parity.fermat_resolution``).
  The line search takes a step only if the float32 length falls, so each
  package stops where its rounding of the length no longer falls, within
  ``sqrt(2 k ulp(L) / lambda)`` of the optimum: millimetres on these
  paths, though both follow the same iteration.
- Gradients with ``implicit_diff=True``: within ``rtol=1e-3`` of
  ``jax.grad`` (norm over the converged paths whose Hessian is not
  ill-conditioned); with ``implicit_diff=False``, ``rtol=2e-2``.
"""

import doctest
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differt_tpu.rt import fermat_path_on_linear_objects as jax_fermat
from differt_tpu.rt import fermat_path_on_planar_mirrors as jax_mirrors
from differt_tpu.rt._fermat import _total_length as jax_total_length
from differt_tpu_torch.rt import fermat_path_on_linear_objects, fermat_path_on_planar_mirrors
from differt_tpu_torch.geometry._vectors import orthogonal_basis
from differt_tpu_torch.rt import _fermat

from .torch_parity import fermat_hessian_eigenvalues, fermat_resolution

STEPS = 20
VERTEX_ATOL = 1e-4
GRAD_RTOL = 1e-3
UNROLLED_RTOL = 2e-2


def _np(x) -> np.ndarray:
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.cache
def _problem(num_objects: int, num_dims: int, edges: int = 0, batch: int = 256, seed: int = 0):
    """TX and RX 10-20 m apart, objects spanning 1-4 m between them; the last ``edges`` objects have one vector."""
    rng = np.random.default_rng(seed)
    from_vertex = rng.uniform(-12.0, -6.0, (batch, 3)).astype(np.float32)
    to_vertex = rng.uniform(6.0, 12.0, (batch, 3)).astype(np.float32)
    origins = rng.uniform(-3.0, 3.0, (batch, num_objects, 3)).astype(np.float32)
    vectors = rng.uniform(-2.0, 2.0, (batch, num_objects, num_dims, 3)).astype(np.float32)
    if edges:
        vectors[:, num_objects - edges :, 1:] = 0.0
    return from_vertex, to_vertex, origins, vectors


def _lengths(from_vertex, to_vertex, points) -> np.ndarray:
    full = np.concatenate((from_vertex[..., None, :], points, to_vertex[..., None, :]), axis=-2).astype(np.float64)
    return np.sqrt((np.diff(full, axis=-2) ** 2).sum(-1)).sum(-1)


def _converged(inputs, points, ref) -> np.ndarray:
    """The paths on which both packages reached the optimum, nearly all of them.

    The optimum is the port's float64 solve. Reaching it means a length
    within ``k = n + 2`` float32 ulps of it (the rounding of the computed
    length). Near a kink of the length (two points that nearly meet) either
    package may stop short, each on a few paths in a hundred.
    """
    from_vertex, to_vertex = inputs[:2]
    num_ulps = inputs[3].shape[-3] + 2
    optimum = _np(fermat_path_on_linear_objects(*(torch.from_numpy(np.asarray(a, np.float64)) for a in inputs), steps=60))
    best = _lengths(from_vertex, to_vertex, optimum)
    ulp = np.spacing(best.astype(np.float32)).astype(np.float64)
    converged = (_lengths(from_vertex, to_vertex, ref) - best <= num_ulps * ulp) & (
        _lengths(from_vertex, to_vertex, points) - best <= num_ulps * ulp
    )
    assert converged.mean() >= 0.95
    return converged


def _assert_same_optimum(inputs, points, ref) -> None:
    """On the converged paths, the points within ``1e-4`` m plus the float32 resolution."""
    from_vertex, to_vertex, _, vectors = inputs
    full = np.concatenate((from_vertex[..., None, :], ref, to_vertex[..., None, :]), axis=-2)
    bound = VERTEX_ATOL + fermat_resolution(full, vectors, vectors.shape[-3] + 2)
    err = np.abs(points - ref).max(axis=(-1, -2))
    converged = _converged(inputs, points, ref)
    assert (err <= bound)[converged].all(), f"worst {err[converged].max()} m"


@pytest.mark.parametrize(
    ("num_objects", "num_dims", "edges"),
    [(1, 2, 0), (1, 1, 0), (2, 2, 1), (2, 2, 2)],
    ids=["plane", "edge", "plane-edge", "edge-edge"],
)
def test_linear_objects_match(num_objects: int, num_dims: int, edges: int) -> None:
    inputs = _problem(num_objects, num_dims, edges)
    points = _np(fermat_path_on_linear_objects(*(torch.from_numpy(a) for a in inputs), steps=STEPS))
    ref = _np(jax_fermat(*(jnp.asarray(a) for a in inputs), steps=STEPS))
    assert points.shape == ref.shape == (inputs[0].shape[0], num_objects, 3)
    _assert_same_optimum(inputs, points, ref)


def test_planar_mirrors_match() -> None:
    rng = np.random.default_rng(1)
    from_vertex, to_vertex, origins, _ = _problem(1, 2, seed=1)
    normals = rng.normal(size=origins.shape).astype(np.float32)
    points = _np(fermat_path_on_planar_mirrors(*(torch.from_numpy(a) for a in (from_vertex, to_vertex, origins, normals))))
    ref = _np(jax_mirrors(*(jnp.asarray(a) for a in (from_vertex, to_vertex, origins, normals))))
    d1, d2 = (_np(v) for v in orthogonal_basis(torch.from_numpy(normals)))
    _assert_same_optimum((from_vertex, to_vertex, origins, np.stack((d1, d2), axis=-2)), points, ref)


def test_batch_axes_broadcast() -> None:
    """``[2, 1]`` TX, ``[1, 3]`` RX and ``[4]``-free objects broadcast as ``jnp.vectorize`` does."""
    from_vertex, to_vertex, origins, vectors = _problem(2, 2, 1, batch=6, seed=2)
    inputs = (from_vertex[:2, None, None], to_vertex[None, :3, None], origins[:4], vectors[:4])
    points = _np(fermat_path_on_linear_objects(*(torch.from_numpy(a) for a in inputs), steps=STEPS))
    ref = _np(jax_fermat(*(jnp.asarray(a) for a in inputs), steps=STEPS))
    assert points.shape == ref.shape == (2, 3, 4, 2, 3)
    batch = (2, 3, 4)
    full = [np.broadcast_to(a, (*batch, *a.shape[a.ndim - core :])) for a, core in zip(inputs, (1, 1, 2, 3))]
    _assert_same_optimum(full, points, ref)


@pytest.mark.parametrize(("num_objects", "num_dims"), [(0, 2), (2, 0)], ids=["no-objects", "no-vectors"])
def test_empty_objects_return_early(num_objects: int, num_dims: int) -> None:
    rng = np.random.default_rng(3)
    inputs = (
        rng.normal(size=(5, 3)).astype(np.float32),
        rng.normal(size=(1, 3)).astype(np.float32),
        rng.normal(size=(5, num_objects, 3)).astype(np.float32),
        rng.normal(size=(1, num_objects, num_dims, 3)).astype(np.float32),
    )
    points = fermat_path_on_linear_objects(*(torch.from_numpy(a) for a in inputs))
    ref = _np(jax_fermat(*(jnp.asarray(a) for a in inputs)))
    assert tuple(points.shape) == ref.shape == (5, num_objects, 3)
    np.testing.assert_array_equal(_np(points), ref)


def test_length_gradient_and_hvp_match_autodiff() -> None:
    """The closed forms against ``jax.grad`` and ``jax.jvp`` of the reference's own length."""
    from_vertex, to_vertex, origins, vectors = _problem(3, 2, 1, batch=64, seed=4)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 3, 2)).astype(np.float32)
    v = rng.normal(size=(64, 3, 2)).astype(np.float32)
    ref_grad = jax.vmap(jax.grad(jax_total_length))(x, from_vertex, to_vertex, origins, vectors)

    def hvp(x, v, *args):
        return jax.jvp(lambda y: jax.grad(jax_total_length)(y, *args), (x,), (v,))[1]

    ref_hvp = jax.vmap(hvp)(x, v, from_vertex, to_vertex, origins, vectors)
    geometry = _fermat._geometry(*(torch.from_numpy(a) for a in (from_vertex, to_vertex, origins, vectors)))
    x_t = torch.from_numpy(x).movedim(0, -1)
    grad, units, lengths, loss = _fermat._linearize(x_t, geometry)
    got_hvp = _fermat._hvp(torch.from_numpy(v).movedim(0, -1), geometry[3], units, lengths)
    np.testing.assert_allclose(_np(grad.movedim(-1, 0)), _np(ref_grad), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got_hvp.movedim(-1, 0)), _np(ref_hvp), rtol=1e-5, atol=1e-5)
    ref_loss = jax.vmap(jax_total_length)(x, from_vertex, to_vertex, origins, vectors)
    np.testing.assert_allclose(_np(loss), _np(ref_loss), rtol=1e-6)


def test_conjugate_gradients_stop_path_by_path() -> None:
    """Systems that converge at different iterations, each frozen when it does, as under ``vmap``."""
    rng = np.random.default_rng(5)
    size, batch = 4, 200
    basis = rng.normal(size=(batch, size, size))
    # Some systems have fewer distinct eigenvalues and converge early.
    eig = np.where(rng.random((batch, 1)) < 0.5, rng.uniform(1, 10, (batch, size)), np.repeat(rng.uniform(1, 10, (batch, 1)), size, 1))
    q, _ = np.linalg.qr(basis)
    a = np.einsum("bij,bj,bkj->bik", q, eig, q).astype(np.float32)
    b = rng.normal(size=(batch, size)).astype(np.float32)
    ref = jax.vmap(lambda a, b: jax.scipy.sparse.linalg.cg(lambda v: a @ v, b, maxiter=3)[0])(a, b)
    a_t = torch.from_numpy(a).permute(1, 2, 0)
    got = _fermat._cg(lambda v: (a_t * v[None, :, 0]).sum(1)[:, None], torch.from_numpy(b).T[:, None], 3)
    np.testing.assert_allclose(_np(got[:, 0].T), _np(ref), atol=1e-5, rtol=1e-5)


def _gradients(inputs, implicit_diff: bool, weights: np.ndarray):
    tensors = [torch.from_numpy(a).requires_grad_() for a in inputs]
    points = fermat_path_on_linear_objects(*tensors, steps=STEPS, implicit_diff=implicit_diff)
    (points * torch.from_numpy(weights)).sum().backward()
    return [_np(t.grad) for t in tensors], points


def _jax_gradients(inputs, implicit_diff: bool, weights: np.ndarray):
    def loss(*args):
        return jnp.sum(jax_fermat(*args, steps=STEPS, implicit_diff=implicit_diff) * weights)

    return [_np(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in inputs))]


def _well_posed(inputs, points, ref) -> np.ndarray:
    """Converged paths whose length's Hessian has a condition number of at most 1e5.

    Each path's gradient is its rows of the inputs' gradients. It multiplies
    the inverse Hessian, so where two points nearly meet (a condition
    number of 1e6) the millimetres between the packages' points move it by
    tens of percent.
    """
    full = np.concatenate((inputs[0][..., None, :], ref, inputs[1][..., None, :]), axis=-2)
    least, largest, _ = fermat_hessian_eigenvalues(full, inputs[3])
    keep = _converged(inputs, points, ref) & (largest <= 1e5 * least)
    assert keep.mean() >= 0.85
    return keep


def _assert_gradients_close(grads, refs, keep, rtol: float = GRAD_RTOL) -> None:
    for grad, ref in zip(grads, refs):
        assert np.isfinite(grad).all()
        assert np.linalg.norm(grad[keep] - ref[keep]) <= rtol * np.linalg.norm(ref[keep])


def _walk(fn, seen=None):
    """Every node of an autograd graph."""
    seen = set() if seen is None else seen
    for child, _ in fn.next_functions:
        if child is not None and child not in seen:
            seen.add(child)
            yield child
            yield from _walk(child, seen)


@pytest.mark.parametrize(("num_objects", "edges"), [(1, 0), (2, 1), (2, 2)], ids=["plane", "plane-edge", "edge-edge"])
def test_implicit_gradients_match(num_objects: int, edges: int) -> None:
    inputs = _problem(num_objects, 2, edges, batch=64, seed=6)
    weights = np.random.default_rng(6).normal(size=(64, num_objects, 3)).astype(np.float32)
    grads, points = _gradients(inputs, True, weights)
    assert any("_ImplicitSolve" in type(fn).__name__ for fn in _walk(points.grad_fn))
    ref = _np(jax_fermat(*(jnp.asarray(a) for a in inputs), steps=STEPS))
    keep = _well_posed(inputs, _np(points), ref)
    _assert_gradients_close(grads, _jax_gradients(inputs, True, weights), keep)


def test_unrolled_gradients_match_where_converged() -> None:
    """``implicit_diff=False`` differentiates the iterations: the port's CG
    iterations, the reference's CG as a linear solve. At convergence both
    approach the implicit gradient, to within the reference's own gap
    between its two modes (0.4-1% here), so ``rtol=2e-2``."""
    inputs = _problem(1, 2, 0, batch=32, seed=7)
    weights = np.random.default_rng(7).normal(size=(32, 1, 3)).astype(np.float32)
    grads, points = _gradients(inputs, False, weights)
    assert not any("_ImplicitSolve" in type(fn).__name__ for fn in _walk(points.grad_fn))
    implicit, _ = _gradients(inputs, True, weights)
    ref = _np(jax_fermat(*(jnp.asarray(a) for a in inputs), steps=STEPS))
    keep = _well_posed(inputs, _np(points), ref)
    _assert_gradients_close(grads, _jax_gradients(inputs, False, weights), keep, UNROLLED_RTOL)
    _assert_gradients_close(grads, implicit, keep, UNROLLED_RTOL)


def test_doctests() -> None:
    result = doctest.testmod(importlib.import_module("differt_tpu_torch.rt._fermat"), optionflags=doctest.ELLIPSIS)
    assert result.attempted > 0 and result.failed == 0
