"""Fermat-principle path solver (PyTorch port of ``differt_tpu.rt._fermat``).

Finds the minimum-length path touching a sequence of *linear objects*
(each a point plus spanning vectors: an edge has one vector, a plane two,
zero-padded to a common ``num_dims``), so it handles diffraction on edges
as well as reflection on planes.

- The objective ``L(x) = sum_i sqrt(|p_{i+1}(x) - p_i(x)|^2 + eps)`` is
  convex in the object-local coordinates ``x``. A damped Newton method
  minimizes it from ``x = 0``: conjugate gradients on the damped Hessian
  (stopped path by path, as ``jax.scipy.sparse.linalg.cg`` is under
  ``jnp.vectorize``) and a halving line search.
- The gradient and the Hessian-vector product have a closed form:
  ``dl/ds = s / l`` and ``H_s = (I - u u^T) / l`` per segment ``s``
  (``u = s / l``), mapped through each object's vectors. They are the
  derivatives of the same function the reference differentiates with
  ``jax.grad`` and ``jax.jvp``, without a double-backward graph.
- With ``implicit_diff=True`` the solve is a :class:`torch.autograd.Function`
  whose backward uses the implicit function theorem: at the optimum the
  gradient ``g(x*, theta)`` is 0, so the backward solves ``H u = cotangent``
  and pulls ``-u`` through ``dg/dtheta``. Without it, autograd runs through
  the iterations.

Vectors are carried as tensors with small leading axes (``[n, d, *batch]``
for ``x``, ``[3, *batch]`` per point), so each component is a
``[*batch]`` view and the objects' data broadcast over the batch.
"""

import torch

from ..geometry._vectors import orthogonal_basis
from ..utils import dot3

_EPS = 1e-12
_DAMPING = 1e-6
_CG_TOL = 1e-5


def _geometry(from_vertex, to_vertex, object_origins, object_vectors):
    """The inputs as component views: ``(from [3, *b], to [3, *b], origins [n, 3, *b], vectors [n, d, 3, *b])``."""
    return (
        from_vertex.movedim(-1, 0),
        to_vertex.movedim(-1, 0),
        object_origins.movedim((-2, -1), (0, 1)),
        object_vectors.movedim((-3, -2, -1), (0, 1, 2)),
    )


def _offsets(x: torch.Tensor, vectors) -> list[tuple[torch.Tensor, ...]]:
    """``sum_k x_k vectors_k`` for each object, one component tuple each."""
    offsets = []
    for j in range(x.shape[0]):
        comps = []
        for a in range(3):
            offset = x[j, 0] * vectors[j, 0, a]
            for k in range(1, x.shape[1]):
                offset = offset + x[j, k] * vectors[j, k, a]
            comps.append(offset)
        offsets.append(tuple(comps))
    return offsets


def _points(x: torch.Tensor, origins, vectors) -> list[tuple[torch.Tensor, ...]]:
    """The path's intermediate points ``origins + sum_k x_k vectors_k``, one component tuple each."""
    return [tuple(origins[j, a] + off[a] for a in range(3)) for j, off in enumerate(_offsets(x, vectors))]


def _segments(x: torch.Tensor, geometry) -> list[tuple[torch.Tensor, ...]]:
    from_vertex, to_vertex, origins, vectors = geometry
    full = [tuple(from_vertex), *_points(x, origins, vectors), tuple(to_vertex)]
    return [tuple(full[i + 1][a] - full[i][a] for a in range(3)) for i in range(len(full) - 1)]


def _lengths(segments) -> list[torch.Tensor]:
    # Smooth (eps-regularized) norm: finite gradients at coincident points.
    return [torch.sqrt(dot3(s, s) + _EPS) for s in segments]


def _total(lengths) -> torch.Tensor:
    total = lengths[0]
    for length in lengths[1:]:
        total = total + length
    return total


def _loss(x: torch.Tensor, geometry) -> torch.Tensor:
    return _total(_lengths(_segments(x, geometry)))


def _coordinates(vectors, per_point) -> torch.Tensor:
    """``[n, d, *batch]``: each point's 3-vector projected on each of its object's vectors."""
    n, d = vectors.shape[:2]
    rows = [torch.stack([dot3(tuple(vectors[j, k]), per_point[j]) for k in range(d)]) for j in range(n)]
    return torch.stack(rows)


def _linearize(x: torch.Tensor, geometry):
    """The loss's gradient ``[n, d, *batch]``, the segments' directions ``s / l`` and lengths ``l``, and the loss."""
    segments = _segments(x, geometry)
    lengths = _lengths(segments)
    units = [tuple(c / length for c in s) for s, length in zip(segments, lengths)]
    per_point = [tuple(units[j][a] - units[j + 1][a] for a in range(3)) for j in range(x.shape[0])]
    return _coordinates(geometry[3], per_point), units, lengths, _total(lengths)


def _hvp(v: torch.Tensor, vectors, units, lengths) -> torch.Tensor:
    """The loss's Hessian at the linearized point times ``v`` (``[n, d, *batch]``)."""
    n = v.shape[0]
    moves = [None, *_offsets(v, vectors), None]
    turns = []
    for i in range(n + 1):
        ahead, behind = moves[i + 1], moves[i]
        if ahead is None:
            ds = tuple(-c for c in behind)
        elif behind is None:
            ds = ahead
        else:
            ds = tuple(ahead[a] - behind[a] for a in range(3))
        u = units[i]
        along = dot3(u, ds)
        turns.append(tuple((ds[a] - u[a] * along) / lengths[i] for a in range(3)))
    per_point = [tuple(turns[j][a] - turns[j + 1][a] for a in range(3)) for j in range(n)]
    return _coordinates(vectors, per_point)


def _cg(matvec, b: torch.Tensor, maxiter: int) -> torch.Tensor:
    """``jax.scipy.sparse.linalg.cg(matvec, b, maxiter=maxiter)`` (``x0 = 0``, ``tol = 1e-5``, ``atol = 0``), path by path.

    Systems are ``[n, d]`` per path of ``b``'s ``[n, d, *batch]``. A path
    stops once its squared residual is at most ``tol^2 |b|^2`` and keeps its
    value while the others go on, as the reference's ``while_loop`` does
    under ``vmap``. The loop ends when every path has stopped.
    """

    def vdot(a, c):
        return (a * c).sum(dim=(0, 1))

    tol = torch.tensor(_CG_TOL, dtype=b.dtype, device=b.device)
    atol2 = torch.clamp_min(tol * tol * vdot(b, b), 0.0)
    x = torch.zeros_like(b)
    r = b  # b - matvec(x0) with x0 = 0
    p = r
    gamma = vdot(r, r)
    for _ in range(maxiter):
        active = gamma > atol2
        if not bool(active.any()):
            break
        ap = matvec(p)
        # Stopped paths divide by 1: their values are discarded, and a 0/0
        # would send NaN through a backward that runs through the loop.
        alpha = gamma / torch.where(active, vdot(p, ap), 1.0)
        x = torch.where(active, x + alpha * p, x)
        r_next = r - alpha * ap
        gamma_next = vdot(r_next, r_next)
        beta = gamma_next / torch.where(active, gamma, 1.0)
        p = torch.where(active, r_next + beta * p, p)
        r = torch.where(active, r_next, r)
        gamma = torch.where(active, gamma_next, gamma)
    return x


def _solve(geometry, batch, steps: int, linesearch_steps: int, cg_steps: int) -> torch.Tensor:
    """Damped-Newton minimization of the path length from ``x = 0``; returns ``x*`` as ``[n, d, *batch]``."""
    vectors = geometry[3]
    n, d = vectors.shape[:2]
    x = torch.zeros((n, d, *batch), dtype=vectors.dtype, device=vectors.device)
    scales = [0.5**k for k in range(max(linesearch_steps, 1))]
    for _ in range(steps):
        g, units, lengths, loss_x = _linearize(x, geometry)
        direction = _cg(lambda v: _hvp(v, vectors, units, lengths) + _DAMPING * v, g, cg_steps)
        direction = torch.where(torch.isfinite(direction), direction, g)
        # Halving line search: the first of the smallest losses, taken if
        # strictly below the current one (a NaN loss, which the reference's
        # argmin would pick, is never taken).
        best_loss = best_scale = saw_nan = None
        for k, scale in enumerate(scales):
            loss = _loss(x - scale * direction, geometry)
            if k == 0:
                best_loss, best_scale, saw_nan = loss, torch.full_like(loss, scale, dtype=x.dtype), torch.isnan(loss)
                continue
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_scale = torch.where(better, scale, best_scale)
            saw_nan = saw_nan | torch.isnan(loss)
        accept = (best_loss < loss_x) & ~saw_nan
        if not bool(accept.any()):
            break  # every path is at its fixed point: the steps left would change nothing
        x = torch.where(accept, x - best_scale * direction, x)
    return x


class _ImplicitSolve(torch.autograd.Function):
    """``x*`` with the implicit-function-theorem backward (the reference's custom VJP)."""

    @staticmethod
    def forward(ctx, from_vertex, to_vertex, object_origins, object_vectors, batch, steps, linesearch_steps, cg_steps):
        x = _solve(_geometry(from_vertex, to_vertex, object_origins, object_vectors), batch, steps, linesearch_steps, cg_steps)
        ctx.save_for_backward(x, from_vertex, to_vertex, object_origins, object_vectors)
        ctx.cg_steps = cg_steps
        return x

    @staticmethod
    def backward(ctx, cotangent):
        x, *inputs = ctx.saved_tensors
        geometry = _geometry(*inputs)
        _, units, lengths, _ = _linearize(x, geometry)
        u = _cg(lambda v: _hvp(v, geometry[3], units, lengths) + _DAMPING * v, cotangent, ctx.cg_steps)
        u = torch.where(torch.isfinite(u), u, 0.0)
        wanted = [i for i in range(4) if ctx.needs_input_grad[i]]
        grads = [None] * 4
        if wanted:
            with torch.enable_grad():
                theta = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
                g = _linearize(x, _geometry(*theta))[0]
                pulled = torch.autograd.grad(g, [theta[i] for i in wanted], grad_outputs=-u, allow_unused=True)
            for i, grad in zip(wanted, pulled):
                grads[i] = torch.zeros_like(inputs[i]) if grad is None else grad
        return (*grads, None, None, None, None)


def fermat_path_on_linear_objects(
    from_vertex,
    to_vertex,
    object_origins,
    object_vectors,
    *,
    steps: int = 10,
    unroll: int | bool = 1,
    linesearch_steps: int = 8,
    unroll_linesearch: int | bool = 1,
    implicit_diff: bool = True,
    cg_steps: int | None = None,
) -> torch.Tensor:
    """Minimum-length path through a sequence of linear objects, ``[*batch, num_objects, 3]``.

    ``from_vertex`` ``[*batch, 3]``, ``to_vertex`` ``[*batch, 3]``,
    ``object_origins`` ``[*batch, n, 3]`` and ``object_vectors``
    ``[*batch, n, d, 3]`` broadcast over their batch axes (the reference's
    ``jnp.vectorize`` signature ``(3),(3),(n,3),(n,d,3)->(n,3)``). Objects
    with fewer than ``d`` vectors pad them with zero vectors. Returns the
    intermediate vertices only. ``cg_steps`` defaults to ``max(n * d, 8)``;
    ``unroll`` and ``unroll_linesearch`` are accepted for the reference's
    signature and ignored.

    >>> import torch
    >>> point = fermat_path_on_linear_objects(
    ...     torch.tensor([-1.0, 0.0, 1.0]),
    ...     torch.tensor([1.0, 0.0, 1.0]),
    ...     torch.tensor([[0.0, -1.0, 0.0]]),
    ...     torch.tensor([[[0.0, 2.0, 0.0]]]),
    ... )
    >>> [round(v, 4) + 0.0 for v in point[0].tolist()]  # the edge along y, at its closest point
    [0.0, 0.0, 0.0]
    """
    del unroll, unroll_linesearch
    tensors = [torch.as_tensor(t) for t in (from_vertex, to_vertex, object_origins, object_vectors)]
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    from_vertex, to_vertex, object_origins, object_vectors = (t.to(dtype) for t in tensors)
    num_objects, num_dims = object_vectors.shape[-3], object_vectors.shape[-2]
    batch = torch.broadcast_shapes(
        from_vertex.shape[:-1], to_vertex.shape[:-1], object_origins.shape[:-2], object_vectors.shape[:-3]
    )
    if object_origins.shape[-2] == 0:
        return object_origins.new_empty((*batch, 0, 3))
    if num_dims == 0:
        return object_origins.expand(*batch, *object_origins.shape[-2:])

    if cg_steps is None:
        cg_steps = max(num_objects * num_dims, 8)
    if implicit_diff:
        x = _ImplicitSolve.apply(
            from_vertex, to_vertex, object_origins, object_vectors, batch, steps, linesearch_steps, cg_steps
        )
    else:
        geometry = _geometry(from_vertex, to_vertex, object_origins, object_vectors)
        x = _solve(geometry, batch, steps, linesearch_steps, cg_steps)
    # The direct dependence of the points on the objects, through autograd.
    x = x.movedim((0, 1), (-2, -1))
    return object_origins + (x[..., None] * object_vectors).sum(dim=-2)


def fermat_path_on_planar_mirrors(
    from_vertex, to_vertex, mirror_vertices, mirror_normals, **kwargs
) -> torch.Tensor:
    """The Fermat counterpart of :func:`~differt_tpu_torch.rt.image_method` on planar mirrors, ``[*batch, num_mirrors, 3]``.

    Each mirror spans the two in-plane vectors of
    :func:`~differt_tpu_torch.geometry._vectors.orthogonal_basis` of its
    normal; ``kwargs`` go to :func:`fermat_path_on_linear_objects`. The
    ground bounce between two symmetric points is below their midpoint:

    >>> import torch
    >>> point = fermat_path_on_planar_mirrors(
    ...     torch.tensor([-1.0, 0.0, 1.0]),
    ...     torch.tensor([1.0, 0.0, 1.0]),
    ...     torch.tensor([[0.0, 0.0, 0.0]]),
    ...     torch.tensor([[0.0, 0.0, 1.0]]),
    ... )
    >>> bool(torch.allclose(point[0], torch.zeros(3), atol=1e-3))
    True
    """
    d1, d2 = orthogonal_basis(torch.as_tensor(mirror_normals))
    return fermat_path_on_linear_objects(
        from_vertex, to_vertex, mirror_vertices, torch.stack((d1, d2), dim=-2), **kwargs
    )
