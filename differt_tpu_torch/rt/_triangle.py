"""Batched Möller–Trumbore ray-triangle intersection (port of ``differt_tpu.rt._triangle``)."""

import torch

from ..geometry._vectors import _cross, _dot
from ..utils import min_with_initial, smoothing_function

F32_EPS = float(torch.finfo(torch.float32).eps)


def ray_intersect_triangle(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    *,
    epsilon: float | None = None,
    smoothing_factor: float | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Möller–Trumbore test, batched over leading dimensions; returns ``(t, hit)``.

    ``t`` scales ``ray_directions`` to reach the triangle's plane; ``hit``
    says whether that point lies inside the triangle with ``t > epsilon``.
    ``epsilon`` defaults to ``10 * eps(float32)``. With a
    ``smoothing_factor`` every comparison becomes a sigmoid and ``hit`` a
    confidence in [0, 1], the least of the six, so that the test stays
    differentiable.

    >>> import torch
    >>> tri = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    >>> t, hit = ray_intersect_triangle(
    ...     torch.tensor([0.2, 0.2, 1.0]), torch.tensor([0.0, 0.0, -2.0]), tri
    ... )
    >>> float(t), bool(hit)
    (0.5, True)
    """
    if epsilon is None:
        epsilon = 10.0 * F32_EPS

    v0 = triangle_vertices[..., 0, :]
    edge_1 = triangle_vertices[..., 1, :] - v0
    edge_2 = triangle_vertices[..., 2, :] - v0

    h = _cross(ray_directions, edge_2)
    det = _dot(h, edge_1)
    # Parallel ray: 1/inf pushes u, v and t to 0 (and |det| fails the guard).
    parallel = det == 0.0
    det_safe = torch.where(parallel, torch.full_like(det, torch.inf), det)
    inv_det = 1.0 / det_safe
    s = ray_origins - v0
    u = inv_det * _dot(s, h)
    q = _cross(s, edge_1)
    v = inv_det * _dot(q, ray_directions)
    t = inv_det * _dot(q, edge_2)

    if smoothing_factor is not None:
        # The sigmoid of inf * factor is a constant whose derivative in the
        # factor would be 0 * inf: a parallel ray takes that constant,
        # detached, and the sigmoid sees a finite stand-in there (the same
        # forward values, a derivative of exactly 0).
        det_arg = torch.where(parallel, torch.zeros_like(det), torch.abs(det) - epsilon)
        det_conf = torch.where(
            parallel,
            smoothing_function(torch.full_like(det, torch.inf), smoothing_factor).detach(),
            smoothing_function(det_arg, smoothing_factor),
        )
        conds = torch.stack(
            (
                det_conf,
                smoothing_function(u, smoothing_factor),
                smoothing_function(1.0 - u, smoothing_factor),
                smoothing_function(v, smoothing_factor),
                smoothing_function(1.0 - (u + v), smoothing_factor),
                smoothing_function(t - epsilon, smoothing_factor),
            ),
            dim=-1,
        )
        return t, min_with_initial(conds, -1, 1.0)

    hit = (
        (torch.abs(det) > epsilon)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > epsilon)
    )
    return t, hit


def triangle_contains_vertex_assuming_inside_same_plane(
    triangle_vertices: torch.Tensor, vertex: torch.Tensor
) -> torch.Tensor:
    """Whether a vertex in the triangle's plane lies inside it (or on its edges): the same-side test.

    ``triangle_vertices [*batch, 3, 3]`` and ``vertex [*batch, 3]`` broadcast.

    >>> import torch
    >>> tri = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    >>> triangle_contains_vertex_assuming_inside_same_plane(
    ...     tri, torch.tensor([[0.2, 0.2, 0.0], [0.8, 0.8, 0.0]])
    ... ).tolist()
    [True, False]
    """
    p0 = triangle_vertices[..., 0, :]
    p1 = triangle_vertices[..., 1, :]
    p2 = triangle_vertices[..., 2, :]
    normal = _cross(p1 - p0, p2 - p0)

    def same_side(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _dot(_cross(b - a, vertex - a), normal) >= 0.0

    return same_side(p0, p1) & same_side(p1, p2) & same_side(p2, p0)
