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
    det_safe = torch.where(det == 0.0, torch.full_like(det, torch.inf), det)
    inv_det = 1.0 / det_safe
    s = ray_origins - v0
    u = inv_det * _dot(s, h)
    q = _cross(s, edge_1)
    v = inv_det * _dot(q, ray_directions)
    t = inv_det * _dot(q, edge_2)

    if smoothing_factor is not None:
        conds = torch.stack(
            (
                smoothing_function(torch.abs(det_safe) - epsilon, smoothing_factor),
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
