"""Memory-bounded any-hit scan over all triangles (port of ``differt_tpu.rt._scan``).

This is the plain form of the any-hit contract: peak memory is bounded at
``batch * tile`` ray-triangle pairs by looping over triangle tiles. The
any-hit kernel's plain version (``ops/_rt.py``) is built on
:func:`any_hit_below`. Closest-hit and visibility are not ported yet
(ROADMAP B3, A10).
"""

import torch

from ._triangle import F32_EPS, ray_intersect_triangle


def any_hit_below(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None,
    hit_threshold: torch.Tensor,
    *,
    epsilon: float | None = None,
    tile: int = 512,
) -> torch.Tensor:
    """Whether each ray hits an active triangle with ``epsilon < t < hit_threshold``.

    Rays are ``[*batch, 3]``, ``hit_threshold`` broadcasts against
    ``[*batch]``, triangles are ``[T, 3, 3]``, processed ``tile`` at a time.
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    out = torch.zeros(batch, dtype=torch.bool, device=ray_origins.device)
    origins = ray_origins[..., None, :]
    directions = ray_directions[..., None, :]
    threshold = hit_threshold[..., None]
    for lo in range(0, triangle_vertices.shape[0], max(tile, 1)):
        t, hit = ray_intersect_triangle(
            origins, directions, triangle_vertices[lo : lo + tile], epsilon=epsilon
        )
        blocked = (t < threshold) & hit
        if active_triangles is not None:
            blocked = blocked & active_triangles[lo : lo + tile]
        out |= blocked.any(dim=-1)
    return out


def ray_intersect_any_triangle(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    hit_tol: float | None = None,
    epsilon: float | None = None,
    batch_size: int | None = 512,
) -> torch.Tensor:
    """Whether each ray hits any (active) triangle before ``t = 1 - hit_tol``.

    Rays broadcast over ``[*batch, 3]``; ``triangle_vertices`` is
    ``[num_triangles, 3, 3]``, tested ``batch_size`` at a time. ``hit_tol``
    defaults to ``100 * eps(float32)``. Hard only: the smoothed sum is
    ROADMAP A5.

    >>> import torch
    >>> wall = torch.tensor([[[0.0, -9.0, -9.0], [0.0, 9.0, -9.0], [0.0, 0.0, 9.0]]])
    >>> start, end = torch.tensor([-1.0, 0.0, 0.0]), torch.tensor([2.0, 0.0, 0.0])
    >>> bool(ray_intersect_any_triangle(start, end - start, wall))
    True
    >>> bool(ray_intersect_any_triangle(start, start - end, wall))
    False
    """
    if hit_tol is None:
        hit_tol = 100.0 * F32_EPS
    hit_threshold = 1.0 - torch.as_tensor(
        hit_tol, dtype=torch.float32, device=ray_origins.device
    )
    num_triangles = triangle_vertices.shape[0]
    tile = num_triangles if batch_size is None else min(batch_size, num_triangles)
    return any_hit_below(
        ray_origins,
        ray_directions,
        triangle_vertices,
        active_triangles,
        hit_threshold,
        epsilon=epsilon,
        tile=tile,
    )
