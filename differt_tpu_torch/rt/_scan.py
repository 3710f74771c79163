"""Memory-bounded any-hit and closest-hit scans over all triangles (port of ``differt_tpu.rt._scan``).

These are the plain forms of the any-hit and closest-hit contracts: peak
memory is bounded at ``batch * tile`` ray-triangle pairs by looping over
triangle tiles. The kernels' plain versions (``ops/_rt.py``,
``ops/_closest.py``) are built on them. Visibility is not ported yet
(ROADMAP A10).
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


def first_triangle_hit_by_ray(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    batch_size: int | None = 512,
    *,
    epsilon: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Index of and distance to the first (active) triangle hit by each ray.

    Rays broadcast over ``[*batch, 3]``; ``triangle_vertices`` is
    ``[num_triangles, 3, 3]``, tested ``batch_size`` at a time. Returns
    int64 indices and ``t`` of shape ``[*batch]``, ``(-1, inf)`` on a miss.
    Within a tile, ties keep the lowest index (argmin); across tiles, an
    equal ``t`` in a later tile wins.

    >>> import torch
    >>> walls = torch.tensor([
    ...     [[1.0, -9.0, -9.0], [1.0, 9.0, -9.0], [1.0, 0.0, 9.0]],
    ...     [[2.0, -9.0, -9.0], [2.0, 9.0, -9.0], [2.0, 0.0, 9.0]],
    ... ])
    >>> ray = torch.tensor([1.0, 0.0, 0.0])
    >>> index, t = first_triangle_hit_by_ray(torch.zeros(3), ray, walls)
    >>> int(index), float(t)
    (0, 1.0)
    >>> int(first_triangle_hit_by_ray(torch.zeros(3), -ray, walls)[0])
    -1
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    device = ray_origins.device
    best_idx = torch.full(batch, -1, dtype=torch.int64, device=device)
    best_t = torch.full(batch, torch.inf, dtype=ray_origins.dtype, device=device)
    num_triangles = triangle_vertices.shape[0]
    tile = num_triangles if batch_size is None else max(min(batch_size, num_triangles), 1)
    origins = ray_origins[..., None, :]
    directions = ray_directions[..., None, :]
    for lo in range(0, num_triangles, tile):
        t, hit = ray_intersect_triangle(
            origins, directions, triangle_vertices[lo : lo + tile], epsilon=epsilon
        )
        if active_triangles is not None:
            hit = hit & active_triangles[lo : lo + tile]
        t_min, arg = torch.where(hit, t, torch.inf).min(dim=-1)
        # Strict `<`: an equal t in a later tile wins.
        keep = best_t < t_min
        best_idx = torch.where(keep | torch.isinf(t_min), best_idx, arg + lo)
        best_t = torch.where(keep, best_t, t_min)
    return best_idx, best_t
