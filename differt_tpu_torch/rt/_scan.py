"""Memory-bounded any-hit, closest-hit and visibility scans over all triangles (port of ``differt_tpu.rt._scan``).

These are the plain forms of the any-hit and closest-hit contracts: peak
memory is bounded at ``batch * tile`` ray-triangle pairs by looping over
triangle tiles. The kernels' plain versions (``ops/_rt.py``,
``ops/_closest.py``) are built on them. With a ``smoothing_factor`` the
any-hit scan returns a confidence through which gradients flow; it keeps a
graph of every ray-triangle pair, so it is for small scenes. Visibility
launches a lattice of rays from a vertex over its frustum and marks the
first triangle each ray hits; on the card the mesh-level entry
(``ops/_dispatch.py``) sends those rays through the closest-hit kernel.
"""

from collections.abc import Callable

import torch

from ..geometry._lattice import fibonacci_lattice, viewing_frustum
from ..utils import smoothing_function
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
            blocked = blocked & active_triangles[..., lo : lo + tile]
        out |= blocked.any(dim=-1)
    return out


def smoothed_any_hit(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_tile: Callable[[int, int], torch.Tensor | None],
    hit_threshold: torch.Tensor,
    *,
    smoothing_factor,
    epsilon: float | None = None,
    tile: int | None = 512,
) -> torch.Tensor:
    """Confidence in [0, 1] that each ray is blocked before ``hit_threshold``.

    A triangle's confidence is ``minimum(hit, sigmoid((hit_threshold - t) *
    smoothing_factor))``; they are summed over the active triangles of each
    tile, and the tiles combined by ``minimum(left + right, 1)``.
    ``active_tile(lo, hi)`` gives the bool mask ``[*batch, hi - lo]`` of
    triangles ``lo`` to ``hi`` (or None: all active), so that a caller can
    make a mask that depends on the ray one tile at a time.

    ``torch.minimum`` halves the gradient on a tie, as ``jnp.minimum`` and
    ``jnp.clip`` do (``torch.clamp`` would pass all of it).
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    out = torch.zeros(batch, dtype=ray_origins.dtype, device=ray_origins.device)
    one = out.new_tensor(1.0)
    origins = ray_origins[..., None, :]
    directions = ray_directions[..., None, :]
    num_triangles = triangle_vertices.shape[0]
    tile = num_triangles if tile is None else min(tile, num_triangles)
    for lo in range(0, num_triangles, max(tile, 1)):
        hi = min(lo + tile, num_triangles)
        t, hit = ray_intersect_triangle(
            origins,
            directions,
            triangle_vertices[lo:hi],
            epsilon=epsilon,
            smoothing_factor=smoothing_factor,
        )
        conf = torch.minimum(hit, smoothing_function(hit_threshold - t, smoothing_factor))
        active = active_tile(lo, hi)
        if active is not None:
            conf = torch.where(active, conf, 0.0)
        out = torch.minimum(out + conf.sum(dim=-1), one)
    return out


def ray_intersect_any_triangle(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    hit_tol: float | None = None,
    epsilon: float | None = None,
    smoothing_factor: float | torch.Tensor | None = None,
    batch_size: int | None = 512,
) -> torch.Tensor:
    """Whether each ray hits any (active) triangle before ``t = 1 - hit_tol``.

    Rays broadcast over ``[*batch, 3]``; ``triangle_vertices`` is
    ``[num_triangles, 3, 3]``, tested ``batch_size`` at a time, and
    ``active_triangles`` ``[num_triangles]`` or ``[*batch, num_triangles]``.
    ``hit_tol`` defaults to ``100 * eps(float32)``. With a
    ``smoothing_factor`` the result is a float confidence: the clipped sum
    of the triangles' confidences (:func:`smoothed_any_hit`).

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
    if smoothing_factor is not None:
        return smoothed_any_hit(
            ray_origins,
            ray_directions,
            triangle_vertices,
            lambda lo, hi: None if active_triangles is None else active_triangles[..., lo:hi],
            hit_threshold,
            smoothing_factor=smoothing_factor,
            epsilon=epsilon,
            tile=batch_size,
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


def visibility_frustums(
    vertex: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
) -> torch.Tensor:
    """``[*batch, 2, 3]``: the frustum of each ``[*batch, 3]`` vertex over the (active) triangles' corners and centres."""
    centers = triangle_vertices.mean(dim=-2, keepdim=True)
    world_vertices = torch.cat((triangle_vertices, centers), dim=-2).reshape(-1, 3)
    active_vertices = (
        None if active_triangles is None else active_triangles.repeat_interleave(4)
    )
    return viewing_frustum(vertex, world_vertices, active_vertices=active_vertices)


def mark_visible(visible: torch.Tensor, hit_indices: torch.Tensor) -> torch.Tensor:
    """Set ``visible [*batch, T + 1]`` at each ``[*batch, rays]`` first hit; a miss (-1) marks the spare column ``T``."""
    num_triangles = visible.shape[-1] - 1
    return visible.scatter_(-1, torch.where(hit_indices < 0, num_triangles, hit_indices), True)


def triangles_visible_from_vertex(
    vertex: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    num_rays: int = int(1e6),
    batch_size: int | None = 512,
    *,
    epsilon: float | None = None,
) -> torch.Tensor:
    """Which triangles each vertex sees, estimated by ray launching, ``[*batch, T]`` bool.

    From each ``[*batch, 3]`` vertex, ``num_rays`` Fibonacci-lattice rays
    spread over the frustum of the (active) triangles' corners and centres;
    the first (active) triangle each ray hits is marked visible. Rays go
    ``batch_size`` at a time; each tile is one closest-hit scan over all
    ``[T, 3, 3]`` triangles, whose ties at equal ``t`` keep the lowest index.

    >>> import torch
    >>> from differt_tpu_torch.geometry import Mesh
    >>> box = Mesh.box(10.0, 10.0, 10.0, with_top=True, device="cpu")
    >>> inside = triangles_visible_from_vertex(torch.zeros(3), box.triangle_vertices, num_rays=2000)
    >>> int(inside.sum())  # from inside a closed box, every face
    12
    """
    batch = vertex.shape[:-1]
    num_triangles = triangle_vertices.shape[0]
    visible = torch.zeros((*batch, num_triangles + 1), dtype=torch.bool, device=vertex.device)
    if num_triangles == 0:
        return visible[..., :0]
    frustum = visibility_frustums(vertex, triangle_vertices, active_triangles)
    directions = fibonacci_lattice(num_rays, frustum=frustum)
    tile = num_rays if batch_size is None else max(min(batch_size, num_rays), 1)
    for lo in range(0, num_rays, tile):
        idx, _ = first_triangle_hit_by_ray(
            vertex[..., None, :],
            directions[..., lo : lo + tile, :],
            triangle_vertices,
            active_triangles,
            batch_size=None,
            epsilon=epsilon,
        )
        mark_visible(visible, idx)
    return visible[..., :num_triangles]
