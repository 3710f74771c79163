"""Image-method specular path solver (port of ``differt_tpu.rt._image_method``).

The forward pass computes consecutive mirror images of the source; the
backward pass intersects segments toward those images with each mirror
plane, last mirror first. The JAX ``scan``s become loops over the (few)
mirrors, vectorized over the batch.
"""

import torch

from ..geometry._vectors import _dot
from ..utils import smoothing_function


def sign(x: torch.Tensor) -> torch.Tensor:
    """``sign`` with ``sign(0) = 0`` and NaN kept NaN, as ``jnp.sign``.

    ``torch.sign`` maps NaN to 0, which would make a NaN compare equal to 0.
    """
    return torch.where(torch.isnan(x), x, torch.sign(x))


def image_of_vertex_with_respect_to_mirror(
    vertex: torch.Tensor, mirror_vertex: torch.Tensor, mirror_normal: torch.Tensor
) -> torch.Tensor:
    """The mirror image of ``vertex`` across the plane through ``mirror_vertex`` of unit normal ``mirror_normal`` (all ``[*batch, 3]``, broadcast).

    >>> import torch
    >>> image_of_vertex_with_respect_to_mirror(
    ...     torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 1.0]), torch.tensor([0.0, 0.0, 1.0])
    ... ).tolist()
    [1.0, 2.0, -1.0]
    """
    offset = _dot(vertex - mirror_vertex, mirror_normal)[..., None]
    return vertex - 2.0 * offset * mirror_normal


def intersection_of_ray_with_plane(
    ray_origin: torch.Tensor,
    ray_direction: torch.Tensor,
    plane_vertex: torch.Tensor,
    plane_normal: torch.Tensor,
) -> torch.Tensor:
    """Where the line ``ray_origin + t ray_direction`` meets the plane (all ``[*batch, 3]``, broadcast).

    A ray parallel to the plane and off it gives ``inf``; one in the plane
    gives its origin.

    >>> import torch
    >>> intersection_of_ray_with_plane(
    ...     torch.tensor([0.0, 0.0, 2.0]), torch.tensor([1.0, 0.0, -1.0]),
    ...     torch.tensor([0.0, 0.0, 0.0]), torch.tensor([0.0, 0.0, 1.0]),
    ... ).tolist()
    [2.0, 0.0, 0.0]
    """
    dn = _dot(ray_direction, plane_normal)[..., None]
    vn = _dot(plane_vertex - ray_origin, plane_normal)[..., None]
    parallel = dn == 0.0
    t = vn / torch.where(parallel, torch.ones_like(dn), dn)
    point = ray_origin + ray_direction * t
    return torch.where(parallel & (vn != 0.0), torch.full_like(point, torch.inf), point)


def image_method(
    from_vertex: torch.Tensor,
    to_vertex: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
) -> torch.Tensor:
    """Specular path points through an ordered list of mirrors.

    Broadcasts ``from_vertex [*, 3]``, ``to_vertex [*, 3]`` and the mirrors
    ``[*, num_mirrors, 3]``; returns ``[*batch, num_mirrors, 3]``.
    Impossible configurations (a segment parallel to a mirror it should
    cross) come out as ``inf`` vertices.

    >>> import torch
    >>> image_method(
    ...     torch.tensor([0.0, 0.0, 1.0]),
    ...     torch.tensor([2.0, 0.0, 1.0]),
    ...     torch.tensor([[1.0, 0.0, 0.0]]),
    ...     torch.tensor([[0.0, 0.0, 1.0]]),
    ... ).tolist()
    [[1.0, 0.0, 0.0]]
    """
    num_mirrors = mirror_vertices.shape[-2]
    batch = torch.broadcast_shapes(
        from_vertex.shape[:-1],
        to_vertex.shape[:-1],
        mirror_vertices.shape[:-2],
        mirror_normals.shape[:-2],
    )
    if num_mirrors == 0:
        return torch.empty((*batch, 0, 3), dtype=from_vertex.dtype, device=from_vertex.device)

    images = []
    image = from_vertex
    for b in range(num_mirrors):
        image = image_of_vertex_with_respect_to_mirror(
            image, mirror_vertices[..., b, :], mirror_normals[..., b, :]
        )
        images.append(image)

    points = [None] * num_mirrors
    point = to_vertex
    for b in reversed(range(num_mirrors)):
        # inf - inf would be NaN: intersect from 0 and restore inf after.
        invalid = torch.isinf(point)
        safe = torch.where(invalid, torch.zeros_like(point), point)
        hit = intersection_of_ray_with_plane(
            safe, images[b] - safe, mirror_vertices[..., b, :], mirror_normals[..., b, :]
        )
        point = torch.where(invalid, torch.full_like(hit, torch.inf), hit)
        points[b] = point.expand(*batch, 3)
    return torch.stack(points, dim=-2)


def consecutive_vertices_are_on_same_side_of_mirror(
    vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
    *,
    smoothing_factor: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Whether the vertices around each mirror lie on the same side of it.

    ``vertices [*, num_mirrors + 2, 3]``; returns ``[*, num_mirrors]`` bool
    or, with a ``smoothing_factor``, the confidence
    ``sigmoid(sign * sign * smoothing_factor)`` (a constant of the inputs:
    ``sign`` passes no gradient).
    """
    if vertices.shape[-2] != mirror_vertices.shape[-2] + 2:
        msg = "'vertices' must hold two more points than there are mirrors."
        raise TypeError(msg)
    dot_prev = _dot(vertices[..., :-2, :] - mirror_vertices, mirror_normals)
    dot_next = _dot(vertices[..., 2:, :] - mirror_vertices, mirror_normals)
    if smoothing_factor is not None:
        return smoothing_function(sign(dot_prev) * sign(dot_next), smoothing_factor)
    return sign(dot_prev) == sign(dot_next)
