"""Multipath lifetime map (MLM) by shooting and bouncing rays (PyTorch port of ``differt_tpu.rt._mlm``).

Rays leave each transmitter on a Fibonacci lattice and bounce ``order + 1``
times through the closest-hit kernel (or its plain version). Every crossing
of the horizontal receiver plane by a bounce of index ``>= min_order``
records a 32-bit hash of the path's primitive sequence so far into the
crossed grid cell, OR-accumulated: cells with equal values share one
multipath structure. The hash constants are the JAX package's (the boost
``hash_combine`` golden ratio, the degski multiplier and the FNV-1a offset
basis), so the maps agree bit for bit given the same hits.

CPU PyTorch has no ``uint32`` shifts, adds or scatter-``amax``, so hashes
live in int64 holding 32-bit values, and the per-cell OR is a scatter-max
over 32 bit planes (the OR of a set is the max of each bit), in plain
PyTorch on every device.
"""

import math

import torch

from ..geometry._lattice import fibonacci_lattice, viewing_frustum
from ..geometry._vectors import _dot

_MLM_EPSILON = 1e-4
"""After the first bounce, each closest-hit query starts this far along the ray."""
_MASK32 = 0xFFFFFFFF
_FNV_OFFSET = 0x811C9DC5
_BITS = 32


def _hash_int(x: torch.Tensor) -> torch.Tensor:
    """32-bit integer avalanche hash (degski multiplier), in int64 holding ``uint32`` values.

    Negative inputs wrap to their ``uint32`` bit pattern, as ``astype(uint32)`` does.

    >>> import torch
    >>> int(_hash_int(torch.tensor(0)))
    0
    >>> int(_combine_hashes(torch.tensor(1), torch.tensor(2)))
    2654435834
    """
    x = x.to(torch.int64) & _MASK32
    m = 0x045D9F3B
    x = (((x >> 16) ^ x) * m) & _MASK32
    x = (((x >> 16) ^ x) * m) & _MASK32
    return (x >> 16) ^ x


def _combine_hashes(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """Boost-style ``hash_combine`` of two ``uint32`` values held in int64."""
    return h1 ^ ((h2 + 0x9E3779B9 + ((h1 << 6) & _MASK32) + (h1 >> 2)) & _MASK32)


def _to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding ``uint32`` values -> int32 of the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _compute_tx_mlm(
    mesh,
    tx_vertices: torch.Tensor,
    ray_directions: torch.Tensor,
    receiver_plane_z: float | torch.Tensor,
    grid_min: torch.Tensor,
    grid_max: torch.Tensor,
    *,
    order: int,
    min_order: int,
    grid_size: tuple[int, int],
    assume_quads: bool,
) -> torch.Tensor:
    """The map ``[num_tx, m, n]`` (int32) for given rays ``[num_tx, num_rays, 3]``."""
    num_tx, num_rays = ray_directions.shape[:2]
    m, n = grid_size
    device, dtype = ray_directions.device, ray_directions.dtype
    cell = (grid_max - grid_min) / torch.tensor([m, n], dtype=grid_max.dtype, device=device)
    z = torch.as_tensor(receiver_plane_z, dtype=dtype, device=device)
    eps = torch.tensor(_MLM_EPSILON, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    normals = mesh.normals
    bits = torch.arange(_BITS, device=device)

    origins = tx_vertices[:, None, :].expand(num_tx, num_rays, 3)
    directions = ray_directions
    valid = torch.ones((num_tx, num_rays), dtype=torch.bool, device=device)
    path_hash = torch.full((num_tx, num_rays), _FNV_OFFSET, dtype=torch.int64, device=device)
    planes = torch.zeros((num_tx, m * n, _BITS), dtype=torch.int64, device=device)

    for bounce in range(order + 1):
        # After the first segment, start slightly along the ray so that the
        # reflection point's own triangle is not hit again.
        offset = eps if bounce > 0 else zero
        query_origins = origins + offset * directions
        triangles, t_hit = mesh.first_triangle_hit_by_ray(query_origins, directions)
        hit = torch.isfinite(t_hit)
        t_window = torch.where(hit, t_hit + offset, torch.inf)

        # Receiver-plane crossing within this segment.
        dz = directions[..., 2]
        t_plane = (z - query_origins[..., 2]) / torch.where(dz == 0.0, 1.0, dz)
        crosses = (dz.abs() > 1e-6) & (t_plane > 0.0) & (t_plane < t_window) & valid
        if bounce < min_order:
            crosses = torch.zeros_like(crosses)
        hit_xy = query_origins[..., :2] + t_plane[..., None] * directions[..., :2]
        in_grid = (
            crosses
            & (hit_xy[..., 0] >= grid_min[0])
            & (hit_xy[..., 0] <= grid_max[0])
            & (hit_xy[..., 1] >= grid_min[1])
            & (hit_xy[..., 1] <= grid_max[1])
        )
        # Off the plane t_plane is inf or NaN: pick the cells under in_grid
        # before casting to int. A point on the max edge lands in the last cell.
        cell_xy = torch.where(in_grid[..., None], torch.floor((hit_xy - grid_min) / cell), 0.0)
        cell_i = cell_xy[..., 0].to(torch.int64).clamp(0, m - 1)
        cell_j = cell_xy[..., 1].to(torch.int64).clamp(0, n - 1)

        # The hash of the bounces made so far: the segment belongs to the
        # path's prefix, not to the triangle it is about to hit.
        emitted = torch.where(in_grid, path_hash, 0)
        flat_cell = torch.where(in_grid, cell_i * n + cell_j, 0)
        bit_values = (emitted[..., None] >> bits) & 1
        planes.scatter_reduce_(
            1, flat_cell[..., None].expand(-1, -1, _BITS), bit_values, reduce="amax"
        )

        valid = valid & hit
        origins = query_origins + torch.where(hit, t_hit, 0.0)[..., None] * directions
        face_normals = normals[triangles]
        directions = directions - 2.0 * _dot(directions, face_normals)[..., None] * face_normals
        hash_face = torch.div(triangles, 2, rounding_mode="floor") if assume_quads else triangles
        path_hash = torch.where(
            hit, _combine_hashes(path_hash, _hash_int(hash_face)), path_hash
        )

    combined = (planes << bits).sum(dim=-1)
    return _to_int32_bits(combined).reshape(num_tx, m, n)


def compute_tx_mlm(
    scene,
    *,
    num_rays: int = int(1e4),
    order: int = 2,
    min_order: int = 0,
    receiver_plane_z: float = 0.0,
    grid_bounds: torch.Tensor | None = None,
    grid_size: tuple[int, int] = (100, 100),
) -> torch.Tensor:
    """Per-transmitter multipath lifetime map, ``[num_tx, m, n]`` int32.

    Rays leave each transmitter on a Fibonacci lattice over the frustum of
    the mesh and the map's corners (its polar band opened to the nadir),
    bounce ``order + 1`` times, and every crossing of the plane ``z =
    receiver_plane_z`` by a bounce of index ``>= min_order`` ORs a hash of
    the path's primitives into the crossed cell. ``grid_bounds`` is
    ``[[min_x, min_y], [max_x, max_y]]``, the mesh's footprint by default.
    """
    tx_vertices = scene.transmitters.reshape(-1, 3)
    mesh = scene.mesh
    device, dtype = tx_vertices.device, tx_vertices.dtype
    if grid_bounds is None:
        bbox = mesh.bounding_box
        grid_min, grid_max = bbox[0, :2], bbox[1, :2]
    else:
        grid_bounds = torch.as_tensor(grid_bounds, dtype=dtype, device=device)
        grid_min, grid_max = grid_bounds[0], grid_bounds[1]

    # Frustum over the mesh and the map's corners, opened to the whole lower
    # hemisphere: cells between the corners lie at steeper downward angles.
    z = torch.as_tensor(receiver_plane_z, dtype=dtype, device=device)
    corners = torch.stack((
        torch.stack((grid_min[0], grid_min[1], z)),
        torch.stack((grid_max[0], grid_min[1], z)),
        torch.stack((grid_max[0], grid_max[1], z)),
        torch.stack((grid_min[0], grid_max[1], z)),
    ))
    world_vertices = torch.cat((mesh.triangle_vertices.reshape(-1, 3), corners))
    active_vertices = None
    if mesh.mask is not None:
        active_vertices = torch.cat((
            mesh.mask.repeat_interleave(3),
            torch.ones(4, dtype=torch.bool, device=device),
        ))
    frustums = viewing_frustum(tx_vertices, world_vertices, active_vertices=active_vertices)
    frustums[:, 1, 1] = math.pi
    ray_directions = torch.stack([fibonacci_lattice(num_rays, frustum=f) for f in frustums])

    return _compute_tx_mlm(
        mesh,
        tx_vertices,
        ray_directions,
        z,
        grid_min,
        grid_max,
        order=order,
        min_order=min_order,
        grid_size=grid_size,
        assume_quads=mesh.assume_quads,
    )
