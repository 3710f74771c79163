"""Vector utilities (PyTorch port of ``differt_tpu.geometry._vectors``)."""

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # Written out so the sum runs left to right, as XLA's reduce does.
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        (
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ),
        dim=-1,
    )


def normalize(
    vectors: torch.Tensor, keepdims: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize vectors, returning ``(unit_vectors, lengths)``.

    Zero-length vectors come back unchanged with a length of 0.

    >>> import torch
    >>> unit, length = normalize(torch.tensor([3.0, 0.0, 4.0]))
    >>> [round(x, 6) for x in unit.tolist()], float(length)
    ([0.6, 0.0, 0.8], 5.0)
    """
    lengths = torch.sqrt(_dot(vectors, vectors))[..., None]
    safe = torch.where(lengths == 0.0, torch.ones_like(lengths), lengths)
    unit = vectors / safe
    return unit, (lengths if keepdims else lengths[..., 0])


def perpendicular_vector(u: torch.Tensor) -> torch.Tensor:
    """A unit vector perpendicular to ``u`` (the reference's branch rule)."""
    zeros = torch.zeros_like(u[..., 0])
    cand_a = torch.stack((-u[..., 1], u[..., 0], zeros), dim=-1)
    cand_b = torch.stack((zeros, -u[..., 2], u[..., 1]), dim=-1)
    pick_a = (torch.abs(u[..., 0]) > torch.abs(u[..., 1]))[..., None]
    return normalize(_cross(u, torch.where(pick_a, cand_a, cand_b)))[0]


def orthogonal_basis(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit vectors ``(v, w)`` forming an orthogonal basis with ``u``."""
    w = perpendicular_vector(u)
    v = normalize(_cross(w, u))[0]
    return v, w


def path_length(path: torch.Tensor) -> torch.Tensor:
    """Total Euclidean length of each ``[*batch, path_length, 3]`` polyline path.

    >>> import torch
    >>> float(path_length(torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 0.0], [3.0, 4.0, 0.0]])))
    7.0
    """
    segments = path[..., 1:, :] - path[..., :-1, :]
    return torch.sqrt(_dot(segments, segments)).sum(dim=-1)


def rotation_matrix_along_x_axis(angle) -> torch.Tensor:
    """``[3, 3]`` rotation by ``angle`` (rad) about the x axis.

    >>> import math
    >>> [round(x, 6) + 0.0 for x in (rotation_matrix_along_x_axis(math.pi / 2) @ torch.tensor([0.0, 1.0, 0.0])).tolist()]
    [0.0, 0.0, 1.0]
    """
    c, s, one, zero = _trig(angle)
    return torch.stack((
        torch.stack((one, zero, zero)),
        torch.stack((zero, c, -s)),
        torch.stack((zero, s, c)),
    ))


def rotation_matrix_along_y_axis(angle) -> torch.Tensor:
    """``[3, 3]`` rotation by ``angle`` (rad) about the y axis."""
    c, s, one, zero = _trig(angle)
    return torch.stack((
        torch.stack((c, zero, s)),
        torch.stack((zero, one, zero)),
        torch.stack((-s, zero, c)),
    ))


def rotation_matrix_along_z_axis(angle) -> torch.Tensor:
    """``[3, 3]`` rotation by ``angle`` (rad) about the z axis."""
    c, s, one, zero = _trig(angle)
    return torch.stack((
        torch.stack((c, -s, zero)),
        torch.stack((s, c, zero)),
        torch.stack((zero, zero, one)),
    ))


def _trig(angle) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``cos``, ``sin``, one and zero of a float32 (or given floating) angle."""
    angle = torch.as_tensor(angle)
    if not angle.is_floating_point():
        angle = angle.to(torch.float32)
    c = torch.cos(angle)
    return c, torch.sin(angle), torch.ones_like(c), torch.zeros_like(c)


def rotation_matrix_along_axis(angle, axis) -> torch.Tensor:
    """``[3, 3]`` rotation by ``angle`` (rad) about the unit vector ``axis`` (Rodrigues' formula).

    >>> import math
    >>> r = rotation_matrix_along_axis(math.pi / 2, torch.tensor([0.0, 0.0, 1.0]))
    >>> [round(x, 6) + 0.0 for x in (r @ torch.tensor([1.0, 0.0, 0.0])).tolist()]
    [0.0, 1.0, 0.0]
    """
    axis = torch.as_tensor(axis)
    if not axis.is_floating_point():
        axis = axis.to(torch.float32)
    c, s, _, _ = _trig(torch.as_tensor(angle, device=axis.device))
    zero = torch.zeros_like(axis[0])
    cross = torch.stack((
        torch.stack((zero, -axis[2], axis[1])),
        torch.stack((axis[2], zero, -axis[0])),
        torch.stack((-axis[1], axis[0], zero)),
    ))
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    return c * eye + s * cross + (1.0 - c) * torch.outer(axis, axis)


def min_distance_between_cells(cell_vertices: torch.Tensor, cell_ids: torch.Tensor, *, chunk: int = 1024) -> torch.Tensor:
    """For every ``[*batch, 3]`` vertex, the least distance to a vertex of another cell (``inf`` if none).

    O(n^2) work, done ``chunk`` vertices at a time so memory stays
    O(chunk * n).

    >>> v = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [3.0, 0, 0]])
    >>> min_distance_between_cells(v, torch.tensor([0, 0, 1])).tolist()
    [3.0, 2.0, 2.0]
    """
    cell_vertices = torch.as_tensor(cell_vertices)
    cell_ids = torch.as_tensor(cell_ids, device=cell_vertices.device)
    flat_v = cell_vertices.reshape(-1, 3)
    flat_ids = cell_ids.reshape(-1)
    out = []
    for start in range(0, flat_v.shape[0], chunk):
        d = flat_v[start : start + chunk, None, :] - flat_v[None, :, :]
        dist = torch.sqrt(_dot(d, d))
        other = flat_ids[start : start + chunk, None] != flat_ids[None, :]
        out.append(torch.where(other, dist, torch.inf).amin(dim=-1))
    if not out:
        return torch.empty(cell_ids.shape, dtype=cell_vertices.dtype, device=cell_vertices.device)
    return torch.cat(out).reshape(cell_ids.shape)


def cartesian_to_spherical(xyz: torch.Tensor) -> torch.Tensor:
    """Cartesian to spherical ``(r, polar, azimuth)``.

    The polar angle lies in ``[0, pi]`` from +z, the azimuth in ``[-pi, pi]``
    (``atan2``); a zero vector has a polar angle of ``pi / 2``.

    >>> import torch
    >>> [round(x, 6) for x in cartesian_to_spherical(torch.tensor([0.0, 2.0, 0.0])).tolist()]
    [2.0, 1.570796, 1.570796]
    """
    r = torch.sqrt(_dot(xyz, xyz))
    r_safe = torch.where(r == 0.0, torch.ones_like(r), r)
    polar = torch.arccos(xyz[..., 2] / r_safe)
    azimuth = torch.atan2(xyz[..., 1], xyz[..., 0])
    return torch.stack((r, polar, azimuth), dim=-1)


def spherical_to_cartesian(rpa: torch.Tensor) -> torch.Tensor:
    """Spherical ``(r, polar, azimuth)``, or ``(polar, azimuth)`` with ``r = 1``, to Cartesian.

    >>> import math, torch
    >>> [round(x, 6) + 0.0 for x in spherical_to_cartesian(torch.tensor([math.pi / 2, 0.0])).tolist()]
    [1.0, 0.0, 0.0]
    """
    p = rpa[..., -2]
    a = rpa[..., -1]
    sp = torch.sin(p)
    xyz = torch.stack((sp * torch.cos(a), sp * torch.sin(a), torch.cos(p)), dim=-1)
    if rpa.shape[-1] == 3:
        xyz = xyz * rpa[..., 0, None]
    return xyz


def assemble_path(
    from_vertex: torch.Tensor,
    intermediate_vertices: torch.Tensor,
    to_vertex: torch.Tensor | None = None,
) -> torch.Tensor:
    """Concatenate start, intermediate and end vertices into full paths.

    With ``to_vertex=None``, ``intermediate_vertices`` is the end vertex.
    """
    if to_vertex is None:
        batch = torch.broadcast_shapes(
            from_vertex.shape[:-1], intermediate_vertices.shape[:-1]
        )
        return torch.cat(
            (
                from_vertex[..., None, :].expand(*batch, 1, 3),
                intermediate_vertices[..., None, :].expand(*batch, 1, 3),
            ),
            dim=-2,
        )
    batch = torch.broadcast_shapes(
        from_vertex.shape[:-1],
        intermediate_vertices.shape[:-2],
        to_vertex.shape[:-1],
    )
    return torch.cat(
        (
            from_vertex[..., None, :].expand(*batch, 1, 3),
            intermediate_vertices.expand(*batch, *intermediate_vertices.shape[-2:]),
            to_vertex[..., None, :].expand(*batch, 1, 3),
        ),
        dim=-2,
    )
