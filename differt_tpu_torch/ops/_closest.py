"""Closest-hit ray casting: the Hopper kernel's wrapper, its plain version and its tie rule.

Replaces the TPU kernel ``differt_tpu/ops/_pallas_rt.py::_closest_kernel``
(launched by ``_run_closest``, entry ``pallas_first_triangle_hit_by_ray``) with
the hand-written CUDA kernel in ``differt_tpu_torch/csrc/closest.cu``.

The kernel walks the mesh's BVH (:mod:`._bvh`), one thread per ray, and
reports Morton positions; the wrapper maps them back through the BVH's
permutation. What bounds it on the H100 is the Möller–Trumbore work that
culling against the best ``t`` cannot skip and the divergence of
incoherent rays within a warp (see the kernel's header note).

On an exact tie in ``t`` (a shared edge, coincident faces) the kernel
keeps the rule of the JAX kernel, which walked 64-triangle chunks of the
Morton order: the later chunk wins, and within a chunk the earlier
triangle. As a key on the Morton position ``p``: the larger ``p // 64``
wins, then the smaller ``p`` (:func:`tie_key_winner`). The plain scan
breaks ties in index order instead, with the same ``t``: both are valid
answers of the contract.

Visibility has a launch of its own (:func:`lattice_visibility_cuda`): the
kernel makes each vertex's Fibonacci-lattice rays itself, in the slot
order of :func:`~..geometry._lattice.lattice_slots`, and marks each ray's
first hit in the ``[V, T + 1]`` visibility rows; no ray, index or ``t``
reaches device memory. Its plain version is :func:`lattice_directions`
(the per-ray arithmetic, bit-equal to :func:`~..geometry.fibonacci_lattice`)
then :func:`first_triangle_hit_by_ray_reference` and the marks.
"""

import torch

from ..geometry._vectors import spherical_to_cartesian
from ..profiling import annotate
from ..rt._scan import first_triangle_hit_by_ray, mark_visible
from ..rt._triangle import F32_EPS, ray_intersect_triangle
from ._build import check_launch, load_kernels
from ._rt import _MAX_PAIRS, T_SUB, _check, checked_bvh

LAUNCHES = 0
"""Launches of the CUDA closest-hit kernel in this process."""
REFERENCE_CALLS = 0
"""Calls of :func:`first_triangle_hit_by_ray_reference` in this process."""
LATTICE_LAUNCHES = 0
"""Launches that made their own lattice rays (:func:`lattice_visibility_cuda`), also counted in :data:`LAUNCHES`."""

_TILE = 512
"""Triangles per tile of the plain scan (its tie rule depends on it)."""


def first_triangle_hit_by_ray_reference(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    epsilon: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the closest-hit kernel, with the same contract.

    ``ray_origins`` and ``ray_directions`` are ``[R, 3]``. Returns int64
    indices and ``t`` ``[R]``: the nearest active triangle with ``t >
    epsilon``, or ``(-1, inf)``. This is :func:`~..rt._scan.first_triangle_hit_by_ray`
    with 512-triangle tiles, run on blocks of rays so that a block holds at
    most ``_MAX_PAIRS`` ray-triangle pairs.
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    num_rays = ray_origins.shape[0]
    block = max(_MAX_PAIRS // _TILE, 1)
    parts = [
        first_triangle_hit_by_ray(
            ray_origins[lo : lo + block],
            ray_directions[lo : lo + block],
            triangle_vertices,
            active_triangles,
            batch_size=_TILE,
            epsilon=epsilon,
        )
        for lo in range(0, max(num_rays, 1), block)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def tie_key_winner(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None,
    best_t: torch.Tensor,
    positions: torch.Tensor,
    *,
    epsilon: float | None = None,
) -> torch.Tensor:
    """The triangle the kernel's tie key picks for each ray, in plain PyTorch.

    ``best_t [R]`` is the plain version's distance and ``positions [T]``
    each triangle's Morton position (``MeshBVH.positions``). Among the
    active triangles hit at exactly ``best_t``, the one with the largest
    ``p // 64`` wins, then the smallest ``p``; ``-1`` where nothing is hit.
    """
    num_tris = triangle_vertices.shape[0]
    score = (positions // T_SUB) * T_SUB + (T_SUB - 1 - positions % T_SUB)
    out = torch.full(best_t.shape, -1, dtype=torch.int64, device=best_t.device)
    block = max(_MAX_PAIRS // max(num_tris, 1), 1)
    for lo in range(0, best_t.shape[0], block):
        t, hit = ray_intersect_triangle(
            ray_origins[lo : lo + block, None],
            ray_directions[lo : lo + block, None],
            triangle_vertices[None],
            epsilon=epsilon,
        )
        tied = hit & (t == best_t[lo : lo + block, None])
        if active_triangles is not None:
            tied = tied & active_triangles
        best, arg = torch.where(tied, score, -1).max(dim=-1)
        out[lo : lo + block] = torch.where(best >= 0, arg, -1)
    return out


def first_triangle_hit_by_ray_cuda(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor | None,
    active_triangles: torch.Tensor | None = None,
    *,
    epsilon: float | None = None,
    bvh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit on the CUDA kernel; see :func:`first_triangle_hit_by_ray_reference`.

    Inputs are float32 ``[R, 3]`` rays, ``[T, 3, 3]`` triangles and an
    optional ``[T]`` bool mask, contiguous and on one device. ``bvh`` is
    the triangles' :class:`._bvh.MeshBVH` (``Mesh.bvh``); it is built here
    when not given, and with it the triangles may be None on CUDA. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise); other devices raise.
    """
    device = ray_origins.device
    if device.type == "cpu":
        return first_triangle_hit_by_ray_reference(
            ray_origins, ray_directions, triangle_vertices, active_triangles, epsilon=epsilon
        )
    if device.type != "cuda":
        msg = f"The closest-hit kernel runs on CUDA tensors, not on {device}."
        raise ValueError(msg)
    num_rays = ray_origins.shape[0]
    _check("ray_origins", ray_origins, torch.float32, (num_rays, 3), device)
    _check("ray_directions", ray_directions, torch.float32, (num_rays, 3), device)
    bvh = checked_bvh(triangle_vertices, active_triangles, bvh, device)
    if epsilon is None:
        epsilon = 10.0 * F32_EPS

    idx = torch.full((num_rays,), -1, dtype=torch.int64, device=device)
    t = torch.full((num_rays,), torch.inf, dtype=torch.float32, device=device)
    if num_rays == 0 or bvh.num_triangles == 0:
        return idx, t
    pos = torch.empty(num_rays, dtype=torch.int32, device=device)
    launch_closest(ray_origins, ray_directions, bvh, epsilon, pos, t)
    return torch.where(pos >= 0, bvh.perm[pos.clamp(min=0).long()], idx), t


def launch_closest(ray_origins, ray_directions, bvh, epsilon: float, pos_out, t_out) -> None:
    """Launch ``csrc/closest.cu`` on checked inputs (counted in :data:`LAUNCHES`)."""
    global LAUNCHES
    lib = load_kernels()
    with annotate("kernel.closest"):
        status = lib.differt_closest(
            ray_origins.data_ptr(),
            ray_directions.data_ptr(),
            bvh.nodes.data_ptr(),
            bvh.triangles.data_ptr(),
            bvh.num_nodes,
            bvh.large_begin,
            bvh.num_large,
            ray_origins.shape[0],
            epsilon,
            pos_out.data_ptr(),
            t_out.data_ptr(),
            torch.cuda.current_stream(pos_out.device).cuda_stream,
        )
    LAUNCHES += 1
    check_launch("differt_closest", status)


def lattice_directions(frusta: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``[V, n, 3]``: each vertex's lattice directions in slot order, as the kernel computes them.

    ``frusta [V, 4]`` are :func:`~..geometry._lattice.frustum_terms`, ``slots
    [n, 4]`` :func:`~..geometry._lattice.lattice_slots`; the operations are
    :func:`~..geometry.fibonacci_lattice`'s, so row ``v`` equals its lattice
    over vertex ``v``'s frustum taken in slot order, bit for bit.
    """
    cos_lo, cos_hi, azim_lo, azim_hi = frusta[:, :, None].unbind(1)
    step, rest_step, frac, rest_frac = slots.unbind(-1)
    polar = torch.arccos(cos_lo * rest_step + cos_hi * step)
    azimuth = azim_lo * rest_frac + azim_hi * frac
    return spherical_to_cartesian(torch.stack((polar, azimuth), dim=-1))


def lattice_visibility_reference(
    vertices: torch.Tensor,
    frusta: torch.Tensor,
    slots: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None,
    visible: torch.Tensor,
    *,
    epsilon: float | None = None,
) -> None:
    """Plain PyTorch version of the lattice visibility launch; see :func:`lattice_visibility_cuda`."""
    directions = lattice_directions(frusta, slots)
    origins = vertices[:, None, :].expand_as(directions)
    idx, _ = first_triangle_hit_by_ray_reference(
        origins.reshape(-1, 3),
        directions.reshape(-1, 3),
        triangle_vertices,
        active_triangles,
        epsilon=epsilon,
    )
    mark_visible(visible, idx.reshape(directions.shape[:2]))


def lattice_visibility_cuda(
    vertices: torch.Tensor,
    frusta: torch.Tensor,
    slots: torch.Tensor,
    triangle_vertices: torch.Tensor | None,
    active_triangles: torch.Tensor | None,
    visible: torch.Tensor,
    *,
    epsilon: float | None = None,
    bvh=None,
) -> None:
    """Mark in ``visible [V, T + 1]`` the first hit of each vertex's lattice rays, in one launch.

    ``vertices [V, 3]``, their ``frusta [V, 4]`` and the ``slots [n, 4]``
    of an ``n``-ray lattice are float32 and contiguous; ``visible`` is bool
    and contiguous, and a ray that hits nothing marks its spare column
    ``T``. Each ray is :func:`lattice_directions`' row from its vertex; its
    hit is :func:`first_triangle_hit_by_ray_cuda`'s. ``bvh`` is as there.
    CPU tensors take :func:`lattice_visibility_reference`; CUDA tensors
    launch the kernel (or raise; counted in :data:`LAUNCHES` and
    :data:`LATTICE_LAUNCHES`); other devices raise.
    """
    global LAUNCHES, LATTICE_LAUNCHES
    device = vertices.device
    if device.type == "cpu":
        lattice_visibility_reference(
            vertices, frusta, slots, triangle_vertices, active_triangles, visible, epsilon=epsilon
        )
        return
    if device.type != "cuda":
        msg = f"The closest-hit kernel runs on CUDA tensors, not on {device}."
        raise ValueError(msg)
    num_vertices, num_rays = vertices.shape[0], slots.shape[0]
    _check("vertices", vertices, torch.float32, (num_vertices, 3), device)
    _check("frusta", frusta, torch.float32, (num_vertices, 4), device)
    _check("slots", slots, torch.float32, (num_rays, 4), device)
    bvh = checked_bvh(triangle_vertices, active_triangles, bvh, device)
    _check("visible", visible, torch.bool, (num_vertices, bvh.num_triangles + 1), device)
    if num_vertices * num_rays > 1 << 30:
        msg = f"One launch takes at most 2**30 rays, got {num_vertices} x {num_rays}."
        raise ValueError(msg)
    if epsilon is None:
        epsilon = 10.0 * F32_EPS
    if num_vertices * num_rays == 0:
        return
    if bvh.num_triangles == 0:  # every ray misses
        visible[:, -1] = True
        return
    lib = load_kernels()
    next_ray = torch.zeros(1, dtype=torch.int32, device=device)  # the persistent warps' queue
    with annotate("kernel.closest"):
        status = lib.differt_lattice_closest(
            vertices.data_ptr(),
            frusta.data_ptr(),
            slots.data_ptr(),
            num_vertices,
            num_rays,
            bvh.nodes.data_ptr(),
            bvh.triangles.data_ptr(),
            bvh.num_nodes,
            bvh.large_begin,
            bvh.num_large,
            epsilon,
            bvh.perm.data_ptr(),
            bvh.num_triangles,
            visible.data_ptr(),
            next_ray.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
    LATTICE_LAUNCHES += 1
    check_launch("differt_lattice_closest", status)
