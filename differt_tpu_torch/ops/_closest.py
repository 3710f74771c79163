"""Closest-hit ray casting: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``differt_tpu/ops/_pallas_rt.py::_closest_kernel``
(launched by ``_run_closest``, entry ``pallas_first_triangle_hit_by_ray``) with
the hand-written CUDA kernel in ``differt_tpu_torch/csrc/closest.cu``.

The kernel walks the Morton-sorted mesh of :func:`._rt.sorted_mesh`, one
thread per ray, and reports positions in that order; the wrapper maps them
back through the permutation. What bounds it on the H100 is the
Möller–Trumbore work that culling against the best ``t`` cannot skip and the
divergence of incoherent rays within a warp (see the kernel's header note).

Because the mesh is sorted, an exact tie in ``t`` (a shared edge, coincident
faces) can resolve to another triangle than the plain scan's, with the same
``t``: both are valid answers of the contract.
"""

import torch

from ..rt._scan import first_triangle_hit_by_ray
from ..rt._triangle import F32_EPS
from ._build import check_launch, load_kernels
from ._rt import _MAX_PAIRS, _check, sorted_mesh

LAUNCHES = 0
"""Launches of the CUDA closest-hit kernel in this process."""
REFERENCE_CALLS = 0
"""Calls of :func:`first_triangle_hit_by_ray_reference` in this process."""

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


def first_triangle_hit_by_ray_cuda(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    epsilon: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Closest hit on the CUDA kernel; see :func:`first_triangle_hit_by_ray_reference`.

    Inputs are float32 ``[R, 3]`` rays, ``[T, 3, 3]`` triangles and an
    optional ``[T]`` bool mask, contiguous and on one device. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise);
    other devices raise.
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
    num_tris = triangle_vertices.shape[0]
    _check("ray_origins", ray_origins, torch.float32, (num_rays, 3), device)
    _check("ray_directions", ray_directions, torch.float32, (num_rays, 3), device)
    _check("triangle_vertices", triangle_vertices, torch.float32, (num_tris, 3, 3), device)
    if active_triangles is not None:
        _check("active_triangles", active_triangles, torch.bool, (num_tris,), device)
    if epsilon is None:
        epsilon = 10.0 * F32_EPS

    idx = torch.full((num_rays,), -1, dtype=torch.int64, device=device)
    t = torch.full((num_rays,), torch.inf, dtype=torch.float32, device=device)
    if num_rays == 0 or num_tris == 0:
        return idx, t
    mesh, chunk_box, tile_box, num_chunks, perm = sorted_mesh(
        triangle_vertices, active_triangles
    )
    sorted_idx = torch.empty(num_rays, dtype=torch.int32, device=device)
    lib = load_kernels()
    global LAUNCHES
    status = lib.differt_closest(
        ray_origins.data_ptr(),
        ray_directions.data_ptr(),
        mesh.data_ptr(),
        chunk_box.data_ptr(),
        tile_box.data_ptr(),
        num_rays,
        num_chunks,
        epsilon,
        sorted_idx.data_ptr(),
        t.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    LAUNCHES += 1
    check_launch("differt_closest", status)
    hit = sorted_idx >= 0
    idx = torch.where(hit, perm[sorted_idx.clamp(min=0).long()], idx)
    return idx, t
