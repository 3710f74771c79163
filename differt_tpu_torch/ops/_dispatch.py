"""Mesh-level any-hit test (PyTorch port of ``differt_tpu.ops._dispatch``, any-hit part).

The contract of the reference: an empty mesh blocks nothing; inactive rays
are sanitized to 0 and never reported blocked; ``hit_tol`` defaults to
``100 * eps(float32)``; each origin moves by ``d * hit_tol`` and the hit
threshold is ``1 - 2 * hit_tol``, so segments do not hit the faces they
start or end on.

Inactive rays get a threshold of -1 (the kernel skips them at once). On
CPU tensors the plain any-hit version honours the same thresholds, which
is the reference's AND with ``active_rays``.
"""

import torch

from ..rt._triangle import F32_EPS
from ._rt import ray_intersect_any_triangle_cuda


def dispatch_ray_intersect_any_triangle(
    mesh,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    hit_tol: float | None = None,
    active_rays: torch.Tensor | None = None,
    epsilon: float | None = None,
) -> torch.Tensor:
    """Whether each segment ``o + t d``, ``0 < t < 1``, is blocked by the mesh.

    Rays broadcast over ``[*batch, 3]``; ``active_rays`` marks the rays whose
    result matters. Returns ``[*batch]`` bool.
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    if mesh.num_triangles == 0:
        return torch.zeros(batch, dtype=torch.bool, device=ray_origins.device)

    ray_origins, ray_directions = torch.broadcast_tensors(ray_origins, ray_directions)
    if active_rays is not None:
        active_rays = active_rays.expand(batch)
        keep = active_rays[..., None]
        ray_origins = torch.where(keep, ray_origins, 0.0)
        ray_directions = torch.where(keep, ray_directions, 0.0)

    if hit_tol is None:
        hit_tol = 100.0 * F32_EPS
    hit_tol = torch.as_tensor(hit_tol, dtype=torch.float32, device=ray_origins.device)
    ray_origins = ray_origins + ray_directions * hit_tol
    hit_threshold = (1.0 - 2.0 * hit_tol).expand(batch)
    if active_rays is not None:
        hit_threshold = torch.where(active_rays, hit_threshold, -1.0)

    out = ray_intersect_any_triangle_cuda(
        ray_origins.reshape(-1, 3).contiguous(),
        ray_directions.reshape(-1, 3).contiguous(),
        mesh.triangle_vertices.contiguous(),
        mesh.mask,
        hit_threshold=hit_threshold.reshape(-1).contiguous(),
        epsilon=epsilon,
    )
    return out.reshape(batch)
