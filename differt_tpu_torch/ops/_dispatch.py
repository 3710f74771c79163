"""Backend switch and mesh-level ray casting (PyTorch port of ``differt_tpu.ops._dispatch``).

Backends (:func:`set_backend`): ``"auto"`` (the default) launches the
hand-written kernels on CUDA tensors and runs their plain PyTorch versions
on CPU tensors; ``"cuda"`` always launches the kernels (CPU tensors raise);
``"torch"`` always runs the plain versions, on any device. These are the
port's names for the JAX package's ``"auto"``, ``"pallas"`` and ``"jax"``.

The any-hit contract of the reference: an empty mesh blocks nothing;
inactive rays are sanitized to 0 and never reported blocked; ``hit_tol``
defaults to ``100 * eps(float32)``; each origin moves by ``d * hit_tol`` and
the hit threshold is ``1 - 2 * hit_tol``, so segments do not hit the faces
they start or end on. Inactive rays get a threshold of -1 (the kernel skips
them at once); the plain version honours the same thresholds, which is the
reference's AND with ``active_rays``.

The closest-hit contract: an empty mesh gives ``(-1, inf)``; the index
carries no gradient, and the distance is differentiable through a backward
that recomputes ``t`` from the frozen hit triangle.

Visibility (:func:`dispatch_triangles_visible_from_vertex`) is a closest
hit per lattice ray: on the card several vertices share one closest-hit
launch on the mesh's BVH that makes their lattice rays and marks their
first hits itself (:func:`~._closest.lattice_visibility_cuda`).
"""

import torch

from ..geometry._lattice import fibonacci_lattice, frustum_terms, lattice_slots
from ..geometry._vectors import _cross, _dot
from ..rt._scan import triangles_visible_from_vertex, visibility_frustums
from ..rt._triangle import F32_EPS
from . import _closest
from ._closest import (
    first_triangle_hit_by_ray_cuda,
    first_triangle_hit_by_ray_reference,
    lattice_visibility_cuda,
)
from ._rt import ray_intersect_any_triangle_cuda, ray_intersect_any_triangle_reference

_BACKENDS = ("auto", "cuda", "torch")
_BACKEND = "auto"


def set_backend(backend: str) -> None:
    """Set the global ray-casting backend: ``"auto"``, ``"cuda"`` or ``"torch"``.

    >>> set_backend("torch")
    >>> get_backend()
    'torch'
    >>> set_backend("auto")
    """
    if backend not in _BACKENDS:
        msg = f"Unknown backend {backend!r}, expected 'auto', 'cuda', or 'torch'."
        raise ValueError(msg)
    global _BACKEND
    _BACKEND = backend


def get_backend(device: torch.device | None = None) -> str:
    """The backend as set or, given the tensors' ``device``, as it resolves there.

    With a device, ``"auto"`` resolves to ``"cuda"`` for a CUDA device and
    to ``"torch"`` otherwise, and ``"cuda"`` raises for a device that is
    not CUDA.

    >>> import torch
    >>> get_backend(torch.device("cpu"))
    'torch'
    """
    if device is None:
        return _BACKEND
    if _BACKEND == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if _BACKEND == "cuda" and device.type != "cuda":
        msg = f"The 'cuda' backend needs CUDA tensors, got tensors on {device}."
        raise ValueError(msg)
    return _BACKEND


def anyhit_segments(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    *,
    hit_tol: float | None = None,
    active_rays: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The any-hit kernel's inputs for segments ``o + t d``, ``0 < t < 1``, as the dispatch makes them.

    Rays broadcast over ``[*batch, 3]``. Returns contiguous origins and
    directions ``[N, 3]`` (inactive rays zeroed, origins moved by ``d *
    hit_tol``) and thresholds ``[N]`` (``1 - 2 * hit_tol``, -1 for an
    inactive ray), ``N`` the batch's size.
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
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
    return (
        ray_origins.reshape(-1, 3).contiguous(),
        ray_directions.reshape(-1, 3).contiguous(),
        hit_threshold.reshape(-1).contiguous(),
    )


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

    # The result is boolean: rays that require a gradient (a TX being
    # placed, vertices being fitted) are cut from the graph here, so that
    # neither the kernel nor its plain version records anything.
    with torch.no_grad():
        *rays, hit_threshold = anyhit_segments(
            ray_origins, ray_directions, hit_tol=hit_tol, active_rays=active_rays
        )
        kw = {"hit_threshold": hit_threshold, "epsilon": epsilon}
        if get_backend(ray_origins.device) == "cuda":
            out = ray_intersect_any_triangle_cuda(*rays, None, None, bvh=mesh.bvh, **kw)
        else:
            out = ray_intersect_any_triangle_reference(
                *rays, mesh.triangle_vertices.contiguous(), mesh.mask, **kw
            )
    return out.reshape(batch)


def _recomputed_distance(
    vertices: torch.Tensor,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    hit_faces: torch.Tensor,
    triangles: torch.Tensor,
) -> torch.Tensor:
    """Möller–Trumbore ``t`` of each ray for its (frozen) hit triangle."""
    tv = vertices[triangles[hit_faces.clamp(min=0)]]
    v0 = tv[:, 0, :]
    edge1 = tv[:, 1, :] - v0
    edge2 = tv[:, 2, :] - v0
    det = _dot(_cross(ray_directions, edge2), edge1)
    det = torch.where(det == 0.0, torch.inf, det)
    q = _cross(ray_origins - v0, edge1)
    t = _dot(q, edge2) / det
    return torch.where(hit_faces != -1, t, torch.inf)


class _FirstHit(torch.autograd.Function):
    """Closest hit whose distance is differentiable (``_first_hit_helper`` of the reference).

    The forward runs the kernel on the mesh's BVH (``bvh``) or, when that
    is None, the plain version; the backward recomputes ``t`` from the
    frozen hit index, so that gradients reach the vertices and the rays,
    and zeroes non-finite incoming gradients (misses).
    """

    @staticmethod
    def forward(ctx, vertices, triangles, active, ray_origins, ray_directions, bvh):
        if bvh is None:
            idx, t = first_triangle_hit_by_ray_reference(
                ray_origins, ray_directions, vertices[triangles].contiguous(), active
            )
        else:
            idx, t = first_triangle_hit_by_ray_cuda(ray_origins, ray_directions, None, bvh=bvh)
        ctx.save_for_backward(vertices, triangles, ray_origins, ray_directions, idx)
        ctx.mark_non_differentiable(idx)
        return idx, t

    @staticmethod
    def backward(ctx, grad_idx, grad_t):
        del grad_idx
        vertices, triangles, ray_origins, ray_directions, idx = ctx.saved_tensors
        grad_t = torch.where(torch.isfinite(grad_t), grad_t, 0.0)
        with torch.enable_grad():
            inputs = [x.detach().requires_grad_() for x in (vertices, ray_origins, ray_directions)]
            t = _recomputed_distance(*inputs, idx, triangles)
            g_vertices, g_origins, g_directions = torch.autograd.grad(t, inputs, grad_t)
        return g_vertices, None, None, g_origins, g_directions, None


def dispatch_first_triangle_hit_by_ray(
    mesh,
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Index (int64, no gradient) and differentiable distance of the first triangle hit.

    Rays broadcast over ``[*batch, 3]``; returns two ``[*batch]`` tensors,
    ``(-1, inf)`` where nothing active is hit.
    """
    batch = torch.broadcast_shapes(ray_origins.shape[:-1], ray_directions.shape[:-1])
    device = ray_origins.device
    if mesh.num_triangles == 0:
        return (
            torch.full(batch, -1, dtype=torch.int64, device=device),
            torch.full(batch, torch.inf, dtype=mesh.vertices.dtype, device=device),
        )
    ray_origins, ray_directions = torch.broadcast_tensors(ray_origins, ray_directions)
    idx, t = _FirstHit.apply(
        mesh.vertices,
        mesh.triangles,
        mesh.mask,
        ray_origins.reshape(-1, 3).contiguous(),
        ray_directions.reshape(-1, 3).contiguous(),
        mesh.bvh if get_backend(device) == "cuda" else None,
    )
    return idx.reshape(batch), t.reshape(batch)


VISIBILITY_RAYS = 1 << 25
"""Most rays of one closest-hit launch of the visibility on the card (whole vertices at a time)."""


def visibility_groups(num_vertices: int, num_rays: int) -> list[tuple[int, int]]:
    """The ``(start, stop)`` vertex ranges whose rays share one closest-hit launch.

    >>> visibility_groups(128, 1_000_000)
    [(0, 33), (33, 66), (66, 99), (99, 128)]
    """
    per = max(1, VISIBILITY_RAYS // max(num_rays, 1))
    return [(lo, min(lo + per, num_vertices)) for lo in range(0, num_vertices, per)]


def visibility_rays(mesh, vertex: torch.Tensor, num_rays: int) -> torch.Tensor:
    """The lattice directions ``[*batch, num_rays, 3]`` of each vertex's visibility rays, in index order.

    The card's launch makes the same rays itself, in slot order; tests and
    ``chip_smoke.py`` hold it against these rays through
    :func:`~._closest.first_triangle_hit_by_ray_cuda` and ``mark_visible``.
    """
    frustum = visibility_frustums(vertex, mesh.triangle_vertices, mesh.mask)
    return fibonacci_lattice(num_rays, frustum=frustum)


def dispatch_triangles_visible_from_vertex(
    mesh,
    vertex: torch.Tensor,
    num_rays: int = int(1e6),
    *,
    batch_size: int | None = 512,
    epsilon: float | None = None,
) -> torch.Tensor:
    """Which (active) triangles each ``[*batch, 3]`` vertex sees, ``[*batch, T]`` bool.

    The vertex and the mesh are cut from any graph (the result is
    boolean). On the "cuda" backend the vertices are taken in the groups
    of :func:`visibility_groups`, one launch each on ``mesh.bvh`` that
    makes the group's lattice rays and marks their hits
    (:func:`~._closest.lattice_visibility_cuda`); otherwise the plain scan of
    :func:`~differt_tpu_torch.rt._scan.triangles_visible_from_vertex` runs
    (``batch_size`` rays at a time), counted in
    ``ops._closest.REFERENCE_CALLS``.
    """
    with torch.no_grad():
        vertex = torch.as_tensor(vertex, dtype=torch.float32, device=mesh.device).detach()
        batch = vertex.shape[:-1]
        num_triangles = mesh.num_triangles
        if num_triangles == 0:
            return torch.zeros((*batch, 0), dtype=torch.bool, device=vertex.device)
        if get_backend(vertex.device) != "cuda":
            _closest.REFERENCE_CALLS += 1
            return triangles_visible_from_vertex(
                vertex,
                mesh.triangle_vertices.detach(),
                mesh.mask,
                num_rays,
                batch_size,
                epsilon=epsilon,
            )
        flat = vertex.reshape(-1, 3)
        tv = mesh.triangle_vertices.contiguous()
        bvh = mesh.bvh
        visible = torch.zeros(
            (flat.shape[0], num_triangles + 1), dtype=torch.bool, device=vertex.device
        )
        for lo, hi in visibility_groups(flat.shape[0], num_rays):
            lattice_visibility_cuda(
                flat[lo:hi].contiguous(),
                frustum_terms(visibility_frustums(flat[lo:hi], tv, mesh.mask)),
                lattice_slots(num_rays, vertex.device),
                tv,
                mesh.mask,
                visible[lo:hi],
                epsilon=epsilon,
                bvh=bvh,
            )
        return visible[:, :num_triangles].reshape(*batch, num_triangles)
