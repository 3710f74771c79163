"""Hand-written Hopper kernels, their plain PyTorch versions, and dispatch.

- :mod:`._rt`: any-hit (``csrc/anyhit.cu``) and the helpers the BVH is built from.
- :mod:`._bvh`: the kernels' BVH, built once per mesh (``Mesh.bvh``).
- :mod:`._closest`: closest-hit and the visibility's lattice launch (``csrc/closest.cu``).
- :mod:`._trace`: the fused specular trace (``csrc/trace.cu``).
- :mod:`._em`: a coverage tile's EM chain and per-pixel sum (``csrc/em.cu``),
  for tiles that need no gradient; CUDA tensors only.
- :mod:`._build`: builds the CUDA sources with ``nvcc`` at first use.
- :mod:`._dispatch`: the backend switch and the mesh-level entry points
  (any hit, closest hit, visibility).

Each wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises. :func:`set_backend` picks the
plain versions on any device (``"torch"``) or insists on the kernels
(``"cuda"``).
"""

from ._closest import first_triangle_hit_by_ray_cuda, first_triangle_hit_by_ray_reference
from ._dispatch import (
    dispatch_first_triangle_hit_by_ray,
    dispatch_ray_intersect_any_triangle,
    dispatch_triangles_visible_from_vertex,
    get_backend,
    set_backend,
)
from ._rt import (
    morton_perm_points,
    ray_intersect_any_triangle_cuda,
    ray_intersect_any_triangle_reference,
)
from ._trace import trace_specular_cuda, trace_specular_reference

__all__ = (
    "dispatch_first_triangle_hit_by_ray",
    "dispatch_ray_intersect_any_triangle",
    "dispatch_triangles_visible_from_vertex",
    "first_triangle_hit_by_ray_cuda",
    "first_triangle_hit_by_ray_reference",
    "get_backend",
    "morton_perm_points",
    "ray_intersect_any_triangle_cuda",
    "ray_intersect_any_triangle_reference",
    "set_backend",
    "trace_specular_cuda",
    "trace_specular_reference",
)
