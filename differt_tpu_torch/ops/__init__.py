"""Hand-written Hopper kernels, their plain PyTorch versions, and dispatch.

- :mod:`._rt`: any-hit (``csrc/anyhit.cu``) and the shared mesh preparation.
- :mod:`._trace`: the fused specular trace (``csrc/trace.cu``).
- :mod:`._build`: builds the CUDA sources with ``nvcc`` at first use.

Each wrapper takes its plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""

from ._dispatch import dispatch_ray_intersect_any_triangle
from ._rt import (
    morton_perm_points,
    ray_intersect_any_triangle_cuda,
    ray_intersect_any_triangle_reference,
)
from ._trace import trace_specular_cuda, trace_specular_reference

__all__ = (
    "dispatch_ray_intersect_any_triangle",
    "morton_perm_points",
    "ray_intersect_any_triangle_cuda",
    "ray_intersect_any_triangle_reference",
    "trace_specular_cuda",
    "trace_specular_reference",
)
