"""Ray primitives, the exhaustive specular path tracer, SBR ray launching and the MLM."""

from ._image_method import consecutive_vertices_are_on_same_side_of_mirror, image_method
from ._mlm import compute_tx_mlm
from ._scan import first_triangle_hit_by_ray, ray_intersect_any_triangle
from ._solvers import (
    AbstractPathLauncher,
    ExhaustivePathTracer,
    SBRPathLauncher,
    trace_path_candidates,
)
from ._triangle import ray_intersect_triangle

__all__ = (
    "AbstractPathLauncher",
    "ExhaustivePathTracer",
    "SBRPathLauncher",
    "compute_tx_mlm",
    "consecutive_vertices_are_on_same_side_of_mirror",
    "first_triangle_hit_by_ray",
    "image_method",
    "ray_intersect_any_triangle",
    "ray_intersect_triangle",
    "trace_path_candidates",
)
