"""Ray primitives and the exhaustive specular path tracer."""

from ._image_method import consecutive_vertices_are_on_same_side_of_mirror, image_method
from ._scan import ray_intersect_any_triangle
from ._solvers import ExhaustivePathTracer, trace_path_candidates
from ._triangle import ray_intersect_triangle

__all__ = (
    "ExhaustivePathTracer",
    "consecutive_vertices_are_on_same_side_of_mirror",
    "image_method",
    "ray_intersect_any_triangle",
    "ray_intersect_triangle",
    "trace_path_candidates",
)
