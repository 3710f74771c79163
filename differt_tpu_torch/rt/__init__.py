"""Ray primitives, visibility, the exhaustive and hybrid specular path tracers, first-order diffraction, SBR ray launching and the MLM."""

from ._diffraction import DiffractionPathTracer, diffraction_amplitudes, diffraction_point_on_edge
from ._image_method import consecutive_vertices_are_on_same_side_of_mirror, image_method
from ._mlm import compute_tx_mlm
from ._scan import first_triangle_hit_by_ray, ray_intersect_any_triangle, triangles_visible_from_vertex
from ._solvers import (
    AbstractPathLauncher,
    AbstractPathTracer,
    ExhaustivePathTracer,
    HybridPathTracer,
    SBRPathLauncher,
    trace_path_candidates,
)
from ._triangle import ray_intersect_triangle

__all__ = (
    "AbstractPathLauncher",
    "AbstractPathTracer",
    "DiffractionPathTracer",
    "ExhaustivePathTracer",
    "HybridPathTracer",
    "SBRPathLauncher",
    "compute_tx_mlm",
    "consecutive_vertices_are_on_same_side_of_mirror",
    "diffraction_amplitudes",
    "diffraction_point_on_edge",
    "first_triangle_hit_by_ray",
    "image_method",
    "ray_intersect_any_triangle",
    "ray_intersect_triangle",
    "trace_path_candidates",
    "triangles_visible_from_vertex",
)
