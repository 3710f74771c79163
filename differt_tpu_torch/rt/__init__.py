"""Ray primitives, visibility, the exhaustive and hybrid specular path tracers, first-order diffraction, the Fermat solver and mixed reflection/diffraction paths, diffuse scattering, SBR ray launching and the MLM."""

from ._diffraction import DiffractionPathTracer, diffraction_amplitudes, diffraction_point_on_edge
from ._fermat import fermat_path_on_linear_objects, fermat_path_on_planar_mirrors
from ._image_method import (
    consecutive_vertices_are_on_same_side_of_mirror,
    image_method,
    image_of_vertex_with_respect_to_mirror,
    intersection_of_ray_with_plane,
)
from ._mixed import (
    MixedPathTracer,
    count_mixed_path_candidates,
    generate_mixed_path_candidates,
    mixed_amplitudes,
)
from ._mlm import compute_tx_mlm
from ._scattering import (
    ScatteringPathTracer,
    directive_pattern_normalization,
    scattering_amplitudes,
    triangle_sample_points,
)
from ._scan import first_triangle_hit_by_ray, ray_intersect_any_triangle, triangles_visible_from_vertex
from ._solvers import (
    AbstractPathLauncher,
    AbstractPathSolver,
    AbstractPathTracer,
    ExhaustivePathTracer,
    HybridPathTracer,
    SBRPathLauncher,
    trace_path_candidates,
)
from ._triangle import ray_intersect_triangle, triangle_contains_vertex_assuming_inside_same_plane

__all__ = (
    "AbstractPathLauncher",
    "AbstractPathSolver",
    "AbstractPathTracer",
    "DiffractionPathTracer",
    "ExhaustivePathTracer",
    "HybridPathTracer",
    "MixedPathTracer",
    "SBRPathLauncher",
    "ScatteringPathTracer",
    "compute_tx_mlm",
    "consecutive_vertices_are_on_same_side_of_mirror",
    "count_mixed_path_candidates",
    "diffraction_amplitudes",
    "diffraction_point_on_edge",
    "directive_pattern_normalization",
    "fermat_path_on_linear_objects",
    "fermat_path_on_planar_mirrors",
    "first_triangle_hit_by_ray",
    "generate_mixed_path_candidates",
    "image_method",
    "image_of_vertex_with_respect_to_mirror",
    "intersection_of_ray_with_plane",
    "mixed_amplitudes",
    "ray_intersect_any_triangle",
    "ray_intersect_triangle",
    "scattering_amplitudes",
    "trace_path_candidates",
    "triangle_contains_vertex_assuming_inside_same_plane",
    "triangle_sample_points",
    "triangles_visible_from_vertex",
)
