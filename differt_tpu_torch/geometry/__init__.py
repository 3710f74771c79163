"""Geometry: meshes, scenes, traced and launched paths, candidates, lattices and vector helpers."""

from ._candidates import (
    SizedIterator,
    count_path_candidates,
    generate_all_path_candidates,
    generate_all_path_candidates_chunks_iter,
    generate_all_path_candidates_iter,
    generate_filtered_path_candidates,
    generate_path_candidates,
)
from ._lattice import fibonacci_lattice, viewing_frustum
from ._mesh import Mesh
from ._paths import LaunchedPaths, Paths, SBRPaths, TracedPaths, concatenate_paths, merge_cell_ids
from ._scene import Scene, TriangleScene
from ._vectors import (
    assemble_path,
    cartesian_to_spherical,
    min_distance_between_cells,
    normalize,
    orthogonal_basis,
    path_length,
    perpendicular_vector,
    rotation_matrix_along_axis,
    rotation_matrix_along_x_axis,
    rotation_matrix_along_y_axis,
    rotation_matrix_along_z_axis,
    spherical_to_cartesian,
)

__all__ = (
    "LaunchedPaths",
    "Mesh",
    "Paths",
    "SBRPaths",
    "Scene",
    "SizedIterator",
    "TracedPaths",
    "TriangleScene",
    "assemble_path",
    "cartesian_to_spherical",
    "concatenate_paths",
    "count_path_candidates",
    "fibonacci_lattice",
    "generate_all_path_candidates",
    "generate_all_path_candidates_chunks_iter",
    "generate_all_path_candidates_iter",
    "generate_filtered_path_candidates",
    "generate_path_candidates",
    "merge_cell_ids",
    "min_distance_between_cells",
    "normalize",
    "orthogonal_basis",
    "path_length",
    "perpendicular_vector",
    "rotation_matrix_along_axis",
    "rotation_matrix_along_x_axis",
    "rotation_matrix_along_y_axis",
    "rotation_matrix_along_z_axis",
    "spherical_to_cartesian",
    "viewing_frustum",
)
