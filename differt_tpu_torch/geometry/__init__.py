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
from ._paths import LaunchedPaths, TracedPaths, concatenate_paths
from ._scene import Scene
from ._vectors import (
    assemble_path,
    cartesian_to_spherical,
    normalize,
    orthogonal_basis,
    path_length,
    perpendicular_vector,
    spherical_to_cartesian,
)

__all__ = (
    "LaunchedPaths",
    "Mesh",
    "Scene",
    "SizedIterator",
    "TracedPaths",
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
    "normalize",
    "orthogonal_basis",
    "path_length",
    "perpendicular_vector",
    "spherical_to_cartesian",
    "viewing_frustum",
)
