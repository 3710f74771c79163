"""Geometry: meshes, scenes, traced and launched paths, candidates, lattices and vector helpers."""

from ._candidates import (
    count_path_candidates,
    generate_path_candidates,
)
from ._lattice import fibonacci_lattice, viewing_frustum
from ._mesh import Mesh
from ._paths import LaunchedPaths, TracedPaths
from ._scene import Scene
from ._vectors import (
    assemble_path,
    cartesian_to_spherical,
    normalize,
    orthogonal_basis,
    perpendicular_vector,
    spherical_to_cartesian,
)

__all__ = (
    "LaunchedPaths",
    "Mesh",
    "Scene",
    "TracedPaths",
    "assemble_path",
    "cartesian_to_spherical",
    "count_path_candidates",
    "fibonacci_lattice",
    "generate_path_candidates",
    "normalize",
    "orthogonal_basis",
    "perpendicular_vector",
    "spherical_to_cartesian",
    "viewing_frustum",
)
