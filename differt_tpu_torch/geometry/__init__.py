"""Geometry: meshes, scenes, traced paths, candidates and vector helpers."""

from ._candidates import (
    count_path_candidates,
    generate_path_candidates,
)
from ._mesh import Mesh
from ._paths import TracedPaths
from ._scene import Scene
from ._vectors import assemble_path, normalize, orthogonal_basis, perpendicular_vector

__all__ = (
    "Mesh",
    "Scene",
    "TracedPaths",
    "assemble_path",
    "count_path_candidates",
    "generate_path_candidates",
    "normalize",
    "orthogonal_basis",
    "perpendicular_vector",
)
