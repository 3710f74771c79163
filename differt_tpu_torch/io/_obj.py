"""Wavefront OBJ loader: vertices, fan-triangulated faces, MTL diffuse colours and materials.

A port of ``differt_tpu.io._obj``: the same parse, in the same order
(negative indices, the first use of each material, ``Kd`` colours), so
that both packages load the same arrays from the same file.
"""

from os import PathLike
from pathlib import Path

import numpy as np
import torch


def _parse_mtl(path: Path) -> dict[str, tuple[float, float, float]]:
    """``newmtl`` name -> diffuse ``Kd`` colour of an MTL file (empty if it cannot be read)."""
    colors: dict[str, tuple[float, float, float]] = {}
    current: str | None = None
    try:
        text = path.read_text(errors="replace")
    except OSError:
        return colors
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "newmtl" and len(parts) > 1:
            current = parts[1]
            colors.setdefault(current, (0.0, 0.0, 0.0))
        elif parts[0] == "Kd" and current is not None and len(parts) >= 4:
            colors[current] = (float(parts[1]), float(parts[2]), float(parts[3]))
    return colors


def _mesh(vertices, triangles, face_colors, face_materials, material_names, device):
    """A :class:`Mesh` on ``device`` (the card when None) from numpy arrays."""
    from ..geometry._mesh import Mesh, _on_card

    device = _on_card(device)
    as_t = lambda x, dtype: None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)  # noqa: E731
    return Mesh(
        vertices=as_t(np.asarray(vertices, dtype=np.float32).reshape(-1, 3), torch.float32),
        triangles=as_t(np.asarray(triangles).reshape(-1, 3), torch.int64),
        face_colors=as_t(face_colors, torch.float32),
        face_materials=as_t(face_materials, torch.int64),
        material_names=tuple(material_names),
    )


def _palette_colors(face_materials: np.ndarray, material_names: list[str], mtl_colors: dict) -> np.ndarray:
    """``[num_faces, 3]`` float32: each face's material colour (black without a material)."""
    palette = np.asarray(
        [mtl_colors.get(name, (0.0, 0.0, 0.0)) for name in material_names], dtype=np.float32
    )
    colors = np.zeros((face_materials.shape[0], 3), dtype=np.float32)
    has = face_materials >= 0
    colors[has] = palette[face_materials[has]]
    return colors


def load_obj(file: str | PathLike[str], *, device: torch.device | str | None = None):
    """Load a Wavefront .obj file as a :class:`~differt_tpu_torch.geometry.Mesh` on ``device`` (the card when None).

    Only the geometry, the diffuse colours and the material of each face
    are kept (normals and texture coordinates are not). The geometry goes
    through the native parser when it can be built (counted in
    ``native.OBJ_CALLS``), else through the Python parser (counted in
    ``native.OBJ_FALLBACK_CALLS``); both give the same arrays.

    >>> import pathlib, tempfile
    >>> with tempfile.TemporaryDirectory() as d:
    ...     path = pathlib.Path(d) / "tri.obj"
    ...     _ = path.write_text("v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n")
    ...     mesh = load_obj(path, device="cpu")
    >>> mesh.num_primitives, tuple(mesh.vertices.shape)
    (1, (3, 3))
    """
    from .. import native

    path = Path(file)
    if native.is_available():
        return _load_obj_native(path, device)
    return _load_obj_python(path, device)


def _load_obj_python(path: Path, device):
    """The Python parser: the fallback without ``g++``, and the native parser's oracle."""
    from .. import native

    native.OBJ_FALLBACK_CALLS += 1
    vertices: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []
    face_materials: list[int] = []
    material_names: list[str] = []
    mtl_colors: dict[str, tuple[float, float, float]] = {}
    current_material = -1

    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        tag = parts[0]
        if tag == "v":
            vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
        elif tag == "f":
            idx = []
            for token in parts[1:]:
                i = int(token.split("/")[0])
                idx.append(i - 1 if i > 0 else len(vertices) + i)
            # Fan triangulation of polygons.
            for a, b in zip(idx[1:-1], idx[2:]):
                faces.append((idx[0], a, b))
                face_materials.append(current_material)
        elif tag == "mtllib" and len(parts) > 1:
            mtl_colors.update(_parse_mtl(path.parent / parts[1]))
        elif tag == "usemtl" and len(parts) > 1:
            name = parts[1]
            if name not in material_names:
                material_names.append(name)
            current_material = material_names.index(name)

    mats = np.asarray(face_materials, dtype=np.int32)
    face_colors = None
    if material_names and mtl_colors:
        face_colors = _palette_colors(mats, material_names, mtl_colors)
    return _mesh(
        vertices,
        np.asarray(faces, dtype=np.int32),
        face_colors,
        mats if material_names else None,
        material_names,
        device,
    )


def _load_obj_native(path: Path, device):
    """The native parser for the geometry, and a Python scan of the ``usemtl``/``mtllib`` lines."""
    from .. import native

    vertices, triangles, sections = native.parse_obj_geometry(path)
    usemtl_names: list[str] = []
    material_names: list[str] = []
    mtl_colors: dict[str, tuple[float, float, float]] = {}
    for line in path.read_text(errors="replace").splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "usemtl" and len(parts) > 1:
            usemtl_names.append(parts[1])
            if parts[1] not in material_names:
                material_names.append(parts[1])
        elif parts[0] == "mtllib" and len(parts) > 1:
            mtl_colors.update(_parse_mtl(path.parent / parts[1]))

    face_materials = None
    face_colors = None
    if material_names:
        # sections[i] indexes the i-th usemtl statement; map it to the
        # materials in their order of first use, as the Python parser does.
        occurrence = np.asarray([material_names.index(n) for n in usemtl_names], dtype=np.int32)
        face_materials = np.where(sections >= 0, occurrence[sections.clip(min=0)], -1).astype(np.int32)
        if mtl_colors:
            face_colors = _palette_colors(face_materials, material_names, mtl_colors)
    return _mesh(vertices, triangles, face_colors, face_materials, material_names, device)
