"""Mitsuba/Sionna XML scenes (a port of ``differt_tpu.io._xml``).

Parses the ``<bsdf>`` materials (``twosided``, ``diffuse``,
``itu-radio-material``) and the ``<shape>`` file references, loads each
shape's OBJ or PLY file, tags it with its material's name and colour, and
merges all into one :class:`~differt_tpu_torch.geometry.Mesh` with one
object per shape.
"""

import dataclasses
import warnings
import xml.etree.ElementTree as ET
from os import PathLike
from pathlib import Path

import torch

# Sionna RT's display colours of the ITU materials (public data of
# NVlabs/sionna-rt's itu_material.py).
_ITU_COLORS: dict[str, tuple[float, float, float]] = {
    "vacuum": (0.8, 0.8, 0.8),
    "marble": (0.701, 0.644, 0.485),
    "concrete": (0.539, 0.539, 0.539),
    "wood": (0.266, 0.109, 0.060),
    "metal": (0.220, 0.220, 0.254),
    "brick": (0.402, 0.112, 0.087),
    "glass": (0.168, 0.139, 0.509),
    "floorboard": (0.539, 0.386, 0.025),
    "ceiling_board": (0.376, 0.539, 0.117),
    "chipboard": (0.509, 0.159, 0.323),
    "plasterboard": (0.051, 0.539, 0.133),
    "plywood": (0.136, 0.076, 0.539),
    "very_dry_ground": (0.539, 0.319, 0.223),
    "medium_dry_ground": (0.539, 0.181, 0.076),
    "wet_ground": (0.539, 0.027, 0.147),
    "clear_acrylic": (0.198, 0.804, 0.818),
    "vinyl_tile": (0.334, 0.046, 0.670),
    "carpet_tile": (0.836, 0.419, 0.888),
    "asphalt_concrete": (0.119, 0.282, 0.297),
}


@dataclasses.dataclass
class SionnaMaterial:
    """A material of a Sionna XML scene."""

    name: str
    id: str
    color: tuple[float, float, float]
    thickness: float | None = None


@dataclasses.dataclass
class SionnaShape:
    """A shape (a mesh file reference) of a Sionna XML scene."""

    type: str
    id: str
    file: str
    material_id: str


def _parse_rgb(elem: ET.Element) -> tuple[float, float, float] | None:
    parts = elem.get("value", "").split()
    return tuple(float(v) for v in parts) if len(parts) == 3 else None  # type: ignore[return-value]


@dataclasses.dataclass
class SionnaScene:
    """The materials and shapes of a Sionna XML scene, by id."""

    materials: dict[str, SionnaMaterial]
    shapes: dict[str, SionnaShape]

    @classmethod
    def load_xml(cls, file: str | PathLike[str]) -> "SionnaScene":
        """Parse a Sionna/Mitsuba ``scene.xml`` file.

        An ``itu-radio-material`` is named ``itu_<type>`` and takes the ITU
        display colour (black, with a warning, for an unknown type) and
        its ``thickness``; a ``twosided`` or ``diffuse`` bsdf takes its id
        without one leading ``mat-`` and its first ``rgb`` (black if none).
        """
        root = ET.parse(file).getroot()
        materials: dict[str, SionnaMaterial] = {}
        shapes: dict[str, SionnaShape] = {}

        for bsdf in root.iter("bsdf"):
            bsdf_type = bsdf.get("type")
            bsdf_id = bsdf.get("id")
            if bsdf_id is None:
                continue
            if bsdf_type == "itu-radio-material":
                itu_type = None
                thickness = None
                for s in bsdf.iter("string"):
                    if s.get("name") == "type":
                        itu_type = s.get("value")
                for f in bsdf.iter("float"):
                    if f.get("name") == "thickness":
                        thickness = float(f.get("value", "0"))
                if itu_type is None:
                    continue
                color = _ITU_COLORS.get(itu_type)
                if color is None:
                    warnings.warn(
                        f"unknown material type: {itu_type!r}, using default color, i.e., black",
                        stacklevel=2,
                    )
                    color = (0.0, 0.0, 0.0)
                materials[bsdf_id] = SionnaMaterial(
                    name=f"itu_{itu_type}", id=bsdf_id, color=color, thickness=thickness
                )
            elif bsdf_type in ("twosided", "diffuse"):
                rgb = next((c for c in map(_parse_rgb, bsdf.iter("rgb")) if c is not None), None)
                materials[bsdf_id] = SionnaMaterial(
                    name=bsdf_id.removeprefix("mat-"), id=bsdf_id, color=rgb or (0.0, 0.0, 0.0)
                )

        for shape in root.iter("shape"):
            shape_type = shape.get("type")
            shape_id = shape.get("id")
            if shape_type is None or shape_id is None:
                continue
            filename = None
            for s in shape.iter("string"):
                if s.get("name") == "filename":
                    filename = s.get("value")
            material_id = None
            for ref in shape.iter("ref"):
                material_id = ref.get("id")
            if filename is None:
                continue
            shapes[shape_id] = SionnaShape(
                type=shape_type, id=shape_id, file=filename, material_id=material_id or ""
            )

        return cls(materials=materials, shapes=shapes)


def _moved(mesh, device):
    """The mesh with every tensor field on ``device``."""
    return dataclasses.replace(
        mesh,
        **{
            f.name: getattr(mesh, f.name).to(device)
            for f in dataclasses.fields(mesh)
            if f.init and isinstance(getattr(mesh, f.name), torch.Tensor)
        },
    )


def load_scene_xml(file: str | PathLike[str], *, device: torch.device | str | None = None):
    """Load a Sionna XML scene as one merged :class:`~differt_tpu_torch.geometry.Mesh` on ``device`` (the card when None).

    Each shape's file is loaded and tagged with its material's colour and
    name, and the shapes are appended in file order (one object each), on
    the host; the merged mesh crosses to ``device`` once.

    >>> import os, tempfile
    >>> xml = (
    ...     '<scene version="2.1.0">'
    ...     '<bsdf type="twosided" id="mat-wall">'
    ...     '<rgb value="0.8 0.1 0.1" name="reflectance"/></bsdf>'
    ...     '<shape type="obj" id="wall">'
    ...     '<string name="filename" value="meshes/wall.obj"/>'
    ...     '<ref id="mat-wall"/></shape></scene>'
    ... )
    >>> with tempfile.TemporaryDirectory() as d:
    ...     os.mkdir(os.path.join(d, "meshes"))
    ...     _ = open(os.path.join(d, "meshes", "wall.obj"), "w").write("v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n")
    ...     _ = open(os.path.join(d, "scene.xml"), "w").write(xml)
    ...     mesh = load_scene_xml(os.path.join(d, "scene.xml"), device="cpu")
    >>> mesh.num_primitives, [round(float(c), 2) for c in mesh.face_colors[0]]
    (1, [0.8, 0.1, 0.1])
    """
    from ..geometry._mesh import Mesh, _on_card
    from ._obj import load_obj
    from ._ply import load_ply

    path = Path(file)
    sionna = SionnaScene.load_xml(path)
    mesh = None
    for shape in sionna.shapes.values():
        shape_path = path.parent / shape.file
        if shape.type == "obj":
            part = load_obj(shape_path, device="cpu")
        elif shape.type == "ply":
            part = load_ply(shape_path, device="cpu")
        else:
            warnings.warn(f"Unsupported shape type {shape.type}, skipping.", stacklevel=2)
            continue
        material = sionna.materials.get(shape.material_id)
        if material is not None:
            part = part.set_face_colors(list(material.color)).set_materials(material.name)
        mesh = part if mesh is None else mesh.append(part)

    device = _on_card(device)
    return Mesh.empty(device=device) if mesh is None else _moved(mesh, device)
