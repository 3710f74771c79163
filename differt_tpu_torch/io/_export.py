"""Scene writers: Stanford PLY and Sionna/Mitsuba ``scene.xml`` (a port of ``differt_tpu.io._export``).

:func:`export_scene_xml` writes the on-disk layout Sionna RT ships (a
``scene.xml`` with ``itu-radio-material`` bsdfs and one binary PLY per
shape under ``meshes/``), which :func:`~differt_tpu_torch.io.load_scene_xml`
and the JAX package's loader read back.
"""

from os import PathLike
from pathlib import Path
from xml.sax.saxutils import quoteattr

import numpy as np

from ._xml import _ITU_COLORS, _moved


def save_ply(mesh, file: str | PathLike[str]) -> None:
    """Write a mesh's vertices and triangles as a binary little-endian PLY file.

    >>> import os, tempfile
    >>> from differt_tpu_torch.geometry import Mesh
    >>> from differt_tpu_torch.io import load_ply
    >>> mesh = Mesh.box(2.0, 1.0, 1.0, device="cpu")
    >>> path = os.path.join(tempfile.mkdtemp(), "box.ply")
    >>> save_ply(mesh, path)
    >>> load_ply(path, device="cpu").num_triangles == mesh.num_triangles
    True
    """
    vertices = mesh.vertices.detach().cpu().numpy().astype("<f4")
    triangles = mesh.triangles.cpu().numpy()
    path = Path(file)
    path.parent.mkdir(parents=True, exist_ok=True)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {vertices.shape[0]}\n"
        "property float x\n"
        "property float y\n"
        "property float z\n"
        f"element face {triangles.shape[0]}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    faces = np.empty(triangles.shape[0], dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
    faces["n"] = 3
    faces["idx"] = triangles
    with path.open("wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.tobytes())
        f.write(faces.tobytes())


def _itu_type(material_name: str) -> str | None:
    """The Sionna ITU bsdf ``type`` of a material name (``Concrete``, ``itu_concrete``), or None."""
    name = material_name.lower().removeprefix("itu_")
    return name if name in _ITU_COLORS else None


def export_scene_xml(mesh, folder: str | PathLike[str]) -> Path:
    """Write ``mesh`` as a Sionna scene, ``scene.xml`` and one PLY per object; returns the XML's path.

    One ``<shape>`` and one ``meshes/object_<i>.ply`` per object of
    :meth:`~differt_tpu_torch.geometry.Mesh.iter_objects` (the whole mesh
    without object bounds), its vertices renumbered to those it uses, each
    referring to the ``itu-radio-material`` of its first face's material
    (``concrete`` when it has none or an unknown one).
    """
    folder = Path(folder)
    (folder / "meshes").mkdir(parents=True, exist_ok=True)
    mesh = _moved(mesh, "cpu")  # The files are written on the host: one copy of the mesh there.

    bsdfs: dict[str, str] = {}
    shapes: list[str] = []
    for i, obj in enumerate(mesh.iter_objects()):
        mat_name = None
        if obj.face_materials is not None and obj.material_names and obj.num_triangles > 0:
            idx = int(obj.face_materials[0])
            if 0 <= idx < len(obj.material_names):
                mat_name = obj.material_names[idx]
        itu = (_itu_type(mat_name) if mat_name else None) or "concrete"  # Sionna's default radio material
        mat_id = f"mat-itu_{itu}"
        bsdfs.setdefault(
            mat_id,
            f"    <bsdf type=\"itu-radio-material\" id={quoteattr(mat_id)}>\n"
            f"        <string name=\"type\" value={quoteattr(itu)}/>\n"
            "    </bsdf>\n",
        )
        filename = f"meshes/object_{i}.ply"
        save_ply(obj.drop_unused_vertices(), folder / filename)
        shapes.append(
            f"    <shape type=\"ply\" id={quoteattr(f'mesh-object_{i}')}>\n"
            f"        <string name=\"filename\" value={quoteattr(filename)}/>\n"
            f"        <ref id={quoteattr(mat_id)} name=\"bsdf\"/>\n"
            "        <boolean name=\"face_normals\" value=\"true\"/>\n"
            "    </shape>\n"
        )

    xml = (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        "<scene version=\"2.1.0\">\n"
        "    <default name=\"spp\" value=\"4096\"/>\n"
        "    <default name=\"resx\" value=\"1024\"/>\n"
        "    <default name=\"resy\" value=\"768\"/>\n"
        "    <integrator type=\"path\">\n"
        "        <integer name=\"max_depth\" value=\"12\"/>\n"
        "    </integrator>\n"
        + "".join(bsdfs.values())
        + "".join(shapes)
        + "</scene>\n"
    )
    scene_path = folder / "scene.xml"
    scene_path.write_text(xml, encoding="utf-8")
    return scene_path
