"""Stanford PLY loader: ascii, and binary little- or big-endian (a port of ``differt_tpu.io._ply``).

Vertex positions and the faces' vertex-index lists, fan-triangulated.
"""

import struct
from os import PathLike
from pathlib import Path

import numpy as np
import torch

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_ply(file: str | PathLike[str], *, device: torch.device | str | None = None):
    """Load a Stanford .ply file as a :class:`~differt_tpu_torch.geometry.Mesh` on ``device`` (the card when None).

    >>> import os, tempfile
    >>> ply = "\\n".join([
    ...     "ply", "format ascii 1.0",
    ...     "element vertex 3", "property float x",
    ...     "property float y", "property float z",
    ...     "element face 1", "property list uchar int vertex_indices",
    ...     "end_header",
    ...     "0 0 0", "1 0 0", "0 1 0", "3 0 1 2", "",
    ... ])
    >>> with tempfile.TemporaryDirectory() as d:
    ...     path = os.path.join(d, "tri.ply")
    ...     _ = open(path, "w").write(ply)
    ...     mesh = load_ply(path, device="cpu")
    >>> mesh.num_primitives, tuple(mesh.vertices.shape)
    (1, (3, 3))
    """
    from ._obj import _mesh

    data = Path(file).read_bytes()
    if not data.startswith(b"ply"):
        msg = f"Not a PLY file: {file!r}"
        raise ValueError(msg)

    end = data.index(b"end_header") + len(b"end_header")
    newline = data.index(b"\n", end) + 1
    header = data[:newline].decode("ascii", errors="replace")
    body = data[newline:]

    fmt = "ascii"
    elements: list[tuple[str, int, list[tuple[str, ...]]]] = []
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            elements[-1][2].append(tuple(parts[1:]))

    vertices = np.zeros((0, 3), dtype=np.float32)
    faces: list[list[int]] = []

    if fmt == "ascii":
        rows = [t.split() for t in body.decode("ascii", errors="replace").split("\n") if t.strip()]
        row = 0
        for name, count, props in elements:
            if name == "vertex":
                names = [p[-1] for p in props]
                ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
                arr = np.asarray([rows[row + i] for i in range(count)], dtype=np.float32)
                vertices = arr[:, [ix, iy, iz]]
            elif name == "face":
                for i in range(count):
                    vals = rows[row + i]
                    n = int(vals[0])
                    faces.append([int(v) for v in vals[1 : 1 + n]])
            row += count
    else:
        endian = "<" if "little" in fmt else ">"
        offset = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dtype = np.dtype([(p[-1], endian + _PLY_TYPES[p[0]]) for p in props])
                arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
                offset += dtype.itemsize * count
                vertices = np.stack([arr["x"], arr["y"], arr["z"]], axis=-1).astype(np.float32)
            elif name == "face":
                # A list property: row by row.
                count_type, item_type = next((p[1], p[2]) for p in props if p[0] == "list")
                count_fmt = endian + {"u1": "B", "i1": "b", "u2": "H", "i2": "h", "u4": "I", "i4": "i"}[
                    _PLY_TYPES[count_type]
                ]
                item_np = np.dtype(endian + _PLY_TYPES[item_type])
                count_size = struct.calcsize(count_fmt)
                for _ in range(count):
                    (n,) = struct.unpack_from(count_fmt, body, offset)
                    offset += count_size
                    faces.append(np.frombuffer(body, dtype=item_np, count=n, offset=offset).tolist())
                    offset += item_np.itemsize * n
            else:
                # Skip other fixed-size elements.
                offset += count * sum(
                    np.dtype(endian + _PLY_TYPES[p[0]]).itemsize for p in props if p[0] != "list"
                )

    triangles = [(face[0], a, b) for face in faces for a, b in zip(face[1:-1], face[2:])]
    return _mesh(vertices, np.asarray(triangles, dtype=np.int32), None, None, (), device)
