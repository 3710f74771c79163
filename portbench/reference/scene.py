"""The procedural city, as NumPy arrays (frozen).

A copy of ``differt_tpu_torch/scenes.py::urban_scene`` as of commit
``d3b5058`` (its template box from ``geometry/_mesh.py::Mesh.box`` with a
top and a bottom, its ground from ``Mesh.plane`` with the normal ``+z``),
written over whole arrays instead of a loop over the boxes. It gives the
same float32 vertices, triangles and object bounds, in the same order:
``portbench/tests/test_portbench_reference.py`` holds it against the port.
The benchmark makes each city here and hands the arrays to the port and
to the reference alike.
"""

import numpy as np

# Mesh.box(1, 1, 1, with_top=True): its 8 corners and 12 triangles.
_BOX_VERTICES = np.array(
    [
        [0.5, 0.5, 0.5],
        [0.5, 0.5, -0.5],
        [-0.5, 0.5, -0.5],
        [-0.5, 0.5, 0.5],
        [-0.5, -0.5, -0.5],
        [-0.5, -0.5, 0.5],
        [0.5, -0.5, -0.5],
        [0.5, -0.5, 0.5],
    ],
    dtype=np.float32,
)
_BOX_TRIANGLES = np.array(
    [
        [0, 1, 2], [0, 2, 3], [3, 2, 4], [3, 4, 5], [5, 4, 6], [5, 6, 7],
        [7, 6, 1], [7, 1, 0], [1, 4, 2], [1, 6, 4], [0, 3, 5], [0, 5, 7],
    ],
    dtype=np.int64,
)
# Mesh.plane([0, 0, 0], normal=[0, 0, 1], side_length=2): its corners over the half side.
_PLANE_CORNERS = np.array([[1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0], [-1.0, -1.0, 0.0]], dtype=np.float32)
_PLANE_TRIANGLES = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int64)


def urban_city(
    num_blocks_x: int,
    num_blocks_y: int,
    *,
    block_size: float = 50.0,
    street_width: float = 15.0,
    min_height: float = 10.0,
    max_height: float = 60.0,
    subdivisions: int = 3,
    with_ground: bool = True,
    seed: int = 0,
) -> dict:
    """``{"vertices": float32 [V, 3], "triangles": int64 [T, 3], "object_bounds": int64 [O, 2]}``.

    A Manhattan grid of ``num_blocks_x * num_blocks_y`` buildings, each a
    stack of ``subdivisions`` shrinking boxes of random height, and the
    ground (its two triangles last).
    """
    heights = np.random.default_rng(seed).uniform(min_height, max_height, (num_blocks_x, num_blocks_y))
    footprint = block_size - street_width
    extent_x = num_blocks_x * block_size
    extent_y = num_blocks_y * block_size
    i, j, level = np.meshgrid(
        np.arange(num_blocks_x), np.arange(num_blocks_y), np.arange(subdivisions), indexing="ij"
    )
    i, j, level = i.reshape(-1), j.reshape(-1), level.reshape(-1)
    h = heights[i, j]
    level_h = h / subdivisions
    # z0 of each level: the running sum of the level heights below it, added
    # one at a time as the loop of the original adds them.
    z0 = np.zeros_like(level_h)
    per_building = level_h.reshape(-1, subdivisions)
    running = np.zeros(per_building.shape[0])
    z0_levels = []
    for lv in range(subdivisions):
        z0_levels.append(running.copy())
        running = running + per_building[:, lv]
    z0 = np.stack(z0_levels, axis=-1).reshape(-1)
    frac = 1.0 - 0.25 * level
    scale = np.stack((footprint * frac, footprint * frac, level_h), axis=-1)
    center = np.stack(
        (
            (i + 0.5) * block_size - extent_x / 2.0,
            (j + 0.5) * block_size - extent_y / 2.0,
            z0 + level_h / 2.0,
        ),
        axis=-1,
    )
    num_boxes = scale.shape[0]
    box_vertices = _BOX_VERTICES[None] * scale[:, None, :] + center[:, None, :]
    nv, nt = _BOX_VERTICES.shape[0], _BOX_TRIANGLES.shape[0]
    box_triangles = _BOX_TRIANGLES[None] + (nv * np.arange(num_boxes))[:, None, None]
    starts = nt * np.arange(num_boxes)
    vertices = [box_vertices.reshape(-1, 3)]
    triangles = [box_triangles.reshape(-1, 3)]
    bounds = [np.stack((starts, starts + nt), axis=-1)]
    if with_ground:
        half = np.float32(0.5 * 2.0 * max(extent_x, extent_y))
        vertices.append((half * _PLANE_CORNERS).astype(np.float64))
        triangles.append(_PLANE_TRIANGLES + nv * num_boxes)
        bounds.append(np.array([[nt * num_boxes, nt * num_boxes + 2]]))
    return {
        "vertices": np.concatenate(vertices).astype(np.float32),
        "triangles": np.concatenate(triangles).astype(np.int64),
        "object_bounds": np.concatenate(bounds).astype(np.int64),
    }
