"""Procedural scenes (PyTorch port of ``differt_tpu.scenes``).

A two-building street canyon and a Manhattan grid of buildings; both carry
the single material ``"Concrete"``. They are built on the card
(``device=None`` means ``torch.device("cuda")``) unless asked for another
device.
"""

import numpy as np
import torch

from .geometry import Mesh, Scene


def street_canyon_scene(
    *,
    street_width: float = 20.0,
    building_height: float = 25.0,
    building_depth: float = 15.0,
    length: float = 100.0,
    with_ground: bool = True,
    device: torch.device | str | None = None,
) -> Scene:
    """A street canyon: two building rows facing each other, plus the ground.

    >>> street_canyon_scene(device="cpu").mesh.num_triangles
    26
    """
    device = torch.device("cuda") if device is None else device
    half = street_width / 2.0
    box = lambda: Mesh.box(  # noqa: E731
        length, building_depth, building_height, with_top=True, device=device
    )
    offset = half + building_depth / 2.0
    left = box().translate([0.0, -offset, building_height / 2.0])
    right = box().translate([0.0, offset, building_height / 2.0])
    mesh = left + right
    if with_ground:
        mesh = mesh + Mesh.plane(
            [0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0], side_length=2.0 * length, device=device
        )
    return Scene(mesh=mesh.set_materials("Concrete"))


def urban_scene(
    num_blocks_x: int = 8,
    num_blocks_y: int = 8,
    *,
    block_size: float = 50.0,
    street_width: float = 15.0,
    min_height: float = 10.0,
    max_height: float = 60.0,
    subdivisions: int = 3,
    with_ground: bool = True,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> Scene:
    """A Manhattan grid of buildings with random heights.

    Each building is a stack of ``subdivisions`` shrinking boxes, so a grid
    of ``nx * ny`` blocks has ``36 * nx * ny (+ 2 ground)`` triangles:
    20,738 at 24 x 24. The heights are drawn from
    ``numpy.random.default_rng(seed)``, where the JAX package draws them
    from ``jax.random``: the two cities have the same layout and triangle
    count but not the same skyline.

    >>> urban_scene(2, 2, device="cpu").mesh.num_triangles
    146
    """
    device = torch.device("cuda") if device is None else device
    heights = np.random.default_rng(seed).uniform(
        min_height, max_height, (num_blocks_x, num_blocks_y)
    )
    footprint = block_size - street_width
    extent_x = num_blocks_x * block_size
    extent_y = num_blocks_y * block_size

    # The template box and the ground feed the numpy step: built on the CPU.
    template = Mesh.box(1.0, 1.0, 1.0, with_top=True, device="cpu")
    tmpl_v = template.vertices.numpy()
    tmpl_t = template.triangles.numpy()
    verts_list, tris_list, bounds = [], [], []
    v_offset = t_offset = 0
    for i in range(num_blocks_x):
        for j in range(num_blocks_y):
            h = float(heights[i, j])
            cx = (i + 0.5) * block_size - extent_x / 2.0
            cy = (j + 0.5) * block_size - extent_y / 2.0
            z0 = 0.0
            for level in range(subdivisions):
                frac = 1.0 - 0.25 * level
                level_h = h / subdivisions
                scale = np.array([footprint * frac, footprint * frac, level_h])
                center = np.array([cx, cy, z0 + level_h / 2.0])
                verts_list.append(tmpl_v * scale + center)
                tris_list.append(tmpl_t + v_offset)
                bounds.append((t_offset, t_offset + tmpl_t.shape[0]))
                v_offset += tmpl_v.shape[0]
                t_offset += tmpl_t.shape[0]
                z0 += level_h

    if with_ground:
        ground = Mesh.plane(
            [0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0], side_length=2.0 * max(extent_x, extent_y),
            device="cpu",
        )
        verts_list.append(ground.vertices.numpy())
        tris_list.append(ground.triangles.numpy() + v_offset)
        bounds.append((t_offset, t_offset + ground.triangles.shape[0]))

    mesh = Mesh(
        vertices=torch.from_numpy(np.concatenate(verts_list).astype(np.float32)).to(device),
        triangles=torch.from_numpy(np.concatenate(tris_list).astype(np.int64)).to(device),
        object_bounds=torch.tensor(bounds, dtype=torch.int64, device=device),
    )
    return Scene(mesh=mesh.set_materials("Concrete"))
