"""``{"kind": "near_then_strided", "pool": p, "size": n}``: every ordered pair of the ``p``
triangles nearest the TX in plan and the ground (the configuration's
``ground_triangles``), then a strided shard at an offset drawn from the seed, up to ``n`` rows."""

import torch

from portbench.reference import candidates as rc


def make(spec: dict, order: int, city: dict, rng):
    offset = int(rng.integers(0, 2**62))
    near = rc.near_pairs(city["triangle_vertices"], city["config"]["ground_triangles"], city["tx"], spec["pool"])
    rest = rc.strided(city["num_primitives"], order, spec["size"] - near.shape[0], offset, city["device"])
    return torch.cat((near, rest))
