"""``{"kind": "block", "size": n, "triangles_per_block": t, "blocks": [[bx, by], ...]}``: ``n``
consecutive rows from the first whose first bounce is on one of ``blocks``
of the city, the block drawn from the seed."""

from portbench.reference import candidates as rc


def make(spec: dict, order: int, city: dict, rng):
    num = city["num_primitives"]
    bx, by = spec["blocks"][int(rng.integers(len(spec["blocks"])))]
    start = rc.block_start(bx, by, city["config"]["city"]["num_blocks_y"], spec["triangles_per_block"], num)
    return rc.decode_range(start, spec["size"], num, order, city["device"])
