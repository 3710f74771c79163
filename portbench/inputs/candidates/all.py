"""``{"kind": "all"}``: every row of the order's decode."""

from portbench.reference import candidates as rc


def make(spec: dict, order: int, city: dict, rng):
    num = city["num_primitives"]
    return rc.decode_range(0, rc.count(num, order), num, order, city["device"])
