"""``{"kind": "strided", "size": n}``: ``n`` rows in groups of 8 spread over the whole decode,
at an offset drawn from the seed."""

from portbench.reference import candidates as rc


def make(spec: dict, order: int, city: dict, rng):
    offset = int(rng.integers(0, 2**62))
    return rc.strided(city["num_primitives"], order, spec["size"], offset, city["device"])
