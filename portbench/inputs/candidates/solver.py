"""``{"kind": "solver"}``: the solver makes the candidates (e.g. the hybrid tracer's visibility)."""


def make(spec: dict, order: int, city: dict, rng):
    return None
