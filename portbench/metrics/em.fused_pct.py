"""Share of the ``tile`` spans that hold a ``kernel.em`` span, in %: the tiles whose EM chain and pixel sum ran
as one kernel (``csrc/em.cu``), not as the plain chain. None where the program has no ``kernel.em`` span."""

from portbench.spans import read as read_spans


def read(trace: dict) -> float | None:
    spans = read_spans()
    if spans is None or not any(s["name"] == "kernel.em" for s in spans):
        return None
    tiles = [i for i, s in enumerate(spans) if s["name"] == "tile"]
    if not tiles:
        return None
    fused = set()
    for s in spans:
        if s["name"] != "kernel.em":
            continue
        parent = s["parent"]
        while parent is not None and spans[parent]["name"] != "tile":
            parent = spans[parent]["parent"]
        if parent is not None:
            fused.add(parent)
    return 100.0 * len(fused) / len(tiles)
