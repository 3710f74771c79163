"""Fused tiles per plan: the ``tile`` spans that hold a ``kernel.em`` span, over the ``tile.prep`` spans.

A ``tile.prep`` span lays out what a fused tile's kernels read of one
candidate set, once per set and call (``coverage._tile_plan``); every fused
tile of that set then launches on slices of it. None where the program has
no ``tile.prep`` span (each tile then lays out its own inputs).
"""

from portbench.spans import read as read_spans


def read(trace: dict) -> float | None:
    spans = read_spans()
    if spans is None:
        return None
    plans = sum(1 for s in spans if s["name"] == "tile.prep")
    if not plans:
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
    return len(fused) / plans
