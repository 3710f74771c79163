"""``csrc/closest.cu``'s share of its roofline on the visibility rays, in %: the bounds of its launches over its time."""

from portbench.tracing import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "closest_kernel", "closest")
