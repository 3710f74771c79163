"""``csrc/closest.cu``'s share of its roofline on the visibility rays, in %: the bounds of its launches over
the device time of their ``kernel.closest`` spans."""

from portbench.spans import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "kernel.closest", "closest")
