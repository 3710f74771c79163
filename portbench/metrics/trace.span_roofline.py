"""``csrc/trace.cu``'s share of its roofline, in %: the bounds of its launches over the device time of their
``kernel.trace`` spans (CUDA events around each launch, none lost)."""

from portbench.spans import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "kernel.trace", "trace")
