"""``csrc/trace.cu``'s share of its roofline, in %: the bounds of its launches (portbench/bounds.py) over its time."""

from portbench.tracing import roofline_pct


def read(trace: dict) -> float | None:
    return roofline_pct(trace, "trace_kernel", "trace")
