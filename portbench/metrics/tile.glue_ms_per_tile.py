"""Device ms of the tile step outside the EM chain and the ``trace.cu`` launch, per ``trace.cu`` launch.

The ``tile`` spans' device time less that of their ``em`` and ``kernel.trace`` spans: the gathers, layouts
and sums of ``coverage._coverage_tile`` and the trace wrapper's preparation.
"""

from portbench.spans import glue_ms, per_launch_ms


def read(trace: dict) -> float | None:
    return per_launch_ms(trace, glue_ms)
