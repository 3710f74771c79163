"""Device ms of the EM chain's forward (the ``em`` spans, ``coverage.complex_amplitudes``) per ``trace.cu`` launch."""

from portbench.spans import per_launch_ms, total_ms


def read(trace: dict) -> float | None:
    return per_launch_ms(trace, lambda spans: total_ms(spans, "em"))
