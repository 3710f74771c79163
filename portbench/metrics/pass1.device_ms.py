"""Device ms a step of the streamed step's pass 1 (the ``step.pass1`` span): the forward tiles, no graph."""

from portbench.spans import per_request_ms


def read(trace: dict) -> float | None:
    return per_request_ms("step.pass1")
