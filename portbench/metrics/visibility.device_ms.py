"""Device ms a map of the hybrid tracer's visibility (the ``visibility`` spans): lattice rays, ``closest.cu``,
the marks and their reduction."""

from portbench.spans import per_request_ms


def read(trace: dict) -> float | None:
    return per_request_ms("visibility")
