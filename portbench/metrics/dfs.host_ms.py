"""Host ms a map of the candidate DFS (the ``dfs`` spans): from the masks on the host to the rows on the device."""

from portbench.spans import per_request_ms


def read(trace: dict) -> float | None:
    return per_request_ms("dfs", "host_ms")
