"""The 90th percentile of every map's wall time in the window, each ended by a synchronise."""

from portbench.harness import quantile


def read(window: dict) -> float:
    return quantile(window["walls"], 90)
