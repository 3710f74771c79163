"""Seconds a map: the window's wall time, ended by a synchronise after the last whole map, over the maps completed."""

from portbench.harness import per_call_s as read  # noqa: F401
