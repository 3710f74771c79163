"""Seconds a step: the window's wall time, ended by a synchronise after the last whole step, over the steps completed."""

from portbench.harness import per_call_s as read  # noqa: F401
