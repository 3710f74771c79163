"""The device's idle share over the traced window, in % (torch.profiler's device records, merged)."""

from portbench.tracing import idle_pct as read  # noqa: F401
