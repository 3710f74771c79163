"""Device ms per tile in records other than the port's hand-written kernels: the EM chain (and its backward in a step).

Every other device record of the window counts, so a cell whose calls run
other work on the device besides the tiles (the hybrid's visibility) does
not report it.
"""

from portbench.tracing import other_ms_per_tile as read  # noqa: F401
