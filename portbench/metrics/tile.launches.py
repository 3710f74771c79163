"""Kernel launches the host made per tile (per ``trace.cu`` launch): the tile step's dispatch.

Every launch of the window counts, so a cell whose calls launch other work
besides the tiles (the hybrid's visibility) does not report it.
"""

from portbench.tracing import launches_per_tile as read  # noqa: F401
