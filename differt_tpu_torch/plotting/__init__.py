"""Plotting on vispy, matplotlib or plotly (port of ``differt_tpu.plotting``).

The ``draw_*`` primitives dispatch on a backend (a process-wide default,
:func:`use` for a block, or ``backend=``), merge each backend's default
keyword arguments, and draw into one figure inside :func:`reuse`. Tensors
become numpy arrays at the boundary; a backend is imported only when it
draws, so importing this package needs none of them.
"""

from ._core import (
    draw_contour,
    draw_image,
    draw_markers,
    draw_mesh,
    draw_paths,
    draw_rays,
    draw_surface,
)
from ._utils import (
    PlotOutput,
    dispatch,
    get_backend,
    reuse,
    set_backend,
    set_defaults,
    update_defaults,
    use,
)

__all__ = [
    "PlotOutput",
    "draw_contour",
    "draw_image",
    "draw_markers",
    "draw_mesh",
    "draw_paths",
    "draw_rays",
    "draw_surface",
    "dispatch",
    "get_backend",
    "reuse",
    "set_backend",
    "set_defaults",
    "update_defaults",
    "use",
]
