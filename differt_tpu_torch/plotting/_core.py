"""Draw primitives for the vispy, plotly and matplotlib backends (port of ``differt_tpu.plotting._core``).

Seven primitives: mesh, paths, rays, markers, image, contour, surface.
Tensors become numpy arrays on entry (:func:`to_numpy`).
"""

from typing import Any

import numpy as np

from ._utils import PlotOutput, current_figure, get_backend, merged_kwargs, to_numpy


def _plotly_figure():
    import plotly.graph_objects as go

    fig = current_figure()
    return fig if fig is not None else go.Figure()


def _mpl_axes(three_d: bool = True):
    import matplotlib.pyplot as plt

    fig = current_figure()
    if fig is None:
        fig = plt.figure()
    if fig.axes:
        return fig, fig.axes[0]
    ax = fig.add_subplot(projection="3d" if three_d else None)
    return fig, ax


def draw_mesh(
    mesh,
    *,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw a triangle mesh."""
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    vertices = to_numpy(mesh.vertices)
    triangles = to_numpy(mesh.triangles)
    colors = (
        to_numpy(mesh.face_colors) if mesh.face_colors is not None else None
    )
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_mesh(vertices, triangles, colors, **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        fig.add_trace(
            go.Mesh3d(
                x=vertices[:, 0],
                y=vertices[:, 1],
                z=vertices[:, 2],
                i=triangles[:, 0],
                j=triangles[:, 1],
                k=triangles[:, 2],
                facecolor=[
                    f"rgb({int(r * 255)},{int(g * 255)},{int(b * 255)})"
                    for r, g, b in colors
                ]
                if colors is not None
                else None,
                **kwargs,
            )
        )
        return fig
    fig, ax = _mpl_axes()
    ax.plot_trisurf(
        vertices[:, 0],
        vertices[:, 1],
        vertices[:, 2],
        triangles=triangles,
        **kwargs,
    )
    return fig


def draw_paths(paths, *, backend: str | None = None, **kwargs: Any) -> PlotOutput:
    """Draw polyline paths of shape ``[*batch path_length 3]``."""
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    paths = to_numpy(paths)
    paths = paths.reshape(-1, paths.shape[-2], 3)
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_paths(paths, **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        # One trace with None-separated segments: fast for many paths.
        xs, ys, zs = [], [], []
        for path in paths:
            xs.extend([*path[:, 0], None])
            ys.extend([*path[:, 1], None])
            zs.extend([*path[:, 2], None])
        fig.add_trace(
            go.Scatter3d(x=xs, y=ys, z=zs, mode=kwargs.pop("mode", "lines"), **kwargs)
        )
        return fig
    fig, ax = _mpl_axes()
    for path in paths:
        ax.plot(path[:, 0], path[:, 1], path[:, 2], **kwargs)
    return fig


def draw_rays(
    ray_origins,
    ray_directions,
    *,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw rays as segments from origins to origins + directions."""
    ray_origins = to_numpy(ray_origins).reshape(-1, 3)
    ray_directions = to_numpy(ray_directions).reshape(-1, 3)
    segments = np.stack((ray_origins, ray_origins + ray_directions), axis=1)
    return draw_paths(segments, backend=backend, **kwargs)


def draw_markers(
    markers,
    labels: list[str] | None = None,
    *,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw 3D point markers with optional text labels.

    >>> import torch
    >>> fig = draw_markers(torch.zeros((2, 3)), backend="matplotlib")
    >>> type(fig).__name__
    'Figure'
    >>> import matplotlib.pyplot as plt
    >>> plt.close(fig)
    """
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    markers = to_numpy(markers).reshape(-1, 3)
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_markers(markers, labels, **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        fig.add_trace(
            go.Scatter3d(
                x=markers[:, 0],
                y=markers[:, 1],
                z=markers[:, 2],
                mode="markers+text" if labels else "markers",
                text=labels,
                **kwargs,
            )
        )
        return fig
    fig, ax = _mpl_axes()
    ax.scatter(markers[:, 0], markers[:, 1], markers[:, 2], **kwargs)
    if labels:
        for (x, y, z), label in zip(markers, labels):
            ax.text(x, y, z, label)
    return fig


def draw_image(
    data,
    *,
    x=None,
    y=None,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw a 2D image / heatmap."""
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    data = to_numpy(data)
    x, y = (None if a is None else to_numpy(a) for a in (x, y))
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_image(data, x, y, **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        fig.add_trace(
            go.Heatmap(
                z=data,
                x=x,
                y=y,
                **kwargs,
            )
        )
        return fig
    fig, ax = _mpl_axes(three_d=False)
    ax.imshow(data, origin="lower", **kwargs)
    return fig


def draw_contour(
    data,
    *,
    x=None,
    y=None,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw 2D contour lines."""
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    data = to_numpy(data)
    x, y = (None if a is None else to_numpy(a) for a in (x, y))
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_contour(data, x, y, kwargs.pop("levels", None), **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        fig.add_trace(
            go.Contour(
                z=data,
                x=x,
                y=y,
                **kwargs,
            )
        )
        return fig
    fig, ax = _mpl_axes(three_d=False)
    ax.contour(data, **kwargs)
    return fig


def draw_surface(
    *,
    x,
    y,
    z,
    colors=None,
    backend: str | None = None,
    **kwargs: Any,
) -> PlotOutput:
    """Draw a parametric 3D surface with optional per-vertex colors."""
    backend = get_backend(backend)
    kwargs = merged_kwargs(backend, kwargs)
    x, y, z = to_numpy(x), to_numpy(y), to_numpy(z)
    colors = None if colors is None else to_numpy(colors)
    if backend == "vispy":
        from . import _vispy

        return _vispy.draw_surface(x, y, z, colors, **kwargs)
    if backend == "plotly":
        import plotly.graph_objects as go

        fig = _plotly_figure()
        fig.add_trace(
            go.Surface(
                x=x,
                y=y,
                z=z,
                surfacecolor=colors,
                **kwargs,
            )
        )
        return fig
    fig, ax = _mpl_axes()
    ax.plot_surface(x, y, z, **kwargs)
    return fig
