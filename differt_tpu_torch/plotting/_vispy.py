"""vispy implementations of the draw primitives (port of ``differt_tpu.plotting._vispy``).

The figure of this backend is a ``vispy.scene.SceneCanvas`` with one 3D
view (turntable camera); :func:`reuse` carries the canvas between calls as
it does plotly's figures. It needs the optional ``vispy`` package and a
GPU canvas; the inputs arrive as numpy arrays.
"""

from typing import Any

import numpy as np

from ._utils import current_figure


def _canvas():
    """Reuse the current canvas or create one with a 3D turntable view."""
    from vispy import scene

    canvas = current_figure()
    if canvas is None or not hasattr(canvas, "central_widget"):
        canvas = scene.SceneCanvas(keys="interactive", bgcolor="white")
        view = canvas.central_widget.add_view()
        view.camera = "turntable"
        canvas._differt_view = view
    return canvas


def _view(canvas):
    from vispy import scene

    view = getattr(canvas, "_differt_view", None)
    if view is None:
        view = canvas.central_widget.add_view()
        view.camera = "turntable"
        canvas._differt_view = view
    return view


def draw_mesh(vertices, triangles, colors, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    scene.visuals.Mesh(
        vertices=np.asarray(vertices, dtype=np.float32),
        faces=np.asarray(triangles, dtype=np.uint32),
        face_colors=np.asarray(colors, dtype=np.float32)
        if colors is not None
        else None,
        shading=kwargs.pop("shading", "flat"),
        parent=_view(canvas).scene,
        **kwargs,
    )
    return canvas


def draw_paths(paths, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    paths = np.asarray(paths, dtype=np.float32)
    path_len = paths.shape[-2]
    pos = paths.reshape(-1, 3)
    # Connect consecutive points within each path, not across paths.
    idx = np.arange(pos.shape[0] - 1)
    keep = (idx + 1) % path_len != 0
    connect = np.stack((idx[keep], idx[keep] + 1), axis=-1)
    scene.visuals.Line(
        pos=pos, connect=connect, parent=_view(canvas).scene, **kwargs
    )
    return canvas


def draw_markers(markers, labels, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    view = _view(canvas)
    markers = np.asarray(markers, dtype=np.float32)
    text_kwargs = kwargs.pop("text_kwargs", {})
    scene.visuals.Markers(pos=markers, parent=view.scene, **kwargs)
    if labels is not None and len(labels):
        scene.visuals.Text(
            text=list(labels), pos=markers, parent=view.scene, **text_kwargs
        )
    return canvas


def draw_image(data, x, y, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    view = _view(canvas)
    image = scene.visuals.Image(
        np.asarray(data, dtype=np.float32), parent=view.scene, **kwargs
    )
    # Place the image in world coordinates when x/y grids are given.
    if x is not None and y is not None:
        from vispy.visuals.transforms import STTransform

        x = np.asarray(x)
        y = np.asarray(y)
        data = np.asarray(data)
        sx = (x.max() - x.min()) / max(data.shape[-1] - 1, 1)
        sy = (y.max() - y.min()) / max(data.shape[-2] - 1, 1)
        image.transform = STTransform(
            scale=(sx, sy), translate=(x.min(), y.min())
        )
    return canvas


def draw_contour(data, x, y, levels, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    scene.visuals.Isocurve(
        np.asarray(data, dtype=np.float32),
        levels=levels,
        parent=_view(canvas).scene,
        **kwargs,
    )
    return canvas


def draw_surface(x, y, z, colors, **kwargs: Any):
    from vispy import scene

    canvas = _canvas()
    surface = scene.visuals.SurfacePlot(
        x=np.asarray(x, dtype=np.float32),
        y=np.asarray(y, dtype=np.float32),
        z=np.asarray(z, dtype=np.float32),
        parent=_view(canvas).scene,
        **kwargs,
    )
    if colors is not None:
        colors = np.asarray(colors, dtype=np.float32)
        surface.mesh_data.set_vertex_colors(colors.reshape(-1, colors.shape[-1]))
    return canvas
