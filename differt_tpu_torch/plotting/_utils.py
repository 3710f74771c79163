"""Backend dispatch, default keyword arguments and figure reuse (port of ``differt_tpu.plotting._utils``).

Three backends: vispy, matplotlib and plotly, each imported only when it
draws. The default is plotly where it is installed, else matplotlib
(vispy needs a GPU canvas, rarely there on a headless host).
"""

import contextlib
from contextvars import ContextVar
from typing import Any

import numpy as np

PlotOutput = Any
"""A backend-specific figure object."""


def to_numpy(x) -> np.ndarray:
    """``x`` as a numpy array: a tensor leaves its graph and its device at this boundary."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)

SUPPORTED_BACKENDS = ("vispy", "plotly", "matplotlib")


def _pick_default_backend() -> str:
    import importlib.util

    if importlib.util.find_spec("plotly") is not None:
        return "plotly"
    return "matplotlib"


_DEFAULT_BACKEND: str = _pick_default_backend()
_DEFAULT_KWARGS: dict[str, dict[str, Any]] = {b: {} for b in SUPPORTED_BACKENDS}

_CURRENT_FIGURE: ContextVar[Any] = ContextVar("differt_tpu_torch_current_figure", default=None)
_CURRENT_BACKEND: ContextVar[str | None] = ContextVar(
    "differt_tpu_torch_current_backend", default=None
)
_CURRENT_REUSE_KWARGS: ContextVar[dict[str, Any] | None] = ContextVar(
    "differt_tpu_torch_current_reuse_kwargs", default=None
)


def set_backend(backend: str) -> None:
    """Set the process-global default plotting backend."""
    if backend not in SUPPORTED_BACKENDS:
        msg = (
            f"Unsupported backend {backend!r}, "
            f"allowed values are: {', '.join(SUPPORTED_BACKENDS)}."
        )
        raise ValueError(msg)
    global _DEFAULT_BACKEND
    _DEFAULT_BACKEND = backend


def get_backend(backend: str | None = None) -> str:
    """Resolve the active backend name."""
    if backend is not None:
        if backend not in SUPPORTED_BACKENDS:
            msg = (
                f"Unsupported backend {backend!r}, "
                f"allowed values are: {', '.join(SUPPORTED_BACKENDS)}."
            )
            raise ValueError(msg)
        return backend
    return _CURRENT_BACKEND.get() or _DEFAULT_BACKEND


def set_defaults(backend: str, **kwargs: Any) -> None:
    """Replace default kwargs for a backend."""
    _DEFAULT_KWARGS[get_backend(backend)] = kwargs


def update_defaults(backend: str, **kwargs: Any) -> None:
    """Update (merge) default kwargs for a backend."""
    _DEFAULT_KWARGS[get_backend(backend)].update(kwargs)


def merged_kwargs(backend: str, kwargs: dict[str, Any]) -> dict[str, Any]:
    """Backend defaults < reuse(pass_all_kwargs=True) kwargs < call kwargs."""
    reuse_kwargs = _CURRENT_REUSE_KWARGS.get() or {}
    return {**_DEFAULT_KWARGS.get(backend, {}), **reuse_kwargs, **kwargs}


@contextlib.contextmanager
def use(backend: str):
    """Temporarily switch the default backend.

    >>> from differt_tpu_torch.plotting import get_backend, use
    >>> with use("matplotlib"):
    ...     get_backend()
    'matplotlib'
    """
    token = _CURRENT_BACKEND.set(get_backend(backend))
    try:
        yield
    finally:
        _CURRENT_BACKEND.reset(token)


def dispatch(fun):
    """Turn a function into a per-backend dispatcher.

    The wrapped function is documentation only; implementations are added
    with ``@fn.register("plotly")`` / ``@fn.register("matplotlib")`` and the
    call is routed by the ``backend=...`` keyword (or the active default).
    """
    registry: dict[str, Any] = {}

    def register(backend: str):
        if backend not in SUPPORTED_BACKENDS:
            msg = (
                f"Unsupported backend {backend!r}, "
                f"allowed values are: {', '.join(SUPPORTED_BACKENDS)}."
            )
            raise ValueError(msg)

        def wrapper(impl):
            registry[backend] = impl
            return impl

        return wrapper

    def call(*args: Any, backend: str | None = None, **kwargs: Any):
        resolved = get_backend(backend)
        try:
            impl = registry[resolved]
        except KeyError:
            msg = f"Backend {resolved!r} has not registered this primitive."
            raise NotImplementedError(msg) from None
        return impl(*args, **kwargs)

    call.register = register
    call.registry = registry
    call.__name__ = getattr(fun, "__name__", "dispatch")
    call.__doc__ = fun.__doc__
    return call


def current_figure() -> Any:
    """The figure currently being reused, if any."""
    return _CURRENT_FIGURE.get()


@contextlib.contextmanager
def reuse(backend: str | None = None, pass_all_kwargs: bool = False, **kwargs: Any):
    """Context reusing a single figure across multiple ``draw_*`` calls.

    Yields the figure object. With ``pass_all_kwargs=True`` the extra
    keyword arguments are forwarded to every ``draw_*`` call inside the
    context (between backend defaults and per-call kwargs in priority);
    otherwise they go to the figure/canvas constructor.
    """
    resolved = get_backend(backend)
    backend_token = _CURRENT_BACKEND.set(resolved)
    ctor_kwargs = {} if pass_all_kwargs else kwargs
    if resolved == "plotly":
        import plotly.graph_objects as go

        fig = go.Figure(**ctor_kwargs)
    elif resolved == "vispy":
        from vispy import scene

        fig = scene.SceneCanvas(
            **{"keys": "interactive", "bgcolor": "white", **ctor_kwargs}
        )
        view = fig.central_widget.add_view()
        view.camera = "turntable"
        fig._differt_view = view
    else:
        import matplotlib.pyplot as plt

        fig = plt.figure(**ctor_kwargs)
    fig_token = _CURRENT_FIGURE.set(fig)
    kwargs_token = _CURRENT_REUSE_KWARGS.set(
        kwargs if pass_all_kwargs else None
    )
    try:
        yield fig
    finally:
        _CURRENT_REUSE_KWARGS.reset(kwargs_token)
        _CURRENT_FIGURE.reset(fig_token)
        _CURRENT_BACKEND.reset(backend_token)
