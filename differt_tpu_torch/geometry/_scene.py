"""Scene container (PyTorch port of ``differt_tpu.geometry._scene``)."""

import dataclasses
import math
import warnings
from os import PathLike

import torch

from ._mesh import Mesh


def _resolve_solver(solver, shortcuts: dict, options: dict):
    """A solver from a registered shortcut name (built with ``options``) or an instance.

    An instance comes configured: options beside it raise.
    """
    if isinstance(solver, str):
        cls = shortcuts.get(solver)
        if cls is None:
            known = ", ".join(sorted(shortcuts))
            msg = f"No solver is registered under {solver!r}; known shortcuts: {known}."
            raise ValueError(msg)
        return cls(**options)
    if options:
        msg = (
            f"Solver options {sorted(options)} conflict with an explicit solver"
            f" instance; configure the {type(solver).__name__} directly instead."
        )
        raise ValueError(msg)
    return solver


@dataclasses.dataclass(frozen=True)
class Scene:
    """A triangle mesh plus transmitters and receivers (any batch shapes)."""

    transmitters: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.empty((0, 3))
    )
    """``[*tx_batch, 3]`` transmitter positions."""
    receivers: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.empty((0, 3))
    )
    """``[*rx_batch, 3]`` receiver positions."""
    mesh: Mesh = dataclasses.field(default_factory=Mesh.empty)
    """The scene geometry."""

    @property
    def num_transmitters(self) -> int:
        return math.prod(self.transmitters.shape[:-1])

    @property
    def num_receivers(self) -> int:
        return math.prod(self.receivers.shape[:-1])

    def set_assume_quads(self, flag: bool = True) -> "Scene":
        """:meth:`Mesh.set_assume_quads` on the scene's mesh."""
        return dataclasses.replace(self, mesh=self.mesh.set_assume_quads(flag))

    def with_transmitters_grid(
        self, m: int = 50, n: int | None = 50, *, height: float = 1.5
    ) -> "Scene":
        """Place an ``n x m`` grid of transmitters over the scene footprint."""
        return dataclasses.replace(self, transmitters=self._grid(m, n, height=height))

    def with_receivers_grid(
        self, m: int = 50, n: int | None = 50, *, height: float = 1.5
    ) -> "Scene":
        """Place an ``n x m`` grid of receivers over the scene footprint."""
        return dataclasses.replace(self, receivers=self._grid(m, n, height=height))

    def rotate(self, rotation_matrix) -> "Scene":
        """Rotate the transmitters, the receivers and the mesh by a ``[3, 3]`` matrix."""
        rotation_matrix = torch.as_tensor(
            rotation_matrix, dtype=self.mesh.vertices.dtype, device=self.mesh.device
        )

        def turn(points: torch.Tensor) -> torch.Tensor:
            return (rotation_matrix @ points.reshape(-1, 3).T).T.reshape(points.shape)

        return dataclasses.replace(
            self,
            transmitters=turn(self.transmitters),
            receivers=turn(self.receivers),
            mesh=self.mesh.rotate(rotation_matrix),
        )

    def scale(self, scale_factor) -> "Scene":
        """Scale the transmitters, the receivers and the mesh."""
        return dataclasses.replace(
            self,
            transmitters=self.transmitters * scale_factor,
            receivers=self.receivers * scale_factor,
            mesh=self.mesh.scale(scale_factor),
        )

    def translate(self, translation) -> "Scene":
        """Translate the transmitters, the receivers and the mesh."""
        translation = torch.as_tensor(
            translation, dtype=self.mesh.vertices.dtype, device=self.mesh.device
        )
        return dataclasses.replace(
            self,
            transmitters=self.transmitters + translation,
            receivers=self.receivers + translation,
            mesh=self.mesh.translate(translation),
        )

    @classmethod
    def load_xml(cls, file: str | PathLike[str], *, device: torch.device | str | None = None) -> "Scene":
        """A scene of the mesh of a Sionna/Mitsuba XML file (:func:`differt_tpu_torch.io.load_scene_xml`), on ``device`` (the card when None)."""
        from ..io import load_scene_xml

        mesh = load_scene_xml(file, device=device)
        empty = torch.empty((0, 3), device=mesh.device)
        return cls(transmitters=empty, receivers=empty, mesh=mesh)

    @classmethod
    def from_mitsuba(cls, mi_scene, *, device: torch.device | str | None = None) -> "Scene":
        """A scene of every shape of a loaded Mitsuba scene (needs the ``mitsuba`` package)."""
        import mitsuba as mi
        import numpy as np

        mesh = Mesh.empty(device=device)
        params = mi.traverse(mi_scene)
        shapes = [k.removesuffix(".vertex_positions") for k in params.keys() if k.endswith(".vertex_positions")]
        for shape in shapes:
            mesh = mesh + Mesh(
                vertices=torch.as_tensor(
                    np.asarray(params[f"{shape}.vertex_positions"]).reshape(-1, 3), device=mesh.device
                ),
                triangles=torch.as_tensor(
                    np.asarray(params[f"{shape}.faces"]).reshape(-1, 3).astype(np.int64), device=mesh.device
                ),
            )
        empty = torch.empty((0, 3), device=mesh.device)
        return cls(transmitters=empty, receivers=empty, mesh=mesh)

    @classmethod
    def from_sionna(cls, sionna_scene, *, device: torch.device | str | None = None) -> "Scene":
        """A scene of a loaded Sionna RT scene (needs the ``sionna`` and ``mitsuba`` packages)."""
        return cls.from_mitsuba(sionna_scene.mi_scene, device=device)

    def _grid(self, m: int, n: int | None, *, height: float) -> torch.Tensor:
        if n is None:
            n = m
        (min_x, min_y, _), (max_x, max_y, _) = self.mesh.bounding_box.tolist()
        kwargs = {"dtype": self.mesh.vertices.dtype, "device": self.mesh.device}
        y, x = torch.meshgrid(
            torch.linspace(min_y, max_y, n, **kwargs),
            torch.linspace(min_x, max_x, m, **kwargs),
            indexing="ij",
        )
        return torch.stack((x, y, torch.full_like(x, height)), dim=-1)

    def _batched(self, paths, trailing: int):
        """Reshape flat solver output to ``[*tx_batch, *rx_batch, trailing]`` (``-1`` allowed)."""
        return paths.reshape(
            *self.transmitters.shape[:-1], *self.receivers.shape[:-1], trailing
        )

    def trace_paths(
        self,
        order=None,
        *,
        solver="exhaustive",
        path_candidates: torch.Tensor | None = None,
        merge_orders: bool = False,
        **solver_kwargs,
    ):
        """Trace exact specular paths between all TX/RX pairs.

        ``solver`` is ``"exhaustive"``, ``"hybrid"`` (a
        :class:`~differt_tpu_torch.rt.ExhaustivePathTracer` or
        :class:`~differt_tpu_torch.rt.HybridPathTracer` built with
        ``solver_kwargs``: tolerances, ``smoothing_factor``, ``megakernel``,
        ``chunk_size``, ``num_rays``...) or a tracer instance. Returns
        :class:`TracedPaths` of batch shape ``[*tx_batch, *rx_batch,
        num_candidates]``; with a ``chunk_size``, a :class:`SizedIterator`
        of one per chunk. ``order`` may be a sequence of orders: then a
        :class:`SizedIterator` of one :class:`TracedPaths` per order (an
        iterator of one per chunk, with a ``chunk_size``), or with
        ``merge_orders`` one :class:`TracedPaths` that pads the lower orders
        to the highest (:func:`concatenate_paths`). The tracer's
        ``trace_paths`` walks the orders and chunks. ``path_candidates``
        replaces the candidate generation (the hybrid tracer needs an order).
        """
        from ..rt._solvers import ExhaustivePathTracer, HybridPathTracer
        from ._candidates import SizedIterator
        from ._paths import TracedPaths, concatenate_paths

        if order is None and path_candidates is None:
            msg = "trace_paths needs a path 'order' or explicit 'path_candidates'."
            raise ValueError(msg)
        if order is not None and path_candidates is not None:
            msg = "'order' and 'path_candidates' are mutually exclusive; pass only one."
            raise ValueError(msg)

        tracer = _resolve_solver(
            solver, {"exhaustive": ExhaustivePathTracer, "hybrid": HybridPathTracer}, solver_kwargs
        )
        if isinstance(tracer, HybridPathTracer):
            if order is None:
                msg = (
                    "The hybrid tracer prunes candidates by TX/RX visibility"
                    " and therefore needs an explicit 'order'."
                )
                raise ValueError(msg)
            if tracer.smoothing_factor is not None:
                warnings.warn(
                    "The hybrid tracer's visibility pruning is hard (non-"
                    "differentiable); its 'smoothing_factor' has no effect.",
                    UserWarning,
                    stacklevel=2,
                )

        if path_candidates is not None:
            if getattr(tracer, "chunk_size", None):
                warnings.warn(
                    "Explicit 'path_candidates' bypass candidate generation,"
                    " so 'chunk_size' has no effect.",
                    UserWarning,
                    stacklevel=2,
                )
            candidates = torch.as_tensor(path_candidates, device=self.mesh.device)
            if self.mesh.assume_quads:
                # Quad candidates address the even (first) triangle of a pair.
                candidates = candidates & ~1
            types = torch.zeros_like(candidates, dtype=torch.int32)
            return self._batched(
                tracer.trace_path_candidates(self, candidates, types), candidates.shape[0]
            )

        def batched(paths: TracedPaths) -> TracedPaths:
            return self._batched(paths, paths.shape[-1])

        several = not isinstance(order, int)
        result = tracer.trace_paths(
            self, list(order) if several else order, chunk_size=getattr(tracer, "chunk_size", None)
        )
        if isinstance(result, TracedPaths):
            return batched(result)
        if several and merge_orders:
            return batched(concatenate_paths(list(result)))
        traced = (batched(paths) for paths in result)
        return SizedIterator(traced, size=len(result)) if isinstance(result, SizedIterator) else traced

    def trace_diffraction_paths(self, **solver_kwargs):
        """First-order diffraction paths over every diffraction edge of the mesh.

        See :class:`~differt_tpu_torch.rt.DiffractionPathTracer` (built with
        ``solver_kwargs``: ``hit_tol``, ``min_len``); batch shape
        ``[num_tx, num_rx, num_edges]``.
        """
        from ..rt._diffraction import DiffractionPathTracer

        return DiffractionPathTracer(**solver_kwargs).trace_paths(self)

    def trace_mixed_paths(self, interactions, **solver_kwargs):
        """Paths of one mixed reflection/diffraction signature, e.g. ``(REFLECTION, DIFFRACTION)``.

        See :class:`~differt_tpu_torch.rt.MixedPathTracer` (built with
        ``solver_kwargs``: ``epsilon``, ``hit_tol``, ``min_len``,
        ``angle_tol``, ``steps``); batch shape ``[num_tx, num_rx,
        num_candidates]``.
        """
        from ..rt._mixed import MixedPathTracer

        return MixedPathTracer(**solver_kwargs).trace_paths(self, interactions)

    def trace_scattering_paths(self, **solver_kwargs):
        """Single-bounce diffuse-scattering paths off every triangle.

        See :class:`~differt_tpu_torch.rt.ScatteringPathTracer` (built with
        ``solver_kwargs``: ``hit_tol``, ``min_len``, ``num_samples``); batch
        shape ``[num_tx, num_rx, num_triangles * num_samples]``.
        """
        from ..rt._scattering import ScatteringPathTracer

        return ScatteringPathTracer(**solver_kwargs).trace_paths(self)

    def compute_paths(self, order: int | None = None, *, method="exhaustive", **kwargs):
        """Deprecated: :meth:`trace_paths` (``method`` "exhaustive" or "hybrid") or :meth:`launch_paths` ("sbr")."""
        warnings.warn(
            "compute_paths is deprecated, use trace_paths or launch_paths instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        if method == "sbr":
            return self.launch_paths(order, solver="sbr", **kwargs)
        return self.trace_paths(order, solver=method, **kwargs)

    def launch_paths(self, order: int | None = None, *, solver="sbr", **solver_kwargs):
        """Launch rays from each TX and keep those passing near the receivers (SBR).

        ``solver`` is ``"sbr"`` (an :class:`~differt_tpu_torch.rt.SBRPathLauncher`
        built with ``solver_kwargs``, e.g. ``num_rays``) or a launcher
        instance. Returns :class:`LaunchedPaths` of batch shape
        ``[*tx_batch, *rx_batch, num_rays]`` with one mask per order 0 ... ``order``.
        """
        from ..rt._solvers import SBRPathLauncher

        if order is None:
            msg = "launch_paths needs a maximum bounce 'order'."
            raise ValueError(msg)
        launcher = _resolve_solver(solver, {"sbr": SBRPathLauncher}, solver_kwargs)
        return self._batched(launcher.launch_paths(self, order=order), -1)

    def compute_tx_mlm(
        self,
        *,
        num_rays: int = int(1e4),
        order: int = 2,
        min_order: int = 0,
        receiver_plane_z: float = 0.0,
        grid_bounds: torch.Tensor | None = None,
        grid_size: tuple[int, int] = (100, 100),
    ) -> torch.Tensor:
        """Multipath lifetime map per transmitter; see :func:`differt_tpu_torch.rt.compute_tx_mlm`."""
        from ..rt._mlm import compute_tx_mlm

        return compute_tx_mlm(
            self,
            num_rays=num_rays,
            order=order,
            min_order=min_order,
            receiver_plane_z=receiver_plane_z,
            grid_bounds=grid_bounds,
            grid_size=grid_size,
        )

    def plot(self, **kwargs):
        """Draw the mesh and markers at the transmitters and receivers, in one figure; ``kwargs`` go to every draw."""
        from ..plotting import draw_markers, draw_mesh, reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            draw_mesh(self.mesh)
            if self.num_transmitters:
                draw_markers(self.transmitters.reshape(-1, 3), labels=["tx"])
            if self.num_receivers:
                draw_markers(self.receivers.reshape(-1, 3), labels=["rx"])
        return output


class TriangleScene(Scene):
    """Deprecated alias of :class:`Scene`."""

    def __init__(self, *args, **kwargs) -> None:
        warnings.warn(
            "TriangleScene was renamed to Scene; this alias will be removed.",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(*args, **kwargs)
