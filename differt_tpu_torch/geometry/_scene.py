"""Scene container (PyTorch port of ``differt_tpu.geometry._scene``, subset)."""

import dataclasses
import math

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
    def num_receivers(self) -> int:
        return math.prod(self.receivers.shape[:-1])

    def with_receivers_grid(
        self, m: int = 50, n: int | None = 50, *, height: float = 1.5
    ) -> "Scene":
        """Place an ``n x m`` grid of receivers over the scene footprint."""
        return dataclasses.replace(self, receivers=self._grid(m, n, height=height))

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
        order: int | None = None,
        *,
        path_candidates: torch.Tensor | None = None,
        **solver_kwargs,
    ):
        """Trace exact specular paths between all TX/RX pairs (exhaustive solver).

        ``solver_kwargs`` configure the
        :class:`~differt_tpu_torch.rt.ExhaustivePathTracer` (tolerances,
        ``smoothing_factor``, ``megakernel``). Returns :class:`TracedPaths` of batch shape
        ``[*tx_batch, *rx_batch, num_candidates]``.
        """
        from ..rt._solvers import ExhaustivePathTracer

        if (order is None) == (path_candidates is None):
            msg = "trace_paths needs exactly one of 'order' and 'path_candidates'."
            raise ValueError(msg)
        tracer = ExhaustivePathTracer(**solver_kwargs)
        if path_candidates is not None:
            candidates = torch.as_tensor(path_candidates, device=self.mesh.device)
            if self.mesh.assume_quads:
                # Quad candidates address the even (first) triangle of a pair.
                candidates = candidates & ~1
            types = torch.zeros_like(candidates, dtype=torch.int32)
        else:
            candidates, types = tracer.generate_path_candidates(self, order)
        return self._batched(
            tracer.trace_path_candidates(self, candidates, types),
            candidates.shape[0],
        )

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
