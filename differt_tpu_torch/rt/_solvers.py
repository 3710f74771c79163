"""Exhaustive and hybrid specular path tracing, and SBR ray launching (port of ``differt_tpu.rt._solvers``).

Exhaustive tracing: candidates are decoded from the closed-form index
mapping; each batch of candidates goes through the image method, four
geometric checks and the blockage test. Hybrid tracing
(:class:`HybridPathTracer`) first estimates which primitives the
transmitters and the receivers see (``Mesh.triangles_visible_from_vertex``:
lattice rays through the closest-hit kernel on the card), keeps the
candidates that start on one the TX sees and end on one the RX sees (the
host DFS of :mod:`differt_tpu_torch.native`, or its chunked plain fallback)
and traces those as the exhaustive tracer does. On CUDA tensors with ``order >= 1``
and hard masks the whole pipeline runs in the fused trace kernel
(differentiable through its recompute backward); otherwise it runs
unfused, with its blockage test on the any-hit kernel (CUDA) or its plain
version (CPU). With a ``smoothing_factor`` every check becomes a sigmoid
confidence and the pipeline is plain PyTorch throughout.

Ray launching (:class:`SBRPathLauncher`): a Fibonacci lattice of rays per
transmitter, bounced ``order + 1`` times through the closest-hit kernel
(or its plain version), each segment captured by the receivers it passes
within ``sqrt(max_dist)`` of.
"""

import abc
import dataclasses
from collections.abc import Iterator, Sequence

import torch

from ..geometry._candidates import (
    SizedIterator,
    generate_all_path_candidates_chunks_iter,
    generate_filtered_path_candidates,
    generate_path_candidates,
)
from ..geometry._lattice import fibonacci_lattice, viewing_frustum
from ..geometry._mesh import Mesh
from ..geometry._paths import LaunchedPaths, TracedPaths, concatenate_paths
from ..geometry._vectors import _cross, _dot, assemble_path
from ..profiling import annotate
from ..utils import max_with_initial, min_with_initial, smoothing_function
from ._image_method import consecutive_vertices_are_on_same_side_of_mirror, image_method
from ._scan import smoothed_any_hit
from ._triangle import F32_EPS, ray_intersect_triangle


def candidate_geometry(
    mesh: Mesh, path_candidates: torch.Tensor, normals: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The mirrors of ``[C, order]`` candidates, as the trace kernel takes them.

    Returns the triangle indices ``[C, k * order]`` (each quad expanded to
    its two triangles, ``k = 2``; ``k = 1`` otherwise), their vertices
    ``[C, k * order, 3, 3]``, and each mirror's vertex and unit normal
    ``[C, order, 3]``, all contiguous. ``normals`` are the mesh's
    (:attr:`Mesh.normals`), where the caller holds them already.
    """
    num_candidates, order = path_candidates.shape
    k = 2 if mesh.assume_quads else 1
    if mesh.assume_quads:
        path_candidates = torch.repeat_interleave(path_candidates, 2, dim=-1)
        path_candidates[..., 1::2] += 1
    triangles = mesh.triangles[path_candidates].reshape(num_candidates, k * order, 3)
    triangle_vertices = mesh.vertices[triangles].reshape(num_candidates, k * order, 3, 3)
    mirror_vertices = triangle_vertices[..., ::k, 0, :].contiguous()
    mirror_normals = (mesh.normals if normals is None else normals)[path_candidates[..., ::k]].contiguous()
    return path_candidates, triangle_vertices, mirror_vertices, mirror_normals


def fused_trace(
    megakernel: bool | None, device: torch.device, order: int, num_candidates: int, smoothing_factor
) -> bool:
    """Whether a trace takes the fused kernel: ``megakernel``, or where it is None, whether the backend
    resolves to ``"cuda"``, the masks are hard, there are candidates and the order is 1 to the kernel's
    cap (``ops._trace.MAX_ORDER``; higher orders go to the unfused pipeline)."""
    if megakernel is not None:
        return megakernel
    from ..ops import get_backend
    from ..ops._trace import MAX_ORDER

    return (
        get_backend(device) == "cuda"
        and smoothing_factor is None
        and 1 <= order <= MAX_ORDER
        and num_candidates > 0
    )


def kernel_tolerances(
    epsilon: float | None = None, hit_tol: float | None = None, min_len: float | None = None
) -> tuple[float, float, float]:
    """The fused trace kernel's ``epsilon``, ``hit_tol`` and ``min_len``, with their defaults."""
    return (
        10.0 * F32_EPS if epsilon is None else float(epsilon),
        100.0 * F32_EPS if hit_tol is None else float(hit_tol),
        10.0 * F32_EPS if min_len is None else float(min_len),
    )


def trace_path_candidates(
    mesh: Mesh,
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    path_candidates: torch.Tensor,
    interaction_types: torch.Tensor | None = None,
    *,
    epsilon: float | None = None,
    hit_tol: float | None = None,
    min_len: float | None = None,
    smoothing_factor: float | torch.Tensor | None = None,
    confidence_threshold: float | torch.Tensor = 0.5,
    batch_size: int | None = 512,
    megakernel: bool | None = None,
) -> TracedPaths:
    """Trace and validate exact specular paths for a batch of candidates.

    ``tx_vertices [Ntx, 3]``, ``rx_vertices [Nrx, 3]``, ``path_candidates
    [C, order]`` primitive indices. Returns paths of batch shape
    ``[Ntx, Nrx, C]``. ``megakernel=None`` picks the fused trace kernel when
    the backend resolves to ``"cuda"`` (by default: CUDA tensors), the
    order is 1 to the kernel's cap (``ops._trace.MAX_ORDER``) and the masks
    are hard; ``False`` forces the unfused pipeline; ``True`` forces the
    fused kernel's contract (its plain version on CPU), and raises above
    the cap.

    With a ``smoothing_factor`` each of the five checks is a sigmoid
    confidence and the mask their minimum, a float held against
    ``confidence_threshold``: gradients then flow through whether a path
    exists. The smoothed blockage sums every triangle's confidence
    (``batch_size`` triangles at a time) but each segment's own mirrors: a
    sigmoid in ``t`` cannot resolve the ``hit_tol`` offset that keeps the
    hard test off them, and would count them as half-blockers.
    """
    full_paths, mask, expanded, k = trace_geometry(
        mesh,
        tx_vertices,
        rx_vertices,
        path_candidates,
        epsilon=epsilon,
        hit_tol=hit_tol,
        min_len=min_len,
        smoothing_factor=smoothing_factor,
        batch_size=batch_size,
        megakernel=megakernel,
    )
    return _assemble_traced_paths(
        full_paths, mask, expanded, interaction_types, k,
        tx_vertices.shape[0], rx_vertices.shape[0], *path_candidates.shape, confidence_threshold,
    )


def trace_geometry(
    mesh: Mesh,
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    path_candidates: torch.Tensor,
    *,
    epsilon: float | None = None,
    hit_tol: float | None = None,
    min_len: float | None = None,
    smoothing_factor: float | torch.Tensor | None = None,
    batch_size: int | None = 512,
    megakernel: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """:func:`trace_path_candidates` before its objects and types are attached.

    Returns the paths' vertices ``[Ntx, Nrx, C, order + 2, 3]``, their mask
    ``[Ntx, Nrx, C]``, the candidates' triangles and ``k`` as
    :func:`candidate_geometry` gives them. A caller that needs no
    ``TracedPaths`` (a coverage tile summed by ``csrc/em.cu``) is spared the
    expanded ``[Ntx, Nrx, C, order + 2]`` objects.
    """
    if min_len is None:
        min_len = 10.0 * F32_EPS
    smooth = smoothing_factor is not None

    num_candidates, order = path_candidates.shape
    path_candidates, triangle_vertices, mirror_vertices, mirror_normals = (
        candidate_geometry(mesh, path_candidates)
    )
    k = 2 if mesh.assume_quads else 1
    active_rays = None
    if mesh.mask is not None:
        active_rays = mesh.mask[path_candidates].all(dim=-1)

    if fused_trace(megakernel, tx_vertices.device, order, num_candidates, smoothing_factor):
        if order < 1:
            msg = "The fused trace kernel needs order >= 1."
            raise ValueError(msg)
        if smooth:
            msg = "The fused trace kernel has hard masks only: drop 'smoothing_factor' or 'megakernel'."
            raise ValueError(msg)
        from ..ops._trace import trace_specular_cuda

        # On the card the kernel reads the mesh's cached BVH; on the CPU the
        # plain version reads the triangles.
        on_card = tx_vertices.device.type == "cuda"
        kernel_epsilon, kernel_hit_tol, kernel_min_len = kernel_tolerances(epsilon, hit_tol, min_len)
        vertices, mask = trace_specular_cuda(
            tx_vertices.contiguous(),
            rx_vertices.contiguous(),
            mirror_vertices,
            mirror_normals,
            triangle_vertices,
            None if on_card else mesh.triangle_vertices.contiguous(),
            mesh.mask,
            order=order,
            epsilon=kernel_epsilon,
            hit_tol=kernel_hit_tol,
            min_len=kernel_min_len,
            bvh=mesh.bvh if on_card else None,
        )
        # [tx, cand, rx, ...] -> [tx, rx, cand, ...]
        full_paths = vertices.transpose(1, 2)
        mask = mask.transpose(1, 2)
        if active_rays is not None:
            mask = mask & active_rays
        return full_paths, mask, path_candidates, k

    if smooth:
        full_paths, ray_origins, ray_directions, checks = _geometric_checks(
            tx_vertices,
            rx_vertices,
            triangle_vertices,
            mirror_vertices,
            mirror_normals,
            k,
            epsilon=epsilon,
            min_len=min_len,
            smoothing_factor=smoothing_factor,
        )
        inside, valid_reflections, too_small, is_finite = checks
        # Check 3, smoothed, without each segment's own mirrors. The mask
        # of a triangle tile is made inside the scan: [C, order + 1, tile],
        # never [C, order + 1, T].
        endpoint_ids = _segment_endpoint_ids(path_candidates, order, k)
        mesh_tv = mesh.triangle_vertices
        if hit_tol is None:
            hit_tol = 100.0 * F32_EPS

        def active_tile(lo: int, hi: int) -> torch.Tensor:
            active = ~own_mirror_tile(endpoint_ids, lo, hi)
            return active if mesh.mask is None else active & mesh.mask[lo:hi]

        blocked = smoothed_any_hit(
            ray_origins,
            ray_directions,
            mesh_tv,
            active_tile,
            1.0 - torch.as_tensor(hit_tol, dtype=mesh_tv.dtype, device=mesh_tv.device),
            smoothing_factor=smoothing_factor,
            epsilon=epsilon,
            tile=batch_size,
        )
        blocked = max_with_initial(blocked, -1, 0.0)
        mask = min_with_initial(
            torch.stack(
                (
                    inside,
                    valid_reflections,
                    1.0 - blocked,
                    1.0 - too_small,
                    is_finite.to(inside.dtype),
                ),
                dim=-1,
            ),
            -1,
            1.0,
        )
        if active_rays is not None:
            mask = mask * active_rays
        return full_paths, mask, path_candidates, k

    full_paths, ray_origins, ray_directions, alive = unfused_blockage_inputs(
        tx_vertices,
        rx_vertices,
        triangle_vertices,
        mirror_vertices,
        mirror_normals,
        k,
        epsilon=epsilon,
        min_len=min_len,
    )
    # Check 3, last on purpose: only the paths that survived the cheap
    # checks take the blockage test (the others are inactive rays). As in
    # the reference, the blockage test keeps its default epsilon.
    blocked = mesh.ray_intersect_any_triangle(
        ray_origins,
        ray_directions,
        hit_tol=hit_tol,
        active_rays=alive[..., None],
    ).any(dim=-1)

    mask = alive & ~blocked
    if active_rays is not None:
        mask = mask & active_rays
    return full_paths, mask, path_candidates, k


def _segment_endpoint_ids(path_candidates: torch.Tensor, order: int, k: int) -> torch.Tensor:
    """The triangles each segment starts and ends on, ``[C, order + 1, 2 * k]`` (-1: none).

    ``path_candidates [C, k * order]`` holds the ``k`` triangles of each
    mirror (:func:`candidate_geometry`); segment ``s`` leaves mirror
    ``s - 1`` and reaches mirror ``s``, the TX and the RX being no triangle.
    """
    pc = path_candidates.reshape(path_candidates.shape[0], order, k)
    none = torch.full((pc.shape[0], 1, k), -1, dtype=pc.dtype, device=pc.device)
    seg_start = torch.cat((none, pc), dim=1)
    seg_end = torch.cat((pc, none), dim=1)
    return torch.cat((seg_start, seg_end), dim=-1)


def own_mirror_tile(endpoint_ids: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``[C, order + 1, hi - lo]``: whether triangle ``lo + j`` is a mirror of segment ``s``'s ends."""
    tri_ids = torch.arange(lo, hi, dtype=endpoint_ids.dtype, device=endpoint_ids.device)
    return (endpoint_ids[..., None] == tri_ids).any(dim=-2)


def unfused_blockage_inputs(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    triangle_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
    k: int,
    *,
    epsilon: float | None,
    min_len: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused pipeline up to its blockage test: the image method and four checks.

    Takes ``[Ntx, 3]`` and ``[Nrx, 3]`` vertices and the candidates' mirrors
    as :func:`candidate_geometry` gives them (``k`` triangles a mirror).
    Returns the paths ``[Ntx, Nrx, C, order + 2, 3]`` (impossible ones
    zeroed), their segments' origins and directions ``[Ntx, Nrx, C, order
    + 1, 3]`` and ``alive`` ``[Ntx, Nrx, C]``: the paths that passed the
    checks, whose segments take the blockage test.
    """
    full_paths, ray_origins, ray_directions, checks = _geometric_checks(
        tx_vertices,
        rx_vertices,
        triangle_vertices,
        mirror_vertices,
        mirror_normals,
        k,
        epsilon=epsilon,
        min_len=min_len,
    )
    inside, valid_reflections, too_small, is_finite = checks
    alive = inside & valid_reflections & ~too_small & is_finite
    return full_paths, ray_origins, ray_directions, alive


def _geometric_checks(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    triangle_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
    k: int,
    *,
    epsilon: float | None,
    min_len: float,
    smoothing_factor: float | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...]]:
    """The image method and checks 1, 2, 4 and 5, hard or smoothed.

    Returns the paths (impossible ones zeroed), their segments' origins and
    directions, and ``(inside, valid_reflections, too_small, is_finite)``,
    each ``[Ntx, Nrx, C]``: bool, or with a ``smoothing_factor`` float
    confidences (``is_finite`` stays bool).

    The smoothed reductions are ``amin``/``amax``, which split the gradient
    evenly among ties as ``jnp.min``/``jnp.max`` do: on a symmetric scene
    the confidences tie exactly.
    """
    num_tx, num_rx = tx_vertices.shape[0], rx_vertices.shape[0]
    num_candidates, order = mirror_vertices.shape[:2]
    smooth = smoothing_factor is not None
    paths = image_method(
        tx_vertices[:, None, None, :],
        rx_vertices[None, :, None, :],
        mirror_vertices,
        mirror_normals,
    )
    full_paths = assemble_path(
        tx_vertices[:, None, None, :], paths, rx_vertices[None, :, None, :]
    )
    ray_origins = full_paths[..., :-1, :]
    ray_directions = full_paths[..., 1:, :] - full_paths[..., :-1, :]

    # Check 1: reflection points lie inside their triangles (or either
    # triangle of the quad).
    hits = ray_intersect_triangle(
        torch.repeat_interleave(ray_origins[..., :-1, :], k, dim=-2),
        torch.repeat_interleave(ray_directions[..., :-1, :], k, dim=-2),
        triangle_vertices,
        epsilon=epsilon,
        smoothing_factor=smoothing_factor,
    )[1].reshape(num_tx, num_rx, num_candidates, order, k)
    if smooth:
        inside = min_with_initial(max_with_initial(hits, -1, 0.0), -1, 1.0)
    else:
        inside = hits.any(dim=-1).all(dim=-1)

    # Check 2: consecutive vertices on the same side of each mirror.
    same_side = consecutive_vertices_are_on_same_side_of_mirror(
        full_paths, mirror_vertices, mirror_normals, smoothing_factor=smoothing_factor
    )
    valid_reflections = min_with_initial(same_side, -1, 1.0) if smooth else same_side.all(dim=-1)

    # Check 4: no degenerate (too short) segment.
    seg_sq = _dot(ray_directions, ray_directions)
    if smooth:
        too_small = max_with_initial(
            smoothing_function(min_len - seg_sq, smoothing_factor), -1, 0.0
        )
    else:
        too_small = (seg_sq < min_len).any(dim=-1)

    # Check 5: finiteness (the image method emits inf for impossible paths).
    is_finite = torch.isfinite(full_paths).all(dim=-1).all(dim=-1)
    full_paths = torch.where(is_finite[..., None, None], full_paths, 0.0)
    return full_paths, ray_origins, ray_directions, (inside, valid_reflections, too_small, is_finite)


def _assemble_traced_paths(
    full_paths: torch.Tensor,
    mask: torch.Tensor,
    path_candidates: torch.Tensor,
    interaction_types: torch.Tensor | None,
    k: int,
    num_tx: int,
    num_rx: int,
    num_candidates: int,
    order: int,
    confidence_threshold: float | torch.Tensor = 0.5,
) -> TracedPaths:
    """Attach object indices and interaction types to traced geometry."""
    device = path_candidates.device
    dtype = path_candidates.dtype
    shape = (num_tx, num_rx, num_candidates)
    rows, types = candidate_rows(path_candidates, interaction_types, k)
    tx_objects = torch.arange(num_tx, dtype=dtype, device=device)[:, None, None, None]
    rx_objects = torch.arange(num_rx, dtype=dtype, device=device)[None, :, None, None]
    objects = torch.cat(
        (
            tx_objects.expand(*shape, 1),
            rows.expand(*shape, order),
            rx_objects.expand(*shape, 1),
        ),
        dim=-1,
    )
    return TracedPaths(
        full_paths,
        objects,
        mask=mask,
        interaction_types=types.expand(*shape, order),
        confidence_threshold=confidence_threshold,
    )


def candidate_rows(
    path_candidates: torch.Tensor, interaction_types: torch.Tensor | None, k: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each candidate's object and interaction type per bounce, ``[C, order]`` each.

    What a traced path's ``objects`` (between its TX and its RX) and its
    ``interaction_types`` hold, before they are expanded over the TX and
    the RX. ``path_candidates`` takes ``k`` triangles a mirror (2 for quads,
    as :func:`candidate_geometry` expands them); no types means reflections.
    """
    rows = path_candidates[:, ::k]
    if interaction_types is None:
        return rows, torch.zeros(rows.shape, dtype=torch.int32, device=rows.device)
    return rows, interaction_types


class AbstractPathSolver(abc.ABC):
    """Base class of the path tracers and launchers."""

    epsilon: float | None
    """Tolerance of the ray-object intersection tests (None: ``10 * eps(float32)``)."""
    hit_tol: float | None
    """Tolerance of the blockage test on path segments (None: ``100 * eps(float32)``)."""


class AbstractPathTracer(AbstractPathSolver):
    """Base class of the exact path tracers (candidates, then traced paths).

    Subclasses give :meth:`generate_path_candidates` and
    :meth:`trace_path_candidates`; both take an order or, for several
    orders, a sequence of orders (then a tuple per order).
    """

    @abc.abstractmethod
    def generate_path_candidates(self, scene, order: int | Sequence[int]):
        """``(path_candidates, interaction_types)``, each ``[C, order]`` (tuples of them for a sequence of orders)."""

    @abc.abstractmethod
    def trace_path_candidates(self, scene, path_candidates, interaction_types) -> TracedPaths:
        """The traced paths ``[num_tx, num_rx, C]`` of the candidates."""

    def generate_path_candidates_chunks_iter(
        self, scene, order: int | Sequence[int], *, chunk_size: int, pad_chunks: bool = False
    ) -> SizedIterator:
        """The candidates of :meth:`generate_path_candidates`, ``chunk_size`` rows at a time.

        With ``pad_chunks`` the last chunk is padded to ``chunk_size`` with -1.
        """
        candidates, interactions = self.generate_path_candidates(scene, order)
        num = candidates.shape[-2]
        num_chunks, rem = divmod(num, chunk_size)

        def gen() -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
            for i in range(num_chunks):
                sl = slice(i * chunk_size, (i + 1) * chunk_size)
                yield candidates[..., sl, :], interactions[..., sl, :]
            if rem:
                tail = (candidates[..., num - rem :, :], interactions[..., num - rem :, :])
                if pad_chunks:
                    pad = chunk_size - rem
                    tail = tuple(
                        torch.nn.functional.pad(x, (0, 0, 0, pad), value=-1) for x in tail
                    )
                yield tail

        return SizedIterator(gen(), size=num_chunks + (1 if rem else 0))

    def trace_paths(
        self,
        scene,
        order: int | Sequence[int],
        chunk_size: int | None = None,
        pad_chunks: bool = False,
    ):
        """Trace the paths of ``order``: one :class:`TracedPaths`, or an iterator of them.

        A sequence of orders gives a :class:`SizedIterator` of one
        :class:`TracedPaths` per order (an iterator of one per chunk, with
        ``chunk_size``); ``chunk_size`` alone gives a :class:`SizedIterator`
        of one per chunk.
        """
        if isinstance(order, Sequence):
            orders = list(order)

            def gen() -> Iterator[TracedPaths]:
                for o in orders:
                    result = self.trace_paths(scene, o, chunk_size=chunk_size, pad_chunks=pad_chunks)
                    if isinstance(result, TracedPaths):
                        yield result
                    else:
                        yield from result

            return SizedIterator(gen(), size=len(orders)) if chunk_size is None else gen()
        if chunk_size is not None:
            chunks = self.generate_path_candidates_chunks_iter(
                scene, order, chunk_size=chunk_size, pad_chunks=pad_chunks
            )
            return SizedIterator(
                (self.trace_path_candidates(scene, cands, types) for cands, types in chunks),
                size=len(chunks),
            )
        candidates, interactions = self.generate_path_candidates(scene, order)
        return self.trace_path_candidates(scene, candidates, interactions)


@dataclasses.dataclass(frozen=True)
class _TracerOptions(AbstractPathTracer):
    """The options both tracers pass to :func:`trace_path_candidates`, and the tracing of candidates."""

    epsilon: float | None = None
    """Tolerance for ray / object intersection checks."""
    hit_tol: float | None = None
    """Hit-distance tolerance when testing path segments for blockage."""
    min_len: float | None = None
    """Minimal (squared) segment length for a valid path."""
    smoothing_factor: float | torch.Tensor | None = None
    """Slope of the sigmoids that replace the hard checks (None: hard checks)."""
    confidence_threshold: float | torch.Tensor = 0.5
    """Confidence from which a path with a smoothed mask counts as valid."""
    batch_size: int | None = 512
    """Triangle tile of the smoothed blockage sum."""
    chunk_size: int | None = None
    """Candidates per chunk of ``Scene.trace_paths`` (None: all at once)."""
    megakernel: bool | None = None
    """Force the fused trace kernel on or off (None: on for the "cuda" backend, orders 1 to ``ops._trace.MAX_ORDER``, hard checks)."""

    def trace_path_candidates(self, scene, path_candidates, interaction_types) -> TracedPaths:
        """Trace ``[C, order]`` candidates (or a tuple of them, one per order, merged by :func:`concatenate_paths`)."""
        if isinstance(path_candidates, tuple):
            return concatenate_paths([
                self.trace_path_candidates(scene, c, t)
                for c, t in zip(path_candidates, interaction_types, strict=True)
            ])
        return trace_path_candidates(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            path_candidates,
            interaction_types=interaction_types,
            epsilon=self.epsilon,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
            smoothing_factor=self.smoothing_factor,
            confidence_threshold=self.confidence_threshold,
            batch_size=self.batch_size,
            megakernel=self.megakernel,
        )


def _quad_mask(mesh) -> torch.Tensor | None:
    """The mesh's active mask per primitive (a quad is active when both its triangles are)."""
    if mesh.mask is None or not mesh.assume_quads:
        return mesh.mask
    return mesh.mask[0::2] & mesh.mask[1::2]


@dataclasses.dataclass(frozen=True)
class ExhaustivePathTracer(_TracerOptions):
    """Exhaustive image-method tracer over all candidates, with hard or smoothed checks."""

    disconnect_inactive_triangles: bool = False
    """Drop the candidates that touch a masked-out primitive before tracing."""

    def generate_path_candidates(self, scene, order: int | Sequence[int]):
        """All ``[C, order]`` candidates of the scene's mesh and their (zero) types; a tuple of each for several orders."""
        if isinstance(order, Sequence):
            per_order = [self.generate_path_candidates(scene, o) for o in order]
            return tuple(c for c, _ in per_order), tuple(t for _, t in per_order)
        mesh = scene.mesh
        if self.disconnect_inactive_triangles and mesh.mask is not None and order > 0:
            mask = _quad_mask(mesh)
            candidates = generate_filtered_path_candidates(
                mesh.num_primitives, order, lambda chunk: mask[chunk].all(dim=-1), device=mesh.device
            )
        else:
            candidates = generate_path_candidates(mesh.num_primitives, order, device=mesh.device)
        if mesh.assume_quads:
            candidates = 2 * candidates
        return candidates, torch.zeros_like(candidates, dtype=torch.int32)

    def generate_path_candidates_chunks_iter(
        self,
        scene,
        order: int | Sequence[int],
        *,
        chunk_size: int | None = None,
        pad_chunks: bool = False,
    ) -> SizedIterator:
        """The candidates ``chunk_size`` (or :attr:`chunk_size`) at a time, each chunk decoded on the mesh's device."""
        effective = chunk_size or self.chunk_size
        if effective is None:
            return SizedIterator(iter([self.generate_path_candidates(scene, order)]), size=1)
        if isinstance(order, Sequence):
            iters = [
                self.generate_path_candidates_chunks_iter(
                    scene, o, chunk_size=effective, pad_chunks=pad_chunks
                )
                for o in order
            ]
            return SizedIterator(
                (chunk for it in iters for chunk in it), size=sum(len(it) for it in iters)
            )
        mesh = scene.mesh
        chunks = generate_all_path_candidates_chunks_iter(
            mesh.num_primitives, order, effective, device=mesh.device
        )

        def gen() -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
            for chunk in chunks:
                if pad_chunks and chunk.shape[0] < effective:
                    chunk = torch.nn.functional.pad(chunk, (0, 0, 0, effective - chunk.shape[0]), value=-1)
                if mesh.assume_quads:
                    chunk = 2 * chunk
                yield chunk, torch.zeros_like(chunk, dtype=torch.int32)

        return SizedIterator(gen(), size=len(chunks))


@dataclasses.dataclass(frozen=True)
class HybridPathTracer(_TracerOptions):
    """Visibility pruning, then exact tracing of the candidates that survive.

    A candidate survives when the transmitters see its first primitive,
    the receivers its last, and every primitive is active. Visibility is
    estimated with ``num_rays`` lattice rays per vertex
    (``Mesh.triangles_visible_from_vertex``); the survivors are enumerated
    by the host DFS of :mod:`differt_tpu_torch.native`, or by its chunked
    plain fallback where the DFS cannot be built. Pruning is hard: a
    ``smoothing_factor`` smooths the trace only.
    """

    num_rays: int = int(1e6)
    """Visibility rays launched from each transmitter and each receiver."""

    def _visibility(self, scene) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
        """``[num_primitives]`` masks: seen from a TX, seen from an RX, active (or None)."""
        with annotate("visibility"):
            mesh = scene.mesh
            visible_tx = mesh.triangles_visible_from_vertex(
                scene.transmitters.reshape(-1, 3), num_rays=self.num_rays
            ).any(dim=0)
            visible_rx = mesh.triangles_visible_from_vertex(
                scene.receivers.reshape(-1, 3), num_rays=self.num_rays
            ).any(dim=0)
            if mesh.assume_quads:
                visible_tx = visible_tx.reshape(-1, 2).any(dim=-1)
                visible_rx = visible_rx.reshape(-1, 2).any(dim=-1)
            return visible_tx, visible_rx, _quad_mask(mesh)

    def generate_path_candidates(self, scene, order: int | Sequence[int]):
        """The ``[C, order]`` candidates that survive the visibility pruning, and their (zero) types."""
        if isinstance(order, Sequence):
            per_order = [self.generate_path_candidates(scene, o) for o in order]
            return tuple(c for c, _ in per_order), tuple(t for _, t in per_order)
        from .. import native

        mesh = scene.mesh
        visible_tx, visible_rx, mask = self._visibility(scene)
        if order > 0:
            enumerate_ = (
                native.filtered_path_candidates
                if native.is_available()
                else native.filtered_path_candidates_chunked
            )
            candidates = enumerate_(
                mesh.num_primitives, order, visible_tx, visible_rx, mask, device=mesh.device
            )
        else:
            candidates = generate_path_candidates(mesh.num_primitives, order, device=mesh.device)
        if mesh.assume_quads:
            candidates = 2 * candidates
        return candidates, torch.zeros_like(candidates, dtype=torch.int32)


class AbstractPathLauncher(AbstractPathSolver):
    """Base class of the ray-launching solvers.

    Subclasses are frozen dataclasses with a ``max_dist`` field (the
    largest squared ray-to-receiver distance of a capture) and a
    :meth:`launch_rays`.
    """

    max_dist: float

    @abc.abstractmethod
    def launch_rays(self, scene) -> tuple[torch.Tensor, torch.Tensor]:
        """Initial ray origins and directions, ``[num_tx, num_rays, 3]`` each."""

    def bounce_rays(
        self,
        scene,
        ray_origins: torch.Tensor,
        ray_directions: torch.Tensor,
        triangles: torch.Tensor,
        t_hit: torch.Tensor,
        valid_rays: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Advance rays to their hits and reflect them specularly.

        A ray that hit nothing stays where it was and becomes invalid; its
        reflection reads the normal of index -1 (the last triangle), as in
        the JAX package.
        """
        inside = torch.isfinite(t_hit)
        valid_rays = valid_rays & inside
        t_hit = torch.where(inside, t_hit, 0.0)
        ray_origins = ray_origins + t_hit[..., None] * ray_directions
        normals = scene.mesh.normals[triangles]
        ray_directions = ray_directions - 2.0 * _dot(ray_directions, normals)[..., None] * normals
        return ray_origins, ray_directions, valid_rays

    def filter_rays(
        self,
        scene,
        ray_origins: torch.Tensor,
        ray_directions: torch.Tensor,
        rx_vertices: torch.Tensor,
        t_hit: torch.Tensor,
        valid_rays: torch.Tensor,
    ) -> torch.Tensor:
        """``[num_tx, num_rx, num_rays]``: rays passing within ``sqrt(max_dist)`` of each RX."""
        del scene
        directions = ray_directions[:, None, ...]
        to_rx = rx_vertices[None, :, None, :] - ray_origins[:, None, ...]
        off_axis = _cross(directions, to_rx)
        dist_sq = _dot(off_axis, off_axis)
        t_rx = _dot(directions, to_rx)
        ahead = (t_rx > 0) & (t_rx < t_hit[:, None, :]) & valid_rays[:, None, :]
        return ahead & (dist_sq < self.max_dist)

    def launch_paths(self, scene, order: int) -> LaunchedPaths:
        """Launch, bounce ``order + 1`` times, capture and assemble ray paths.

        Returns :class:`LaunchedPaths` of batch shape ``[num_tx, num_rx,
        num_rays]`` with one mask per order 0 ... ``order``.
        """
        tx_vertices = scene.transmitters.reshape(-1, 3)
        rx_vertices = scene.receivers.reshape(-1, 3)
        num_tx, num_rx = tx_vertices.shape[0], rx_vertices.shape[0]

        origins, directions = self.launch_rays(scene)
        num_rays = origins.shape[1]
        valid = torch.ones(origins.shape[:-1], dtype=torch.bool, device=origins.device)
        hit_triangles, hit_points, masks = [], [], []
        for _ in range(order + 1):
            triangles, t_hit = scene.mesh.first_triangle_hit_by_ray(origins, directions)
            masks.append(self.filter_rays(scene, origins, directions, rx_vertices, t_hit, valid))
            origins, directions, valid = self.bounce_rays(
                scene, origins, directions, triangles, t_hit, valid
            )
            hit_triangles.append(triangles)
            hit_points.append(origins)

        # The last bounce leads nowhere: only the first `order` hits are vertices.
        path_candidates = torch.stack(hit_triangles, dim=-1)[..., :order]
        vertices = torch.stack(hit_points, dim=-2)[..., :order, :]
        vertices = assemble_path(
            tx_vertices[:, None, None, :],
            vertices[:, None, ...],
            rx_vertices[None, :, None, :],
        )
        shape = (num_tx, num_rx, num_rays)
        dtype, device = path_candidates.dtype, path_candidates.device
        objects = torch.cat(
            (
                torch.arange(num_tx, dtype=dtype, device=device)[:, None, None, None].expand(
                    *shape, 1
                ),
                path_candidates[:, None, ...].expand(*shape, order),
                torch.arange(num_rx, dtype=dtype, device=device)[None, :, None, None].expand(
                    *shape, 1
                ),
            ),
            dim=-1,
        )
        return LaunchedPaths(
            vertices=vertices,
            objects=objects,
            masks=torch.stack(masks, dim=-1),
            interaction_types=torch.zeros((*shape, order), dtype=torch.int32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class SBRPathLauncher(AbstractPathLauncher):
    """Shooting-and-bouncing-rays launcher: a Fibonacci lattice over each TX's frustum."""

    num_rays: int = int(1e6)
    """Number of rays launched from each transmitter."""
    epsilon: float | None = None
    """Tolerance for ray / object intersection checks (kept for the solver interface)."""
    hit_tol: float | None = None
    """Hit-distance tolerance for blockage tests (kept for the solver interface)."""
    max_dist: float = 1e-3
    """Largest squared ray-to-receiver distance of a capture."""

    def launch_rays(self, scene) -> tuple[torch.Tensor, torch.Tensor]:
        """Rays from each TX over the frustum of the mesh's vertices and the receivers."""
        tx_vertices = scene.transmitters.reshape(-1, 3)
        rx_vertices = scene.receivers.reshape(-1, 3)
        world_vertices = torch.cat(
            (scene.mesh.triangle_vertices.reshape(-1, 3), rx_vertices), dim=0
        )
        frustums = viewing_frustum(tx_vertices, world_vertices)
        ray_origins = tx_vertices[:, None, :].expand(-1, self.num_rays, 3)
        ray_directions = torch.stack(
            [fibonacci_lattice(self.num_rays, frustum=f) for f in frustums]
        )
        return ray_origins, ray_directions


_SOLVER_REGISTRY = {
    "exhaustive": ExhaustivePathTracer,
    "hybrid": HybridPathTracer,
    "sbr": SBRPathLauncher,
}
"""The solvers' shortcut names."""
