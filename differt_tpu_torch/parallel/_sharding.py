"""Device meshes on ``torch.distributed`` and gradient steps on coverage maps (PyTorch port of ``differt_tpu.parallel._sharding``).

A mesh (:class:`DeviceMesh`) is one axis of ranks of a process group. The
scene is replicated on every rank (:func:`replicate`, a broadcast from the
mesh's first rank); the receiver or candidate axis is split into one
contiguous block a rank (:func:`shard_along`); each rank traces its block,
and the results are gathered so that every rank holds them whole, as a
global ``jax.Array`` reads whole. Gradients follow JAX's semantics for
replicated inputs: a tensor that went through :func:`replicate` gets the
whole gradient on every rank (the backward of the broadcast is a sum over
the ranks, the backward of the gather this rank's slice).

:func:`training_step` and :func:`placement_training_step` differentiate a
coverage map held whole; :func:`streamed_placement_step` streams the same
loss and its gradient through fixed-size (RX tile, candidate chunk)
buffers, so that a city-scale grid fits one card. With ``mesh=None`` each
runs on one device with no collective.
"""

import dataclasses
import socket
from collections.abc import Sequence

import torch
import torch.distributed as dist

from ..coverage import _coverage_tile, _TileWalk, received_power, resolve_materials
from ..em import z_0
from ..geometry import Scene, TracedPaths, generate_path_candidates
from ..profiling import annotate
from ..rt._solvers import trace_path_candidates as _trace_path_candidates
from ..treekit import tree_leaves, tree_rebuild

_POWER_FLOOR = 1e-30
"""Floor of the power under the logarithm: pixels below it sit at -300 dB and pass no gradient."""


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh: the first :attr:`size` ranks of the default process group, one block each.

    ``group`` is the process group the collectives run on (None: the whole
    default group), ``rank`` this process's index in it, ``device`` where
    its tensors live.
    """

    group: dist.ProcessGroup | None
    axis_name: str
    size: int
    rank: int
    device: torch.device

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis_name,)

    @property
    def source(self) -> int:
        """The global rank of the mesh's first rank, the source of :func:`replicate`'s broadcast."""
        return 0 if self.group is None else dist.get_global_rank(self.group, 0)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def make_device_mesh(
    num_devices: int | None = None,
    axis_name: str = "rx",
    device: torch.device | str | None = None,
) -> DeviceMesh:
    """A 1-D mesh over the first ``num_devices`` ranks of the default process group.

    The caller initializes the group, as ``torchrun`` does. Without one, and
    with ``num_devices`` None or 1, a group of one rank is made here: NCCL
    for a CUDA ``device``, gloo for the CPU. ``device=None`` is the current
    CUDA device. A mesh smaller than the group makes a new group, so every
    rank of the default group calls this; a rank outside the mesh gets a
    mesh it cannot run on.

    >>> import torch.distributed as dist
    >>> from differt_tpu_torch.parallel import make_device_mesh
    >>> mesh = make_device_mesh(1, device="cpu")
    >>> mesh.axis_names, mesh.size, mesh.rank
    (('rx',), 1, 0)
    >>> dist.destroy_process_group()
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            msg = f"A mesh of {num_devices} ranks needs the default process group initialized first."
            raise ValueError(msg)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://localhost:{_free_port()}",
            world_size=1,
            rank=0,
            **({"device_id": device} if device.type == "cuda" else {}),
        )
    world = dist.get_world_size()
    size = world if num_devices is None else num_devices
    if not 1 <= size <= world:
        msg = f"A mesh of {size} ranks does not fit a process group of {world}."
        raise ValueError(msg)
    group = None if size == world else dist.new_group(list(range(size)))
    rank = dist.get_rank()
    return DeviceMesh(group, axis_name, size, rank if rank < size else -1, device)


def _member(mesh: DeviceMesh) -> None:
    if mesh.rank < 0:
        msg = f"Rank {dist.get_rank()} is not in the mesh of the first {mesh.size} ranks."
        raise ValueError(msg)


def _block(n: int, mesh: DeviceMesh, axis: int) -> tuple[int, int]:
    if n % mesh.size:
        msg = (
            f"Axis {axis} of length {n} does not split into {mesh.size} equal blocks:"
            " pad it to a multiple of the mesh size first."
        )
        raise ValueError(msg)
    width = n // mesh.size
    return mesh.rank * width, width


def shard_along(x: torch.Tensor, mesh: DeviceMesh, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``axis``, on the mesh's device.

    The axis must split evenly (as JAX's ``NamedSharding`` asks): callers
    pad first.
    """
    _member(mesh)
    x = torch.as_tensor(x)
    start, width = _block(x.shape[axis], mesh, axis)
    return x.narrow(axis, start, width).to(mesh.device)


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor every backend's collectives take: booleans as ``uint8``, complex as (re, im) pairs."""
    if x.dtype == torch.bool:
        return x.to(torch.uint8)
    if x.is_complex():
        return torch.view_as_real(x)
    return x


def _from_wire(wire: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        return wire.to(torch.bool)
    if like.is_complex():
        return torch.view_as_complex(wire)
    return wire


def _broadcast(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (the source's own tensor, moved to the device, on the source)."""
    x = x.to(mesh.device)
    wire = _to_wire(x if mesh.rank == 0 else torch.empty_like(x))
    dist.broadcast(wire.contiguous() if mesh.rank == 0 else wire, mesh.source, group=mesh.group)
    return x if mesh.rank == 0 else _from_wire(wire, x)


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    wire = _to_wire(x).contiguous()
    dist.all_reduce(wire, group=mesh.group)
    return _from_wire(wire, x)


class _Replicate(torch.autograd.Function):
    """Forward: rank 0's tensors on every rank. Backward: the sum of every rank's gradient."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        ctx.shapes = [(x.shape, x.dtype) for x in xs]
        return tuple(_broadcast(x, mesh).clone() for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        # Every rank whose backward reaches any output runs this once, the
        # tensors in the same order: an unused output's gradient is zeros.
        out = []
        for needed, grad, (shape, dtype) in zip(ctx.needs_input_grad[1:], grads, ctx.shapes, strict=True):
            if not needed:
                out.append(None)
                continue
            if grad is None:
                grad = torch.zeros(shape, dtype=dtype, device=ctx.mesh.device)
            out.append(_all_reduce(grad, ctx.mesh))
        return None, *out


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` (tensors, the port's dataclasses, tuples, lists, dicts) as rank 0 holds it, on the mesh's device.

    A tensor that requires a gradient goes through one autograd Function
    whose backward sums the gradient over the ranks: each rank's gradient of
    a loss that every rank computes alike from gathered results is then the
    whole gradient. Other tensors are broadcast plainly; on rank 0 they are
    the caller's own (moved to the device), so a :class:`Mesh
    <differt_tpu_torch.geometry.Mesh>` there keeps its cached BVH.
    """
    _member(mesh)
    tensors = tree_leaves(tree, _is_tensor)
    grads = [i for i, x in enumerate(tensors) if x.requires_grad]
    out = [x if x.requires_grad else _broadcast(x, mesh) for x in tensors]
    if grads:
        with_grad = _Replicate.apply(mesh, *(tensors[i] for i in grads))
        for i, x in zip(grads, with_grad, strict=True):
            out[i] = x
    return tree_rebuild(tree, iter(out), _is_tensor)


class _Gather(torch.autograd.Function):
    """Forward: every rank's block along ``axis``, whole on every rank. Backward: this rank's slice."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width = mesh, axis, x.shape[axis]
        shape = list(x.shape)
        shape[axis] *= mesh.size
        # A zero-filled whole in which each rank writes its block, summed:
        # exact values (x + 0 = x) and one code path for gloo and NCCL.
        whole = x.new_zeros(shape)
        whole.narrow(axis, mesh.rank * ctx.width, ctx.width).copy_(x)
        return _all_reduce(whole, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.axis, ctx.mesh.rank * ctx.width, ctx.width), None, None


def _gather(x: torch.Tensor, mesh: DeviceMesh, axis: int) -> torch.Tensor:
    return _Gather.apply(x, mesh, axis % x.ndim)


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """``x`` padded along its first axis to a multiple of ``multiple`` with copies of its first row."""
    pad = -x.shape[0] % multiple
    return torch.cat((x, x[:1].expand(pad, *x.shape[1:]))) if pad else x


def sharded_trace_paths(
    scene: Scene,
    order: int,
    mesh: DeviceMesh,
    *,
    shard_candidates: bool = True,
    **solver_kwargs,
) -> TracedPaths:
    """The exhaustive trace with the candidate axis split over the mesh's ranks.

    The candidates are padded to a multiple of the mesh size with copies of
    candidate 0, each rank traces its block (through
    :func:`~differt_tpu_torch.rt.trace_path_candidates`, ``solver_kwargs``
    passed on) and the blocks are gathered: every rank returns the whole,
    whose candidate axis keeps its padded length, the padded rows masked
    out. With ``shard_candidates=False`` every rank traces every candidate
    and no collective runs.
    """
    _member(mesh)
    num_primitives = scene.mesh.num_primitives
    candidates = generate_path_candidates(num_primitives, order, device=mesh.device)
    if scene.mesh.assume_quads:
        candidates = 2 * candidates
    if not shard_candidates:
        moved = (x.to(mesh.device) for x in tree_leaves(scene, _is_tensor))
        scene = tree_rebuild(scene, moved, _is_tensor)
        return _trace_path_candidates(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            candidates,
            **solver_kwargs,
        )

    num_candidates = candidates.shape[0]
    candidates = _pad_rows(candidates, mesh.size)
    block = shard_along(candidates, mesh, axis=0)
    scene = replicate(scene, mesh)
    paths = _trace_path_candidates(
        scene.mesh,
        scene.transmitters.reshape(-1, 3),
        scene.receivers.reshape(-1, 3),
        block,
        **solver_kwargs,
    )
    # [tx, rx, candidates, ...]: gather along the candidate axis.
    paths = paths._remap(lambda x, nd: _gather(x, mesh, x.ndim - nd - 1))
    valid = torch.arange(candidates.shape[0], device=mesh.device) < num_candidates
    if paths.mask.dtype == torch.bool:
        mask = paths.mask & valid
    else:
        mask = torch.where(valid, paths.mask, 0.0)
    return dataclasses.replace(paths, mask=mask)


def sharded_power_map(
    scene: Scene,
    frequency,
    mesh: DeviceMesh,
    *,
    order: int = 1,
    eta_r: torch.Tensor | None = None,
    conductivity: torch.Tensor | None = None,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
) -> torch.Tensor:
    """The coverage map of ``order`` with the receiver axis split over the mesh's ranks.

    Materials default to the ITU table at ``frequency``. The receivers are
    flattened and padded to a multiple of the mesh size with copies of the
    first; each rank traces its block and computes its received power, and
    the blocks are gathered: every rank returns the whole
    ``[*tx_batch, *rx_batch]`` map. The map is differentiable: the scene and
    the materials go through :func:`replicate`, so a gradient with respect
    to any of them is the whole gradient on every rank.
    """
    _member(mesh)
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=mesh.device)
    if eta_r is None or conductivity is None:
        eta_r, conductivity, thickness = resolve_materials(
            scene, frequency, eta_r, conductivity, thickness
        )
    rx_batch = scene.receivers.shape[:-1]
    rx_flat = scene.receivers.reshape(-1, 3)
    num_rx = rx_flat.shape[0]
    block = shard_along(_pad_rows(rx_flat, mesh.size), mesh, axis=0)
    scene, frequency, eta_r, conductivity, thickness = replicate(
        (dataclasses.replace(scene, receivers=rx_flat[:0]), frequency, eta_r, conductivity, thickness),
        mesh,
    )
    scene = dataclasses.replace(scene, receivers=block)
    power = received_power(
        scene.trace_paths(order=order),
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        coherent=coherent,
    )
    tx_batch = scene.transmitters.shape[:-1]
    power = _gather(power.reshape(*tx_batch, -1), mesh, -1)[..., :num_rx]
    return power.reshape(*tx_batch, *rx_batch)


def _power_db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=_POWER_FLOOR))


def _db_loss(power_db: torch.Tensor, target_power) -> torch.Tensor:
    """The dB mean-squared error to ``target_power``, or without one the negated mean dB power."""
    if target_power is not None:
        target = torch.as_tensor(target_power, dtype=power_db.dtype, device=power_db.device)
        return torch.mean((power_db - target) ** 2)
    return -torch.mean(power_db)


def _map_loss(scene: Scene, frequency, mesh, order: int, tx, eta_r, conductivity, target_power):
    """The dB loss of the coverage map of ``order``, held whole (gathered on every rank of a mesh)."""
    if tx is not None:
        scene = dataclasses.replace(scene, transmitters=tx)
    if mesh is not None:
        power = sharded_power_map(
            scene, frequency, mesh, order=order, eta_r=eta_r, conductivity=conductivity
        )
        return _db_loss(_power_db(power), target_power)
    device = scene.mesh.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    power = received_power(
        scene.trace_paths(order=order),
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
    )
    return _db_loss(_power_db(power), target_power)


def _leaf(x, device) -> torch.Tensor:
    """A fresh float32 leaf on ``device`` that requires a gradient."""
    return torch.as_tensor(x, dtype=torch.float32).to(device).detach().clone().requires_grad_()


def training_step(
    scene: Scene,
    frequency,
    mesh=None,
    *,
    order: int,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    target_power: torch.Tensor,
    learning_rate: float = 1e-2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One gradient-descent step on the materials' permittivity.

    The loss is the dB mean-squared error of the order-``order`` coverage
    map to ``target_power``. With a ``mesh`` the map is
    :func:`sharded_power_map`'s: every rank computes the same loss and gets
    the whole gradient. Returns the updated ``eta_r`` and the loss.
    """
    eta = _leaf(eta_r, scene.mesh.device if mesh is None else mesh.device)
    loss = _map_loss(scene, frequency, mesh, order, None, eta, conductivity, target_power)
    (grad,) = torch.autograd.grad(loss, (eta,))
    return eta.detach() - learning_rate * grad, loss.detach()


def placement_training_step(
    scene: Scene,
    frequency,
    mesh=None,
    *,
    order: int,
    tx: torch.Tensor,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    target_power: torch.Tensor | None = None,
    tx_learning_rate: float = 1e-1,
    eta_learning_rate: float = 1e-2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One gradient step on the TX positions and the permittivity.

    Gradients reach the TX through the image method (the paths' geometry)
    and the EM chain (directions, spreading, phase); hard validity masks
    are frozen selectors. With ``target_power`` (dB) the loss is the dB
    mean-squared error; without it the negated mean dB power over the
    receivers (coverage-optimal placement). With a ``mesh`` the map is
    :func:`sharded_power_map`'s, and every rank gets the same update.
    Returns the updated ``tx`` and ``eta_r`` and the loss.
    """
    device = scene.mesh.device if mesh is None else mesh.device
    tx_leaf, eta = _leaf(tx, device), _leaf(eta_r, device)
    loss = _map_loss(scene, frequency, mesh, order, tx_leaf, eta, conductivity, target_power)
    g_tx, g_eta = torch.autograd.grad(loss, (tx_leaf, eta))
    return (
        tx_leaf.detach() - tx_learning_rate * g_tx,
        eta.detach() - eta_learning_rate * g_eta,
        loss.detach(),
    )


def _streamed_setup(
    scene: Scene, frequency, mesh, tx, eta_r, conductivity, thickness,
    path_candidates, candidate_chunk: int, rx_chunk: int,
):
    """The tile walk (``coverage._TileWalk``), the scene without its receivers, the TX, the frequency and
    the materials of the streamed loss and step.

    ``path_candidates`` is one ``[C, order]`` tensor or a sequence of them,
    one per order, each a set of the walk. With a ``mesh`` the scene, TX and
    materials are replicated (detached: the step sums the ranks' gradients
    itself), and the passes pad each RX tile to a multiple of the mesh size
    with copies of its first receiver, this rank taking its block.
    """
    device = scene.mesh.device if mesh is None else mesh.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=scene.mesh.device)
    eta_r, conductivity, thickness = resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )
    tx = torch.as_tensor(tx, dtype=torch.float32).to(device)
    cand_list = path_candidates if isinstance(path_candidates, (list, tuple)) else [path_candidates]
    sets = [(torch.as_tensor(cand, device=device), None) for cand in cand_list]
    walk = _TileWalk(scene.receivers.reshape(-1, 3), rx_chunk, sets, candidate_chunk)
    scene_tile = dataclasses.replace(scene, receivers=walk.rx.new_zeros((0, 3)))
    if mesh is not None:
        detached = [None if x is None else x.detach() for x in (tx, eta_r, conductivity, thickness)]
        scene_tile, frequency, tx, eta_r, conductivity, thickness = replicate(
            (scene_tile, frequency, *detached), mesh
        )
    return walk, scene_tile, tx, frequency, eta_r, conductivity, thickness


def _streamed_forward(
    walk, scene_tile, mesh, tx, frequency, eta_r, conductivity, thickness,
    megakernel, batch_size, smoothing_factor=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: the per-pixel coherent amplitude sum, tile by tile, as (real, imag) ``[num_tx, num_rx]``.

    Each set is planned once for its tiles (``coverage._tile_plan``; no
    receiver enters the layout, so with or without a mesh). On a mesh each
    rank sums its blocks, and one gather gives every rank the whole.
    """
    rows: list[torch.Tensor] = []  # one complex sum per RX tile; the tiles come row by row
    with torch.no_grad():
        planned = walk.planned(
            scene_tile.mesh, tx, frequency, eta_r, conductivity, thickness,
            megakernel=megakernel,
            smoothing_factor=smoothing_factor,
            tx_pattern=None,
        )
        for row, rx_tile, s, lo, hi in planned:
            if mesh is not None:
                rx_tile = shard_along(_pad_rows(rx_tile, mesh.size), mesh)
            part = _coverage_tile(
                scene_tile, tx, rx_tile, s, lo, hi, s.plan, frequency, eta_r, conductivity,
                thickness, True, megakernel, batch_size, smoothing_factor,
            )
            if row == len(rows):
                rows.append(part)
            else:
                rows[row] = rows[row] + part
        totals = torch.stack(rows)  # [rows, num_tx, tile or block]
        if mesh is not None:
            totals = _gather(totals, mesh, -1)[..., : walk.rx_chunk]
        total = totals.transpose(0, 1).reshape(totals.shape[1], -1)[..., : walk.num_rx]
    return total.real.clone(), total.imag.clone()


def _placement_loss(re: torch.Tensor, im: torch.Tensor, target_power) -> torch.Tensor:
    return _db_loss(_power_db((re**2 + im**2) / z_0), target_power)


def streamed_placement_loss(
    scene: Scene,
    frequency,
    mesh=None,
    *,
    tx: torch.Tensor,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    path_candidates: torch.Tensor | Sequence[torch.Tensor],
    candidate_chunk: int = 256,
    rx_chunk: int = 8192,
    target_power: torch.Tensor | None = None,
    megakernel: bool | None = None,
    batch_size: int | None = 512,
    return_db_map: bool = False,
    smoothing_factor: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """The loss of :func:`streamed_placement_step` at ``tx``, with no gradient pass.

    The same tiling, coherent accumulation and dB loss, for a
    finite-difference probe of the streamed gradient. With
    ``return_db_map=True`` the per-pixel dB power ``[num_tx, num_rx]`` comes
    back instead of its mean: a probe whose loss differs by a few float32
    ulps of a mean near 260 dB takes that mean in float64 on the host. With
    a device ``mesh`` every rank returns the whole loss or map.
    """
    walk, scene_tile, tx, frequency, eta_r, conductivity, thickness = _streamed_setup(
        scene, frequency, mesh, tx, eta_r, conductivity, thickness,
        path_candidates, candidate_chunk, rx_chunk,
    )
    re, im = _streamed_forward(
        walk, scene_tile, mesh, tx, frequency, eta_r, conductivity, thickness,
        megakernel, batch_size, smoothing_factor,
    )
    if return_db_map:
        return _power_db((re**2 + im**2) / z_0)
    return _placement_loss(re, im, target_power)


def streamed_placement_step(
    scene: Scene,
    frequency,
    mesh=None,
    *,
    tx: torch.Tensor,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    path_candidates: torch.Tensor | Sequence[torch.Tensor],
    candidate_chunk: int = 256,
    rx_chunk: int = 8192,
    target_power: torch.Tensor | None = None,
    tx_learning_rate: float = 1e-1,
    eta_learning_rate: float = 1e-2,
    megakernel: bool | None = None,
    batch_size: int | None = 512,
    smoothing_factor: float | torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One TX-placement and permittivity gradient step, streamed over the grid.

    :func:`placement_training_step` differentiates a coverage map held
    whole, which a city-scale grid (16 TX x 10^6 RX x candidates) does not
    allow. This step streams both directions through fixed-size
    (RX tile, candidate chunk) buffers:

    1. Forward, without a graph: the per-pixel coherent amplitude sum, tile
       by tile (the loop of :func:`~differt_tpu_torch.coverage.power_map_chunked`).
    2. The loss reads only that ``[num_tx, num_rx]`` sum, so its gradient
       with respect to the sum's real and imaginary parts is one cheap
       elementwise pass.
    3. Backward: each tile runs again, with ``tx`` and ``eta_r`` as fresh
       leaves, and its amplitude is differentiated against its slice of
       that gradient. The total is a plain sum of the tiles' shares, so it
       is the exact gradient of the whole grid.

    Nothing of a tile's graph outlives the tile: peak memory is
    ``O(candidate_chunk * rx_chunk)`` whatever the grid. The mesh's BVH is
    built once, as moving the TX does not change the mesh. With a device
    ``mesh`` each RX tile is split over the ranks: pass 1 gathers the sums,
    every rank computes the same loss, pass 3 runs this rank's blocks
    against their slices, and the gradients are summed over the ranks once
    a step. Returns the updated ``tx`` and ``eta_r`` and the loss (the same
    on every rank).

    >>> import torch
    >>> from differt_tpu_torch.geometry import Mesh, Scene, generate_path_candidates
    >>> mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu").set_materials("Concrete")
    >>> scene = Scene(transmitters=torch.tensor([[-5.0, 0.5, 1.0]]), mesh=mesh)
    >>> tx, eta_r, loss = streamed_placement_step(
    ...     scene.with_receivers_grid(4, 2, height=1.0),
    ...     2.4e9,
    ...     tx=scene.transmitters,
    ...     eta_r=torch.tensor([5.24]),
    ...     conductivity=torch.tensor([0.1]),
    ...     path_candidates=generate_path_candidates(mesh.num_triangles, 1, device="cpu"),
    ...     candidate_chunk=4,
    ...     rx_chunk=3,
    ... )
    >>> tuple(tx.shape), tuple(eta_r.shape), bool(torch.isfinite(loss))
    ((1, 3), (1,), True)
    >>> bool((tx != scene.transmitters).any())
    True
    """
    with annotate("step"):
        walk, scene_tile, tx, frequency, eta_r, conductivity, thickness = _streamed_setup(
            scene, frequency, mesh, tx, eta_r, conductivity, thickness,
            path_candidates, candidate_chunk, rx_chunk,
        )
        tx, eta_r = tx.detach(), eta_r.detach()
        with annotate("step.pass1"):
            re, im = _streamed_forward(
                walk, scene_tile, mesh, tx, frequency, eta_r, conductivity, thickness,
                megakernel, batch_size, smoothing_factor,
            )

        # Pass 2: the loss and its gradient on the accumulated sums only.
        re.requires_grad_()
        im.requires_grad_()
        loss = _placement_loss(re, im, target_power)
        g_re, g_im = torch.autograd.grad(loss, (re, im))
        if walk.pad_r:
            zeros = g_re.new_zeros((g_re.shape[0], walk.pad_r))
            g_re = torch.cat((g_re, zeros), dim=-1)
            g_im = torch.cat((g_im, zeros), dim=-1)

        # Pass 3: each tile again, differentiated against its slice.
        with annotate("step.pass3"):
            g_tx = torch.zeros_like(tx)
            g_eta = torch.zeros_like(eta_r)
            for row, rx_tile, s, lo, hi in walk:
                if mesh is not None:
                    rx_tile = shard_along(_pad_rows(rx_tile, mesh.size), mesh)
                sl = slice(row * walk.rx_chunk, (row + 1) * walk.rx_chunk)
                cotangents = (g_re[:, sl], g_im[:, sl])
                if mesh is not None:  # this rank's block; the padded receivers' cotangent is 0
                    cotangents = tuple(
                        shard_along(torch.cat((g, g.new_zeros(g.shape[0], -g.shape[1] % mesh.size)), -1), mesh, 1)
                        for g in cotangents
                    )
                tx_leaf = tx.clone().requires_grad_()
                eta_leaf = eta_r.clone().requires_grad_()
                a = _coverage_tile(
                    scene_tile, tx_leaf, rx_tile, s, lo, hi, None, frequency, eta_leaf, conductivity,
                    thickness, True, megakernel, batch_size, smoothing_factor,
                )
                # (real, imag): the backward composes with the loss's gradient with no convention
                # for complex cotangents in between. A line-of-sight tile reads no material: its
                # share of g_eta is None.
                parts = a.real, a.imag
                with annotate("step.backward"):
                    d_tx, d_eta = torch.autograd.grad(parts, (tx_leaf, eta_leaf), cotangents, allow_unused=True)
                del a, parts
                if d_tx is not None:
                    g_tx += d_tx
                if d_eta is not None:
                    g_eta += d_eta
            if mesh is not None:  # one sum over the ranks a step, whatever each rank's tiles read
                summed = _all_reduce(torch.cat((g_tx.reshape(-1), g_eta)), mesh)
                g_tx, g_eta = summed[: g_tx.numel()].reshape(g_tx.shape), summed[g_tx.numel() :]

        return tx - tx_learning_rate * g_tx, eta_r - eta_learning_rate * g_eta, loss.detach()
