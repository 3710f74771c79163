"""Gradient steps on coverage maps (PyTorch port of ``differt_tpu.parallel._sharding``, one device).

:func:`training_step` and :func:`placement_training_step` differentiate a
coverage map held whole; :func:`streamed_placement_step` streams the same
loss and its gradient through fixed-size (RX tile, candidate chunk)
buffers, so that a city-scale grid fits one card. The device-mesh forms
(``sharded_trace_paths``, ``sharded_power_map``, ``make_device_mesh``) are
not ported yet (ROADMAP A11): the ``mesh`` argument must be None.
"""

import dataclasses
from collections.abc import Iterator, Sequence

import torch

from ..coverage import _coverage_tile, _resolve_materials, received_power
from ..em import z_0
from ..geometry import Scene

_POWER_FLOOR = 1e-30
"""Floor of the power under the logarithm: pixels below it sit at -300 dB and pass no gradient."""


def _one_device(mesh) -> None:
    if mesh is not None:
        msg = "A device mesh is not ported yet (ROADMAP A11): pass mesh=None to run on one device."
        raise NotImplementedError(msg)


def _power_db(power: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(power, min=_POWER_FLOOR))


def _db_loss(power_db: torch.Tensor, target_power) -> torch.Tensor:
    """The dB mean-squared error to ``target_power``, or without one the negated mean dB power."""
    if target_power is not None:
        target = torch.as_tensor(target_power, dtype=power_db.dtype, device=power_db.device)
        return torch.mean((power_db - target) ** 2)
    return -torch.mean(power_db)


def _map_loss(scene: Scene, frequency, order: int, tx, eta_r, conductivity, target_power):
    """The dB loss of the coverage map of ``order``, held whole."""
    if tx is not None:
        scene = dataclasses.replace(scene, transmitters=tx)
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
    map to ``target_power``. Returns the updated ``eta_r`` and the loss.
    """
    _one_device(mesh)
    eta = _leaf(eta_r, scene.mesh.device)
    loss = _map_loss(scene, frequency, order, None, eta, conductivity, target_power)
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
    receivers (coverage-optimal placement). Returns the updated ``tx`` and
    ``eta_r`` and the loss.
    """
    _one_device(mesh)
    device = scene.mesh.device
    tx_leaf, eta = _leaf(tx, device), _leaf(eta_r, device)
    loss = _map_loss(scene, frequency, order, tx_leaf, eta, conductivity, target_power)
    g_tx, g_eta = torch.autograd.grad(loss, (tx_leaf, eta))
    return (
        tx_leaf.detach() - tx_learning_rate * g_tx,
        eta.detach() - eta_learning_rate * g_eta,
        loss.detach(),
    )


def _tile_amplitude_parts(
    scene_tile, tx, eta_r, rx_tile, cand, itypes, valid,
    frequency, conductivity, thickness, megakernel, batch_size, smoothing_factor=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(real, imag) of one (RX tile, candidate chunk) amplitude sum.

    A pair of real tensors, so that the streamed backward composes with the
    loss's gradient with no convention for complex cotangents in between.
    """
    a = _coverage_tile(
        scene_tile, tx, rx_tile, cand, itypes, valid, frequency, eta_r, conductivity,
        thickness, True, megakernel, batch_size, smoothing_factor,
    )
    return a.real, a.imag


def _streamed_setup(
    scene: Scene, frequency, tx, eta_r, conductivity, thickness,
    path_candidates, candidate_chunk: int, rx_chunk: int,
):
    """Padding and tiling shared by the streamed loss and step.

    Receivers are padded to whole tiles of ``rx_chunk`` with copies of the
    first, each order's candidates to whole chunks with copies of its
    first (masked out by the tile's ``valid``). ``path_candidates`` is one
    ``[C, order]`` tensor or a sequence of them, one per order: every
    order's chunks go through the same tile step, so the accumulated
    amplitude is the coherent sum over the orders.
    """
    device = scene.mesh.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    eta_r, conductivity, thickness = _resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )
    tx = torch.as_tensor(tx, dtype=torch.float32).to(device)

    rx_all = scene.receivers.reshape(-1, 3)
    num_rx = rx_all.shape[0]
    rx_chunk = min(rx_chunk, max(num_rx, 1))
    pad_r = -num_rx % rx_chunk
    if pad_r:
        rx_all = torch.cat((rx_all, rx_all[:1].expand(pad_r, 3)))

    cand_list = (
        list(path_candidates) if isinstance(path_candidates, (list, tuple)) else [path_candidates]
    )
    prepared = []
    for cand in cand_list:
        cand = torch.as_tensor(cand, device=device)
        n = cand.shape[0]
        chunk = min(candidate_chunk, max(n, 1))
        pad = -n % chunk
        if pad:
            cand = torch.cat((cand, cand[:1].expand(pad, -1)))
        prepared.append((cand, n, chunk))

    scene_tile = dataclasses.replace(scene, receivers=rx_all.new_zeros((0, 3)))

    def tiles() -> Iterator[tuple[int, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
        for row, r0 in enumerate(range(0, rx_all.shape[0], rx_chunk)):
            rx_tile = rx_all[r0 : r0 + rx_chunk]
            for cand, n, chunk in prepared:
                for c0 in range(0, cand.shape[0], chunk):
                    part = cand[c0 : c0 + chunk]
                    yield (
                        row,
                        rx_tile,
                        part,
                        torch.zeros_like(part, dtype=torch.int32),
                        torch.arange(c0, c0 + chunk, device=device) < n,
                    )

    return frequency, tx, eta_r, conductivity, thickness, scene_tile, tiles, num_rx, rx_chunk, pad_r


def _streamed_forward(
    scene_tile, tiles, tx, frequency, eta_r, conductivity, thickness, num_rx,
    megakernel, batch_size, smoothing_factor=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 1: the per-pixel coherent amplitude sum, tile by tile, as (real, imag) ``[num_tx, num_rx]``."""
    rows: list[torch.Tensor] = []  # one complex sum per RX tile; the tiles come row by row
    with torch.no_grad():
        for row, rx_tile, cand, itypes, valid in tiles():
            part = _coverage_tile(
                scene_tile, tx, rx_tile, cand, itypes, valid, frequency, eta_r, conductivity,
                thickness, True, megakernel, batch_size, smoothing_factor,
            )
            if row == len(rows):
                rows.append(part)
            else:
                rows[row] = rows[row] + part
        total = torch.cat(rows, dim=-1)[..., :num_rx]
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
    ulps of a mean near 260 dB takes that mean in float64 on the host.
    """
    _one_device(mesh)
    frequency, tx, eta_r, conductivity, thickness, scene_tile, tiles, num_rx, _, _ = (
        _streamed_setup(
            scene, frequency, tx, eta_r, conductivity, thickness,
            path_candidates, candidate_chunk, rx_chunk,
        )
    )
    re, im = _streamed_forward(
        scene_tile, tiles, tx, frequency, eta_r, conductivity, thickness, num_rx,
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
    built once, as moving the TX does not change the mesh. Returns the
    updated ``tx`` and ``eta_r`` and the loss.

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
    _one_device(mesh)
    frequency, tx, eta_r, conductivity, thickness, scene_tile, tiles, num_rx, rx_chunk, pad_r = (
        _streamed_setup(
            scene, frequency, tx, eta_r, conductivity, thickness,
            path_candidates, candidate_chunk, rx_chunk,
        )
    )
    tx, eta_r = tx.detach(), eta_r.detach()
    re, im = _streamed_forward(
        scene_tile, tiles, tx, frequency, eta_r, conductivity, thickness, num_rx,
        megakernel, batch_size, smoothing_factor,
    )

    # Pass 2: the loss and its gradient on the accumulated sums only.
    re.requires_grad_()
    im.requires_grad_()
    loss = _placement_loss(re, im, target_power)
    g_re, g_im = torch.autograd.grad(loss, (re, im))
    if pad_r:
        zeros = g_re.new_zeros((g_re.shape[0], pad_r))
        g_re = torch.cat((g_re, zeros), dim=-1)
        g_im = torch.cat((g_im, zeros), dim=-1)

    # Pass 3: each tile again, differentiated against its slice.
    g_tx = torch.zeros_like(tx)
    g_eta = torch.zeros_like(eta_r)
    for row, rx_tile, cand, itypes, valid in tiles():
        sl = slice(row * rx_chunk, (row + 1) * rx_chunk)
        tx_leaf = tx.clone().requires_grad_()
        eta_leaf = eta_r.clone().requires_grad_()
        parts = _tile_amplitude_parts(
            scene_tile, tx_leaf, eta_leaf, rx_tile, cand, itypes, valid, frequency,
            conductivity, thickness, megakernel, batch_size, smoothing_factor,
        )
        # A line-of-sight tile reads no material: its share of g_eta is None.
        d_tx, d_eta = torch.autograd.grad(
            parts, (tx_leaf, eta_leaf), (g_re[:, sl], g_im[:, sl]), allow_unused=True
        )
        del parts
        if d_tx is not None:
            g_tx += d_tx
        if d_eta is not None:
            g_eta += d_eta

    return tx - tx_learning_rate * g_tx, eta_r - eta_learning_rate * g_eta, loss.detach()
