"""DeepMIMO export: traced paths and the scene's materials to per-path channels (a port of ``differt_tpu.plugins.deepmimo``).

Per path: the received power (dBW, for 0 dBW transmitted), phase
(degrees), delay (s), and the angles of arrival and departure (degrees),
beside the interaction types, points and, on request, primitives. The
per-bounce Jones chain is :func:`differt_tpu_torch.em.transition_apply`;
after the material table the export is differentiable (with respect to
the path vertices, hence the transmitters).
"""

__all__ = ("DeepMIMO", "export")

import dataclasses
import math
from collections.abc import Iterable, Mapping

import numpy as np
import torch

from ..em import InteractionType, Material, c, epsilon_0, materials, spherical_basis, transition_apply, z_0
from ..geometry import Scene, TracedPaths, cartesian_to_spherical, normalize
from ..utils import safe_divide


def _stack_ragged(parts: list[torch.Tensor], fill_value, width: int) -> torch.Tensor:
    """Join per-order tensors along the path axis (2), padding each one's interaction axis (3) to ``width``."""
    padded = []
    for part in parts:
        out = part.new_full((*part.shape[:3], width, *part.shape[4:]), fill_value)
        out[:, :, :, : part.shape[3]] = part
        padded.append(out)
    return torch.cat(padded, dim=2)


@dataclasses.dataclass(frozen=True, kw_only=True)
class DeepMIMO:
    """DeepMIMO-format channel data, one entry per path (tensors, or numpy arrays after :meth:`numpy`)."""

    power: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` received power (dBW, 0 dBW transmitted)."""
    phase: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` received phase (degrees)."""
    delay: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` propagation delay (s)."""
    aoa_az: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` angle of arrival, azimuth (degrees)."""
    aoa_el: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` angle of arrival, elevation from +z (degrees)."""
    aod_az: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` angle of departure, azimuth (degrees)."""
    aod_el: torch.Tensor
    """``[num_tx, num_rx, num_paths]`` angle of departure, elevation from +z (degrees)."""
    primitives: torch.Tensor | None = None
    """Optional ``[num_tx, num_rx, num_paths, max_inter]`` primitive along each path (-1: none)."""
    inter: torch.Tensor = None
    """``[num_tx, num_rx, num_paths, max_inter]`` interaction types along each path (-1: none)."""
    inter_pos: torch.Tensor = None
    """``[num_tx, num_rx, num_paths, max_inter, 3]`` interaction points (m)."""
    rx_pos: torch.Tensor = None
    """``[num_rx, 3]`` receiver positions (m)."""
    tx_pos: torch.Tensor = None
    """``[num_tx, 3]`` transmitter positions (m)."""
    mask: torch.Tensor = None
    """``[num_tx, num_rx, num_paths]`` valid-path mask."""

    @property
    def num_tx(self) -> int:
        return self.mask.shape[0]

    @property
    def num_rx(self) -> int:
        return self.mask.shape[1]

    @property
    def num_paths(self) -> int:
        return self.mask.shape[2]

    def asdict(self) -> dict:
        """The fields as a plain dict (the same tensors, not copies)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def _map(self, fn) -> "DeepMIMO":
        return dataclasses.replace(self, **{k: None if v is None else fn(v) for k, v in self.asdict().items()})

    def numpy(self) -> "DeepMIMO":
        """Every field as a numpy array (on the host)."""
        return self._map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x))

    def torch(self, device: torch.device | str | None = None) -> "DeepMIMO":
        """Every field as a tensor on ``device`` (the card when None)."""
        device = torch.device("cuda") if device is None else device
        return self._map(lambda x: torch.as_tensor(x, device=device))

    def sort_by_vertices(self, vertices, interactions) -> "DeepMIMO":
        """Reorder the paths to match another ordering, given by its interaction points and types.

        ``vertices`` ``[num_tx, num_rx, num_paths, max_inter, 3]`` and
        ``interactions`` (same batch, ``max_inter``): each of this
        dataset's paths takes the row of the other ordering whose points
        are nearest (summed over this path's interactions) among those
        of the same types; useful beside another ray tracer, whose paths
        come in another order.
        """
        device = self.inter_pos.device
        vertices = torch.as_tensor(vertices, dtype=self.inter_pos.dtype, device=device)
        interactions = torch.as_tensor(interactions, device=device)
        if tuple(vertices.shape) != tuple(self.inter_pos.shape):
            msg = (
                "External path geometry must match this dataset's shape "
                f"{tuple(self.inter_pos.shape)!r}; received {tuple(vertices.shape)!r}."
            )
            raise ValueError(msg)
        max_inter = self.inter.shape[-1]
        d = self.inter_pos.reshape(-1, 1, max_inter, 3) - vertices.reshape(1, -1, max_inter, 3)
        distances = torch.linalg.vector_norm(d, dim=3)
        inter = self.inter.reshape(-1, 1, max_inter)
        type_mismatch = ~(inter == interactions.reshape(1, -1, max_inter)).all(dim=-1)
        cost = torch.where(inter != -1, distances, 0.0).sum(dim=2) + torch.where(type_mismatch, torch.inf, 0.0)
        indices = cost.argmin(dim=1)
        prefix = (self.num_tx, self.num_rx, self.num_paths)

        def sort_fn(x: torch.Tensor) -> torch.Tensor:
            if tuple(x.shape[: len(prefix)]) != prefix:
                return x
            return x.reshape(-1, *x.shape[len(prefix) :])[indices].reshape(x.shape)

        return self._map(sort_fn)

    def iter_paths(self):
        """A :class:`~differt_tpu_torch.geometry.SizedIterator` of the valid paths' vertices, one ``[n, k + 2, 3]`` tensor per interaction count ``k``."""
        from ..geometry import SizedIterator

        max_inter = self.inter.shape[-1]
        shape = (self.num_tx, self.num_rx, self.num_paths, 3)

        def it():
            positions = torch.arange(max_inter, device=self.inter.device).expand(self.inter.shape)
            num_interactions = torch.where(self.inter == -1, positions, max_inter)
            num_interactions = (
                num_interactions.amin(dim=-1) if max_inter else torch.zeros(self.mask.shape, dtype=torch.int64)
            )
            for num in range(max_inter + 1):
                where = (self.mask & (num_interactions == num)).reshape(-1)
                tx = self.tx_pos[:, None, None, :].expand(shape).reshape(-1, 3)[where]
                rx = self.rx_pos[None, :, None, :].expand(shape).reshape(-1, 3)[where]
                mid = self.inter_pos.reshape(-1, max_inter, 3)[where, :num]
                yield torch.cat((tx[:, None, :], mid, rx[:, None, :]), dim=-2)

        return SizedIterator(it(), size=max_inter + 1)

    def plot_paths(self, **kwargs):
        """Draw every valid path into one figure, one draw per interaction count; ``kwargs`` go to every draw."""
        from ..plotting import draw_paths, reuse

        with reuse(**kwargs, pass_all_kwargs=True) as output:
            for paths in self.iter_paths():
                draw_paths(paths)
        return output


def _slab_tables(
    radio_materials: Mapping[str, Material], names, frequency: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each material's complex refractive index and slab thickness (-1: semi-infinite)."""
    device = frequency.device
    refraction, thickness = [], []
    for name in names:
        material = radio_materials[name]
        eps = material.relative_permittivity(frequency) - 1j * safe_divide(
            material.conductivity(frequency), 2.0 * math.pi * frequency * epsilon_0
        )
        refraction.append(torch.sqrt(eps))
        thickness.append(-1.0 if material.thickness is None else float(material.thickness))
    if not refraction:
        return torch.zeros(0, dtype=torch.complex64, device=device), torch.zeros(0, device=device)
    return torch.stack(refraction).to(device), torch.tensor(thickness, dtype=torch.float32, device=device)


def _transmit_field(pol, k_first: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch field's ``(theta, phi)`` components for the TX polarization."""
    theta_hat, phi_hat = spherical_basis(k_first)
    lanes = theta_hat.shape[:-1]
    if isinstance(pol, str):
        vertical = pol == "V"
        full = lambda v: torch.full(lanes, v, dtype=torch.complex64, device=k_first.device)  # noqa: E731
        return full(1.0 if vertical else 0.0), full(0.0 if vertical else 1.0)
    p = torch.as_tensor(pol, device=k_first.device).to(torch.complex64)
    return (p * theta_hat).sum(dim=-1), (p * phi_hat).sum(dim=-1)


def _receive_projection(pol, k_last: torch.Tensor, e_theta: torch.Tensor, e_phi: torch.Tensor) -> torch.Tensor:
    """The arriving field projected on the RX polarization."""
    theta_hat, phi_hat = spherical_basis(k_last)
    if isinstance(pol, str):
        # The forward basis against the receive basis, which looks along -k.
        align = (theta_hat * spherical_basis(-k_last)[0]).sum(dim=-1)
        return align * e_theta if pol == "V" else -align * e_phi
    p = torch.as_tensor(pol, dtype=theta_hat.dtype, device=k_last.device)
    return (p * theta_hat).sum(dim=-1) * e_theta + (p * phi_hat).sum(dim=-1) * e_phi


def _direction_angles_deg(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(azimuth, zenith)`` of unit directions, in degrees.

    >>> az, zen = _direction_angles_deg(torch.tensor([1.0, 0.0, 0.0]))
    >>> round(float(az)), round(float(zen))
    (0, 90)
    """
    spherical = cartesian_to_spherical(k)
    return torch.rad2deg(spherical[..., 2]), torch.rad2deg(spherical[..., 1])


def export(
    *,
    paths: TracedPaths | Iterable[TracedPaths],
    scene: Scene,
    radio_materials: Mapping[str, Material] | None = None,
    frequency,
    include_primitives: bool = False,
    polarization="V",
) -> DeepMIMO:
    """Export traced paths (one :class:`TracedPaths`, or one per order) to the DeepMIMO format.

    Far field in free space, isotropic antennas. ``polarization`` is
    ``"V"``, ``"H"``, a 3-vector, or a ``(tx, rx)`` pair of those. The
    materials come from ``radio_materials`` (the ITU table by default) by
    the mesh's material names; a face material outside the table takes
    its nearest entry (clamped). Each order is computed apart, then the
    orders are joined along the path axis, their interaction axes padded
    with -1 (types, primitives) and 0 (points). The tensors lie on the
    paths' device; ``frequency`` (Hz) becomes a 0-d float32 tensor there.
    """
    if scene.mesh.face_materials is None:
        msg = (
            "Cannot export paths without per-face material information;"
            " load or assign materials on the scene mesh first."
        )
        raise ValueError(msg)
    if radio_materials is None:
        radio_materials = materials
    if isinstance(polarization, tuple) and len(polarization) == 2:
        tx_pol, rx_pol = polarization
    else:
        tx_pol = rx_pol = polarization

    device = scene.mesh.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    n_complex, thickness = _slab_tables(radio_materials, scene.mesh.material_names, frequency)
    speed = torch.tensor(c, dtype=torch.float32, device=device)
    wavelength = speed / frequency

    tx_pos = scene.transmitters.reshape(-1, 3)
    rx_pos = scene.receivers.reshape(-1, 3)
    num_tx, num_rx = tx_pos.shape[0], rx_pos.shape[0]
    last_material = max(n_complex.shape[0] - 1, 0)

    def batch_channel(batch: TracedPaths) -> dict[str, torch.Tensor]:
        """Amplitude and geometry of one single-order batch."""
        batch = batch.reshape(num_tx, num_rx, -1)
        v = batch.vertices
        k_hat, seg_len = normalize(v[..., 1:, :] - v[..., :-1, :], keepdims=True)
        total_len = seg_len[..., 0, 0]
        for i in range(1, seg_len.shape[-2]):
            total_len = total_len + seg_len[..., i, 0]

        e_theta, e_phi = _transmit_field(tx_pol, k_hat[..., 0, :])
        if batch.order > 0:
            bounce_objects = batch.objects[..., 1:-1]
            slab_ids = scene.mesh.face_materials[bounce_objects].clamp(0, last_material)
            e_theta, e_phi = transition_apply(
                v,
                scene.mesh.normals[bounce_objects],
                n_complex[slab_ids],
                thickness[slab_ids],
                wavelength,
                e_theta,
                e_phi,
                interaction_types=batch.interaction_types,
            )
        amplitude = _receive_projection(rx_pol, k_hat[..., -1, :], e_theta, e_phi)
        # Free-space 1/s spreading and the e^{-j 2 pi f s / c} propagation phase.
        phase = -2.0 * math.pi * frequency * total_len / c
        amplitude = amplitude * safe_divide(1.0, total_len) * torch.complex(torch.cos(phase), torch.sin(phase))
        types = batch.interaction_types
        if types is None:
            types = torch.full_like(batch.objects[..., 1:-1], InteractionType.REFLECTION)
        return {
            "amplitude": amplitude,
            "length": total_len,
            "k_first": k_hat[..., 0, :],
            "k_last": k_hat[..., -1, :],
            "types": types,
            "points": v[..., 1:-1, :],
            "objects": batch.objects[..., 1:-1],
            "valid": batch.mask,
        }

    batches = [paths] if isinstance(paths, TracedPaths) else list(paths)
    if not batches:
        # No batch: a well-formed dataset of zero paths.
        batches = [
            TracedPaths(
                vertices=torch.zeros((num_tx, num_rx, 0, 2, 3), device=device),
                objects=torch.zeros((num_tx, num_rx, 0, 2), dtype=torch.int64, device=device),
                mask=torch.zeros((num_tx, num_rx, 0), dtype=torch.bool, device=device),
                interaction_types=torch.zeros((num_tx, num_rx, 0, 0), dtype=torch.int32, device=device),
            )
        ]
    per_order = [batch_channel(batch) for batch in batches]

    def flat(field: str) -> torch.Tensor:
        return torch.cat([p[field] for p in per_order], dim=-1)

    widest = max(p["types"].shape[3] for p in per_order)
    amplitude = flat("amplitude") * (wavelength / (4 * math.pi))
    aod_az, aod_el = _direction_angles_deg(torch.cat([p["k_first"] for p in per_order], dim=2))
    aoa_az, aoa_el = _direction_angles_deg(torch.cat([-p["k_last"] for p in per_order], dim=2))
    return DeepMIMO(
        power=10.0 * torch.log10(torch.abs(amplitude) ** 2 / z_0),
        phase=torch.rad2deg(torch.angle(amplitude)),
        delay=flat("length") / c,
        aoa_az=aoa_az,
        aoa_el=aoa_el,
        aod_az=aod_az,
        aod_el=aod_el,
        inter=_stack_ragged([p["types"] for p in per_order], -1, widest),
        inter_pos=_stack_ragged([p["points"] for p in per_order], 0.0, widest),
        rx_pos=rx_pos,
        tx_pos=tx_pos,
        mask=flat("valid"),
        primitives=_stack_ragged([p["objects"] for p in per_order], -1, widest) if include_primitives else None,
    )
