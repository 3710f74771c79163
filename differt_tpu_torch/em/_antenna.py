"""Antennas and radiation patterns (PyTorch port of ``differt_tpu.em._antenna``).

Frozen dataclasses of tensors, as :class:`~differt_tpu_torch.em.Material`
is. The frequency and the centre are float32 tensors on one device: the
centre's when it is a tensor, else ``device`` (the card when None), so that
``HWDipolePattern(2.4e9, direction=(0, 0, 1))`` lives on the card.

A :class:`RadiationPattern` feeds the coverage path
(``coverage.complex_amplitudes(tx_pattern=...)``): its (s, p) vectors,
evaluated one metre from its centre along each path's departure, replace
the unit vertical polarization of an isotropic antenna. The local frames
use the zero-safe :func:`~..utils.normalize3`, whose backward is finite
where the JAX package's ``normalize`` is not (a direction along the dipole
axis, ``sin theta = 0``).

Left out: ``plot_radiation_pattern`` (it needs a plotting adapter).
"""

import abc
import dataclasses
import math

import torch

from ..geometry._vectors import _cross, cartesian_to_spherical, normalize, spherical_to_cartesian
from ..utils import normalize3, safe_divide
from ._constants import c, epsilon_0, mu_0


def poynting_vector(e: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Poynting vector in vacuum, ``S = E x B / mu_0``, of ``[*batch, 3]`` fields."""
    e, b = torch.broadcast_tensors(torch.as_tensor(e), torch.as_tensor(b))
    return _cross(e, b) / mu_0


def _unit(vectors: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero-safe ``(unit, length [*batch, 1])`` of ``[*batch, 3]`` vectors (:func:`~..utils.normalize3`)."""
    unit, length = normalize3(tuple(vectors.unbind(-1)))
    return torch.stack(unit, dim=-1), length[..., None]


def _sphere(center: torch.Tensor, num_points: int, distance=1.0):
    """The angular grid of ``directivity``: azimuths ``u [2n]``, polar angles ``v [n]``, points ``[2n, n, 3]``."""
    kw = {"dtype": torch.float32, "device": center.device}
    u = torch.linspace(0, 2 * math.pi, num_points * 2, **kw)
    v = torch.linspace(0, math.pi, num_points, **kw)
    x = torch.outer(torch.cos(u), torch.sin(v))
    y = torch.outer(torch.sin(u), torch.sin(v))
    z = torch.outer(torch.ones_like(u), torch.cos(v))
    return u, v, center + distance * torch.stack((x, y, z), dim=-1)


@dataclasses.dataclass(frozen=True, eq=False)
class BaseAntenna:
    """Base class of antennas and radiation patterns."""

    frequency: torch.Tensor
    """Operating frequency (Hz)."""
    _: dataclasses.KW_ONLY
    center: torch.Tensor | None = None
    """Position of the antenna, ``[3]`` (the origin when None)."""
    device: dataclasses.InitVar[torch.device | str | None] = None

    def __post_init__(self, device) -> None:
        if isinstance(self.center, torch.Tensor):
            device = self.center.device
        elif device is None:
            device = torch.device("cuda")
        center = (0.0, 0.0, 0.0) if self.center is None else self.center
        object.__setattr__(self, "center", torch.as_tensor(center, dtype=torch.float32, device=device))
        object.__setattr__(
            self, "frequency", torch.as_tensor(self.frequency, dtype=torch.float32, device=device)
        )

    @property
    def period(self) -> torch.Tensor:
        """``T = 1 / f``."""
        return 1 / self.frequency

    @property
    def angular_frequency(self) -> torch.Tensor:
        """``omega = 2 pi f``."""
        return 2 * math.pi * self.frequency

    @property
    def wavelength(self) -> torch.Tensor:
        """``lambda = c / f``."""
        return c * self.period

    @property
    def wavenumber(self) -> torch.Tensor:
        """``k = omega / c``."""
        return self.angular_frequency / c

    @property
    def aperture(self) -> torch.Tensor:
        """Effective aperture of an isotropic antenna, ``lambda^2 / (4 pi)``."""
        return self.wavelength**2 / (4 * math.pi)


class Antenna(BaseAntenna, abc.ABC):
    """An antenna that radiates E and B fields; subclasses give :meth:`fields`."""

    @property
    @abc.abstractmethod
    def reference_power(self) -> torch.Tensor:
        """Radiated power (W) at one metre."""

    @abc.abstractmethod
    def fields(self, r: torch.Tensor, t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Complex E and B fields ``[*batch, 3]`` at positions ``r`` and times ``t``."""

    def poynting_vector(self, r: torch.Tensor, t: torch.Tensor | None = None) -> torch.Tensor:
        """Poynting vector at positions ``r`` (and times ``t``)."""
        return poynting_vector(*self.fields(r, t))

    def directivity(self, num_points: int = 100) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Directivity estimated on a ``2 num_points x num_points`` angular grid: ``(u, v, D)``."""
        u, v, r = _sphere(self.center, num_points)
        du = 2 * math.pi / (2 * num_points - 1)
        dv = math.pi / (num_points - 1)
        p = torch.linalg.vector_norm(self.poynting_vector(r), dim=-1)
        p_tot = (p * torch.sin(v)).sum() / (4 * math.pi)
        return u, v, p / (du * dv) / p_tot

    def directive_gain(self, num_points: int = 100) -> torch.Tensor:
        """The largest value of :meth:`directivity`."""
        return self.directivity(num_points=num_points)[-1].max()

    def plot_radiation_pattern(self, num_points: int = int(1e2), distance=1.0, num_wavelengths=None, **kwargs):
        """Draw the radiated power, normalized to its peak, as a surface around the antenna.

        The sphere of radius ``distance`` (or ``num_wavelengths``
        wavelengths) is scaled along each direction by the normalized power,
        which also colors it (:func:`differt_tpu_torch.plotting.draw_surface`).
        """
        from ..plotting import draw_surface

        _, _, r = _sphere(self.center, num_points, _radius(self, distance, num_wavelengths))
        p = torch.linalg.vector_norm(self.poynting_vector(r), dim=-1, keepdim=True)
        gain = p / p.max()
        r = self.center + (r - self.center) * gain
        return draw_surface(x=r[..., 0], y=r[..., 1], z=r[..., 2], colors=gain[..., 0], **kwargs)


def _radius(antenna: BaseAntenna, distance, num_wavelengths) -> torch.Tensor:
    if num_wavelengths is not None:
        return torch.as_tensor(num_wavelengths) * antenna.wavelength
    return torch.as_tensor(distance)


@dataclasses.dataclass(frozen=True, eq=False, init=False)
class Dipole(Antenna):
    """A Hertzian dipole, with the near and far fields of the JAX package.

    With ``p = p_rad + p_perp`` split along and across the line of sight,
    ``E = [k^2 p_perp / r + (2 p_rad - p_perp)(1 - jkr) / r^4] e^{j(kr - wt)} / (4 pi eps_0)``
    and ``B = (r x p)(k^2 / r + jk / r^2) e^{j(kr - wt)} / (4 pi eps_0 c)``
    (the reference's near field falls as ``1 / r^4``; the far field is the
    textbook one).

    >>> import torch
    >>> antenna = Dipole(1e9, device="cpu")
    >>> float(antenna.directive_gain())
    1.5
    >>> e, b = antenna.fields(torch.tensor([100.0, 0.0, 0.0]))
    >>> tuple(e.shape), tuple(b.shape)
    ((3,), (3,))
    """

    length: torch.Tensor
    """Dipole length (m)."""
    moment: torch.Tensor
    """Dipole moment (C m), ``[3]``."""

    def __init__(
        self,
        frequency,
        num_wavelengths=0.5,
        *,
        length=None,
        moment=(0.0, 0.0, 1.0),
        current=1.0,
        charge=None,
        center=None,
        look_at=None,
        device=None,
    ) -> None:
        object.__setattr__(self, "frequency", frequency)
        object.__setattr__(self, "center", center)
        self.__post_init__(device)
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=self.center.device)  # noqa: E731
        length = as_f32(num_wavelengths) * self.wavelength if length is None else as_f32(length)
        axis, scale = normalize(as_f32(moment))
        if charge is not None:
            # Opposite charges +-q at the ends: |p| = q * length.
            moment = axis * (as_f32(charge) * length)
        elif current is not None:
            # A constant current I at pulsation w: |p| = I * length / w.
            moment = axis * (as_f32(current) * length / self.angular_frequency)
        else:
            moment = axis * scale
        if look_at is not None:
            # A dipole radiates broadside: its default (+x-looking)
            # orientation turns toward `look_at` by offsetting the moment's
            # polar angle by (the target's - pi / 2) and its azimuth by the
            # target's, its length unchanged.
            _, t_pol, t_azi = cartesian_to_spherical(
                normalize(as_f32(look_at) - self.center)[0]
            ).unbind(-1)
            p_len, p_pol, p_azi = cartesian_to_spherical(moment).unbind(-1)
            moment = p_len * spherical_to_cartesian(
                torch.stack((p_pol + t_pol - 0.5 * math.pi, p_azi + t_azi))
            )
        object.__setattr__(self, "length", length)
        object.__setattr__(self, "moment", moment)

    @property
    def reference_power(self) -> torch.Tensor:
        """Radiated power ``mu_0 w^4 |p|^2 / (4 pi c)``, as ``(w^2 |p|)^2`` so that no factor overflows float32."""
        amplitude = self.angular_frequency**2 * torch.linalg.vector_norm(self.moment)
        return amplitude**2 * (mu_0 / (4 * math.pi * c))

    def fields(self, r: torch.Tensor, t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        r_hat, dist = normalize(torch.as_tensor(r) - self.center, keepdims=True)
        k = self.wavenumber
        # The moment along and across the line of sight:
        # (r x p) x r = p_perp and 3 r (r.p) - p = 2 p_rad - p_perp.
        p_rad = r_hat * (r_hat * self.moment).sum(dim=-1, keepdim=True)
        p_perp = self.moment - p_rad
        inv_r = 1.0 / dist
        kr = k * dist
        angle = kr if t is None else kr - self.angular_frequency * torch.as_tensor(t)[..., None]
        cycle = torch.exp(1j * angle) / (4 * math.pi * epsilon_0)
        near_field = (1.0 - 1j * kr) * inv_r**4
        e = cycle * (k * k * inv_r * p_perp + (2.0 * p_rad - p_perp) * near_field)
        r_x_p = _cross(r_hat, self.moment.expand_as(r_hat))
        b = (cycle / c) * r_x_p * (k * k * inv_r + 1j * k * inv_r * inv_r)
        return e, b

    def directivity(self, num_points: int = 100) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The exact directivity ``1.5 sin^2(theta)`` of the ideal dipole."""
        u, v, r = _sphere(torch.zeros_like(self.center), num_points)
        p = self.moment / torch.linalg.vector_norm(self.moment)
        sin_theta_sq = (_cross(r, p.expand_as(r)) ** 2).sum(dim=-1)
        return u, v, 1.5 * sin_theta_sq

    def directive_gain(self, num_points: int = 100) -> torch.Tensor:
        """The exact gain of the ideal dipole, 1.5."""
        del num_points
        return torch.tensor(1.5, device=self.center.device)


@dataclasses.dataclass(frozen=True, eq=False, init=False)
class ShortDipole(Dipole):
    """A short dipole (triangular current), far field only: the Hertzian dipole's with half the moment."""

    def fields(self, r: torch.Tensor, t: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        r_hat, dist = normalize(torch.as_tensor(r) - self.center, keepdims=True)
        p = 0.5 * self.moment  # a triangular current halves the mean current
        w = self.angular_frequency
        k = self.wavenumber
        k_sq = k * k
        inv_r = 1 / dist
        factor = 1 / (4 * math.pi * epsilon_0)
        r_x_p = _cross(r_hat, p.expand_as(r_hat))
        e = factor * k_sq * _cross(r_x_p, r_hat) * inv_r
        b = (factor * k_sq / c) * r_x_p * inv_r
        j_k_r = 1j * k * dist
        phase = torch.exp(j_k_r if t is None else j_k_r - 1j * w * torch.as_tensor(t)[..., None])
        return e * phase, b * phase

    def directivity(self, num_points: int = 100) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Numeric directivity of the far field."""
        return Antenna.directivity(self, num_points=num_points)

    def directive_gain(self, num_points: int = 100) -> torch.Tensor:
        """Numeric directive gain."""
        return Antenna.directive_gain(self, num_points=num_points)


class RadiationPattern(BaseAntenna, abc.ABC):
    """A radiation pattern given by its polarization vectors; subclasses give :meth:`polarization_vectors`."""

    @abc.abstractmethod
    def polarization_vectors(self, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The s and p polarization vectors ``[*batch, 3]`` at ``r``, scaled by the amplitude pattern."""

    def directivity(self, num_points: int = 100) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The squared polarization amplitudes on the angular grid: ``(u, v, D)``."""
        u, v, r = _sphere(self.center, num_points)
        s, p = self.polarization_vectors(r)
        return u, v, (s * s).sum(dim=-1) + (p * p).sum(dim=-1)

    def directive_gain(self, num_points: int = 100) -> torch.Tensor:
        """The largest value of :meth:`directivity`."""
        return self.directivity(num_points=num_points)[-1].max()

    def plot_radiation_pattern(self, num_points: int = int(1e2), distance=1.0, num_wavelengths=None, **kwargs):
        """Draw the pattern's power, normalized to its peak, as a surface (see :meth:`Antenna.plot_radiation_pattern`).

        As in the JAX package, the points are scaled about the origin, not the center.
        """
        from ..plotting import draw_surface

        _, _, r = _sphere(self.center, num_points, _radius(self, distance, num_wavelengths))
        s, p = self.polarization_vectors(r)
        power = (s * s).sum(dim=-1, keepdim=True) + (p * p).sum(dim=-1, keepdim=True)
        gain = power / power.max()
        r = r * gain
        return draw_surface(x=r[..., 0], y=r[..., 1], z=r[..., 2], colors=gain[..., 0], **kwargs)


def _dipole_frame(r: torch.Tensor, center: torch.Tensor, direction: torch.Tensor):
    """The unit radial direction, the local theta direction, and ``(cos theta, sin theta)``."""
    r_hat, _ = _unit(torch.as_tensor(r) - center)
    direction = direction.expand_as(r_hat)
    cos_theta = (r_hat * direction).sum(dim=-1, keepdim=True)
    # phi_hat along direction x r_hat (the azimuth); theta_hat completes the triad.
    phi_vec, phi_norm = _unit(_cross(direction, r_hat))
    theta_vec, _ = _unit(_cross(phi_vec, r_hat))
    return r_hat, theta_vec, (cos_theta, phi_norm)


@dataclasses.dataclass(frozen=True, eq=False)
class HWDipolePattern(RadiationPattern):
    """Half-wave dipole: amplitude ``cos(pi/2 cos theta) / sin theta`` along theta, peak gain ``4 / Cin(2 pi)``.

    >>> pattern = HWDipolePattern(2.4e9, direction=(0.0, 0.0, 1.0), device="cpu")
    >>> round(float(pattern.directive_gain(num_points=101)), 3)  # the grid holds theta = pi / 2
    1.641
    """

    direction: torch.Tensor
    """The dipole's axis (a unit vector), ``[3]``."""

    def __post_init__(self, device) -> None:
        super().__post_init__(device)
        object.__setattr__(
            self, "direction", torch.as_tensor(self.direction, dtype=torch.float32, device=self.center.device)
        )

    def polarization_vectors(self, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _, theta_vec, (cos_theta, sin_norm) = _dipole_frame(r, self.center, self.direction)
        d = 1.640922376984585  # 4 / Cin(2 pi)
        amplitude = math.sqrt(d) * safe_divide(torch.cos(0.5 * math.pi * cos_theta), sin_norm)
        p = amplitude * theta_vec
        return torch.zeros_like(p), p


@dataclasses.dataclass(frozen=True, eq=False)
class ShortDipolePattern(RadiationPattern):
    """Short dipole: amplitude ``sin theta`` along theta, gain 1.5.

    >>> pattern = ShortDipolePattern(2.4e9, direction=(0.0, 0.0, 1.0), device="cpu")
    >>> round(float(pattern.directive_gain()), 3)
    1.5
    """

    direction: torch.Tensor
    """The dipole's axis (a unit vector), ``[3]``."""

    def __post_init__(self, device) -> None:
        super().__post_init__(device)
        object.__setattr__(
            self, "direction", torch.as_tensor(self.direction, dtype=torch.float32, device=self.center.device)
        )

    def polarization_vectors(self, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        _, theta_vec, (_, sin_norm) = _dipole_frame(r, self.center, self.direction)
        p = math.sqrt(1.5) * sin_norm * theta_vec
        return torch.zeros_like(p), p
