"""Fresnel reflection and refraction coefficients (PyTorch port of ``differt_tpu.em._fresnel``).

The complex-safe form ``n_r cos(theta_t) = sqrt(n_r^2 + cos^2(theta_i) - 1)``
handles total internal reflection and lossy media through one branch cut: a
real ``n_r`` is taken as complex first, so that a negative radicand gives an
imaginary root and not NaN.
"""

import math

import torch

from ..utils import safe_divide


def _as_complex(n_r) -> torch.Tensor:
    n_r = torch.as_tensor(n_r)
    if n_r.is_complex():
        return n_r
    return n_r.to(torch.promote_types(n_r.dtype, torch.complex64))


def refractive_index(epsilon_r, mu_r=None) -> torch.Tensor:
    """Refractive index ``n = sqrt(epsilon_r * mu_r)`` (``mu_r`` defaults to 1).

    >>> float(refractive_index(4.0))
    2.0
    """
    epsilon_r = torch.as_tensor(epsilon_r)
    return torch.sqrt(epsilon_r if mu_r is None else epsilon_r * torch.as_tensor(mu_r))


def fresnel_coefficients(
    n_r, cos_theta_i
) -> tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Fresnel ``((r_s, r_p), (t_s, t_p))`` at an interface of relative index ``n_r``.

    ``cos_theta_i`` is the cosine of the incidence angle (its absolute
    value is taken). At normal incidence on glass (``n = 1.5``) ``r`` is
    ``-0.2`` for s, ``+0.2`` for p, and ``t = 2 / (1 + n) = 0.8``:

    >>> import torch
    >>> (r_s, r_p), (t_s, t_p) = fresnel_coefficients(1.5, torch.tensor(1.0))
    >>> round(float(r_s.real), 3), round(float(r_p.real), 3), round(float(t_s.real), 3)
    (-0.2, 0.2, 0.8)
    """
    n_r = _as_complex(n_r)
    cos_theta_i = torch.as_tensor(cos_theta_i)
    r_s, r_p = reflection_coefficients(n_r, cos_theta_i)
    ci = torch.abs(cos_theta_i)
    n_sq = n_r * n_r
    ct = torch.sqrt(n_sq + ci * ci - 1.0)
    t_s = safe_divide(2.0 * ci, ci + ct)
    t_p = safe_divide(2.0 * n_r * ci, n_sq * ci + ct)
    return (r_s, r_p), (t_s, t_p)


def reflection_coefficients(n_r, cos_theta_i) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresnel ``(r_s, r_p)`` at an interface of relative index ``n_r``.

    >>> import torch
    >>> r_s, r_p = reflection_coefficients(torch.tensor(1.5 + 0j), torch.tensor(1.0))
    >>> round(float(r_s.real), 3), round(float(r_p.real), 3)
    (-0.2, 0.2)
    """
    n_r = _as_complex(n_r)
    ci = torch.abs(torch.as_tensor(cos_theta_i))
    n_sq = n_r * n_r
    ct = torch.sqrt(n_sq + ci * ci - 1.0)
    r_s = safe_divide(ci - ct, ci + ct)
    incident_p = n_sq * ci
    r_p = safe_divide(incident_p - ct, incident_p + ct)
    return r_s, r_p


def refraction_coefficients(n_r, cos_theta_i) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresnel ``(t_s, t_p)`` at an interface of relative index ``n_r``."""
    return fresnel_coefficients(n_r, cos_theta_i)[1]


def slab_reflection_coefficients(
    n_r: torch.Tensor,
    cos_theta_i: torch.Tensor,
    thickness: torch.Tensor,
    wavelength: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflection off a finite-thickness slab (multi-bounce interference).

    Negative ``thickness`` selects the semi-infinite (plain Fresnel) result.
    The slab branch is then computed at a thickness of 0, not at the
    negative one: on a good conductor (ITU ``Metal``, 10^7 S/m) a negative
    thickness makes ``exp(-2j q)`` overflow, and the discarded branch's
    ``0 * inf`` would turn every gradient through it into NaN (the JAX
    package's is). The values are the same bits either way.
    """
    n_r = _as_complex(n_r)
    thickness = torch.as_tensor(thickness)
    r_s_inf, r_p_inf = reflection_coefficients(n_r, cos_theta_i)

    use_slab = thickness >= 0.0
    slab_thickness = torch.where(use_slab, thickness, 0.0)
    sin_theta_sq = 1.0 - cos_theta_i * cos_theta_i
    a = torch.sqrt(n_r * n_r - sin_theta_sq)
    q = (2.0 * math.pi * slab_thickness / wavelength) * a
    phase = torch.exp(-2j * q)

    r_s_slab = safe_divide(r_s_inf * (1.0 - phase), 1.0 - r_s_inf * r_s_inf * phase)
    r_p_slab = safe_divide(r_p_inf * (1.0 - phase), 1.0 - r_p_inf * r_p_inf * phase)

    return (
        torch.where(use_slab, r_s_slab, r_s_inf),
        torch.where(use_slab, r_p_slab, r_p_inf),
    )
