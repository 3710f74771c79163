"""Fresnel reflection coefficients (PyTorch port of ``differt_tpu.em._fresnel``).

The complex-safe form ``n_r cos(theta_t) = sqrt(n_r^2 + cos^2(theta_i) - 1)``
handles total internal reflection and lossy media through one branch cut.
"""

import math

import torch

from ..utils import safe_divide


def reflection_coefficients(
    n_r: torch.Tensor, cos_theta_i: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fresnel ``(r_s, r_p)`` at an interface of relative index ``n_r``.

    >>> import torch
    >>> r_s, r_p = reflection_coefficients(torch.tensor(1.5 + 0j), torch.tensor(1.0))
    >>> round(float(r_s.real), 3), round(float(r_p.real), 3)
    (-0.2, 0.2)
    """
    ci = torch.abs(cos_theta_i)
    n_sq = n_r * n_r
    ct = torch.sqrt(n_sq + ci * ci - 1.0)
    r_s = safe_divide(ci - ct, ci + ct)
    incident_p = n_sq * ci
    r_p = safe_divide(incident_p - ct, incident_p + ct)
    return r_s, r_p


def slab_reflection_coefficients(
    n_r: torch.Tensor,
    cos_theta_i: torch.Tensor,
    thickness: torch.Tensor,
    wavelength: torch.Tensor | float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reflection off a finite-thickness slab (multi-bounce interference).

    Negative ``thickness`` selects the semi-infinite (plain Fresnel) result.
    """
    r_s_inf, r_p_inf = reflection_coefficients(n_r, cos_theta_i)

    sin_theta_sq = 1.0 - cos_theta_i * cos_theta_i
    a = torch.sqrt(n_r * n_r - sin_theta_sq)
    q = (2.0 * math.pi * thickness / wavelength) * a
    phase = torch.exp(-2j * q)

    r_s_slab = safe_divide(r_s_inf * (1.0 - phase), 1.0 - r_s_inf * r_s_inf * phase)
    r_p_slab = safe_divide(r_p_inf * (1.0 - phase), 1.0 - r_p_inf * r_p_inf * phase)

    use_slab = thickness >= 0.0
    return (
        torch.where(use_slab, r_s_slab, r_s_inf),
        torch.where(use_slab, r_p_slab, r_p_inf),
    )
