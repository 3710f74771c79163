"""Uniform Theory of Diffraction coefficients (PyTorch port of ``differt_tpu.em._utd``).

The McNamara D1..D4 wedge coefficients ("Introduction to the Uniform
Geometrical Theory of Diffraction", ch. 6, eqs. 6.21-6.29) with the
transition function ``F``, and the Luebbers heuristic for finitely
conducting wedges through per-face reflection coefficients.

PyTorch has no Fresnel integrals, so :func:`fresnel` is written here: the
single-precision Cephes ``fresnlf`` as a :class:`torch.autograd.Function`
whose backward is the integrands ``sin(pi x^2 / 2)`` and ``cos(pi x^2 / 2)``.
"""

import cmath
import math
from typing import Literal

import torch

# Coefficients of the single-precision Cephes ``fresnlf`` (Cephes Math
# Library, S. L. Moshier; as SciPy carries them in special/cephes/fresnl.h),
# highest degree first.
_FRESNL_SN = (
    +1.647629463788700e-9,
    -1.522754752581096e-7,
    +8.424748808502400e-6,
    -3.120693124703272e-4,
    +7.244727626597022e-3,
    -9.228055941124598e-2,
    +5.235987735681432e-1,
)
_FRESNL_CN = (
    +1.416802502367354e-8,
    -1.157231412229871e-6,
    +5.387223446683264e-5,
    -1.604381798862293e-3,
    +2.818489036795073e-2,
    -2.467398198317899e-1,
    +9.999999760004487e-1,
)
_FRESNL_FN = (
    -1.903009855649792e12,
    +1.355942388050252e11,
    -4.158143148511033e9,
    +7.343848463587323e7,
    -8.732356681548485e5,
    +8.560515466275470e3,
    -1.032877601091159e2,
    +2.999401847870011e0,
)
_FRESNL_GN = (
    -1.860843997624650e11,
    +1.278350673393208e10,
    -3.779387713202229e8,
    +6.492611570598858e6,
    -7.787789623358162e4,
    +8.602931494734327e2,
    -1.493439396592284e1,
    +9.999841934744914e-1,
)


def _polyval(coefficients: tuple[float, ...], x: torch.Tensor) -> torch.Tensor:
    """Horner's rule, highest degree first (``jnp.polyval``)."""
    out = torch.full_like(x, coefficients[0])
    for coefficient in coefficients[1:]:
        out = out * x + coefficient
    return out


def _sincos_pi_x2_half(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``sin(pi x^2 / 2)`` and ``cos(pi x^2 / 2)``, with the argument reduced mod 2 first.

    With ``s = x mod 2``, ``x^2 / 2 = s (x - s / 2) mod 2``: the reduction
    is exact, where ``pi * x * x / 2`` in float32 loses the phase for large
    ``x`` (SciPy's ``sinpi``/``cospi`` trick, as JAX's ``fresnel`` uses it).
    """
    x = torch.abs(x)
    s = torch.fmod(x, 2.0)
    r = torch.fmod(s * (x - s / 2), 2.0)
    sinpi = torch.where(
        r < 0.5,
        torch.sin(math.pi * r),
        torch.where(r > 1.5, torch.sin(math.pi * (r - 2.0)), -torch.sin(math.pi * (r - 1.0))),
    )
    cospi = torch.where(
        r == 0.5,
        0.0,
        torch.where(r < 1.0, -torch.sin(math.pi * (r - 0.5)), torch.sin(math.pi * (r - 1.5))),
    )
    return sinpi, cospi


def _fresnel_values(xx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Cephes ``fresnlf`` forward on float32: the power series for
    ``x^2 < 2.5625``, the auxiliary functions ``f`` and ``g`` above, 1/2 for
    ``x > 36974`` and at infinity; odd in ``x``."""
    x = torch.abs(xx)
    x2 = x * x
    t = x2 * x2
    s_small = x * x2 * _polyval(_FRESNL_SN, t)
    c_small = x * _polyval(_FRESNL_CN, t)

    sinpi, cospi = _sincos_pi_x2_half(x)
    t = math.pi * x2
    u = 1.0 / (t * t)
    t = 1.0 / t
    f = 1.0 - u * _polyval(_FRESNL_FN, u)
    g = t * _polyval(_FRESNL_GN, u)
    t = math.pi * x
    c_other = 0.5 + (f * sinpi - g * cospi) / t
    s_other = 0.5 - (f * cospi + g * sinpi) / t

    small = x2 < 2.5625
    limit = torch.isinf(xx) | (x > 36974.0)
    s = torch.where(limit, 0.5, torch.where(small, s_small, s_other))
    c = torch.where(limit, 0.5, torch.where(small, c_small, c_other))
    neg = xx < 0.0
    return torch.where(neg, -s, s), torch.where(neg, -c, c)


class _Fresnel(torch.autograd.Function):
    """Fresnel integrals with the integrands as derivatives (JAX's custom JVP)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _fresnel_values(x)

    @staticmethod
    def backward(ctx, grad_s, grad_c):
        (x,) = ctx.saved_tensors
        sinpi, cospi = _sincos_pi_x2_half(x)
        return grad_s * sinpi + grad_c * cospi


def fresnel(x) -> tuple[torch.Tensor, torch.Tensor]:
    r"""The Fresnel integrals ``(S(x), C(x))``, differentiable.

    .. math::
        S(x) = \int_0^x \sin(\pi t^2 / 2)\,dt, \qquad
        C(x) = \int_0^x \cos(\pi t^2 / 2)\,dt.

    The single-precision Cephes ``fresnlf``, as ``jax.scipy.special.fresnel``
    computes it for float32; accurate to about 1e-7 on [-10, 10]. Inputs of
    another floating dtype are evaluated in float32 and returned in their
    own dtype. The gradient is ``(sin(pi x^2 / 2), cos(pi x^2 / 2))``.

    >>> import torch
    >>> s, c = fresnel(torch.tensor([0.0, 1.0, 1e6]))
    >>> [round(v, 4) for v in s.tolist()], [round(v, 4) for v in c.tolist()]
    ([0.0, 0.4383, 0.5], [0.0, 0.7799, 0.5])
    """
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    s, c = _Fresnel.apply(x.to(torch.float32))
    return s.to(x.dtype), c.to(x.dtype)


def _cot(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.tan(x)


def _n_plus_minus(beta, n, mode: Literal["+", "-"]) -> torch.Tensor:
    """Integer ``N+-`` closest to satisfying ``2 pi n N - beta = +-pi``."""
    sign = 1.0 if mode == "+" else -1.0
    return torch.round((beta + sign * math.pi) / (2.0 * n * math.pi))


def _a_plus_minus(beta, n, mode: Literal["+", "-"]) -> torch.Tensor:
    """Angular distance measure ``a+-(beta) = 2 cos^2((2 pi n N+- - beta) / 2)``."""
    big_n = _n_plus_minus(beta, n, mode)
    co = torch.cos(0.5 * (2.0 * n * math.pi * big_n - beta))
    return 2.0 * co * co


def L_i(  # noqa: N802
    s_d,
    sin_2_beta_0,
    rho_1_i=None,
    rho_2_i=None,
    rho_e_i=None,
    s_i=None,
) -> torch.Tensor:
    """Distance parameter of the incident shadow boundary.

    Plane-wave incidence by default (``L = s^d sin^2(beta_0)``), spherical
    when ``s_i`` is given, general astigmatic when the three radii
    ``rho_1_i``, ``rho_2_i`` and ``rho_e_i`` are.

    >>> float(L_i(2.0, 0.5)), float(L_i(2.0, 0.5, s_i=2.0))
    (1.0, 0.5)
    """
    radii = (rho_1_i, rho_2_i, rho_e_i)
    all_none = all(x is None for x in radii)
    all_set = all(x is not None for x in radii)
    if s_i is not None and not all_none:
        msg = (
            "If 's_i' is provided, then 'rho_1_i', 'rho_2_i', and 'rho_e_i' "
            "must be left to 'None'."
        )
        raise ValueError(msg)
    if not all_none and not all_set:
        msg = (
            "All three of 'rho_1_i', 'rho_2_i', and 'rho_e_i' must be "
            "provided, or left to 'None'."
        )
        raise ValueError(msg)

    s_d = torch.as_tensor(s_d)
    sin_2_beta_0 = torch.as_tensor(sin_2_beta_0)
    if s_i is not None:
        s_i = torch.as_tensor(s_i)
        return (s_d * s_i) * sin_2_beta_0 / (s_d + s_i)
    if all_none:
        return s_d * sin_2_beta_0
    rho_1_i, rho_2_i, rho_e_i = (torch.as_tensor(x) for x in radii)
    return (
        (s_d * (rho_e_i + s_d) * rho_1_i * rho_2_i)
        / (rho_e_i * (rho_1_i + s_d) * (rho_2_i + s_d))
    ) * sin_2_beta_0


def F(z) -> torch.Tensor:  # noqa: N802
    r"""UTD transition function, through the Fresnel integrals.

    ``F(x) = 2j sqrt(x) e^{jx} int_sqrt(x)^inf e^{-ju^2} du``
    (McNamara eq. 4.72). It tends to 1 far from the shadow boundaries:

    >>> import torch
    >>> bool(torch.abs(F(torch.tensor(100.0)) - 1.0) < 1e-2)
    True
    """
    z = torch.as_tensor(z)
    factor = math.sqrt(math.pi / 2)
    # F multiplies an error in sqrt(z) by about 2 sqrt(z) (the Fresnel
    # integrals' argument and the prefactor must agree), so the root is the
    # correctly rounded one on every device: taken in float64, then rounded.
    # (PyTorch's vectorised float32 sqrt on the CPU is an ulp off for about
    # 0.7% of arguments.)
    sqrt_z = torch.sqrt(z.double()).to(z.dtype)
    s, c = fresnel(sqrt_z / factor)
    return 2j * sqrt_z * torch.exp(1j * z) * (factor * ((1 - 1j) / 2 - c + 1j * s))


_EXP_J_PI_4 = cmath.exp(1j * math.pi / 4)


def _cot_f_term(phi, n, two_n, k, length, mode: Literal["+", "-"]) -> torch.Tensor:
    """``cot((pi +- phi) / 2n) F(k L a+-(phi))``, with its limit at the singular points.

    At shadow and reflection boundaries the cotangent diverges while ``F``
    goes to 0, and their product stays finite. Where ``eps = 2 n x`` (``x``
    the signed distance of the cotangent's argument from a multiple of pi)
    is below 0.005 in magnitude, the McNamara eq. 6.32 limit
    ``n [sqrt(2 pi k L) sgn(eps) - 2 k L eps e^{j pi/4}] e^{j pi/4}`` is
    taken instead. The discarded branch is fed harmless arguments (``pi/4``
    and ``k L``), so that no ``0 * inf`` reaches a gradient.
    """
    sign = 1.0 if mode == "+" else -1.0
    arg = (math.pi + sign * phi) / two_n
    x = arg - math.pi * torch.round(arg / math.pi)
    eps_m = two_n * x
    singular = torch.abs(eps_m) < 0.005

    kl = k * length
    a = _a_plus_minus(phi, n, mode)
    safe_arg = torch.where(singular, math.pi / 4, arg)
    exact = _cot(safe_arg) * F(kl * torch.where(singular, 1.0, a))

    sgn = torch.where(eps_m >= 0.0, 1.0, -1.0)
    limit = n * (torch.sqrt(2.0 * math.pi * kl) * sgn - 2.0 * kl * eps_m * _EXP_J_PI_4) * _EXP_J_PI_4
    return torch.where(singular, limit, exact)


def diffraction_coefficients(
    k,
    n,
    phi_i,
    phi_d,
    sin_beta_0,
    length_i,
    length_r_o=None,
    length_r_n=None,
    r_o=None,
    r_n=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""UTD wedge diffraction coefficients ``(D_s, D_h)``.

    The four-cotangent McNamara form (eqs. 6.21-6.29):

    .. math::
        D_{1,2} = -\frac{e^{-j\pi/4}}{2n\sqrt{2\pi k}\sin\beta_0}
                  \cot\Big(\frac{\pi \pm (\phi - \phi')}{2n}\Big)
                  F\big(k L^i a^\pm(\phi - \phi')\big)

    and ``D_{3,4}`` likewise with :math:`\phi + \phi'` and the reflection
    distance parameters. A perfectly conducting wedge gives
    ``D_s = D_1 + D_2 - (D_3 + D_4)`` and ``D_h = D_1 + D_2 + (D_3 + D_4)``;
    per-face ``(r_s, r_p)`` reflection coefficients ``r_o`` / ``r_n``
    apply the Luebbers heuristic for lossy wedges:
    ``D = D_1 + D_2 + R_n D_3 + R_o D_4``.

    Args:
        k: Wavenumber (rad/m).
        n: Wedge parameter (exterior angle ``n * pi``).
        phi_i: Incidence azimuth ``phi'`` from the o-face, in ``[0, n pi]``.
        phi_d: Diffraction azimuth ``phi`` from the o-face.
        sin_beta_0: Sine of the skew angle between the incident ray and the edge.
        length_i: Distance parameter of the incident boundary (see :func:`L_i`).
        length_r_o: Of the o-face reflection boundary (default ``length_i``).
        length_r_n: Of the n-face reflection boundary (default ``length_i``).
        r_o: ``(r_s, r_p)`` of the o-face (default PEC: ``(-1, 1)``).
        r_n: ``(r_s, r_p)`` of the n-face.

    Returns:
        The soft and hard coefficients, complex.
    """
    k, n, phi_i, phi_d, sin_beta_0, length_i = (
        torch.as_tensor(x) for x in (k, n, phi_i, phi_d, sin_beta_0, length_i)
    )
    length_r_o = length_i if length_r_o is None else torch.as_tensor(length_r_o)
    length_r_n = length_i if length_r_n is None else torch.as_tensor(length_r_n)

    phi_m = phi_d - phi_i
    phi_p = phi_d + phi_i
    two_n = 2.0 * n

    d1 = _cot_f_term(phi_m, n, two_n, k, length_i, "+")
    d2 = _cot_f_term(phi_m, n, two_n, k, length_i, "-")
    d3 = _cot_f_term(phi_p, n, two_n, k, length_r_n, "+")
    d4 = _cot_f_term(phi_p, n, two_n, k, length_r_o, "-")

    factor = -cmath.exp(-1j * math.pi / 4) / (two_n * torch.sqrt(2.0 * math.pi * k) * sin_beta_0)

    r_o_s, r_o_p = (-1.0, 1.0) if r_o is None else r_o
    r_n_s, r_n_p = (-1.0, 1.0) if r_n is None else r_n
    d12 = d1 + d2
    d_s = (d12 + r_n_s * d3 + r_o_s * d4) * factor
    d_h = (d12 + r_n_p * d3 + r_o_p * d4) * factor
    return d_s, d_h
