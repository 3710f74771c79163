"""The plain EM chain: a path's complex amplitude (frozen).

A copy of ``differt_tpu_torch/coverage.py::complex_amplitudes`` as of
commit ``d3b5058`` for what the benchmark's cells run: an isotropic TX
(vertical polarization), specular reflections only, one material of
semi-infinite thickness (plain Fresnel; the slab branch the port also
computes is discarded there), on paths that are valid. Its helpers are
copies of ``differt_tpu_torch/utils.py`` (``dot3``, ``cross3``,
``normalize3``, ``spherical3``, ``perpendicular3``, ``sp_directions3``,
``safe_divide``) and ``em/_fresnel.py::reflection_coefficients``;
the constants are ``em/_constants.py``'s.
"""

import math

import torch

C = 299792458.0
EPSILON_0 = 8.8541878128e-12
Z_0 = 376.73031341259


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def normalize3(a):
    sq = dot3(a, a)
    zero = sq == 0.0
    n = torch.sqrt(sq + zero)
    return tuple(comp / n for comp in a), torch.where(zero, sq, n)


def spherical3(k):
    x, y, z = k
    s_sq = x * x + y * y
    degenerate = s_sq < 1e-12
    one, zero = torch.ones_like(s_sq), torch.zeros_like(s_sq)
    s = torch.sqrt(torch.where(degenerate, one, s_sq))
    cos_p = torch.where(degenerate, one, x / s)
    sin_p = torch.where(degenerate, zero, y / s)
    s_out = torch.where(degenerate, zero, s)
    return (z * cos_p, z * sin_p, -s_out), (-sin_p, cos_p, zero)


def perpendicular3(u):
    ux, uy, uz = u
    zeros = torch.zeros_like(ux)
    pick_a = torch.abs(ux) > torch.abs(uy)
    cand = (torch.where(pick_a, -uy, zeros), torch.where(pick_a, ux, -uz), torch.where(pick_a, zeros, uy))
    return normalize3(cross3(u, cand))[0]


def sp_directions3(k_i, k_r, normal):
    e_i_s, norm = normalize3(cross3(k_i, normal))
    perp = perpendicular3(k_i)
    degenerate = norm == 0.0
    e_i_s = tuple(torch.where(degenerate, p, e) for p, e in zip(perp, e_i_s, strict=True))
    e_i_p = normalize3(cross3(e_i_s, k_i))[0]
    e_r_p = normalize3(cross3(e_i_s, k_r))[0]
    return (e_i_s, e_i_p), (e_i_s, e_r_p)


def safe_divide(num, den):
    zero = den == 0
    out = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(out), out)


def reflection_coefficients(n_r, cos_theta_i):
    ci = torch.abs(cos_theta_i)
    n_sq = n_r * n_r
    ct = torch.sqrt(n_sq + ci * ci - 1.0)
    r_s = safe_divide(ci - ct, ci + ct)
    incident_p = n_sq * ci
    r_p = safe_divide(incident_p - ct, incident_p + ct)
    return r_s, r_p


def refractive_index(eta_r: torch.Tensor, conductivity: torch.Tensor, frequency: float) -> torch.Tensor:
    """``sqrt(eta_r - j sigma / (omega epsilon_0))``, complex64 (a gradient flows to ``eta_r``)."""
    omega = 2.0 * math.pi * torch.as_tensor(frequency, dtype=torch.float32, device=eta_r.device)
    return torch.sqrt(eta_r.float() - 1j * conductivity.float() / (omega * EPSILON_0))


def amplitudes(vertices: torch.Tensor, bounce_normals: torch.Tensor, n_complex: torch.Tensor, frequency: float):
    """Complex amplitude ``[P]`` of valid paths ``[P, k + 2, 3]`` with each bounce's unit normal ``[P, k, 3]``.

    Computed in float32 and complex64 whatever the vertices' dtype: a lower
    precision reaches it through the vertices alone.
    """
    vertices = vertices.float()
    bounce_normals = bounce_normals.float()
    device = vertices.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    wavelength = C / frequency
    num_points = vertices.shape[-2]
    pts = [[vertices[:, p, axis] for axis in range(3)] for p in range(num_points)]
    k_hats, s_lens = [], []
    for i in range(num_points - 1):
        k_hat, s_len = normalize3(tuple(pts[i + 1][ax] - pts[i][ax] for ax in range(3)))
        k_hats.append(k_hat)
        s_lens.append(s_len)
    e_theta = torch.ones(vertices.shape[0], dtype=torch.complex64, device=device)
    e_phi = torch.zeros(vertices.shape[0], dtype=torch.complex64, device=device)
    for b in range(num_points - 2):
        normal = tuple(bounce_normals[:, b, axis] for axis in range(3))
        k_in, k_out = k_hats[b], k_hats[b + 1]
        th_in, ph_in = spherical3(k_in)
        th_out, ph_out = spherical3(k_out)
        (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions3(k_in, k_out, normal)
        cos_theta_i = -dot3(normal, k_in)
        r_s, r_p = reflection_coefficients(n_complex, cos_theta_i)
        f_s = r_s * (dot3(e_i_s, th_in) * e_theta + dot3(e_i_s, ph_in) * e_phi)
        f_p = r_p * (dot3(e_i_p, th_in) * e_theta + dot3(e_i_p, ph_in) * e_phi)
        e_theta = dot3(th_out, e_r_s) * f_s + dot3(th_out, e_r_p) * f_p
        e_phi = dot3(ph_out, e_r_s) * f_s + dot3(ph_out, e_r_p) * f_p
    k_last = k_hats[-1]
    theta_hat_last, _ = spherical3(k_last)
    theta_hat_neg, _ = spherical3(tuple(-comp for comp in k_last))
    a = dot3(theta_hat_last, theta_hat_neg) * e_theta
    s_tot = s_lens[0]
    for s_len in s_lens[1:]:
        s_tot = s_tot + s_len
    spreading = safe_divide(torch.ones_like(s_tot), s_tot)
    phase = -2.0 * math.pi * frequency * s_tot / C
    a = a * spreading * torch.complex(torch.cos(phase), torch.sin(phase))
    return a * (wavelength / (4 * math.pi))
